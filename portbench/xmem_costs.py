"""XMem's FLOPs, counted as ``torch.utils.flop_counter`` counts them: 2 a
multiply-add of every convolution, linear layer and product, nothing for
normalisations, activations, pooling, resampling and elementwise work.
``w`` takes the keys of ``reference/xmem.py::XMEM``; H and W are the
network's input (resized and padded to multiples of 16, ``frame_shape``).

- ``key_flops``: the key encoder (ResNet-50 to layer3) and the key and
  selection projections, every frame;
- ``decode_flops``: the decoder, on every frame after the first, with the
  sensory update where ``hidden_update``;
- ``value_flops``: a memory frame's shrinkage projection, value encoder
  (ResNet-18 to layer3, the fusion with f16) and deep update;
- ``read_flops``: the similarity (two products over the key width) and the
  dense readout over ``elements`` memory elements for every query pixel.

Consolidation (every ``T_max - T_min`` memory frames: prototypes against
their candidates, under 0.1 % of the frames between) is left out."""
from __future__ import annotations


def _conv(cin: int, cout: int, k: int, hw: int) -> int:
    return 2 * cin * cout * k * k * hw


def frame_shape(H: int, W: int, size: int) -> tuple:
    """The network's input for an H x W frame: the shorter side at
    ``size``, padded up to multiples of 16."""
    if min(H, W) != size:
        H, W = (size, int(size * W / H)) if H <= W else (int(size * H / W), size)
    return H + (-H) % 16, W + (-W) % 16


def _res_block(cin: int, cout: int, hw: int) -> int:
    out = _conv(cin, cout, 3, hw) + _conv(cout, cout, 3, hw)
    return out + (_conv(cin, cout, 3, hw) if cin != cout else 0)


def _fusion(x_in: int, g_in: int, g_mid: int, g_out: int, hw: int) -> int:
    cbam = 2 * 2 * (2 * g_mid * (g_mid // 16)) + _conv(2, 1, 7, hw)
    return _res_block(x_in + g_in, g_mid, hw) + cbam + _res_block(g_mid, g_out, hw)


def key_flops(w: dict, H: int, W: int) -> int:
    s2, s4, s8, s16 = (H // d * (W // d) for d in (2, 4, 8, 16))
    total = _conv(3, 64, 7, s2)
    cin = 64
    for planes, n, hw_in, hw_out in ((64, 3, s4, s4), (128, 4, s4, s8), (256, 6, s8, s16)):
        for i in range(n):
            first = i == 0
            total += _conv(cin, planes, 1, hw_in if first else hw_out)
            total += _conv(planes, planes, 3, hw_out)
            total += _conv(planes, planes * 4, 1, hw_out)
            if first:
                total += _conv(cin, planes * 4, 1, hw_out)
            cin = planes * 4
    return total + 2 * _conv(1024, w["key_dim"], 3, s16)


def decode_flops(w: dict, H: int, W: int, hidden_update: bool) -> int:
    s4, s8, s16 = (H // d * (W // d) for d in (4, 8, 16))
    cv, hd = w["value_dim"], w["hidden_dim"]
    total = _fusion(1024, cv + hd, 512, 512, s16)
    total += _conv(512, 512, 3, s8) + _res_block(512, 256, s8)
    total += _conv(256, 256, 3, s4) + _res_block(256, 256, s4)
    total += _conv(256, 1, 3, s4)
    if hidden_update:
        total += (_conv(512, 256, 1, s16) + _conv(256, 256, 1, s16) + _conv(257, 256, 1, s16)
                  + _conv(256 + hd, 3 * hd, 3, s16))
    return total


def value_flops(w: dict, H: int, W: int) -> int:
    s2, s4, s8, s16 = (H // d * (W // d) for d in (2, 4, 8, 16))
    cv, hd = w["value_dim"], w["hidden_dim"]
    total = _conv(1024, 1, 3, s16) + _conv(5, 64, 7, s2) + 4 * _conv(64, 64, 3, s4)
    cin = 64
    for planes, hw in ((128, s8), (256, s16)):
        total += _conv(cin, planes, 3, hw) + 3 * _conv(planes, planes, 3, hw)
        total += _conv(cin, planes, 1, hw)
        cin = planes
    return total + _fusion(1024, 256, cv, cv, s16) + _conv(cv + hd, 3 * hd, 3, s16)


def read_flops(w: dict, elements: int, H: int, W: int) -> int:
    q = H // 16 * (W // 16)
    return 2 * elements * q * (2 * w["key_dim"] + w["value_dim"])
