"""LoFTR's forward FLOPs for one pair of H x W images at fixed capacity K
(the program's fine stage gathers all K windows), counted as
``torch.utils.flop_counter`` counts them: 2 a multiply-add of every
convolution, linear layer and product (attention, dual softmax, the fine
heatmap and its expectation), nothing for normalisations, activations,
softmaxes, gathers and resampling.  ``widths`` takes the keys of
``reference/loftr.py::CVPR_DS``."""
from __future__ import annotations

from .reference.loftr import backbone_convs


def _conv_out(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def backbone_flops(w: dict, H: int, W: int) -> int:
    """One image through the ResNet-FPN 8_2 backbone: layer 1 and its FPN
    output at 1/2, layer 2 at 1/4, layer 3 at 1/8."""
    s1 = (_conv_out(H, 7, 2), _conv_out(W, 7, 2))
    s2 = tuple(_conv_out(n, 3, 2) for n in s1)
    s3 = tuple(_conv_out(n, 3, 2) for n in s2)
    total = 0
    for name, cin, cout, k, _ in backbone_convs(w):
        h, ww = s3 if "layer3" in name else s2 if "layer2" in name else s1
        total += 2 * cin * cout * k * k * h * ww
    return total


def encoder_layer_flops(n: int, L: int, S: int, d: int, nhead: int) -> int:
    """One LoFTREncoderLayer over n sequences of L queries and S sources:
    the q, k, v and merge projections, linear attention (K^T V, the
    normaliser Q . sum K, Q (K^T V)) and the two-layer MLP."""
    D = d // nhead
    proj = 2 * n * d * d * (2 * L + 2 * S)
    attn = 2 * n * nhead * (S * D * D + L * D + L * D * D)
    mlp = 2 * n * L * (2 * d * 2 * d + 2 * d * d)
    return proj + attn + mlp


def pair_flops(w: dict, H: int, W: int, K: int) -> int:
    """One pair: both images' backbones, the coarse transformer, the dual
    softmax's similarity, and the fine stage at K windows (down-projection,
    merge, fine transformer, heatmap and expectation)."""
    Hc, Wc = H // 8, W // 8
    L = Hc * Wc
    dc, df, nh = w["d_coarse"], w["d_fine"], w["nhead"]
    WW = w["window"] ** 2
    coarse = 2 * 2 * w["coarse_pairs"] * encoder_layer_flops(1, L, L, dc, nh)
    sim = 2 * L * L * dc
    fine = (2 * 2 * K * dc * df
            + 2 * 2 * K * WW * (w["block_dims"][0] + df) * df
            + 2 * 2 * w["fine_pairs"] * encoder_layer_flops(K, WW, WW, df, nh)
            + 2 * K * WW * df + 2 * K * WW * 2)
    return 2 * backbone_flops(w, H, W) + coarse + sim + fine
