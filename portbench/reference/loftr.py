"""Plain PyTorch reference of LoFTR (Sun et al., "LoFTR: Detector-Free
Local Feature Matching with Transformers", CVPR 2021), the matcher that
BundleSDF ships (``BundleTrack/LoFTR/src/loftr/``, built from
``cvpr_ds_config``), written from the upstream's equations in float32.
It imports nothing of the program.

The weights are a state dict under the upstream's own names
(``backbone.layer1.0.conv1.weight``, ``loftr_coarse.layers.3.q_proj.weight``,
``fine_preprocess.merge_feat.bias``, ...): ``make_weights`` draws one from a
seed with the upstream's init schemes, and the program loads the same
dict.  ``forward``:

- the ResNet-FPN 8_2 backbone (backbone/resnet_fpn.py): ``F.conv2d``,
  BatchNorm at its running statistics, the 1/8 and 1/2 maps;
- the 2-D sine positional encoding (utils/position_encoding.py), computed
  in float32 as the upstream computes it, the temperature's precedence bug
  kept where ``temp_bug_fix`` is False (the released weights' setting);
- the coarse LocalFeatureTransformer (loftr_module/transformer.py,
  linear_attention.py): ``elu + 1`` linear attention, self then cross, the
  cross update sequential (feat1 attends to the updated feat0);
- dual softmax at the temperature over every cell pair
  (utils/coarse_matching.py:109-119);
- the upstream's dynamic selection (get_coarse_match :150-196, eval path):
  threshold, border removal, mutual nearest (equality with the row and the
  column maximum), every match kept;
- the fine stage (loftr_module/fine_preprocess.py, utils/fine_matching.py):
  ``F.unfold`` windows (zero padding), the coarse feature down-projected
  and merged, the fine transformer, the heatmap's spatial expectation.
  It runs teacher-forced at given coarse ids, as the upstream's training
  path does, so that it is compared where nothing is selected too.

``warp`` is the plain warp of a frame's grey image into a pair's crop
(the upstream's ``cv::warpPerspective`` with bilinear taps and a zero
border), in float64, from ``gray``, the BT.601 luma of the RGB frame.

Departures from the upstream: the fine stage runs only at given ids (the
program's); ``mconf`` ties within a row keep the first column (the
upstream's ``mask.max`` does the same); pairs run in blocks of
``block`` so that the reference fits beside the program.

``precision="ref"`` computes in float32 with TF32 off for cuBLAS and cuDNN
(both switches restored afterwards).  ``precision="tf32"`` is the control,
one precision below: both switches on, and every operand of a
convolution, linear layer and product rounded to TF32 (10 mantissa bits,
to nearest even), so that the control is the same on a CPU.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

# The upstream's cvpr_ds_config (BundleTrack/LoFTR/src/config/default.py,
# loftr/utils/cvpr_ds_config.py): the published widths, under the names
# that the program's LoftrCfg gives them.
CVPR_DS = {"initial_dim": 128, "block_dims": (128, 196, 256), "d_coarse": 256,
           "d_fine": 128, "nhead": 8, "coarse_pairs": 4, "fine_pairs": 1, "window": 5,
           "dsmax_temp": 0.1, "thr": 0.2, "border_rm": 2, "temp_bug_fix": False}
BN_EPS = 1e-5
LN_EPS = 1e-5
ATTN_EPS = 1e-6


# ----------------------------------------------------------- the weights ---

def backbone_convs(w: dict) -> list:
    """(name, cin, cout, k, stride) of every convolution of the backbone, in
    the order it runs."""
    d0, d1, d2 = w["block_dims"]
    out = [("backbone.conv1", 1, w["initial_dim"], 7, 2)]
    cin = w["initial_dim"]
    for li, (d, stride) in enumerate(((d0, 1), (d1, 2), (d2, 2)), start=1):
        for bi, (ci, s) in enumerate(((cin, stride), (d, 1))):
            base = f"backbone.layer{li}.{bi}"
            out.append((f"{base}.conv1", ci, d, 3, s))
            out.append((f"{base}.conv2", d, d, 3, 1))
            if s != 1:
                out.append((f"{base}.downsample.0", ci, d, 1, s))
        cin = d
    out += [("backbone.layer3_outconv", d2, d2, 1, 1),
            ("backbone.layer2_outconv", d1, d2, 1, 1),
            ("backbone.layer2_outconv2.0", d2, d2, 3, 1),
            ("backbone.layer2_outconv2.3", d2, d1, 3, 1),
            ("backbone.layer1_outconv", d0, d1, 1, 1),
            ("backbone.layer1_outconv2.0", d1, d1, 3, 1),
            ("backbone.layer1_outconv2.3", d1, d0, 3, 1)]
    return out


def param_shapes(w: dict = CVPR_DS) -> dict:
    """name -> (shape, kind) of every weight, kind one of ``conv``, ``bn``
    (the four BatchNorm tensors share the prefix), ``linear``, ``bias``
    (a linear layer's; its fan-in beside it) and ``ln``."""
    d0, d1, d2 = w["block_dims"]
    out = {}
    for name, cin, cout, k, _ in backbone_convs(w):
        out[f"{name}.weight"] = ((cout, cin, k, k), "conv")
    bns = [("backbone.bn1", w["initial_dim"])]
    for li, d in enumerate((d0, d1, d2), start=1):
        for bi in range(2):
            bns += [(f"backbone.layer{li}.{bi}.bn1", d), (f"backbone.layer{li}.{bi}.bn2", d)]
        if li > 1:
            bns.append((f"backbone.layer{li}.0.downsample.1", d))
    bns += [("backbone.layer2_outconv2.1", d2), ("backbone.layer1_outconv2.1", d1)]
    for name, d in bns:
        for t in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{t}"] = ((d,), "bn")
    for prefix, d, n in (("loftr_coarse", w["d_coarse"], 2 * w["coarse_pairs"]),
                         ("loftr_fine", w["d_fine"], 2 * w["fine_pairs"])):
        for i in range(n):
            base = f"{prefix}.layers.{i}"
            for m in ("q_proj", "k_proj", "v_proj", "merge"):
                out[f"{base}.{m}.weight"] = ((d, d), "linear")
            out[f"{base}.mlp.0.weight"] = ((2 * d, 2 * d), "linear")
            out[f"{base}.mlp.2.weight"] = ((d, 2 * d), "linear")
            for m in ("norm1", "norm2"):
                out[f"{base}.{m}.weight"] = ((d,), "ln")
                out[f"{base}.{m}.bias"] = ((d,), "ln")
    df = w["d_fine"]
    out["fine_preprocess.down_proj.weight"] = ((df, w["d_coarse"]), "linear")
    out["fine_preprocess.down_proj.bias"] = ((df,), ("bias", w["d_coarse"]))
    out["fine_preprocess.merge_feat.weight"] = ((df, d0 + df), "linear")
    out["fine_preprocess.merge_feat.bias"] = ((df,), ("bias", d0 + df))
    return out


def make_weights(seed: int, w: dict = CVPR_DS) -> dict:
    """A state dict from ``seed`` (on the CPU) with the upstream's init:
    kaiming-normal fan-out convolutions (resnet_fpn.py:64-69), BatchNorm at
    identity, xavier-uniform transformer matrices (transformer.py:98-101),
    ``nn.Linear``'s uniform biases, LayerNorm at identity."""
    from ..draws import mix

    gen = torch.Generator().manual_seed(mix(seed, 5))
    sd = {}
    for name, (shape, kind) in param_shapes(w).items():
        t = torch.empty(shape)
        if kind == "conv":
            fan_out = shape[0] * shape[2] * shape[3]
            t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
        elif kind == "linear":
            a = math.sqrt(6.0 / (shape[0] + shape[1]))
            t.uniform_(-a, a, generator=gen)
        elif isinstance(kind, tuple):
            b = 1.0 / math.sqrt(kind[1])
            t.uniform_(-b, b, generator=gen)
        else:
            last = name.rsplit(".", 1)[1]
            t.fill_(1.0 if last in ("weight", "running_var") else 0.0)
        sd[name] = t
    return sd


# -------------------------------------------------------------- precision ---

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Ops:
    """The products of one forward, with the operands rounded to TF32 in the
    control."""

    def __init__(self, sd: dict, precision: str):
        if precision not in ("ref", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.sd = sd
        self.r = tf32_round if precision == "tf32" else (lambda t: t)

    def conv(self, x, name, stride, pad):
        return F.conv2d(self.r(x), self.r(self.sd[f"{name}.weight"]), None, stride, pad)

    def bn(self, x, name):
        s = self.sd
        return F.batch_norm(x, s[f"{name}.running_mean"], s[f"{name}.running_var"],
                            s[f"{name}.weight"], s[f"{name}.bias"], False, 0.0, BN_EPS)

    def linear(self, x, name):
        b = self.sd.get(f"{name}.bias")
        return F.linear(self.r(x), self.r(self.sd[f"{name}.weight"]), b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))

    def ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.sd[f"{name}.weight"],
                            self.sd[f"{name}.bias"], LN_EPS)


# ------------------------------------------------------------------- warp ---

def gray(rgb) -> torch.Tensor:
    """The BT.601 luma of an (H, W, 3) RGB image, float64 in [0, 255]."""
    c = torch.as_tensor(rgb).double()
    return 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]


def warp(img: torch.Tensor, M, size: int, precision: str = "ref") -> torch.Tensor:
    """The (size, size) crop that the 3 x 3 homography ``M`` (image -> crop)
    makes of the (H, W) image: crop pixel (x, y) reads the image bilinearly
    at M^-1 (x, y, 1), a tap outside the image reading 0.  Float64; in the
    control (``precision="tf32"``) M^-1 and the source coordinates are
    rounded to TF32."""
    if precision not in ("ref", "tf32"):
        raise ValueError(f"precision {precision!r}")
    r = ((lambda t: tf32_round(t.float()).double()) if precision == "tf32"
         else (lambda t: t))
    H, W = img.shape
    img = img.double()
    Mi = r(torch.linalg.inv(torch.as_tensor(M, dtype=torch.float64, device=img.device)))
    ax = torch.arange(size, dtype=torch.float64, device=img.device)
    ys, xs = torch.meshgrid(ax, ax, indexing="ij")
    p = Mi @ torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs.reshape(-1))])
    sx, sy = r(p[0] / p[2]), r(p[1] / p[2])
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        return torch.where(ok, img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)], 0.0)

    top = (1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1)
    bottom = (1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)
    return ((1 - fy) * top + fy * bottom).view(size, size)


# ---------------------------------------------------------------- forward ---

def _block(o: _Ops, x, base, stride):
    y = F.relu(o.bn(o.conv(x, f"{base}.conv1", stride, 1), f"{base}.bn1"))
    y = o.bn(o.conv(y, f"{base}.conv2", 1, 1), f"{base}.bn2")
    if f"{base}.downsample.0.weight" in o.sd:
        x = o.bn(o.conv(x, f"{base}.downsample.0", stride, 0), f"{base}.downsample.1")
    return F.relu(x + y)


def backbone(o: _Ops, x):
    """ResNetFPN_8_2.forward: (N, 1, H, W) -> the 1/8 and the 1/2 map."""
    def up(t):
        return F.interpolate(t, scale_factor=2.0, mode="bilinear", align_corners=True)

    def outconv2(t, base):
        t = F.leaky_relu(o.bn(o.conv(t, f"{base}.0", 1, 1), f"{base}.1"), 0.01)
        return o.conv(t, f"{base}.3", 1, 1)

    x0 = F.relu(o.bn(o.conv(x, "backbone.conv1", 2, 3), "backbone.bn1"))
    x1 = _block(o, _block(o, x0, "backbone.layer1.0", 1), "backbone.layer1.1", 1)
    x2 = _block(o, _block(o, x1, "backbone.layer2.0", 2), "backbone.layer2.1", 1)
    x3 = _block(o, _block(o, x2, "backbone.layer3.0", 2), "backbone.layer3.1", 1)
    x3_out = o.conv(x3, "backbone.layer3_outconv", 1, 0)
    x2_out = outconv2(o.conv(x2, "backbone.layer2_outconv", 1, 0) + up(x3_out),
                      "backbone.layer2_outconv2")
    x1_out = outconv2(o.conv(x1, "backbone.layer1_outconv", 1, 0) + up(x2_out),
                      "backbone.layer1_outconv2")
    return x3_out, x1_out


def sine_encoding(d: int, H: int, W: int, temp_bug_fix: bool, device) -> torch.Tensor:
    """PositionEncodingSine's ``pe`` cut to (1, d, H, W), in float32."""
    pe = torch.zeros((d, H, W), device=device)
    y = torch.ones((H, W), device=device).cumsum(0).float()[None]
    x = torch.ones((H, W), device=device).cumsum(1).float()[None]
    if temp_bug_fix:
        div = torch.exp(torch.arange(0, d // 2, 2, device=device).float()
                        * (-math.log(10000.0) / (d // 2)))
    else:   # the upstream's precedence bug: (-log(1e4) / d) // 2
        div = torch.exp(torch.arange(0, d // 2, 2, device=device).float()
                        * (-math.log(10000.0) / d // 2))
    div = div[:, None, None]
    pe[0::4] = torch.sin(x * div)
    pe[1::4] = torch.cos(x * div)
    pe[2::4] = torch.sin(y * div)
    pe[3::4] = torch.cos(y * div)
    return pe[None]


def encoder_layer(o: _Ops, x, source, base: str, nhead: int):
    """LoFTREncoderLayer.forward with LinearAttention."""
    n, L, C = x.shape
    D = C // nhead
    q = o.linear(x, f"{base}.q_proj").view(n, -1, nhead, D)
    k = o.linear(source, f"{base}.k_proj").view(n, -1, nhead, D)
    v = o.linear(source, f"{base}.v_proj").view(n, -1, nhead, D)
    Q, K = F.elu(q) + 1, F.elu(k) + 1
    v_len = v.shape[1]
    v = v / v_len
    KV = o.einsum("nshd,nshv->nhdv", K, v)
    Z = 1 / (o.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + ATTN_EPS)
    msg = o.einsum("nlhd,nhdv->nlhv", Q, KV) * Z[..., None] * v_len
    msg = o.ln(o.linear(msg.reshape(n, -1, C), f"{base}.merge"), f"{base}.norm1")
    h = F.relu(o.linear(torch.cat([x, msg], dim=2), f"{base}.mlp.0"))
    msg = o.ln(o.linear(h, f"{base}.mlp.2"), f"{base}.norm2")
    return x + msg


def transformer(o: _Ops, f0, f1, prefix: str, n_pairs: int, nhead: int):
    """LocalFeatureTransformer.forward over ['self', 'cross'] * n_pairs."""
    for i in range(2 * n_pairs):
        base = f"{prefix}.layers.{i}"
        if i % 2 == 0:
            f0 = encoder_layer(o, f0, f0, base, nhead)
            f1 = encoder_layer(o, f1, f1, base, nhead)
        else:
            f0 = encoder_layer(o, f0, f1, base, nhead)
            f1 = encoder_layer(o, f1, f0, base, nhead)
    return f0, f1


def coarse_matches(conf, Hc: int, Wc: int, thr: float, border: int):
    """get_coarse_match's eval path: (b_ids, i_ids, j_ids, mconf) of every
    match."""
    B = conf.shape[0]
    mask = (conf > thr).view(B, Hc, Wc, Hc, Wc)
    if border > 0:
        mask[:, :border] = False
        mask[:, :, :border] = False
        mask[:, :, :, :border] = False
        mask[:, :, :, :, :border] = False
        mask[:, -border:] = False
        mask[:, :, -border:] = False
        mask[:, :, :, -border:] = False
        mask[:, :, :, :, -border:] = False
    mask = mask.view(B, Hc * Wc, Hc * Wc)
    mask = (mask & (conf == conf.max(dim=2, keepdim=True)[0])
            & (conf == conf.max(dim=1, keepdim=True)[0]))
    mask_v, all_j = mask.max(dim=2)
    b_ids, i_ids = torch.where(mask_v)
    j_ids = all_j[b_ids, i_ids]
    return b_ids, i_ids, j_ids, conf[b_ids, i_ids, j_ids]


def fine_at(o: _Ops, w: dict, ff0, ff1, fc0, fc1, Wc: int, scale: int, i_ids, j_ids):
    """FinePreprocess, the fine transformer and FineMatching at the coarse
    ids (B, K) of each pair: mkpts1_f (B, K, 2) in input pixels.  ``scale``:
    the input's size over the coarse map's."""
    B, K = i_ids.shape
    W = w["window"]
    WW = W * W
    Hc = fc0.shape[1] // Wc
    stride = ff0.shape[2] // Hc
    scale_f = scale // stride   # the input over the fine map

    def unfold(ff):
        u = F.unfold(ff, kernel_size=(W, W), stride=stride, padding=W // 2)
        return u.view(B, ff.shape[1], WW, -1).permute(0, 3, 2, 1)   # (B, L, WW, C)

    b = torch.arange(B, device=i_ids.device)[:, None]
    w0, w1 = unfold(ff0)[b, i_ids], unfold(ff1)[b, j_ids]           # (B, K, WW, Cf)
    c_win = o.linear(torch.cat([fc0[b, i_ids], fc1[b, j_ids]], 0),
                     "fine_preprocess.down_proj")                   # (2B, K, df)
    merged = o.linear(torch.cat([torch.cat([w0, w1], 0),
                                 c_win[:, :, None].expand(-1, -1, WW, -1)], -1),
                      "fine_preprocess.merge_feat")
    df = merged.shape[-1]
    g0, g1 = merged.reshape(2, B * K, WW, df)
    g0, g1 = transformer(o, g0, g1, "loftr_fine", w["fine_pairs"], w["nhead"])
    sim = o.einsum("mc,mrc->mr", g0[:, WW // 2, :], g1)
    heat = torch.softmax(sim / df ** 0.5, dim=1).view(-1, W, W)     # rows y, columns x
    lin = torch.linspace(-1.0, 1.0, W, device=heat.device)
    coords = torch.stack([(heat.sum(1) * lin).sum(-1), (heat.sum(2) * lin).sum(-1)], -1)
    mkpts1_c = torch.stack([j_ids % Wc, j_ids // Wc], -1).float() * scale
    return mkpts1_c + (coords * (W // 2) * scale_f).view(B, K, 2)


def _forward_block(img0, img1, w, o, ids):
    B = img0.shape[0]
    fc, ff = backbone(o, torch.cat([img0, img1], 0))
    _, C, Hc, Wc = fc.shape
    fc = fc + sine_encoding(C, Hc, Wc, w["temp_bug_fix"], fc.device)
    fcl = fc.flatten(2).transpose(1, 2)                             # (2B, L, C)
    f0, f1 = transformer(o, fcl[:B], fcl[B:], "loftr_coarse", w["coarse_pairs"], w["nhead"])
    f0n, f1n = f0 / C ** 0.5, f1 / C ** 0.5
    sim = o.einsum("nlc,nsc->nls", f0n, f1n) / w["dsmax_temp"]
    conf = F.softmax(sim, 1) * F.softmax(sim, 2)
    b_ids, i_ids, _, _ = coarse_matches(conf, Hc, Wc, w["thr"], w["border_rm"])
    out = {"conf": conf, "counts": torch.bincount(b_ids, minlength=B)}
    if ids is not None:
        out["mkpts1_f"] = fine_at(o, w, ff[:B], ff[B:], f0, f1, Wc, img0.shape[2] // Hc, *ids)
    return out


def forward(sd: dict, img0, img1, w: dict = CVPR_DS, precision: str = "ref", ids=None,
            block: int = 1) -> dict:
    """img0/img1: (B, 1, H, W) in [0, 1], on the weights' device.  Returns
    ``conf`` (B, L, S), ``counts`` (B,) of the upstream's matches, and with
    ``ids`` = (i_ids, j_ids), each (B, K), ``mkpts1_f`` (B, K, 2) there."""
    parts = []
    with torch.no_grad(), _matmul_precision(precision):
        o = _Ops(sd, precision)
        for s in range(0, img0.shape[0], block):
            e = s + block
            sub = None if ids is None else (ids[0][s:e], ids[1][s:e])
            parts.append(_forward_block(img0[s:e], img1[s:e], w, o, sub))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
