"""LoFTR detector-free transformer matcher (port of
``bundlesdf_tpu/models/loftr_jax.py``), as ``nn.Module``s.

The reference LoFTR (BundleTrack/LoFTR/src/loftr/): ResNet-FPN 8_2 backbone
(backbone/resnet_fpn.py), 2D sine positional encoding
(utils/position_encoding.py), a coarse LocalFeatureTransformer of 4 x (self,
cross) linear-attention layers (loftr_module/transformer.py,
linear_attention.py), dual-softmax coarse matching at temperature 0.1
(utils/coarse_matching.py), 5 x 5 fine windows with the coarse feature
concatenated (loftr_module/fine_preprocess.py), a 1 x (self, cross) fine
transformer, and the expectation over the fine heatmap
(utils/fine_matching.py).

As in the JAX module, matching has fixed capacity: the coarse matches are a
static top-K (K = ``max_matches``, first index first among equal scores)
with a validity mask, and the fine stage gathers K windows unconditionally,
clamped at the feature map's border.  BatchNorm always uses its running
statistics (flax ``use_running_average=True``), in training too.

Submodules carry the reference torch LoFTR's state-dict names
(``backbone.layer1.0.conv1``, ``loftr_coarse.layers.3.q_proj``,
``fine_preprocess.merge_feat``), so a released ``outdoor_ds.ckpt`` loads with
``load_state_dict`` once its ``matcher.`` prefix is stripped
(``load_checkpoint``).  ``state_dict_from_flax`` turns the JAX module's
params into such a state dict.

``LoftrMatcher`` is the host contract of the reference LoftrRunner.predict
(loftr_wrapper.py:29-82) that ``tracking/corres.py::make_matcher`` builds
for ``feature_corres.matcher: loftr``.  The network is plain torch
(PyTorch's im2col convolutions, cuBLAS f32 GEMMs); it has no hand-written
kernel, as the JAX module has no Pallas one.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device

# LoftrMatcher.predict calls since the last reset.
launches = 0


class LoftrCfg(NamedTuple):
    initial_dim: int = 128
    block_dims: Sequence[int] = (128, 196, 256)
    d_coarse: int = 256
    d_fine: int = 128
    nhead: int = 8
    coarse_pairs: int = 4   # x (self, cross)
    fine_pairs: int = 1
    window: int = 5
    dsmax_temp: float = 0.1
    thr: float = 0.2
    border_rm: int = 2
    max_matches: int = 512
    # The shipped reference pipeline builds LoFTR from cvpr_ds_config
    # (TEMP_BUG_FIX False): the released outdoor_ds.ckpt was trained with
    # the buggy positional-encoding temperature.
    temp_bug_fix: bool = False


# ---------------------------------------------------------------- backbone
class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalizes with its running statistics, in
    ``train()`` mode too (flax ``BatchNorm(use_running_average=True)``):
    batch statistics are never used or accumulated.

    The JAX trainer differentiates those statistics like any weight (they
    sit in the variables it hands to optax), so when they require grad
    (``models/loftr_train.py``) the layer is written out as flax computes
    it, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, which autograd
    differentiates with respect to them."""

    def forward(self, x):
        if self.running_mean.requires_grad or self.running_var.requires_grad:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                    + self.bias[:, None, None])
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride)
        self.conv2 = _conv(planes, planes, 3)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = None if stride == 1 else nn.Sequential(
            _conv(in_planes, planes, 1, stride), FrozenBatchNorm2d(planes))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample with align_corners=True (resnet_fpn.py:110)."""
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=True)


@contextlib.contextmanager
def _without_cudnn():
    """PyTorch's own convolutions (im2col + cuBLAS GEMM) instead of cuDNN's.
    For these f32 convolutions (TF32 off) cuDNN picks FFT tiling, tens of
    thousands of small complex GEMMs: on the H100 a 400 x 400 pair took
    323-485 ms and 21.6 GB on cuDNN against 22-23 ms and 1.4 GB here
    (chip_smoke.py loftr_parity, PERF.md §6)."""
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


class ResNetFPN82(nn.Module):
    """ResNet + FPN: (B, 1, H, W) -> 1/8 (coarse, block_dims[2]) and 1/2
    (fine, block_dims[0]) feature maps, NCHW."""

    def __init__(self, cfg: LoftrCfg):
        super().__init__()
        d0, d1, d2 = cfg.block_dims
        self.conv1 = nn.Conv2d(1, cfg.initial_dim, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(cfg.initial_dim)
        self.layer1 = nn.Sequential(BasicBlock(cfg.initial_dim, d0, 1), BasicBlock(d0, d0, 1))
        self.layer2 = nn.Sequential(BasicBlock(d0, d1, 2), BasicBlock(d1, d1, 1))
        self.layer3 = nn.Sequential(BasicBlock(d1, d2, 2), BasicBlock(d2, d2, 1))
        self.layer3_outconv = _conv(d2, d2, 1)
        self.layer2_outconv = _conv(d1, d2, 1)
        self.layer2_outconv2 = nn.Sequential(_conv(d2, d2, 3), FrozenBatchNorm2d(d2),
                                             nn.LeakyReLU(0.01), _conv(d2, d1, 3))
        self.layer1_outconv = _conv(d0, d1, 1)
        self.layer1_outconv2 = nn.Sequential(_conv(d1, d1, 3), FrozenBatchNorm2d(d1),
                                             nn.LeakyReLU(0.01), _conv(d1, d0, 3))

    def forward(self, x):
        with _without_cudnn():
            return self._forward(x)

    def _forward(self, x):
        x0 = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x3_out = self.layer3_outconv(x3)
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2) + _upsample2x(x3_out))
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1) + _upsample2x(x2_out))
        return x3_out, x1_out  # coarse 1/8, fine 1/2


# ----------------------------------------------------------- pos encoding
def sine_pos_encoding(H: int, W: int, d_model: int,
                      temp_bug_fix: bool = True) -> np.ndarray:
    """(H, W, d_model) 2D sine positional encoding (position_encoding.py:
    22-34).  ``temp_bug_fix=False`` reproduces the original temperature
    ``(-log(1e4)/d_model)//2`` (a floor-division precedence bug that the
    released checkpoints were trained with)."""
    pe = np.zeros((d_model, H, W), dtype=np.float32)
    y_pos = np.cumsum(np.ones((H, W)), axis=0)[None]
    x_pos = np.cumsum(np.ones((H, W)), axis=1)[None]
    if temp_bug_fix:
        temp = -math.log(10000.0) / (d_model // 2)
    else:
        temp = (-math.log(10000.0) / d_model) // 2
    div = np.exp(np.arange(0, d_model // 2, 2) * temp)[:, None, None]
    pe[0::4] = np.sin(x_pos * div)
    pe[1::4] = np.cos(x_pos * div)
    pe[2::4] = np.sin(y_pos * div)
    pe[3::4] = np.cos(y_pos * div)
    return np.moveaxis(pe, 0, -1)


# ------------------------------------------------------------ transformer
def linear_attention(q, k, v, eps: float = 1e-6):
    """elu + 1 kernelized attention (linear_attention.py:18-50).
    q: (B, L, H, D), k/v: (B, S, H, D)."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    v_len = v.shape[1]
    v = v / v_len
    KV = torch.einsum("bshd,bshv->bhdv", K, v)
    Z = 1.0 / (torch.einsum("blhd,bhd->blh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("blhd,bhdv->blhv", Q, KV) * Z[..., None] * v_len


class LoftrEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(nn.Linear(d_model * 2, d_model * 2, bias=False), nn.ReLU(),
                                 nn.Linear(d_model * 2, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, source):
        B, L, C = x.shape
        h = self.nhead
        q = self.q_proj(x).reshape(B, -1, h, C // h)
        k = self.k_proj(source).reshape(B, -1, h, C // h)
        v = self.v_proj(source).reshape(B, -1, h, C // h)
        msg = self.norm1(self.merge(linear_attention(q, k, v).reshape(B, L, C)))
        msg = self.norm2(self.mlp(torch.cat([x, msg], dim=-1)))
        return x + msg


class LocalFeatureTransformer(nn.Module):
    def __init__(self, d_model: int, nhead: int, n_pairs: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [LoftrEncoderLayer(d_model, nhead) for _ in range(2 * n_pairs)])

    def forward(self, f0, f1):
        for i in range(0, len(self.layers), 2):
            self_l, cross_l = self.layers[i], self.layers[i + 1]
            f0 = self_l(f0, f0)
            f1 = self_l(f1, f1)
            # sequential cross update (transformer.py:94-96): feat1 attends
            # to the already-updated feat0
            f0 = cross_l(f0, f1)
            f1 = cross_l(f1, f0)
        return f0, f1


class FinePreprocess(nn.Module):
    def __init__(self, cfg: LoftrCfg):
        super().__init__()
        self.down_proj = nn.Linear(cfg.d_coarse, cfg.d_fine, bias=True)
        self.merge_feat = nn.Linear(cfg.block_dims[0] + cfg.d_fine, cfg.d_fine, bias=True)


# --------------------------------------------------- coarse/fine matching
def dual_softmax_conf(f0: torch.Tensor, f1: torch.Tensor, temp: float) -> torch.Tensor:
    """Dual-softmax confidence matrix (coarse_matching.py:109-119):
    features (B, L, C) / (B, S, C) -> (B, L, S)."""
    d = f0.shape[-1]
    sim = torch.einsum("bld,bsd->bls", f0 / d ** 0.5, f1 / d ** 0.5) / temp
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)


def coarse_match_fixed(conf: torch.Tensor, Hc: int, Wc: int, thr: float,
                       border_rm: int, K: int):
    """Fixed-capacity coarse match selection (coarse_matching.py
    get_coarse_match :150-196, eval path): confidence threshold, border
    removal and mutual nearest, then the top K by confidence (the lower
    cell first among equal scores, as ``jax.lax.top_k``).

    conf: (B, L, S), L == S == Hc * Wc.  Returns (i_ids, j_ids, mconf,
    valid), each (B, K) with K clamped to L."""
    best_j = torch.argmax(conf, dim=2)          # (B, L)
    best_i = torch.argmax(conf, dim=1)          # (B, S)
    l_idx = torch.arange(Hc * Wc, device=conf.device)
    mutual = torch.gather(best_i, 1, best_j) == l_idx
    conf_best = conf.amax(dim=2)
    rm = border_rm

    def inside(idx):
        y, x = idx // Wc, idx % Wc
        return (y >= rm) & (y < Hc - rm) & (x >= rm) & (x < Wc - rm)

    ok = mutual & (conf_best > thr) & inside(l_idx)[None] & inside(best_j)
    score = torch.where(ok, conf_best, torch.full_like(conf_best, -1.0))
    K = min(K, score.shape[1])
    mconf, i_ids = torch.sort(score, dim=1, descending=True, stable=True)
    mconf, i_ids = mconf[:, :K], i_ids[:, :K]
    j_ids = torch.gather(best_j, 1, i_ids)
    valid = mconf > 0
    return i_ids, j_ids, torch.where(valid, mconf, torch.zeros_like(mconf)), valid


def fine_expectation(w0f: torch.Tensor, w1f: torch.Tensor, W: int) -> torch.Tensor:
    """Expectation over the fine heatmap (fine_matching.py:43-54): window
    features (M, WW, C) x 2 -> sub-cell [dx, dy] of the match in image 1,
    normalized to [-1, 1], (M, 2)."""
    WW = W * W
    C = w0f.shape[-1]
    center = w0f[:, WW // 2, :]
    heat = torch.softmax(torch.einsum("mc,mrc->mr", center, w1f) / C ** 0.5, dim=1)
    ax = torch.arange(W, dtype=torch.float32, device=w0f.device) / (W // 2) - 1.0
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (WW, 2) [x, y]
    return heat @ grid


# ----------------------------------------------------------------- LoFTR
class LoftrModule(nn.Module):
    def __init__(self, cfg: LoftrCfg = LoftrCfg()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetFPN82(cfg)
        self.loftr_coarse = LocalFeatureTransformer(cfg.d_coarse, cfg.nhead, cfg.coarse_pairs)
        self.fine_preprocess = FinePreprocess(cfg)
        self.loftr_fine = LocalFeatureTransformer(cfg.d_fine, cfg.nhead, cfg.fine_pairs)
        self._pe: dict = {}

    def pos_encoding(self, Hc: int, Wc: int, device) -> torch.Tensor:
        key = (Hc, Wc, str(device))
        if key not in self._pe:
            c = self.cfg
            self._pe[key] = torch.from_numpy(
                sine_pos_encoding(Hc, Wc, c.d_coarse, c.temp_bug_fix)).to(device)
        return self._pe[key]

    def forward(self, img0, img1, gt_ids=None):
        """img0/img1: (B, 1, H, W) grayscale in [0, 1], H and W multiples of 8.

        Inference (``gt_ids`` None) returns fixed-capacity matches per batch
        item: mkpts0, mkpts1 (B, K, 2) pixel coords, conf (B, K), valid
        (B, K), and the coarse conf_matrix (B, L, S) with the selected
        i_ids, j_ids (B, K).

        Training (``gt_ids`` = (i_ids, j_ids), each (B, K) coarse cell ids)
        teacher-forces the fine branch at those cells and returns
        conf_matrix, mkpts0 and mkpts1_f (the loss's supervision points)."""
        c = self.cfg
        B = img0.shape[0]
        fc, ff = self.backbone(torch.cat([img0, img1], dim=0))
        _, Dc, Hc, Wc = fc.shape
        Hf, Wf = ff.shape[2:]
        pe = self.pos_encoding(Hc, Wc, fc.device)
        fcl = (fc.permute(0, 2, 3, 1) + pe).reshape(2 * B, Hc * Wc, Dc)
        f0, f1 = self.loftr_coarse(fcl[:B], fcl[B:])
        conf = dual_softmax_conf(f0, f1, c.dsmax_temp)

        ffl = ff.permute(0, 2, 3, 1)  # (2B, Hf, Wf, Df)
        ff0, ff1 = ffl[:B], ffl[B:]
        W = c.window
        stride = Hf // Hc
        r = torch.arange(-(W // 2), W // 2 + 1, device=fc.device)
        oy, ox = torch.meshgrid(r, r, indexing="ij")
        oy, ox = oy.reshape(-1), ox.reshape(-1)  # (WW,) [dy, dx]
        WW = W * W
        bidx = torch.arange(B, device=fc.device)[:, None, None]

        def windows(feat_f, ids):
            cy = (ids // Wc) * stride
            cx = (ids % Wc) * stride
            yy = (cy[..., None] + oy).clamp(0, Hf - 1)
            xx = (cx[..., None] + ox).clamp(0, Wf - 1)
            return feat_f[bidx, yy, xx]  # (B, K, WW, Df)

        def fine_refine(i_ids, j_ids):
            """Window gather at the coarse cells -> fine transformer ->
            heatmap expectation: the sub-cell delta (B, K, 2) in pixels."""
            Kn = i_ids.shape[1]
            fp = self.fine_preprocess
            d0 = fp.down_proj(torch.gather(f0, 1, i_ids[..., None].expand(-1, -1, Dc)))
            d1 = fp.down_proj(torch.gather(f1, 1, j_ids[..., None].expand(-1, -1, Dc)))
            w0, w1 = windows(ff0, i_ids), windows(ff1, j_ids)
            w0m = fp.merge_feat(torch.cat(
                [w0, d0[:, :, None, :].expand(-1, -1, WW, -1)], dim=-1))
            w1m = fp.merge_feat(torch.cat(
                [w1, d1[:, :, None, :].expand(-1, -1, WW, -1)], dim=-1))
            w0f, w1f = self.loftr_fine(w0m.reshape(B * Kn, WW, c.d_fine),
                                       w1m.reshape(B * Kn, WW, c.d_fine))
            coords = fine_expectation(w0f, w1f, W)
            return coords.reshape(B, Kn, 2) * (W // 2) * 2  # fine -> input: x2

        def cells_to_px(ids):
            return torch.stack([ids % Wc, ids // Wc], dim=-1).to(torch.float32) * 8

        if gt_ids is not None:
            i_ids, j_ids = gt_ids
            return {"conf_matrix": conf, "mkpts0": cells_to_px(i_ids),
                    "mkpts1_f": cells_to_px(j_ids) + fine_refine(i_ids, j_ids)}

        i_ids, j_ids, top_conf, valid = coarse_match_fixed(
            conf, Hc, Wc, c.thr, c.border_rm, c.max_matches)
        return {"mkpts0": cells_to_px(i_ids),
                "mkpts1": cells_to_px(j_ids) + fine_refine(i_ids, j_ids),
                "conf": top_conf, "valid": valid,
                "conf_matrix": conf, "i_ids": i_ids, "j_ids": j_ids}


def init_weights(module: LoftrModule, seed: int = 0) -> LoftrModule:
    """Seeded random weights from one ``torch.Generator``: the reference's
    init schemes (kaiming-normal fan-out convolutions, resnet_fpn.py:64-69;
    xavier-uniform transformer matrices, transformer.py:98-101), BatchNorm
    at identity.  They cannot equal the JAX module's flax init (another
    random stream); tests carry one set of weights to both packages."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                        generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=gen)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(m.weight.shape[1])
                    nn.init.uniform_(m.bias, -bound, bound, generator=gen)
    return module


def load_weights(module: LoftrModule, state_dict: dict) -> LoftrModule:
    """Load a reference-layout state dict (arrays or tensors; a ``matcher.``
    prefix is stripped).  Every weight must be present: only BatchNorm's
    ``num_batches_tracked`` may be absent.  Keys the module does not have
    are ignored, as ``convert_torch_state_dict`` ignores them."""
    sd = {(k[len("matcher."):] if k.startswith("matcher.") else k): torch.as_tensor(v)
          for k, v in state_dict.items()}
    missing = [k for k in module.load_state_dict(sd, strict=False).missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"LoFTR weights missing: {missing}")
    return module


class LoftrMatcher:
    """Host contract of the reference LoftrRunner.predict (loftr_wrapper.py:
    29-82): batched grayscale pairs -> per-pair (K, 5) [uA, vA, uB, vB, conf]
    and validity, as numpy.

    ``state_dict``: reference-layout weights (``load_checkpoint`` reads them
    from a file); without one, seeded random weights (``init_weights``).
    ``device``: where the network runs (None = CUDA; raises without one)."""

    def __init__(self, cfg: LoftrCfg = LoftrCfg(), state_dict=None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        module = init_weights(LoftrModule(cfg), seed)
        if state_dict is not None:
            load_weights(module, state_dict)
        self.module = module.to(self.device).eval()

    def predict(self, grayAs, grayBs):
        """grayAs/grayBs: (B, H, W) grayscale, [0, 255] or [0, 1] (numpy or
        tensors): both are divided by 255 when A's maximum exceeds 1.5, and
        cropped to multiples of 8."""
        global launches
        a = torch.as_tensor(grayAs, dtype=torch.float32).to(self.device)
        b = torch.as_tensor(grayBs, dtype=torch.float32).to(self.device)
        if float(a.max()) > 1.5:
            a = a / 255.0
            b = b / 255.0
        H8 = a.shape[1] - a.shape[1] % 8
        W8 = a.shape[2] - a.shape[2] % 8
        launches += 1
        with torch.inference_mode():
            out = self.module(a[:, None, :H8, :W8], b[:, None, :H8, :W8])
            corres = torch.cat([out["mkpts0"], out["mkpts1"], out["conf"][..., None]], dim=-1)
            return corres.cpu().numpy(), out["valid"].cpu().numpy()


# ------------------------------------------------------- weight transfer
def state_dict_from_flax(params: dict, cfg: LoftrCfg = LoftrCfg()) -> dict:
    """The JAX module's params ({'params': ..., 'batch_stats': ...}, numpy
    or arrays) as a reference-layout torch state dict: the inverse of
    ``bundlesdf_tpu/models/loftr_jax.py::convert_torch_state_dict``
    (:442-528).  BatchNorm's ``num_batches_tracked`` is not produced."""
    P, S = params["params"], params.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def node(tree, path):
        for p in path:
            tree = tree[p]
        return tree

    def conv(tpath, fpath):
        sd[tpath + ".weight"] = t(np.transpose(np.asarray(node(P, fpath)["kernel"]),
                                               (3, 2, 0, 1)))

    def bn(tpath, fpath):
        p, s = node(P, fpath), node(S, fpath)
        sd[tpath + ".weight"] = t(p["scale"])
        sd[tpath + ".bias"] = t(p["bias"])
        sd[tpath + ".running_mean"] = t(s["mean"])
        sd[tpath + ".running_var"] = t(s["var"])

    def dense(tpath, fpath):
        p = node(P, fpath)
        sd[tpath + ".weight"] = t(np.asarray(p["kernel"]).T)
        if "bias" in p:
            sd[tpath + ".bias"] = t(p["bias"])

    B = ("backbone",)
    conv("backbone.conv1", B + ("conv1",))
    bn("backbone.bn1", B + ("bn1",))
    for layer in ("layer1", "layer2", "layer3"):
        for bi in range(2):
            base, fb = f"backbone.{layer}.{bi}", B + (f"{layer}_{bi}",)
            conv(f"{base}.conv1", fb + ("conv1",))
            conv(f"{base}.conv2", fb + ("conv2",))
            bn(f"{base}.bn1", fb + ("bn1",))
            bn(f"{base}.bn2", fb + ("bn2",))
            if "down_conv" in node(P, fb):
                conv(f"{base}.downsample.0", fb + ("down_conv",))
                bn(f"{base}.downsample.1", fb + ("down_bn",))
    for name in ("layer3_outconv", "layer2_outconv", "layer1_outconv"):
        conv(f"backbone.{name}", B + (name,))
    for lvl in ("layer2", "layer1"):
        conv(f"backbone.{lvl}_outconv2.0", B + (f"{lvl}_outconv2_0",))
        bn(f"backbone.{lvl}_outconv2.1", B + (f"{lvl}_outconv2_bn",))
        conv(f"backbone.{lvl}_outconv2.3", B + (f"{lvl}_outconv2_1",))

    def enc_layer(tbase, fbase):
        for name in ("q_proj", "k_proj", "v_proj", "merge"):
            dense(f"{tbase}.{name}", fbase + (name,))
        dense(f"{tbase}.mlp.0", fbase + ("mlp_0",))
        dense(f"{tbase}.mlp.2", fbase + ("mlp_1",))
        for n in ("norm1", "norm2"):
            p = node(P, fbase + (n,))
            sd[f"{tbase}.{n}.weight"] = t(p["scale"])
            sd[f"{tbase}.{n}.bias"] = t(p["bias"])

    for i in range(cfg.coarse_pairs * 2):
        enc_layer(f"loftr_coarse.layers.{i}", ("loftr_coarse", f"layer{i}"))
    for i in range(cfg.fine_pairs * 2):
        enc_layer(f"loftr_fine.layers.{i}", ("loftr_fine", f"layer{i}"))
    dense("fine_preprocess.down_proj", ("fine_down_proj",))
    dense("fine_preprocess.merge_feat", ("fine_merge_feat",))
    return sd


def read_state_dict(path: str, cfg: LoftrCfg = LoftrCfg()) -> dict:
    """Reference-layout weights from a file: a torch checkpoint
    (``.ckpt``/``.pth``, its ``state_dict`` or the whole file; the reference
    ``outdoor_ds.ckpt`` that loftr_wrapper.py:24 loads, or what
    ``loftr_train.train_loftr`` saves) or an ``.npz`` of the JAX module's
    params (keys '/'-joined pytree paths, as ``loftr_jax.save_params_npz``
    and the JAX trainer write them)."""
    if path.endswith(".npz"):
        flat = np.load(path)
        tree: dict = {}
        for k in flat.files:
            node = tree
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[k]
        return state_dict_from_flax(tree, cfg)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt)


def load_checkpoint(path: str, cfg: LoftrCfg = LoftrCfg(), device=None) -> LoftrMatcher:
    """A LoftrMatcher from a weights file (``read_state_dict``).  A missing
    weight raises."""
    return LoftrMatcher(cfg, state_dict=read_state_dict(path, cfg), device=device)
