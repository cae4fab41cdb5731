"""Corner matcher (port of the ``CornerMatcher`` half of
``bundlesdf_tpu/models/matcher.py``).

Harris corners + ZNCC patch descriptors + mutual nearest neighbour, with
static shapes: top-K corners per image, a (K, K) similarity product and a
fixed-capacity output with a validity mask, in the output contract of the
reference's LoftrRunner.predict (loftr_wrapper.py:29-82).  The pair
preprocessing (``tracking/corres.py``) already rotation- and scale-
normalizes both crops, so ZNCC suffices for the tracker's pairs.

Functions take a batch of image pairs (B, H, W); ``match_pair`` is the
batch of one.  Order rules kept from the JAX module:

- ``jax.lax.top_k`` puts the lower index first among equal values (the
  invalid corners all tie at -inf).  ``torch.topk`` promises no order, so
  top-k here is a stable descending sort, first k.
- ``argmax`` returns the first maximal index in both frameworks.
- The Harris box blur pads with 0 and the NMS max with -inf
  (``reduce_window(..., "SAME")``); ``avg_pool2d`` with
  ``count_include_pad=True`` and ``max_pool2d`` pad alike.  No convolution:
  cuDNN may run one in TF32.

``SiftMatcher`` (host OpenCV) is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class CornerMatcherCfg(NamedTuple):
    max_corners: int = 512
    patch: int = 8  # descriptor patch radius -> (2p, 2p) window sampled
    nms_radius: int = 2
    min_conf: float = 0.5
    max_matches: int = 512
    harris_k: float = 0.04


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values, the lower
    index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sobel(img: torch.Tensor):
    """Central differences with wrap-around (``jnp.roll``), over the last
    two dims."""
    gx = (torch.roll(img, -1, -1) - torch.roll(img, 1, -1)) * 0.5
    gy = (torch.roll(img, -1, -2) - torch.roll(img, 1, -2)) * 0.5
    return gx, gy


def _box_blur(img: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over the (2r+1)^2 window, zero outside the image; (B, H, W)."""
    k = 2 * r + 1
    return F.avg_pool2d(img[:, None], k, stride=1, padding=r,
                        count_include_pad=True)[:, 0]


def harris_response(img: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris response of (H, W) or (B, H, W) images."""
    single = img.ndim == 2
    if single:
        img = img[None]
    gx, gy = _sobel(img)
    Ixx = _box_blur(gx * gx, 2)
    Iyy = _box_blur(gy * gy, 2)
    Ixy = _box_blur(gx * gy, 2)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    resp = det - k * tr * tr
    return resp[0] if single else resp


def _top_corners(resp: torch.Tensor, cfg: CornerMatcherCfg):
    """NMS + top-K corner extraction of (B, H, W) responses.  Returns
    (B, K, 2) [u, v], (B, K) scores and (B, K) validity."""
    B, H, W = resp.shape
    r = cfg.nms_radius
    k = 2 * r + 1
    local_max = F.max_pool2d(resp[:, None], k, stride=1, padding=r)[:, 0]
    is_max = (resp >= local_max) & (resp > 0)
    m = cfg.patch + 1  # descriptor patch must fit
    interior = torch.zeros((H, W), dtype=torch.bool, device=resp.device)
    interior[m:H - m, m:W - m] = True
    score = torch.where(is_max & interior, resp, -torch.inf)
    top_scores, top_idx = _top_k(score.reshape(B, -1), cfg.max_corners)
    uu = (top_idx % W).to(torch.float32)
    vv = (top_idx // W).to(torch.float32)
    valid = torch.isfinite(top_scores) & (top_scores > 0)
    return torch.stack([uu, vv], dim=-1), top_scores, valid


def _descriptors(img: torch.Tensor, corners: torch.Tensor, patch: int):
    """ZNCC descriptors (B, K, (2p)^2): zero-mean unit-norm patches.  Valid
    corners lie inside the image border, so their patches are in range;
    the clamp only keeps the invalid corners' reads legal (their rows are
    masked out of the similarity)."""
    B, H, W = img.shape
    p = patch
    ar = torch.arange(-p, p, device=img.device)
    dv, du = torch.meshgrid(ar, ar, indexing="ij")
    vu = corners.flip(-1).to(torch.int64)  # (B, K, 2) [v, u]
    v = (vu[..., 0:1] + dv.reshape(1, 1, -1)).clamp(0, H - 1)
    u = (vu[..., 1:2] + du.reshape(1, 1, -1)).clamp(0, W - 1)
    vals = torch.gather(img.reshape(B, -1), 1, (v * W + u).reshape(B, -1))
    vals = vals.reshape(B, corners.shape[1], -1)
    vals = vals - vals.mean(dim=-1, keepdim=True)
    norm = torch.linalg.norm(vals, dim=-1, keepdim=True)
    return vals / torch.clamp(norm, min=1e-6)


def match_pairs_batched(imgs_a: torch.Tensor, imgs_b: torch.Tensor,
                        cfg: CornerMatcherCfg = CornerMatcherCfg()):
    """Match B pairs of preprocessed grayscale images ((B, H, W), [0,1] or
    [0,255]) in one pass (the reference's batched LoFTR predict,
    loftr_wrapper.py:43-58).

    Returns dict: corres (B, M, 5) [uA, vA, uB, vB, conf] compacted valid
    first by confidence, valid (B, M) — M = cfg.max_matches."""
    a = imgs_a.to(torch.float32)
    b = imgs_b.to(torch.float32)
    a = a / torch.clamp(a.amax(dim=(-2, -1), keepdim=True), min=1e-6)
    b = b / torch.clamp(b.amax(dim=(-2, -1), keepdim=True), min=1e-6)
    ca, _, va = _top_corners(harris_response(a, cfg.harris_k), cfg)
    cb, _, vb = _top_corners(harris_response(b, cfg.harris_k), cfg)
    da = _descriptors(a, ca, cfg.patch)
    db = _descriptors(b, cb, cfg.patch)
    sim = torch.bmm(da, db.transpose(1, 2))
    sim = torch.where(va[:, :, None] & vb[:, None, :], sim, -2.0)
    best_ab = torch.argmax(sim, dim=2)  # (B, K)
    best_ba = torch.argmax(sim, dim=1)  # (B, K)
    K = cfg.max_corners
    mutual = torch.gather(best_ba, 1, best_ab) == torch.arange(K, device=sim.device)
    conf = torch.amax(sim, dim=2)
    ok = mutual & (conf > cfg.min_conf) & va
    matched_b = torch.gather(cb, 1, best_ab[..., None].expand(-1, -1, 2))
    corres = torch.cat([ca, matched_b, conf[..., None]], dim=-1)  # (B, K, 5)
    top_conf, order = _top_k(torch.where(ok, conf, -torch.inf), cfg.max_matches)
    corres = torch.gather(corres, 1, order[..., None].expand(-1, -1, 5))
    valid = torch.isfinite(top_conf)
    corres = torch.where(valid[..., None], corres, 0.0)
    return {"corres": corres, "valid": valid}


def match_pair(img_a: torch.Tensor, img_b: torch.Tensor,
               cfg: CornerMatcherCfg = CornerMatcherCfg()):
    """One pair of (H, W) images: corres (M, 5), valid (M,)."""
    res = match_pairs_batched(img_a[None], img_b[None], cfg)
    return {k: v[0] for k, v in res.items()}
