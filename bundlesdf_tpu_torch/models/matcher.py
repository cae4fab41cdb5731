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

``SiftMatcher`` is the JAX package's OpenCV SIFT engine on the device:
``ops/sift.py`` stands in for ``cv2.SIFT_create``, and the brute-force
ratio-tested mutual kNN runs as one distance product per pair.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import sift as sift_ops
from ..utils.device import resolve_device


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


class SiftMatcher:
    """SIFT + ratio-tested mutual kNN (the JAX ``SiftMatcher``,
    ``bundlesdf_tpu/models/matcher.py:160-228``, after the reference
    SiftManager, FeatureManager.h:98-213), with the same ``predict``
    contract: (B, H, W) grayscale pairs -> ((B, K, 5) [uA, vA, uB, vB,
    conf], (B, K) valid) numpy arrays.  Detection and matching run on
    ``device`` (None = CUDA); both images of every pair share one scale
    space.

    Descriptors are integer-valued, so squared L2 distances are exact
    integers; they are formed in f64, so no TF32 setting can move a ratio
    test decided at its margin.  The distance is then the f32 square root,
    as OpenCV's BFMatcher computes it, and the ratio test and ``conf = 1 /
    (1 + d)`` are taken in f64 as the JAX engine's Python does."""

    # Like the JAX engine: find_corres runs exactly the fresh pairs,
    # unpadded.
    compiled = False

    def __init__(self, max_matches: int = 512, ratio: float = 0.8,
                 nfeatures: int = 2000, device=None):
        self.device = resolve_device(device)
        self.max_matches = max_matches
        self.ratio = ratio
        self.nfeatures = nfeatures

    def _to_uint8(self, grayAs, grayBs):
        """The JAX engine's conversion: non-uint8 batches are divided by A's
        maximum when it is <= 1.5 (then x 255), and truncated to uint8."""
        a = torch.as_tensor(grayAs).to(self.device)
        b = torch.as_tensor(grayBs).to(self.device)
        if a.dtype != torch.uint8:
            if not a.is_floating_point():
                a, b = a.double(), b.double()
            mx = max(float(a.max()), 1e-6)
            if mx <= 1.5:
                a = a / mx * 255
                b = b / mx * 255
            a, b = a.to(torch.uint8), b.to(torch.uint8)
        return a, b

    def _ratio_knn(self, d: torch.Tensor):
        """Each row's nearest column under the f32 distances ``d``, its
        distance, and whether it passes the ratio test against the second
        nearest (BFMatcher knnMatch with k = 2)."""
        vals, idx = torch.topk(d, 2, dim=1, largest=False)
        ok = vals[:, 0].double() < self.ratio * vals[:, 1].double()
        return idx[:, 0], vals[:, 0], ok

    def _match_one(self, ka: dict, kb: dict, na: int, nb: int):
        K = self.max_matches
        out = torch.zeros((K, 5), dtype=torch.float32, device=self.device)
        valid = torch.zeros(K, dtype=torch.bool, device=self.device)
        if na < 2 or nb < 2:
            return out, valid
        da, db = ka["desc"][:na].double(), kb["desc"][:nb].double()
        sq = (da * da).sum(1)[:, None] + (db * db).sum(1)[None, :] - 2.0 * da @ db.T
        d = torch.sqrt(sq.clamp(min=0).float())
        ab, dist, ok_ab = self._ratio_knn(d)
        ba, _, ok_ba = self._ratio_knn(d.T)
        mutual = ok_ab & ok_ba[ab] & (ba[ab] == torch.arange(na, device=self.device))
        conf = 1.0 / (1.0 + dist.double())
        rows = torch.cat([ka["pt"][:na], kb["pt"][ab]], dim=1).double()
        rows = torch.cat([rows, conf[:, None]], dim=1)[mutual]
        order = torch.sort(-rows[:, 4], stable=True).indices[:K]
        n = order.shape[0]
        out[:n] = rows[order].float()
        valid[:n] = True
        return out, valid

    def predict(self, grayAs, grayBs):
        a, b = self._to_uint8(grayAs, grayBs)
        B = a.shape[0]
        feats = sift_ops.detect_and_compute(torch.cat([a, b]), self.nfeatures)
        counts = feats["count"].tolist()
        outs = []
        for i in range(B):
            ka = {k: feats[k][i] for k in ("pt", "desc")}
            kb = {k: feats[k][B + i] for k in ("pt", "desc")}
            outs.append(self._match_one(ka, kb, counts[i], counts[B + i]))
        corres = torch.stack([o[0] for o in outs]).cpu().numpy()
        valid = torch.stack([o[1] for o in outs]).cpu().numpy()
        return corres, valid
