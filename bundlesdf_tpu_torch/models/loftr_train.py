"""Training harness for the LoFTR-class matcher (port of
``bundlesdf_tpu/models/loftr_train.py``).

The reference vendors a PyTorch-Lightning + DDP trainer for LoFTR
(BundleTrack/LoFTR/train.py, src/losses/loftr_loss.py) that BundleSDF does
not run: it loads a pretrained checkpoint.  The repo has no such weights and
fetches none, so this trainer is the way to a LoFTR that matches:

* supervision  -- homography-warped image pairs generated on the fly
  (``make_batch``), or pairs of rendered views of random textured sphere
  unions with exact depth and pose (``build_depth_view_pool``,
  ``make_depth_batch``).  GT coarse assignment = each 1/8-grid cell centre
  of img0 mapped into img1; GT fine position = its exact pixel there.
* losses       -- focal loss on the dual-softmax confidence matrix and the
  l2 loss of the fine-refined position (``coarse_focal_loss``,
  ``fine_l2_loss``: reference loftr_loss.py).
* optimizer    -- the JAX trainer's optax chain, ``clip_by_global_norm(1.0)``
  then ``adamw`` on a warmup-cosine schedule (``LoftrOptimizer``).

Every generator takes its random numbers as optional arguments (the raw
[0, 1) uniforms or standard normals that the JAX function draws from its
keys, mapped to ranges as ``jax.random.uniform`` maps them) and draws them
from a ``torch.Generator`` when they are absent.  Images are NCHW
``(B, 1, H, W)``: the JAX batch's ``(B, H, W, 1)`` transposed.

Run ``python3 -m bundlesdf_tpu_torch.models.loftr_train`` for a smoke train;
``--out`` writes a state dict under the reference's names, which
``models/loftr.py::load_checkpoint`` loads.  Data-parallel training over
several devices (the JAX ``mesh``) is not ported.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .loftr import (LoftrCfg, LoftrModule, _without_cudnn, init_weights, load_weights,
                    read_state_dict)


def _span(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(key, shape, lo, hi)`` from the same key's [0, 1)
    draw ``u``: ``max(lo, u * (hi - lo) + lo)`` with the bounds in f32."""
    lo_t = torch.tensor(lo, dtype=u.dtype, device=u.device)
    hi_t = torch.tensor(hi, dtype=u.dtype, device=u.device)
    return torch.maximum(u * (hi_t - lo_t) + lo_t, lo_t)


def _rand(gen, device, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device)


def _resize_linear(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """``jax.image.resize(x, (H, W), "linear")`` for an upsampling: bilinear
    with half-pixel centres (within 1 f32 ulp on the textures' shapes)."""
    return F.interpolate(x[None, None], size=(H, W), mode="bilinear",
                         align_corners=False)[0, 0]


def _normalize(img: torch.Tensor) -> torch.Tensor:
    img = img - img.min()
    return img / (img.max() + 1e-8)


# ------------------------------------------------------------------- data
def random_texture(H: int, W: int, lows=None, generator=None, device=None) -> torch.Tensor:
    """Multi-scale random texture: three uniform grids of (H/8, W/8),
    (H/4, W/4), (H/2, W/2) (``lows``) upsampled and summed, normalized to
    [0, 1]."""
    if lows is None:
        lows = [_rand(generator, device, H // s, W // s) for s in (8, 4, 2)]
    img = torch.zeros((H, W), device=lows[0].device)
    for low in lows:
        img = img + _resize_linear(low, H, W)
    return _normalize(img)


def random_dots_texture(H: int, W: int, n_dots: int = 96, centers=None, radii=None,
                        vals=None, shade=None, generator=None, device=None) -> torch.Tensor:
    """Random bright/dark soft discs on a mid-grey base under a low-frequency
    shading (the synthetic fixtures' texture family).  Draws: ``centers``
    (n_dots, 2), ``radii`` (n_dots,), ``vals`` (n_dots,), ``shade`` (4, 4),
    each in [0, 1)."""
    if centers is None:
        centers = _rand(generator, device, n_dots, 2)
        radii = _rand(generator, device, n_dots)
        vals = _rand(generator, device, n_dots)
        shade = _rand(generator, device, 4, 4)
    dev = centers.device
    c = centers * torch.tensor([H - 1.0, W - 1.0], device=dev)
    r = _span(radii, 2.0, 6.0)
    v = _span(vals, -0.5, 0.5)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    d2 = (ys - c[:, 0]) ** 2 + (xs - c[:, 1]) ** 2
    disc = torch.sigmoid((r ** 2 - d2) / (r + 1.0))  # soft edge
    img = 0.5 + torch.sum(disc * v, dim=-1)
    img = img * (0.7 + 0.6 * _resize_linear(shade, H, W))
    return _normalize(img)


def mixed_texture(H: int, W: int, sel=None, lows=None, dots=None, generator=None,
                  device=None) -> torch.Tensor:
    """``random_texture`` when the draw ``sel`` < 0.5, else
    ``random_dots_texture`` (``dots``: its four draws)."""
    if sel is None:
        sel = _rand(generator, device)
    a = random_texture(H, W, lows, generator, device)
    b = random_dots_texture(H, W, 96, *(dots or ()), generator=generator, device=device)
    return torch.where(sel < 0.5, a, b)


def random_object_mask(H: int, W: int, center=None, radii=None, ang=None,
                       generator=None, device=None) -> torch.Tensor:
    """Soft random ellipse ~ an object's silhouette: the production matcher
    sees masked object crops on black (process_image_pair), so the
    curriculum has texture islands with black surrounds.  Draws: ``center``
    (2,), ``radii`` (2,), ``ang`` ()."""
    if center is None:
        center = _rand(generator, device, 2)
        radii = _rand(generator, device, 2)
        ang = _rand(generator, device)
    cy, cx = _span(center, 0.38, 0.62)
    ry, rx = _span(radii, 0.22, 0.42)
    a = _span(ang, 0.0, np.pi)
    dev = center.device
    ys = (torch.arange(H, dtype=torch.float32, device=dev)[:, None] / H) - cy
    xs = (torch.arange(W, dtype=torch.float32, device=dev)[None, :] / W) - cx
    c, s = torch.cos(a), torch.sin(a)
    u = (c * xs - s * ys) / rx
    v = (s * xs + c * ys) / ry
    return torch.sigmoid((1.0 - (u * u + v * v)) * 40.0)  # ~2 px soft edge


def random_homography(H: int, W: int, ang=None, scale=None, trans=None, persp=None,
                      max_angle=0.3, max_scale=0.15, max_trans=0.12, max_persp=1e-4,
                      generator=None, device=None) -> torch.Tensor:
    """Random similarity + mild perspective about the image centre, (3, 3)
    f32.  Draws: ``ang`` (), ``scale`` (), ``trans`` (2,), ``persp`` (2,)."""
    if ang is None:
        ang = _rand(generator, device)
        scale = _rand(generator, device)
        trans = _rand(generator, device, 2)
        persp = _rand(generator, device, 2)
    dev = ang.device
    a = _span(ang, -max_angle, max_angle)
    sc = 1.0 + _span(scale, -max_scale, max_scale)
    tx, ty = _span(trans, -max_trans, max_trans)
    px, py = _span(persp, -max_persp, max_persp)
    c, s = torch.cos(a) * sc, torch.sin(a) * sc
    cx, cy = W / 2.0, H / 2.0
    T1 = torch.tensor([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]], device=dev)
    T2 = torch.tensor([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]], device=dev)
    R = torch.stack([torch.stack([c, -s, tx * W]), torch.stack([s, c, ty * H]),
                     torch.stack([px, py, torch.ones((), device=dev)])])
    return T2 @ R @ T1


def warp_image(img: torch.Tensor, H_mat: torch.Tensor) -> torch.Tensor:
    """Inverse-warp ``img`` (H, W) by the homography ``H_mat`` (img0 px ->
    img1 px): img1(x) = img0(H^-1 x), bilinear, zero outside."""
    H, W = img.shape
    Hinv = torch.linalg.inv(H_mat)
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    src = torch.einsum("ij,jhw->ihw", Hinv, torch.stack([xs, ys, torch.ones_like(xs)]))
    sx, sy = src[0] / src[2], src[1] / src[2]
    fx0, fy0 = torch.floor(sx), torch.floor(sy)
    x0, y0 = fx0.to(torch.int64), fy0.to(torch.int64)
    fx, fy = sx - fx0, sy - fy0

    def at(yy, xx):
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
        return torch.where(inb, v, 0.0)

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


class HomographyBatch(NamedTuple):
    img0: torch.Tensor      # (B, 1, H, W)
    img1: torch.Tensor      # (B, 1, H, W)
    i_ids: torch.Tensor     # (B, K) GT coarse cells in img0
    j_ids: torch.Tensor     # (B, K) GT coarse cells in img1
    pts1: torch.Tensor      # (B, K, 2) exact pixel of each cell centre in img1
    pos_mask: torch.Tensor  # (B, K) valid GT correspondences


class PairDraws(NamedTuple):
    """The random numbers of one ``make_batch`` call, batch first: [0, 1)
    uniforms but for the two standard-normal noise images.  The JAX
    function's keys (``make_batch``'s ``one``): k1 -> ``mixed_texture``
    (sel, lows, dots), k5 -> (use_mask, ``random_object_mask``), k2 ->
    ``random_homography``, k3 -> (gain, bias, noise1), k4 -> noise0."""

    sel: torch.Tensor        # (B,)
    lows: tuple              # 3 x (B, H/s, W/s), s = 8, 4, 2
    dots: tuple              # (B, 96, 2), (B, 96), (B, 96), (B, 4, 4)
    use_mask: torch.Tensor   # (B,)
    mask: tuple              # (B, 2), (B, 2), (B,)
    hom: tuple               # (B,), (B,), (B, 2), (B, 2)
    gain: torch.Tensor       # (B,)
    bias: torch.Tensor       # (B,)
    noise1: torch.Tensor     # (B, H, W)
    noise0: torch.Tensor     # (B, H, W)


def draw_pair(batch: int, H: int, W: int, generator=None, device=None) -> PairDraws:
    """``PairDraws`` from ``generator``."""
    def u(*shape):
        return _rand(generator, device, batch, *shape)

    def n():
        return torch.randn((batch, H, W), generator=generator, device=device)

    return PairDraws(u(), tuple(u(H // s, W // s) for s in (8, 4, 2)),
                     (u(96, 2), u(96), u(96), u(4, 4)), u(), (u(2), u(2), u()),
                     (u(), u(), u(2), u(2)), u(), u(), n(), n())


def _gt_cells(H: int, W: int, device):
    """Cell-centre pixels of the 1/8 grid, row-major: (cx, cy), (Hc*Wc,)."""
    Hc, Wc = H // 8, W // 8
    ys, xs = torch.meshgrid(torch.arange(Hc, device=device), torch.arange(Wc, device=device),
                            indexing="ij")
    return (xs.reshape(-1) * 8 + 4).to(torch.float32), (ys.reshape(-1) * 8 + 4).to(torch.float32)


def _top_gt(px, py, pos, max_gt: int, Wc: int, Hc: int):
    """Fixed capacity: the first ``max_gt`` cells by (valid, then lower
    index), as the JAX function's ``top_k`` of ``valid - index * 1e-6``."""
    n = Hc * Wc
    jx = torch.clamp(torch.floor(px / 8.0).to(torch.int64), 0, Wc - 1)
    jy = torch.clamp(torch.floor(py / 8.0).to(torch.int64), 0, Hc - 1)
    score = pos.to(torch.float32) - torch.arange(n, device=px.device) * 1e-6
    sel = torch.sort(score, descending=True, stable=True)[1][:max_gt]
    return (torch.arange(n, device=px.device)[sel], (jy * Wc + jx)[sel],
            torch.stack([px, py], -1)[sel], pos[sel])


def make_batch(batch: int, H: int, W: int, max_gt: int, draws: PairDraws | None = None,
               generator=None, device=None) -> HomographyBatch:
    """A homography-supervised pair batch (JAX ``make_batch``): a mixed
    texture, masked by a random silhouette in 70% of pairs, warped by a
    random homography, with photometric jitter and noise; GT: each cell
    centre of img0 mapped by the homography, kept where it lands 4 px
    inside img1 on the silhouette."""
    if draws is None:
        draws = draw_pair(batch, H, W, generator, device)
    Hc, Wc = H // 8, W // 8
    items = []
    for b in range(batch):
        def at(t, b=b):
            return tuple(x[b] for x in t)

        img0 = mixed_texture(H, W, draws.sel[b], at(draws.lows), at(draws.dots))
        msk = random_object_mask(H, W, *at(draws.mask))
        msk = torch.where(draws.use_mask[b] < 0.7, msk, torch.ones_like(msk))
        img0 = img0 * msk
        Hm = random_homography(H, W, *at(draws.hom))
        img1 = warp_image(img0, Hm)
        gain = _span(draws.gain[b], 0.7, 1.3)
        bias = _span(draws.bias[b], -0.15, 0.15)
        img1 = torch.clamp(img1 * gain + bias, 0.0, 1.0)
        img1 = torch.clamp(img1 + 0.02 * draws.noise1[b], 0.0, 1.0)
        img0 = torch.clamp(img0 + 0.02 * draws.noise0[b], 0.0, 1.0)
        cx, cy = _gt_cells(H, W, img0.device)
        p = torch.einsum("ij,jn->in", Hm, torch.stack([cx, cy, torch.ones_like(cx)]))
        px, py = p[0] / p[2], p[1] / p[2]
        inb = (px >= 4) & (px < W - 4) & (py >= 4) & (py < H - 4)
        # background cells (black on black) are no positive supervision
        inb = inb & (msk[cy.to(torch.int64), cx.to(torch.int64)] > 0.5)
        items.append((img0[None], img1[None]) + _top_gt(px, py, inb, max_gt, Wc, Hc))
    return HomographyBatch(*(torch.stack(f) for f in zip(*items)))


# ------------------------------------------------- depth+pose supervision
def _render_sphere_union(ob_in_cam, K, H, W, spheres, dot_seed=0):
    """Minimal numpy ray tracer of a textured sphere union (the hard
    fixture's object family).  Returns (gray float [0,1], depth z, mask)."""
    T_oc = np.linalg.inv(ob_in_cam)
    j, i = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d_cam = np.stack(
        [(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
         np.ones_like(i, np.float64)], axis=-1)
    d_obj = d_cam @ T_oc[:3, :3].T
    o_obj = T_oc[:3, 3]
    a = np.sum(d_obj * d_obj, axis=-1)
    t_best = np.full((H, W), np.inf)
    sid_best = np.full((H, W), -1, np.int64)
    for s, (cx, cy, cz, r) in enumerate(spheres):
        oc = o_obj - np.array([cx, cy, cz])
        b = 2.0 * (d_obj @ oc)
        c = oc @ oc - r * r
        disc = b * b - 4 * a * c
        ok = disc > 0
        sq = np.sqrt(np.where(ok, disc, 0.0))
        t = (-b - sq) / (2 * a)
        ok &= t > 0.01
        closer = ok & (t < t_best)
        t_best = np.where(closer, t, t_best)
        sid_best = np.where(closer, s, sid_best)
    hit = sid_best >= 0
    t = np.where(hit, t_best, 0.0)
    p_obj = o_obj + d_obj * t[..., None]
    # per-sphere dot texture in OBJECT space: view-consistent, so the
    # supervision carries true photometric correspondence across parallax
    rng = np.random.default_rng(dot_seed)
    gray = np.full((H, W), 0.45)
    for s, (cx, cy, cz, r) in enumerate(spheres):
        sel = sid_best == s
        if not sel.any():
            continue
        local = (p_obj[sel] - np.array([cx, cy, cz])) / r
        dots = rng.uniform(-1, 1, (24, 3))
        dots /= np.linalg.norm(dots, axis=-1, keepdims=True)
        vals = rng.uniform(-0.45, 0.45, 24)
        d2 = local @ dots.T                     # cos angle to each dot
        w_tex = np.clip((d2 - 0.965) / 0.035, 0, 1)
        gray[sel] = 0.5 + (w_tex * vals).sum(-1)
    # lambertian shading from the sphere normal
    n_obj = np.zeros((H, W, 3))
    for s, (cx, cy, cz, r) in enumerate(spheres):
        sel = sid_best == s
        n_obj[sel] = (p_obj[sel] - np.array([cx, cy, cz])) / r
    light = np.array([0.3, -0.5, -0.8])
    light = light / np.linalg.norm(light)
    shade = 0.65 + 0.35 * np.clip(-(n_obj @ light), 0, 1)
    gray = np.clip(gray * shade, 0, 1) * hit
    depth = np.where(hit, t, 0.0).astype(np.float32)
    return gray.astype(np.float32), depth, hit


class DepthViewPool(NamedTuple):
    """Multi-view renders of random objects with exact depth + pose GT."""

    imgs: torch.Tensor     # (V, H, W) gray [0,1], bg = 0
    depths: torch.Tensor   # (V, H, W) z, 0 = invalid
    poses: torch.Tensor    # (V, 4, 4) cam-in-object
    K: torch.Tensor        # (3, 3)
    views_per: int


def build_depth_view_pool(n_objects=24, views_per=6, H=160, W=160, seed=0,
                          max_rel_deg=28.0, device=None) -> DepthViewPool:
    """Host-rendered views for depth+pose-warped supervision: random sphere
    unions with object-space dot textures (the hard eval fixture's family);
    consecutive views differ by tracking-scale rotations, so GT
    correspondences carry real parallax and self-occlusion.  The same
    numpy stream as the JAX function, so the same seed gives the same
    pool."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    # long focal: the object fills ~half the frame, like the letterboxed
    # object crops the production matcher sees
    f = 1.6 * H
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float64)
    imgs, depths, poses = [], [], []
    for o in range(n_objects):
        n_sph = rng.integers(2, 6)
        spheres = []
        for _ in range(n_sph):
            c = rng.uniform(-0.05, 0.05, 3)
            r = rng.uniform(0.035, 0.085)
            spheres.append((c[0], c[1], c[2], float(r)))
        base = Rotation.random(random_state=int(rng.integers(1 << 30)))
        for v in range(views_per):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            # per-view-step rotation at tracking scale (any sampled pair
            # differs by <= views_per * step, ~40 deg at worst)
            ang = np.deg2rad(rng.uniform(3.0, max_rel_deg / views_per))
            R = (Rotation.from_rotvec(axis * ang * v) * base).as_matrix()
            ob = np.eye(4)
            ob[:3, :3] = R
            ob[:3, 3] = [rng.uniform(-0.01, 0.01), rng.uniform(-0.01, 0.01),
                         rng.uniform(0.38, 0.5)]
            g, d, _m = _render_sphere_union(ob, K, H, W, spheres, dot_seed=o)
            imgs.append(g)
            depths.append(d)
            poses.append(np.linalg.inv(ob))     # cam-in-object
    dev = resolve_device(device)
    return DepthViewPool(
        torch.from_numpy(np.stack(imgs)).to(dev), torch.from_numpy(np.stack(depths)).to(dev),
        torch.from_numpy(np.stack(poses).astype(np.float32)).to(dev),
        torch.from_numpy(K.astype(np.float32)).to(dev), views_per)


class DepthDraws(NamedTuple):
    """The random numbers of one ``make_depth_batch`` call, batch first (the
    JAX function's keys: ko -> obj, kv -> views, kj -> gain and bias, kn0,
    kn1 -> the noise images)."""

    obj: torch.Tensor      # (B,) int: the object
    views: torch.Tensor    # (B, 2) int: two distinct views of it
    gain: torch.Tensor     # (B,) [0, 1)
    bias: torch.Tensor     # (B,) [0, 1)
    noise0: torch.Tensor   # (B, H, W) standard normal
    noise1: torch.Tensor   # (B, H, W)


def make_depth_batch(pool: DepthViewPool, batch: int, H: int, W: int, max_gt: int,
                     draws: DepthDraws | None = None, generator=None) -> HomographyBatch:
    """Depth+pose-supervised pair batch (JAX ``make_depth_batch``): GT by
    back-projecting view 0's cell centres through its exact depth and the
    relative pose, kept where the point lands 4 px inside view 1 and is
    view 1's front surface (a 4 mm z-test)."""
    dev = pool.imgs.device
    n_obj = pool.imgs.shape[0] // pool.views_per
    if draws is None:
        draws = DepthDraws(
            torch.randint(0, n_obj, (batch,), generator=generator, device=dev),
            torch.stack([torch.randperm(pool.views_per, generator=generator, device=dev)[:2]
                         for _ in range(batch)]),
            _rand(generator, dev, batch), _rand(generator, dev, batch),
            torch.randn((batch, H, W), generator=generator, device=dev),
            torch.randn((batch, H, W), generator=generator, device=dev))
    Hc, Wc = H // 8, W // 8
    Km = pool.K
    items = []
    for b in range(batch):
        v0 = draws.obj[b] * pool.views_per + draws.views[b, 0]
        v1 = draws.obj[b] * pool.views_per + draws.views[b, 1]
        img0, img1 = pool.imgs[v0], pool.imgs[v1]
        d0, d1 = pool.depths[v0], pool.depths[v1]
        rel = torch.linalg.inv(pool.poses[v1]) @ pool.poses[v0]  # cam0 -> cam1
        gain = _span(draws.gain[b], 0.75, 1.25)
        bias = _span(draws.bias[b], -0.1, 0.1)
        img1 = torch.where(img1 > 0, torch.clamp(img1 * gain + bias, 0.0, 1.0), 0.0)
        img0 = torch.clamp(img0 + 0.02 * draws.noise0[b], 0, 1)
        img1 = torch.clamp(img1 + 0.02 * draws.noise1[b], 0, 1)
        cx, cy = _gt_cells(H, W, dev)
        z0 = d0[cy.to(torch.int64), cx.to(torch.int64)]
        X0 = torch.stack([(cx - Km[0, 2]) / Km[0, 0] * z0,
                          (cy - Km[1, 2]) / Km[1, 1] * z0, z0], -1)
        X1 = X0 @ rel[:3, :3].T + rel[:3, 3]
        z1 = X1[:, 2]
        px = Km[0, 0] * X1[:, 0] / torch.clamp(z1, min=1e-6) + Km[0, 2]
        py = Km[1, 1] * X1[:, 1] / torch.clamp(z1, min=1e-6) + Km[1, 2]
        inb = (px >= 4) & (px < W - 4) & (py >= 4) & (py < H - 4) & (z0 > 0.01)
        pxi = torch.clamp(torch.round(px).to(torch.int64), 0, W - 1)
        pyi = torch.clamp(torch.round(py).to(torch.int64), 0, H - 1)
        # z-test: the warped point must BE view 1's front surface
        pos = inb & (torch.abs(d1[pyi, pxi] - z1) < 0.004)
        items.append((img0[None], img1[None]) + _top_gt(px, py, pos, max_gt, Wc, Hc))
    return HomographyBatch(*(torch.stack(f) for f in zip(*items)))


# ----------------------------------------------------------------- losses
def coarse_focal_loss(conf, i_ids, j_ids, pos_mask, alpha=0.25, gamma=2.0):
    """Focal loss on the dual-softmax confidence matrix (reference
    loftr_loss.py compute_coarse_loss, focal variant): -alpha (1-p)^gamma
    log(p) at GT-positive cells, -alpha p^gamma log(1-p) elsewhere, each
    averaged over its cells."""
    B, L, S = conf.shape
    conf = torch.clamp(conf, 1e-6, 1 - 1e-6)
    gt = torch.zeros((B, L, S), dtype=torch.bool, device=conf.device)
    bb = torch.arange(B, device=conf.device)[:, None].expand_as(i_ids)
    gt[bb, i_ids, j_ids] = pos_mask
    pos = -alpha * (1 - conf) ** gamma * torch.log(conf)
    neg = -alpha * conf ** gamma * torch.log(1 - conf)
    n_pos = gt.sum()
    return (torch.where(gt, pos, 0.0).sum() / (n_pos + 1e-6)
            + torch.where(gt, 0.0, neg).sum() / (B * L * S - n_pos + 1e-6))


def fine_l2_loss(mkpts1_f, pts1_gt, pos_mask):
    """L2 on the fine-refined match position, in fine-scale (1/2 px) units
    (reference compute_fine_loss, l2 variant), over the valid GT."""
    err = ((mkpts1_f - pts1_gt) / 2.0) ** 2
    w = pos_mask.to(torch.float32)
    return (err.sum(-1) * w).sum() / (w.sum() + 1e-6)


# -------------------------------------------------------------- training
class TrainCfg(NamedTuple):
    H: int = 160
    W: int = 160
    batch: int = 8
    max_gt: int = 256
    lr: float = 1e-3
    warmup: int = 50
    fine_weight: float = 1.0


def trainable(module: LoftrModule) -> list:
    """The leaves the JAX trainer optimizes: every parameter and, as the
    flax variables it hands to optax hold them, the BatchNorm running means
    and variances (marked ``requires_grad``; ``FrozenBatchNorm2d`` then
    differentiates them)."""
    stats = []
    for name, buf in module.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.requires_grad_(True)
            stats.append(buf)
    return list(module.parameters()) + stats


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float) -> None:
    """optax ``clip_by_global_norm``: when the global L2 norm reaches
    ``max_norm``, every gradient becomes ``g / norm * max_norm``.  In place,
    with no host synchronisation."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


class LoftrOptimizer:
    """The JAX trainer's optax chain: ``clip_by_global_norm(1.0)`` ->
    ``adamw(warmup_cosine_decay_schedule(0, lr, warmup, decay_steps))``
    with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
    every leaf).  optax reads the schedule at the update count before it
    rises, so the first update runs at lr 0 (its moments still move)."""

    def __init__(self, leaves: list, tcfg: TrainCfg, n_steps: int):
        self.leaves = leaves
        self.peak = tcfg.lr
        self.warmup = tcfg.warmup
        self.decay_steps = max(n_steps, tcfg.warmup + 1)
        self.adam = torch.optim.AdamW(leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)
        self.count = 0

    def schedule(self, count: int) -> float:
        """optax ``warmup_cosine_decay_schedule(0, peak, warmup,
        decay_steps)`` (end value 0)."""
        if count < self.warmup:
            return self.peak * count / self.warmup
        T = self.decay_steps - self.warmup
        return self.peak * 0.5 * (1.0 + math.cos(math.pi * min(count - self.warmup, T) / T))

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=False)

    def step(self) -> None:
        clip_by_global_norm([p.grad for p in self.leaves], 1.0)
        for g in self.adam.param_groups:
            g["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1


def make_loss_fn(module: LoftrModule, tcfg: TrainCfg):
    """``loss_fn(batch) -> (loss, {"coarse", "fine"})``: the teacher-forced
    forward at the GT cells, the focal coarse loss plus ``fine_weight``
    times the fine l2 loss."""

    def loss_fn(batch: HomographyBatch):
        with _without_cudnn():
            out = module(batch.img0, batch.img1, gt_ids=(batch.i_ids, batch.j_ids))
        lc = coarse_focal_loss(out["conf_matrix"], batch.i_ids, batch.j_ids, batch.pos_mask)
        lf = fine_l2_loss(out["mkpts1_f"], batch.pts1, batch.pos_mask)
        return lc + tcfg.fine_weight * lf, {"coarse": lc, "fine": lf}

    return loss_fn


def make_train_step(module: LoftrModule, tcfg: TrainCfg, optimizer: LoftrOptimizer,
                    mesh=None):
    """``step(batch=None, generator=None) -> metrics`` (loss, coarse, fine as
    device tensors): one update of ``module``'s weights in place, on
    ``batch`` or on a ``make_batch`` drawn from ``generator``."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel LoFTR training over a device mesh is not ported "
            "(ROADMAP queue 1, item 7: parallel/)")
    loss_fn = make_loss_fn(module, tcfg)
    device = next(module.parameters()).device

    def step(batch: HomographyBatch | None = None, generator=None):
        if batch is None:
            batch = make_batch(tcfg.batch, tcfg.H, tcfg.W, tcfg.max_gt,
                               generator=generator, device=device)
        optimizer.zero_grad()
        loss, aux = loss_fn(batch)
        with _without_cudnn():  # the backward's convolutions as well
            loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    return step


def save_weights(module: LoftrModule, path: str) -> None:
    """``{"state_dict": ...}`` under the reference's names (the layout of
    ``outdoor_ds.ckpt`` without its ``matcher.`` prefix)."""
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in module.state_dict().items()}},
               path)


def train_loftr(cfg: LoftrCfg | None = None, tcfg: TrainCfg = TrainCfg(),
                n_steps: int = 200, seed: int = 0, mesh=None, log_every: int = 20,
                save_path: str = "", save_every: int = 2000, resume: str = "",
                depth_frac: float = 0.0, depth_pool_objects: int = 24, device=None):
    """Train from scratch (or from ``resume``); returns ``(module, history)``.
    ``module.state_dict()`` is a reference-layout state dict for
    ``LoftrMatcher(cfg, state_dict=...)``.  ``save_path``: the weights are
    saved there every ``save_every`` steps and at the end
    (``save_weights``).  ``resume``: warm-start from a file
    ``read_state_dict`` reads (a saved state dict, a reference checkpoint,
    or a JAX ``.npz``), with a fresh optimizer.  ``depth_frac`` > 0 mixes
    in that fraction of depth+pose-supervised batches.  The weights of a
    fresh start are ``init_weights(seed)``; the batches come from a
    generator on the device seeded with ``seed``.  ``device``: None = CUDA
    (raises without one)."""
    cfg = cfg or LoftrCfg()
    dev = resolve_device(device)
    module = init_weights(LoftrModule(cfg), seed)
    if resume:
        load_weights(module, read_state_dict(resume, cfg))
        print(f"resumed weights from {resume}", flush=True)
    module = module.to(dev).train()
    optimizer = LoftrOptimizer(trainable(module), tcfg, n_steps)
    step = make_train_step(module, tcfg, optimizer, mesh)
    gen = torch.Generator(device=dev).manual_seed(seed)
    hist = []

    pool = None
    if depth_frac > 0:
        print(f"building depth-view pool ({depth_pool_objects} objects)...", flush=True)
        pool = build_depth_view_pool(n_objects=depth_pool_objects, H=tcfg.H, W=tcfg.W,
                                     seed=seed + 1, device=dev)
    for i in range(n_steps):
        batch = None
        if pool is not None and (i % 100) < int(depth_frac * 100):
            batch = make_depth_batch(pool, tcfg.batch, tcfg.H, tcfg.W, tcfg.max_gt,
                                     generator=gen)
        metrics = step(batch, gen)
        if i % log_every == 0 or i == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            hist.append({"step": i, **m})
            print(f"step {i}: {m}", flush=True)
        if save_path and save_every and (i + 1) % save_every == 0:
            save_weights(module, save_path)
    if save_path:
        save_weights(module, save_path)
    return module, hist


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Train the LoFTR matcher from scratch.")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=160,
                    help="train pair resolution (engine crops run at "
                         "feature_corres.resize; closer = better transfer)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="", help="state dict file to write")
    ap.add_argument("--save_every", type=int, default=2000)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--resume", default="",
                    help="weights to warm-start from (.ckpt/.pth or a JAX .npz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth_frac", type=float, default=0.0,
                    help="fraction of depth+pose-warped supervision batches")
    ap.add_argument("--pool_objects", type=int, default=24)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    train_loftr(
        tcfg=TrainCfg(H=args.size, W=args.size, batch=args.batch, lr=args.lr,
                      warmup=max(50, args.steps // 20)),
        n_steps=args.steps, log_every=args.log_every, save_path=args.out,
        save_every=args.save_every, resume=args.resume, seed=args.seed,
        depth_frac=args.depth_frac, depth_pool_objects=args.pool_objects,
        device=args.device)
    print(f"trained {args.steps} steps in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
