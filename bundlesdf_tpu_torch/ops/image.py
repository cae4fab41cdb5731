"""Image-space depth preprocessing (port of ``bundlesdf_tpu/ops/image.py``).

The reference's per-pixel CUDA kernels (CUDAImageUtil erodeDepthMap,
gaussFilterDepthMap, the edge-grazing filter) and the Frame init pipeline
(Frame.cpp:225-334) as whole-image tensor ops: each stencil is a static
unrolled loop of shifted copies.  ``process_depth_frame_np`` is the host
twin that the tracker's ``Frame`` runs, as in the JAX package; it is a copy
of the JAX package's, so the two agree bitwise.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import geometry
from ..utils.profiler import span


def _shifted(img: torch.Tensor, dy: int, dx: int, fill: float = 0.0) -> torch.Tensor:
    """Shift a 2D image by (dy, dx), filling vacated pixels with ``fill``."""
    out = torch.roll(img, (dy, dx), dims=(0, 1))
    H, W = img.shape
    ok = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    ok[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = True
    return torch.where(ok, out, fill)


def erode_depth(depth: torch.Tensor, radius: int = 1, diff: float = 0.001,
                ratio: float = 0.8) -> torch.Tensor:
    """Zero a valid pixel whose (2r+1)^2 window has more than ``ratio`` bad
    neighbours (invalid, or relative depth difference above ``diff``)
    (CUDAImageUtil erodeDepthMap; config_ho3d.yml:17-21)."""
    valid = depth > 0.1
    bad = torch.zeros_like(depth)
    total = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            nd = _shifted(depth, dy, dx)
            nv = nd > 0.1
            rel = torch.abs(nd - depth) / torch.clamp(depth, min=1e-6)
            bad = bad + torch.where(~nv | (rel > diff), 1.0, 0.0)
            total += 1
    return torch.where(valid & (bad / total <= ratio), depth, 0.0)


def bilateral_filter_depth(depth: torch.Tensor, radius: int = 2, sigma_d: float = 2.0,
                           sigma_r: float = 100000.0) -> torch.Tensor:
    """Spatial x range Gaussian over the (2r+1)^2 window, invalid (<= 0.1)
    pixels excluded (CUDAImageUtil gaussFilterDepthMap)."""
    valid = depth > 0.1
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    f32 = dict(dtype=torch.float32, device=depth.device)
    sd = torch.tensor(sigma_d, **f32)
    sr = torch.tensor(sigma_r, **f32)
    inv_2sd2 = 1.0 / (2.0 * sd * sd)
    inv_2sr2 = 1.0 / (2.0 * sr * sr)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nd = _shifted(depth, dy, dx)
            nv = nd > 0.1
            w_s = torch.exp(-(dy * dy + dx * dx) * inv_2sd2)
            w_r = torch.exp(-((nd - depth) ** 2) * inv_2sr2)
            w = torch.where(nv, w_s * w_r, 0.0)
            acc = acc + w * nd
            wacc = wacc + w
    return torch.where(valid & (wacc > 1e-8), acc / torch.clamp(wacc, min=1e-8), 0.0)


def filter_edge_grazing(depth: torch.Tensor, xyz: torch.Tensor, normals: torch.Tensor,
                        edge_normal_thres_deg: float = 10.0) -> torch.Tensor:
    """Zero depth where the normal is within ``edge_normal_thres_deg`` of
    perpendicular to the viewing ray (config_ho3d.yml:29)."""
    valid = depth > 0.1
    to_eye = -xyz
    to_eye = to_eye / (torch.linalg.norm(to_eye, dim=-1, keepdim=True) + 1e-10)
    has_n = torch.linalg.norm(normals, dim=-1) > 0.5
    cos_ang = torch.abs(torch.sum(to_eye * normals, dim=-1))
    min_cos = torch.sin(torch.deg2rad(torch.tensor(
        edge_normal_thres_deg, dtype=torch.float32, device=depth.device)))
    keep = valid & has_n & (cos_ang > min_cos)
    return torch.where(keep, depth, 0.0)


def process_depth_frame(depth: torch.Tensor, K: torch.Tensor, zfar: float = 1.0,
                        erode_radius: int = 1, erode_diff: float = 0.001,
                        erode_ratio: float = 0.8, bilateral_radius: int = 2,
                        sigma_d: float = 2.0, sigma_r: float = 100000.0,
                        edge_normal_thres_deg: float = 10.0):
    """clamp zfar -> erode -> 2x bilateral -> xyz -> normals -> edge-grazing
    filter (Frame.cpp:80-138).  Returns (depth, xyz, normals, valid)."""
    depth = torch.where((depth > 0.1) & (depth < zfar), depth, 0.0)
    depth = erode_depth(depth, erode_radius, erode_diff, erode_ratio)
    depth = bilateral_filter_depth(depth, bilateral_radius, sigma_d, sigma_r)
    depth = bilateral_filter_depth(depth, bilateral_radius, sigma_d, sigma_r)
    xyz = geometry.depth_to_xyz(depth, K)
    valid = depth > 0.1
    normals = geometry.xyz_to_normals(xyz, valid)
    depth = filter_edge_grazing(depth, xyz, normals, edge_normal_thres_deg)
    valid = depth > 0.1
    xyz = torch.where(valid[..., None], xyz, 0.0)
    normals = torch.where(valid[..., None], normals, 0.0)
    return depth, xyz, normals, valid


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB (H, W, 3) -> float gray (H, W) in [0, 255]."""
    rgb = rgb.to(torch.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def downscale_image(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool downscale by an integer factor, (H, W) or (H, W, C)
    (the BA dense-term pyramid, bundle.image_downscale)."""
    if factor == 1:
        return img
    x = img[None, None] if img.ndim == 2 else img.permute(2, 0, 1)[None]
    out = F.avg_pool2d(x, factor, stride=factor)[0]
    return out[0] if img.ndim == 2 else out.permute(1, 2, 0)


def downscale_depth_nearest(depth: torch.Tensor, factor: int) -> torch.Tensor:
    """Stride-subsample depth (no averaging across depth discontinuities)."""
    if factor == 1:
        return depth
    return depth[::factor, ::factor]


# ---------------------------------------------------------- numpy twin
def process_depth_frame_np(depth, K, zfar: float = 1.0, erode_radius: int = 1,
                           erode_diff: float = 0.001, erode_ratio: float = 0.8,
                           bilateral_radius: int = 2, sigma_d: float = 2.0,
                           sigma_r: float = 100000.0,
                           edge_normal_thres_deg: float = 10.0):
    """Host numpy mirror of ``process_depth_frame`` (the JAX package's
    ``process_depth_frame_np``, line for line): the tracker's Frame runs its
    image prep on the host, so the card is free for other work."""

    def shifted(img, dy, dx, fill=0.0):
        out = np.roll(img, (dy, dx), axis=(0, 1))
        if dy > 0:
            out[:dy] = fill
        elif dy < 0:
            out[dy:] = fill
        if dx > 0:
            out[:, :dx] = fill
        elif dx < 0:
            out[:, dx:] = fill
        return out

    depth = np.asarray(depth, np.float32)
    with span("track/depth/erode"):
        depth = np.where((depth > 0.1) & (depth < zfar), depth, 0.0)
        valid = depth > 0.1
        bad = np.zeros_like(depth)
        total = 0
        for dy in range(-erode_radius, erode_radius + 1):
            for dx in range(-erode_radius, erode_radius + 1):
                if dy == 0 and dx == 0:
                    continue
                nd = shifted(depth, dy, dx)
                nv = nd > 0.1
                rel = np.abs(nd - depth) / np.maximum(depth, 1e-6)
                bad += np.where(~nv | (rel > erode_diff), 1.0, 0.0)
                total += 1
        depth = np.where(valid & (bad / total <= erode_ratio), depth, 0.0)

    # 2x bilateral
    inv_2sd2 = 1.0 / (2.0 * sigma_d * sigma_d)
    inv_2sr2 = 1.0 / (2.0 * sigma_r * sigma_r)
    with span("track/depth/bilateral"):
        for _ in range(2):
            valid = depth > 0.1
            acc = np.zeros_like(depth)
            wacc = np.zeros_like(depth)
            for dy in range(-bilateral_radius, bilateral_radius + 1):
                for dx in range(-bilateral_radius, bilateral_radius + 1):
                    nd = shifted(depth, dy, dx)
                    nv = nd > 0.1
                    w = np.where(
                        nv,
                        np.exp(-(dy * dy + dx * dx) * inv_2sd2)
                        * np.exp(-((nd - depth) ** 2) * inv_2sr2),
                        0.0,
                    )
                    acc += w * nd
                    wacc += w
            depth = np.where(valid & (wacc > 1e-8), acc / np.maximum(wacc, 1e-8), 0.0)

    # xyz + normals + edge-grazing
    with span("track/depth/cloud"):
        xyz = geometry.depth_to_xyz_np(depth, np.asarray(K))
        valid = depth > 0.1
        right, left = np.roll(xyz, -1, 1), np.roll(xyz, 1, 1)
        down, up = np.roll(xyz, -1, 0), np.roll(xyz, 1, 0)
        n = np.cross(right - left, down - up)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / (norm + 1e-10)
        flip = (n * xyz).sum(-1, keepdims=True) > 0
        n = np.where(flip, -n, n)
        ok = (
            valid
            & np.roll(valid, -1, 1) & np.roll(valid, 1, 1)
            & np.roll(valid, -1, 0) & np.roll(valid, 1, 0)
            & (norm[..., 0] > 1e-10)
        )
        ok[0, :] = ok[-1, :] = False
        ok[:, 0] = ok[:, -1] = False
        normals = np.where(ok[..., None], n, 0.0).astype(np.float32)

        to_eye = -xyz
        to_eye = to_eye / (np.linalg.norm(to_eye, axis=-1, keepdims=True) + 1e-10)
        has_n = np.linalg.norm(normals, axis=-1) > 0.5
        cos_ang = np.abs((to_eye * normals).sum(-1))
        min_cos = np.sin(np.deg2rad(edge_normal_thres_deg))
        keep = valid & has_n & (cos_ang > min_cos)
        depth = np.where(keep, depth, 0.0).astype(np.float32)
        valid = depth > 0.1
        xyz = np.where(valid[..., None], xyz, 0.0).astype(np.float32)
        normals = np.where(valid[..., None], normals, 0.0)
    return depth, xyz, normals, valid
