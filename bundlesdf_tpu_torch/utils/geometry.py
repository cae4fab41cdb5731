"""Camera and ray geometry (port of ``bundlesdf_tpu/utils/geometry.py``).

``ray_box_intersection`` for the occupancy march; ``depth_to_xyz`` and
``xyz_to_normals`` for the torch depth pipeline (``ops/image.py``) and
``depth_to_xyz_np`` for the host one, which the tracker's ``Frame`` uses;
``compute_covisibility``, the device version of the tracker's host one
(``tracking/frame.py``);
``GLCAM_IN_CVCAM``, ``camera_rays_gl(_np)`` and ``ray_box_intersection_np``
for the NOF ray pool and the scene bounds.  The JAX module's
``erode_mask`` / ``dilate_mask`` are called by nothing in either package
and are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-10


def _iota(H: int, W: int, like: torch.Tensor):
    """(v, u) float32 pixel-index grids of shape (H, W) on ``like``'s device."""
    v = torch.arange(H, dtype=torch.float32, device=like.device)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=like.device)[None, :].expand(H, W)
    return v, u


def depth_to_xyz(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Back-project a depth image (H, W) to a camera-space xyz map (H, W, 3);
    OpenCV convention, xyz = 0 where depth <= 0."""
    H, W = depth.shape
    v, u = _iota(H, W, depth)
    x = (u - K[0, 2]) / K[0, 0] * depth
    y = (v - K[1, 2]) / K[1, 1] * depth
    xyz = torch.stack([x, y, depth], dim=-1)
    return torch.where((depth > 0.0)[..., None], xyz, 0.0)


def xyz_to_normals(xyz: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Cross-product normals of an organized xyz map (H, W, 3), oriented to
    face the camera; 0 where a neighbour is invalid and on the border."""
    right = torch.roll(xyz, -1, dims=1)
    left = torch.roll(xyz, 1, dims=1)
    down = torch.roll(xyz, -1, dims=0)
    up = torch.roll(xyz, 1, dims=0)
    vr = torch.roll(valid, -1, dims=1)
    vl = torch.roll(valid, 1, dims=1)
    vd = torch.roll(valid, -1, dims=0)
    vu = torch.roll(valid, 1, dims=0)
    n = torch.linalg.cross(right - left, down - up, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / (norm + _EPS)
    flip = torch.sum(n * xyz, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    ok = valid & vr & vl & vd & vu & (norm[..., 0] > _EPS)
    H, W = valid.shape
    interior = torch.zeros((H, W), dtype=torch.bool, device=xyz.device)
    interior[1:H - 1, 1:W - 1] = True
    ok = ok & interior
    return torch.where(ok[..., None], n, 0.0)


def compute_covisibility(xyz_a: torch.Tensor, normal_a: torch.Tensor,
                         valid_a: torch.Tensor, pose_a: torch.Tensor,
                         pose_b: torch.Tensor,
                         visible_angle_deg: float = 70.0) -> torch.Tensor:
    """Fraction of frame A's valid points whose normals, moved into frame
    B's camera by ``inv(pose_b) @ pose_a``, face B's eye within
    ``visible_angle_deg`` (reference Frame.h:122-190, every pixel).

    ``xyz_a`` and ``normal_a`` (H, W, 3) or (N, 3), ``valid_a`` (H, W) or
    (N,) bool, the poses (4, 4) cam-in-model.  Returns a 0-d f32 tensor in
    [0, 1]."""
    pts = xyz_a.reshape(-1, 3)
    nrm = normal_a.reshape(-1, 3)
    msk = valid_a.reshape(-1)
    R_b = pose_b[:3, :3]
    rel_R = R_b.T @ pose_a[:3, :3]
    rel_t = R_b.T @ (pose_a[:3, 3] - pose_b[:3, 3])
    p_b = pts @ rel_R.T + rel_t
    n_b = nrm @ rel_R.T
    to_eye = -p_b / (torch.linalg.norm(p_b, dim=-1, keepdim=True) + _EPS)
    n_b = n_b / (torch.linalg.norm(n_b, dim=-1, keepdim=True) + _EPS)
    dots = torch.sum(to_eye * n_b, dim=-1)
    thres = float(np.cos(np.deg2rad(np.float32(visible_angle_deg))))
    vis = torch.sum((dots > thres) & msk)
    total = torch.sum(msk)
    return vis.to(torch.float32) / (total.to(torch.float32) + 1e-7)


def camera_rays_gl(H: int, W: int, K: torch.Tensor) -> torch.Tensor:
    """Per-pixel ray directions in the OpenGL camera convention (+x right,
    +y up, -z forward; reference nerf_helpers.py:358-363).  (H, W, 3), not
    normalized: the z component is exactly -1."""
    v, u = _iota(H, W, K)
    return torch.stack([(u - K[0, 2]) / K[0, 0], -(v - K[1, 2]) / K[1, 1],
                        -torch.ones((H, W), device=K.device)], dim=-1)


# OpenGL camera expressed in the OpenCV camera (reference Utils.py:37).
GLCAM_IN_CVCAM = np.array(
    [[1.0, 0.0, 0.0, 0.0],
     [0.0, -1.0, 0.0, 0.0],
     [0.0, 0.0, -1.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]],
    dtype=np.float32,
)


def ray_box_intersection(origins: torch.Tensor, dirs: torch.Tensor,
                         box_min: torch.Tensor, box_max: torch.Tensor):
    """Slab-test ray/AABB intersection (reference nerf_helpers.py:403-446).

    Directions are normalized internally, per-axis entry times are clamped
    at 0 (ray starts inside the box), and misses return (-1, -1).

    Args:
      origins, dirs: (N, 3).
      box_min, box_max: (3,).
    Returns: (tmin, tmax) each (N,); -1 where the ray misses the box.
    """
    d = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + _EPS)
    small = torch.where(d < 0, -_EPS, _EPS)
    inv_d = 1.0 / torch.where(torch.abs(d) < _EPS, small, d)
    t0 = (box_min[None] - origins) * inv_d
    t1 = (box_max[None] - origins) * inv_d
    t_near = torch.minimum(t0, t1)
    t_far = torch.maximum(t0, t1)
    t_near = torch.clamp(t_near, min=0.0)  # clamp per-axis entry like the reference
    tmin = torch.amax(t_near, dim=-1)
    tmax = torch.amin(t_far, dim=-1)
    hit = tmin <= tmax
    tmin = torch.where(hit, tmin, -1.0)
    tmax = torch.where(hit, tmax, -1.0)
    return tmin, tmax


# ------------------------------------------------------------ numpy twins
def camera_rays_gl_np(H: int, W: int, K: np.ndarray) -> np.ndarray:
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.stack(
        [(u - K[0, 2]) / K[0, 0], -(v - K[1, 2]) / K[1, 1],
         -np.ones((H, W), np.float32)], axis=-1,
    )


def depth_to_xyz_np(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    H, W = depth.shape
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    x = (u - K[0, 2]) / K[0, 0] * depth
    y = (v - K[1, 2]) / K[1, 1] * depth
    xyz = np.stack([x, y, depth], axis=-1)
    return np.where(depth[..., None] > 0.0, xyz, 0.0)


def ray_box_intersection_np(origins, dirs, box_min, box_max, eps=_EPS):
    d = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + eps)
    inv_d = 1.0 / np.where(np.abs(d) < eps, np.where(d < 0, -eps, eps), d)
    t0 = (box_min[None] - origins) * inv_d
    t1 = (box_max[None] - origins) * inv_d
    t_near = np.maximum(np.minimum(t0, t1), 0.0)
    t_far = np.maximum(t0, t1)
    tmin = t_near.max(axis=-1)
    tmax = t_far.min(axis=-1)
    hit = tmin <= tmax
    return np.where(hit, tmin, -1.0), np.where(hit, tmax, -1.0)
