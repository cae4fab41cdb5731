"""SE(3)/SO(3) Lie-group utilities, rigid alignment and rotation distances
(port of ``bundlesdf_tpu/utils/se3.py``).

Same conventions as the JAX module: rotations act on column vectors,
tangents are ``[t(3), w(3)]``, float32 math, and small-angle Taylor branches
selected with ``torch.where`` so gradients stay finite at the identity.
PyTorch runs float32 matmuls in full precision while
``torch.get_float32_matmul_precision()`` is ``"highest"`` (its default), so
the JAX module's ``f32_precision`` wrapper has no counterpart: the port
never lowers that setting.

The ``*_np`` functions are the host twins used in per-keyframe loops
(admission, BA subset selection, sanity gates).
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) via Rodrigues."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS))
    W = hat(w)
    eye = _eye3(w, W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def rotation_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [w, x, y, z],
    branchless Shepperd's method, returned with w >= 0."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (r21 - r12) / s0, (r02 - r20) / s0,
                      (r10 - r01) / s0], -1)
    s1 = safe_sqrt(1.0 + r00 - r11 - r22) * 2.0
    q1 = torch.stack([(r21 - r12) / s1, 0.25 * s1, (r01 + r10) / s1,
                      (r02 + r20) / s1], -1)
    s2 = safe_sqrt(1.0 - r00 + r11 - r22) * 2.0
    q2 = torch.stack([(r02 - r20) / s2, (r01 + r10) / s2, 0.25 * s2,
                      (r12 + r21) / s2], -1)
    s3 = safe_sqrt(1.0 - r00 - r11 + r22) * 2.0
    q3 = torch.stack([(r10 - r01) / s3, (r02 + r20) / s3, (r12 + r21) / s3,
                      0.25 * s3], -1)

    case = torch.argmax(torch.stack([tr, r00, r11, r22], dim=-1), dim=-1)[..., None]
    q = torch.where(case == 0, q0,
                    torch.where(case == 1, q1, torch.where(case == 2, q2, q3)))
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    return torch.where(q[..., :1] < 0, -q, q)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), via quaternion +
    atan2 (well-conditioned at 0 and near pi)."""
    q = rotation_to_quat(R)
    w, v = q[..., 0], q[..., 1:]
    nv = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(nv, w)
    scale = torch.where(nv < 1e-6, 2.0 / torch.clamp(w, min=_EPS),
                        theta / torch.clamp(nv, min=_EPS))
    return scale[..., None] * v


def _v_matrix(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3) used in se3 exp: t_SE3 = V @ rho."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta).clamp(min=_EPS))
    W = hat(w)
    eye = _eye3(w, W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [t(3), w(3)] (..., 6) -> homogeneous transform (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    t = torch.einsum("...ij,...j->...i", _v_matrix(w), rho)
    return pack_pose(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform (..., 4, 4) -> tangent [t(3), w(3)] (..., 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    Vinv = torch.linalg.inv(_v_matrix(w))
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, w], dim=-1)


def pack_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device (no host copy: the train step is
    # captured as a CUDA graph)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def inv_pose(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform (..., 4, 4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return pack_pose(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) (or (..., 3))."""
    single = pts.ndim == T.ndim - 1
    if single:
        pts = pts[..., None, :]
    out = torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]
    return out[..., 0, :] if single else out


def transform_dirs(T: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Rotate direction vectors (..., N, 3) (or (..., 3)) by the rotation
    part of (..., 4, 4) T."""
    single = dirs.ndim == T.ndim - 1
    if single:
        dirs = dirs[..., None, :]
    out = torch.einsum("...ij,...nj->...ni", T[..., :3, :3], dirs)
    return out[..., 0, :] if single else out


def rotation_geodesic_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotations (reference Utils.cpp:81-88)."""
    prod = R1 @ R2.transpose(-1, -2)
    tmp = (torch.diagonal(prod, dim1=-2, dim2=-1).sum(-1) - 1.0) * 0.5
    return torch.arccos(torch.clamp(tmp, -1.0, 1.0))


def rotation_geodesic_distance_ignore_cam_z(R1: torch.Tensor,
                                            R2: torch.Tensor) -> torch.Tensor:
    """Rotation distance ignoring rotation around the camera z-axis
    (reference Utils.cpp:90-98): zero the z-component of the relative
    rotation's axis, keep the angle, and return the geodesic angle."""
    R_ab = R2 @ R1.transpose(-1, -2)
    w = so3_log(R_ab)
    theta = torch.linalg.norm(w, dim=-1)
    axis = w / (theta[..., None] + _EPS)
    axis = torch.cat([axis[..., :2], torch.zeros_like(axis[..., 2:])], dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + _EPS)
    R_out = so3_exp(axis * theta[..., None])
    return rotation_geodesic_distance(R_out, _eye3(R_out, R_out.shape))


def kabsch(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted rigid alignment: T with ``dst ~= T @ src`` (Kabsch without
    scale; reference Utils.cpp:360-405).  Batched over leading dims.

    R = V diag(1, 1, det) U^T does not depend on the SVD's sign convention.
    All-zero weights give a zero covariance, whose SVD is still a pair of
    rotations, so the result is a finite rigid transform (callers gate such
    pairs out, as ``ransac_multi_pair`` does through ``ok``)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.sum(weights, dim=-1, keepdim=True) + _EPS
    wn = weights / wsum
    src_c = torch.sum(src * wn[..., None], dim=-2, keepdim=True)
    dst_c = torch.sum(dst * wn[..., None], dim=-2, keepdim=True)
    src0 = src - src_c
    dst0 = dst - dst_c
    H = torch.einsum("...ni,...nj->...ij", src0 * wn[..., None], dst0)
    U, _, Vt = torch.linalg.svd(H)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(Vt.transpose(-1, -2) @ Ut)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = torch.einsum("...ji,...j,...jk->...ik", Vt, D, Ut)
    t = dst_c[..., 0, :] - torch.einsum("...ij,...j->...i", R, src_c[..., 0, :])
    return pack_pose(R, t)


def to_homo(pts: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) -> (..., N, 4) homogeneous."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_rotation(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block of (..., 4, 4) via SVD."""
    R = T[..., :3, :3]
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    Rn = torch.einsum("...ij,...j,...jk->...ik", U, D, Vt)
    return pack_pose(Rn, T[..., :3, 3])


# ------------------------------------------------------------ numpy twins
def rotation_geodesic_distance_np(R1, R2) -> float:
    tmp = (np.trace(R1 @ R2.T) - 1.0) * 0.5
    return float(np.arccos(np.clip(tmp, -1.0, 1.0)))


def rotation_geodesic_distance_ignore_cam_z_np(R1, R2) -> float:
    from scipy.spatial.transform import Rotation

    R_ab = np.asarray(R2) @ np.asarray(R1).T
    w = Rotation.from_matrix(R_ab).as_rotvec()
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return 0.0
    axis = w / theta
    axis[2] = 0.0
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return 0.0
    axis = axis / n
    R_out = Rotation.from_rotvec(axis * theta).as_matrix()
    return rotation_geodesic_distance_np(R_out, np.eye(3))
