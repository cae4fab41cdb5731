"""SE(3)/SO(3) exponential maps (port of ``bundlesdf_tpu/utils/se3.py``).

Only what ``models.nof.pose_array_matrices`` needs: ``hat``, ``so3_exp``,
``_v_matrix``, ``se3_exp`` and ``pack_pose``.  Same conventions as the JAX
module: rotations act on column vectors, tangents are ``[t(3), w(3)]``,
float32 math, and small-angle Taylor branches selected with ``torch.where``
so gradients stay finite at the identity.  (PyTorch runs float32 matmuls in
full precision unless TF32 is switched on, so the JAX module's
``f32_precision`` wrapper has no counterpart.)
"""
from __future__ import annotations

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


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) via Rodrigues."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


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
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [t(3), w(3)] (..., 6) -> homogeneous transform (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    t = torch.einsum("...ij,...j->...i", _v_matrix(w), rho)
    return pack_pose(R, t)


def pack_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)
