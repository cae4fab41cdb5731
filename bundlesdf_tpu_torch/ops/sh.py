"""Real spherical-harmonics direction encoding, degree <= 4 (port of
``bundlesdf_tpu/ops/sh.py``; reference SHEncoder nerf_helpers.py:22-105).
Plain elementwise torch ops."""
from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh_encode(dirs: torch.Tensor, degree: int = 3) -> torch.Tensor:
    """Unit directions (..., 3) -> SH basis values (..., degree**2)."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree must be in [1, 4], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full(x.shape, _C0, dtype=dirs.dtype, device=dirs.device)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree > 3:
        out += [
            _C3[0] * y * (3 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            _C3[4] * x * (4 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3 * yy),
        ]
    return torch.stack(out, dim=-1)


def sh_out_dim(degree: int) -> int:
    return degree * degree
