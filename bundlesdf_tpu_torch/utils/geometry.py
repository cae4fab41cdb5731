"""Ray geometry (port of ``bundlesdf_tpu/utils/geometry.py``).

Only ``ray_box_intersection``, which the occupancy march needs.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


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
