"""Dense occupancy grid and occupied-space ray sampling (port of
``bundlesdf_tpu/ops/occupancy.py``; replaces the reference's kaolin octree
raytrace + mycuda sampling kernels with a fixed-count march, a prefix sum
of occupied step lengths and its inverse).

Randomness: every sampler takes its jitter uniforms as optional (N, S)
tensors in [0, 1).  When they are not given and ``perturb`` is on, they are
drawn from ``generator`` on the inputs' device.  Tests hand both this
module and the JAX one the same uniforms.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import geometry


def _uniform(shape, like: torch.Tensor, generator):
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=torch.float32)


def build_occupancy_grid(points: torch.Tensor, valid: torch.Tensor,
                         resolution: int) -> torch.Tensor:
    """Scatter points in [-1,1]^3 into a dense (R, R, R) bool occupancy grid."""
    R = resolution
    ijk = torch.floor((points + 1.0) * 0.5 * R).to(torch.int64)
    ijk = torch.clamp(ijk, 0, R - 1)
    inside = valid & torch.all(torch.abs(points) <= 1.0, dim=-1)
    flat = ijk[..., 0] * (R * R) + ijk[..., 1] * R + ijk[..., 2]
    flat = torch.where(inside, flat, 0)
    grid = torch.zeros((R * R * R,), dtype=torch.uint8, device=points.device)
    grid.scatter_reduce_(0, flat, inside.to(torch.uint8), "amax")
    return grid.bool().view(R, R, R)


def dilate_grid(grid: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """3^3 max-pool dilation, ``iterations`` times (reference
    nerf_runner.py:447-474)."""
    g = grid.to(torch.float32)[None, None]
    for _ in range(iterations):
        g = F.max_pool3d(g, kernel_size=3, stride=1, padding=1)
    return g[0, 0] > 0.5


def grid_occupied_centers(grid: torch.Tensor):
    """Voxel-center coordinates (R, R, R, 3) of all cells, with the grid."""
    R = grid.shape[0]
    ar = torch.arange(R, device=grid.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1)
    return (idx + 0.5) / R * 2.0 - 1.0, grid


def query_occupancy(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Occupancy lookup for points (..., 3) in [-1,1]^3; False outside the
    cube."""
    R = grid.shape[0]
    ijk = torch.floor((points + 1.0) * 0.5 * R).to(torch.int64)
    inside = torch.all((ijk >= 0) & (ijk < R), dim=-1)
    ijk = torch.clamp(ijk, 0, R - 1)
    occ = grid[ijk[..., 0], ijk[..., 1], ijk[..., 2]]
    return occ & inside


def _march_occupancy(grid, rays_o, rays_d, n_march: int):
    """Probe occupancy at n_march midpoints along each ray's [-1,1]^3
    chord.  Returns (occ (N,M) incl. box mask, t0, dt, t_mid), computed
    per axis like the JAX module."""
    N = rays_o.shape[0]
    dev = rays_o.device
    tmin, tmax = geometry.ray_box_intersection(
        rays_o, rays_d, torch.full((3,), -1.0, device=dev),
        torch.full((3,), 1.0, device=dev))
    box_hit = tmin >= 0.0
    t0 = torch.where(box_hit, tmin, 0.0)
    t1 = torch.where(box_hit, tmax, 0.0)
    dt = (t1 - t0) / n_march  # (N,)
    steps = (torch.arange(n_march, dtype=torch.float32, device=dev) + 0.5)[None, :]
    t_mid = t0[:, None] + steps * dt[:, None]  # (N, M)
    R = grid.shape[0]
    idx = None
    inside = None
    for k in range(3):
        pk = rays_o[:, k:k + 1] + rays_d[:, k:k + 1] * t_mid  # (N, M)
        gk = torch.floor((pk + 1.0) * 0.5 * R).to(torch.int64)
        ik = (gk >= 0) & (gk < R)
        inside = ik if inside is None else inside & ik
        gk = torch.clamp(gk, 0, R - 1)
        idx = gk if idx is None else idx * R + gk
    occ = grid.reshape(-1)[idx.reshape(-1)].reshape(N, n_march) & inside
    return occ & box_hit[:, None], t0, dt, t_mid


def _cdf_rank(cdf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rank of each s among its row of the nondecreasing cdf, #{cdf <= s}:
    the JAX module's broadcast compare-count, as a right-sided
    searchsorted (same integers, no (N, S, M) temp)."""
    return torch.searchsorted(cdf.contiguous(), s.contiguous(), right=True)


def _invert_occupied_cdf(occ, t0, dt, n_march: int, n_samples: int,
                         perturb: bool, u=None, generator=None):
    """Map stratified uniforms through the inverse of the occupied-length
    prefix sum (the union-of-spans CDF).  ``u``: optional (N, n_samples)
    jitter uniforms."""
    N = occ.shape[0]
    seg_len = torch.where(occ, dt[:, None], 0.0)  # (N, M)
    cdf = torch.cumsum(seg_len, dim=-1)  # (N, M)
    total = cdf[:, -1]  # (N,) occupied length
    hit = total > 1e-8

    base = (torch.arange(n_samples, dtype=torch.float32, device=occ.device)
            + 0.5) / n_samples
    s_u = base[None].expand(N, n_samples)
    if perturb:
        if u is None:
            u = _uniform((N, n_samples), occ, generator)
        jitter = (u - 0.5) / n_samples
        s_u = torch.clamp(s_u + jitter, 0.0, 1.0 - 1e-6)
    s = s_u * total[:, None]  # (N, S) target arc length

    k = torch.clamp(_cdf_rank(cdf, s), 0, n_march - 1)
    prev = torch.gather(cdf, -1, torch.clamp(k - 1, min=0))
    cdf_prev = torch.where(k > 0, prev, 0.0)
    t_step_start = t0[:, None] + k.to(torch.float32) * dt[:, None]
    # Residual arc length inside step k: the whole step is occupied.
    z = t_step_start + (s - cdf_prev)
    z = torch.where(hit[:, None], z, 0.0)
    return z, hit


def sample_rays_in_occupied_space(grid, rays_o, rays_d, n_march: int,
                                  n_samples: int, depth=None, trunc: float = 0.0,
                                  perturb: bool = True, u=None, generator=None):
    """Distribute ``n_samples`` per ray across occupied space along the ray.

    Returns (z_vals (N, n_samples), hit (N,), near, far) like the JAX
    function; ``u`` is the optional jitter uniforms."""
    occ, t0, dt, t_mid = _march_occupancy(grid, rays_o, rays_d, n_march)
    if depth is not None:
        depth_ok = depth > 1e-6
        clip_far = torch.where(depth_ok, depth + trunc, float("inf"))
        occ = occ & (t_mid <= clip_far[:, None])

    z, hit = _invert_occupied_cdf(occ, t0, dt, n_march, n_samples, perturb,
                                  u, generator)

    occ8 = occ.to(torch.uint8)
    first_idx = torch.argmax(occ8, dim=-1)
    last_idx = n_march - 1 - torch.argmax(occ8.flip(-1), dim=-1)
    near = torch.where(hit, t0 + first_idx.to(torch.float32) * dt, 0.0)
    far = torch.where(hit, t0 + (last_idx.to(torch.float32) + 1.0) * dt, 0.0)
    return z, hit, near, far


def sample_rays_occupied_with_fallback(grid, rays_o, rays_d, n_march: int,
                                       n_samples: int, n_samples_fb: int,
                                       depth, trunc: float = 0.0,
                                       perturb: bool = True, u_main=None,
                                       u_fb=None, generator=None):
    """One march, two sample sets: the depth-clipped main set and an
    unclipped fallback set (for rays without valid depth).  ``u_main``
    (N, n_samples) and ``u_fb`` (N, n_samples_fb) are the optional jitter
    uniforms, drawn in that order when absent."""
    occ_free, t0, dt, t_mid = _march_occupancy(grid, rays_o, rays_d, n_march)
    depth_ok = depth > 1e-6
    clip_far = torch.where(depth_ok, depth + trunc, float("inf"))
    occ_main = occ_free & (t_mid <= clip_far[:, None])
    z, hit = _invert_occupied_cdf(occ_main, t0, dt, n_march, n_samples,
                                  perturb, u_main, generator)
    z_fb, _ = _invert_occupied_cdf(occ_free, t0, dt, n_march, n_samples_fb,
                                   perturb, u_fb, generator)
    return z, z_fb, hit


def sample_rays_uniform(near, far, n_samples: int, perturb: bool = True,
                        u=None, generator=None) -> torch.Tensor:
    """Stratified uniform samples in [near, far] per ray (N,) -> (N, S)
    (reference sample_rays_uniform, nerf_runner.py:1066-1073)."""
    N = near.shape[0]
    s_u = ((torch.arange(n_samples, dtype=torch.float32, device=near.device)
            + 0.5) / n_samples)[None].expand(N, n_samples)
    if perturb:
        if u is None:
            u = _uniform((N, n_samples), near, generator)
        jitter = (u - 0.5) / n_samples
        s_u = torch.clamp(s_u + jitter, 0.0, 1.0)
    return near[:, None] + s_u * (far - near)[:, None]
