"""Neural Object Field volumetric rendering (port of
``bundlesdf_tpu/nof/render.py``; reference nerf_runner.py:1013-1168
render_rays / raw2outputs / sdf2weights).

Ray-batch layout (parity with the reference ray tensor,
nerf_runner.py:257-298):
  [0:3]  dir (camera GL frame, z = -1 plane, NOT unit)
  [3:6]  rgb target
  [6]    depth target (normalized units, z-depth convention)
  [7]    mask
  [8]    frame_id
  [9]    ray_type (0 good, 1 invalid-depth)
  [10]   near  [11] far

z values are in z-depth units (multiples of the z=-1-plane direction), so
they compare directly with the depth image.

Randomness: the three jitter draws of ``sample_z_vals`` and the uniforms
of ``sample_pdf`` are optional tensors in ``SampleDraws``; missing ones are
drawn from ``generator``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import nof as nof_model
from ..ops import occupancy as occ_ops

RAY_DIR = slice(0, 3)
RAY_RGB = slice(3, 6)
RAY_DEPTH = 6
RAY_MASK = 7
RAY_FRAME_ID = 8
RAY_TYPE = 9
RAY_NEAR = 10
RAY_FAR = 11
RAY_DIM = 12


class RenderCfg(NamedTuple):
    """Static rendering configuration (reference config.yml sampling keys)."""

    n_samples: int = 128
    n_samples_around_depth: int = 64
    n_importance: int = 0
    n_march: int = 256
    sdf_lambda: float = 5.0
    neg_trunc_ratio: float = 1.0
    near: float = 0.1
    far: float = 2.0
    sc_factor: float = 1.0
    perturb: bool = True


class SampleDraws(NamedTuple):
    """Uniforms in [0, 1) for one ``render_rays`` call; ``None`` fields are
    drawn from the generator.  The JAX counterparts are the
    ``jax.random.uniform`` draws of keys k1, k2 and k3 in ``sample_z_vals``
    and of ``k_imp`` in ``render_rays``."""

    occ: torch.Tensor | None = None       # (N, n_samples): occupied-space set
    band: torch.Tensor | None = None      # (N, n_samples_around_depth)
    fallback: torch.Tensor | None = None  # (N, n_samples_around_depth)
    # (N, n_importance): sample_pdf's uniforms (the JAX render's k_imp draw)
    importance: torch.Tensor | None = None

    def rows(self, sl: slice) -> "SampleDraws":
        """The draws of the rays in ``sl`` (for microbatch chunks)."""
        return SampleDraws(*(None if u is None else u[sl] for u in self))

    def to(self, device) -> "SampleDraws":
        """The draws on ``device``."""
        return SampleDraws(*(None if u is None else u.to(device) for u in self))


def sample_z_vals(cfg: RenderCfg, grid, rays_o_w, dirs_unit_w, dir_norm_cam,
                  depth, truncation, draws: SampleDraws | None = None,
                  generator: torch.Generator | None = None):
    """Occupancy-pruned z samples + near-depth band samples -> (N, S_total)
    (reference render_rays sampling, nerf_runner.py:1045-1085).  Sampling
    is not differentiated.  Returns (z_vals, hit)."""
    draws = SampleDraws() if draws is None else draws
    rays_o_w = rays_o_w.detach()
    dirs_unit_w = dirs_unit_w.detach()
    with torch.no_grad():
        depth_clip_t = (depth + truncation) * dir_norm_cam
        inv_norm = 1.0 / torch.clamp(dir_norm_cam, min=1e-10)
        if cfg.n_samples_around_depth > 0:
            # one occupancy march serves the depth-clipped main samples and
            # the unclipped fallback samples for invalid-depth rays
            t_occ, t_fb, hit = occ_ops.sample_rays_occupied_with_fallback(
                grid, rays_o_w, dirs_unit_w, cfg.n_march, cfg.n_samples,
                cfg.n_samples_around_depth, depth=depth_clip_t, trunc=0.0,
                perturb=cfg.perturb, u_main=draws.occ, u_fb=draws.fallback,
                generator=generator)
            z_occ = t_occ * inv_norm[:, None]
            valid_depth = ((depth >= cfg.near * cfg.sc_factor)
                           & (depth <= cfg.far * cfg.sc_factor))
            near_d = depth - truncation
            far_d = depth + truncation * cfg.neg_trunc_ratio
            z_band = occ_ops.sample_rays_uniform(
                near_d, far_d, cfg.n_samples_around_depth, cfg.perturb,
                u=draws.band, generator=generator)
            z_fb = t_fb * inv_norm[:, None]
            z_band = torch.where(valid_depth[:, None], z_band, z_fb)
            z = torch.cat([z_occ, z_band], dim=-1)
        else:
            t_occ, hit, _, _ = occ_ops.sample_rays_in_occupied_space(
                grid, rays_o_w, dirs_unit_w, cfg.n_march, cfg.n_samples,
                depth=depth_clip_t, trunc=0.0, perturb=cfg.perturb,
                u=draws.occ, generator=generator)
            z = t_occ * inv_norm[:, None]
    return z, hit


def sdf2weights(sdf_raw, z_vals, depth, truncation, cfg: RenderCfg):
    """Depth-guided compositing weights (reference nerf_runner.py:1146-1160):
    a sigmoid bell at the measured depth, masked to the truncation band,
    zeroed for invalid (> far) depth, normalized per ray."""
    del sdf_raw
    d = depth[:, None]
    s = (d - z_vals) / truncation
    w = torch.sigmoid(s * cfg.sdf_lambda) * torch.sigmoid(-s * cfg.sdf_lambda)
    band = (z_vals - d <= truncation * cfg.neg_trunc_ratio) & (z_vals - d >= -truncation)
    invalid = (depth > cfg.far * cfg.sc_factor)[:, None]
    w = torch.where(invalid, 0.0, torch.where(band, w, 0.0))
    return w / (torch.sum(w, dim=-1, keepdim=True) + 1e-10)


def render_rays(params: dict, spec: nof_model.NofSpec, cfg: RenderCfg, grid,
                ray_batch: torch.Tensor, c2w_array: torch.Tensor, truncation,
                draws: SampleDraws | None = None,
                generator: torch.Generator | None = None):
    """Render a batch of rays.

    Args:
      ray_batch: (N, RAY_DIM) in the layout above.
      c2w_array: (num_frames, 4, 4) normalized GL cam-to-object poses.
      truncation: scalar (annealed, normalized units).
    Returns dict: rgb_map (N,3), raw (N,S,4), z_vals (N,S), valid_samples
    (N,S), weights (N,S), pts (N,S,3), with S = n_samples +
    n_samples_around_depth + n_importance.
    """
    draws = SampleDraws() if draws is None else draws
    rays_d = ray_batch[:, RAY_DIR]
    frame_ids = ray_batch[:, RAY_FRAME_ID].to(torch.int64)
    depth = ray_batch[:, RAY_DEPTH]
    dir_norm = torch.linalg.norm(rays_d, dim=-1)
    viewdirs = rays_d / dir_norm[:, None]

    # pose correction on top of the tracker pose (nerf_runner.py:1052-1055)
    tf = c2w_array[frame_ids]
    if spec.optimize_poses:
        corr = nof_model.pose_array_matrices(params["pose_array"], spec, frame_ids)
        tf = corr @ tf

    rays_o_w = tf[:, :3, 3]
    dirs_w = torch.einsum("nij,nj->ni", tf[:, :3, :3], viewdirs)

    z_vals, hit = sample_z_vals(cfg, grid, rays_o_w, dirs_w, dir_norm, depth,
                                truncation, draws, generator)
    # points in camera frame (origin 0), then to object frame via tf
    pts_cam = rays_d[:, None, :] * z_vals[..., None]
    pts_w = torch.einsum("nij,nsj->nsi", tf[:, :3, :3], pts_cam) + tf[:, None, :3, 3]

    raw, valid_samples = nof_model.nof_forward(params, spec, pts_w, dirs_w, frame_ids)
    valid_samples = valid_samples & hit[:, None]

    weights = sdf2weights(raw[..., 3], z_vals, depth, truncation, cfg)
    weights = torch.where(valid_samples, weights, 0.0)
    rgb = torch.sigmoid(raw[..., :3])
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)

    if cfg.n_importance > 0:
        # Hierarchical importance resampling (reference nerf_runner.py:
        # 1088-1112, as the JAX render): n_importance extra z's from the
        # first pass's weight pdf, only the new points queried, both sample
        # sets merged in z order and recomposited.  Kept deviation of the
        # JAX render: the reference's last raw2outputs call omits `depth`;
        # here it recomposites with the same depth.
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samp = sample_pdf(z_mid, weights[..., 1:-1], cfg.n_importance,
                            det=not cfg.perturb, u=draws.importance,
                            generator=generator).detach()
        pts_cam_i = rays_d[:, None, :] * z_samp[..., None]
        pts_w_i = (torch.einsum("nij,nsj->nsi", tf[:, :3, :3], pts_cam_i)
                   + tf[:, None, :3, 3])
        raw_i, valid_i = nof_model.nof_forward(params, spec, pts_w_i, dirs_w, frame_ids)
        # rays with no valid first-pass sample stay invalid (reference
        # valid_samples_importance zeroing, nerf_runner.py:1095-1096)
        valid_i = valid_i & valid_samples.any(dim=-1, keepdim=True)

        # a stable sort, as jnp.argsort: equal z keep first-pass-first order
        z_all = torch.cat([z_vals, z_samp], dim=-1)
        order = torch.argsort(z_all, dim=-1, stable=True)
        z_vals = torch.gather(z_all, 1, order)
        raw = torch.gather(torch.cat([raw, raw_i], dim=1), 1,
                           order[..., None].expand(-1, -1, raw.shape[-1]))
        valid_samples = torch.gather(torch.cat([valid_samples, valid_i], dim=-1), 1, order)
        pts_w = torch.gather(torch.cat([pts_w, pts_w_i], dim=1), 1,
                             order[..., None].expand(-1, -1, 3))
        weights = sdf2weights(raw[..., 3], z_vals, depth, truncation, cfg)
        weights = torch.where(valid_samples, weights, 0.0)
        rgb = torch.sigmoid(raw[..., :3])
        rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)

    return {
        "rgb_map": rgb_map,
        "raw": raw,
        "z_vals": z_vals,
        "valid_samples": valid_samples,
        "weights": weights,
        "pts": pts_w,
    }


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, eps: float = 1e-5, u: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Hierarchical importance sampling along rays (JAX ``sample_pdf``;
    reference sample_pdf nerf_helpers.py:324-354).

    bins: (N, B) z midpoints; weights: (N, B-1).  Returns (N, n_samples)
    z values distributed ~ the weight pdf (inverse-transform sampling).
    ``u``: (N, n_samples) uniforms, drawn from ``generator`` when absent
    (unused when ``det``).  The bin of each u is the rank count
    ``sum(cdf <= u)``, as in the JAX function, so tied cdf values (equal
    f32 prefix sums) rank alike."""
    w = weights + eps
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (N, B)
    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        # jnp.linspace(0, 1, n) as XLA computes it: i * f32(1 / (n - 1)),
        # the last one exactly 1 (torch.linspace rounds some others apart)
        u = torch.arange(n_samples, dtype=cdf.dtype, device=cdf.device) * (
            1.0 / max(n_samples - 1, 1))
        u[-1] = 1.0
        u = u.expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=generator, device=cdf.device)
    idx = torch.sum(cdf[..., None, :] <= u[..., :, None], dim=-1)
    below = torch.clamp(idx - 1, 0, cdf.shape[-1] - 1)
    above = torch.clamp(idx, 0, cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bin_b = torch.gather(bins, -1, torch.clamp(below, 0, bins.shape[-1] - 1))
    bin_a = torch.gather(bins, -1, torch.clamp(above, 0, bins.shape[-1] - 1))
    denom = torch.where(cdf_a - cdf_b < 1e-8, 1.0, cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)
