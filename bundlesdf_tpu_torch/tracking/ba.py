"""Pose-graph bundle adjustment: sparse feature term + dense point-to-plane
ICP term, Gauss-Newton with direct normal-equation solves (port of
``bundlesdf_tpu/tracking/ba.py``).

The reference GPU solver (LossGPU.cpp OptimizerGpu::optimizeFrames;
SolverBundling.cu: 7 outer Gauss-Newton iterations, Huber feature residuals
||Ti pi - Tj pj|| plus dense point-to-plane residuals re-associated every
outer iteration at 1/4 resolution).  With N <= max_BA_frames (10) poses the
normal equations are (6N, 6N): each outer iteration builds them by
scatter-adds over all residuals (``index_add_``, repeated indices summed)
and solves them directly.  The JAX ``lax.scan``
over outer iterations is a Python loop.

Conventions: poses are cam-in-model; increments left-multiply
(``T <- exp(xi) T``) with xi = [t(3), w(3)].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import se3


class BAParams(NamedTuple):
    """Static BA configuration (reference config_ho3d.yml bundle section)."""

    num_iter_outer: int = 7
    robust_delta: float = 0.005
    w_fm: float = 1.0
    w_p2p: float = 1.0
    image_downscale: int = 4
    dense_max_dist: float = 0.02
    dense_max_normal_angle: float = 45.0
    icp_rot_thres_deg: float = 60.0
    damping: float = 1e-4


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _scatter_blocks(n_frames: int, i, j, Hii, Hij, Hji, Hjj, bi, bj):
    """H (N, N, 6, 6) and b (N, 6) from per-residual-block products at frame
    indices i, j; repeated indices are summed.  One ``index_add_`` each
    over flat block indices: on CUDA it adds with atomics, where
    ``index_put_(..., accumulate=True)`` sorts the indices first (about
    110 ms a frame at the tracker's shapes on an H100)."""
    N = n_frames
    rows = torch.cat([i * N + i, i * N + j, j * N + i, j * N + j])
    H = torch.zeros((N * N, 36), dtype=Hii.dtype, device=Hii.device)
    H.index_add_(0, rows, torch.cat([Hii, Hij, Hji, Hjj]).reshape(-1, 36))
    b = torch.zeros((N, 6), dtype=Hii.dtype, device=Hii.device)
    b.index_add_(0, torch.cat([i, j]), torch.cat([bi, bj]))
    return H.reshape(N, N, 6, 6), b


def _feature_system(poses, ii, jj, pi, pj, valid, delta: float, n_frames: int):
    """Sparse feature-term contributions: residual r = Ti pi - Tj pj (model
    frame), Huber-weighted IRLS (robust_delta, config_ho3d.yml:49).
    Returns H (N, N, 6, 6), b (N, 6), chi2 scalar."""
    Ti = poses[ii]  # (E, 4, 4)
    Tj = poses[jj]
    xi_w = torch.einsum("eab,eb->ea", Ti[:, :3, :3], pi) + Ti[:, :3, 3]
    xj_w = torch.einsum("eab,eb->ea", Tj[:, :3, :3], pj) + Tj[:, :3, 3]
    r = xi_w - xj_w
    rn = torch.linalg.norm(r, dim=-1)
    huber_w = torch.where(rn <= delta, 1.0, delta / torch.clamp(rn, min=1e-12))
    w = huber_w * valid.to(r.dtype)

    # J_i = [I | -skew(xi_w)], J_j = -[I | -skew(xj_w)]  (3, 6) each
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device).expand(r.shape[0], 3, 3)
    Jii = torch.cat([eye3, -se3.hat(xi_w)], dim=-1)  # (E, 3, 6)
    Jjj = -torch.cat([eye3, -se3.hat(xj_w)], dim=-1)

    Wii = Jii * w[:, None, None]
    Wjj = Jjj * w[:, None, None]
    H, b = _scatter_blocks(
        n_frames, ii, jj,
        torch.einsum("eai,eaj->eij", Wii, Jii), torch.einsum("eai,eaj->eij", Wii, Jjj),
        torch.einsum("eai,eaj->eij", Wjj, Jii), torch.einsum("eai,eaj->eij", Wjj, Jjj),
        torch.einsum("eai,ea->ei", Wii, r), torch.einsum("eai,ea->ei", Wjj, r))
    return H, b, torch.sum(w * rn * rn)


def _dense_system(poses, pair_i, pair_j, pair_valid, xyz_ds, normal_ds, valid_ds,
                  K_ds, params: BAParams, n_frames: int):
    """Dense point-to-plane contributions, re-associated projectively: each
    active pair (i, j) moves i's downsampled points into j's camera,
    projects with K_ds, reads j's xyz/normals there, gates by distance and
    normal agreement, and accumulates r = n_j . (x_i - x_j) (reference
    FindDenseCorrespondences/BuildDenseSystem, SolverBundling.cu:78-479)."""
    h, w3 = xyz_ds.shape[1:3]
    n_pix = h * w3
    dtype = poses.dtype
    P = pair_i.shape[0]

    Ti = poses[pair_i]
    Tj = poses[pair_j]
    rel = se3.inv_pose(Tj) @ Ti  # i cam -> j cam

    # Gate whole pairs by relative rotation (icp_pose_rot_thres).
    rot = se3.rotation_geodesic_distance(
        rel[:, :3, :3], torch.eye(3, dtype=dtype, device=poses.device).expand(P, 3, 3))
    pair_ok = pair_valid & (rot <= torch.deg2rad(_f32(params.icp_rot_thres_deg, rot)))

    pts_i = xyz_ds[pair_i].reshape(P, n_pix, 3)
    nrm_i = normal_ds[pair_i].reshape(P, n_pix, 3)
    ok_i = valid_ds[pair_i].reshape(P, n_pix)

    p_in_j = torch.einsum("pab,pnb->pna", rel[:, :3, :3], pts_i) + rel[:, None, :3, 3]
    z = p_in_j[..., 2]
    u = K_ds[0, 0] * p_in_j[..., 0] / torch.clamp(z, min=1e-6) + K_ds[0, 2]
    v = K_ds[1, 1] * p_in_j[..., 1] / torch.clamp(z, min=1e-6) + K_ds[1, 2]
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    inb = (ui >= 0) & (ui < w3) & (vi >= 0) & (vi < h) & (z > 0.1)
    pix = (vi.clamp(0, h - 1) * w3 + ui.clamp(0, w3 - 1)).to(torch.int64)  # (P, n)

    def at_j(maps):
        flat = maps[pair_j].reshape((P, n_pix) + maps.shape[3:])
        idx = pix.reshape(pix.shape + (1,) * (maps.ndim - 3))
        return torch.gather(flat, 1, idx.expand(pix.shape + maps.shape[3:]))

    tgt = at_j(xyz_ds)
    tgt_n = at_j(normal_ds)
    tgt_ok = at_j(valid_ds)

    x_i_w = torch.einsum("pab,pnb->pna", Ti[:, :3, :3], pts_i) + Ti[:, None, :3, 3]
    x_j_w = torch.einsum("pab,pnb->pna", Tj[:, :3, :3], tgt) + Tj[:, None, :3, 3]
    n_j_w = torch.einsum("pab,pnb->pna", Tj[:, :3, :3], tgt_n)
    n_i_w = torch.einsum("pab,pnb->pna", Ti[:, :3, :3], nrm_i)

    diff = x_i_w - x_j_w
    dist = torch.linalg.norm(diff, dim=-1)
    n_dot = torch.sum(n_i_w * n_j_w, dim=-1)
    cos_th = torch.cos(torch.deg2rad(_f32(params.dense_max_normal_angle, dist)))
    has_n = ((torch.linalg.norm(tgt_n, dim=-1) > 0.5)
             & (torch.linalg.norm(nrm_i, dim=-1) > 0.5))
    ok = (ok_i & inb & tgt_ok & has_n & (dist < params.dense_max_dist)
          & (n_dot > cos_th) & pair_ok[:, None])
    w = ok.to(dtype)

    r = torch.sum(n_j_w * diff, dim=-1)  # (P, n_pix)
    # J_i = [n | x_i x n], J_j = -[n | x_j x n]
    Ji = torch.cat([n_j_w, torch.linalg.cross(x_i_w, n_j_w, dim=-1)], dim=-1)
    Jj = -torch.cat([n_j_w, torch.linalg.cross(x_j_w, n_j_w, dim=-1)], dim=-1)

    Wi = Ji * w[..., None]
    Wj = Jj * w[..., None]
    H, b = _scatter_blocks(
        n_frames, pair_i, pair_j,
        torch.einsum("pni,pnj->pij", Wi, Ji), torch.einsum("pni,pnj->pij", Wi, Jj),
        torch.einsum("pni,pnj->pij", Wj, Ji), torch.einsum("pni,pnj->pij", Wj, Jj),
        torch.einsum("pni,pn->pi", Wi, r), torch.einsum("pni,pn->pi", Wj, r))
    return H, b, torch.sum(w * r * r)


def solve_gn_step(H, b, fixed, n_frames: int, damping: float):
    """One Gauss-Newton update from assembled normal equations.  Fixed
    frames get identity rows/cols and zero rhs (reference update_pose_flags
    freezing, Bundler.cpp:908-914).  Returns xi (N, 6)."""
    free = (~fixed).to(H.dtype)
    mask2 = free[:, None] * free[None, :]
    Hm = H * mask2[:, :, None, None]
    bm = b * free[:, None]
    A = Hm.permute(0, 2, 1, 3).reshape(n_frames * 6, n_frames * 6)
    diag_boost = torch.repeat_interleave(1.0 - free, 6)
    scale = torch.clamp(torch.diagonal(A).max(), min=1.0)
    A = A + torch.diag(diag_boost * scale + damping * scale
                       * torch.ones(n_frames * 6, dtype=H.dtype, device=H.device))
    xi = torch.linalg.solve(A, -bm.reshape(-1))
    return xi.reshape(n_frames, 6)


def bundle_adjust(poses, fixed, ii, jj, pi, pj, corr_valid, pair_i, pair_j,
                  pair_valid, xyz_ds, normal_ds, valid_ds, K_ds,
                  params: BAParams = BAParams(), n_frames: int = 10, reduce=None):
    """Joint pose-graph optimization.

    Args:
      poses: (N, 4, 4) cam-in-model initial poses (N = n_frames, padded).
      fixed: (N,) bool — frozen poses (frame 0 + nerfed keyframes).
      ii, jj: (E,) int64 frame indices of sparse correspondences; pi, pj:
        (E, 3) camera-frame points; corr_valid: (E,) mask.
      pair_i, pair_j: (P,) int64 dense-term pair indices; pair_valid: (P,).
      xyz_ds, normal_ds, valid_ds: (N, h, w, {3,3,-}) downsampled maps.
      K_ds: (3, 3) downsampled intrinsics.
      reduce: optional hook ``flat -> flat`` that sums a tensor over the
        ranks that each hold a share of the edges and pairs
        (``parallel/ba_shard.py``); it is handed each outer iteration's H,
        b and both chi2 in one flat tensor, and every rank then solves the
        same system.
    Returns: (poses_out, info dict of per-iteration chi2 tensors).
    """
    chi_f, chi_d = [], []
    for _ in range(params.num_iter_outer):
        Hf, bf, cf = _feature_system(poses, ii, jj, pi, pj, corr_valid,
                                     params.robust_delta, n_frames)
        Hd, bd, cd = _dense_system(poses, pair_i, pair_j, pair_valid, xyz_ds,
                                   normal_ds, valid_ds, K_ds, params, n_frames)
        H = params.w_fm * Hf + params.w_p2p * Hd
        b = params.w_fm * bf + params.w_p2p * bd
        if reduce is not None:
            flat = reduce(torch.cat([H.reshape(-1), b.reshape(-1), cf[None], cd[None]]))
            H, b = flat[: H.numel()].view_as(H), flat[H.numel(): H.numel() + b.numel()].view_as(b)
            cf, cd = flat[-2], flat[-1]
        xi = solve_gn_step(H, b, fixed, n_frames, params.damping)
        poses_new = se3.se3_exp(xi) @ poses
        poses = torch.where(fixed[:, None, None], poses, poses_new)
        chi_f.append(cf)
        chi_d.append(cd)
    return poses, {"chi2_feature": torch.stack(chi_f), "chi2_dense": torch.stack(chi_d)}
