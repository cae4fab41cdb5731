"""Multi-pair RANSAC rigid-pose estimation (port of
``bundlesdf_tpu/ops/ransac.py``).

The reference's GPU RANSAC (cuda_ransac.cu:1167-1616) as one dense
(pairs, trials) program: sample 3 valid correspondences per trial,
closed-form 3-point rigid solve, a (pairs, trials, matches) inlier grid,
best-trial selection under per-pair trans/rot caps, and a Kabsch refit on
the best trial's inliers.

Random draws: the JAX module draws ``jax.random.uniform(key, (P, T, 3))``
inside ``_sample_indices``; here the caller passes that (P, T, 3) tensor of
uniforms in [0, 1) (``draws``), so a test can hand the port the JAX stream
itself.  ``draw_uniforms`` makes them: from a caller's draw source, or from
a ``torch.Generator`` on the device seeded with the frame id.

The inlier grid uses the JAX module's expanded form of |R a + t - b|^2 as
one batched product; near the 5 mm gate its cancellation leaves about
1e-7 m^2, so rows that close to the gate may flip between frameworks.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils import se3


class RansacParams(NamedTuple):
    """Static RANSAC parameters (reference config_ho3d.yml:85-96)."""

    n_trials: int = 2000
    inlier_dist: float = 0.005
    inlier_normal_angle_deg: float = 30.0
    max_trans: float = 0.02
    max_rot_deg: float = 30.0
    min_match_after_ransac: int = 5


# ransac_draws(seed, shape) -> tensor of uniforms in [0, 1)
DrawSource = Callable[[int, tuple], torch.Tensor]


def draw_uniforms(seed: int, shape: tuple, device, source: DrawSource | None = None):
    """The RANSAC draws of one call: ``source(seed, shape)`` moved to
    ``device`` when a source is given, else uniforms from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (the frame id,
    the seed of the JAX package's ``jax.random.PRNGKey``)."""
    if source is not None:
        u = source(seed, tuple(shape))
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"draw source gave {tuple(u.shape)}, want {tuple(shape)}")
        return u.to(device=device, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(shape, generator=gen, device=device)


def _deg2rad(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.deg2rad(torch.tensor(x, dtype=torch.float32, device=like.device))


def _sample_indices(draws: torch.Tensor, n_pairs: int, n_trials: int,
                    n_matches: int, valid: torch.Tensor) -> torch.Tensor:
    """3 correspondence indices per (pair, trial), uniform over the VALID
    rows: a stable argsort of ~valid lists the valid rows first, and a draw
    in [0, n_valid) indexes that list.  ``draws`` (P, T, 3) in [0, 1)."""
    valid_rows = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    n_valid = torch.clamp(valid.sum(dim=-1), min=1)  # (P,)
    r = torch.minimum((draws * n_valid[:, None, None]).to(torch.int64),
                      (n_valid - 1)[:, None, None])  # (P, T, 3), truncation
    return torch.gather(valid_rows, 1, r.reshape(n_pairs, -1)).reshape(
        n_pairs, n_trials, 3)


def _tri_rigid(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid transform from 3-point correspondences without an
    SVD: orthonormal triangle bases on both sides, R = B A^T,
    t = c_b - R c_a.  (..., 3, 3) triples -> (..., 4, 4)."""

    def basis(p):
        e1 = p[..., 1, :] - p[..., 0, :]
        e1 = e1 / (torch.linalg.norm(e1, dim=-1, keepdim=True) + 1e-12)
        u = p[..., 2, :] - p[..., 0, :]
        e2 = u - torch.sum(u * e1, dim=-1, keepdim=True) * e1
        e2 = e2 / (torch.linalg.norm(e2, dim=-1, keepdim=True) + 1e-12)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        return torch.stack([e1, e2, e3], dim=-1)  # columns

    R = basis(b) @ basis(a).transpose(-1, -2)
    t = b.mean(dim=-2) - torch.einsum("...ij,...j->...i", R, a.mean(dim=-2))
    return se3.pack_pose(R, t)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (P, M, ...) gathered at idx (P, n) along M -> (P, n, ...)."""
    tail = x.shape[2:]
    i = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(x, 1, i)


def ransac_multi_pair(draws: torch.Tensor, pts_a: torch.Tensor, pts_b: torch.Tensor,
                      normals_a: torch.Tensor, normals_b: torch.Tensor,
                      valid: torch.Tensor, params: RansacParams = RansacParams(),
                      max_trans: torch.Tensor | None = None,
                      max_rot_deg: torch.Tensor | None = None):
    """Estimate a rigid transform per pair mapping pts_a -> pts_b.

    Args:
      draws: (n_pairs, n_trials, 3) uniforms in [0, 1) (``draw_uniforms``).
      pts_a, pts_b: (n_pairs, n_matches, 3) corresponding 3D points in a
        common (model) frame.
      normals_a, normals_b: (n_pairs, n_matches, 3) unit normals (0 if none).
      valid: (n_pairs, n_matches) bool.
      max_trans, max_rot_deg: optional per-pair (n_pairs,) model caps.
    Returns dict: pose (n_pairs, 4, 4) refit best model (identity where the
      pair failed), inliers (n_pairs, n_matches) bool, n_inliers (n_pairs,)
      int, ok (n_pairs,) bool.
    """
    n_pairs, n_matches, _ = pts_a.shape
    n_trials = params.n_trials
    idx = _sample_indices(draws, n_pairs, n_trials, n_matches, valid)  # (P, T, 3)
    flat = idx.reshape(n_pairs, -1)
    tri_a = _take_rows(pts_a, flat).reshape(n_pairs, n_trials, 3, 3)
    tri_b = _take_rows(pts_b, flat).reshape(n_pairs, n_trials, 3, 3)
    tri_valid = _take_rows(valid, flat).reshape(n_pairs, n_trials, 3)

    # Degeneracy: minimum pairwise span and distinct indices.
    def dist(t, i, j):
        return torch.linalg.norm(t[..., i, :] - t[..., j, :], dim=-1)

    d01, d02, d12 = dist(tri_a, 0, 1), dist(tri_a, 0, 2), dist(tri_a, 1, 2)
    min_span = torch.minimum(torch.minimum(d01, d02), d12)
    distinct = ((idx[..., 0] != idx[..., 1]) & (idx[..., 0] != idx[..., 2])
                & (idx[..., 1] != idx[..., 2]))
    # Pairwise-distance consistency between the two point sets (<= 5 mm,
    # reference FeatureManager.cpp:1290-1304).
    e01 = torch.abs(d01 - dist(tri_b, 0, 1))
    e02 = torch.abs(d02 - dist(tri_b, 0, 2))
    e12 = torch.abs(d12 - dist(tri_b, 1, 2))
    consistent = torch.maximum(torch.maximum(e01, e02), e12) < 0.005
    trial_ok = distinct & tri_valid.all(dim=-1) & (min_span > 1e-4) & consistent

    T = _tri_rigid(tri_a, tri_b)  # (P, T, 4, 4)

    # Inlier grid (P, T, M) as one batched product:
    #   |R a + t - b|^2 = |a|^2 + |b|^2 + |t|^2
    #                     + 2 a.(R^T t) - 2 vec(R).vec(b (x) a) - 2 b.t
    #   n_b.(R n_a)     =                   vec(R).vec(n_b (x) n_a)
    Rm = T[..., :3, :3]
    tm = T[..., :3, 3]
    Rt_t = torch.einsum("ptij,pti->ptj", Rm, tm)  # R^T t
    w_dist = torch.cat([-2.0 * Rm.reshape(n_pairs, n_trials, 9), 2.0 * Rt_t,
                        -2.0 * tm, torch.sum(tm * tm, dim=-1, keepdim=True)],
                       dim=-1)  # (P, T, 16)
    ba_outer = pts_b[..., :, None] * pts_a[..., None, :]
    f_dist = torch.cat([ba_outer.reshape(n_pairs, n_matches, 9), pts_a, pts_b,
                        torch.ones_like(pts_a[..., :1])], dim=-1)  # (P, M, 16)
    dist2 = (torch.bmm(w_dist, f_dist.transpose(1, 2))
             + torch.sum(pts_a * pts_a, dim=-1)[:, None, :]
             + torch.sum(pts_b * pts_b, dim=-1)[:, None, :])
    nn_outer = normals_b[..., :, None] * normals_a[..., None, :]
    cos_n = torch.bmm(Rm.reshape(n_pairs, n_trials, 9),
                      nn_outer.reshape(n_pairs, n_matches, 9).transpose(1, 2))
    has_n = ((torch.linalg.norm(normals_a, dim=-1) > 0.5)
             & (torch.linalg.norm(normals_b, dim=-1) > 0.5))
    cos_thres = torch.cos(_deg2rad(params.inlier_normal_angle_deg, pts_a))
    normal_ok = torch.where(has_n[:, None], cos_n > cos_thres, True)
    inlier = (dist2 < params.inlier_dist ** 2) & normal_ok & valid[:, None]
    n_inl = inlier.sum(dim=-1)  # (P, T)

    # Model caps (reference findBestInlier, cuda_ransac.cu:1420-1460).
    trans_mag = torch.linalg.norm(tm, dim=-1)
    rot_mag = se3.rotation_geodesic_distance(
        Rm, torch.eye(3, dtype=Rm.dtype, device=Rm.device).expand(Rm.shape))
    if max_trans is None:
        max_trans = torch.full((n_pairs,), params.max_trans, device=pts_a.device)
    if max_rot_deg is None:
        max_rot_deg = torch.full((n_pairs,), params.max_rot_deg, device=pts_a.device)
    cap_ok = ((trans_mag <= max_trans[:, None])
              & (rot_mag <= torch.deg2rad(max_rot_deg)[:, None]))
    score = torch.where(trial_ok & cap_ok, n_inl, -1)
    best = torch.argmax(score, dim=-1)  # (P,), first maximum
    rows = torch.arange(n_pairs, device=pts_a.device)
    best_inlier = inlier[rows, best]  # (P, M)
    best_score = score[rows, best]

    # Refit on all inliers of the best trial, then re-evaluate.
    refit = se3.kabsch(pts_a, pts_b, best_inlier.to(torch.float32))
    moved_r = torch.einsum("pij,pmj->pmi", refit[..., :3, :3], pts_a) + refit[:, None, :3, 3]
    dist_r = torch.linalg.norm(moved_r - pts_b, dim=-1)
    moved_rn = torch.einsum("pij,pmj->pmi", refit[..., :3, :3], normals_a)
    cos_rn = torch.sum(moved_rn * normals_b, dim=-1)
    normal_ok_r = torch.where(has_n, cos_rn > cos_thres, True)
    final_inlier = (dist_r < params.inlier_dist) & normal_ok_r & valid
    n_final = final_inlier.sum(dim=-1)

    ok = ((best_score >= params.min_match_after_ransac)
          & (n_final >= params.min_match_after_ransac))
    eye = torch.eye(4, dtype=refit.dtype, device=refit.device).expand(refit.shape)
    pose = torch.where(ok[:, None, None], refit, eye)
    return {
        "pose": pose,
        "inliers": final_inlier & ok[:, None],
        "n_inliers": torch.where(ok, n_final, 0),
        "ok": ok,
    }


def procrustes_by_correspondence(pts_a: torch.Tensor, pts_b: torch.Tensor,
                                 inliers: torch.Tensor) -> torch.Tensor:
    """Weighted rigid solve on surviving correspondences -> pose increment
    (reference FeatureManager.cpp:1050-1129 procrustesByCorrespondence)."""
    return se3.kabsch(pts_a, pts_b, inliers.to(torch.float32))
