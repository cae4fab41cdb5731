"""The stage the step's reference takes from the program's state, checked by
itself: each ray of a seeded sample of the pool must be a pixel of its
frame, with that pixel's colour, depth and mask as the reference's
preprocessing (nerf_helpers.py:218-240) gives them, under the normalized
true camera pose; and the scene normalization must hold the whole cube
inside [-1, 1]^3.  Host numpy, float64."""
from __future__ import annotations

import numpy as np

BAD_DEPTH = 99.0
BAD_COLOR = 128
SAMPLE = 4096
GLCAM_IN_CVCAM = np.diag([1.0, -1.0, -1.0, 1.0])


def mismatches(cfg: dict, pool: dict, inputs: dict, seed: int = 0) -> int:
    """Sampled pool rows that disagree with the frames, plus cube points
    that the normalization leaves outside [-1, 1]^3."""
    sc = float(cfg["sc_factor"])
    tr = np.asarray(cfg["translation"], np.float64)
    K = np.asarray(inputs["K"], np.float64)
    rays = pool["rays"]
    n_frames = pool["n_frames"]
    c2w = np.stack([np.linalg.inv(T) @ GLCAM_IN_CVCAM for T in inputs["gt"][:n_frames]])
    c2w[:, :3, 3] = (c2w[:, :3, 3] + tr) * sc
    bad = int(np.abs(pool["c2w"][:n_frames] - c2w).max() > 1e-5)

    rng = np.random.default_rng(seed)
    rows = rays[rng.choice(len(rays), min(SAMPLE, len(rays)), replace=False)].astype(np.float64)
    fid = rows[:, 8].astype(np.int64)
    u = rows[:, 0] * K[0, 0] + K[0, 2]
    v = -rows[:, 1] * K[1, 1] + K[1, 2]
    ui, vi = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)
    ok = (np.abs(u - ui) < 1e-3) & (np.abs(v - vi) < 1e-3) & (rows[:, 2] == -1.0)
    ok &= (fid >= 0) & (fid < n_frames)
    H, W = inputs["colors"][0].shape[:2]
    ok &= (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    fid, ui, vi = np.where(ok, fid, 0), np.clip(ui, 0, W - 1), np.clip(vi, 0, H - 1)
    colors = np.stack(inputs["colors"])[fid, vi, ui].astype(np.float64) / 255.0
    depth = np.stack(inputs["depths"])[fid, vi, ui].astype(np.float64)
    mask = np.stack(inputs["masks"])[fid, vi, ui] > 0
    colors = np.where(mask[:, None], colors, BAD_COLOR / 255.0)
    depth = np.where((depth < 0.1) | ~mask, BAD_DEPTH, depth) * sc
    ok &= np.abs(rows[:, 3:6] - colors).max(-1) < 1e-6
    ok &= np.abs(rows[:, 6] - depth) <= 1e-6 * np.maximum(1.0, depth)
    ok &= rows[:, 7] == mask.astype(np.float64)
    ok &= rows[:, 9] == 0.0
    # the ray's entry into and exit from [-1, 1]^3 under its camera
    d = rows[:, 0:3] / np.linalg.norm(rows[:, 0:3], axis=-1, keepdims=True)
    R, o = c2w[fid, :3, :3], c2w[fid, :3, 3]
    dw = np.einsum("nij,nj->ni", R, d)
    inv = 1.0 / np.where(np.abs(dw) < 1e-10, np.where(dw < 0, -1e-10, 1e-10), dw)
    t0, t1 = (-1.0 - o) * inv, (1.0 - o) * inv
    near = np.maximum(np.minimum(t0, t1), 0.0).max(-1)
    far = np.maximum(t0, t1).min(-1)
    ok &= (np.abs(rows[:, 10] - near) < 1e-4) & (np.abs(rows[:, 11] - far) < 1e-4)
    bad += int((~ok).sum())

    pts = (np.asarray(inputs["model_pts"], np.float64) + tr) * sc
    bad += int((np.abs(pts) > 1.0).any(-1).sum())
    return bad
