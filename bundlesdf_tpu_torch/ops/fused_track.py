"""Fused per-frame tracking program: BA-pair matching + bundle adjustment
from one packed upload to one readback (port of
``bundlesdf_tpu/ops/fused_track.py``).

    warp + match + gate + RANSAC for the frame's FRESH pairs [fused_corres]
  -> merge their edges with host-uploaded edges of pairs matched on
     EARLIER frames (store.matches)
  -> dense-term maps by strided downsampling of the resident device pool
     (no per-frame upload of them; the reference's CUDACache keeps them on
     the GPU too)
  -> Gauss-Newton BA (tracking/ba.py)
  -> one readback: fresh-pair match tables + optimized poses.

Reference anchors: the reference's per-frame loop reads its match tables
and CUDACache straight from GPU memory (bundlesdf.py:391-506; optimizeGPU
Bundler.cpp:810-956).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..tracking import ba as ba_mod
from . import fused_corres as fc


class FusedTrackCfg(NamedTuple):
    corres: fc.FusedCorresCfg = fc.FusedCorresCfg()
    ba: ba_mod.BAParams = ba_mod.BAParams()
    n_frames: int = 10     # BA pose-graph width (max_BA_frames)
    host_edge_cap: int = 8192  # capacity for edges of already-matched pairs


def fused_match_ba(gray_pool, depth_pool, normal_pool, K, packed, fresh_lij, draws,
                   poses, fixed, frame_slot, h_ii, h_jj, h_pi, h_pj, h_valid,
                   pair_i, pair_j, pair_valid, cfg: FusedTrackCfg = FusedTrackCfg()):
    """Device tensors in, device tensors out.

    packed (P, 56+4E) fresh pairs (``fc.pack_call``); fresh_lij (P, 2) local
    BA indices (-1 for padding); draws (P, T, 3) RANSAC uniforms; poses
    (N, 4, 4) local-frame poses (padded); fixed (N,) bool; frame_slot (N,)
    pool slot per local frame (-1 for padding: it wraps to the last slot
    and is masked out, as in the JAX program); h_* (Eh,) host edges;
    pair_i, pair_j, pair_valid (Q,) dense-term pairs.
    Returns (corres_readback (P, M+3, 8), poses_out (N, 4, 4), info)."""
    N = cfg.n_frames
    P = packed.shape[0]
    M = cfg.corres.matcher.max_matches

    # 1. fresh-pair match (warp -> match -> gate -> RANSAC)
    res = fc._unpack_and_run(gray_pool, depth_pool, normal_pool, K, packed, draws,
                             cfg.corres)

    # 2. edge set = host edges (earlier frames) + fresh in-program edges;
    #    fresh pair p contributes its M rows with weight inlier & gate.
    f_w = res["inlier"] & res["gate_valid"]
    f_ii = fresh_lij[:, 0:1].expand(P, M).reshape(-1)
    f_jj = fresh_lij[:, 1:2].expand(P, M).reshape(-1)
    f_valid = (f_w & (fresh_lij[:, 0:1] >= 0)).reshape(-1)
    ii = torch.cat([h_ii, f_ii.clamp(0, N - 1)])
    jj = torch.cat([h_jj, f_jj.clamp(0, N - 1)])
    pi = torch.cat([h_pi, res["pA"].reshape(-1, 3)])
    pj = torch.cat([h_pj, res["pB"].reshape(-1, 3)])
    cvalid = torch.cat([h_valid, f_valid])

    # 3. dense maps from the resident pool (strided downsample; the pool
    #    holds the host maps at 0.1 mm / 1/127, far below the dense gates)
    f = cfg.ba.image_downscale
    d_ds = depth_pool[frame_slot][:, ::f, ::f]   # (N, h, w)
    n_ds = normal_pool[frame_slot][:, ::f, ::f]  # (N, h, w, 3)
    h, w = d_ds.shape[1:3]
    K_ds = torch.cat([K[:2] * (1.0 / f), K[2:]])
    u = torch.arange(w, dtype=torch.float32, device=K.device)[None, :].expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=K.device)[:, None].expand(h, w)
    x = (u - K_ds[0, 2]) / K_ds[0, 0] * d_ds
    y = (v - K_ds[1, 2]) / K_ds[1, 1] * d_ds
    xyz_ds = torch.stack([x, y, d_ds], dim=-1)
    ok_ds = (d_ds > 0.1) & (torch.linalg.norm(n_ds, dim=-1) > 0.5)
    ok_ds = ok_ds & (frame_slot >= 0)[:, None, None]

    # 4. BA
    poses_out, info = ba_mod.bundle_adjust(
        poses, fixed, ii, jj, pi, pj, cvalid, pair_i, pair_j, pair_valid,
        xyz_ds, n_ds, ok_ds, K_ds, cfg.ba, N)

    # 5. one packed readback
    return fc._pack_core_result(res), poses_out, info


def assemble_host_edges(matches: dict, pair_keys, local_idx: dict, cap: int,
                        per_pair_cap: int = 256):
    """Host edge arrays for pairs matched on earlier frames (store.matches),
    as Bundler.optimize assembles them: up to ``per_pair_cap`` inlier
    correspondences per pair, camera-frame points.  Like the JAX function,
    it stops (``break``) at the first pair that adds no edge: a pair with
    no inliers, or any pair once the cap is full.  The split path's loop
    goes on with ``continue`` instead.

    Returns (ii, jj, pi, pj, valid) numpy arrays of length ``cap``."""
    ii = np.zeros(cap, np.int32)
    jj = np.zeros(cap, np.int32)
    pi = np.zeros((cap, 3), np.float32)
    pj = np.zeros((cap, 3), np.float32)
    valid = np.zeros(cap, bool)
    e = 0
    for key in pair_keys:
        m = matches.get(key)
        if m is None:
            continue
        sel = np.nonzero(m["inlier"])[0][:per_pair_cap]
        k = min(len(sel), cap - e)
        if k <= 0:
            break
        sel = sel[:k]
        ii[e:e + k] = local_idx[key[0]]
        jj[e:e + k] = local_idx[key[1]]
        pi[e:e + k] = m["pA"][sel]
        pj[e:e + k] = m["pB"][sel]
        valid[e:e + k] = True
        e += k
    return ii, jj, pi, pj, valid
