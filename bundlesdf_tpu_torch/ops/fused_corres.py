"""One-call correspondence pipeline over the device-resident frame pool (port
of ``bundlesdf_tpu/ops/fused_corres.py``).

Frames' gray/depth/normal maps live in the device pool
(``tracking/device_pool.py``, uploaded once per frame), and the whole
per-call pipeline

    warp crops (homography bilinear sampling)          [CUDAImageUtil-class]
  -> Harris + ZNCC match              (models/matcher.py)
  -> unwarp matches through the inverse homographies
  -> merge host-provided track-propagation candidates
  -> 3D gate (depth validity, camera-space points)     [rawMatchesToCorres]
  -> model-frame transform + multi-pair RANSAC         [ransacMultiPairGPU]

runs on the device from one packed upload to one packed readback.  Every
index into an image or the pool is clipped first, as the JAX code does
(JAX clamps an out-of-range gather; torch would raise).

Output packing (single (P, M+3, 8) float32 readback):
  rows 0..M-1: [uA, vA, uB, vB, conf, match_valid, gate_valid, inlier]
               (uv in FULL-RES pixels, unrounded)
  row  M    : refit pose rows 0,1 (8 floats)
  row  M+1  : refit pose rows 2,3
  row  M+2  : [n_inliers, ok, n_matcher_valid, 0...]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import matcher as matcher_mod
from . import ransac as ransac_ops


class FusedCorresCfg(NamedTuple):
    out_size: int = 400
    n_extra: int = 128  # track-propagation candidate capacity per pair
    matcher: matcher_mod.CornerMatcherCfg = matcher_mod.CornerMatcherCfg()
    ransac: ransac_ops.RansacParams = ransac_ops.RansacParams()


def _warp_crop(img: torch.Tensor, tf_inv: torch.Tensor, out_size: int) -> torch.Tensor:
    """Homography-warp crops: out[..., v, u] = img(tf_inv @ [u, v, 1]) with
    bilinear sampling, zero outside (cv2.warpPerspective convention,
    reference processImagePair FeatureManager.cpp:126-257).
    img (..., H, W), tf_inv (..., 3, 3) -> (..., S, S)."""
    H, W = img.shape[-2:]
    S = out_size
    batch = img.shape[:-2]
    ar = torch.arange(S, dtype=torch.float32, device=img.device)
    v = ar[:, None].expand(S, S)
    u = ar[None, :].expand(S, S)

    def coef(i, j):
        return tf_inv[..., i, j][..., None, None]

    x = coef(0, 0) * u + coef(0, 1) * v + coef(0, 2)
    y = coef(1, 0) * u + coef(1, 1) * v + coef(1, 2)
    w = coef(2, 0) * u + coef(2, 1) * v + coef(2, 2)
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    x = x / w
    y = y / w
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    flat = img.reshape(batch + (H * W,))

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).to(torch.int64)
        vals = torch.gather(flat, -1, idx.reshape(batch + (S * S,)))
        return torch.where(inb, vals.reshape(batch + (S, S)), 0.0)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def _apply_h(tf: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) homography applied to (..., K, 2) pixel coords."""
    def c(i, j):
        return tf[..., i, j][..., None]

    x = c(0, 0) * uv[..., 0] + c(0, 1) * uv[..., 1] + c(0, 2)
    y = c(1, 0) * uv[..., 0] + c(1, 1) * uv[..., 1] + c(1, 2)
    w = torch.clamp(c(2, 0) * uv[..., 0] + c(2, 1) * uv[..., 1] + c(2, 2), min=1e-12)
    return torch.stack([x / w, y / w], dim=-1)


def _gather_pixels(pool: torch.Tensor, slot: torch.Tensor, uvc: torch.Tensor):
    """pool (S, H, W[, C]) read at slot (P,) and clipped integer pixels
    uvc (P, M, 2) [u, v] -> (P, M[, C])."""
    S, H, W = pool.shape[:3]
    flat = pool.reshape((S * H * W,) + pool.shape[3:])
    return flat[slot[:, None] * (H * W) + (uvc[..., 1] * W + uvc[..., 0]).to(torch.int64)]


def _fused_core(gray_pool, depth_pool, normal_pool, K, slotA, slotB, tfA_inv,
                tfB_inv, poseA, poseB, pair_valid, extra_uv, extra_n, max_trans,
                max_rot_deg, draws, cfg: FusedCorresCfg = FusedCorresCfg()):
    """The fused pipeline for P pairs.  Pools (S, H, W[, 3]) float32; slots
    (P,) int64; tf*_inv (P, 3, 3) crop -> full-res; poses (P, 4, 4)
    cam -> model; pair_valid (P,) bool; extra_uv (P, E, 4) and extra_n (P,)
    track-propagation candidates; max_trans, max_rot_deg (P,) RANSAC caps;
    draws (P, T, 3) RANSAC uniforms.  Returns a dict of device tensors."""
    P = slotA.shape[0]
    M = cfg.matcher.max_matches
    E = cfg.n_extra
    dev = gray_pool.device

    # 1. warp crops on the device
    cropsA = _warp_crop(gray_pool[slotA], tfA_inv, cfg.out_size)
    cropsB = _warp_crop(gray_pool[slotB], tfB_inv, cfg.out_size)

    # 2. match
    res = matcher_mod.match_pairs_batched(cropsA, cropsB, cfg.matcher)
    corres = res["corres"]  # (P, M, 5) crop-frame, compacted valid-first
    mvalid = res["valid"]   # (P, M)

    # 3. unwarp to full-res pixels
    uvA = _apply_h(tfA_inv, corres[..., 0:2])
    uvB = _apply_h(tfB_inv, corres[..., 2:4])
    conf = corres[..., 4]

    # 4. merge the track-propagation candidates after the matcher's valid rows
    n_valid = mvalid.sum(dim=-1).to(torch.int32)  # (P,)
    row = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    ei = row - n_valid[:, None]
    use_extra = (ei >= 0) & (ei < torch.clamp(extra_n, max=E)[:, None])
    eic = ei.clamp(0, E - 1).to(torch.int64)[..., None].expand(P, M, 2)
    exA = torch.gather(extra_uv[..., 0:2], 1, eic)
    exB = torch.gather(extra_uv[..., 2:4], 1, eic)
    uvA = torch.where(use_extra[..., None], exA, uvA)
    uvB = torch.where(use_extra[..., None], exB, uvB)
    conf = torch.where(use_extra, 0.5, conf)
    row_valid = mvalid | use_extra

    # 5. 3D gate (rawMatchesToCorres parity: round half to even, bounds,
    #    z > 0.1)
    H, W = gray_pool.shape[1:3]
    uvAi = torch.round(uvA).to(torch.int32)
    uvBi = torch.round(uvB).to(torch.int32)

    def in_bounds(uv):
        return ((uv[..., 0] >= 0) & (uv[..., 0] < W)
                & (uv[..., 1] >= 0) & (uv[..., 1] < H))

    def clip(uv):
        return torch.stack([uv[..., 0].clamp(0, W - 1), uv[..., 1].clamp(0, H - 1)], -1)

    inb = in_bounds(uvAi) & in_bounds(uvBi)
    uvAc = clip(uvAi)
    uvBc = clip(uvBi)
    zA = _gather_pixels(depth_pool, slotA, uvAc)
    zB = _gather_pixels(depth_pool, slotB, uvBc)
    nrmA = _gather_pixels(normal_pool, slotA, uvAc)
    nrmB = _gather_pixels(normal_pool, slotB, uvBc)
    gate_valid = row_valid & inb & (zA > 0.1) & (zB > 0.1) & pair_valid[:, None]

    # camera-space points from depth (the host maps' xyz = depth_to_xyz)
    def xyz_of(uvc, z):
        x = (uvc[..., 0].to(torch.float32) - K[0, 2]) / K[0, 0] * z
        y = (uvc[..., 1].to(torch.float32) - K[1, 2]) / K[1, 1] * z
        return torch.stack([x, y, z], dim=-1)

    pA = xyz_of(uvAc, zA)  # (P, M, 3)
    pB = xyz_of(uvBc, zB)

    # 6. model frame + RANSAC
    RA = poseA[:, :3, :3]
    RB = poseB[:, :3, :3]
    ptsA = torch.einsum("pij,pmj->pmi", RA, pA) + poseA[:, None, :3, 3]
    ptsB = torch.einsum("pij,pmj->pmi", RB, pB) + poseB[:, None, :3, 3]
    nA_m = torch.einsum("pij,pmj->pmi", RA, nrmA)
    nB_m = torch.einsum("pij,pmj->pmi", RB, nrmB)
    rres = ransac_ops.ransac_multi_pair(draws, ptsA, ptsB, nA_m, nB_m, gate_valid,
                                        cfg.ransac, max_trans, max_rot_deg)
    return {
        "uvA": uvA, "uvB": uvB, "conf": conf,
        "row_valid": row_valid, "gate_valid": gate_valid,
        "inlier": rres["inliers"],
        "pA": pA, "pB": pB,  # camera-frame 3D points
        "pose": rres["pose"], "n_inliers": rres["n_inliers"],
        "ok": rres["ok"], "n_matcher_valid": n_valid,
    }


def _pack_core_result(res) -> torch.Tensor:
    """Pack the ``_fused_core`` dict into the single (P, M+3, 8) readback
    buffer (layout in the module docstring)."""
    P = res["uvA"].shape[0]
    f32 = torch.float32
    per_match = torch.stack([
        res["uvA"][..., 0], res["uvA"][..., 1],
        res["uvB"][..., 0], res["uvB"][..., 1],
        res["conf"],
        res["row_valid"].to(f32), res["gate_valid"].to(f32), res["inlier"].to(f32),
    ], dim=-1)  # (P, M, 8)
    meta = torch.cat([
        res["pose"].reshape(P, 16),
        res["n_inliers"].to(f32)[:, None],
        res["ok"].to(f32)[:, None],
        res["n_matcher_valid"].to(f32)[:, None],
        torch.zeros((P, 5), dtype=f32, device=per_match.device),
    ], dim=-1).reshape(P, 3, 8)
    return torch.cat([per_match, meta], dim=1)


# Per-pair packed-call layout: 6 scalars + two 3x3 inverse homographies +
# two 4x4 poses = 56 floats, then the (E, 4) extra-candidate block: one
# host -> device buffer per call.
_HEAD = 56


def pack_call(pairs_data, n_extra: int) -> np.ndarray:
    """Assemble the (P, 56 + 4E) float32 call buffer on the host.

    pairs_data: list of dicts with keys slotA, slotB, valid, tfA_inv,
    tfB_inv, poseA, poseB, extra_uv (n, 4), max_trans, max_rot_deg.
    """
    P = len(pairs_data)
    E = n_extra
    buf = np.zeros((P, _HEAD + 4 * E), np.float32)
    for i, d in enumerate(pairs_data):
        ex = np.asarray(d.get("extra_uv", np.zeros((0, 4))), np.float32)[:E]
        buf[i, 0] = d["slotA"]
        buf[i, 1] = d["slotB"]
        buf[i, 2] = 1.0 if d.get("valid", True) else 0.0
        buf[i, 3] = len(ex)
        buf[i, 4] = d["max_trans"]
        buf[i, 5] = d["max_rot_deg"]
        buf[i, 6:15] = np.asarray(d["tfA_inv"], np.float32).reshape(-1)
        buf[i, 15:24] = np.asarray(d["tfB_inv"], np.float32).reshape(-1)
        buf[i, 24:40] = np.asarray(d["poseA"], np.float32).reshape(-1)
        buf[i, 40:56] = np.asarray(d["poseB"], np.float32).reshape(-1)
        if len(ex):
            buf[i, _HEAD:_HEAD + 4 * len(ex)] = ex.reshape(-1)
    return buf


def fused_find_corres_packed(gray_pool, depth_pool, normal_pool, K,
                             packed: torch.Tensor, draws: torch.Tensor,
                             cfg: FusedCorresCfg = FusedCorresCfg()) -> torch.Tensor:
    """The standalone corres program: ``packed`` (P, 56 + 4E) from
    ``pack_call`` on the pool's device, ``draws`` (P, T, 3)."""
    return _pack_core_result(_unpack_and_run(
        gray_pool, depth_pool, normal_pool, K, packed, draws, cfg))


def _unpack_and_run(gray_pool, depth_pool, normal_pool, K, packed, draws, cfg):
    """Decode the ``pack_call`` buffer and run the fused core (shared by the
    standalone corres program and the fused match + BA program)."""
    P = packed.shape[0]
    E = cfg.n_extra
    return _fused_core(
        gray_pool, depth_pool, normal_pool, K,
        slotA=packed[:, 0].to(torch.int64),
        slotB=packed[:, 1].to(torch.int64),
        tfA_inv=packed[:, 6:15].reshape(P, 3, 3),
        tfB_inv=packed[:, 15:24].reshape(P, 3, 3),
        poseA=packed[:, 24:40].reshape(P, 4, 4),
        poseB=packed[:, 40:56].reshape(P, 4, 4),
        pair_valid=packed[:, 2] > 0.5,
        extra_uv=packed[:, _HEAD:].reshape(P, E, 4),
        extra_n=packed[:, 3].to(torch.int32),
        max_trans=packed[:, 4],
        max_rot_deg=packed[:, 5],
        draws=draws,
        cfg=cfg,
    )


def unpack_result(buf, max_matches: int):
    """Split the packed (P, M+3, 8) readback into a dict of numpy arrays
    (one device -> host copy)."""
    if isinstance(buf, torch.Tensor):
        buf = buf.cpu().numpy()
    M = max_matches
    pm = buf[:, :M, :]
    meta = buf[:, M:, :].reshape(buf.shape[0], 24)
    return {
        "uvA": pm[..., 0:2],
        "uvB": pm[..., 2:4],
        "conf": pm[..., 4],
        "row_valid": pm[..., 5] > 0.5,
        "gate_valid": pm[..., 6] > 0.5,
        "inlier": pm[..., 7] > 0.5,
        "pose": meta[:, :16].reshape(-1, 4, 4),
        "n_inliers": meta[:, 16].astype(np.int32),
        "ok": meta[:, 17] > 0.5,
        "n_matcher_valid": meta[:, 18].astype(np.int32),
    }
