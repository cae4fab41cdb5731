"""Pair preprocessing + correspondence management (port of
``bundlesdf_tpu/tracking/corres.py``).

Mirrors the reference GluNet feature pipeline:
  * ``pair_homographies``  — the processImagePair homography math
    (FeatureManager.cpp:126-257): rotate B into A's in-plane camera
    orientation, crop both ROIs (+10 px), letterbox-scale to a square;
  * ``process_image_pair`` — those homographies and the two warped crops
    (``io/imgproc.py::warp_perspective``, OpenCV's arithmetic in torch);
  * ``make_matcher``       — the configured engine: None for the built-in
    corner matcher, ``models/loftr.py::LoftrMatcher`` for ``loftr``;
  * ``CorresStore``        — the `_raw_matches` / `_matches` tables
    (FeatureManager.h:164-170) as fixed-capacity numpy arrays per pair;
  * ``find_corres``        — the per-pair loop of bundlesdf.py:352-387.  With
    the corner matcher and ``feature_corres.fused`` (default on), fresh pairs
    go to ONE device program over the resident frame pool
    (``ops/fused_corres.py``: warp, match, unwarp, 3D gate, multi-pair
    RANSAC).  Everything else takes the host-warp path
    (``_find_corres_legacy``): warp each pair, run the matcher on the batch,
    map matches back through the inverse homographies, gate them in 3D on
    the host and run one multi-pair RANSAC.  A pair whose raw table survived
    a match invalidation (NOF pose feedback, ``rematch_after_nerf``) is
    re-gated and re-RANSACed from that table, without the matcher
    (rawMatchesToCorres, FeatureManager.cpp:2720-2769);
  * ``procrustes_offset``  — FeatureManager.cpp:1050-1129
    procrustesByCorrespondence;
  * ``FeatureTracks``      — the MapPoint table.

The ``sift`` engine (host OpenCV) and the ``remote`` engine (a ZMQ server)
are not ported: ``make_matcher`` raises for them.  No OpenCV here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import Cfg
from ..io import imgproc
from ..models import matcher as matcher_mod
from ..ops import fused_corres as fused_ops
from ..ops import ransac as ransac_ops
from ..utils import profiler
from ..utils.device import resolve_device
from ..utils.profiler import span
from .device_pool import DeviceFramePool
from .frame import Frame

# Sizes the JAX package reads from optional config keys that no shipped
# config sets: device frame-pool slots, track-propagation candidates per
# pair, and the default of the pair batch (``feature_corres.pair_batch``).
DEVICE_POOL_SLOTS = 64
N_EXTRA_PROP = 128
PAIR_BATCH = 16


def _rotate_image_transform(H: int, W: int, angle_rad: float) -> np.ndarray:
    """3x3 homography rotating an image by ``angle_rad`` about its center
    (reference Utils::getRotateImageTransform)."""
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)
    T1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], dtype=np.float64)
    T2 = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], dtype=np.float64)
    return T2 @ R @ T1


def in_plane_rotation(fa: Frame, fb: Frame) -> float:
    """Signed in-plane (camera-z) component of the relative rotation that
    maps B's camera orientation onto A's (FeatureManager.cpp:140-147)."""
    from scipy.spatial.transform import Rotation

    RA = fa.pose_in_model[:3, :3].T  # model -> camA
    RB = fb.pose_in_model[:3, :3].T
    R_BA = RA @ np.linalg.inv(RB)
    return float(Rotation.from_matrix(R_BA).as_rotvec()[2])


def pair_homographies(fa: Frame, fb: Frame, out_size: int):
    """The processImagePair homography math without the warp: the 3x3
    full-res -> crop transforms (tfA, tfB) that the device warps with."""
    H, W = fb.H, fb.W
    roiA, roiB = fa.roi, fb.roi
    margin = 10

    tfA = np.eye(3)
    tfB = _rotate_image_transform(H, W, in_plane_rotation(fa, fb))

    corners = np.array(
        [[roiB[0], roiB[2], 1], [roiB[0], roiB[3], 1],
         [roiB[1], roiB[2], 1], [roiB[1], roiB[3], 1]], dtype=np.float64
    )
    tc = (tfB @ corners.T).T
    umin, umax = tc[:, 0].min(), tc[:, 0].max()
    vmin, vmax = tc[:, 1].min(), tc[:, 1].max()

    tA = np.eye(3); tA[0, 2] = -roiA[0] + margin; tA[1, 2] = -roiA[2] + margin
    tfA = tA @ tfA
    tB = np.eye(3); tB[0, 2] = -umin + margin; tB[1, 2] = -vmin + margin
    tfB = tB @ tfB

    WA = roiA[1] - roiA[0] + margin * 2
    HA = roiA[3] - roiA[2] + margin * 2
    WB = umax - umin + margin * 2
    HB = vmax - vmin + margin * 2
    max_dim = max(WA, HA, WB, HB)
    sA = np.eye(3); sA[:2, :2] *= max_dim / max(WA, HA)
    tfA = sA @ tfA
    sB = np.eye(3); sB[:2, :2] *= max_dim / max(WB, HB)
    tfB = sB @ tfB
    sO = np.eye(3); sO[:2, :2] *= out_size / max_dim
    return sO @ tfA, sO @ tfB


def process_image_pair(fa: Frame, fb: Frame, out_size: int, device=None):
    """(warped_gray_A, warped_gray_B, tfA, tfB): the pair's two crops as
    (S, S) f32 tensors on ``device`` (None = CUDA) and the homographies."""
    dev = resolve_device(device)
    tfA, tfB = pair_homographies(fa, fb, out_size)
    out = [imgproc.warp_perspective(
        torch.from_numpy(np.asarray(f.gray, np.float32)).to(dev), tf, (out_size, out_size))
        for f, tf in ((fa, tfA), (fb, tfB))]
    return out[0], out[1], tfA, tfB


def _apply_homography(tf: np.ndarray, uv: np.ndarray) -> np.ndarray:
    h = np.concatenate([uv, np.ones((len(uv), 1))], axis=-1) @ tf.T
    return h[:, :2] / np.maximum(h[:, 2:3], 1e-12)


def make_matcher(cfg: Cfg, device=None):
    """The configured matching engine (reference FeatureManager class tree:
    SiftManager base / GluNet = LoFTR / Lfnet = remote server,
    FeatureManager.h:98-213): None for the built-in corner matcher, or an
    object with the ``predict(grayAs, grayBs) -> ((B, K, 5), (B, K) valid)``
    contract.  ``loftr`` builds ``LoftrMatcher`` on ``device`` (None = CUDA)
    from ``feature_corres.loftr_ckpt`` when it is set, else with seeded
    random weights."""
    fc = cfg["feature_corres"]
    name = str(fc["matcher"])
    if name == "corner":
        return None
    if name == "loftr":
        from ..models import loftr

        lcfg = loftr.LoftrCfg(max_matches=int(fc["max_matches_per_pair"]))
        ckpt = str(fc.get("loftr_ckpt", "") or "")
        if ckpt:
            return loftr.load_checkpoint(ckpt, lcfg, device=device)
        return loftr.LoftrMatcher(lcfg, device=device)
    if name == "sift":
        raise NotImplementedError(
            "feature_corres.matcher 'sift' is not ported: the JAX engine runs "
            "OpenCV's SIFT on the host, and the card's machine has no OpenCV "
            "(ROADMAP queue 1, item 5: the SIFT engine)")
    if name == "remote":
        raise NotImplementedError(
            "feature_corres.matcher 'remote' is not ported: it talks to a ZMQ "
            "matcher server, and the card's machine has no pyzmq (ROADMAP queue "
            "1, item 6: the remote engine)")
    raise ValueError(f"unknown feature_corres.matcher: {name!r}")


class CorresStore:
    """Per-pair correspondence tables (the reference `_matches` /
    `_raw_matches` maps), keyed by (idA, idB) with idA the newer frame, the
    configured matching engine, and the device frame pool the fused
    programs read (created at the first fused match, on ``device``)."""

    def __init__(self, cfg: Cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_matches = int(cfg["feature_corres"]["max_matches_per_pair"])
        self.raw: dict[tuple, np.ndarray] = {}
        self.matches: dict[tuple, dict] = {}
        self.tracks = FeatureTracks()
        # configured matching engine (None = built-in corner matcher)
        self.matcher = make_matcher(cfg, self.device)
        self.device_pool: DeviceFramePool | None = None
        self._fused_enabled = bool(cfg["feature_corres"].get("fused", True))

    @property
    def use_fused(self):
        # dynamic: an engine can be swapped in after construction; the
        # fused programs cover the built-in matcher only
        return self._fused_enabled and self.matcher is None

    def _ensure_pool(self, frame):
        if self.device_pool is None:
            self.device_pool = DeviceFramePool(
                frame.H, frame.W, capacity=DEVICE_POOL_SLOTS, device=self.device)
            self.device_pool.K = torch.as_tensor(frame.K, device=self.device)
        return self.device_pool

    def forget_frame(self, fid: int):
        """Erase all matches touching a frame (reference forgetFrame,
        Bundler.cpp:62-73)."""
        for table in (self.raw, self.matches):
            for k in [k for k in table if fid in k]:
                del table[k]
        self.tracks.forget_frame(fid)
        if self.device_pool is not None:
            self.device_pool.release(fid)

    def invalidate_matches(self, fid: int):
        """Erase only the gated matches touching a frame, keeping the raw
        table (the reference's NeRF-feedback invalidation,
        bundlesdf.py:607-617): the next find_corres re-gates the raw
        matches under the updated poses without re-running the matcher."""
        for k in [k for k in self.matches if fid in k]:
            del self.matches[k]

    def n_inliers(self, key: tuple) -> int:
        m = self.matches.get(key)
        return 0 if m is None else int(m["inlier"].sum())


def gate_matches_3d(fa: Frame, fb: Frame, uvA: np.ndarray, uvB: np.ndarray,
                    max_matches: int) -> dict:
    """Pixel-bounds + depth-validity gating; camera-frame 3D
    correspondences (reference rawMatchesToCorres / makeCorrespondence)."""
    uvA = np.round(uvA).astype(np.int64)
    uvB = np.round(uvB).astype(np.int64)
    n = min(len(uvA), max_matches)
    uvA, uvB = uvA[:n], uvB[:n]
    out = {
        "uvA": np.zeros((max_matches, 2), np.int32),
        "uvB": np.zeros((max_matches, 2), np.int32),
        "pA": np.zeros((max_matches, 3), np.float32),
        "pB": np.zeros((max_matches, 3), np.float32),
        "nA": np.zeros((max_matches, 3), np.float32),
        "nB": np.zeros((max_matches, 3), np.float32),
        "valid": np.zeros(max_matches, bool),
        "inlier": np.zeros(max_matches, bool),
    }
    if n == 0:
        return out
    inb = (
        (uvA[:, 0] >= 0) & (uvA[:, 0] < fa.W) & (uvA[:, 1] >= 0) & (uvA[:, 1] < fa.H)
        & (uvB[:, 0] >= 0) & (uvB[:, 0] < fb.W) & (uvB[:, 1] >= 0) & (uvB[:, 1] < fb.H)
    )
    uvA_c = np.clip(uvA, 0, [fa.W - 1, fa.H - 1])
    uvB_c = np.clip(uvB, 0, [fb.W - 1, fb.H - 1])
    zA = fa.depth[uvA_c[:, 1], uvA_c[:, 0]]
    zB = fb.depth[uvB_c[:, 1], uvB_c[:, 0]]
    out["uvA"][:n] = uvA_c
    out["uvB"][:n] = uvB_c
    out["pA"][:n] = fa.xyz[uvA_c[:, 1], uvA_c[:, 0]]
    out["pB"][:n] = fb.xyz[uvB_c[:, 1], uvB_c[:, 0]]
    out["nA"][:n] = fa.normals[uvA_c[:, 1], uvA_c[:, 0]]
    out["nB"][:n] = fb.normals[uvB_c[:, 1], uvB_c[:, 0]]
    out["valid"][:n] = inb & (zA > 0.1) & (zB > 0.1)
    return out


def find_corres(store: CorresStore, pairs: list[tuple[Frame, Frame]], cfg: Cfg,
                matcher_cfg: matcher_mod.CornerMatcherCfg | None = None,
                key: int | None = None,
                ransac_draws: ransac_ops.DrawSource | None = None,
                matcher_fn=None):
    """Correspondences for a list of (new, old) frame pairs: fills
    store.matches[(idA, idB)] with gated + RANSAC-filtered matches
    (BundleSdf.find_corres, bundlesdf.py:352-387).

    key: the RANSAC seed (the frame id; the JAX package's
    ``jax.random.PRNGKey(key)``), 0 when None.  ransac_draws: optional
    draw source ``(seed, shape) -> uniforms`` (``ops/ransac.draw_uniforms``).
    matcher_fn: optional engine ``(imgsA, imgsB) -> (corres (B, K, 5),
    valid (B, K))`` taking the warped crops as (B, S, S) f32 tensors on the
    store's device and returning numpy arrays or tensors; it sends every
    pair through the host-warp path.
    """
    if not pairs:
        return
    if matcher_cfg is None:
        matcher_cfg = matcher_mod.CornerMatcherCfg(max_matches=store.max_matches)
    key = 0 if key is None else key
    # Raw-match reuse (rawMatchesToCorres, FeatureManager.cpp:2720-2769):
    # pairs whose raw table survived a match invalidation re-derive their
    # correspondences from it under the updated poses; the matcher does not
    # run for them.
    fresh_idx = [i for i, (fa, fb) in enumerate(pairs) if (fa.id, fb.id) not in store.raw]
    if store.use_fused and matcher_fn is None:
        fresh = set(fresh_idx)
        fresh_pairs = [pairs[i] for i in fresh_idx]
        reused = [p for i, p in enumerate(pairs) if i not in fresh]
        if fresh_pairs:
            _find_corres_fused(store, fresh_pairs, cfg, matcher_cfg, key, ransac_draws)
        if reused:
            _find_corres_legacy(store, reused, cfg, matcher_cfg, key, None, [],
                                ransac_draws)
        return
    _find_corres_legacy(store, pairs, cfg, matcher_cfg, key, matcher_fn, fresh_idx,
                        ransac_draws)


def _bucket(n: int, fixed: int) -> int:
    """Padded batch of n pairs: 1, ``pair_batch``, or the next power of two
    (one matcher and RANSAC shape per bucket, as the JAX package's compiled
    programs)."""
    if n == 1:
        return 1
    if n <= fixed:
        return fixed
    return 1 << max(0, (n - 1).bit_length())


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _find_corres_legacy(store, pairs, cfg, matcher_cfg, key, matcher_fn, fresh_idx,
                        ransac_draws=None):
    """The host-warp path (JAX ``_find_corres_legacy``): warp the fresh
    pairs on the store's device, match them in one batch, unwarp, propagate
    tracks into the raw table; re-gate reused pairs from their raw table;
    gate in 3D on the host; one multi-pair RANSAC in model frame."""
    fc = cfg["feature_corres"]
    out_size = int(fc["resize"])
    fixed = int(fc.get("pair_batch", PAIR_BATCH))

    imgsA, imgsB = [], []
    tfsA = [None] * len(pairs)
    tfsB = [None] * len(pairs)
    with span("corres/warp"):
        for i in fresh_idx:
            fa, fb = pairs[i]
            a, b, ta, tb = process_image_pair(fa, fb, out_size, store.device)
            imgsA.append(a); imgsB.append(b); tfsA[i] = ta; tfsB[i] = tb

    corres_b = valid_b = None
    if fresh_idx:
        # Buckets {1, pair_batch, next power of two}: the per-frame pair
        # count varies, and the bucket fixes the matcher's batch (padded
        # slots repeat pair 0 and are dropped).  Host engines
        # (``compiled = False``) run exactly the fresh pairs.
        n_fresh = len(fresh_idx)
        engine = store.matcher if matcher_fn is None else None
        host_engine = (matcher_fn is None and engine is not None
                       and not getattr(engine, "compiled", True))
        n_pad = n_fresh if host_engine else _bucket(n_fresh, fixed)
        imgsA += [imgsA[0]] * (n_pad - n_fresh)
        imgsB += [imgsB[0]] * (n_pad - n_fresh)
        with span("corres/match"):
            profiler.count("launch/corres")
            profiler.count("readback/corres")
            if matcher_fn is None and store.matcher is not None:
                matcher_fn = store.matcher.predict
            if matcher_fn is None:
                res = matcher_mod.match_pairs_batched(torch.stack(imgsA), torch.stack(imgsB),
                                                      matcher_cfg)
                corres_b, valid_b = res["corres"], res["valid"]
            else:
                corres_b, valid_b = matcher_fn(torch.stack(imgsA), torch.stack(imgsB))
            corres_b, valid_b = _host(corres_b)[:n_fresh], _host(valid_b)[:n_fresh]

    gated = []
    fresh_pos = {pi: bi for bi, pi in enumerate(fresh_idx)}
    for i, (fa, fb) in enumerate(pairs):
        if i in fresh_pos:
            bi = fresh_pos[i]
            cc = corres_b[bi][valid_b[bi]]
            uvA = _apply_homography(np.linalg.inv(tfsA[i]), cc[:, 0:2])
            uvB = _apply_homography(np.linalg.inv(tfsB[i]), cc[:, 2:4])
            # track propagation (MapPoint propagation): pixels linked to
            # both frames through shared tracks join the RANSAC candidates
            pA, pB = store.tracks.propagate(fa.id, fb.id)
            if len(pA):
                uvA = np.concatenate([uvA, pA])
                uvB = np.concatenate([uvB, pB])
            store.raw[(fa.id, fb.id)] = np.concatenate(
                [uvA, uvB], axis=-1).astype(np.float32)[: store.max_matches]
        else:
            raw = store.raw[(fa.id, fb.id)]
            uvA, uvB = raw[:, 0:2].astype(np.float64), raw[:, 2:4].astype(np.float64)
        gated.append(gate_matches_3d(fa, fb, uvA, uvB, store.max_matches))

    # Model-frame points for RANSAC (the reference runRansacMultiPairGPU host
    # glue), padded over all pairs to the same buckets (padded slots are
    # all-invalid); the bucket fixes the draws' shape.
    rcfg = cfg["ransac"]
    params = ransac_ops.RansacParams(
        n_trials=int(rcfg["max_iter"]),
        inlier_dist=float(rcfg["inlier_dist"]),
        inlier_normal_angle_deg=float(rcfg["inlier_normal_angle"]),
        min_match_after_ransac=int(rcfg["min_match_after_ransac"]),
    )
    P, M = _bucket(len(pairs), fixed), store.max_matches
    ptsA = np.zeros((P, M, 3), np.float32)
    ptsB = np.zeros((P, M, 3), np.float32)
    nA = np.zeros((P, M, 3), np.float32)
    nB = np.zeros((P, M, 3), np.float32)
    valid = np.zeros((P, M), bool)
    max_trans = np.zeros(P, np.float32)
    max_rot = np.zeros(P, np.float32)
    for i, (fa, fb) in enumerate(pairs):
        g = gated[i]
        Ta, Tb = fa.pose_in_model, fb.pose_in_model
        ptsA[i] = g["pA"] @ Ta[:3, :3].T + Ta[:3, 3]
        ptsB[i] = g["pB"] @ Tb[:3, :3].T + Tb[:3, 3]
        nA[i] = g["nA"] @ Ta[:3, :3].T
        nB[i] = g["nB"] @ Tb[:3, :3].T
        valid[i] = g["valid"]
        neighbor = abs(fa.id - fb.id) == 1
        max_trans[i] = float(rcfg["max_trans_neighbor"] if neighbor
                             else rcfg["max_trans_no_neighbor"])
        max_rot[i] = float(rcfg["max_rot_deg_neighbor"] if neighbor
                           else rcfg["max_rot_no_neighbor"])

    def dev(a):
        return torch.from_numpy(a).to(store.device)

    draws = ransac_ops.draw_uniforms(key, (P, params.n_trials, 3), store.device,
                                     ransac_draws)
    with span("corres/ransac"):
        profiler.count("launch/ransac")
        profiler.count("readback/ransac")
        res = ransac_ops.ransac_multi_pair(draws, dev(ptsA), dev(ptsB), dev(nA), dev(nB),
                                           dev(valid), params, dev(max_trans), dev(max_rot))
        inliers = res["inliers"].cpu().numpy()
    for i, (fa, fb) in enumerate(pairs):
        g = gated[i]
        g["inlier"] = inliers[i] & g["valid"]
        store.matches[(fa.id, fb.id)] = g
        # merge inliers into the multi-frame feature tracks (map points)
        store.tracks.add_matches(fa.id, fb.id, g["uvA"], g["uvB"], g["inlier"])


def make_fused_cfg(store, cfg, matcher_cfg):
    """FusedCorresCfg from the tracker config (shared by the standalone
    fused corres path and the fused match + BA path)."""
    fc = cfg["feature_corres"]
    rcfg = cfg["ransac"]
    params = ransac_ops.RansacParams(
        n_trials=int(rcfg["max_iter"]),
        inlier_dist=float(rcfg["inlier_dist"]),
        inlier_normal_angle_deg=float(rcfg["inlier_normal_angle"]),
        min_match_after_ransac=int(rcfg["min_match_after_ransac"]),
    )
    return fused_ops.FusedCorresCfg(
        out_size=int(fc["resize"]), n_extra=N_EXTRA_PROP,
        matcher=matcher_cfg, ransac=params,
    )


def ensure_pool_frames(store, frames):
    """Upload any non-resident frames to the device pool; returns the pool
    and the slot map."""
    pool = store._ensure_pool(frames[0])
    with span("corres/pool_upload"):
        pool.ensure(frames)
        return pool, {f.id: pool.slot_of[f.id] for f in frames}


def build_pairs_data(store, pairs, cfg, slot_of):
    """Per-pair host metadata for the fused device paths: homographies,
    poses, RANSAC caps, track-propagation candidates."""
    fc = cfg["feature_corres"]
    rcfg = cfg["ransac"]
    out_size = int(fc["resize"])
    pairs_data = []
    with span("corres/warp"):
        for fa, fb in pairs:
            tfA, tfB = pair_homographies(fa, fb, out_size)
            pA_uv, pB_uv = store.tracks.propagate(fa.id, fb.id)
            extra = (np.concatenate([pA_uv, pB_uv], axis=-1)
                     if len(pA_uv) else np.zeros((0, 4)))
            neighbor = abs(fa.id - fb.id) == 1
            pairs_data.append({
                "slotA": slot_of[fa.id], "slotB": slot_of[fb.id],
                "valid": True,
                "tfA_inv": np.linalg.inv(tfA), "tfB_inv": np.linalg.inv(tfB),
                "poseA": fa.pose_in_model, "poseB": fb.pose_in_model,
                "extra_uv": extra,
                "max_trans": float(rcfg["max_trans_neighbor"] if neighbor
                                   else rcfg["max_trans_no_neighbor"]),
                "max_rot_deg": float(rcfg["max_rot_deg_neighbor"] if neighbor
                                     else rcfg["max_rot_no_neighbor"]),
            })
    return pairs_data


def commit_fused_results(store, pairs, res):
    """Write a fused program's unpacked match results into the host tables
    (store.raw / store.matches / feature tracks): the same bookkeeping for
    the standalone corres program and the fused match + BA program."""
    for i, (fa, fb) in enumerate(pairs):
        row_valid = res["row_valid"][i]
        uvA_f = res["uvA"][i]
        uvB_f = res["uvB"][i]
        nv = int(row_valid.sum())
        store.raw[(fa.id, fb.id)] = np.concatenate(
            [uvA_f[:nv], uvB_f[:nv]], axis=-1).astype(np.float32)
        # gated table: validity/inliers as the device decided them from its
        # quantized pool; points and normals from the host's own maps
        uvAc = np.clip(np.round(uvA_f).astype(np.int64), 0, [fa.W - 1, fa.H - 1])
        uvBc = np.clip(np.round(uvB_f).astype(np.int64), 0, [fb.W - 1, fb.H - 1])
        rv = row_valid[:, None]
        g = {
            "uvA": np.where(rv, uvAc, 0).astype(np.int32),
            "uvB": np.where(rv, uvBc, 0).astype(np.int32),
            "pA": np.where(rv, fa.xyz[uvAc[:, 1], uvAc[:, 0]], 0.0).astype(np.float32),
            "pB": np.where(rv, fb.xyz[uvBc[:, 1], uvBc[:, 0]], 0.0).astype(np.float32),
            "nA": np.where(rv, fa.normals[uvAc[:, 1], uvAc[:, 0]], 0.0).astype(np.float32),
            "nB": np.where(rv, fb.normals[uvBc[:, 1], uvBc[:, 0]], 0.0).astype(np.float32),
            "valid": res["gate_valid"][i],
            "inlier": res["inlier"][i] & res["gate_valid"][i],
        }
        store.matches[(fa.id, fb.id)] = g
        store.tracks.add_matches(fa.id, fb.id, g["uvA"], g["uvB"], g["inlier"])


def _find_corres_fused(store, pairs, cfg, matcher_cfg, key, ransac_draws=None):
    """The fused device program for fresh pairs (ops/fused_corres.py)."""
    M = store.max_matches
    all_frames, seen = [], set()
    for fa, fb in pairs:
        for f in (fa, fb):
            if f.id not in seen:
                seen.add(f.id)
                all_frames.append(f)
    pool, slot_of = ensure_pool_frames(store, all_frames)
    fcfg = make_fused_cfg(store, cfg, matcher_cfg)
    pairs_data = build_pairs_data(store, pairs, cfg, slot_of)

    # batch-size buckets {1, pair_batch/2, pair_batch, pow2}, as in the JAX
    # package, so the padded pair count (and with it the RANSAC draws'
    # shape) is the same in both
    n = len(pairs_data)
    fixed = int(cfg["feature_corres"].get("pair_batch", PAIR_BATCH))
    half = fixed // 2
    if n == 1:
        P = 1
    elif half >= 2 and n <= half:
        P = half
    elif n <= fixed:
        P = fixed
    else:
        P = 1 << max(0, (n - 1).bit_length())
    pad = dict(pairs_data[0])
    pad["valid"] = False
    pairs_data += [pad] * (P - n)

    packed = torch.from_numpy(fused_ops.pack_call(pairs_data, fcfg.n_extra)).to(store.device)
    draws = ransac_ops.draw_uniforms(key, (P, fcfg.ransac.n_trials, 3), store.device,
                                     ransac_draws)
    with span("corres/match"):
        profiler.count("launch/corres")
        profiler.count("readback/corres")
        buf = fused_ops.fused_find_corres_packed(
            pool.gray, pool.depth, pool.normals, pool.K, packed, draws, fcfg)
        res = fused_ops.unpack_result(buf, M)
    commit_fused_results(store, pairs, res)


def procrustes_offset(store: CorresStore, fa: Frame, fb: Frame) -> np.ndarray:
    """Pose increment from the inlier correspondences of (fa, fb):
    ``pose_a <- offset @ pose_a`` (reference procrustesByCorrespondence).
    Host SVD: <= 512 points."""
    m = store.matches.get((fa.id, fb.id))
    if m is None or m["inlier"].sum() < 3:
        return np.eye(4, dtype=np.float32)
    Ta, Tb = fa.pose_in_model, fb.pose_in_model
    src = m["pA"] @ Ta[:3, :3].T + Ta[:3, 3]
    dst = m["pB"] @ Tb[:3, :3].T + Tb[:3, 3]
    w = m["inlier"].astype(np.float64)
    wsum = w.sum()
    mu_s = (src * w[:, None]).sum(0) / wsum
    mu_d = (dst * w[:, None]).sum(0) / wsum
    S = ((dst - mu_d) * w[:, None]).T @ (src - mu_s)
    U, _, Vt = np.linalg.svd(S)
    d = np.sign(np.linalg.det(U @ Vt))
    R = U @ np.diag([1.0, 1.0, d]) @ Vt
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


# ----------------------------------------------------------- map points
class FeatureTracks:
    """Multi-frame feature tracks (the reference MapPoint table,
    FeatureManager.h:49-66): inlier correspondences merge into tracks by
    union-find over quantized (frame, u, v) keypoints.  Used for
    covisible-point counting in BA subset selection and for match
    propagation (two frames that both match a third share candidates)."""

    def __init__(self, quant: int = 2):
        self.quant = quant
        self._parent: dict[tuple, tuple] = {}
        self._frame_keys: dict[int, set] = {}

    def _key(self, fid: int, u: float, v: float) -> tuple:
        q = self.quant
        return (fid, int(round(u / q)), int(round(v / q)))

    def _find(self, k):
        p = self._parent.setdefault(k, k)
        while p != self._parent[p]:
            self._parent[p] = self._parent[self._parent[p]]
            p = self._parent[p]
        self._parent[k] = p
        return p

    def _union(self, a, b):
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[rb] = ra

    def add_matches(self, fa_id: int, fb_id: int, uvA: np.ndarray,
                    uvB: np.ndarray, inlier: np.ndarray):
        for i in np.nonzero(inlier)[0]:
            ka = self._key(fa_id, uvA[i, 0], uvA[i, 1])
            kb = self._key(fb_id, uvB[i, 0], uvB[i, 1])
            self._union(ka, kb)
            self._frame_keys.setdefault(fa_id, set()).add(ka)
            self._frame_keys.setdefault(fb_id, set()).add(kb)

    def forget_frame(self, fid: int):
        self._frame_keys.pop(fid, None)
        # dead frames' union-find entries are kept lazily, but compacted
        # when the table exceeds 2x the live key count
        n_live = sum(len(ks) for ks in self._frame_keys.values())
        if len(self._parent) > max(1024, 2 * n_live):
            self.compact()

    def compact(self):
        """Rebuild the union-find over the live keys only, keeping their
        connectivity (one live representative per component)."""
        live = set()
        for ks in self._frame_keys.values():
            live |= ks
        root_rep: dict[tuple, tuple] = {}
        new_parent: dict[tuple, tuple] = {}
        for k in live:
            r = self._find(k)
            rep = root_rep.setdefault(r, k)
            new_parent[k] = rep
        for rep in root_rep.values():
            new_parent[rep] = rep
        self._parent = new_parent

    def n_covisible(self, fa_id: int, fb_id: int) -> int:
        """Number of shared tracks between two frames."""
        ka = self._frame_keys.get(fa_id, ())
        kb = self._frame_keys.get(fb_id, ())
        if not ka or not kb:
            return 0
        roots_b = {self._find(k) for k in kb}
        return sum(1 for k in ka if self._find(k) in roots_b)

    def propagate(self, fa_id: int, fb_id: int):
        """Candidate (uvA, uvB) pixel pairs linked through shared tracks."""
        ka = self._frame_keys.get(fa_id, ())
        kb = self._frame_keys.get(fb_id, ())
        if not ka or not kb:
            return np.zeros((0, 2)), np.zeros((0, 2))
        by_root: dict[tuple, tuple] = {}
        for k in kb:
            by_root.setdefault(self._find(k), k)
        uvA, uvB = [], []
        q = self.quant
        for k in ka:
            other = by_root.get(self._find(k))
            if other is not None:
                uvA.append((k[1] * q, k[2] * q))
                uvB.append((other[1] * q, other[2] * q))
        return np.asarray(uvA, np.float64), np.asarray(uvB, np.float64)
