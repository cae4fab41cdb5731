"""Keyframe memory pool + pose-graph bookkeeping: the reference Bundler
(port of ``bundlesdf_tpu/tracking/pool.py``).

Re-design of BundleTrack/src/Bundler.{h,cpp}: the sliding non-keyframe
window, the dynamic keyframe memory pool, keyframe admission
(checkAndAddKeyframe Bundler.cpp:263-323), BA subset selection
(selectKeyFramesForBA :430-609, every strategy of the JAX module),
covisibility-gated match pair enumeration (getFeatureMatchPairs :781-807),
BA assembly + launch (optimizeGPU :810-956) and the post-BA pose sanity
gate (:926-946).

Host bookkeeping is plain Python over Frame objects; the numerics (fused
match + BA, split-path BA) run on the store's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Cfg
from ..models import matcher as matcher_mod
from ..ops import covisibility_cuda
from ..ops import fused_corres as fused_ops
from ..ops import fused_track
from ..ops import ransac as ransac_ops
from ..utils import geometry, profiler, se3
from ..utils.profiler import span
from . import ba as ba_mod
from . import corres as corres_mod
from .corres import CorresStore
from .frame import FAIL, Frame


class Bundler:
    def __init__(self, cfg: Cfg, device=None):
        self.cfg = cfg
        self.frames: dict[int, Frame] = {}     # sliding window (non-keyframes)
        self.keyframes: list[Frame] = []
        self.firstframe: Frame | None = None
        self.newframe: Frame | None = None
        self.local_frames: list[Frame] = []
        self.store = CorresStore(cfg, device)
        self.device = self.store.device
        self._cov_cache: dict[tuple, float] = {}
        # Fixed BA edge capacity: pairs x per-pair cap.
        self.max_ba_frames = int(cfg["bundle"]["max_BA_frames"])
        self.ba_edge_cap = self.max_ba_frames * (self.max_ba_frames - 1) // 2 * 256

    # ------------------------------------------------------------------
    def covisibility(self, fa: Frame, fb: Frame) -> float:
        return self.covisibilities([(fa, fb)])[0]

    def covisibilities(self, pairs) -> list[float]:
        """The covisibility of each (fa, fb) in ``pairs``, in order: cached
        ones counted as ``track/covisibility_hit``, the rest computed in one
        ``track/covisibility`` span (on a CUDA tracker one kernel launch and
        one readback over the store's device frame pool, else the host twin
        pair by pair) and cached."""
        keys = [(fa.id, fb.id) for fa, fb in pairs]
        misses = {}
        for key, pair in zip(keys, pairs):
            if key in self._cov_cache or key in misses:
                profiler.count("track/covisibility_hit")
            else:
                misses[key] = pair
        if misses:
            with span("track/covisibility"):
                profiler.count("track/covisibility_pairs", len(misses))
                vals = covisibility_cuda.covisibilities(
                    list(misses.values()), float(self.cfg["visible_angle"]),
                    self.store.device_pool)
            self._cov_cache.update(zip(misses, vals))
        return [self._cov_cache[key] for key in keys]

    def forget_covisibilities(self):
        """Empty the covisibility cache, as the JAX Bundler does when poses
        move (and only then: relocalization reads it under a past pose)."""
        self._cov_cache = {}

    def forget_frame(self, f: Frame) -> bool:
        """Reference Bundler.cpp:62-73: drop a non-keyframe (or failed
        frame) and erase its matches."""
        if f in self.keyframes and f.status != FAIL:
            return False
        self.frames.pop(f.id, None)
        if f in self.keyframes:
            self.keyframes.remove(f)
        self.store.forget_frame(f.id)
        self._cov_cache = {
            k: v for k, v in self._cov_cache.items() if f.id not in k
        }
        return True

    # ------------------------------------------------------------------
    def check_and_add_keyframe(self, frame: Frame) -> bool:
        """Reference Bundler.cpp:263-323."""
        if frame.id == 0:
            self.keyframes.append(frame)
            return True
        if frame.status != 0:
            return False
        kf_cfg = self.cfg["keyframe"]
        n_valid = frame.count_valid_points()
        n_first = self.firstframe.count_valid_points()
        if n_valid < n_first / 10.0:
            return False
        min_rot = np.deg2rad(float(kf_cfg["min_rot"]))
        for kf in self.keyframes:
            rot_diff = se3.rotation_geodesic_distance_ignore_cam_z_np(
                frame.pose_in_model[:3, :3].T, kf.pose_in_model[:3, :3].T
            )
            if rot_diff < min_rot:
                return False
        min_visible = float(kf_cfg["min_visible"])
        if min_visible < 1.0:
            vis = self.covisibilities([(frame, kf) for kf in self.keyframes])
            if any(v > min_visible for v in vis):
                return False
        self.keyframes.append(frame)
        return True

    # ------------------------------------------------------------------
    def select_keyframes_for_ba(self):
        """Reference Bundler.cpp:430-609."""
        method = str(self.cfg["bundle"]["subset_selection_method"])
        max_frames = self.max_ba_frames
        nf = self.newframe
        if len(self.keyframes) + 1 <= max_frames:
            chosen = {f.id: f for f in self.keyframes}
            chosen[nf.id] = nf
            self.local_frames = sorted(chosen.values(), key=lambda f: f.id)
            return

        chosen = {nf.id: nf}
        if method == "greedy_rot":
            chosen[self.keyframes[0].id] = self.keyframes[0]
            while len(chosen) < max_frames:
                best, best_d = None, np.inf
                for kf in self.keyframes:
                    if kf.id in chosen:
                        continue
                    cum = sum(
                        se3.rotation_geodesic_distance_ignore_cam_z_np(
                            kf.pose_in_model[:3, :3].T, f.pose_in_model[:3, :3].T
                        )
                        for f in chosen.values()
                    )
                    if cum < best_d:
                        best, best_d = kf, cum
                chosen[best.id] = best
        elif method == "nearest_rotations":
            dists = [
                (se3.rotation_geodesic_distance_ignore_cam_z_np(
                    nf.pose_in_model[:3, :3].T, kf.pose_in_model[:3, :3].T
                ), kf)
                for kf in self.keyframes
            ]
            for _, kf in sorted(dists, key=lambda x: x[0]):
                if len(chosen) >= max_frames:
                    break
                chosen[kf.id] = kf
        elif method == "normal_orientation_greedy":
            # Greedily add the keyframe with max cumulative covisibility to
            # the chosen set (Bundler.cpp:529-554).
            chosen[self.keyframes[0].id] = self.keyframes[0]
            while len(chosen) < max_frames:
                best, best_v = None, 0.0
                rest = [kf for kf in self.keyframes if kf.id not in chosen]
                n = len(chosen)
                vis = self.covisibilities([(kf, f) for kf in rest for f in chosen.values()])
                for i, kf in enumerate(rest):
                    v = sum(vis[i * n:(i + 1) * n])
                    if v > best_v:
                        best, best_v = kf, v
                if best is None:
                    break
                chosen[best.id] = best
        elif method == "greedy_covisible_points":
            # Greedily add the keyframe sharing the most inlier feature
            # matches with the anchor frames (Bundler.cpp:555-580; the
            # reference counts covisible map points — our inlier-match
            # counts are the equivalent signal in this design).
            refs = [self.keyframes[0], nf]
            while len(chosen) < max_frames:
                best, best_n = None, 0
                for kf in self.keyframes:
                    if kf.id in chosen:
                        continue
                    n = sum(
                        self.store.tracks.n_covisible(f.id, kf.id)
                        + self.store.n_inliers((max(f.id, kf.id), min(f.id, kf.id)))
                        for f in refs
                    )
                    if n > best_n:
                        best, best_n = kf, n
                if best is None:
                    # no matched candidates left: fall back to covisibility
                    rest = [k for k in self.keyframes if k.id not in chosen]
                    if not rest:
                        break
                    vis = self.covisibilities([(nf, k) for k in rest])
                    best = rest[vis.index(max(vis))]
                chosen[best.id] = best
        elif method == "max_edge":
            # DFS over frame subsets rooted at keyframe 0 that reach the
            # new frame, maximizing the subset's total pairwise match count
            # (Bundler.cpp:581-591 + maxNumEdgePathDfs :612-686).  The
            # reference runs the matcher on unseen pairs *inside* the DFS
            # ("Super slow" per its own comment); here the edge indicator
            # is the already-tracked inlier count with covisibility as the
            # optimistic proxy for not-yet-matched pairs, so selection
            # never launches the matcher.
            min_vis = float(self.cfg["bundle"]["non_neighbor_min_visible"])
            kf0 = self.keyframes[0]
            pool_f = list(self.keyframes[1:]) + [nf]

            def n_matches(a, b):
                key = (max(a.id, b.id), min(a.id, b.id))
                m = self.store.matches.get(key)
                return 0 if not m else int(m["inlier"].sum())

            def has_edge(a, b):
                key = (max(a.id, b.id), min(a.id, b.id))
                if key in self.store.matches:
                    m = self.store.matches[key]
                    return m is not None and m["inlier"].any()
                return self.covisibility(a, b) >= min_vis

            best_path: dict | None = None
            best_n = -1
            visited: set = set()
            budget = [20000]  # bound the exponential search (the memoized
            # reference has no bound; with pools of hundreds of keyframes
            # that is not acceptable online)

            def dfs(cur, path: dict):
                nonlocal best_path, best_n
                key = frozenset(path)
                if key in visited or budget[0] <= 0:
                    return
                visited.add(key)
                budget[0] -= 1
                if len(path) == max_frames:
                    if nf.id in path:
                        fr = list(path.values())
                        total = sum(
                            n_matches(fr[i], fr[j])
                            for i in range(len(fr))
                            for j in range(i + 1, len(fr))
                        )
                        if total > best_n:
                            best_n = total
                            best_path = dict(path)
                    return
                for kf in pool_f:
                    if kf.id in path or not has_edge(cur, kf):
                        continue
                    path[kf.id] = kf
                    dfs(kf, path)
                    del path[kf.id]

            dfs(kf0, {kf0.id: kf0})
            if best_path is not None:
                chosen = best_path
            else:  # fall back to covisibility ranking
                vis = zip(self.covisibilities([(nf, kf) for kf in self.keyframes]),
                          self.keyframes)
                for _, kf in sorted(vis, key=lambda x: -x[0]):
                    if len(chosen) >= max_frames:
                        break
                    chosen[kf.id] = kf
        elif method == "near_enough_rot":
            # Chain from keyframe 0 to the new frame through rotation-near
            # hops (Bundler.cpp:592-601 nearEnoughRotSearch, greedy variant
            # of the reference's DFS).
            max_rot = np.deg2rad(float(self.cfg["bundle"]["non_neighbor_max_rot"]))
            chosen[self.keyframes[0].id] = self.keyframes[0]
            cur = self.keyframes[0]
            while len(chosen) < max_frames:
                cands = [
                    (se3.rotation_geodesic_distance_ignore_cam_z_np(
                        cur.pose_in_model[:3, :3].T, kf.pose_in_model[:3, :3].T
                    ), kf)
                    for kf in self.keyframes if kf.id not in chosen
                ]
                cands = [(d, kf) for d, kf in cands if d <= max_rot]
                if not cands:
                    break
                _, cur = min(cands, key=lambda x: x[0])
                chosen[cur.id] = cur
        else:  # normal_orientation_nearest (default, config_ho3d.yml:39)
            vis = zip(self.covisibilities([(nf, kf) for kf in self.keyframes]),
                      self.keyframes)
            for _, kf in sorted(vis, key=lambda x: -x[0]):
                if len(chosen) >= max_frames:
                    break
                chosen[kf.id] = kf
        self.local_frames = sorted(chosen.values(), key=lambda f: f.id)

    # ------------------------------------------------------------------
    def get_feature_match_pairs(self, frames: list[Frame]) -> list[tuple]:
        """Reference Bundler.cpp:781-807: enumerate unmatched pairs gated by
        covisibility >= non_neighbor_min_visible (the candidates' covisibility
        in one batch)."""
        cands = []
        for i in range(len(frames)):
            for j in range(i + 1, len(frames)):
                fa, fb = frames[j], frames[i]
                if (fa.id, fb.id) in self.store.matches:
                    continue
                if np.abs(fa.pose_in_model - np.eye(4)).max() <= 1e-6:
                    continue
                cands.append((fa, fb))
        pairs = []
        min_vis = float(self.cfg["bundle"]["non_neighbor_min_visible"])
        for (fa, fb), v in zip(cands, self.covisibilities(cands)):
            if v < min_vis:
                self.store.matches[(fa.id, fb.id)] = None  # marked skip
                continue
            pairs.append((fa, fb))
        return pairs

    # ------------------------------------------------------------------
    def _dense_maps(self, frames: list[Frame]):
        """Downsampled xyz/normal maps for the dense BA term (reference
        CUDACache downsampled frames, bundle.image_downscale)."""
        factor = int(self.cfg["bundle"]["image_downscale"])
        xyzs, nrms, oks = [], [], []
        for f in frames:
            if not hasattr(f, "_ds_cache") or f._ds_cache[0] != factor:
                d = f.depth[::factor, ::factor]
                K_ds = f.K.copy()
                K_ds[:2] /= factor
                xyz = geometry.depth_to_xyz_np(d.astype(np.float32), K_ds)
                nrm = f.normals[::factor, ::factor]
                ok = (d > 0.1) & (np.linalg.norm(nrm, axis=-1) > 0.5)
                f._ds_cache = (factor, xyz, nrm, ok, K_ds)
            _, xyz, nrm, ok, K_ds = f._ds_cache
            xyzs.append(xyz)
            nrms.append(nrm)
            oks.append(ok)
        return np.stack(xyzs), np.stack(nrms), np.stack(oks), frames[0]._ds_cache[4]

    def _ba_params(self) -> ba_mod.BAParams:
        bcfg = self.cfg["bundle"]
        return ba_mod.BAParams(
            num_iter_outer=int(bcfg["num_iter_outter"]),
            robust_delta=float(bcfg["robust_delta"]),
            w_fm=float(bcfg["w_fm"]),
            w_p2p=float(bcfg["w_p2p"]),
            image_downscale=int(bcfg["image_downscale"]),
            dense_max_dist=float(self.cfg["p2p"]["max_dist"]),
            dense_max_normal_angle=float(self.cfg["p2p"]["max_normal_angle"]),
            icp_rot_thres_deg=float(bcfg["icp_pose_rot_thres"]),
        )

    def _pose_graph(self, frames: list[Frame]):
        """Padded (N) poses, fixed flags and the dense-term pair list
        (every pair of active frames, newer first) of a BA over
        ``frames``."""
        N = self.max_ba_frames
        n_act = len(frames)
        poses = np.stack([f.pose_in_model for f in frames]
                         + [np.eye(4, dtype=np.float32)] * (N - n_act))
        fixed = np.zeros(N, bool)
        fixed[0] = True
        for i, f in enumerate(frames):
            if f.nerfed:
                fixed[i] = True
        fixed[n_act:] = True
        n_pair_cap = N * (N - 1) // 2
        pair_i = np.zeros(n_pair_cap, np.int64)
        pair_j = np.zeros(n_pair_cap, np.int64)
        pair_valid = np.zeros(n_pair_cap, bool)
        p = 0
        for i in range(n_act):
            for j in range(i + 1, n_act):
                pair_i[p] = j
                pair_j[p] = i
                pair_valid[p] = True
                p += 1
        return [torch.from_numpy(a).to(self.device) for a in (
            poses.astype(np.float32), fixed, pair_i, pair_j, pair_valid)]

    def optimize(self, frames: list[Frame]):
        """Assemble + launch the BA (reference optimizeGPU Bundler.cpp:810-956)."""
        frames = sorted(frames, key=lambda f: f.id)
        N = self.max_ba_frames
        n_act = len(frames)
        local_idx = {f.id: i for i, f in enumerate(frames)}

        # Sparse edges from inlier matches.
        cap = self.ba_edge_cap
        ii = np.zeros(cap, np.int64)
        jj = np.zeros(cap, np.int64)
        pi = np.zeros((cap, 3), np.float32)
        pj = np.zeros((cap, 3), np.float32)
        cvalid = np.zeros(cap, bool)
        e = 0
        total_edges = 0
        for i in range(n_act):
            for j in range(i + 1, n_act):
                fa, fb = frames[j], frames[i]
                m = self.store.matches.get((fa.id, fb.id))
                if m is None:
                    continue
                sel = np.nonzero(m["inlier"])[0][:256]
                k = min(len(sel), cap - e)
                if k <= 0:
                    continue
                sel = sel[:k]
                ii[e : e + k] = local_idx[fa.id]
                jj[e : e + k] = local_idx[fb.id]
                pi[e : e + k] = m["pA"][sel]
                pj[e : e + k] = m["pB"][sel]
                cvalid[e : e + k] = True
                e += k
                total_edges += k
        if total_edges == 0:
            self.newframe.status = FAIL
            return

        poses, fixed, pair_i, pair_j, pair_valid = self._pose_graph(frames)
        xyz_ds, nrm_ds, ok_ds, K_ds = self._dense_maps(frames)
        h, w = xyz_ds.shape[1:3]
        pad = N - n_act
        if pad:
            xyz_ds = np.concatenate([xyz_ds, np.zeros((pad, h, w, 3), np.float32)])
            nrm_ds = np.concatenate([nrm_ds, np.zeros((pad, h, w, 3), np.float32)])
            ok_ds = np.concatenate([ok_ds, np.zeros((pad, h, w), bool)])

        def dev(a, dtype=None):
            a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
            return torch.from_numpy(a).to(self.device)

        profiler.count("launch/ba")
        profiler.count("readback/ba")
        out, _info = ba_mod.bundle_adjust(
            poses, fixed, dev(ii), dev(jj), dev(pi), dev(pj), dev(cvalid),
            pair_i, pair_j, pair_valid,
            dev(xyz_ds, np.float32), dev(nrm_ds, np.float32), dev(ok_ds),
            dev(K_ds, np.float32), self._ba_params(), N,
        )
        self._apply_ba_result(frames, local_idx, out.cpu().numpy())

    def _apply_ba_result(self, frames, local_idx, out):
        """Post-BA pose application + sanity gate on the new frame vs its
        immediate-previous reference (Bundler.cpp:926-946)."""
        nf = self.newframe
        new_pose = out[local_idx[nf.id]]
        if nf.ref_frame_id == nf.id - 1 and nf.ref_frame_id in self.frames:
            rcfg = self.cfg["ransac"]
            ref = self.frames[nf.ref_frame_id]
            inv_new = np.linalg.inv(new_pose)
            inv_ref = np.linalg.inv(ref.pose_in_model)
            trans_diff = np.linalg.norm(inv_new[:3, 3] - inv_ref[:3, 3])
            rot_diff = se3.rotation_geodesic_distance_np(
                inv_new[:3, :3], inv_ref[:3, :3]
            )
            if trans_diff > float(rcfg["max_trans_neighbor"]) or rot_diff > np.deg2rad(
                float(rcfg["max_rot_deg_neighbor"])
            ):
                nf.status = FAIL
                return

        for i, f in enumerate(frames):
            f.pose_in_model = out[i]
        self.forget_covisibilities()

    # ------------------------------------------------------------------
    def match_and_optimize(self, pairs, frames, key,
                           ransac_draws: ransac_ops.DrawSource | None = None) -> bool:
        """The fused tail of the per-frame loop: match the fresh BA pairs,
        merge with previously-matched edges, and bundle-adjust, from one
        packed upload to one readback (ops/fused_track.py).  Dense-term maps
        come from the resident device frame pool (reference CUDACache
        residency, LossGPU.cpp:95-99).  ``key`` is the RANSAC seed (the
        frame id) and ``ransac_draws`` an optional draw source, as in
        ``corres.find_corres``.

        Returns False when the frame is ineligible (an engine other than
        the built-in corner matcher or ``feature_corres.fused`` off, raw-reuse
        pairs pending re-gating, oversized fresh batch); the caller then runs
        the split find_corres + optimize path.
        """
        cfg = self.cfg
        store = self.store
        if not store.use_fused:
            return False
        cap = int(cfg["bundle"]["fused_ba_pairs"])
        fresh = [p for p in pairs if (p[0].id, p[1].id) not in store.raw]
        if len(fresh) != len(pairs) or len(fresh) > cap:
            return False
        frames = sorted(frames, key=lambda f: f.id)
        N = self.max_ba_frames
        if len(frames) > N:
            return False
        local_idx = {f.id: i for i, f in enumerate(frames)}
        with span("track/fused_pack"):
            pool, slot_of = corres_mod.ensure_pool_frames(store, frames)
            mcfg = matcher_mod.CornerMatcherCfg(max_matches=store.max_matches)
            fcfg = corres_mod.make_fused_cfg(store, cfg, mcfg)
            pairs_data = corres_mod.build_pairs_data(store, fresh, cfg, slot_of)

            if pairs_data:
                pad = dict(pairs_data[0])
                pad["valid"] = False
            else:
                pad = {
                    "slotA": 0, "slotB": 0, "valid": False,
                    "tfA_inv": np.eye(3), "tfB_inv": np.eye(3),
                    "poseA": np.eye(4, dtype=np.float32),
                    "poseB": np.eye(4, dtype=np.float32),
                    "extra_uv": np.zeros((0, 4)),
                    "max_trans": 1.0, "max_rot_deg": 180.0,
                }
            pairs_data = pairs_data + [pad] * (cap - len(pairs_data))
            packed = fused_ops.pack_call(pairs_data, fcfg.n_extra)
            lij = np.full((cap, 2), -1, np.int64)
            for i, (fa, fb) in enumerate(fresh):
                lij[i] = (local_idx[fa.id], local_idx[fb.id])

            # previously-matched pairs among the local frames -> host edges
            keys = []
            for i in range(len(frames)):
                for j in range(i + 1, len(frames)):
                    kk = (frames[j].id, frames[i].id)
                    if store.matches.get(kk) is not None:
                        keys.append(kk)
            Eh = int(cfg["bundle"]["fused_host_edge_cap"])
            h_ii, h_jj, h_pi, h_pj, h_valid = fused_track.assemble_host_edges(
                store.matches, keys, local_idx, Eh)

            poses, fixed, pair_i, pair_j, pair_valid = self._pose_graph(frames)
            frame_slot = np.full(N, -1, np.int64)
            for i, f in enumerate(frames):
                frame_slot[i] = slot_of[f.id]

            def dev(a):
                return torch.from_numpy(np.asarray(a)).to(self.device)

            draws = ransac_ops.draw_uniforms(key, (cap, fcfg.ransac.n_trials, 3),
                                             self.device, ransac_draws)
            tcfg = fused_track.FusedTrackCfg(corres=fcfg, ba=self._ba_params(), n_frames=N)
        with span("track/fused_match_ba"):
            profiler.count("launch/fused_match_ba")
            profiler.count("readback/fused_match_ba")
            buf, out, _info = fused_track.fused_match_ba(
                pool.gray, pool.depth, pool.normals, pool.K,
                dev(packed), dev(lij), draws, poses, fixed, dev(frame_slot),
                dev(h_ii.astype(np.int64)), dev(h_jj.astype(np.int64)),
                dev(h_pi), dev(h_pj), dev(h_valid),
                pair_i, pair_j, pair_valid, tcfg,
            )
            res = fused_ops.unpack_result(buf, store.max_matches)
            out = out.cpu().numpy()
        corres_mod.commit_fused_results(store, fresh, res)

        total_edges = int(h_valid.sum()) + sum(
            store.n_inliers((fa.id, fb.id)) for fa, fb in fresh)
        if total_edges == 0:
            self.newframe.status = FAIL
            return True
        self._apply_ba_result(frames, local_idx, out)
        return True
