"""BundleSdf orchestrator: the per-frame online tracking + reconstruction
loop with an interleaved Neural Object Field trainer (port of
``bundlesdf_tpu/pipeline/bundlesdf.py``).

  * ``run``               — the per-frame entry point (reference
    bundlesdf.py:510-632): depth percentile cut, Frame build,
    ``process_new_frame``, the NOF scheduler's hooks, pose log;
  * ``process_new_frame`` — bundlesdf.py:391-506: FAIL gates, reference-
    frame re-selection by covisibility, Procrustes bootstrap, window
    eviction, BA-subset selection, fused match + BA (or the split path),
    keyframe admission;
  * NOF scheduling        — the reference's tracker/NeRF process pair
    (bundlesdf.py:64-260 run_nerf, :546-617 sync logic) as an interleaved
    scheduler in one process: once ``start_nerf_keyframes`` keyframes exist,
    pending keyframes go to the ``NofRunner`` in rounds; a round's steps
    are dispatched in chunks, and its completion exports the optimized
    keyframe poses, writes them back and freezes those keyframes in BA
    (``nerfed``).  Under strict sync (``sync_max_delay`` 0, the shipped
    value) every new keyframe's round is drained before tracking goes on;
  * ``on_finish``         — drains the last round and returns the mesh in
    real-world units;
  * ``run_global_nerf``   — bundlesdf.py:636-766: the offline global
    refinement, a fresh NOF at the offline budget trained on the saved
    keyframes, the cleaned mesh, the refined poses and the texture bake.

With ``save_artifacts`` each frame leaves the artifact trail
(``pipeline/artifacts.py``) under ``out_dir``, and the scene normalization
is saved as ``config_nerf.yml``, which the global refinement restarts
from (``entry.run_global_refine``).  With ``use_gui`` each frame writes a
dashboard PNG under ``out_dir`` (``viz/gui.py``), and every completed NOF
round extracts the mesh for it (JAX bundlesdf.py:52-59, 142-147,
418-427).  Unlike the JAX package, which writes into its default folder,
``use_gui`` without an ``out_dir`` raises, as ``save_artifacts`` does.

With ``feature_corres.rematch_after_nerf`` a keyframe that a NOF round
moved by 5 mm or 5 deg or more loses its gated matches and keeps its raw
ones, which the next ``find_corres`` re-gates under the new poses without
the matcher (JAX bundlesdf.py:467-495).

Under ``dp_devices > 1`` one process a rank runs this pipeline: rank 0
tracks and schedules, and its NOF runner sends each call that the steps'
collectives need to the other ranks, which :meth:`BundleSdf.follow` it
(``parallel/joint.py``).  The scheduler's decisions are rank 0's alone.
"""
from __future__ import annotations

import copy
import logging
import os

import numpy as np
import torch

from ..config import Cfg, default_nof_config, default_track_config
from ..io import scene_bounds as sb
from ..nof.runner import BAD_COLOR, BAD_DEPTH, NofRunner, TrainDraws, mesh_to_real_world
from ..nof.texture import bake_texture_from_train_images, bake_vertex_colors
from ..ops import ransac as ransac_ops
from ..tracking import corres as corres_mod
from ..tracking.frame import FAIL, Frame
from ..tracking.pool import Bundler
from ..utils import se3
from ..utils.device import resolve_device
from ..utils.geometry import GLCAM_IN_CVCAM
from ..utils.mesh import largest_component
from ..utils.profiler import report, span
from ..viz.gui import Dashboard
from .artifacts import save_newframe_result


class BundleSdf:
    def __init__(self, cfg_track: Cfg | None = None, cfg_nof: Cfg | None = None,
                 start_nerf_keyframes: int = 5, use_nof: bool = True,
                 save_artifacts: bool = False, use_gui: bool = False,
                 device=None, ransac_draws: ransac_ops.DrawSource | None = None,
                 nof_draws: TrainDraws | None = None, out_dir: str | None = None):
        """``device``: where the tracker's and the NOF's device work runs
        (None = CUDA; raises without one).  ``ransac_draws``: optional draw
        source ``(frame_id, shape) -> uniforms in [0, 1)`` for every RANSAC
        of a frame; without one each frame draws from a generator seeded
        with its id.  ``nof_draws``: optional draw source ``(step, n_rays)
        -> (batch_idx, SampleDraws)`` for every NOF step, handed to the
        ``NofRunner``.  ``cfg_nof`` is copied: the scene normalization is
        written into the copy.  ``out_dir``: where ``save_artifacts`` writes
        the artifact trail (required then).

        Under ``cfg_nof["dp_devices"] > 1`` (with the NOF) every rank of a
        process group of that many ranks builds this pipeline, and the NOF
        trains over all of them (``parallel/joint.py``).  Rank 0 is the
        tracker of record (``lead``): it alone is fed the frames, tracks,
        applies the NOF feedback, writes the trail and the dashboard and
        returns the mesh from ``on_finish``.  The other ranks call
        :meth:`follow`, which trains as rank 0's runner does until its
        ``on_finish``; they build no tracker.  ``device`` is then the
        rank's (None = its CUDA card).  Without such a process group this
        raises, as ``parallel.mesh.make_mesh`` does.  The offline
        ``run_global_nerf`` honours ``dp_devices`` in its ``cfg_refine``."""
        if save_artifacts and not out_dir:
            raise ValueError("save_artifacts=True needs an out_dir")
        if use_gui and not out_dir:
            raise ValueError("use_gui=True needs an out_dir for the dashboard")
        self.cfg_track = cfg_track or default_track_config()
        self.cfg_nof = Cfg.wrap(copy.deepcopy(cfg_nof or default_nof_config()))
        self._channel = None
        self.lead = True
        if use_nof and int(self.cfg_nof.get("dp_devices", 0) or 0) > 1:
            from ..parallel import joint
            from ..parallel.mesh import make_mesh

            dp_mesh = make_mesh(int(self.cfg_nof["dp_devices"]), device=device)
            device, self.lead = dp_mesh.device, dp_mesh.rank == 0
            self._channel = joint.Channel(dp_mesh)
        self.bundler = Bundler(self.cfg_track, device) if self.lead else None
        self.device = self.bundler.device if self.lead else resolve_device(device)
        self.save_artifacts = save_artifacts and self.lead
        self.out_dir = out_dir
        if self.save_artifacts:
            os.makedirs(out_dir, exist_ok=True)
        self.gui = Dashboard(out_dir, device=self.device) if use_gui and self.lead else None
        self.ransac_draws = ransac_draws
        self.nof_draws = nof_draws
        self.start_nerf_keyframes = start_nerf_keyframes
        self.use_nof = use_nof
        self.cnt = -1
        self.K = None
        self.nof: NofRunner | None = None
        self._kf_sent = 0          # how many keyframes have been handed to NOF
        self._nof_steps_left = 0   # undispatched steps of the open NOF round
        self._nof_open = False     # a round is in flight (not yet completed)
        self._nof_poses_pending = None
        self._cal_debt = 0         # calibration steps not yet repaid
        self._mesh_offset = np.eye(4)
        self.mesh = None
        self.translation = None
        self.sc_factor = None
        self._pcd_real = None      # running fused cloud (real scale)
        self.poses_log: dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    def run(self, color, depth, K, id_str, mask=None, occ_mask=None,
            pose_in_model=np.eye(4)):
        """Process one RGBD frame; returns the frame (with pose_in_model)."""
        with span("pipeline/run"):
            self._require_lead("run")
            self.cnt += 1
            if self.K is None:
                self.K = np.asarray(K, dtype=np.float32)
            if self.use_nof:
                # keep the device busy with NOF while the host preps this frame
                self._nof_pump()
            depth = np.asarray(depth, dtype=np.float32).copy()

            percentile = float(self.cfg_track["depth_processing"]["percentile"])
            if percentile < 100 and mask is not None:
                valid = (depth >= 0.1) & (mask > 0)
                if valid.any():
                    thres = np.percentile(depth[valid], percentile)
                    depth[depth >= thres] = 0
            with span("track/make_frame"):
                frame = Frame(
                    color, depth, self.K, self.cnt, id_str, self.cfg_track,
                    pose_in_model=np.asarray(pose_in_model, dtype=np.float32),
                    fg_mask=mask, occ_mask=occ_mask, device=self.bundler.device,
                )
            with span("track/process_new_frame"):
                self.process_new_frame(frame)

            if self.use_nof:
                # NOF scheduling under the reference sync contract
                # (bundlesdf.py:571-582 + config.yml sync_max_delay): a round is
                # dispatched in chunks with a bounded queue depth (_nof_pump);
                # its completion (drain + pose export + feedback) happens on a
                # non-blocking poll once the queue is idle, and the tracker
                # blocks only at the reference gate: a new keyframe with a
                # backlog >= max(1, delay).
                n_kf = len(self.bundler.keyframes)
                new_kf = bool(self.bundler.keyframes) and \
                    self.bundler.keyframes[-1] is frame
                delay = int(self.cfg_nof.get("sync_max_delay", 0))
                backlog = n_kf - self._kf_sent
                self._nof_poll()
                if self._nof_open and new_kf and backlog >= max(1, delay):
                    with span("nof/sync_wait"):
                        self._nof_round_finish()
                if not self._nof_open and backlog >= 1 and (
                        (self.nof is not None)
                        or (n_kf >= self.start_nerf_keyframes)):
                    with span("nof/round_start"):
                        self._nof_round_start()
                    if delay == 0 and self._nof_open:
                        # strict lockstep: the reference wait loop blocks until
                        # the round holding the just-pushed keyframe finishes
                        with span("nof/sync_wait"):
                            self._nof_round_finish()
                self._nof_pump()

            self.poses_log[id_str] = np.linalg.inv(frame.pose_in_model)  # ob_in_cam
            if self.gui is not None:
                with span("gui/update"):
                    self.gui.update(frame.color, frame.fg_mask, self.poses_log[id_str],
                                    self.K, id_str, mesh=self.mesh,
                                    n_keyframes=len(self.bundler.keyframes))
            if self.save_artifacts:
                with span("artifacts/save"):
                    save_newframe_result(self, frame, self.out_dir,
                                         int(self.cfg_track["SPDLOG"]))
            return frame

    # ------------------------------------------------------------------
    def process_new_frame(self, frame: Frame):
        """Parity with bundlesdf.py:391-506."""
        b = self.bundler
        b.newframe = frame
        cfg = self.cfg_track

        if frame.id > 0:
            if b.frames:
                ref = b.frames[sorted(b.frames.keys())[-1]]
            elif b.keyframes:
                ref = b.keyframes[-1]
            else:
                frame.status = FAIL
                return
            frame.ref_frame_id = ref.id
            frame.pose_in_model = ref.pose_in_model.copy()
        else:
            b.firstframe = frame

        if frame.id == 0 and np.abs(frame.pose_in_model - np.eye(4)).max() <= 1e-4:
            frame.set_new_init_coordinate()

        n_fg = int(frame.fg_mask.sum())
        if n_fg < 100:
            logging.info(f"frame {frame.id_str}: empty mask, FAIL")
            frame.status = FAIL
            b.forget_frame(frame)
            return

        if bool(cfg["depth_processing"]["denoise_cloud"]):
            with span("track/denoise"):
                frame.point_cloud_denoise()

        n_valid = frame.count_valid_points()
        if frame.id > 0:
            n_first = b.firstframe.count_valid_points()
            if n_valid < n_first / 40.0:
                logging.info(f"frame {frame.id_str}: too few valid points, FAIL")
                frame.status = FAIL
                b.forget_frame(frame)
                return

        if frame.id == 0:
            b.check_and_add_keyframe(frame)
            b.frames[frame.id] = frame
            return

        min_match = int(cfg["feature_corres"]["min_match_with_ref"])
        # one RANSAC seed per frame, as the JAX package's PRNGKey(frame.id)
        key, draws = frame.id, self.ransac_draws
        with span("track/find_corres_ref"):
            corres_mod.find_corres(b.store, [(frame, ref)], cfg, key=key,
                                   ransac_draws=draws)
        if b.store.n_inliers((frame.id, ref.id)) < min_match:
            # Relocalize against the pool: try keyframes by covisibility
            # (bundlesdf.py:443-471).
            vis = b.covisibilities([(frame, kf) for kf in b.keyframes])
            ranked = [kf for _, kf in sorted(zip(vis, b.keyframes), key=lambda x: -x[0])]
            found = False
            for kf in ranked:
                if kf.id == ref.id:
                    continue
                frame.ref_frame_id = kf.id
                frame.pose_in_model = kf.pose_in_model.copy()
                corres_mod.find_corres(b.store, [(frame, kf)], cfg, key=key,
                                       ransac_draws=draws)
                if b.store.n_inliers((frame.id, kf.id)) >= min_match:
                    ref = kf
                    found = True
                    break
            if not found:
                logging.info(f"frame {frame.id_str}: no suitable ref frame, FAIL")
                frame.status = FAIL
                b.forget_frame(frame)
                return

        offset = corres_mod.procrustes_offset(b.store, frame, ref)
        frame.pose_in_model = (offset @ frame.pose_in_model).astype(np.float32)

        window_size = int(cfg["bundle"]["window_size"])
        kf_ids = {kf.id for kf in b.keyframes}
        if len(b.frames) - sum(1 for fid in b.frames if fid in kf_ids) > window_size:
            for fid in sorted(b.frames.keys()):
                if b.forget_frame(b.frames[fid]):
                    break
        b.frames[frame.id] = frame

        with span("track/select_keyframes"):
            b.select_keyframes_for_ba()
        pairs = b.get_feature_match_pairs(b.local_frames)
        # Fused tail: fresh-pair matching + BA from one upload to one
        # readback; the split path runs when the frame is ineligible.
        fused_done = False
        if bool(cfg["bundle"]["fused_ba"]):
            fused_done = b.match_and_optimize(pairs, b.local_frames, key, draws)
        if not fused_done:
            with span("track/find_corres_ba"):
                corres_mod.find_corres(b.store, pairs, cfg, key=key, ransac_draws=draws)
            if frame.status == FAIL:
                b.forget_frame(frame)
                return
            with span("track/ba"):
                b.optimize(b.local_frames)
        if frame.status == FAIL:
            b.forget_frame(frame)
            return

        b.check_and_add_keyframe(frame)

    # ------------------------------------------------------------------
    def _run_nof_chunk(self):
        """Hand pending keyframes to the NOF runner and train one full round
        synchronously (the reference run_nerf iteration, bundlesdf.py:
        64-260): round_start + drain + complete, used by on_finish."""
        self._nof_round_start()
        if self._nof_open:
            self._nof_round_finish()

    def _nof_round_start(self):
        """Prepare the next NOF round: hand the pending keyframes to the
        runner (or create it) and set the round's step budget.  Training is
        dispatched by _nof_pump and _nof_round_finish."""
        kfs = self.bundler.keyframes
        new_kfs = kfs[self._kf_sent:]
        n_step = int(self.cfg_nof["n_step"])
        # Extension rounds keep the continually-trained weights, so they
        # may take fewer steps (n_step_extend; 0 = n_step).
        n_extend = int(self.cfg_nof.get("n_step_extend", 0)) or n_step
        if not new_kfs and self.nof is not None:
            # No new keyframes — keep refining with the updated poses.
            self._sync_poses_into_nof()
            self._set_round_budget(n_extend)
            return
        if not new_kfs:
            return

        rgbs = np.stack([f.color / 255.0 if f.color.max() > 1.5 else f.color
                         for f in new_kfs]).astype(np.float32)
        depths = np.stack([f.depth for f in new_kfs]).astype(np.float32)
        masks = np.stack([f.fg_mask for f in new_kfs]).astype(np.float32)
        cam_in_obs = np.stack([f.pose_in_model for f in kfs])
        glcam_in_obs = cam_in_obs @ GLCAM_IN_CVCAM

        if not any(((d >= 0.1) & (m > 0)).any() for d, m in zip(depths, masks)):
            logging.warning("NOF chunk skipped: no keyframe has valid masked depth")
            self._kf_sent = len(kfs)
            return
        first = self.nof is None
        if first:
            with span("nof/scene_bounds"):
                sc, tr, pcd_real, _ = sb.compute_scene_bounds(
                    rgbs, depths, masks, self.K, glcam_in_obs,
                    eps=float(self.cfg_nof["dbscan_eps"]),
                    min_samples=int(self.cfg_nof["dbscan_eps_min_samples"]),
                )
            sc *= 0.7  # online margin (bundlesdf.py:151)
            self.sc_factor = sc
            self.translation = tr
            self.cfg_nof["sc_factor"] = float(sc)
            self.cfg_nof["translation"] = tr.tolist()
            self._pcd_real = pcd_real
            if self.save_artifacts:
                # the normalization as an artifact, so that the global
                # refinement reuses the online mapping (bundlesdf.py:696-700)
                self.cfg_nof.save(f"{self.out_dir}/config_nerf.yml")
            with span("nof/preprocess"):
                pr, pd, pm, poses_n = self._preprocess(rgbs, depths, masks, glcam_in_obs)
            pcd_norm = (self._pcd_real + self.translation) * self.sc_factor
            with span("nof/create_runner"):
                args = (self.cfg_nof, pr, pd, pm, poses_n, self.K, pcd_norm)
                kw = dict(device=self.device, train_draws=self.nof_draws)
                if self._channel is None:
                    self.nof = NofRunner(*args, **kw)
                else:
                    from ..parallel.joint import LeadRunner

                    self.nof = LeadRunner(self._channel, *args, **kw)
        else:
            # incrementally fuse new keyframe clouds (bundlesdf.py:162-177)
            with span("nof/fuse_cluster"):
                pts_new = []
                with span("nof/fuse_cloud"):
                    for i, f in enumerate(new_kfs):
                        glc = f.pose_in_model @ GLCAM_IN_CVCAM
                        pts, _ = sb.fuse_frame_cloud(depths[i], rgbs[i], masks[i], self.K, glc)
                        if pts is not None:
                            pts_new.append(pts)
                allpts = (np.concatenate([self._pcd_real] + pts_new) if pts_new
                          else self._pcd_real)
                with span("nof/voxel_downsample"):
                    allpts, _ = sb.voxel_downsample(allpts, None, 0.01)
                with span("nof/cluster"):
                    allpts, _ = sb.find_biggest_cluster(
                        allpts, eps=float(self.cfg_nof["dbscan_eps"]),
                        min_samples=int(self.cfg_nof["dbscan_eps_min_samples"]),
                    )
                self._pcd_real = allpts
            with span("nof/preprocess"):
                pr, pd, pm, poses_n = self._preprocess(rgbs, depths, masks, glcam_in_obs)
            pcd_norm = (allpts + self.translation) * self.sc_factor
            with span("nof/add_new_frames"):
                self.nof.add_new_frames(pr, pd, pm, poses_n, pcd_norm)

        self._kf_sent = len(kfs)
        self._set_round_budget(n_step if first else n_extend)

    def _set_round_budget(self, budget: int):
        """Open a round with ``budget`` steps, less the steps that the
        session's one calibration chunk trained (calibrate_step_ms trains
        for real, so the total step budget stays exact).  The deduction
        never shrinks a round below one loop chunk; unrepaid debt carries
        to later rounds."""
        nof = self.nof
        cal = nof._calibrate_steps if nof else 0
        if cal:
            nof._calibrate_steps = 0
        debt = self._cal_debt + cal
        chunk = nof.loop_chunk if nof else 1
        use = min(debt, max(0, int(budget) - chunk))
        self._cal_debt = debt - use
        self._nof_steps_left = int(budget) - use
        self._nof_open = self._nof_steps_left > 0

    def _nof_pump(self):
        """Keep up to ``nof_queue_depth`` NOF chunks queued on the device,
        without blocking; the poll completes the round once its budget is
        dispatched and the queue is observed idle."""
        depth = int(self.cfg_nof.get("nof_queue_depth", 2))
        if self.nof is not None and self._nof_steps_left > 0:
            chunk = self.nof.loop_chunk
            with span("nof/advance"):
                while (self._nof_steps_left > 0
                       and self.nof.pending_chunks() < depth):
                    n = min(chunk, self._nof_steps_left)
                    self.nof.train_advance(n)
                    self._nof_steps_left -= n
        self._nof_poll()

    def _nof_poll(self):
        """Complete the open round iff its budget is fully dispatched and
        the device queue has drained (non-blocking)."""
        if (self._nof_open and self._nof_steps_left == 0
                and self.nof is not None and self.nof.train_queue_ready()):
            self._nof_round_complete()
            self._nof_open = False

    def _nof_round_finish(self):
        """Blocking round completion: dispatch any remaining budget, drain,
        complete (the reference wait loop, bundlesdf.py:571-582)."""
        if not self._nof_open:
            return
        if self._nof_steps_left > 0:
            self.nof.train_advance(self._nof_steps_left)
            self._nof_steps_left = 0
        self._nof_round_complete()
        self._nof_open = False

    def _nof_round_complete(self):
        """Drain the round, export optimized poses, apply feedback (the
        reference's end-of-round writes, bundlesdf.py:244-255, and the
        tracker-side pose sync, :584-617).  The mesh is extracted here only
        for the dashboard; without it, once, at on_finish."""
        self.nof.train_drain()
        with span("nof/pose_export"):
            poses_out, offset = self.nof.get_optimized_poses_in_real_world()
        self._nof_poses_pending = poses_out
        self._mesh_offset = offset
        if self.gui is not None:
            self.mesh = mesh_to_real_world(
                self.nof.extract_mesh(), offset,
                np.asarray(self.cfg_nof["translation"]), self.sc_factor)
        with span("nof/feedback"):
            self._apply_nof_feedback()
        if not self.nof._step_ms and bool(self.cfg_nof.get("calibrate_step", True)):
            # one-time step-time calibration; its real steps are deducted
            # from the next rounds' budgets
            with span("nof/calibrate"):
                self.nof.calibrate_step_ms()

    def _preprocess(self, rgbs, depths, masks, glcam_in_obs):
        """preprocess_data parity (nerf_helpers.py:218-240): normalize rgb,
        mark bad depth/color, scale depth & poses.  Poses: all keyframes
        (the runner gets the full set each extension)."""
        sc = self.sc_factor
        tr = np.asarray(self.translation)
        rgbs = rgbs.copy()
        depths = depths.copy()
        depths[depths < 0.1] = BAD_DEPTH
        rgbs[masks == 0] = BAD_COLOR / 255.0
        depths[masks == 0] = BAD_DEPTH
        depths = depths * sc
        poses = glcam_in_obs.copy()
        poses[:, :3, 3] += tr
        poses[:, :3, 3] *= sc
        return rgbs, depths, masks, poses.astype(np.float32)

    def _sync_poses_into_nof(self):
        kfs = self.bundler.keyframes[: self.nof.n_frames]
        cam_in_obs = np.stack([f.pose_in_model for f in kfs])
        glcam = cam_in_obs @ GLCAM_IN_CVCAM
        glcam[:, :3, 3] += np.asarray(self.translation)
        glcam[:, :3, 3] *= self.sc_factor
        self.nof.set_poses(glcam.astype(np.float32))

    def _apply_nof_feedback(self):
        """Write optimized keyframe poses back and freeze them in BA
        (bundlesdf.py:584-617).  With ``rematch_after_nerf``, a keyframe
        moved by >= 5 mm or >= 5 deg has its gated matches invalidated and
        its raw table kept (bundlesdf.py:607-617 + rawMatchesToCorres)."""
        if self._nof_poses_pending is None:
            return
        poses = self._nof_poses_pending
        rematch = bool(self.cfg_track["feature_corres"]["rematch_after_nerf"])
        large_update = []
        for i in range(min(len(poses), len(self.bundler.keyframes))):
            kf = self.bundler.keyframes[i]
            if rematch:
                t_upd = np.linalg.norm(poses[i][:3, 3] - kf.pose_in_model[:3, 3])
                # f32, as the JAX package's device geodesic
                r_upd = float(se3.rotation_geodesic_distance(
                    torch.from_numpy(np.asarray(poses[i][:3, :3], np.float32)),
                    torch.from_numpy(np.asarray(kf.pose_in_model[:3, :3], np.float32))))
                if t_upd >= 0.005 or r_upd >= np.deg2rad(5):
                    large_update.append(kf)
            kf.pose_in_model = poses[i].astype(np.float32)
            kf.nerfed = True
        for kf in large_update:
            self.bundler.store.invalidate_matches(kf.id)
        self.bundler._cov_cache = {}
        self._nof_poses_pending = None

    # ------------------------------------------------------------------
    def on_finish(self):
        """Final NOF pass over any remaining keyframes (reference on_finish
        bundlesdf.py:324-338 waits for the worker to drain); returns the
        mesh in real-world units (None without the NOF).  Under dp it then
        stops the other ranks' :meth:`follow`."""
        self._require_lead("on_finish")
        if self.use_nof and self.bundler.keyframes:
            if self._nof_open:
                with span("nof/sync_wait"):
                    self._nof_round_finish()
            if self.nof is None or self._kf_sent < len(self.bundler.keyframes):
                self._run_nof_chunk()
        if self._channel is not None and not self._channel.stopped:
            self._channel.send("stop")
        if self.mesh is None and self.nof is not None:
            with span("nof/extract_mesh_final"):
                mesh = self.nof.extract_mesh()
                self.mesh = mesh_to_real_world(
                    mesh, self._mesh_offset,
                    np.asarray(self.cfg_nof["translation"]), self.sc_factor)
        logging.info("timing profile:\n%s", report(min_total=0.01))
        return self.mesh

    def follow(self) -> NofRunner | None:
        """On a rank other than 0 of the online loop under dp: train the NOF
        as rank 0's commands say until its ``on_finish`` (``parallel/
        joint.py``).  Returns this rank's runner (None when no round
        started); the rank tracks nothing and writes nothing."""
        from ..parallel import joint

        if self.lead:
            raise RuntimeError("follow() runs on the ranks other than 0 of a dp "
                               "pipeline; rank 0 feeds the frames to run()")
        self.nof = joint.follow(self._channel, self.device, self.nof_draws)
        return self.nof

    def _require_lead(self, what: str) -> None:
        if not self.lead:
            raise RuntimeError(f"{what}() runs on rank 0, the tracker of record; the "
                               "other ranks of a dp pipeline call follow()")

    # ------------------------------------------------------------------
    def run_global_nerf(self, frames_data: list[dict], cfg_refine: Cfg | None = None,
                        get_texture: bool = False):
        """Offline global refinement (bundlesdf.py:636-766): retrain a fresh
        NOF on the saved keyframes at the offline budget (16 levels 16 ->
        256, 64 + 256 samples a ray, ``frame_features`` 2, ``rgb_weight``
        100, ``loop_chunk`` 10 merged into ``cfg_nof`` unless ``cfg_refine``
        is given), extract and clean the mesh, export the refined poses and,
        with ``get_texture``, bake vertex colors and a UV texture
        (``self.texture``).  The runner takes the pipeline's ``nof_draws``.

        frames_data: list of dicts {color, depth, mask, cam_in_ob (4x4 CV)}.
        Returns (mesh in real-world units, (n, 4, 4) refined cam-in-object
        poses)."""
        cfg = cfg_refine or self.cfg_nof.merged({
            "n_step": 2000, "N_samples": 64, "N_samples_around_depth": 256,
            "num_levels": 16, "finest_res": 256, "frame_features": 2,
            "rgb_weight": 100.0, "loop_chunk": 10,
        })
        n_limit = int(cfg["n_train_image"])
        if len(frames_data) > n_limit:
            idx = np.linspace(0, len(frames_data) - 1, n_limit).astype(int)
            frames_data = [frames_data[i] for i in idx]

        rgbs = np.stack([f["color"] for f in frames_data]).astype(np.float32)
        if rgbs.max() > 1.5:
            rgbs = rgbs / 255.0
        depths = np.stack([f["depth"] for f in frames_data]).astype(np.float32)
        masks = np.stack([f["mask"] for f in frames_data]).astype(np.float32)
        cam_in_obs = np.stack([f["cam_in_ob"] for f in frames_data])
        glcam_in_obs = cam_in_obs @ GLCAM_IN_CVCAM

        if self.sc_factor is None or self._pcd_real is None:
            with span("nof/scene_bounds"):
                sc, tr, pcd_real, _ = sb.compute_scene_bounds(
                    rgbs, depths, masks, self.K, glcam_in_obs,
                    eps=float(cfg["dbscan_eps"]),
                    min_samples=int(cfg["dbscan_eps_min_samples"]))
            if self.sc_factor is None:  # else keep the online normalization
                self.sc_factor, self.translation = sc, tr
            self._pcd_real = pcd_real
        cfg["sc_factor"] = float(self.sc_factor)
        cfg["translation"] = np.asarray(self.translation).tolist()
        cfg["max_kf_pool"] = max(int(cfg.get("max_kf_pool", 128)), len(frames_data))
        pr, pd, pm, poses_n = self._preprocess(rgbs, depths, masks, glcam_in_obs)
        pcd_norm = (self._pcd_real + self.translation) * self.sc_factor
        with span("nof/create_runner"):
            nof = NofRunner(cfg, pr, pd, pm, poses_n, self.K, pcd_norm,
                            device=self.device, train_draws=self.nof_draws)
        nof.train(int(cfg["n_step"]))
        mesh = largest_component(nof.extract_mesh())
        poses_out, offset = nof.get_optimized_poses_in_real_world()
        mesh = mesh_to_real_world(mesh, offset, np.asarray(cfg["translation"]),
                                  self.sc_factor)
        if get_texture:
            with span("texture/bake"):
                mesh = bake_vertex_colors(mesh, nof, rgbs, depths, masks, cam_in_obs,
                                          self.K, device=self.device)
                mesh, self.texture = bake_texture_from_train_images(
                    mesh, rgbs, depths, masks, cam_in_obs, self.K, device=self.device)
        self.global_nof = nof
        return mesh, poses_out
