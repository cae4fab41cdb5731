"""BundleSdf orchestrator, tracking only (port of the tracker half of
``bundlesdf_tpu/pipeline/bundlesdf.py``).

  * ``run``               — the per-frame entry point (reference
    bundlesdf.py:510-632): depth percentile cut, Frame build,
    ``process_new_frame``, pose log;
  * ``process_new_frame`` — bundlesdf.py:391-506: FAIL gates, reference-
    frame re-selection by covisibility, Procrustes bootstrap, window
    eviction, BA-subset selection, fused match + BA (or the split path),
    keyframe admission.

The Neural Object Field half (the NOF scheduler, pose feedback, the mesh,
``run_global_nerf``) waits for the rest of the port's ``NofRunner``:
``use_nof=True`` raises, and ``on_finish`` returns the mesh, which stays
None.  So do the JAX constructor's NOF, artifact and GUI arguments, which
come back with that half.
"""
from __future__ import annotations

import logging

import numpy as np

from ..config import Cfg, default_track_config
from ..ops import ransac as ransac_ops
from ..tracking import corres as corres_mod
from ..tracking.frame import FAIL, Frame
from ..tracking.pool import Bundler
from ..utils.profiler import report, span


class BundleSdf:
    def __init__(self, cfg_track: Cfg | None = None, use_nof: bool = True,
                 device=None, ransac_draws: ransac_ops.DrawSource | None = None):
        """``use_nof`` must be False until the NOF half is ported (the JAX
        default, True, raises).  ``device``: where the tracker's device
        programs run (None = CUDA; raises without one).  ``ransac_draws``:
        optional draw source ``(frame_id, shape) -> uniforms in [0, 1)`` for
        every RANSAC of a frame; without one each frame draws from a
        generator seeded with its id."""
        if use_nof:
            raise NotImplementedError(
                "the Neural Object Field half of BundleSdf waits for the rest "
                "of NofRunner (ROADMAP queue 1, item 6); pass use_nof=False")
        self.cfg_track = cfg_track or default_track_config()
        self.bundler = Bundler(self.cfg_track, device)
        self.device = self.bundler.device
        self.ransac_draws = ransac_draws
        self.use_nof = use_nof
        self.cnt = -1
        self.K = None
        self.mesh = None
        self.poses_log: dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    def run(self, color, depth, K, id_str, mask=None, occ_mask=None,
            pose_in_model=np.eye(4)):
        """Process one RGBD frame; returns the frame (with pose_in_model)."""
        self.cnt += 1
        if self.K is None:
            self.K = np.asarray(K, dtype=np.float32)
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
                fg_mask=mask, occ_mask=occ_mask,
            )
        with span("track/process_new_frame"):
            self.process_new_frame(frame)
        self.poses_log[id_str] = np.linalg.inv(frame.pose_in_model)  # ob_in_cam
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
            ranked = sorted(b.keyframes, key=lambda kf: -b.covisibility(frame, kf))
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
    def on_finish(self):
        """End of the video.  Tracking only: logs the span profile and
        returns the mesh, which without the NOF half is None."""
        logging.info("timing profile:\n%s", report(min_total=0.01))
        return self.mesh
