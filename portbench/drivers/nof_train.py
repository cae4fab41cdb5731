"""Window driver ``nof_train``: the NOF training loop alone, on the ray pool
of a video's first ``frames`` frames at their true poses.

Set-up builds the runner as ``BundleSdf.run_global_nerf`` does (scene
bounds with the online margin, ``_preprocess``, ``NofRunner``), with the
benchmark's initial weights and its draw source, and trains the first
three steps through ``train_advance`` (one step and one drain each),
keeping their losses, the gradient Adam received in the first and each
leaf's change after the third.  The window keeps at most
``nof_queue_depth`` chunks of ``loop_chunk`` steps in flight, as the
scheduler's pump does, and closes with ``train_drain``.  The check runs
the plain reference over the same three steps from the same weights, ray
pool, occupancy grid and poses, after the program's state is freed.
"""
from __future__ import annotations

import time
import types

import numpy as np

from .. import costs, video as video_mod
from ..draws import NofDraws
from ..reference import nof_step, pool as pool_check
from . import common

FIRST_STEPS = 3


class Cell:
    def __init__(self, ctx):
        from bundlesdf_tpu_torch.io import scene_bounds as sb
        from bundlesdf_tpu_torch.nof.runner import NofRunner
        from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf
        from bundlesdf_tpu_torch.utils.geometry import GLCAM_IN_CVCAM

        self.ctx = ctx
        cfg, traffic, dev = ctx.config["nof"], ctx.traffic, ctx.device
        vid = video_mod.make_video(traffic, ctx.seed)
        K = vid["K"]
        rgbs = np.stack(vid["colors"]).astype(np.float32) / 255.0
        depths = np.stack(vid["depths"]).astype(np.float32)
        masks = np.stack(vid["masks"]).astype(np.float32)
        cam_in_obs = np.stack([np.linalg.inv(T) for T in vid["gt"]])
        glcam = cam_in_obs @ GLCAM_IN_CVCAM
        sc, tr, pcd_real, _ = sb.compute_scene_bounds(
            rgbs, depths, masks, K, glcam, eps=float(cfg["dbscan_eps"]),
            min_samples=int(cfg["dbscan_eps_min_samples"]))
        sc *= common.ONLINE_MARGIN
        nof_cfg = common.nof_config(cfg, ctx.tmp).merged({
            "sc_factor": float(sc), "translation": np.asarray(tr).tolist(),
            "max_kf_pool": max(int(cfg["max_kf_pool"]), len(rgbs))})
        self.cfg = dict(nof_cfg)
        shim = types.SimpleNamespace(sc_factor=float(sc), translation=np.asarray(tr))
        pr, pd, pm, poses_n = BundleSdf._preprocess(shim, rgbs, depths, masks, glcam)
        pcd_norm = (pcd_real + tr) * sc
        self.inputs = {k: vid[k] for k in ("colors", "depths", "masks", "K", "gt", "model_pts")}
        params = nof_step.make_params(self.cfg, int(nof_cfg["max_kf_pool"]), ctx.seed, dev)
        self.params0 = {n: t.detach().cpu().clone() for n, t in nof_step.named_leaves(params)}
        leaves = common.as_leaves(params)
        self.draws = NofDraws(self.cfg, ctx.seed, dev)
        self.runner = NofRunner(nof_cfg, pr, pd, pm, poses_n, K, pcd_norm, device=dev,
                                params=leaves, train_draws=self.draws)
        r = self.runner
        self.pool = {"rays": r.rays_np.copy(), "grid": r.occ_grid.detach().cpu().clone(),
                     "c2w": r.c2w_np.copy(), "n_frames": r.n_frames}
        self.first = common.first_steps(r, FIRST_STEPS, self.draws)
        self.microbatches = costs.microbatches(self.cfg)

    def _pump(self, seconds: float = float("inf"), steps: int | None = None) -> tuple:
        """Keep at most ``nof_queue_depth`` chunks in flight until
        ``seconds`` have passed or ``steps`` are dispatched, then drain:
        (steps, the last step's metrics)."""
        r = self.runner
        depth = int(self.cfg["nof_queue_depth"])
        done, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds and (steps is None or done < steps):
            if r.pending_chunks() < depth:
                n = r.loop_chunk if steps is None else min(r.loop_chunk, steps - done)
                r.train_advance(n)
                done += n
            else:
                time.sleep(2e-4)
        return done, r.train_drain()

    def window(self, seconds: float) -> dict:
        common.sync(self.ctx.device)
        t0 = time.perf_counter()
        steps, out = self._pump(seconds=seconds)
        common.sync(self.ctx.device)
        window_s = time.perf_counter() - t0
        bad = 0 if np.isfinite(out.get("loss", np.nan)) else 1
        return {"steps": steps, "window_s": window_s, "attempted": steps, "failed": bad}

    def traced_slice(self) -> int:
        with common.span_labels():
            return self._pump(steps=int(self.ctx.traffic["trace_steps"]))[0]

    def verify(self) -> list:
        """The three first steps against the reference, and the ray pool
        against the frames."""
        self.runner = None
        common.free(self.ctx.device)
        dev = self.ctx.device
        checks = common.compare_first_steps(
            self.cfg, self.params0, nof_step.fresh_adam(self.params0), self.pool, self.first,
            dev, self.microbatches, self.ctx.limits)
        bad = pool_check.mismatches(self.cfg, self.pool, self.inputs)
        checks.append({"name": "pool_mismatches", "value": float(bad),
                       "limit": float(self.ctx.limits["pool_mismatches"])})
        return checks
