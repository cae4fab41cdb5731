"""Window driver ``video``: the video fed to ``BundleSdf.run`` back to back
(closed loop, as ``run_custom`` reads a folder), through
``entry.build_pipeline`` (``use_nof``) or ``entry.build_tracker``.

Set-up renders the video and runs a throwaway session over its first
``warm_frames`` frames, so that every kernel, handle and capture the
window uses has been made once.  The window starts a fresh session; each
frame's latency is the host clock around ``run``, closed by a
synchronise.  When the video runs out the session ends with
``on_finish()`` (its time counted, not a frame) and a fresh one begins.
The window closes at the end of the frame in flight.

The check holds every frame's pose against the truth; with the NOF it
also trains three more steps of the last runner a session made, after a
drain, and holds them against the plain reference from the same state
(the comparison follows the program from its own state: the start of the
weights and the ray pool are checked in the ``nof_train`` cells).
"""
from __future__ import annotations

import time


from .. import costs, video as video_mod
from ..draws import NofDraws, ransac_draws
from . import common

FIRST_STEPS = 3


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        traffic = ctx.traffic
        self.use_nof = bool(traffic["use_nof"])
        self.vid = video_mod.make_video(traffic, ctx.seed)
        self.n = len(self.vid["colors"])
        self.track_cfg = common.track_config(ctx.config["track"], ctx.tmp)
        self.nof_cfg = common.nof_config(ctx.config["nof"], ctx.tmp) if self.use_nof else None
        self.ransac = ransac_draws(ctx.seed)
        self.nof_draws = (NofDraws(self.nof_cfg, ctx.seed, ctx.device) if self.use_nof
                          else None)
        self.sessions = []
        pipe = self._session()
        for k in range(int(traffic["warm_frames"])):
            self._frame(pipe, k)
        pipe = None
        common.sync(ctx.device)
        self.pipe, self.k, self.cur, self.runner = None, 0, None, None
        self.fail_ids = []

    def _session(self):
        from bundlesdf_tpu_torch import entry

        if self.use_nof:
            return entry.build_pipeline(
                self.track_cfg, self.nof_cfg,
                start_nerf_keyframes=int(self.nof_cfg["start_nerf_keyframes"]),
                device=self.ctx.device, ransac_draws=self.ransac, nof_draws=self.nof_draws)
        return entry.build_tracker(self.track_cfg, device=self.ctx.device,
                                   ransac_draws=self.ransac)

    def _frame(self, pipe, k: int):
        v = self.vid
        return pipe.run(v["colors"][k], v["depths"][k], v["K"], f"{k:05d}", mask=v["masks"][k])

    def _next(self) -> float:
        """Run the next frame of the present session (a fresh session when
        there is none or the video ran out); its latency in seconds."""
        from bundlesdf_tpu_torch.tracking.frame import FAIL

        if self.pipe is None or self.k == self.n:
            if self.pipe is not None:
                self.pipe.on_finish()
            self.pipe, self.k = self._session(), 0
            self.cur = {"preds": [], "gt": [], "fails": 0}
            self.sessions.append(self.cur)
        t0 = time.perf_counter()
        f = self._frame(self.pipe, self.k)
        common.sync(self.ctx.device)
        lat = time.perf_counter() - t0
        self.cur["preds"].append(self.pipe.poses_log[f"{self.k:05d}"])
        self.cur["gt"].append(self.vid["gt"][self.k])
        if f.status == FAIL:
            self.cur["fails"] += 1
            self.fail_ids.append([len(self.sessions) - 1, self.k])
        self.k += 1
        if self.use_nof and self.pipe.nof is not None:
            self.runner = self.pipe.nof
        return lat

    def window(self, seconds: float) -> dict:
        from bundlesdf_tpu_torch.utils import profiler

        profiler.reset()
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(self._next())
        window_s = time.perf_counter() - t0
        self.window_sessions = [dict(s, preds=list(s["preds"]), gt=list(s["gt"]))
                                for s in self.sessions]
        fails = sum(s["fails"] for s in self.window_sessions)
        return {"frames": len(lat), "latencies_s": lat, "window_s": window_s,
                "attempted": len(lat), "failed": fails, "failed_ids": list(self.fail_ids),
                "spans": profiler.stats()}

    def traced_slice(self) -> int:
        n = int(self.ctx.traffic["trace_frames"])
        with common.span_labels():
            for _ in range(n):
                self._next()
        return n

    def verify(self) -> list:
        checks = common.pose_checks(self.window_sessions, self.vid["model_pts"],
                                    self.ctx.limits)
        runner, self.runner, self.pipe = self.runner, None, None
        if runner is None:
            return checks
        params0, adam0 = common.snapshot(runner)
        pool = {"rays": runner.rays_np.copy(), "grid": runner.occ_grid.detach().cpu().clone(),
                "c2w": runner.c2w_np.copy()}
        cfg = dict(runner.cfg)
        first = common.first_steps(runner, FIRST_STEPS, self.nof_draws)
        runner = None
        common.free(self.ctx.device)
        checks += common.compare_first_steps(cfg, params0, adam0, pool, first, self.ctx.device,
                                             costs.microbatches(cfg), self.ctx.limits)
        return checks
