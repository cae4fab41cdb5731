"""Window driver ``match_window``: the tracker's correspondence path with
the configured engine (LoFTR in ``online_loftr``) on every frame of the
video, at the pairs the tracker matches, with poses from the truth.

For frame k of a session:

1. the tracker's own construction makes Frame k (``track/make_frame``:
   the depth percentile cut of ``BundleSdf.run``, then ``Frame``, the
   depth kernel on the card); its ``pose_in_model`` is the truth;
2. ``find_corres`` on the pair (k, k - 1), at batch 1: the reference pair
   of ``BundleSdf.process_new_frame``;
3. ``find_corres`` on the pairs that ``Bundler.get_feature_match_pairs``
   enumerates over the window of the last ``bundle.max_BA_frames`` frames
   (its covisibility gate, its skip of matched pairs): the new frame
   against the older ones, which the tracker's bucket pads to
   ``pair_batch``;
4. a frame that leaves the window is forgotten.

The window stands in for the BA set that ``select_keyframes_for_ba``
picks: the same set on the first 48 frames of the video, when every frame
is a keyframe; on the last 12, where the turn comes round, the program
ranks the first frames in by covisibility, and runs 8-12 fresh pairs where
the window runs 4-8, in the same bucket of 16.  Poses come from the truth
in place of the BA because seeded weights match nothing: a closed loop
would FAIL each frame after its reference pair.  The engine's device work
has fixed capacity, so it does not depend on the weights, which are drawn
from the seed (``reference/loftr.py::make_weights``) and loaded into the
program.

A session is the video once; the next starts with every frame forgotten
and the ids from 0.  Set-up runs a throwaway session over the first
``warm_frames`` frames (both batch sizes).  A frame's latency is the host
clock around steps 1-3, closed by a synchronise; a frame whose matching
raises is counted in ``failed``.

The check takes the engine's last call of each batch size in the window
(the module's own inputs and outputs, kept by reference, and the pairs it
carried) and holds the real pairs of each against the plain reference on
the same inputs and weights:

- ``conf_gap``: each pair's confidence matrix, the L2 norm of the
  difference over the reference's;
- ``valid_mismatch``: the valid matches, the upstream's count capped at the
  program's K;
- ``fine_gap_px``: the fine coordinates at the program's coarse ids, in px,
  where both cells' windows lie inside the fine map (the program clamps a
  window at the map's border, the upstream pads it with zeros, and the
  border removal keeps the upstream's matches away from there);
- ``topk_mismatch``: the program's selection at threshold 0 (the module
  run again on the same inputs, its threshold set to 0), ids in order,
  against the upstream's rule (``reference/loftr.py::coarse_matches``:
  border removal, mutual nearest, then by confidence, the first K) on the
  same confidence matrix, exact: seeded weights select nothing at the
  published threshold, and at 0 every mutual nearest cell pair counts;
- ``warp_gap``: each crop the engine ran against the plain warp of the raw
  frame (``reference/loftr.py::warp`` of the BT.601 grey image) by the
  pair's homographies (``tracking/corres.py::pair_homographies``), the
  largest difference in full-scale units;
- ``failed``.
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from .. import video as video_mod
from ..draws import ransac_draws
from ..reference import loftr as ref_loftr
from . import common

REF_BLOCK = 1   # pairs a reference block holds


class Recorder:
    """Wraps the engine module's ``forward`` and keeps, for each batch size,
    the inputs and outputs of its last inference call, with the real pairs
    that call carried (``pairs``, set before each call)."""

    def __init__(self, module):
        self.module = module
        self.forward = module.forward
        self.last = {}
        self.pairs = []
        module.forward = self

    def __call__(self, img0, img1, gt_ids=None):
        out = self.forward(img0, img1, gt_ids)
        if gt_ids is None:
            self.last[img0.shape[0]] = (img0, img1, out, self.pairs)
        return out

    def at_threshold(self, img0, img1, thr: float) -> dict:
        """The module's forward on ``img0``/``img1`` with its confidence
        threshold set to ``thr`` (restored afterwards), not recorded."""
        cfg = self.module.cfg
        self.module.cfg = cfg._replace(thr=thr)
        try:
            with torch.inference_mode():
                return self.forward(img0, img1)
        finally:
            self.module.cfg = cfg


def ranked(conf, Hc: int, Wc: int, border: int, K: int) -> list:
    """The upstream's matches at threshold 0 in each pair of ``conf``, by
    confidence (the lower cell first among equal scores), the first K:
    a list of (i, j) lists."""
    b, i, j, mconf = ref_loftr.coarse_matches(conf, Hc, Wc, 0.0, border)
    out = []
    for p in range(conf.shape[0]):
        sel = b == p
        order = torch.argsort(mconf[sel], descending=True, stable=True)[:K]
        out.append(list(zip(i[sel][order].tolist(), j[sel][order].tolist())))
    return out


def compare(sd: dict, widths: dict, recorder: Recorder, calls: dict, colors,
            precision: str = "ref") -> dict:
    """The check's numbers over ``calls`` (batch size -> the recorder's
    entry), the reference at ``precision``, and each pair's readings;
    ``colors``: the video's RGB frames, by frame id."""
    from bundlesdf_tpu_torch.tracking import corres

    nums = {"conf_gap": 0.0, "valid_mismatch": 0.0, "fine_gap_px": 0.0, "topk_mismatch": 0.0,
            "warp_gap": 0.0}
    pairs = []
    for B, (img0, img1, out, frames) in sorted(calls.items()):
        n = len(frames)
        i_ids, j_ids = out["i_ids"][:n], out["j_ids"][:n]
        ref = ref_loftr.forward(sd, img0[:n], img1[:n], widths, precision, (i_ids, j_ids),
                                REF_BLOCK)
        S, Wc = img0.shape[3], img0.shape[3] // 8
        K = i_ids.shape[1]
        inner = ((i_ids // Wc > 0) & (i_ids % Wc > 0) & (j_ids // Wc > 0) & (j_ids % Wc > 0))
        sel = recorder.at_threshold(img0[:n], img1[:n], 0.0)
        want = ranked(sel["conf_matrix"], img0.shape[2] // 8, Wc, widths["border_rm"], K)
        for p in range(n):
            conf, rc = out["conf_matrix"][p].double(), ref["conf"][p].double()
            gap = float((conf - rc).norm() / rc.norm().clamp(min=1e-30))
            mism = abs(int(out["valid"][p].sum()) - min(int(ref["counts"][p]), K))
            dev = (out["mkpts1"][p] - ref["mkpts1_f"][p]).abs().amax(-1)[inner[p]]
            fine = float(dev.max()) if dev.numel() else 0.0
            v = sel["valid"][p]
            got = list(zip(sel["i_ids"][p][v].tolist(), sel["j_ids"][p][v].tolist()))
            topk = abs(len(got) - len(want[p])) + sum(g != w for g, w in zip(got, want[p]))
            tfs = corres.pair_homographies(*frames[p], S)
            wgap = 0.0
            for img, f, tf in ((img0, frames[p][0], tfs[0]), (img1, frames[p][1], tfs[1])):
                plain = ref_loftr.warp(ref_loftr.gray(colors[f.id]).to(img.device), tf, S,
                                       precision) / 255.0
                crop = img[p, 0].double()
                wgap = max(wgap, float((crop - plain[:crop.shape[0], :crop.shape[1]])
                                       .abs().max()))
            pairs.append({"batch": B, "pair": p, "conf_gap": gap, "valid_mismatch": mism,
                          "fine_gap_px": fine, "topk_mismatch": topk, "warp_gap": wgap,
                          "valid": int(out["valid"][p].sum()), "valid_at_0": len(got),
                          "conf_max": float(rc.max())})
            nums["conf_gap"] = max(nums["conf_gap"], gap)
            nums["valid_mismatch"] += mism
            nums["fine_gap_px"] = max(nums["fine_gap_px"], fine)
            nums["topk_mismatch"] += topk
            nums["warp_gap"] = max(nums["warp_gap"], wgap)
        del ref, sel
    return {**nums, "pairs": pairs}


class Cell:
    def __init__(self, ctx):
        from bundlesdf_tpu_torch import entry
        from bundlesdf_tpu_torch.models import loftr

        self.ctx = ctx
        traffic = ctx.traffic
        self.vid = video_mod.make_video(traffic, ctx.seed)
        self.n = len(self.vid["colors"])
        self.cfg = common.track_config(ctx.config["track"], ctx.tmp)
        self.ransac = ransac_draws(ctx.seed)
        self.bundler = entry.build_tracker(self.cfg, device=ctx.device,
                                           ransac_draws=self.ransac).bundler
        engine = self.bundler.store.matcher
        if not isinstance(engine, loftr.LoftrMatcher):
            raise ValueError("the match window measures the LoFTR engine, not "
                             f"{self.cfg['feature_corres']['matcher']!r}")
        self.widths = dict(ref_loftr.CVPR_DS)
        got = {k: getattr(engine.cfg, k) for k in self.widths}
        got["block_dims"] = tuple(got["block_dims"])
        if got != self.widths:
            raise ValueError(f"the engine's widths {got} are not the published {self.widths}")
        self.sd = {k: v.to(ctx.device) for k, v in ref_loftr.make_weights(ctx.seed,
                                                                          self.widths).items()}
        loftr.load_weights(engine.module, self.sd)
        self.recorder = Recorder(engine.module)
        self.window_size = int(self.cfg["bundle"]["max_BA_frames"])
        self.frames, self.k, self.failed = [], 0, 0
        for _ in range(int(traffic["warm_frames"])):
            self._next()
        self._restart()
        common.sync(ctx.device)
        self.failed = 0
        self.checked = {}

    def _restart(self):
        for f in self.frames:
            self.bundler.forget_frame(f)
        self.frames, self.k = [], 0

    def _frame(self, k: int):
        """Frame k as ``BundleSdf.run`` makes it, at the true pose."""
        from bundlesdf_tpu_torch.tracking.frame import Frame
        from bundlesdf_tpu_torch.utils import profiler

        v = self.vid
        depth = np.asarray(v["depths"][k], dtype=np.float32).copy()
        mask = v["masks"][k]
        percentile = float(self.cfg["depth_processing"]["percentile"])
        if percentile < 100:
            valid = (depth >= 0.1) & (mask > 0)
            if valid.any():
                depth[depth >= np.percentile(depth[valid], percentile)] = 0
        with profiler.span("track/make_frame"):
            return Frame(v["colors"][k], depth, v["K"], k, f"{k:05d}", self.cfg,
                         pose_in_model=np.linalg.inv(v["gt"][k]).astype(np.float32),
                         fg_mask=mask, device=self.bundler.device)

    def _match(self, pairs: list, key: int):
        from bundlesdf_tpu_torch.tracking import corres

        self.recorder.pairs = list(pairs)
        corres.find_corres(self.bundler.store, pairs, self.cfg, key=key,
                           ransac_draws=self.ransac)

    def _next(self) -> float:
        """Frame k of the session (a fresh session when the video ran out);
        its latency in seconds."""
        if self.k == self.n:
            self._restart()
        k = self.k
        t0 = time.perf_counter()
        f = None
        try:
            f = self._frame(k)
            if self.frames:
                self._match([(f, self.frames[-1])], k)
                window = self.frames[-(self.window_size - 1):] + [f]
                pairs = self.bundler.get_feature_match_pairs(window)
                if pairs:
                    self._match(pairs, k)
        except Exception:   # a frame whose matching raised: counted, and the run goes on
            self.failed += 1
            traceback.print_exc(file=sys.stderr)
        common.sync(self.ctx.device)
        lat = time.perf_counter() - t0
        if f is not None:
            self.frames.append(f)
            if len(self.frames) > self.window_size:
                self.bundler.forget_frame(self.frames.pop(0))
        self.k += 1
        return lat

    def window(self, seconds: float) -> dict:
        from bundlesdf_tpu_torch.utils import profiler

        self._restart()
        profiler.reset()
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(self._next())
        window_s = time.perf_counter() - t0
        self.checked = dict(self.recorder.last)
        self.window_failed = self.failed
        return {"frames": len(lat), "latencies_s": lat, "window_s": window_s,
                "attempted": len(lat), "failed": self.failed, "spans": profiler.stats()}

    def traced_slice(self) -> int:
        n = int(self.ctx.traffic["trace_frames"])
        with common.span_labels():
            for _ in range(n):
                self._next()
        return n

    def numbers(self, precision: str = "ref") -> dict:
        nums = compare(self.sd, self.widths, self.recorder, self.checked, self.vid["colors"],
                       precision)
        common.free(self.ctx.device)
        return nums

    def verify(self) -> list:
        nums = self.numbers()
        nums["failed"] = float(self.window_failed)
        for p in nums.pop("pairs"):
            print(f"portbench: loftr pair {p}", file=sys.stderr)
        limits = self.ctx.limits
        return [{"name": k, "value": float(v), "limit": float(limits[k])}
                for k, v in nums.items() if k in limits]
