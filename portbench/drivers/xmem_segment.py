"""Window driver ``xmem_segment``: the XMem segmenter
(``io/segmentation.py::XmemSegmenter``, built by ``entry.build_segmenter``,
the entry point the pipeline takes it from) on sessions of the traffic's
video, called as ``BundleSdf.run`` calls it: ``step(color, mask)``, host
uint8 frames in, the mask read back every frame.

A session is the video's ``frames`` distinct frames, fed back to back from
a fresh memory, frame 0 with its true mask.  Set-up renders the frames
(``seg_frames.py``, on the device), draws the weights from the seed
(``reference/xmem.py::make_weights``) and loads them into the program, and
runs a throwaway session over the first ``warm_frames`` frames (past the
first consolidation).  The window holds whole sessions: it ends at the end
of the session in flight once ``--seconds`` have passed, so ``frame_ms`` is
a mean over whole sessions.  A frame whose step raises is counted in
``failed``.  After the window, untimed, a fresh session runs to the
traced slice's start: the traced slice is that session's last
``trace_frames`` frames, so the trace sees the memory at the sizes of a
session's end, as the window does on average, with a consolidation.

The check runs one more session through the same segmenter to its last
``check_frames`` frames (the session the window left, when no traced slice
ran past their start), then steps those frames teacher-forced: before
each, the plain reference (``reference/xmem.py::step``) is given the
program's own state (its counters, sensory memory and both stores, at the
sizes the window ran) and the same frame, and

- ``logit_gap``: the mask logits at 1/4 and after the x4 upsample, the
  relative L2 gap, the worst of the two and of the frames;
- ``readout_gap``: the memory readout, the same gap;
- ``value_gap``: a memory frame's new value, the same gap;
- ``hidden_gap``: the sensory memory the step leaves (the decoder's update
  or the deep update), the same gap;
- ``memory_gap``: the stores the step leaves, the program's against the
  reference's, store by store (long-term and working memory) and field by
  field (keys, shrinkage, selection, values, use counts), the same gap,
  the worst of them and of the frames: what a step writes (a memory
  frame's row, a consolidation's prototypes with their potentiated values
  and shrinkage, the compaction) and the use every read adds; a store
  whose element count differs reads 1.0;
- ``memory_mismatch``: exact: each store's element count after the step
  that differs, each prototype index that differs, each element evicted on
  one side alone, a consolidation or eviction on one side alone, and each
  element whose life count differs after the step;
- ``failed``: the window's frames that raised.

Logits and probabilities are compared, not masks: seeded weights leave
many pixels near 0.5.
"""
from __future__ import annotations

import sys
import time
import traceback

import torch

from .. import seg_frames
from ..reference import xmem as ref_xmem
from . import common


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _index_mismatch(got, want) -> int:
    """Positions that differ, or one side alone."""
    if got is None or want is None:
        return 0 if got is None and want is None else 1
    g, w = got.tolist(), want.tolist()
    return abs(len(g) - len(w)) + sum(a != b for a, b in zip(g, w))


def _set_mismatch(got, want) -> int:
    if got is None or want is None:
        return 0 if got is None and want is None else 1
    return len(set(got.tolist()) ^ set(want.tolist()))


def _fields(store) -> dict:
    """A store's fields that hold elements (an empty store has none)."""
    if store is None or store.get("k") is None or not store["k"].shape[1]:
        return {}
    return {k: v for k, v in store.items() if v is not None}


def _stores(got: dict, want: dict) -> tuple:
    """-> (the worst gap of the stores' fields but life, the life counts
    that differ): the program's state after a step against the
    reference's."""
    gap, life = 0.0, 0
    for name in ("lt", "wm"):
        g, w = _fields(got.get(name)), _fields(want.get(name))
        if set(g) != set(w) or any(g[f].shape != w[f].shape for f in g):
            gap = max(gap, 1.0)
            continue
        for f in g:
            if f == "life":
                life += int((g[f] != w[f]).sum())
            else:
                gap = max(gap, _gap(g[f], w[f]))
    return gap, life


class Cell:
    def __init__(self, ctx):
        from bundlesdf_tpu_torch import entry
        from bundlesdf_tpu_torch.models import xmem

        self.ctx = ctx
        t = ctx.traffic
        self.w = dict(ctx.config["xmem"])
        if self.w["deep_update_every"] != -1:
            raise ValueError("the program's deep update runs with the memory frames (-1)")
        self.cfg = xmem.XmemCfg(**{k: self.w[k] for k in xmem.XmemCfg._fields})
        vid = seg_frames.make_frames(t, ctx.seed, ctx.device)
        self.colors, self.mask0 = vid["colors"], vid["mask0"]
        self.n = len(self.colors)
        sd = ref_xmem.make_weights(ctx.seed, self.w)
        self.sd = {k: v.to(ctx.device) for k, v in sd.items()}
        self.seg = entry.build_segmenter(self.cfg, device=ctx.device, state_dict=sd)
        self.failed = 0
        self._session(min(int(t["warm_frames"]), self.n))
        common.sync(ctx.device)
        self.failed = 0
        self.trace_n = min(int(t["trace_frames"]), self.n)

    def _frame(self, k: int):
        mask = self.mask0 if k == 0 else None
        try:
            self.seg.step(self.colors[k], mask)
        except Exception:   # a frame whose step raised: counted, and the run goes on
            self.failed += 1
            traceback.print_exc(file=sys.stderr)

    def _session(self, frames: int) -> None:
        self.seg.reset()
        for k in range(frames):
            self._frame(k)

    def _advance(self, frames: int) -> None:
        """Go on with the session in flight to its first ``frames`` frames,
        or start a fresh one if it is past them."""
        done = self.seg.core.ti + 1
        if done > frames:
            self._session(frames)
            return
        for k in range(done, frames):
            self._frame(k)

    def window(self, seconds: float) -> dict:
        from bundlesdf_tpu_torch.utils import profiler

        profiler.reset()
        sessions = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._session(self.n)
            sessions += 1
        window_s = time.perf_counter() - t0
        self.window_failed = self.failed
        frames = sessions * self.n
        record = {"frames": frames, "sessions": sessions, "window_s": window_s,
                  "attempted": frames, "failed": self.failed, "spans": profiler.stats()}
        self._session(self.n - self.trace_n)
        return record

    def traced_slice(self) -> int:
        """The last ``trace_frames`` frames of the session ``window`` left."""
        self._advance(self.n - self.trace_n)
        with common.span_labels():
            for k in range(self.n - self.trace_n, self.n):
                self._frame(k)
        return self.trace_n

    def numbers(self, precision: str = "ref") -> dict:
        """The check's numbers over a fresh session's last ``check_frames``
        frames, the reference at ``precision``, and each frame's readings."""
        core = self.seg.core
        c = min(int(self.ctx.traffic["check_frames"]), self.n)
        self._advance(self.n - c)
        dev = self.ctx.device
        nums = {"logit_gap": 0.0, "readout_gap": 0.0, "value_gap": 0.0, "hidden_gap": 0.0,
                "memory_gap": 0.0, "memory_mismatch": 0.0}
        frames = []
        for k in range(self.n - c, self.n):
            state = core.state()
            mask = self.mask0 if k == 0 else None
            x, m, _ = ref_xmem.prepare(torch.as_tensor(self.colors[k]).to(dev), self.cfg.size,
                                       None if mask is None else torch.as_tensor(mask))
            ref = ref_xmem.step(self.sd, state, x, m, self.w, precision)
            del state
            self.seg.step(self.colors[k], mask)
            got, mem = core.last, core.memory
            row = {"frame": k, "n_lt": mem.n_lt, "n_wm": mem.n_wm}
            if "logits" in ref:
                row["logit_gap"] = max(_gap(got["logits4"], ref["logits4"]),
                                       _gap(got["logits"], ref["logits"]))
                row["readout_gap"] = _gap(got["readout"], ref["readout"])
            if "value" in ref:
                row["value_gap"] = _gap(got["value"], ref["value"])
            row["hidden_gap"] = _gap(got["hidden"], ref["state"]["hidden"])
            row["memory_gap"], life = _stores(core.state(), ref["state"])
            row["memory_mismatch"] = (
                (mem.n_lt != ref["n_lt"]) + (mem.n_wm != ref["n_wm"])
                + _index_mismatch(got.get("prototypes"), ref["prototypes"])
                + _set_mismatch(got.get("evicted"), ref["evicted"]) + life)
            for name in nums:
                if name in row:
                    nums[name] = (nums[name] + row[name] if name == "memory_mismatch"
                                  else max(nums[name], row[name]))
            frames.append(row)
            del ref
        common.free(dev)
        return {**nums, "frames": frames}

    def verify(self) -> list:
        nums = self.numbers()
        nums["failed"] = float(self.window_failed)
        for row in nums.pop("frames"):
            print(f"portbench: xmem frame {row}", file=sys.stderr)
        limits = self.ctx.limits
        return [{"name": k, "value": float(v), "limit": float(limits[k])}
                for k, v in nums.items() if k in limits]
