"""The traced slice: ``torch.profiler`` (CUPTI) over a few more steps or
frames at the end of a ``--trace 1`` run, reduced to what the per-layer
readers and the ``breakdown`` need.

- ``busy_s``: the union of the device's kernel, copy and set intervals;
- ``window_s``: the slice's wall time, host clock, closed by a synchronise,
  less the idle time spent in the profiler's own buffer flushes (its
  instrumentation, which an untraced run has not);
- ``kernels``: device seconds and calls by kernel name;
- ``device_ops``: the ten names with the most device time;
- ``idle_gaps``: the ten longest gaps between device intervals, each named
  by the innermost host operation open at its midpoint.
"""
from __future__ import annotations

import bisect
import time

import torch
from torch.profiler import ProfilerActivity, profile


FLUSH = "Buffer Flush"


def _is_device(e) -> bool:
    """A kernel, copy or set on the device (not the device-side shadow of a
    host range, which repeats the time of the work inside it)."""
    return "CUDA" in str(e.device_type) and not getattr(e, "is_user_annotation", False)


def run_traced(fn) -> dict:
    """Run ``fn()`` under the profiler and reduce its trace."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        units = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return reduce_events(prof.events(), window_s, units)


def reduce_events(events, window_s: float, units) -> dict:
    dev = sorted((e for e in events if _is_device(e)), key=lambda e: e.time_range.start)
    host = sorted((e for e in events if "CUDA" not in str(e.device_type)),
                  key=lambda e: e.time_range.start)
    kernels = {}
    busy_us = 0.0
    gaps = []
    cur_s = cur_e = None
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (t - s) * 1e-6
        k[1] += 1
        if cur_e is None:
            cur_s, cur_e = s, t
        elif s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    flushes = [(e.time_range.start, e.time_range.end) for e in host if e.name == FLUSH]
    flushed_us = sum(max(0.0, min(b, fe) - max(a, fs)) for _, a, b in gaps
                     for fs, fe in flushes if fs < b and fe > a)
    gaps.sort(reverse=True)
    starts = [e.time_range.start for e in host]
    named = []
    for length, a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        name = "host"
        best = None
        # the innermost host op open at the midpoint: the latest-starting one
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            e = host[i]
            if e.time_range.end >= mid:
                best = e
                break
            if mid - e.time_range.start > 5e6:   # no op opened 5 s before is open now
                break
        if best is not None:
            name = best.name
        named.append([name, length * 1e-6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"busy_s": busy_us * 1e-6, "window_s": window_s - flushed_us * 1e-6,
            "flush_idle_s": flushed_us * 1e-6, "units": units,
            "kernels": {k: {"seconds": v[0], "calls": v[1]} for k, v in kernels.items()},
            "device_ops": [[k, v[0]] for k, v in top[:10]],
            "idle_gaps": named}
