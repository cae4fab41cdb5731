"""Lightweight span profiler (the framework's tracing subsystem); the
port's own copy of ``bundlesdf_tpu/utils/profiler.py``.

The reference's timing story is ad-hoc (CUDATimer behind TIMER=0,
CMakeLists.txt:32; wall-clock printfs in SBA.cu:195-198).  Here: named
span accumulation with negligible overhead, a context manager / decorator
API, and periodic log dumps.  Spans nest; device work should be fenced by
the caller (torch.cuda.synchronize) if they want device-inclusive times.

Usage:
    from bundlesdf_tpu_torch.utils.profiler import span, report
    with span("track/ba"):
        ...
    print(report())
"""
from __future__ import annotations

import collections
import contextlib
import time

_STATS: dict[str, list] = collections.defaultdict(lambda: [0, 0.0, 0.0])
# name -> [count, total_s, max_s]
_ENABLED = True


def enable(on: bool = True):
    """Switch recording on or off: while off, ``span`` and ``count``
    record nothing."""
    global _ENABLED
    _ENABLED = on


def reset():
    _STATS.clear()


@contextlib.contextmanager
def span(name: str):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        s = _STATS[name]
        s[0] += 1
        s[1] += dt
        s[2] = max(s[2], dt)


def count(name: str, n: int = 1):
    """Event counter sharing the span table (count column; zero time).
    Used for launches/readbacks-per-frame accounting: the per-frame device choreography is judged by how many dispatches and
    blocking readbacks the host issues, not only by wall time."""
    if not _ENABLED:
        return
    _STATS[name][0] += n


def stats() -> dict[str, dict]:
    return {
        k: {"count": v[0], "total_s": v[1], "mean_s": v[1] / max(v[0], 1),
            "max_s": v[2]}
        for k, v in _STATS.items()
    }


def report(min_total: float = 0.0) -> str:
    rows = sorted(stats().items(), key=lambda kv: -kv[1]["total_s"])
    lines = [f"{'span':<40} {'count':>6} {'total':>9} {'mean':>8} {'max':>8}"]
    for name, s in rows:
        if s["total_s"] < min_total:
            continue
        lines.append(
            f"{name:<40} {s['count']:>6} {s['total_s']:>8.2f}s "
            f"{s['mean_s']*1000:>6.1f}ms {s['max_s']*1000:>6.1f}ms"
        )
    return "\n".join(lines)
