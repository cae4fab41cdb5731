"""Lightweight span profiler (the framework's tracing subsystem); the
port's own copy of ``bundlesdf_tpu/utils/profiler.py``.

The reference's timing story is ad-hoc (CUDATimer behind TIMER=0,
CMakeLists.txt:32; wall-clock printfs in SBA.cu:195-198).  Here: named
span accumulation with negligible overhead, a context manager / decorator
API, and periodic log dumps.  Device work should be fenced by the caller
(torch.cuda.synchronize) if they want device-inclusive times.

Spans form a tree: each thread keeps a stack of its open spans, and a
closing span adds its duration to its parent's child time.  ``stats()``
gives, per name, ``self_s`` (the total less the time its direct children
cover) and ``parents`` (parent name -> count; ``None`` for a root), and
``report()`` prints the tree.  While a ``torch.profiler`` session records,
each span also opens a ``record_function`` range of its name, so that the
program's spans lie on the device trace's clock (``prof.events()``,
``export_chrome_trace``); with no session that costs one attribute read.

Usage:
    from bundlesdf_tpu_torch.utils.profiler import span, report
    with span("track/ba"):
        ...
    print(report())
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_STATS: dict[str, list] = collections.defaultdict(lambda: [0, 0.0, 0.0, 0.0, {}])
# name -> [count, total_s, max_s, child_s, {parent name or None: count}]
_LOCK = threading.Lock()
_LOCAL = threading.local()     # .stack: this thread's open spans
_ENABLED = True


def enable(on: bool = True):
    """Switch recording on or off: while off, ``span`` and ``count``
    record nothing."""
    global _ENABLED
    _ENABLED = on


def recording() -> bool:
    """Whether ``span`` and ``count`` record (``enable``)."""
    return _ENABLED


def reset():
    with _LOCK:
        _STATS.clear()


class span(contextlib.ContextDecorator):
    """Time the body under ``name``, as a child of the innermost span open
    on this thread."""

    def __init__(self, name: str):
        self.name = name

    def _recreate_cm(self):
        # a fresh span for each call of a decorated function
        return span(self.name)

    def __enter__(self):
        if not _ENABLED:
            self._t0 = None
            return self
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self._parent = stack[-1] if stack else None
        self._child = 0.0
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        _LOCAL.stack.pop()
        parent = self._parent
        if parent is not None:
            parent._child += dt
        key = None if parent is None else parent.name
        with _LOCK:
            s = _STATS[self.name]
            s[0] += 1
            s[1] += dt
            s[2] = max(s[2], dt)
            s[3] += self._child
            s[4][key] = s[4].get(key, 0) + 1
        return False


def count(name: str, n: int = 1):
    """Event counter sharing the span table (count column; zero time).
    Used for launches/readbacks-per-frame accounting: the per-frame device choreography is judged by how many dispatches and
    blocking readbacks the host issues, not only by wall time."""
    if not _ENABLED:
        return
    with _LOCK:
        _STATS[name][0] += n


def stats() -> dict[str, dict]:
    with _LOCK:
        return {
            k: {"count": v[0], "total_s": v[1], "mean_s": v[1] / max(v[0], 1),
                "max_s": v[2], "self_s": max(0.0, v[1] - v[3]), "parents": dict(v[4])}
            for k, v in _STATS.items()
        }


def report(min_total: float = 0.0) -> str:
    """The span tree: each name once, under the parent it ran under most
    often, children by total time, with count, total, self, mean and max
    (a name's numbers are over all its parents)."""
    st = stats()
    kids = collections.defaultdict(list)
    for name, s in st.items():
        par = max(s["parents"].items(), key=lambda kv: kv[1])[0] if s["parents"] else None
        kids[par if par in st and par != name else None].append(name)
    lines = [f"{'span':<44} {'count':>6} {'total':>9} {'self':>9} {'mean':>8} {'max':>8}"]
    seen = set()

    def emit(name, depth):
        if name in seen:
            return
        seen.add(name)
        s = st[name]
        if s["total_s"] >= min_total:
            label = "  " * depth + name
            lines.append(
                f"{label:<44} {s['count']:>6} {s['total_s']:>8.2f}s {s['self_s']:>8.2f}s "
                f"{s['mean_s']*1000:>6.1f}ms {s['max_s']*1000:>6.1f}ms"
            )
        for k in sorted(kids[name], key=lambda n: -st[n]["total_s"]):
            emit(k, depth + 1)

    for name in sorted(kids[None], key=lambda n: -st[n]["total_s"]):
        emit(name, 0)
    for name in sorted(st, key=lambda n: -st[n]["total_s"]):
        emit(name, 0)     # names whose parents only run under each other
    return "\n".join(lines)
