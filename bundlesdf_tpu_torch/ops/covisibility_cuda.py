"""The tracker's covisibility on the card: the hand-written kernel
``csrc/covisibility.cu`` and its host twin.

Replaces no TPU kernel.  The JAX tracker computes covisibility on the host
(``bundlesdf_tpu/tracking/frame.py::compute_covisibility``), one numpy call a
pair, and so does the port's on the CPU.  On a CUDA tracker one launch
counts a whole batch of pairs, and one readback brings back an integer count
a pair and an integer total of valid points a frame; the host forms each
ratio as the twin does, ``count / (total + 1e-7)``.  See the source for the
design and the numerics.

Bound on the H100: memory, 25 bytes a stride-2 point (xyz and normals in
f32, a keep byte), once a frame: 1.92 MB at 480 x 640.  Each frame queried
as A goes up to the card once: its stride-2 maps, as planes, through a
pinned staging buffer into a device copy that the caller keeps in
``resident`` (frame id -> (frame, version, tensor)) and frees.  A Frame's
``version`` changes with its maps, so a stale copy is uploaded again and
never read.  The queries (one 3 x 4 transform each) go up with zeroed
counters in one copy; everything runs on a side stream of this module's
own, so that a query never waits behind NOF work on the current stream.

Routing: a CUDA device launches the kernel; any other device runs the twin
pair by pair.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..tracking.frame import compute_covisibility, relative_transform
from ..utils import profiler
from . import _cuda_lib

# Bytes a stride-2 point takes on the card: six f32 planes, a keep byte.
POINT_BYTES = 25

# Launches of the CUDA kernel since the last reset (the twin adds none).
launches = 0


@functools.lru_cache(maxsize=None)
def threshold(visible_angle_deg: float) -> float:
    """The f32 value ``t`` such that ``dot > t`` for every f32 ``dot`` is
    what the twin's ``dots > np.cos(np.deg2rad(visible_angle_deg))`` gives:
    numpy compares the f32 dots in f32 or in f64 by its promotion rules, so
    ``t`` is found by numpy's own comparison of the f32 neighbours of the
    threshold."""
    thres = np.cos(np.deg2rad(visible_angle_deg))
    c = np.float32(thres)
    cands = np.array([np.nextafter(c, np.float32(-np.inf)), c,
                      np.nextafter(c, np.float32(np.inf))], np.float32)
    return float(cands[~(cands > thres)].max())


def n_points(frame) -> int:
    """Stride-2 points of ``frame``: the ones the twin reads."""
    h, w = frame.xyz[::2, ::2].shape[:2]
    return h * w


def pack_maps(frame, out: np.ndarray) -> None:
    """``frame``'s stride-2 maps into ``out`` (``POINT_BYTES`` bytes a
    point, uint8): the x, y, z, nx, ny, nz planes in f32, then the keep
    byte of ``valid & fg_mask``, the arrays the twin reads."""
    P = n_points(frame)
    planes = out[:24 * P].view(np.float32)
    np.copyto(planes[:3 * P].reshape(3, -1), frame.xyz[::2, ::2].reshape(-1, 3).T)
    np.copyto(planes[3 * P:].reshape(3, -1), frame.normals[::2, ::2].reshape(-1, 3).T)
    np.logical_and(frame.valid[::2, ::2], frame.fg_mask[::2, ::2],
                   out=out[24 * P:25 * P].view(np.bool_).reshape(frame.xyz[::2, ::2].shape[:2]))


def query_transform(fa, fb) -> np.ndarray:
    """The 12 f32 of a query: rel_R (row-major), rel_t, as the twin forms
    them from the two poses."""
    rel_R, rel_t = relative_transform(fa, fb)
    return np.concatenate([np.asarray(rel_R, np.float32).reshape(9),
                           np.asarray(rel_t, np.float32)])


def ratios(counts, totals, q_begin) -> list:
    """``count / (total + 1e-7)`` of each query, its slot's total, in the
    order of the queries: the twin's float."""
    out = []
    for g in range(len(totals)):
        total = int(totals[g]) + 1e-7
        out += [int(v) / total for v in counts[q_begin[g]:q_begin[g + 1]]]
    return out


def covisibilities(pairs, visible_angle_deg: float, device, resident: dict) -> list:
    """``compute_covisibility(fa, fb, visible_angle_deg)`` of each (fa, fb)
    in ``pairs``, in order.  On a CUDA ``device`` one kernel launch and one
    readback compute them (``launches`` counts it; the profiler's counters
    ``launch/covisibility`` and ``readback/covisibility`` too), with each
    A frame's device copy kept in ``resident``; elsewhere the twin runs."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [compute_covisibility(fa, fb, visible_angle_deg) for fa, fb in pairs]
    profiler.count("launch/covisibility")
    profiler.count("readback/covisibility")
    return _run_kernel(dev, pairs, visible_angle_deg, resident)


def _run_kernel(dev, pairs, visible_angle_deg: float, resident: dict) -> list:
    """Upload the A frames that have no fresh copy, then one launch over
    every pair and one readback."""
    groups: dict = {}            # A's id -> (A, indices of its pairs)
    for k, (fa, _) in enumerate(pairs):
        groups.setdefault(fa.id, (fa, []))[1].append(k)
    stale = []
    for fa, _ in groups.values():
        held = resident.get(fa.id)
        if held is None or held[0] is not fa or held[1] != fa.version:
            stale.append(fa)
    if stale:
        for fa, t in zip(stale, _device_maps(dev, stale)):
            resident[fa.id] = (fa, fa.version, t)
    order = [k for _, ks in groups.values() for k in ks]
    rel = np.stack([query_transform(*pairs[k]) for k in order])
    q_begin = np.cumsum([0] + [len(ks) for _, ks in groups.values()]).astype(np.int32)
    maps = [resident[i][2] for i in groups]
    sizes = np.array([n_points(fa) for fa, _ in groups.values()], np.int32)
    counts, totals = _count(dev, maps, sizes, q_begin, rel, threshold(visible_angle_deg))
    got = ratios(counts, totals, q_begin)
    out = [0.0] * len(pairs)
    for k, v in zip(order, got):
        out[k] = v
    return out


class _Stage:
    """One CUDA device's side stream, event and pinned and device buffers,
    grown as larger batches come."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.stream = torch.cuda.Stream(dev)
        self.done = torch.cuda.Event()
        self.staged = torch.cuda.Event()
        self.maps_host = torch.empty(0, dtype=torch.uint8, pin_memory=True)
        self.plan_host = torch.empty(0, dtype=torch.uint8, pin_memory=True)
        self.plan_dev = torch.empty(0, dtype=torch.uint8, device=dev)

    def ensure(self, maps_bytes: int, plan_bytes: int) -> None:
        if maps_bytes > self.maps_host.numel():
            self.maps_host = torch.empty(maps_bytes, dtype=torch.uint8, pin_memory=True)
        if plan_bytes > self.plan_host.numel():
            self.plan_host = torch.empty(plan_bytes, dtype=torch.uint8, pin_memory=True)
            self.plan_dev = torch.empty(plan_bytes, dtype=torch.uint8, device=self.dev)


@functools.lru_cache(maxsize=None)
def _stage(index: int) -> _Stage:
    return _Stage(torch.device("cuda", index))


def _stage_of(dev) -> _Stage:
    return _stage(dev.index if dev.index is not None else torch.cuda.current_device())


def _device_maps(dev, frames) -> list:
    """Each frame's packed stride-2 maps in a device tensor of its own, from
    one pinned staging buffer, enqueued on the side stream."""
    st = _stage_of(dev)
    sizes = [POINT_BYTES * n_points(f) for f in frames]
    st.staged.synchronize()      # the last batch's copies have left the staging buffer
    st.ensure(sum(sizes), 0)
    host = st.maps_host.numpy()
    out, a = [], 0
    with torch.cuda.stream(st.stream):
        for f, n in zip(frames, sizes):
            pack_maps(f, host[a:a + n])
            t = torch.empty(n, dtype=torch.uint8, device=st.dev)
            t.copy_(st.maps_host[a:a + n], non_blocking=True)
            out.append(t)
            a += n
        st.staged.record(st.stream)
    return out


def _offsets(n_groups: int, n_queries: int) -> dict:
    """Byte offsets in the plan buffer: the slots' map pointers (int64),
    point counts and query starts (int32), the queries' transforms (f32),
    then the counters (uint32, a query's, then a slot's), and its end."""
    o = {"np": 8 * n_groups}
    o["qb"] = o["np"] + 4 * n_groups
    o["rel"] = (o["qb"] + 4 * (n_groups + 1) + 15) // 16 * 16
    o["out"] = o["rel"] + 48 * n_queries
    o["end"] = o["out"] + 4 * (n_queries + n_groups)
    return o


def _count(dev, maps, sizes, q_begin, rel, thres: float):
    """The kernel over ``maps`` (one device tensor a slot) and ``rel`` (12
    floats a query, slot by slot as ``q_begin`` cuts them): (counts, totals)
    as host uint32 arrays.  One upload of the plan with zeroed counters,
    one launch, one readback, on the side stream."""
    G, Q = len(maps), len(rel)
    o = _offsets(G, Q)
    st = _stage_of(dev)
    st.ensure(0, o["end"])
    host = st.plan_host.numpy()
    host[:o["np"]].view(np.int64)[:] = [t.data_ptr() for t in maps]
    host[o["np"]:o["qb"]].view(np.int32)[:] = sizes
    host[o["qb"]:o["qb"] + 4 * (G + 1)].view(np.int32)[:] = q_begin
    host[o["rel"]:o["out"]].view(np.float32)[:] = np.asarray(rel, np.float32).reshape(-1)
    host[o["out"]:o["end"]] = 0
    with torch.cuda.stream(st.stream):
        st.plan_dev[:o["end"]].copy_(st.plan_host[:o["end"]], non_blocking=True)
        _launch(st, G, Q, int(max(sizes)), thres)
        st.plan_host[o["out"]:o["end"]].copy_(st.plan_dev[o["out"]:o["end"]],
                                              non_blocking=True)
        st.done.record(st.stream)
    st.done.synchronize()
    out = host[o["out"]:o["end"]].view(np.uint32)
    return out[:Q].copy(), out[Q:].copy()


def _launch(st: _Stage, n_groups: int, n_queries: int, max_points: int, thres: float) -> None:
    """The kernel on the current stream over ``st``'s uploaded plan."""
    global launches
    o = _offsets(n_groups, n_queries)
    base = st.plan_dev.data_ptr()
    _cuda_lib.launch(st.dev, "covisibility_count_f32", base, base + o["np"], base + o["qb"],
                     base + o["rel"], n_groups, max_points, thres, base + o["out"],
                     base + o["out"] + 4 * n_queries)
    launches += 1
