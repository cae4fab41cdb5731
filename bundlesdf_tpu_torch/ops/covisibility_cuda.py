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
as A goes up to the card once, into a copy in ``pack_maps``'s layout that
the tracker's frame pool (``tracking/device_pool.py``) owns.  The queries
(one 3 x 4 transform each) go up with zeroed counters in one copy; all of
it runs on the tracker's side stream (``utils/device.py``), so that a query
never waits behind NOF work on the current stream.

Routing: a CUDA device launches the kernel; any other device runs the twin
pair by pair.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..tracking.frame import compute_covisibility, relative_transform
from ..utils import profiler
from ..utils.device import side_stream, staging
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


def covisibilities(pairs, visible_angle_deg: float, pool) -> list:
    """``compute_covisibility(fa, fb, visible_angle_deg)`` of each (fa, fb)
    in ``pairs``, in order.  On a CUDA frame ``pool`` one kernel launch and
    one readback compute them over the A frames' copies in the pool
    (``launches`` counts it; the profiler's counters ``launch/covisibility``
    and ``readback/covisibility`` too); elsewhere the twin runs."""
    if pool.device.type != "cuda":
        return [compute_covisibility(fa, fb, visible_angle_deg) for fa, fb in pairs]
    profiler.count("launch/covisibility")
    profiler.count("readback/covisibility")
    return _run_kernel(pool, pairs, visible_angle_deg)


def _run_kernel(pool, pairs, visible_angle_deg: float) -> list:
    """The A frames' copies from ``pool``, then one launch over every pair
    and one readback."""
    groups: dict = {}            # A's id -> (A, indices of its pairs)
    for k, (fa, _) in enumerate(pairs):
        groups.setdefault(fa.id, (fa, []))[1].append(k)
    maps = pool.covisibility_maps([fa for fa, _ in groups.values()])
    order = [k for _, ks in groups.values() for k in ks]
    rel = np.stack([query_transform(*pairs[k]) for k in order])
    q_begin = np.cumsum([0] + [len(ks) for _, ks in groups.values()]).astype(np.int32)
    sizes = np.array([n_points(fa) for fa, _ in groups.values()], np.int32)
    counts, totals = _count(pool.device, maps, sizes, q_begin, rel,
                            threshold(visible_angle_deg))
    out = [0.0] * len(pairs)     # count / (total + 1e-7): the twin's float
    for g, (_, ks) in enumerate(groups.values()):
        total = int(totals[g]) + 1e-7
        for k, c in zip(ks, counts[q_begin[g]:q_begin[g + 1]]):
            out[k] = int(c) / total
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
    st = staging(dev, "covisibility_plan")
    buf = st.host(o["end"])
    host = buf.numpy()
    host[:o["np"]].view(np.int64)[:] = [t.data_ptr() for t in maps]
    host[o["np"]:o["qb"]].view(np.int32)[:] = sizes
    host[o["qb"]:o["qb"] + 4 * (G + 1)].view(np.int32)[:] = q_begin
    host[o["rel"]:o["out"]].view(np.float32)[:] = np.asarray(rel, np.float32).reshape(-1)
    host[o["out"]:o["end"]] = 0
    stream = side_stream(dev)
    with torch.cuda.stream(stream):
        plan = buf.to(stream.device, non_blocking=True)
        _launch(plan, G, Q, int(max(sizes)), thres)
        buf[o["out"]:].copy_(plan[o["out"]:], non_blocking=True)
        st.copied(stream)
    st.wait()
    out = host[o["out"]:o["end"]].view(np.uint32)
    return out[:Q].copy(), out[Q:].copy()


def _launch(plan: torch.Tensor, n_groups: int, n_queries: int, max_points: int,
            thres: float) -> None:
    """The kernel on the current stream over the uploaded ``plan``."""
    global launches
    o = _offsets(n_groups, n_queries)
    base = plan.data_ptr()
    _cuda_lib.launch(plan.device, "covisibility_count_f32", base, base + o["np"],
                     base + o["qb"], base + o["rel"], n_groups, max_points, thres,
                     base + o["out"], base + o["out"] + 4 * n_queries)
    launches += 1
