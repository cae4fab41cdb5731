"""Fused multi-level cache scatter-add for the small dense hash-grid levels:
the hand-written Hopper kernel ``csrc/fused_cache_scatter.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``bundlesdf_tpu/ops/hashgrid_pallas.py::
fused_cache_scatter``, reached from the backward of the cell-layout encode
under ``hash_scatter: pallas`` for levels with R^3 <= ``_PALLAS_FUSE_ROWS``
(level 0, R=16, at the online budget).

Bound on the H100: memory on paper — the (N,) int32 indices and (N, F)
f32 updates read once and the accumulators written once (27 MB at
N = 393,216, F = 16: about 8 us at 3.35 TB/s); the real limit is L2 atomic
throughput (N*F adds into rows*F addresses).  The kernel merges runs: a
group of F/4 lanes walks a contiguous span of update rows, carries a float4
sum per lane while the destination row repeats, and adds it with one vector
atomic (``atomicAdd(float4*)``) into an L2-resident accumulator, zeroed by
one memset in the same C call, when the row changes.  The train step's rows are ray-major, so runs are long.
All levels share one launch.  Summation order is nondeterministic
(atomics), so the kernel agrees with the plain version to f32 rounding, not
bitwise.

Routing is by tensor device: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _cuda_lib

MAX_LEVELS = 8  # FCS_MAX_LEVELS in csrc/fused_cache_scatter.cu

# Launches of the CUDA kernel since the last reset (the CPU path adds none);
# a replayed CUDA graph adds the launches its capture recorded
# (``_cuda_lib.add_launches``).
launches = 0

# Per-thread argument block of the C entry point (3 int64 per level),
# filled in place on each call.
_args = threading.local()


def fused_cache_scatter_plain(cells: list, d_rows: list, rows_list: list) -> list:
    """Plain PyTorch version: one ``index_add_`` per level into a fresh
    f32 (rows, F) accumulator."""
    return [torch.zeros((int(r), u.shape[1]), dtype=torch.float32,
                        device=u.device).index_add_(0, c, u)
            for c, u, r in zip(cells, d_rows, rows_list)]


def check_kernel_args(cells: list, d_rows: list, out: torch.Tensor) -> None:
    """Raise unless the kernel takes these arguments: at most MAX_LEVELS
    levels of contiguous (N,) int32 cells and (N, F) f32 rows of one N and
    F on one device, F a multiple of 4, and every pointer 16-byte aligned."""
    if len(cells) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels per launch, got {len(cells)}")
    n, width = d_rows[0].shape
    if n >= 2 ** 31:
        raise ValueError(f"the scatter kernel takes N < 2^31, got {n}")
    if width % 4:
        raise ValueError(f"the scatter kernel needs F % 4 == 0, got F = {width}")
    for c, u in zip(cells, d_rows):
        if c.device != out.device or u.device != out.device:
            raise ValueError("all tensors must be on one device")
        if c.dtype != torch.int32 or u.dtype != torch.float32:
            raise TypeError(f"need int32 cells and float32 rows, got {c.dtype}, {u.dtype}")
        if tuple(c.shape) != (n,) or tuple(u.shape) != (n, width):
            raise ValueError("every level needs (N,) cells and (N, F) rows of one N, F")
        if not (c.is_contiguous() and u.is_contiguous()):
            raise ValueError("cells and rows must be contiguous")
    for t in (*cells, *d_rows, out):
        if t.data_ptr() % 16:
            raise ValueError("every tensor must be 16-byte aligned")


def fused_cache_scatter(cells: list, d_rows: list, rows_list: list) -> list:
    """Scatter-add each (N, F) f32 ``d_rows[i]`` into a fresh
    (rows_list[i], F) f32 accumulator at row indices ``cells[i]`` (int32),
    all levels in ONE kernel launch.  Counts each launch in the module's
    ``launches``."""
    global launches
    if not (len(cells) == len(d_rows) == len(rows_list)) or not cells:
        raise ValueError("cells, d_rows and rows_list must be non-empty and "
                         "of equal length")
    dev = d_rows[0].device
    if dev.type == "cpu":
        return fused_cache_scatter_plain(cells, d_rows, rows_list)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, width = d_rows[0].shape
    rows = [int(r) for r in rows_list]
    # one buffer for all accumulators, back to back; the C entry point
    # zeroes it with one memset before the launch
    acc = torch.empty((sum(rows) * width,), dtype=torch.float32, device=dev)
    check_kernel_args(cells, d_rows, acc)
    k = len(cells)
    args = getattr(_args, "block", None)
    if args is None:
        args = _args.block = (ctypes.c_int64 * (3 * MAX_LEVELS))()
    for i in range(k):
        args[i] = cells[i].data_ptr()
        args[k + i] = d_rows[i].data_ptr()
        args[2 * k + i] = rows[i]
    _cuda_lib.launch(dev, "fused_cache_scatter_f32", args, acc.data_ptr(), k, n,
                     width)
    launches += 1
    outs, o = [], 0
    for r in rows:
        outs.append(acc[o:o + r * width].view(r, width))
        o += r * width
    return outs
