"""Fused multi-level cache scatter-add for the small dense hash-grid levels:
the hand-written Hopper kernel ``csrc/fused_cache_scatter.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``bundlesdf_tpu/ops/hashgrid_pallas.py::
fused_cache_scatter``, reached from the backward of the cell-layout encode
under ``hash_scatter: pallas`` for levels with R^3 <= ``_PALLAS_FUSE_ROWS``
(level 0, R=16, at the online budget).

Bound on the H100: memory on paper — the (N,) int32 indices and (N, F)
f32 updates read once and the accumulators written once (27 MB at
N = 393,216, F = 16: about 8 us at 3.35 TB/s); the likely real limit is L2
atomic throughput (6.3 M float atomics into 65,536 addresses).  The kernel
runs one thread per (level, update row, column) doing a float atomicAdd
into a zeroed global accumulator (256 KB, L2-resident); all levels share
one launch.  Summation order is nondeterministic (atomics), so the kernel
agrees with the plain version to f32 rounding, not bitwise.

Routing is by tensor device: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda_lib

MAX_LEVELS = 8  # FCS_MAX_LEVELS in csrc/fused_cache_scatter.cu

# Launches of the CUDA kernel since the last reset (the CPU path adds none).
launches = 0


def fused_cache_scatter_plain(cells: list, d_rows: list, rows_list: list) -> list:
    """Plain PyTorch version: one ``index_add_`` per level into a fresh
    f32 (rows, F) accumulator."""
    return [torch.zeros((int(r), u.shape[1]), dtype=torch.float32,
                        device=u.device).index_add_(0, c, u)
            for c, u, r in zip(cells, d_rows, rows_list)]


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
    if len(cells) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels per launch, got {len(cells)}")
    n, width = d_rows[0].shape
    for c, u in zip(cells, d_rows):
        if c.device != dev or u.device != dev:
            raise ValueError("all tensors must be on one device")
        if c.dtype != torch.int32 or u.dtype != torch.float32:
            raise TypeError(f"need int32 cells and float32 rows, got {c.dtype}, {u.dtype}")
        if tuple(c.shape) != (n,) or tuple(u.shape) != (n, width):
            raise ValueError("every level needs (N,) cells and (N, F) rows of one N, F")
        if not (c.is_contiguous() and u.is_contiguous()):
            raise ValueError("cells and rows must be contiguous")
    lib = _cuda_lib.load()
    rows = [int(r) for r in rows_list]
    # one zeroed buffer for all accumulators: a single memset
    acc = torch.zeros((sum(rows) * width,), dtype=torch.float32, device=dev)
    outs = list(torch.split(acc, [r * width for r in rows]))
    k = len(cells)
    ptrs = ctypes.c_void_p * k
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fused_cache_scatter_f32(
            ptrs(*[c.data_ptr() for c in cells]),
            ptrs(*[u.data_ptr() for u in d_rows]),
            ptrs(*[o.data_ptr() for o in outs]),
            (ctypes.c_int64 * k)(*rows), k, n, width, stream)
    _cuda_lib.check(rc, "fused_cache_scatter_f32")
    launches += 1
    return [o.view(r, width) for o, r in zip(outs, rows)]

