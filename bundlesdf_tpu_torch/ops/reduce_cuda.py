"""Cache-gradient reduce of a bf16-staged dense hash-grid level: the
hand-written Hopper kernel ``csrc/reduce_cell_cache_grad.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``bundlesdf_tpu/ops/reduce_pallas.py::
reduce_cell_cache_grad_pallas`` (reached from the JAX ``_cell_bwd_impl``
through ``_reduce_cell_cache_grad_pallas_wrap``).  It maps the (R^3, 8C)
bf16 cache cotangent to the flat f32 table cotangent of the level.

Bound on the H100: memory — R^3*8C*2 bytes read + S^3*C*4 written
(84.3 MB at R=128, C=2: about 25 us at 3.35 TB/s).  The kernel is
output-stationary: one thread per table entry sums its at most 8 bf16
inputs in f32 in ``_CORNERS`` order and writes once, so it needs no
atomics, is deterministic, and agrees bitwise with the plain version.  It
covers every dense bf16 level: the JAX package's VMEM shape gate
(``_pallas_reduce_shape_ok``) is a TPU limit with no counterpart here.

Routing is by tensor device: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _cuda_lib
from .hashgrid import _reduce_cell_cache_grad

# Launches of the CUDA kernel since the last reset (the CPU path adds none).
launches = 0


def reduce_cell_cache_grad_plain(d_cache: torch.Tensor, R: int, C: int,
                                 size: int | None = None) -> torch.Tensor:
    """Plain PyTorch reduce: shifted adds in f32 (``hashgrid.
    _reduce_cell_cache_grad``).  Output (size*C,) f32, size >= (R+1)^3
    (zero tail), default (R+1)^3."""
    S = R + 1
    p = {"res": R, "size": S ** 3 if size is None else size}
    return _reduce_cell_cache_grad(d_cache, p, C)


def reduce_cell_cache_grad(d_cache: torch.Tensor, R: int, C: int,
                           size: int | None = None) -> torch.Tensor:
    """(R^3, 8*C) bf16 grad cache -> (size*C,) f32 flat table cotangent.

    ``size`` (entries, >= (R+1)^3, default (R+1)^3) pads the output with
    zeros to the level's aligned table size.  Counts each kernel launch in
    the module's ``launches``."""
    global launches
    S = R + 1
    size = S ** 3 if size is None else size
    if d_cache.device.type == "cpu":
        return reduce_cell_cache_grad_plain(d_cache, R, C, size)
    if d_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {d_cache.device}")
    if d_cache.dtype != torch.bfloat16:
        raise TypeError(f"d_cache must be bfloat16, got {d_cache.dtype}")
    if tuple(d_cache.shape) != (R ** 3, 8 * C):
        raise ValueError(f"d_cache shape {tuple(d_cache.shape)} != {(R ** 3, 8 * C)}")
    if not d_cache.is_contiguous():
        raise ValueError("d_cache must be contiguous")
    if size < S ** 3:
        raise ValueError(f"size {size} < (R+1)^3 = {S ** 3}")
    lib = _cuda_lib.load()
    out = torch.empty((size * C,), dtype=torch.float32, device=d_cache.device)
    out[S ** 3 * C:].zero_()
    stream = torch.cuda.current_stream(d_cache.device).cuda_stream
    with torch.cuda.device(d_cache.device):
        rc = lib.reduce_cell_cache_grad_bf16(d_cache.data_ptr(), out.data_ptr(),
                                             R, C, stream)
    _cuda_lib.check(rc, "reduce_cell_cache_grad_bf16")
    launches += 1
    return out

