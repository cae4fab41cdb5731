"""Cache-gradient reduce of a bf16-staged dense hash-grid level: the
hand-written Hopper kernel ``csrc/reduce_cell_cache_grad.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``bundlesdf_tpu/ops/reduce_pallas.py::
reduce_cell_cache_grad_pallas`` (reached from the JAX ``_cell_bwd_impl``
through ``_reduce_cell_cache_grad_pallas_wrap``).  It maps the (R^3, 8C)
bf16 cache cotangent to the flat f32 table cotangent of the level.

Bound on the H100: memory — R^3*8C*2 bytes read + size*C*4 written
(84.3 MB at R=128, C=2: about 25 us at 3.35 TB/s).  A block owns a
TY x TZ tile of output (gy, gz) and marches along gx over a chunk of the
x range, with the input planes gx-1 and gx staged in shared memory by
16-byte ``cp.async`` (a ring of 3 planes).  Each thread sums its 8 corner
terms in f32 in ``_CORNERS`` order, so the kernel needs no atomics, is
deterministic and agrees bitwise with the plain version; it also writes the
aligned zero tail, so a call is one launch.  The launch geometry is
computed here (``launch_geometry``).  It covers every dense bf16 level
with C = 2: the JAX package's VMEM shape gate (``_pallas_reduce_shape_ok``)
is a TPU limit with no counterpart here.

Routing is by tensor device: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from . import _cuda_lib
from .hashgrid import _reduce_cell_cache_grad

# The kernel's compile-time tile (kTY, kTZ, kBufs in the .cu source).
TILE_Y = 8
TILE_Z = 32
PLANE_BUFS = 3
MAX_SMEM_BYTES = 232_448  # dynamic shared memory a block can use on sm_90

# Launches of the CUDA kernel since the last reset (the CPU path adds none);
# a replayed CUDA graph adds the launches its capture recorded
# (``_cuda_lib.add_launches``).
launches = 0


@functools.lru_cache(maxsize=None)
def launch_geometry(R: int, n_sm: int = 132) -> dict:
    """Grid of the reduce kernel for level resolution R on a card with
    ``n_sm`` SMs: (grid.x, grid.y, grid.z) = (gz tiles, gy tiles, x chunks),
    with the x range cut into chunks of ``x_chunk`` planes so that there are
    at least 2 blocks per SM where the level is large enough."""
    S = R + 1
    tiles_z = -(-S // TILE_Z)
    tiles_y = -(-S // TILE_Y)
    want = -(-2 * n_sm // (tiles_z * tiles_y))
    x_chunk = -(-S // min(want, S))
    grid = (tiles_z, tiles_y, -(-S // x_chunk))
    smem = PLANE_BUFS * (TILE_Y + 1) * (TILE_Z + 1) * 8 * 4
    return {"tile": (TILE_Y, TILE_Z), "x_chunk": x_chunk, "grid": grid,
            "threads": TILE_Y * TILE_Z, "smem_bytes": smem}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_kernel_args(d_cache: torch.Tensor, R: int, C: int, size: int,
                      out: torch.Tensor) -> None:
    """Raise unless the kernel takes these arguments: a contiguous
    (R^3, 8C) bf16 cache with C = 2, size >= (R+1)^3, and 16-byte aligned
    input and output."""
    if d_cache.dtype != torch.bfloat16:
        raise TypeError(f"d_cache must be bfloat16, got {d_cache.dtype}")
    if C != 2:
        raise ValueError(f"the reduce kernel takes C = 2, got {C}")
    if tuple(d_cache.shape) != (R ** 3, 8 * C):
        raise ValueError(f"d_cache shape {tuple(d_cache.shape)} != {(R ** 3, 8 * C)}")
    if not d_cache.is_contiguous():
        raise ValueError("d_cache must be contiguous")
    if size < (R + 1) ** 3:
        raise ValueError(f"size {size} < (R+1)^3 = {(R + 1) ** 3}")
    for name, t in (("d_cache", d_cache), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


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
    size = (R + 1) ** 3 if size is None else size
    dev = d_cache.device
    if dev.type == "cpu":
        return reduce_cell_cache_grad_plain(d_cache, R, C, size)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((size * C,), dtype=torch.float32, device=dev)
    check_kernel_args(d_cache, R, C, size, out)
    geo = launch_geometry(R, _sm_count(dev.index))
    _cuda_lib.launch(dev, "reduce_cell_cache_grad_bf16", d_cache.data_ptr(),
                     out.data_ptr(), R, C, size, geo["x_chunk"], *geo["grid"],
                     geo["smem_bytes"])
    launches += 1
    return out
