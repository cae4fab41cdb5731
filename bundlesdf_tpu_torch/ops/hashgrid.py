"""Multiresolution hash-grid positional encoder (port of
``bundlesdf_tpu/ops/hashgrid.py``).

Same scheme as the JAX module and the reference kernel
(gridencoder.cu:155-190): per-level scale ``exp2(level*log2(pls))*base - 1``,
resolution ``ceil(scale) + 1``, ``pos = x01*scale + 0.5``, dense row-major
index when ``(res+1)^3`` fits the table, else the spatial hash with primes
{1, 2654435761, 805459861}; trilinear blend of 8 corners, levels
concatenated.  The table is one flat ``(total_entries * level_dim,)`` f32
tensor with static per-level offsets.

Two layouts, as in the JAX module (``spec.layout``):
  * ``exact`` (``hash_encode``): the reference's algorithm, 8 corner
    element gathers per level and channel; the backward is one flat
    ``index_add_`` of N * 8 * L * C elements.  Plain torch on every device:
    the JAX module writes it in XLA, with no Pallas kernel.
  * ``cell``: for a DENSE level the 8 corners of every cell are 8 shifted
    slices of the level's (S, S, S, C) view, so a corner-duplicated
    (R^3, 8C) cache is built with dense copies and each point gathers ONE
    8C-wide row; the backward scatters one row per point into a
    cache-shaped gradient and reduces it back to the table with 8 shifted
    adds (``_reduce_cell_cache_grad``, the transpose of
    ``_build_cell_cache``).  Hashed levels take the element path (8 window
    gathers, a flat element scatter).  Big dense levels (>= 2^18 cells) may
    stage their cache and gradient cache in bf16 (``big_dtype``); the table,
    its gradient and the optimizer state stay f32.

The two TPU (Pallas) kernels of the cell layout's backward have
hand-written CUDA counterparts, selected by the spec knobs that keep their
JAX names:
  * ``reduce="pallas"``  -> ``ops/reduce_cuda.py``: the bf16 cache-grad
    reduce of big dense levels;
  * ``scatter="pallas"`` -> ``ops/hashgrid_cuda.py``: one fused atomic
    scatter for all small dense levels (R^3 <= ``_PALLAS_FUSE_ROWS``).
Each wrapper runs its plain PyTorch version for a CPU tensor.

``scatter="seg"`` is the JAX module's segment-dedup path (``_seg_*``, the
JAX package's default): on ray-structured batches (``encode(..., n_rays)``,
each ray's samples contiguous and z-ordered) the backward pre-sums each run
of equal cells along a ray with a segmented scan and scatters one row per
run, and dense levels whose cache exceeds ``_SEG_GATHER_BYTES`` gather one
row per run in the forward.  A static per-ray run cap bounds the compact
buffers; where any ray of a level has more runs, the direct per-sample path
is taken.  JAX makes that choice with ``lax.cond``; here it is a device
bool and both branches are computed and combined with ``torch.where``, so
the step holds no host sync and captures into a CUDA graph.  It is an XLA
rewrite of the same sums (no Pallas kernel behind it), so it is plain
torch; the bf16 levels' cache gradient still reduces through the CUDA
reduce kernel.

Both custom backwards are differentiable once more (the eikonal loss
differentiates the normals, i.e. the coordinate cotangent): under
``create_graph`` they compute the coordinate cotangent with recorded torch
ops from rows gathered again from the table, and the table cotangent
(scatters and kernels) without a graph.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)


class HashGridSpec(NamedTuple):
    """Static hash-grid geometry (same fields and defaults as the JAX spec)."""

    num_levels: int
    level_dim: int
    base_res: int
    finest_res: int
    log2_hashmap_size: int
    # "exact" (hash_encode) or "cell" (hash_encode_cell).
    layout: str = "exact"
    # "xla": per-level index_add_ row scatters in the cell backward.
    # "pallas": the fused CUDA scatter for small dense levels
    #           (ops/hashgrid_cuda.py).
    # "seg": segment-dedup scatters and two-stage run gathers on
    #        ray-structured batches (encode(..., n_rays)).  Use
    #        resolve_scatter().
    scatter: str = "xla"
    # Staging dtype for BIG dense levels (>= _BIG_CACHE_CELLS cells).
    big_dtype: str = "float32"
    # Cache-grad reduce for bf16-staged big levels: "conv" = the plain
    # shifted-add reduce; "pallas" = the CUDA kernel (ops/reduce_cuda.py).
    # Use resolve_reduce().
    reduce: str = "conv"

    @property
    def per_level_scale(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(
            np.exp2(np.log2(self.finest_res / self.base_res) / (self.num_levels - 1))
        )

    def level_params(self):
        """Per-level (scale, resolution, table_size, offset, dense?)."""
        hashmap_size = 1 << self.log2_hashmap_size
        out = []
        offset = 0
        S = np.log2(self.per_level_scale)
        for lv in range(self.num_levels):
            scale = float(np.exp2(lv * S) * self.base_res - 1.0)
            res = int(np.ceil(scale)) + 1
            dense_size = (res + 1) ** 3
            size = min(dense_size, hashmap_size)
            # align to 8 like the reference for hardware-friendly strides
            size = int(np.ceil(size / 8)) * 8
            dense = dense_size <= hashmap_size
            out.append(dict(scale=scale, res=res, size=size, offset=offset, dense=dense))
            offset += size
        return out

    @property
    def total_entries(self) -> int:
        return sum(p["size"] for p in self.level_params())

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.level_dim


def init_table(spec: HashGridSpec, generator: torch.Generator | None = None,
               device=None, dtype=torch.float32) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) init like the reference grid.py reset_parameters.
    Flat 1-D, (total_entries * level_dim,): entry e's features at
    [e*C : (e+1)*C]."""
    n = spec.total_entries * spec.level_dim
    u = torch.rand(n, generator=generator, device=device, dtype=dtype)
    return u * 2e-4 - 1e-4


# 8 corner offsets of the trilinear cell, static (i, j, k lexicographic).
_CORNERS = np.array(
    [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], dtype=np.int32
)

# Dense levels at or above this CELL count stage through spec.big_dtype
# (R=64 and R=128 at the online budget).
_BIG_CACHE_CELLS = 1 << 18

# Dense levels at or below this row count scatter through the fused kernel
# when spec.scatter == "pallas".  The value is the JAX package's VMEM gate
# (a TPU constant); it is kept so the same levels take the same path, and
# is to be revisited on the card (ROADMAP.md).
_PALLAS_FUSE_ROWS = 1 << 12


def _lvl_dtype(spec: HashGridSpec, p) -> torch.dtype:
    """Staging dtype for one level's cache / grad-cache."""
    if (spec.big_dtype == "bfloat16" and p["dense"]
            and p["res"] ** 3 >= _BIG_CACHE_CELLS):
        return torch.bfloat16
    return torch.float32


def _level_views(table: torch.Tensor, spec: HashGridSpec):
    """Split the flat table into per-level flat (size*C,) views."""
    C = spec.level_dim
    return [table[p["offset"] * C:(p["offset"] + p["size"]) * C]
            for p in spec.level_params()]


def _build_cell_cache(level_table: torch.Tensor, p, C: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Dense level (size*C,) flat view -> (res^3, 8*C) corner cache.

    Pure dense copies: column ci*C + ch holds corner ci (``_CORNERS``
    order) channel ch.  Each corner slice is copied straight into its
    column block in the staging dtype, so no f32 temp of the whole cache
    exists."""
    S = p["res"] + 1
    R = p["res"]
    t4 = level_table[:S * S * S * C].view(S, S, S, C)
    cache = torch.empty((R, R, R, 8, C), dtype=dtype, device=level_table.device)
    for ci, c in enumerate(_CORNERS):
        cx, cy, cz = (int(v) for v in c)
        cache[:, :, :, ci].copy_(t4[cx:cx + R, cy:cy + R, cz:cz + R])
    return cache.view(R * R * R, 8 * C)


def _reduce_cell_cache_grad(d_cache: torch.Tensor, p, C: int) -> torch.Tensor:
    """(res^3, 8*C) cache cotangent -> flat (size*C,) f32 table cotangent:
    the transpose of ``_build_cell_cache``,
    ``out[(x+cx, y+cy, z+cz), ch] = sum_corners in[(x, y, z), ci*C + ch]``.

    Ports both ``_reduce_cell_cache_grad`` (f32 pad-adds) and
    ``_reduce_cell_cache_grad_conv`` (the bf16 one-hot conv with f32
    accumulation) of the JAX module: the same linear map, here as 8 shifted
    adds accumulated in f32 in ``_CORNERS`` order.  It is the plain version
    beside the CUDA reduce kernel (ops/reduce_cuda.py), which sums in the
    same order and so agrees bitwise."""
    R = p["res"]
    S = R + 1
    x = d_cache.view(R, R, R, 8, C)
    out = torch.zeros((p["size"] * C,), dtype=torch.float32, device=d_cache.device)
    o4 = out[:S * S * S * C].view(S, S, S, C)
    for ci, c in enumerate(_CORNERS):
        cx, cy, cz = (int(v) for v in c)
        o4[cx:cx + R, cy:cy + R, cz:cz + R] += x[:, :, :, ci]
    return out


def _axes01(x: torch.Tensor):
    """Split x in [-1,1]^3 into per-axis (N,) [0,1] coords."""
    return tuple(torch.clamp((x[:, k] + 1.0) * 0.5, 0.0, 1.0) for k in range(3))


def _level_fracs(axes, p):
    """Per-axis (pos_grid:int32, frac) for one level — all (N,) vectors."""
    pgs, fracs = [], []
    for a in axes:
        pos = a * p["scale"] + 0.5
        pos_grid = torch.floor(pos)
        pgs.append(pos_grid.to(torch.int32))
        fracs.append(pos - pos_grid)
    return pgs, fracs


def _corner_index_axes(gx, gy, gz, res: int, size: int, dense: bool):
    """Per-axis corner index ((N,) integer inputs) -> (N,) int64 row index.

    The hash is computed in int64 and masked to 32 bits, which equals the
    JAX module's wrapping uint32 arithmetic."""
    if dense:
        stride = res + 1
        return (gx.long() * (stride * stride) + gy.long() * stride + gz.long())
    h = ((gx.long() * _PRIMES[0]) ^ (gy.long() * _PRIMES[1])
         ^ (gz.long() * _PRIMES[2])) & 0xFFFFFFFF
    return h % size


def _cell_of(pgs, R: int) -> torch.Tensor:
    return pgs[0] * (R * R) + pgs[1] * R + pgs[2]


def _cell_rows(axes, cache, p, C: int):
    """Gather each point's (N, 8*C) corner rows + per-axis fracs."""
    R = p["res"]
    pgs, fracs = _level_fracs(axes, p)
    cell = _cell_of(pgs, R)
    rows = cache.index_select(0, cell)
    return rows, fracs, cell


def _hashed_rows(axes, level_table, p, C: int):
    """Hashed-level rows shaped like ``_cell_rows``: 8 window-C gathers
    (one per corner) -> natural-layout (N, 8*C) rows."""
    pgs, fracs = _level_fracs(axes, p)
    entries = level_table.view(p["size"], C)
    pairs = []
    for c in _CORNERS:
        idx = _corner_index_axes(
            pgs[0] + int(c[0]), pgs[1] + int(c[1]), pgs[2] + int(c[2]),
            p["res"], p["size"], p["dense"])
        pairs.append(entries.index_select(0, idx))
    return torch.cat(pairs, dim=-1), fracs, None


def _corner_sels(fracs, c):
    """Per-axis selected frac factors for corner c — three (N,) vectors."""
    return tuple(fracs[k] if c[k] else 1.0 - fracs[k] for k in range(3))


def _exact_corners(axes, p, C: int):
    """One level's 8 corners for the exact layout, in ``_CORNERS`` order:
    (corner, flat table index of its channel 0 ``(offset + row) * C`` as
    (N,) int64, its per-axis selected fracs, its trilinear weight)."""
    pgs, fracs = _level_fracs(axes, p)
    out = []
    for c in _CORNERS:
        idx = _corner_index_axes(pgs[0] + int(c[0]), pgs[1] + int(c[1]),
                                 pgs[2] + int(c[2]), p["res"], p["size"], p["dense"])
        sels = _corner_sels(fracs, c)
        out.append((c, (p["offset"] + idx) * C, sels, (sels[0] * sels[1]) * sels[2]))
    return out


def _encode_impl(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec):
    """Forward of the exact layout: per level, corner and channel one
    element gather ``table[base + ch]`` (JAX ``_encode_impl``).  The weights
    and the contraction order are the cell layout's, so both layouts give
    the same f32 values."""
    C = spec.level_dim
    axes = _axes01(x)
    cols = []
    for p in spec.level_params():
        acc = [None] * C
        for _, base, _, w in _exact_corners(axes, p, C):
            for ch in range(C):
                term = table[base + ch] * w
                acc[ch] = term if acc[ch] is None else acc[ch] + term
        cols.extend(acc)
    return torch.stack(cols, dim=-1)


def _hash_encode_bwd(spec: HashGridSpec, x: torch.Tensor, table: torch.Tensor,
                     g: torch.Tensor):
    """Backward of the exact layout (JAX ``_hash_encode_bwd``): the
    coordinate cotangent from ``g . table[row]`` gathered again per corner,
    and the table cotangent as ONE flat ``index_add_`` of N * 8 * L * C
    elements (int32 indices: the table has fewer than 2^31 elements).  The
    scatter runs without a graph; the coordinate cotangent is recorded when
    grad mode is on (``create_graph``)."""
    C = spec.level_dim
    axes = _axes01(x)
    dxa = [torch.zeros_like(axes[0]) for _ in range(3)]
    flat_idx, contrib = [], []
    for li, p in enumerate(spec.level_params()):
        g_cols = [g[:, li * C + ch] for ch in range(C)]
        for c, base, (s0, s1, s2), w in _exact_corners(axes, p, C):
            gdotrow = None
            for ch in range(C):
                with torch.no_grad():
                    flat_idx.append((base + ch).to(torch.int32))
                    contrib.append(w * g_cols[ch])
                t = g_cols[ch] * table[base + ch]
                gdotrow = t if gdotrow is None else gdotrow + t
            # dw/dx01_k = scale * sign_k * prod_{j != k} sel_j
            for k, others in enumerate(((s1, s2), (s0, s2), (s0, s1))):
                term = (gdotrow * (others[0] * others[1])) * p["scale"]
                dxa[k] = dxa[k] + term if c[k] else dxa[k] - term
    with torch.no_grad():
        d_table = torch.zeros_like(table).index_add_(
            0, torch.cat(flat_idx), torch.cat(contrib))
    # chain through x01 = clip((x+1)/2): derivative 0.5 inside, 0 at clip
    inside = (torch.abs(x) <= 1.0).to(x.dtype)
    dx = torch.stack(dxa, dim=-1) * 0.5 * inside
    return dx, d_table


class _HashEncode(torch.autograd.Function):
    """Exact-layout encode with the custom backward ``_hash_encode_bwd``.
    Only ``x`` and ``table`` are saved: indices and weights are recomputed,
    as in the JAX custom VJP."""

    @staticmethod
    def forward(ctx, x, table, spec):
        ctx.save_for_backward(x, table)
        ctx.spec = spec
        return _encode_impl(x, table, spec)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        dx, d_table = _hash_encode_bwd(ctx.spec, x, table, g)
        return dx, d_table, None


def hash_encode(x: torch.Tensor, table: torch.Tensor,
                spec: HashGridSpec) -> torch.Tensor:
    """Exact-layout encode of points x (N, 3) in [-1, 1]^3 ->
    (N, num_levels * level_dim).  Out-of-range points are clamped (callers
    mask validity separately, as the reference does in run_network
    nerf_runner.py:1246)."""
    return _HashEncode.apply(x, table, spec)


# Dense levels whose corner cache exceeds this byte size gather through the
# two-stage run gather (``_cell_rows_seg``) under the seg scatter.  The value
# is the JAX module's (sized for XLA's gather cost on the TPU) and is kept so
# that the same levels take the same path: the online budget's R = 128 bf16
# cache is exactly this size and takes the direct gather.
_SEG_GATHER_BYTES = 64 * 1024 * 1024


def _seg_cap(res: int, n_samples: int) -> int:
    """Static per-ray run capacity of the seg compaction (JAX ``_seg_cap``):
    about twice the distinct cells a z-ordered ray crosses at this
    resolution.  A level where some ray has more runs takes the direct
    path, so the cap trades speed, not correctness."""
    if res <= 16:
        cap = 16
    elif res <= 32:
        cap = 24
    elif res <= 64:
        cap = 40
    else:
        cap = 72
    return min(n_samples, cap)


def _seg_gathers(spec: HashGridSpec, p, n_rays: int, n_pts: int) -> bool:
    """Whether a level's forward takes the two-stage run gather: a dense
    level under the seg scatter, on a ray-structured batch, whose staged
    cache is larger than ``_SEG_GATHER_BYTES`` (strictly, as in JAX)."""
    if not (spec.scatter == "seg" and p["dense"] and n_rays > 0 and n_pts % n_rays == 0):
        return False
    return p["res"] ** 3 * 8 * spec.level_dim * _lvl_dtype(spec, p).itemsize > _SEG_GATHER_BYTES


def _runs(key2d: torch.Tensor):
    """Runs of equal keys along each row of (n_rays, S) keys: the run-start
    flags (bool), each ray's run count, and each sample's run index
    (int64, non-decreasing along a ray)."""
    b = torch.cat([torch.ones_like(key2d[:, :1], dtype=torch.bool),
                   key2d[:, 1:] != key2d[:, :-1]], dim=1)
    return b, b.sum(dim=1), torch.cumsum(b, dim=1) - 1


def _run_slots(seg_id: torch.Tensor, cap: int, right: bool) -> torch.Tensor:
    """(n_rays, cap) sample position that bounds run k of each ray: its
    last sample (``right``: the samples in runs <= k, less one) or its first
    (the samples in runs < k), clamped into the ray.  ``seg_id`` is sorted
    along a ray, so a binary search counts what JAX's compare-reduce does."""
    n_rays, S = seg_id.shape
    ks = torch.arange(cap, device=seg_id.device).expand(n_rays, cap).contiguous()
    pos = torch.searchsorted(seg_id, ks, right=right)
    return (pos - 1 if right else pos).clamp(0, S - 1)


def _seg_comb(a, x):
    """The segmented sum's combine (JAX ``_seg_compact``'s ``comb``)."""
    (av, af), (xv, xf) = a, x
    return torch.where(xf[..., None], xv, av + xv), af | xf


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even`` at the even and ``odd`` at the odd positions of dim 1."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1]) + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _seg_scan(vals: torch.Tensor, flags: torch.Tensor):
    """Segmented inclusive scan along dim 1 of (n_rays, S, F) ``vals`` in
    their dtype, restarting where ``flags`` (n_rays, S) is set.  It pairs
    the terms as ``jax.lax.associative_scan`` does (the JAX module's scan),
    so each run sum is formed in the same order."""
    n = vals.shape[1]
    if n < 2:
        return vals, flags
    ov, of = _seg_scan(*_seg_comb((vals[:, 0:-1:2], flags[:, 0:-1:2]),
                                  (vals[:, 1::2], flags[:, 1::2])))
    head = (ov[:, :-1], of[:, :-1]) if n % 2 == 0 else (ov, of)
    ev, ef = _seg_comb(head, (vals[:, 2::2], flags[:, 2::2]))
    ev = torch.cat([vals[:, :1], ev], dim=1)
    ef = torch.cat([flags[:, :1], ef], dim=1)
    return _interleave(ev, ov), _interleave(ef, of)


def _seg_compact(key2d: torch.Tensor, d_rows2d: torch.Tensor, cap: int):
    """Run compaction shared by the dense and hashed seg scatters (JAX
    ``_seg_compact``).

    key2d: (n_rays, S) integer key, constant within a run of equal cells;
    d_rows2d: (n_rays, S, F).  Returns (rows (n_rays*cap, F): each run's sum
    in d_rows2d's dtype, zero in an empty slot; flat_pos (n_rays*cap,): the
    flat sample index of each run's last sample, the ray's last sample for
    an empty slot; slot_valid (n_rays*cap,); fits: a 0-d device bool, every
    ray's run count <= cap)."""
    n_rays, S = key2d.shape
    F = d_rows2d.shape[-1]
    b, n_runs, seg_id = _runs(key2d)
    vals, _ = _seg_scan(d_rows2d, b)
    end_pos = _run_slots(seg_id, cap, right=True)
    slot_valid = (torch.arange(cap, device=key2d.device)[None, :]
                  < n_runs[:, None]).reshape(-1)
    flat_pos = (torch.arange(n_rays, device=key2d.device)[:, None] * S
                + end_pos).reshape(-1)
    rows = vals.reshape(n_rays * S, F).index_select(0, flat_pos)
    rows = torch.where(slot_valid[:, None], rows, 0.0)
    return rows, flat_pos, slot_valid, n_runs.max() <= cap


def _cell_rows_seg(axes, cache, p, C: int, n_rays: int, n_pts: int):
    """Two-stage run gather (JAX ``_cell_rows_seg``): each run's cache row
    is gathered once into an (n_rays*cap, 8C) buffer and handed out per
    sample from there, rows bitwise equal to ``_cell_rows``'.  Where a ray
    of the level has more runs than the cap, the direct gather's rows are
    taken (JAX's ``lax.cond``; here both are gathered and one is picked on
    the device)."""
    R = p["res"]
    pgs, fracs = _level_fracs(axes, p)
    cell = _cell_of(pgs, R)
    S = n_pts // n_rays
    cap = _seg_cap(R, S)
    _, n_runs, seg_id = _runs(cell.view(n_rays, S))
    base = torch.arange(n_rays, device=cell.device)[:, None]
    start = (base * S + _run_slots(seg_id, cap, right=False)).reshape(-1)
    compact = cache.index_select(0, cell.index_select(0, start))
    rows = compact.index_select(0, (base * cap + seg_id.clamp(max=cap - 1)).reshape(-1))
    if cap < S:
        rows = torch.where(n_runs.max() <= cap, rows, cache.index_select(0, cell))
    return rows, fracs, cell


def _cell_rows_all(axes, table: torch.Tensor, spec: HashGridSpec, n_rays: int = 0):
    """Per level of the cell layout: the (N, 8C) corner rows (the staging
    dtype's values for a dense level) and the per-axis fracs."""
    C = spec.level_dim
    n_pts = axes[0].shape[0]
    out = []
    for p, view in zip(spec.level_params(), _level_views(table, spec)):
        if p["dense"]:
            cache = _build_cell_cache(view, p, C, _lvl_dtype(spec, p))
            if _seg_gathers(spec, p, n_rays, n_pts):
                rows, fracs, _ = _cell_rows_seg(axes, cache, p, C, n_rays, n_pts)
            else:
                rows, fracs, _ = _cell_rows(axes, cache, p, C)
        else:
            rows, fracs, _ = _hashed_rows(axes, view, p, C)
        out.append((rows, fracs))
    return out


def _encode_cell_impl(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                      n_rays: int = 0):
    """Forward for the "cell" layout.  Returns (out, per-level rows)."""
    C = spec.level_dim
    cols = []
    rows_all = []
    for rows, fracs in _cell_rows_all(_axes01(x), table, spec, n_rays):
        rows_all.append(rows)
        acc = [None] * C
        for ci, c in enumerate(_CORNERS):
            s0, s1, s2 = _corner_sels(fracs, c)
            w = (s0 * s1) * s2
            for ch in range(C):
                term = rows[:, ci * C + ch] * w
                acc[ch] = term if acc[ch] is None else acc[ch] + term
        cols.extend(acc)
    return torch.stack(cols, dim=-1), tuple(rows_all)


def _cell_cache_scatter(cell, d_rows, n_dest_rows: int) -> torch.Tensor:
    """Scatter-add (N, F) rows at ``cell`` into a fresh (n_dest_rows, F)
    accumulator of d_rows' dtype.  The JAX module's lane-packed variant
    (``_packed_row_scatter``) is a TPU layout trick for the same sum."""
    out = torch.zeros((n_dest_rows, d_rows.shape[1]), dtype=d_rows.dtype,
                      device=d_rows.device)
    return out.index_add_(0, cell, d_rows)


def _seg_cell_scatter(cell2d, d_rows2d, n_dest_rows: int, cap: int) -> torch.Tensor:
    """Segment-dedup scatter-add (JAX ``_seg_cell_scatter``): each run of
    equal cells along a ray is pre-summed (``_seg_compact``, in d_rows2d's
    dtype) and scattered as one row.  Where ``cap < S`` and some ray has
    more runs than the cap, the per-sample scatter is taken instead: both
    scatter into one accumulator, and the branch not taken adds zeros.

    An empty slot adds its zero row to its ray's last cell.  JAX sends
    every empty slot to cell 0, free on a TPU; on the card that would put
    one atomic address under all of them."""
    n_rays, S = cell2d.shape
    F = d_rows2d.shape[-1]
    rows, flat_pos, _, fits = _seg_compact(cell2d, d_rows2d, cap)
    cells = cell2d.reshape(-1).index_select(0, flat_pos)
    if cap >= S:  # dedup cannot overflow
        return _cell_cache_scatter(cells, rows, n_dest_rows)
    out = _cell_cache_scatter(cell2d.reshape(-1),
                              torch.where(fits, 0.0, d_rows2d.reshape(-1, F)), n_dest_rows)
    return out.index_add_(0, cells, torch.where(fits, rows, 0.0))


def _element_scatter(gx, gy, gz, cols, p, C: int, out=None) -> torch.Tensor:
    """Hashed level: flat (size*C,) element scatter of the 8*C columns, into
    ``out`` when given, else into zeros."""
    flat_idx = []
    contrib = []
    for ci, c in enumerate(_CORNERS):
        idx = _corner_index_axes(gx + int(c[0]), gy + int(c[1]), gz + int(c[2]),
                                 p["res"], p["size"], p["dense"])
        base = idx * C
        for ch in range(C):
            flat_idx.append(base + ch)
            contrib.append(cols[ci * C + ch])
    if out is None:
        out = torch.zeros((p["size"] * C,), dtype=cols[0].dtype, device=cols[0].device)
    return out.index_add_(0, torch.cat(flat_idx), torch.cat(contrib))


def _seg_element_scatter(pgs, d_cols, p, C: int, n_rays: int) -> torch.Tensor:
    """Hashed level under seg (JAX ``_cell_bwd_impl``'s hashed branch): runs
    of equal grid cell (the corner indices are a function of the cell) keyed
    collision-free by ``(gx*K + gy)*K + gz`` with ``K = res + 2``, pre-summed
    and scattered as elements at the run's cell.  An empty slot takes its
    ray's last cell with zero values.  The direct fallback as in
    ``_seg_cell_scatter``."""
    S = pgs[0].shape[0] // n_rays
    cap = _seg_cap(p["res"], S)
    K = p["res"] + 2
    key2d = ((pgs[0] * K + pgs[1]) * K + pgs[2]).view(n_rays, S)
    d2 = torch.stack(d_cols, dim=-1)
    rows, flat_pos, _, fits = _seg_compact(key2d, d2.view(n_rays, S, 8 * C), cap)
    cells = [g.index_select(0, flat_pos) for g in pgs]
    if cap >= S:
        return _element_scatter(*cells, rows.unbind(1), p, C)
    out = _element_scatter(*pgs, torch.where(fits, 0.0, d2).unbind(1), p, C)
    return _element_scatter(*cells, torch.where(fits, rows, 0.0).unbind(1), p, C, out)


def _cell_bwd_impl(spec: HashGridSpec, x: torch.Tensor, rows_all, g: torch.Tensor,
                   n_rays: int = 0):
    """Backward of the cell-layout encode: (dx, flat f32 table gradient).

    Same dispatch as the JAX ``_cell_bwd_impl``: dense levels scatter their
    (N, 8C) row gradients into a cache-shaped accumulator (bf16 for big
    levels) and reduce it to the table — through the CUDA reduce for bf16
    levels when ``spec.reduce == "pallas"``; small dense levels go through
    the fused CUDA scatter when ``spec.scatter == "pallas"``; hashed levels
    use the flat element scatter.  Under ``spec.scatter == "seg"`` with
    ``n_rays`` > 0 the dense and hashed scatters are the segment-dedup
    ones.  The table gradient is computed without a graph; ``dx`` is
    recorded when grad mode is on (``create_graph``)."""
    from . import hashgrid_cuda, reduce_cuda

    C = spec.level_dim
    axes = _axes01(x)
    gT = g.t().contiguous()
    dxa = [torch.zeros_like(axes[0]) for _ in range(3)]
    d_levels = {}
    fuse = []  # (li, p, cell, d_rows)
    seg = spec.scatter == "seg" and n_rays > 0
    for li, p in enumerate(spec.level_params()):
        rows = rows_all[li]
        g_cols = [gT[li * C + ch] for ch in range(C)]
        pgs, fracs = _level_fracs(axes, p)
        d_cols = []
        for ci, c in enumerate(_CORNERS):
            s0, s1, s2 = _corner_sels(fracs, c)
            w = (s0 * s1) * s2
            gdotrow = None
            for ch in range(C):
                with torch.no_grad():
                    d_cols.append(w * g_cols[ch])
                t = g_cols[ch] * rows[:, ci * C + ch]
                gdotrow = t if gdotrow is None else gdotrow + t
            # dw/dx01_k = scale * sign_k * prod_{j != k} sel_j
            for k, others in enumerate(((s1, s2), (s0, s2), (s0, s1))):
                term = (gdotrow * (others[0] * others[1])) * p["scale"]
                dxa[k] = dxa[k] + term if c[k] else dxa[k] - term
        if p["dense"]:
            R = p["res"]
            dt = _lvl_dtype(spec, p)
            cell = _cell_of(pgs, R)
            d_rows = torch.stack(d_cols, dim=-1)  # (N, 8*C) scatter operand
            if spec.scatter == "pallas" and R * R * R <= _PALLAS_FUSE_ROWS:
                fuse.append((li, p, cell, d_rows))
                continue
            if seg:
                # bf16 levels stage the whole compact stream, the scan
                # included, in bf16 (as JAX does)
                S = x.shape[0] // n_rays
                d_cache = _seg_cell_scatter(
                    cell.view(n_rays, S), d_rows.view(n_rays, S, 8 * C).to(dt),
                    R * R * R, _seg_cap(R, S))
            else:
                d_cache = _cell_cache_scatter(cell, d_rows.to(dt), R * R * R)
            if dt == torch.bfloat16 and spec.reduce == "pallas":
                d_levels[li] = reduce_cuda.reduce_cell_cache_grad(
                    d_cache, R, C, p["size"])
            else:
                d_levels[li] = _reduce_cell_cache_grad(d_cache, p, C)
        elif seg:
            d_levels[li] = _seg_element_scatter(pgs, d_cols, p, C, n_rays)
        else:
            d_levels[li] = _element_scatter(pgs[0], pgs[1], pgs[2], d_cols, p, C)
    if fuse:
        d_caches = hashgrid_cuda.fused_cache_scatter(
            [f[2] for f in fuse], [f[3] for f in fuse],
            [f[1]["res"] ** 3 for f in fuse])
        for (li, p, _, _), d_cache in zip(fuse, d_caches):
            d_levels[li] = _reduce_cell_cache_grad(d_cache, p, C)
    d_table = torch.cat([d_levels[li] for li in range(spec.num_levels)])
    # chain through x01 = clip((x+1)/2): derivative 0.5 inside, 0 at clip
    inside = (torch.abs(x) <= 1.0).to(x.dtype)
    dx = torch.stack(dxa, dim=-1) * 0.5 * inside
    return dx, d_table


class _HashEncodeCell(torch.autograd.Function):
    """Cell-layout encode with the custom backward ``_cell_bwd_impl``
    (``n_rays`` > 0: a ray-structured batch, for the seg scatter).  The
    gathered rows are saved for the backward's coordinate cotangent instead
    of re-gathered.  They were gathered without a graph, so a backward that
    is itself differentiated (grad mode on: ``create_graph``) gathers them
    again from the saved table, through the direct gather (the same
    values): else the coordinate cotangent's derivative with respect to the
    table would be silently zero."""

    @staticmethod
    def forward(ctx, x, table, spec, n_rays):
        out, rows_all = _encode_cell_impl(x, table, spec, n_rays)
        ctx.save_for_backward(x, table, *rows_all)
        ctx.spec, ctx.n_rays = spec, n_rays
        return out

    @staticmethod
    def backward(ctx, g):
        x, table, *rows_all = ctx.saved_tensors
        if torch.is_grad_enabled():
            rows_all = [r for r, _ in _cell_rows_all(_axes01(x), table, ctx.spec)]
        dx, d_table = _cell_bwd_impl(ctx.spec, x, rows_all, g, ctx.n_rays)
        return dx, d_table, None, None


def hash_encode_cell(x: torch.Tensor, table: torch.Tensor,
                     spec: HashGridSpec) -> torch.Tensor:
    """Encode points x (N, 3) in [-1, 1]^3 -> (N, num_levels * level_dim).
    Out-of-range points are clamped (callers mask validity separately)."""
    return _HashEncodeCell.apply(x, table, spec, 0)


def hash_encode_cell_rays(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                          n_rays: int) -> torch.Tensor:
    """Ray-structured ``hash_encode_cell``: x is (n_rays * S, 3), each ray's
    S samples contiguous and z-ordered.  Under ``spec.scatter == "seg"``
    that order drives the segment-dedup scatters of the backward and the
    two-stage run gathers of the forward (rows bitwise equal; the table
    gradient differs only by summation order); under any other scatter it
    is ``hash_encode_cell``."""
    return _HashEncodeCell.apply(x, table, spec, n_rays)


def resolve_reduce(pref: str = "auto", device=None) -> str:
    """Resolve the spec.reduce knob (bf16 big-level cache-grad reduce).

    "auto" = "pallas" for CUDA tensors (``device`` None means CUDA, the
    port's default), "conv" otherwise.  In the port "pallas" names the
    hand-written CUDA kernel of ops/reduce_cuda.py (the name is kept from
    the JAX config); for a CPU tensor its wrapper runs the plain reduce,
    so both values give the same result there."""
    if pref not in ("auto", "conv", "pallas"):
        raise ValueError(f"unknown hash_reduce {pref!r}")
    if pref != "auto":
        return pref
    dev = torch.device("cuda") if device is None else torch.device(device)
    return "pallas" if dev.type == "cuda" else "conv"


def resolve_scatter(pref: str = "auto") -> str:
    """Resolve the spec.scatter knob.

    "xla" = per-level ``index_add_`` scatters.  "pallas" = the fused CUDA
    scatter for the small dense levels (ops/hashgrid_cuda.py).  "seg" =
    the JAX module's segment-dedup scatters and two-stage run gathers, as
    JAX runs them.  "auto" = "xla": JAX resolves it to "seg", a choice made
    on the TPU's scatter costs; the port keeps ``index_add_`` until the two
    are timed on the card."""
    if pref not in ("auto", "xla", "pallas", "seg"):
        raise ValueError(f"unknown hash_scatter {pref!r}")
    return "xla" if pref == "auto" else pref


def encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
           n_rays: int = 0) -> torch.Tensor:
    """Dispatch on spec.layout — the single entry point callers use: "cell"
    takes ``hash_encode_cell``, any other layout the exact ``hash_encode``,
    as in the JAX module.

    ``n_rays`` > 0 declares that x is (n_rays * S, 3) with each ray's
    z-ordered samples contiguous (``hash_encode_cell_rays``, which the seg
    scatter reads).  Callers without ray structure (mesh extraction, point
    queries) leave it 0."""
    if spec.layout == "cell":
        if n_rays > 0 and x.shape[0] % n_rays == 0:
            return hash_encode_cell_rays(x, table, spec, n_rays)
        return hash_encode_cell(x, table, spec)
    return hash_encode(x, table, spec)
