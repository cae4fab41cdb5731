#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``bundlesdf_tpu_torch``) on one GPU.

    python3 chip_smoke.py                  # one card, under a minute
    python3 chip_smoke.py --profile DIR    # also profiles the train step and
                                           # writes kernel tables to DIR

Phases, one JSON line each (any failure raises; the exit code is then not 0):

  build         compile every CUDA source of the port with nvcc for sm_90a
  kernels       each hand-written kernel against its plain PyTorch version at
                the online-budget shapes (the scatter on uniform and on
                ray-major cells): max abs error, kernel / plain / library
                device times (``cuda_ms``: CUDA events, L2 cold, queued
                behind a device spin), the wrapper's host time per call
                (``host_us``), the memory-or-compute bound, its share, and
                the bytes and operations it is computed from
  small_parity  the train step on the card against the same step on the CPU
                (plain versions of the kernels) at a small budget, same
                parameters, batch and jitter
  nof_train_step                  the NOF training step at the online budget
                (2048 rays x (128 + 64) samples, 4 hash levels 16 -> 128, bf16
                big levels) under the shipped config; the reduce kernel must
                launch exactly twice per step and the loss must fall
  nof_train_step_pallas_scatter   the same step under hash_scatter: pallas;
                the fused scatter kernel must launch once per step

Before the last line it prints the card's name and power limit (first line)
and the kernels summary ``{"kernels": [...]}``, whose kernel times are taken on
the inputs the train steps handed each kernel.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits 1
and prints no result.

The script imports nothing of JAX or of the JAX package ``bundlesdf_tpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s
# outside the tensor cores, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Spin cycles per second of host enqueue time to cover: above the H100's
# top SM clock (1.98 GHz), so the spin lasts at least as long as asked.
SPIN_HZ = 2.0e9
# Bytes read between timed calls to evict their inputs from the 50 MB L2.
L2_FLUSH_BYTES = 128 << 20

# Online budget (the JAX package's bench.py:50-53).
ONLINE = dict(n_rand=2048, n_samples=128, n_around=64, num_levels=4,
              finest_res=128, log2_hashmap=22, n_march=200, num_frames=16,
              occ_res=64)
TRAIN_STEPS = 20
SCATTER_STEPS = 8

# Tolerances of each kernel against its plain version on the same inputs.
# reduce: both sum the same <= 8 bf16 terms in f32 in the same corner order,
# so they agree bitwise; the stated bound leaves room for nothing but that.
REDUCE_RTOL = 1e-6
# scatter: f32 atomics add in a nondeterministic order; up to ~800 terms per
# address at these shapes, so a reorder moves a sum by well under 1e-5 of
# the largest sum.
SCATTER_RTOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@functools.lru_cache(maxsize=1)
def _l2_flush_buffer():
    import torch

    return torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``, with the L2 cold.

    Three CUDA events time ``iters`` calls, each after a read of a buffer
    2.5x the size of the 50 MB L2 that pushes the call's inputs out of it
    (so its bytes come from device memory, as the bound assumes), and then
    the same reads alone; the difference over ``iters`` is the call's time.
    All of it queues behind a device-side spin that outlasts the host's
    enqueue, so the reading is device time even where a call's host cost
    exceeds its kernel's.  Raises if the first event had already passed
    when the host finished enqueueing (spin too short) after doubling the
    spin three times."""
    import torch

    flush = _l2_flush_buffer()

    def calls():
        for _ in range(iters):
            flush.sum()
            fn()

    def flushes():
        for _ in range(iters):
            flush.sum()

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls()
    flushes()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for attempt in range(4):
        torch.cuda._sleep(int(SPIN_HZ * enqueue_s * 2 ** (attempt + 1)) + 100_000)
        ev[0].record()
        calls()
        ev[1].record()
        flushes()
        ev[2].record()
        covered = not ev[0].query()
        torch.cuda.synchronize()
        if covered:
            return (ev[0].elapsed_time(ev[1]) - ev[1].elapsed_time(ev[2])) / iters
    raise AssertionError("the device spin did not cover the host's enqueue")


def host_us(fn, calls: int = 100) -> float:
    """Mean host time of one call of ``fn`` (its enqueue: no
    synchronisation inside the timed loop), in microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- kernels ---

def reduce_cost(R: int, C: int, size: int) -> tuple[float, float]:
    """Bytes (bf16 input read once, f32 output written once) and adds."""
    return R ** 3 * 8 * C * 2 + size * C * 4, R ** 3 * 8 * C


def scatter_cost(n: int, width: int, rows: list) -> tuple[float, float]:
    """Bytes (indices and updates read once per level, accumulators written
    once) and adds."""
    k = len(rows)
    return k * n * (4 + 4 * width) + sum(rows) * width * 4, k * n * width


def conv3d_reduce(R: int, C: int, device):
    """The library yardstick of the reduce: one one-hot 2x2x2 ``conv3d`` on
    the f32 cache in channels-last layout (never called by the port)."""
    import torch
    import torch.nn.functional as F

    from bundlesdf_tpu_torch.ops.hashgrid import _CORNERS

    w = torch.zeros((C, 8 * C, 2, 2, 2), device=device)
    for ci, c in enumerate(_CORNERS):
        for ch in range(C):
            w[ch, ci * C + ch, 1 - int(c[0]), 1 - int(c[1]), 1 - int(c[2])] = 1.0

    def run(x_f32_cl):
        return F.conv3d(x_f32_cl, w, padding=1)

    def prep(d_cache):
        return d_cache.float().view(1, R, R, R, 8 * C).permute(0, 4, 1, 2, 3)

    def flat(out):
        return out.permute(0, 2, 3, 4, 1).reshape(-1)

    return prep, run, flat


def check_reduce(d_cache, R: int, C: int, size: int) -> dict:
    from bundlesdf_tpu_torch.ops import reduce_cuda

    out = reduce_cuda.reduce_cell_cache_grad(d_cache, R, C, size)
    ref = reduce_cuda.reduce_cell_cache_grad_plain(d_cache, R, C, size)
    err = max_err(out, ref)
    tol = REDUCE_RTOL * max(1.0, float(ref.abs().max()))
    if not err <= tol:
        raise AssertionError(f"reduce R={R}: max abs err {err} > {tol}")
    prep, run, flat = conv3d_reduce(R, C, d_cache.device)
    x_cl = prep(d_cache)
    S3C = (R + 1) ** 3 * C
    lib_err = max_err(flat(run(x_cl)), ref[:S3C])
    if not lib_err <= tol:
        raise AssertionError(f"conv3d yardstick R={R} disagrees: {lib_err}")
    n_bytes, n_ops = reduce_cost(R, C, size)
    b_ms, b_by = bound(n_bytes, n_ops)

    def kernel():
        return reduce_cuda.reduce_cell_cache_grad(d_cache, R, C, size)

    k_ms = cuda_ms(kernel)
    return {
        "R": R, "C": C, "max_abs_err": err, "tol": tol,
        "kernel_ms": k_ms, "host_us": host_us(kernel),
        "plain_ms": cuda_ms(lambda: reduce_cuda.reduce_cell_cache_grad_plain(
            d_cache, R, C, size)),
        "library_ms": cuda_ms(lambda: run(x_cl)),
        "library": "F.conv3d one-hot 2x2x2, f32 input, channels-last",
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms,
        "bytes": n_bytes, "ops": n_ops,
    }


def check_scatter(cells: list, d_rows: list, rows: list) -> dict:
    import torch

    from bundlesdf_tpu_torch.ops import hashgrid_cuda

    outs = hashgrid_cuda.fused_cache_scatter(cells, d_rows, rows)
    refs = hashgrid_cuda.fused_cache_scatter_plain(cells, d_rows, rows)
    errs = [max_err(o, r) for o, r in zip(outs, refs)]
    tols = [SCATTER_RTOL * max(1.0, float(r.abs().max())) for r in refs]
    for e, t, r in zip(errs, tols, rows):
        if not e <= t:
            raise AssertionError(f"scatter rows={r}: max abs err {e} > {t}")
    n, width = d_rows[0].shape
    lib_ms = None
    if len(rows) == 1:  # one index_add_ computes the whole function
        acc = torch.zeros((rows[0], width), device=d_rows[0].device)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, cells[0], d_rows[0]))
    n_bytes, n_ops = scatter_cost(n, width, rows)
    b_ms, b_by = bound(n_bytes, n_ops)

    def kernel():
        return hashgrid_cuda.fused_cache_scatter(cells, d_rows, rows)

    k_ms = cuda_ms(kernel)
    return {
        "rows": rows, "N": n, "width": width, "max_abs_err": max(errs),
        "tol": min(tols), "kernel_ms": k_ms, "host_us": host_us(kernel),
        "plain_ms": cuda_ms(lambda: hashgrid_cuda.fused_cache_scatter_plain(
            cells, d_rows, rows)),
        "library_ms": lib_ms,
        "library": "Tensor.index_add_" if lib_ms is not None else None,
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms,
        "bytes": n_bytes, "ops": n_ops,
        "adds_per_address": n * len(rows) / sum(rows),
        "mean_run": [mean_run(c) for c in cells],
    }


def mean_run(cells) -> float:
    """Mean length of the runs of equal consecutive indices."""
    return cells.numel() / (1 + int((cells[1:] != cells[:-1]).sum()))


def ray_major_cells(n_rays: int, n_occ: int, n_band: int, R: int, gen, device):
    """Seeded ray model of the train step's level-R cells, ray-major as the
    step makes them (models/nof.py flattens (rays, samples)): each ray is a
    segment between two uniform points of [-1, 1]^3 with ``n_occ`` sorted
    uniform samples along it, followed by ``n_band`` sorted samples within
    +-0.02 of a surface point in its middle; cells as the encode computes
    them (pos = x01 * (R - 1) + 0.5)."""
    import torch

    a = torch.rand((n_rays, 1, 3), generator=gen, device=device) * 2 - 1
    b = torch.rand((n_rays, 1, 3), generator=gen, device=device) * 2 - 1
    t_occ = torch.rand((n_rays, n_occ), generator=gen, device=device).sort(1)[0]
    t_srf = 0.3 + 0.4 * torch.rand((n_rays, 1), generator=gen, device=device)
    t_band = t_srf + 0.02 * (2 * torch.rand((n_rays, n_band), generator=gen,
                                            device=device) - 1)
    t = torch.cat([t_occ, t_band.sort(1)[0]], 1).unsqueeze(-1)
    x01 = ((a + t * (b - a)) + 1) * 0.5
    g = torch.floor(x01 * (R - 1) + 0.5).to(torch.int32).clamp_(0, R - 1)
    return ((g[..., 0] * R + g[..., 1]) * R + g[..., 2]).reshape(-1).contiguous()


def online_levels() -> tuple[list, tuple]:
    """Resolutions of the online budget's bf16-staged levels (one reduce
    launch each per step) and of the levels the fused scatter takes."""
    import torch

    from bundlesdf_tpu_torch.ops import hashgrid

    spec = hashgrid.HashGridSpec(ONLINE["num_levels"], 2, 16, ONLINE["finest_res"],
                                 ONLINE["log2_hashmap"], layout="cell",
                                 big_dtype="bfloat16")
    lp = spec.level_params()
    bf16 = [p["res"] for p in lp
            if hashgrid._lvl_dtype(spec, p) == torch.bfloat16]
    fused = tuple(p["res"] for p in lp
                  if p["dense"] and p["res"] ** 3 <= hashgrid._PALLAS_FUSE_ROWS)
    return bf16, fused


def phase_kernels(device) -> dict:
    import torch

    bf16_res, fused_res = online_levels()
    gen = torch.Generator(device=device).manual_seed(0)
    reduce_rows = []
    for R in (8, 64, 128):
        d_cache = torch.randn((R ** 3, 16), generator=gen,
                              device=device).to(torch.bfloat16)
        size = -(-(R + 1) ** 3 // 8) * 8  # the level's 8-aligned table size
        row = check_reduce(d_cache, R, 2, size)
        row["launches_per_step"] = bf16_res.count(R)
        reduce_rows.append(row)
    scatter_rows = []
    n = ONLINE["n_rand"] * (ONLINE["n_samples"] + ONLINE["n_around"])
    for Rs in ((16,), (8, 16)):
        cells = [torch.randint(0, R ** 3, (n,), generator=gen, device=device,
                               dtype=torch.int32) for R in Rs]
        d_rows = [torch.randn((n, 16), generator=gen, device=device) for _ in Rs]
        row = check_scatter(cells, d_rows, [R ** 3 for R in Rs])
        row["launches_per_step"] = int(Rs == fused_res)  # under hash_scatter: pallas
        row["cells"] = "uniform"
        scatter_rows.append(row)
    cells = ray_major_cells(ONLINE["n_rand"], ONLINE["n_samples"], ONLINE["n_around"],
                            16, gen, device)
    row = check_scatter([cells], [torch.randn((n, 16), generator=gen, device=device)],
                        [16 ** 3])
    row["launches_per_step"] = int(fused_res == (16,))
    row["cells"] = "ray-major"
    scatter_rows.append(row)
    return {"phase": "kernels",
            # cuda_ms of a call that launches nothing: the timer's own reading
            "timer_floor_ms": cuda_ms(lambda: None),
            "inputs": "seeded random: reduce caches and scatter rows normal; "
                      "scatter cells uniform, or ray-major from a seeded ray "
                      "model (ray_major_cells: 2048 rays x (128 + 64) "
                      "samples, R = 16)",
            "launches_per_step": "on the online budget's train step, which "
                                 "the train phases count",
            "reduce_cell_cache_grad": reduce_rows,
            "fused_cache_scatter": scatter_rows}


@contextlib.contextmanager
def record_calls(module, name: str, log: list):
    """Record the arguments of every call of ``module.name`` (which still
    runs) while the block runs."""
    orig = getattr(module, name)

    def rec(*args):
        log.append(args)
        return orig(*args)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


def in_situ(reduce_calls: list, scatter_calls: list) -> dict:
    """Kernel vs plain vs library on the inputs one train step handed each
    kernel; per-step sums over that step's launches."""
    red = [check_reduce(d.contiguous(), R, C, size)
           for d, R, C, size in reduce_calls]
    sca = [check_scatter(list(c), list(u), [int(r) for r in rows])
           for c, u, rows in scatter_calls]
    return {"reduce_cell_cache_grad": red, "fused_cache_scatter": sca}


# ------------------------------------------------------------- train step ---

def reset_counts() -> None:
    from bundlesdf_tpu_torch.ops import hashgrid_cuda, reduce_cuda

    reduce_cuda.launches = 0
    hashgrid_cuda.launches = 0


def read_counts() -> dict:
    from bundlesdf_tpu_torch.ops import hashgrid_cuda, reduce_cuda

    return {"reduce_cell_cache_grad": reduce_cuda.launches,
            "fused_cache_scatter": hashgrid_cuda.launches}


def make_step(budget: dict, hash_scatter, device, seed: int = 0):
    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_nof_config
    from bundlesdf_tpu_torch.nof import runner

    spec, rcfg, weights, params, rays, c2w, grid = entry.build_nof(
        **budget, hash_scatter=hash_scatter, seed=seed, device=device)
    st = runner.TrainStatics(
        spec=spec, rcfg=rcfg, weights=weights, n_rand=budget["n_rand"],
        n_step=500, trunc=0.01, trunc_start=0.01, trunc_decay_type="",
        sc_factor=1.0)
    opt = runner.make_optimizer(default_nof_config(), params)
    step = runner.make_train_step(st, opt)
    return spec, params, step, rays, c2w, grid


def run_train(name: str, hash_scatter, n_steps: int, device):
    """Drive the train step ``n_steps`` times with the launch counts set to 0
    just before and read just after; then record one more step's kernel
    inputs (outside the counted run) for the in-situ kernel timings.
    Returns the phase's result and what ``profile_phase`` needs to run
    more steps of it."""
    import torch

    from bundlesdf_tpu_torch.ops import hashgrid_cuda, reduce_cuda

    spec, params, step, rays, c2w, grid = make_step(ONLINE, hash_scatter, device)
    gen = torch.Generator(device=device).manual_seed(1)
    n_rays = rays.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    losses = []
    reset_counts()
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n_steps):
        m = step(params, i, rays, n_rays, grid, c2w, generator=gen)
        events[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    losses = [float(v) for v in torch.stack(losses).cpu()]
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n_steps)]
    warm = min(3, n_steps - 1)
    steady = step_ms[warm:]

    red_calls, sca_calls = [], []
    with record_calls(reduce_cuda, "reduce_cell_cache_grad", red_calls), \
            record_calls(hashgrid_cuda, "fused_cache_scatter", sca_calls):
        step(params, n_steps, rays, n_rays, grid, c2w, generator=gen)
    torch.cuda.synchronize()

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    level_R = [p["res"] for p in spec.grid.level_params()]
    out = {
        "phase": name, "hash_scatter": spec.grid.scatter,
        "hash_reduce": spec.grid.reduce, "big_dtype": spec.grid.big_dtype,
        "level_res": level_R, "steps": n_steps,
        "points_per_step": ONLINE["n_rand"] * (ONLINE["n_samples"]
                                               + ONLINE["n_around"]),
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
        "step_ms": sum(steady) / len(steady), "step_ms_min": min(steady),
        "step_ms_max": max(steady), "step_ms_first": step_ms[0],
        "steady_steps": len(steady), "wall_s": wall_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts,
        "in_situ": in_situ(
            [(a[0], a[1], a[2], a[3]) for a in red_calls],
            [(a[0], a[1], a[2]) for a in sca_calls]),
    }
    return out, (step, params, rays, n_rays, grid, c2w, gen, n_steps + 1)


def profile_phase(name: str, ctx, step_ms: float, out_dir: str) -> dict:
    """torch.profiler over 3 more steps of a train phase: device time by
    kernel name (the table goes to <out_dir>/profile_<name>.txt) and the
    device's idle share of the phase's timed ``step_ms``.  Runs after every
    timed phase: a profiler session leaves the host slower afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step, params, rays, n_rays, grid, c2w, gen, step0 = ctx
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3):
            step(params, step0 + i, rays, n_rays, grid, c2w, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    ka = prof.key_averages()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    rows = []
    for e in ka:
        # device-side events only (kernels, memcpy, memset): an aten op's
        # row, and a user annotation's, repeat the time of the kernels
        # they launched
        if "CUDA" not in str(e.device_type) or e.is_user_annotation:
            continue
        self_us = getattr(e, "self_device_time_total", None)
        if self_us is None:
            self_us = e.self_cuda_time_total
        rows.append({"name": e.key[:80], "device_ms_per_step": self_us / 3e3,
                     "calls_per_step": e.count / 3})
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    total = sum(r["device_ms_per_step"] for r in rows)
    # each launch of the port's kernels, in launch order, to hold the
    # in-situ CUDA-event times against
    ours = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if "CUDA" not in str(e.device_type):
            continue
        for k in ("reduce_cell_cache_grad_kernel", "fused_cache_scatter_kernel"):
            if k in e.name:
                ours.setdefault(k, []).append(e.time_range.elapsed_us())
    return {"phase": f"profile_{name}", "device_ms_per_step": total,
            "kernel_launch_us": ours,
            "device_kernels_per_step": sum(r["calls_per_step"] for r in rows),
            "timed_step_ms": step_ms,
            "device_idle_share": 1.0 - total / step_ms,
            "profiled_wall_ms_per_step": wall_ms,
            "top": rows[:25]}


def phase_small_parity(device) -> dict:
    """The train step on the card (kernels) against the same step on the CPU
    (plain versions) at a small budget: same parameters, batch and jitter.
    Both kernels are on this path (hash_scatter: pallas; bf16 levels)."""
    import torch

    from bundlesdf_tpu_torch.nof import render as nof_render
    from bundlesdf_tpu_torch.nof.runner import param_leaves

    budget = dict(n_rand=256, n_samples=32, n_around=16, num_levels=4,
                  finest_res=128, log2_hashmap=22, n_march=64, num_frames=4,
                  occ_res=32)
    spec_g, params_g, step_g, rays_g, c2w_g, grid_g = make_step(
        budget, "pallas", device)
    spec_c, params_c, step_c, rays_c, c2w_c, grid_c = make_step(
        budget, "pallas", "cpu")
    with torch.no_grad():  # same weights on both sides
        for pg, pc in zip(param_leaves(params_g), param_leaves(params_c)):
            pc.copy_(pg.cpu())
    gen = torch.Generator().manual_seed(2)
    n = budget["n_rand"]
    reset_counts()
    losses = []
    for i in range(3):
        idx = torch.randint(0, n, (n,), generator=gen)
        draws = nof_render.SampleDraws(
            torch.rand((n, budget["n_samples"]), generator=gen),
            torch.rand((n, budget["n_around"]), generator=gen),
            torch.rand((n, budget["n_around"]), generator=gen))
        mg = step_g(params_g, i, rays_g, n, grid_g, c2w_g,
                    batch_idx=idx.to(device),
                    draws=nof_render.SampleDraws(*(u.to(device) for u in draws)))
        mc = step_c(params_c, i, rays_c, n, grid_c, c2w_c, batch_idx=idx,
                    draws=draws)
        losses.append((float(mg["loss"]), float(mc["loss"])))
    counts = read_counts()
    if counts["reduce_cell_cache_grad"] != 6 or counts["fused_cache_scatter"] != 3:
        raise AssertionError(f"small_parity: kernels not on the path: {counts}")
    # step 0 is a pure forward of equal weights: f32 matmul and reduction
    # order only; later steps add one Adam update (near-zero table gradients
    # may take the other sign, see tests/test_torch_nof.py)
    for i, (lg, lc) in enumerate(losses):
        rtol = 1e-4 if i == 0 else 1e-3
        if not abs(lg - lc) <= rtol * abs(lc):
            raise AssertionError(f"small_parity step {i}: gpu {lg} cpu {lc}")
    # an Adam step moves each weight by up to lr = 1e-2 whatever its
    # gradient's size, so a weight whose gradient is near f32 rounding noise
    # may move differently on the two sides; 1e-3 over 3 steps bounds that
    mlp_err = max(max_err(pg.detach().cpu(), pc.detach())
                  for pg, pc in zip(param_leaves({k: params_g[k]
                                                  for k in ("sigma", "color")}),
                                    param_leaves({k: params_c[k]
                                                  for k in ("sigma", "color")})))
    if not mlp_err <= 1e-3:
        raise AssertionError(f"small_parity: MLP params differ by {mlp_err}")
    return {"phase": "small_parity", "budget": budget, "losses_gpu_cpu": losses,
            "mlp_param_max_abs_err": mlp_err, "launches": counts}


def summary(train: dict, scatter_train: dict) -> dict:
    """The contract line: one entry per kernel, times summed over one train
    step's launches on that step's inputs."""
    red = train["in_situ"]["reduce_cell_cache_grad"]
    sca = scatter_train["in_situ"]["fused_cache_scatter"]

    def total(rows, key):
        return sum(r[key] for r in rows)

    def lib(rows):
        vals = [r["library_ms"] for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    def entry(name, source, replaces, rows, launches):
        b_bytes = total(rows, "bytes")
        b_ops = total(rows, "ops")
        b_ms, b_by = bound(b_bytes, b_ops)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": total(rows, "kernel_ms"), "plain_ms": total(rows, "plain_ms"),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib(rows)}

    return {"kernels": [
        entry("reduce_cell_cache_grad",
              "bundlesdf_tpu_torch/csrc/reduce_cell_cache_grad.cu",
              "bundlesdf_tpu/ops/reduce_pallas.py:102", red,
              train["launches"]["reduce_cell_cache_grad"]),
        entry("fused_cache_scatter",
              "bundlesdf_tpu_torch/csrc/fused_cache_scatter.cu",
              "bundlesdf_tpu/ops/hashgrid_pallas.py:95", sca,
              scatter_train["launches"]["fused_cache_scatter"]),
    ]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile each train phase after the timed runs and "
                         "write its kernel table to DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one GPU",
              file=sys.stderr)
        return 1
    from bundlesdf_tpu_torch.ops import _cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    emit({"phase": "setup", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "allow_tf32_matmul": False, "allow_tf32_cudnn": False})

    t0 = time.perf_counter()
    info = _cuda_lib.build(force=True)
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or ln.startswith("==")]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(_cuda_lib.SOURCES), "arch": "sm_90a",
          "library": os.path.relpath(info["path"]), "ptxas": ptxas})

    emit(phase_kernels(device))
    emit(phase_small_parity(device))

    train, train_ctx = run_train("nof_train_step", None, TRAIN_STEPS, device)
    if train["launches"]["reduce_cell_cache_grad"] != 2 * TRAIN_STEPS:
        raise AssertionError(f"reduce launches {train['launches']} != 2/step")
    if not train["loss_last"] < train["loss_first"]:
        raise AssertionError(
            f"loss did not fall: {train['loss_first']} -> {train['loss_last']}")
    emit(train)

    sc, sc_ctx = run_train("nof_train_step_pallas_scatter", "pallas",
                           SCATTER_STEPS, device)
    if sc["launches"]["fused_cache_scatter"] != SCATTER_STEPS:
        raise AssertionError(f"scatter launches {sc['launches']} != 1/step")
    emit(sc)
    if args.profile:
        emit(profile_phase(train["phase"], train_ctx, train["step_ms"],
                           args.profile))
        emit(profile_phase(sc["phase"], sc_ctx, sc["step_ms"], args.profile))

    emit(summary(train, sc))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
