"""The yardstick's arithmetic: the H100's published peaks and the operations
and bytes that a NOF step's work needs, computed from the configuration's
widths alone.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit; the card's limit is printed beside every run.
"""
from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores

# The hash grid's dense levels at or above this many cells are staged in
# bfloat16 under ``hash_big_dtype: bfloat16`` (R = 64 and R = 128 online).
BIG_CACHE_CELLS = 1 << 18

# The field's widths (reference NeRFSmall): sigma net in -> 64 -> 1 + 15,
# color net (SH + frame features + 15) -> 64 -> 64 -> 3.
HIDDEN = 64
GEO_FEAT = 15


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The least time the chip could take for this work, in ms, and which
    of the two peaks bounds it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reduce_cost(R: int, C: int, size: int) -> tuple[float, float]:
    """One call of the cache-gradient reduce of a bf16 level of resolution
    ``R``: bytes (the bf16 (R^3, 8C) cache read once, the f32 (size, C)
    table gradient written once) and adds."""
    return R ** 3 * 8 * C * 2 + size * C * 4, R ** 3 * 8 * C


def scatter_cost(n: int, width: int, rows: list) -> tuple[float, float]:
    """The fused scatter of ``len(rows)`` small levels: bytes (indices and
    updates read once per level, accumulators written once) and adds."""
    k = len(rows)
    return k * n * (4 + 4 * width) + sum(rows) * width * 4, k * n * width


def grid_levels(cfg: dict) -> list:
    """Per level of the multiresolution hash grid: its scale, resolution,
    table rows (dense row-major while ``(res + 1)^3`` fits the table, the
    hash's table size beyond, rounded up to 8), offset in the flat table,
    dense or hashed, and whether it is staged in bfloat16 (a big dense
    level under ``hash_big_dtype: bfloat16``)."""
    L, base, finest = int(cfg["num_levels"]), int(cfg["base_res"]), int(cfg["finest_res"])
    hashmap = 1 << int(cfg["log2_hashmap_size"])
    log_scale = 0.0 if L == 1 else math.log2(finest / base) / (L - 1)
    out, offset = [], 0
    for lv in range(L):
        scale = 2.0 ** (lv * log_scale) * base - 1.0
        res = int(math.ceil(scale)) + 1
        dense = (res + 1) ** 3 <= hashmap
        size = int(math.ceil(min((res + 1) ** 3, hashmap) / 8)) * 8
        staged = (cfg.get("hash_big_dtype") == "bfloat16" and dense
                  and res ** 3 >= BIG_CACHE_CELLS)
        out.append({"scale": scale, "res": res, "size": size, "offset": offset,
                    "dense": dense, "staged": staged})
        offset += size
    return out


def microbatches(cfg: dict) -> int:
    """Gradient-accumulation chunks a step: ``micro_batch`` rays a chunk
    where the config sets it, else the runner's 2M-element budget of rays x
    samples x levels, split into equal divisors of N_rand."""
    n_rand = int(cfg["N_rand"])
    if int(cfg.get("micro_batch", 0) or 0):      # the config's own chunk of rays
        return -(-n_rand // int(cfg["micro_batch"]))
    load = n_rand * samples_per_ray(cfg) * int(cfg["num_levels"])
    budget = 2 * 1024 * 1024
    if load <= budget:
        return 1
    for div in range((load + budget - 1) // budget, n_rand + 1):
        if n_rand % div == 0:
            return div
    return n_rand


def samples_per_ray(cfg: dict) -> int:
    return int(cfg["N_samples"]) + int(cfg["N_samples_around_depth"]) + int(
        cfg.get("N_importance", 0))


def mlp_flops_per_sample(cfg: dict) -> float:
    """Forward GEMM FLOPs of the two MLPs for one sample point."""
    sigma_in = int(cfg["num_levels"]) * int(cfg["feature_grid_dim"])
    color_in = int(cfg["multires_views"]) ** 2 + int(cfg["frame_features"]) + GEO_FEAT
    sigma = sigma_in * HIDDEN + HIDDEN * (1 + GEO_FEAT)
    color = color_in * HIDDEN + HIDDEN * HIDDEN + HIDDEN * 3
    return 2.0 * (sigma + color)


def step_model_flops(cfg: dict) -> float:
    """A training step's model FLOPs: the MLPs' GEMMs forward, and twice
    that backward (the input and the weight gradients), over every sample
    of the N_rand rays.  The hash-grid encode and the elementwise work are
    not counted: they are no GEMM."""
    return 3.0 * mlp_flops_per_sample(cfg) * int(cfg["N_rand"]) * samples_per_ray(cfg)


def reduce_bound_ms_per_step(cfg: dict) -> float | None:
    """The byte bound of one step's reduce calls (one a bf16 level a
    microbatch), in ms; None when the configuration stages no level in
    bf16 (the reduce is then off the path)."""
    C = int(cfg["feature_grid_dim"])
    levels = [p for p in grid_levels(cfg) if p["staged"]]
    if not levels:
        return None
    n_bytes = sum(reduce_cost(p["res"], C, p["size"])[0] for p in levels)
    n_ops = sum(reduce_cost(p["res"], C, p["size"])[1] for p in levels)
    return bound_ms(n_bytes, n_ops)[0] * microbatches(cfg)
