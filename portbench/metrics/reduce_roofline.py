"""``reduce_roofline``: the cache-gradient reduce kernel's byte bound (the
bf16 cache read once and the f32 table gradient written once a bf16 level
a microbatch, at 3.35 TB/s; ``costs.py``) over its device time summed from
the traced slice's kernels, in %.  Nothing to read where no reduce kernel
ran."""
from portbench import costs

KERNEL = "reduce_cell_cache_grad"


def read(run):
    t = run["trace"]
    if t is None or "steps" not in run["record"]:
        return None
    secs = sum(k["seconds"] for name, k in t["kernels"].items() if KERNEL in name)
    bound = costs.reduce_bound_ms_per_step(run["cfg"]["nof"])
    if secs <= 0 or bound is None:
        return None
    return 100.0 * bound * 1e-3 * t["units"] / secs
