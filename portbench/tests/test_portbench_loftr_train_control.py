"""The LoFTR training cell's controls, read on the card at the cell's own
size (``-m card``; they skip on the CPU).  Each seed builds the cell (its
three checked steps at 840 x 840, 4 pairs), frees the program's state, and
prints one JSON line with the readings that
``workloads/loftr_train.homography840.json``'s limits were set from:
``program`` (the sound readings against the plain reference) and, on the
first three seeds, ``tf32`` (the reference in TF32 in the program's place),
and the peak memory of the program's steps.

Every sound reading has to pass the limits, every control has to fail at
least one, and no precision switch may be left changed.
"""
import json
import tempfile
import types

import pytest
import torch

from portbench import run as R
from portbench.drivers import common, loftr_train

pytestmark = pytest.mark.card
CELL = "loftr_train.homography840"
SEEDS = tuple(2 ** 31 + 5000 + 101 * i for i in range(6))
CONTROL_SEEDS = SEEDS[:3]


def switches() -> tuple:
    b = torch.backends
    return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.enabled, b.cudnn.benchmark,
            torch.get_float32_matmul_precision())


def held(limits, nums) -> list:
    return [k for k, v in nums.items() if k in limits and not v <= limits[k]]


def test_loftr_train_controls_fail_the_limits(card):
    p = R.plan(CELL)
    limits = p["workload"]["limits"]
    torch.cuda.init()
    before = switches()
    rows = []
    for seed in SEEDS:
        ctx = types.SimpleNamespace(config=p["config"], traffic=dict(p["traffic"], warm_steps=0),
                                    limits=limits, seed=seed, device=card,
                                    tmp=tempfile.mkdtemp(prefix="portbench-"))
        torch.cuda.reset_peak_memory_stats(card)
        c = loftr_train.Cell(ctx)
        peak = torch.cuda.max_memory_allocated(card)
        c.release()
        row = {"cell": CELL, "seed": seed, "peak_bytes": peak, "losses": c.first["losses"]}
        row["program"] = c.numbers()
        if seed in CONTROL_SEEDS:
            row["tf32"] = c.numbers("tf32")
        rows.append(row)
        print(json.dumps(row), flush=True)
        c = None
        common.free(card)
    assert switches() == before
    for r in rows:
        assert not held(limits, r["program"]), r
        if "tf32" in r:
            assert held(limits, r["tf32"]), r
