"""The XMem cell's controls, read on the card at the cell's own size
(``-m card``; they skip on the CPU).  Each seed builds the cell (its
frames, weights and segmenter; no warm-up session), runs the check's
session (575 frames, then 25 teacher-forced against the plain reference)
and prints one JSON line with the readings that
``workloads/online_xmem.segment600.json``'s limits were set from:
``program`` (the sound readings) and, on the first three seeds, ``tf32``
(the reference in TF32 in the program's place, over a second session), and
the peak memory.  On the first seed, ``unpotentiated`` (``xmem_faults``:
prototypes that keep their candidates' values) runs over a third session
with its shares, and again on weights with softened keys (``soft_keys``):
it has to fail ``memory_gap`` alone on both.

Every sound reading has to pass the limits, every control has to fail at
least one, and no precision switch may be left changed.
"""
import json
import tempfile
import types

import pytest
import torch

from portbench import run as R
from portbench.drivers import common, xmem_segment
from portbench.tests import xmem_faults

pytestmark = pytest.mark.card
CELL = "online_xmem.segment600"
SEEDS = tuple(2 ** 31 + 7000 + 101 * i for i in range(6))
CONTROL_SEEDS = SEEDS[:3]


def switches() -> tuple:
    b = torch.backends
    return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.enabled, b.cudnn.benchmark,
            torch.get_float32_matmul_precision())


def held(limits, nums) -> list:
    return [k for k, v in nums.items() if k in limits and not v <= limits[k]]


def context(p, seed, card):
    return types.SimpleNamespace(config=p["config"], traffic=dict(p["traffic"], warm_frames=0),
                                 limits=p["workload"]["limits"], seed=seed, device=card,
                                 tmp=tempfile.mkdtemp(prefix="portbench-"))


def unpotentiated(c) -> dict:
    with xmem_faults.unpotentiated() as shares:
        nums = c.numbers()
    nums.pop("frames")
    return {"numbers": nums, "shares": shares}


def test_xmem_controls_fail_the_limits(card, monkeypatch):
    p = R.plan(CELL)
    limits = p["workload"]["limits"]
    torch.cuda.init()
    before = switches()
    rows = []
    for seed in SEEDS:
        ctx = context(p, seed, card)
        torch.cuda.reset_peak_memory_stats(card)
        c = xmem_segment.Cell(ctx)
        row = {"cell": CELL, "seed": seed, "program": c.numbers()}
        row["peak_bytes"] = torch.cuda.max_memory_allocated(card)
        if seed in CONTROL_SEEDS:
            row["tf32"] = c.numbers("tf32")
        if seed == SEEDS[0]:
            row["unpotentiated"] = unpotentiated(c)
        assert c.failed == 0, seed
        rows.append(row)
        print(json.dumps(row), flush=True)
        c = None
        common.free(card)
    make = xmem_segment.ref_xmem.make_weights
    monkeypatch.setattr(xmem_segment.ref_xmem, "make_weights",
                        lambda seed, w: xmem_faults.soft_keys(make(seed, w)))
    c = xmem_segment.Cell(context(p, SEEDS[0], card))
    soft = {"cell": CELL, "seed": SEEDS[0], "soft_keys": c.numbers(),
            "soft_unpotentiated": unpotentiated(c)}
    print(json.dumps(soft), flush=True)
    c = None
    common.free(card)
    assert switches() == before
    for r in rows:
        assert not held(limits, r["program"]), r
        if "tf32" in r:
            assert held(limits, r["tf32"]), r
        if "unpotentiated" in r:
            assert held(limits, r["unpotentiated"]["numbers"]) == ["memory_gap"], r
    assert not held(limits, soft["soft_keys"]), soft
    assert held(limits, soft["soft_unpotentiated"]["numbers"]) == ["memory_gap"], soft
