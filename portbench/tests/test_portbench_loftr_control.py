"""The LoFTR cell's controls, read on the card at the cell's own size
(``-m card``; they skip on the CPU).  Each seed builds the cell, runs
``FRAMES`` frames of a session (the last one matches the reference pair at
batch 1 and eight window pairs padded to 16), and prints one JSON line with
the readings that ``workloads/online_loftr.match_window.json``'s limits
were set from:

- ``program``: the engine's last call of each batch size against the plain
  reference (the sound readings);
- on the first three seeds, ``tf32``: the reference in TF32 (switches on,
  operands rounded) in the program's place, and the faults of
  ``loftr_faults.py`` planted in the program one at a time, each over
  ``FAULT_FRAMES`` frames of a fresh session: ``coarse`` (its last coarse
  cross layer left out), ``warp`` (its device warp a pixel off) and
  ``selection`` (its border removal left out).

Each control has to fail at least one of the cell's limits, each fault the
check it is planted for, each sound reading has to pass them all, and no
precision switch may be left changed.
"""
import json
import tempfile
import types

import pytest
import torch

from portbench import run as R
from portbench.drivers import common, match_window
from portbench.tests.loftr_faults import PATCHES, drop_last_coarse_layer

pytestmark = pytest.mark.card
CELL = "online_loftr.match_window"
SEEDS = tuple(2 ** 31 + 3000 + 101 * i for i in range(12))
CONTROL_SEEDS = SEEDS[:3]
FRAMES = 12
FAULT_FRAMES = 4


def switches() -> tuple:
    b = torch.backends
    return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.enabled, b.cudnn.benchmark,
            b.cudnn.deterministic, torch.get_float32_matmul_precision(),
            torch.are_deterministic_algorithms_enabled())


def readings(cell, frames: int, precision: str = "ref") -> dict:
    for _ in range(frames):
        cell._next()
    cell.checked = dict(cell.recorder.last)
    nums = cell.numbers(precision)
    nums.pop("pairs")
    return nums


def held(limits, nums) -> list:
    return [k for k, v in nums.items() if k in limits and not v <= limits[k]]


def test_loftr_controls_fail_the_limits(card, monkeypatch):
    p = R.plan(CELL)
    limits = p["workload"]["limits"]
    before = switches()
    rows = []
    for seed in SEEDS:
        ctx = types.SimpleNamespace(config=p["config"], traffic=p["traffic"], limits=limits,
                                    seed=seed, device=card,
                                    tmp=tempfile.mkdtemp(prefix="portbench-"))
        c = match_window.Cell(ctx)
        row = {"cell": CELL, "seed": seed, "program": readings(c, FRAMES)}
        if seed in CONTROL_SEEDS:
            row["tf32"] = readings(c, 0, "tf32")
            for name, (patch, _) in sorted(PATCHES.items()):
                with monkeypatch.context() as m:
                    m.setattr(*patch)
                    c._restart()
                    row[name] = readings(c, FAULT_FRAMES)
            drop_last_coarse_layer(c.bundler.store.matcher.module)
            c._restart()
            row["coarse"] = readings(c, FAULT_FRAMES)
        assert c.failed == 0, seed
        rows.append(row)
        print(json.dumps(row), flush=True)
        c = None
        common.free(card)
    assert switches() == before
    for r in rows:
        assert not held(limits, r["program"]), r
        if "tf32" in r:
            assert held(limits, r["tf32"]), r
            assert "conf_gap" in held(limits, r["coarse"]), r
            for name, (_, check) in PATCHES.items():
                assert check in held(limits, r[name]), (name, r)
