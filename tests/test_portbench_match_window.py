"""The benchmark's ``match_window`` driver (``portbench/drivers/
match_window.py``) on the CPU at a tiny size, in the manner of
``portbench/tests/tiny.py``: the 480 x 640 video cut to 6 frames, LoFTR at
the narrow config of tests/test_torch_loftr.py (the published threshold,
border and temperature) on 64 x 64 crops, a bucket of 4.  The harness runs
the cell through; the record has the video driver's keys and the readers
read it; the check passes on the sound run and fails on the reference in
TF32, on the program with a coarse layer left out, with its border removal
left out and with its device warp a pixel off."""
import json
import os
import types

import pytest
import torch

from bundlesdf_tpu_torch.models import loftr as lt
from portbench import run as R
from portbench.drivers import match_window
from portbench.reference import loftr as ref_loftr
from portbench.tests.loftr_faults import PATCHES, drop_last_coarse_layer
from portbench.tests.tiny import tiny_root

torch.set_num_threads(2)
CELL = "online_loftr.match_window"
NARROW = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16, nhead=4)
SEED = 2 ** 31 + 77


@pytest.fixture
def plan(tmp_path, monkeypatch):
    """The cell's plan under a tiny root, the engine and the reference's
    published widths narrowed alike."""
    monkeypatch.setattr(ref_loftr, "CVPR_DS", dict(ref_loftr.CVPR_DS, **NARROW))
    cfg_cls = lt.LoftrCfg
    monkeypatch.setattr(lt, "LoftrCfg", lambda **kw: cfg_cls(**NARROW, **kw))
    root = tiny_root(tmp_path, video_frames=6)
    path = os.path.join(root, "portbench", "configs", "online_loftr.json")
    cfg = json.load(open(path))
    cfg["track"]["feature_corres"].update(resize=64, max_matches_per_pair=48, pair_batch=4)
    json.dump(cfg, open(path, "w"))
    return R.plan(CELL, root)


def failed(checks) -> list:
    return [c["name"] for c in checks if not c["value"] <= c["limit"]]


def test_harness_runs_the_cell(plan):
    out = R.run_cell(plan, SEED, 2.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"conf_gap", "valid_mismatch", "fine_gap_px", "topk_mismatch",
                                  "warp_gap", "failed"}
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_record_readers_and_controls(plan, tmp_path):
    ctx = types.SimpleNamespace(config=plan["config"], traffic=plan["traffic"],
                                limits=plan["workload"]["limits"], seed=SEED,
                                device=torch.device("cpu"), tmp=str(tmp_path / "run"))
    cell = match_window.Cell(ctx)
    rec = cell.window(2.0)
    assert set(rec) == {"frames", "latencies_s", "window_s", "attempted", "failed", "spans"}
    assert rec["frames"] == len(rec["latencies_s"]) == rec["attempted"] > 0
    spans = rec["spans"]
    assert spans["loftr/backbone"]["parents"] == {"corres/match": spans["corres/match"]["count"]}
    assert sorted(cell.checked) == [1, 4]
    per_layer = R.read_metrics(plan, {"cfg": plan["config"], "record": rec, "trace": None},
                               "per_layer")
    for name in ("match_ms_per_frame", "loftr_pad_share", "loftr_mfu"):
        assert per_layer[name]["value"] > 0, name
    assert per_layer["loftr_pad_share"]["value"] == pytest.approx(
        1 - spans["corres/pairs"]["count"] / spans["corres/slots"]["count"])
    assert not failed(cell.verify())
    limits = ctx.limits
    sound = cell.numbers()
    assert sound["topk_mismatch"] == 0
    assert all(p["valid_at_0"] > 0 for p in sound["pairs"])
    tf32 = cell.numbers("tf32")
    assert [k for k in ("conf_gap", "fine_gap_px", "warp_gap") if tf32[k] > limits[k]]
    drop_last_coarse_layer(cell.bundler.store.matcher.module)
    cell.window(2.0)
    assert "conf_gap" in failed(cell.verify())


@pytest.mark.parametrize("fault", sorted(PATCHES))
def test_planted_faults_fail_their_check(plan, tmp_path, monkeypatch, fault):
    patch, check = PATCHES[fault]
    monkeypatch.setattr(*patch)
    ctx = types.SimpleNamespace(config=plan["config"], traffic=plan["traffic"],
                                limits=plan["workload"]["limits"], seed=SEED,
                                device=torch.device("cpu"), tmp=str(tmp_path / "run"))
    cell = match_window.Cell(ctx)
    cell.window(1.0)
    assert check in failed(cell.verify())
