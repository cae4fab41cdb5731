"""The benchmark's ``loftr_train`` driver (``portbench/drivers/
loftr_train.py``) on the CPU at a tiny size, in the manner of
``portbench/tests/tiny.py``: the configuration at the narrow LoFTR of
tests/test_torch_loftr.py on 64 x 64 pairs, 2 a step, the whole 8 x 8 grid
labelled and the fine branch at 12 cells.  The harness runs the cell
through; the record has the ``nof_train`` driver's keys and the readers
read it; the checked steps are the trainer's own draws; the check passes
on the sound run and fails on the reference in TF32, on a fine loss
halved and on labels capped below the grid."""
import json
import os
import types

import pytest
import torch

from bundlesdf_tpu_torch.models import loftr as lt
from bundlesdf_tpu_torch.models import loftr_train as tlt
from portbench import costs, loftr_train_costs
from portbench import run as R
from portbench.drivers import loftr_train
from portbench.reference import loftr as ref_loftr
from portbench.tests.tiny import tiny_root

torch.set_num_threads(2)
CELL = "loftr_train.homography840"
NARROW = dict(initial_dim=16, block_dims=[16, 24, 32], d_coarse=32, d_fine=16, nhead=4)
TINY = dict(H=64, W=64, batch=2, max_gt=64, fine_gt=12)
SEED = 2 ** 31 + 77


def tiny_plan(tmp_path, **train) -> dict:
    root = tiny_root(tmp_path)
    path = os.path.join(root, "portbench", "configs", "loftr_train.json")
    cfg = json.load(open(path))
    cfg["loftr"].update(NARROW)
    cfg["train"].update(TINY, **train)
    json.dump(cfg, open(path, "w"))
    path = os.path.join(root, "portbench", "traffic", "homography840.json")
    traffic = json.load(open(path))
    traffic.update(warm_steps=0, trace_steps=1)
    json.dump(traffic, open(path, "w"))
    return R.plan(CELL, root)


def context(plan, tmp_path):
    return types.SimpleNamespace(config=plan["config"], traffic=plan["traffic"],
                                 limits=plan["workload"]["limits"], seed=SEED,
                                 device=torch.device("cpu"), tmp=str(tmp_path / "run"))


def failed(checks) -> list:
    return [c["name"] for c in checks if not c["value"] <= c["limit"]]


def test_harness_runs_the_cell(tmp_path):
    out = R.run_cell(tiny_plan(tmp_path), SEED, 1.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap", "conf_gap",
                                  "gt_dropped", "failed"}
    assert set(out["metrics"]) == {"train_step_ms", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_record_readers_and_controls(tmp_path):
    plan = tiny_plan(tmp_path)
    cell = loftr_train.Cell(context(plan, tmp_path))
    rec = cell.window(1.0)
    assert set(rec) == {"steps", "window_s", "attempted", "failed", "spans"}
    assert rec["steps"] == rec["attempted"] > 0 and rec["failed"] == 0
    spans = rec["spans"]
    assert spans["loftr_train/make_batch"]["count"] == rec["steps"]
    assert spans["loftr_train/fine_windows"]["count"] == rec["steps"] * 2 * 12
    assert spans["loftr/backbone"]["parents"] == {"loftr_train/forward": rec["steps"]}
    trace = {"busy_s": 0.9, "window_s": 1.0}
    got = R.read_metrics(plan, {"cfg": plan["config"], "record": rec, "trace": trace},
                         "per_layer")
    assert set(got) == {"device_idle_share.train", "loftr_train_mfu", "pairgen_ms_per_step"}
    assert got["pairgen_ms_per_step"]["value"] == pytest.approx(
        spans["loftr_train/make_batch"]["total_s"] * 1e3 / rec["steps"])
    w = dict(ref_loftr.CVPR_DS, **NARROW)
    flops = 2 * loftr_train_costs.step_flops(w, 64, 64, 12)
    assert got["loftr_train_mfu"]["value"] == pytest.approx(
        100 * flops * rec["steps"] / rec["window_s"] / costs.PEAK_F32_FLOPS)
    untraced = R.read_metrics(plan, {"cfg": plan["config"], "record": rec, "trace": None},
                              "per_layer")
    assert set(untraced) == {"pairgen_ms_per_step"}
    cell.failed = rec["failed"]
    checks = cell.verify()
    assert not failed(checks), checks
    tf32 = cell.numbers("tf32")
    limits = plan["workload"]["limits"]
    assert {"loss_gap", "conf_gap"} <= {k for k, v in tf32.items()
                                         if k in limits and v > limits[k]}


def test_checked_steps_are_the_trainers_own_draws(tmp_path):
    """Set-up's three steps (a batch, then the fine draws, from the
    generator) leave the weights that ``step(generator=...)`` leaves."""
    plan = tiny_plan(tmp_path)
    cell = loftr_train.Cell(context(plan, tmp_path))
    tcfg = loftr_train.train_config(tlt, plan["config"])
    module = lt.load_weights(lt.LoftrModule(lt.LoftrCfg(**loftr_train.widths(plan["config"]))),
                             cell.sd).train()
    step = tlt.make_train_step(module, tcfg, tlt.LoftrOptimizer(
        tlt.trainable(module), tcfg, int(plan["config"]["train"]["n_steps"])))
    gen = torch.Generator().manual_seed(SEED)
    losses = [float(step(generator=gen)["loss"]) for _ in range(3)]
    assert losses == cell.first["losses"]
    for (k, a), b in zip(module.state_dict().items(), cell.module.state_dict().values()):
        assert torch.equal(a, b), k


def test_a_halved_fine_loss_fails_the_loss_check(tmp_path, monkeypatch):
    plan = tiny_plan(tmp_path)
    fine_l2 = tlt.fine_l2_loss
    monkeypatch.setattr(tlt, "fine_l2_loss", lambda *a, **k: 0.5 * fine_l2(*a, **k))
    cell = loftr_train.Cell(context(plan, tmp_path))
    assert "loss_gap" in failed(cell.verify())


def test_labels_capped_below_the_grid_fail_gt_dropped(tmp_path):
    plan = tiny_plan(tmp_path, max_gt=16)
    cell = loftr_train.Cell(context(plan, tmp_path))
    cell.window(0.5)
    assert cell.dropped > 0
    assert "gt_dropped" in failed(cell.verify())
