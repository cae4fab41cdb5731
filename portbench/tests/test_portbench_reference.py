"""The plain reference of the NOF step held against the port's CPU path at a
tiny size: from the same weights, ray pool, grid and draws, one step's loss
and every leaf's gradient as Adam gets it.  This checks the reference; the
benchmark's runs compare it with the program on the card."""
import json
import os
import tempfile
import types

import pytest
import torch

from portbench import run as R
from portbench.drivers import common, nof_train
from portbench.reference import nof_step
from portbench.tests.tiny import tiny_root


def rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@pytest.mark.parametrize("cell", ["online.nof_train", "offline.nof_train"])
def test_reference_step_matches_the_port_on_the_cpu(cell, tmp_path):
    p = R.plan(cell, tiny_root(tmp_path))
    ctx = types.SimpleNamespace(config=p["config"], traffic=p["traffic"],
                                limits=p["workload"]["limits"], seed=2 ** 31 + 1,
                                device=torch.device("cpu"), tmp=tempfile.mkdtemp(dir=tmp_path))
    c = nof_train.Cell(ctx)
    r = c.runner
    # the program again from the start, one step on the first recorded draws
    with torch.no_grad():
        for name, t in nof_step.named_leaves(r.params):
            t.copy_(c.params0[name])
    r.optimizer.reset()
    n_rays, idx, u = c.first["draws"][0]
    r.train_draws = lambda step, n: (idx, u)
    r.train_advance(1)
    loss = r.train_drain()["loss"]
    group = r.optimizer.groups[0]
    index = {id(t): i for i, t in enumerate(group["params"])}
    got = {name: group["exp_avg"][index[id(t)]] / (1 - nof_step.B1)
           for name, t in nof_step.named_leaves(r.params)}

    params = common.unflatten(c.params0, "cpu")
    res = nof_step.train(c.cfg, params, nof_step.fresh_adam(params),
                         torch.from_numpy(c.pool["rays"]), c.pool["grid"],
                         torch.from_numpy(c.pool["c2w"]), [c.first["draws"][0]], "ref",
                         c.microbatches)
    assert res["losses"][0] == pytest.approx(loss, rel=1e-6)
    staged = {f"table.L{i}" for i, lv in enumerate(nof_step.grid_levels(c.cfg)) if lv["staged"]}
    mine = nof_step.compared_leaves(c.cfg, common.unflatten(got, "cpu"))
    ref = nof_step.compared_leaves(c.cfg, common.unflatten(res["first_grad"], "cpu"))
    assert staged or cell.startswith("offline")
    for name in ref:
        if ref[name].norm() == 0:
            assert mine[name].norm() == 0, name
            continue
        # the program sums a staged level's gradient in bfloat16 (the
        # configuration's staging), the reference in float32
        assert rel_l2(mine[name], ref[name]) < (2e-2 if name in staged else 1e-4), name
    if cell.startswith("offline"):
        assert c.microbatches > 1 and "feature_array" in params


def test_three_steps_through_the_harness_agree(tmp_path):
    """The numbers a run compares, on the CPU, where the program sums in
    float32 but for the staged level: well inside the cells' limits."""
    p = R.plan("online.nof_train", tiny_root(tmp_path))
    out = R.run_cell(p, 2 ** 31 + 77, 0.5, False, "cpu")
    checks = out["checks"]
    assert checks["loss_gap.first"]["value"] < 1e-6
    assert checks["grad_gap"]["value"] < 1e-2
    assert checks["grad_gap.f32"]["value"] < 1e-5
    assert checks["change_gap"]["value"] < 1e-2
    assert checks["pool_mismatches"]["value"] == 0
    json.dumps(out)


def test_control_precision_moves_the_reference(tmp_path):
    """The control (TF32 matmuls, float8 staging) computes other numbers
    than the reference from the same inputs."""
    p = R.plan("online.nof_train", tiny_root(tmp_path))
    ctx = types.SimpleNamespace(config=p["config"], traffic=p["traffic"],
                                limits=p["workload"]["limits"], seed=9,
                                device=torch.device("cpu"), tmp=str(tmp_path))
    c = nof_train.Cell(ctx)
    adam = nof_step.fresh_adam(c.params0)
    ref = common.reference_steps(c.cfg, c.params0, adam, c.pool, c.first["draws"], "cpu", 1)
    ctl = common.reference_steps(c.cfg, c.params0, adam, c.pool, c.first["draws"], "cpu", 1,
                                 precision="control")
    assert ctl["grad_norms"] != ref["grad_norms"]
    assert os.path.isdir(ctx.tmp)
