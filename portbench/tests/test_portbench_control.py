"""The controls, read on the card at the cells' own sizes (``-m card``;
they skip on the CPU).  Each prints one JSON line a seed with the
readings that the limits in ``workloads/*.json`` were set from:

- the training cells: on a dozen seeds, the program's three first steps
  against the plain reference (the lower readings); on the first three,
  also the control (the reference one precision down: TF32 matmuls,
  float8 staging) in the program's place, and a planted fault (the
  reference with half of every microbatch left out);
- the joint loop: the same from the state of a session's runner after
  ``FRAMES`` frames;
- the pose checks: the truth computed in bfloat16 (``video.synth_poses_in``)
  in the tracker's place.

Each control has to fail at least one of its cell's limits, and each
sound reading has to pass them all.
"""
import json
import os
import tempfile
import types

import numpy as np
import pytest
import torch

from portbench import costs, run as R, video
from portbench.drivers import common, nof_train
from portbench.drivers import video as video_driver

pytestmark = pytest.mark.card
SEEDS = tuple(2 ** 31 + 1000 + 97 * i for i in range(12))
CONTROL_SEEDS = SEEDS[:3]
FRAMES = 8


def ctx_for(cell, seed, device, tmp):
    p = R.plan(cell)
    return p, types.SimpleNamespace(config=p["config"], traffic=p["traffic"],
                                    limits=p["workload"]["limits"], seed=seed, device=device,
                                    tmp=tmp)


def readings(cfg, first, params0, adam0, pool, device, mb, controls: bool) -> dict:
    ref = common.reference_steps(cfg, params0, adam0, pool, first["draws"], device, mb)
    out = {"program": common.step_numbers(cfg, first, ref)}
    if controls:
        for name, kw in (("control", {"precision": "control"}), ("half_batch", {"drop_half": True})):
            got = common.reference_steps(cfg, params0, adam0, pool, first["draws"], device, mb,
                                         **kw)
            out[name] = common.step_numbers(cfg, got, ref)
    return out


def held(limits, nums) -> list:
    """The numbers that the cell compares and that fail their limits."""
    return [k for k, v in nums.items() if k in limits and not v <= limits[k]]


def judge(rows: list, limits: dict) -> None:
    """Every sound reading passes, every control and fault fails one."""
    for r in rows:
        assert not held(limits, r["program"]), r["seed"]
        for name in ("control", "half_batch"):
            assert name not in r or held(limits, r[name]), (name, r["seed"])


@pytest.mark.parametrize("cell", ["online.nof_train", "offline.nof_train"])
def test_training_controls_fail_the_limits(card, cell):
    rows = []
    for seed in SEEDS:
        tmp = tempfile.mkdtemp(prefix="portbench-")
        p, ctx = ctx_for(cell, seed, card, tmp)
        c = nof_train.Cell(ctx)
        c.runner = None
        common.free(card)
        from portbench.reference import nof_step

        r = readings(c.cfg, c.first, c.params0, nof_step.fresh_adam(c.params0), c.pool, card,
                     c.microbatches, seed in CONTROL_SEEDS)
        rows.append({"cell": cell, "seed": seed, **r})
        print(json.dumps(rows[-1]), flush=True)
    judge(rows, p["workload"]["limits"])


def test_joint_controls_fail_the_limits(card):
    rows = []
    for seed in SEEDS:
        tmp = tempfile.mkdtemp(prefix="portbench-")
        p, ctx = ctx_for("online.joint_video", seed, card, tmp)
        c = video_driver.Cell(ctx)
        for _ in range(FRAMES):
            c._next()
        runner, c.pipe, c.runner = c.runner, None, None
        params0, adam0 = common.snapshot(runner)
        pool = {"rays": runner.rays_np.copy(), "grid": runner.occ_grid.detach().cpu().clone(),
                "c2w": runner.c2w_np.copy()}
        cfg = dict(runner.cfg)
        first = common.first_steps(runner, 3, c.nof_draws)
        runner = None
        common.free(card)
        r = readings(cfg, first, params0, adam0, pool, card, costs.microbatches(cfg),
                     seed in CONTROL_SEEDS)
        rows.append({"cell": "online.joint_video", "seed": seed, "frames": FRAMES, **r})
        print(json.dumps(rows[-1]), flush=True)
    judge(rows, p["workload"]["limits"])


def test_pose_control_fails_the_limits(card):
    cell = "online.track_only"
    p = R.plan(cell)
    t = p["traffic"]
    args = (int(t["frames"]), float(t["deg_step"]), float(t["wobble"]))
    gts = np.stack(video.synth_poses(*args))
    pts = video.cube_model_points(float(t["half"]))
    with torch.device(card):
        preds = video.synth_poses_in(torch.bfloat16, *args)
    for seed in CONTROL_SEEDS:
        sessions = [{"preds": list(preds), "gt": list(gts), "fails": 0}]
        checks = common.pose_checks(sessions, pts, p["workload"]["limits"])
        print(json.dumps({"cell": cell, "seed": seed, "control_bf16": {
            c["name"]: c["value"] for c in checks}}), flush=True)
        assert any(c["value"] > c["limit"] for c in checks if c["name"] != "fail_frames")
    assert os.path.isdir(tempfile.gettempdir())
