"""A run with its timed path broken underneath comes out not ``correct``:
the harness is driven past its look for a card, on the CPU at a tiny
size, with each fault that a cell can have planted in the program.  (No
cell spans chips, so the exchange between chips has no fault here.)"""
import numpy as np
import torch

from portbench import run as R
from portbench.tests.tiny import tiny_root


def run(tmp_path, cell, seconds=0.5, **kw):
    return R.run_cell(R.plan(cell, tiny_root(tmp_path, **kw)), 2 ** 31 + 21, seconds, False,
                      "cpu")


def failed(out) -> list:
    return [k for k, c in out["checks"].items() if not c["value"] <= c["limit"]]


def test_sound_tiny_runs_are_correct(tmp_path):
    assert run(tmp_path, "online.nof_train")["correct"]


def test_a_step_that_leaves_the_state_unchanged(tmp_path, monkeypatch):
    from bundlesdf_tpu_torch.nof import runner

    monkeypatch.setattr(runner.NofOptimizer, "step", lambda self: None)
    out = run(tmp_path, "online.nof_train")
    assert not out["correct"] and "change_gap" in failed(out)


def test_half_the_batch_left_out(tmp_path, monkeypatch):
    from bundlesdf_tpu_torch.nof import runner

    make = runner.make_loss_fn

    def half_loss(st, mesh=None):
        fn = make(st, mesh)

        def loss_fn(params, batch, grid, c2w, step, draws=None, generator=None):
            h = batch.shape[0] // 2
            return fn(params, batch[:h], grid, c2w, step,
                      None if draws is None else draws.rows(slice(0, h)), generator)

        return loss_fn

    monkeypatch.setattr(runner, "make_loss_fn", half_loss)
    out = run(tmp_path, "online.nof_train")
    assert not out["correct"] and failed(out)


def test_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch):
    """A gradient altered in the step (the colour head's bias's, doubled),
    and a pose altered in the tracker's answer (5 mm on one frame)."""
    from bundlesdf_tpu_torch.nof import runner
    from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

    step = runner.NofOptimizer.step

    def doubled(self):
        for p in self.groups[0]["params"]:
            if p.numel() == 3 and p.grad is not None:
                p.grad.mul_(2.0)
        step(self)

    monkeypatch.setattr(runner.NofOptimizer, "step", doubled)
    out = run(tmp_path / "nof", "online.nof_train")
    assert not out["correct"] and "grad_gap" in failed(out)
    monkeypatch.setattr(runner.NofOptimizer, "step", step)

    run_frame = BundleSdf.run

    def moved(self, color, depth, K, id_str, *a, **kw):
        f = run_frame(self, color, depth, K, id_str, *a, **kw)
        if id_str == "00002":
            pose = self.poses_log[id_str].copy()
            pose[:3, 3] += np.array([0.005, 0.0, 0.0])
            self.poses_log[id_str] = pose
        return f

    monkeypatch.setattr(BundleSdf, "run", moved)
    out = run(tmp_path / "track", "online.track_only", seconds=12.0, video_frames=4)
    assert not out["correct"] and "pose_add_mm" in failed(out)


def test_joint_loop_with_a_step_that_changes_nothing(tmp_path, monkeypatch):
    from bundlesdf_tpu_torch.nof import runner

    sound = run(tmp_path / "sound", "online.joint_video", seconds=40.0, video_frames=6)
    assert sound["correct"], sound["checks"]
    monkeypatch.setattr(runner.NofOptimizer, "step", lambda self: None)
    out = run(tmp_path / "broken", "online.joint_video", seconds=40.0, video_frames=6)
    assert not out["correct"] and "change_gap" in failed(out)
    torch.set_grad_enabled(True)
