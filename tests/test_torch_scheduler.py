"""The NOF scheduler of the port's BundleSdf: the behaviours that
tests/test_pipeline.py:196-325 hold the JAX scheduler to (loose-sync rounds,
extension budgets, the calibration debt), plus the joint loop's surface:
strict sync on the shipped settings, pose feedback, the mesh, and the
arguments that are not ported yet."""
import numpy as np
import pytest
import torch

from synthetic_cube import make_cube_sequence
from test_pipeline import small_nof_cfg, small_track_cfg
from bundlesdf_tpu_torch import entry
from bundlesdf_tpu_torch.config import Cfg, default_nof_config, default_track_config
from bundlesdf_tpu_torch.utils import profiler

torch.set_num_threads(2)


def _cfgs(**nof):
    return (Cfg.wrap(default_track_config().merged(small_track_cfg())),
            Cfg.wrap(default_nof_config().merged(small_nof_cfg()).merged(nof)))


@pytest.fixture(scope="module")
def data():
    return make_cube_sequence(n_frames=8, deg_per_frame=6.0)


def _feed(pipe, data, n):
    for k in range(n):
        pipe.run(data["colors"][k], data["depths"][k], data["K"], f"{k:04d}",
                 mask=data["masks"][k])


def _count_rounds(pipe, log):
    orig = pipe._nof_round_start

    def counting():
        orig()
        log.append((pipe.cnt, pipe._nof_steps_left))

    pipe._nof_round_start = counting


def test_loose_sync_batches_nof_rounds(data):
    """sync_max_delay 3: a round is dispatched in chunks while tracking goes
    on, and the tracker blocks only at a new keyframe once the backlog
    reaches 3, so there are fewer round starts than keyframes; feedback is
    applied and on_finish drains the rest."""
    pipe = entry.build_pipeline(*_cfgs(sync_max_delay=3, loop_chunk=5),
                                start_nerf_keyframes=3, device="cpu")
    rounds = []
    _count_rounds(pipe, rounds)
    _feed(pipe, data, 8)
    n_kf = len(pipe.bundler.keyframes)
    pipe.on_finish()
    assert n_kf >= 6
    assert 1 <= len(rounds) < n_kf, (rounds, n_kf)
    assert pipe._nof_steps_left == 0 and not pipe._nof_open
    assert pipe._kf_sent == n_kf
    assert any(kf.nerfed for kf in pipe.bundler.keyframes)


def test_extension_rounds_use_n_step_extend(data):
    """The first round runs n_step, extensions n_step_extend, and the steps
    dispatched equal the rounds' budgets (no calibration chunk)."""
    pipe = entry.build_pipeline(
        *_cfgs(n_step=20, n_step_extend=5, loop_chunk=5, sync_max_delay=0,
               calibrate_step=False),
        start_nerf_keyframes=3, device="cpu")
    starts, trained = [], []
    orig = pipe._nof_round_start

    def counting():
        orig()
        starts.append(pipe._nof_steps_left)
        if not getattr(pipe.nof, "_adv_hooked", False):
            pipe.nof._adv_hooked = True
            orig_adv = pipe.nof.train_advance

            def adv(n, _o=orig_adv):
                trained.append(n)
                return _o(n)

            pipe.nof.train_advance = adv

    pipe._nof_round_start = counting
    _feed(pipe, data, 7)
    pipe.on_finish()
    assert starts[0] == 20, starts
    assert all(s == 5 for s in starts[1:]), starts
    assert len(starts) >= 3
    assert sum(trained) == sum(starts) == pipe.nof.total_step, (trained, starts)
    assert pipe.nof._step_ms == 0.0


def test_calibration_steps_deducted_from_round_budget(data):
    """The one calibration chunk (3 loop chunks, real steps) is repaid from
    later rounds' budgets, floored at one chunk a round."""
    pipe = entry.build_pipeline(
        *_cfgs(n_step=20, n_step_extend=10, loop_chunk=5, sync_max_delay=0),
        start_nerf_keyframes=3, device="cpu")
    starts = []
    orig = pipe._nof_round_start

    def counting():
        orig()
        starts.append(pipe._nof_steps_left)

    pipe._nof_round_start = counting
    _feed(pipe, data, 7)
    pipe.on_finish()
    assert starts[0] == 20, starts
    assert len(starts) >= 2
    assert 5 in starts[1:] and set(starts[1:]) <= {5, 10}, starts
    cal = 15
    repaid = sum(10 - b for b in starts[1:] if b == 5)
    assert pipe.nof.total_step == sum(starts) + cal, (pipe.nof.total_step, starts)
    assert repaid <= cal and pipe._cal_debt == cal - repaid
    assert pipe.nof.calibrate_step_ms() > 0


def test_strict_sync_joint_loop(data):
    """The shipped scheduling (sync_max_delay 0): every new keyframe from
    the start_nerf_keyframes-th on drains its round before the next frame;
    all of them are nerfed, and on_finish returns a mesh in real-world
    units near the object."""
    profiler.reset()
    pipe = entry.build_pipeline(*_cfgs(n_step_extend=10), start_nerf_keyframes=3,
                                device="cpu")
    rounds = []
    _count_rounds(pipe, rounds)
    _feed(pipe, data, 6)
    kfs = [f.id for f in pipe.bundler.keyframes]
    assert len(kfs) >= 4
    # a round at the 3rd keyframe and at every keyframe after it
    assert [c for c, _ in rounds] == kfs[2:]
    assert not pipe._nof_open and all(kf.nerfed for kf in pipe.bundler.keyframes)
    assert pipe.nof.n_frames == len(kfs)
    mesh = pipe.on_finish()
    assert len(mesh.vertices) > 50
    # real-world units: the 0.3 m cube seen from 0.55 m, in the model frame
    ext = mesh.vertices.max(0) - mesh.vertices.min(0)
    assert ext.max() < 0.5
    # strict sync dispatches each round inside nof/sync_wait (through
    # nof/train_advance), never from the pump's nof/advance
    stats = profiler.stats()
    for name in ("nof/scene_bounds", "nof/create_runner", "nof/build_rays",
                 "nof/fuse_cluster", "nof/add_new_frames", "nof/train_advance",
                 "nof/train_drain", "nof/sync_wait", "nof/pose_export",
                 "nof/extract_mesh_final", "launch/nof_chunk", "nof/calibrate"):
        assert stats[name]["count"] >= 1, name
    assert "nof/advance" not in stats
    assert stats["nof/scene_bounds"]["count"] == 1
    assert stats["nof/add_new_frames"]["count"] == len(kfs) - 3


def test_unported_arguments_raise_at_construction(tmp_path):
    track = default_track_config()
    track["feature_corres"]["rematch_after_nerf"] = True
    # rematch_after_nerf is ported: the joint loop builds with it
    assert entry.build_pipeline(track, device="cpu").cfg_track["feature_corres"][
        "rematch_after_nerf"] is True
    # save_artifacts is ported: it asks for the folder it writes the trail to
    with pytest.raises(ValueError, match="out_dir"):
        entry.BundleSdf(save_artifacts=True, device="cpu")
    # the dashboard is ported: it builds on the CPU and asks for its folder
    with pytest.raises(ValueError, match="out_dir"):
        entry.BundleSdf(use_gui=True, device="cpu")
    assert entry.BundleSdf(use_gui=True, device="cpu", out_dir=str(tmp_path)).gui is not None
    assert (tmp_path / "dashboard").is_dir()
    # the tracker alone never feeds poses back, so the knob is inert there
    assert entry.BundleSdf(track, use_nof=False, device="cpu").use_nof is False
    cfg = default_nof_config()
    pipe = entry.build_pipeline(cfg_nof=cfg, device="cpu")
    assert pipe.use_nof and pipe.start_nerf_keyframes == 5
    assert pipe.cfg_nof == cfg and pipe.cfg_nof is not cfg
    assert pipe.on_finish() is None  # no keyframes, no mesh
