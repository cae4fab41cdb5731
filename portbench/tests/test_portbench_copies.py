"""The benchmark's frozen copies hold equal to their sources at a small
size: the video (poses, renderer, model points), the ADD arithmetic, the
cost functions and peaks, the hash grid's levels and the microbatching,
and the MLP FLOP count against torch's own counter."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from portbench import accuracy, costs, video
from portbench.reference import nof_step
from portbench.tests.tiny import REPO

sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)


def configs():
    return [json.load(open(os.path.join(REPO, "portbench", "configs", f"{n}.json")))["nof"]
            for n in ("online", "offline")]


def test_video_salt_zero_renders_the_source_frames():
    import synthetic_cube

    K = np.array([[80.0, 0, 32], [0, 80.0, 24], [0, 0, 1]], np.float32)
    for T in video.synth_poses(3, 6.0, 0.5):
        for got, want in zip(video.render_cube_rgbd(T, K, 48, 64),
                             synthetic_cube.render_cube_rgbd(T, K, 48, 64)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        salted = video.render_cube_rgbd(T, K, 48, 64, salt=video.dot_salt(7))
        ref = synthetic_cube.render_cube_rgbd(T, K, 48, 64)
        assert np.array_equal(salted[1], ref[1]) and np.array_equal(salted[2], ref[2])
    assert np.array_equal(video.cube_model_points(0.15), synthetic_cube.cube_model_points(0.15))


def test_poses_are_the_smoke_scripts():
    import chip_smoke

    for a, b in zip(video.synth_poses(60, 6.0, 0.5), chip_smoke.synth_poses(60, 6.0, 0.5)):
        assert np.array_equal(a, b)
    # the control's generator is the same arithmetic: in float64 it is the truth
    assert np.abs(video.synth_poses_in(torch.float64, 60, 6.0, 0.25)
                  - np.stack(video.synth_poses(60, 6.0, 0.25))).max() < 1e-7


def test_add_arithmetic_is_the_ports():
    from bundlesdf_tpu_torch.utils import metrics

    rng = np.random.default_rng(0)
    gts = np.stack(video.synth_poses(5, 6.0, 0.5))
    preds = gts.copy()
    preds[:, :3, 3] += rng.normal(scale=1e-3, size=(5, 3))
    pts = video.cube_model_points(0.15)
    assert np.array_equal(accuracy.align_to_first_frame(preds, gts),
                          metrics.align_to_first_frame(preds, gts))
    for p, g in zip(preds, gts):
        assert accuracy.add_err(p, g, pts) == metrics.add_err(p, g, pts)
    res = metrics.trajectory_add_auc(preds, gts, pts)
    assert np.allclose(accuracy.session_errors(preds, gts, pts)["add"], res["add_errs"],
                       rtol=1e-12, atol=0)


def test_costs_and_peaks_are_the_smoke_scripts():
    import chip_smoke

    assert costs.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S
    assert costs.PEAK_F32_FLOPS == chip_smoke.PEAK_F32_FLOPS
    for args in ((64, 2, 274632), (128, 2, 2146696), (160, 2, 4194304)):
        assert costs.reduce_cost(*args) == chip_smoke.reduce_cost(*args)
        b, o = costs.reduce_cost(*args)
        assert costs.bound_ms(b, o) == chip_smoke.bound(b, o)
    assert costs.scatter_cost(1000, 16, [4096, 35937]) == chip_smoke.scatter_cost(
        1000, 16, [4096, 35937])


@pytest.mark.parametrize("cfg", configs(), ids=["online", "offline"])
def test_levels_and_microbatches_are_the_programs(cfg):
    from bundlesdf_tpu_torch.nof.runner import _pick_microbatch
    from bundlesdf_tpu_torch.ops import hashgrid

    spec = hashgrid.HashGridSpec(cfg["num_levels"], cfg["feature_grid_dim"], cfg["base_res"],
                                 cfg["finest_res"], cfg["log2_hashmap_size"], layout="cell",
                                 big_dtype=cfg["hash_big_dtype"])
    want = spec.level_params()
    got = costs.grid_levels(cfg)
    assert [(g["res"], g["size"], g["offset"], g["dense"]) for g in got] == [
        (w["res"], w["size"], w["offset"], w["dense"]) for w in want]
    assert [g["staged"] for g in got] == [
        hashgrid._lvl_dtype(spec, w) == torch.bfloat16 for w in want]
    assert sum(p["size"] for p in got) == spec.total_entries
    mb = _pick_microbatch(cfg["N_rand"], cfg["N_samples"] + cfg["N_samples_around_depth"],
                          cfg["num_levels"])
    assert costs.microbatches(cfg) == (cfg["N_rand"] // mb if mb else 1)
    # the reduce's bound at the online budget is the smoke script's 0.0283 ms
    if cfg["num_levels"] == 4:
        assert costs.reduce_bound_ms_per_step(cfg) == pytest.approx(0.0283, abs=1e-4)


@pytest.mark.parametrize("cfg", configs(), ids=["online", "offline"])
def test_mlp_flops_are_torchs_count(cfg):
    from torch.utils.flop_counter import FlopCounterMode

    p = nof_step.make_params(cfg, 4, 0, "cpu")
    n = 256
    emb = torch.randn(n, cfg["num_levels"] * cfg["feature_grid_dim"])
    dirs = torch.randn(n, cfg["multires_views"] ** 2 + cfg["frame_features"])
    sp, cp = p["sigma"], p["color"]
    with FlopCounterMode(display=False) as fc:
        h = torch.relu(emb @ sp["w0"] + sp["b0"]) @ sp["w1"] + sp["b1"]
        x = torch.relu(torch.cat([dirs, h[:, 1:]], -1) @ cp["w0"] + cp["b0"])
        x = torch.relu(x @ cp["w1"] + cp["b1"])
        x @ cp["w2"] + cp["b2"]
    assert fc.get_total_flops() == costs.mlp_flops_per_sample(cfg) * n
