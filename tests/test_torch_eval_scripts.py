"""The port's quality evaluations (``bundlesdf_tpu_torch/scripts/
synth_hard.py``, ``eval_matcher.py``, ``benchmark_synth.py``,
``benchmark_long.py``) against the JAX harness's (``tests/
synthetic_hard.py``, ``scripts/eval_matcher.py``, ``scripts/
benchmark_synth.py``, ``scripts/benchmark_long.py``): the fixture bit for
bit, the scoring and the evaluations on the same inputs, and the reports'
keys."""
import glob
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

import synthetic_hard as jhard
from bundlesdf_tpu_torch.scripts import benchmark_long as tlong
from bundlesdf_tpu_torch.scripts import benchmark_synth as tsynth
from bundlesdf_tpu_torch.scripts import eval_matcher as tmatch
from bundlesdf_tpu_torch.scripts import synth_hard as thard

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import benchmark_long as jlong  # noqa: E402  (the JAX scripts)
import benchmark_synth as jsynth  # noqa: E402
import eval_matcher as jmatch  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(480, 480), (37, 61), (50, 66), (12, 7)])
def test_blur_is_cv2s_bit_for_bit(shape):
    """The noise field's cv2.GaussianBlur(x, (0, 0), 5.0) in f64: the kernel
    and every output bit, at widths with and without a remainder of 4 and
    below the kernel's radius."""
    np.testing.assert_array_equal(thard.CV_KERNEL_SIGMA5,
                                  cv2.getGaussianKernel(41, 5.0, cv2.CV_64F).ravel())
    x = np.random.default_rng(sum(shape)).normal(0, 1.0, shape)
    np.testing.assert_array_equal(thard.cv_gaussian_blur_sigma5(x),
                                  cv2.GaussianBlur(x, (0, 0), sigmaX=5.0))


def test_fixture_arrays_bit_equal():
    """The rendering, the finger, the surface samples and distances."""
    K = np.array([[600.0, 0, 60], [0, 600.0, 48], [0, 0, 1]], np.float32)
    pose = np.eye(4)
    pose[:3, :3] = jhard.Rotation.from_euler("xyz", [15, 25, 8], degrees=True).as_matrix()
    pose[:3, 3] = [0.01, -0.02, 0.55]
    for a, b in zip(thard.render_blob_rgbd(pose, K, 96, 120),
                    jhard.render_blob_rgbd(pose, K, 96, 120)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(thard.render_finger(K, 96, 120, 3, 14), jhard.render_finger(K, 96, 120, 3, 14)):
        np.testing.assert_array_equal(a, b)
    pts = thard.blob_surface_points(n=500, seed=3)
    np.testing.assert_array_equal(pts, jhard.blob_surface_points(n=500, seed=3))
    np.testing.assert_array_equal(thard.blob_surface_distance(pts * 1.1),
                                  jhard.blob_surface_distance(pts * 1.1))


def test_fixture_files_decode_equal(tmp_path):
    """make_hard_video's PNGs (written by io/png.py) decode equal to the
    cv2-written ones; the poses, model points and intrinsics are the same
    bytes."""
    jhard.make_hard_video(str(tmp_path / "jax"), n_frames=3, H=72, W=90)
    thard.make_hard_video(str(tmp_path / "port"), n_frames=3, H=72, W=90)
    files = sorted(glob.glob(str(tmp_path / "jax" / "*" / "*.png")))
    assert len(files) == 12
    for f in files:
        g = f.replace(f"{os.sep}jax{os.sep}", f"{os.sep}port{os.sep}")
        a, b = cv2.imread(f, cv2.IMREAD_UNCHANGED), cv2.imread(g, cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for name in ("gt_ob_in_cam.npy", "gt_model_points.npy", "cam_K.txt"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """The hard fixture, 4 frames at 240 x 240."""
    d = str(tmp_path_factory.mktemp("hard") / "video")
    thard.make_hard_video(d, n_frames=4, H=240, W=240)
    return d


def test_gt_error_and_pairs_match_jax(video):
    """gt_error_px on random matches (some on invalid depth) and the pair
    schedule equal the JAX script's."""
    class F:
        def __init__(self, depth):
            self.depth = depth

    rng = np.random.default_rng(0)
    depth = rng.uniform(0.4, 0.7, (60, 80)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0
    gts = np.load(os.path.join(video, "gt_ob_in_cam.npy"))
    K = np.loadtxt(os.path.join(video, "cam_K.txt"))
    uvA, uvB = rng.uniform(0, 80, (200, 2)), rng.uniform(0, 80, (200, 2))
    a = tmatch.gt_error_px(F(depth), None, gts[0], gts[2], K, uvA, uvB)
    b = jmatch.gt_error_px(F(depth), None, gts[0], gts[2], K, uvA, uvB)
    np.testing.assert_array_equal(a, b)
    assert np.isinf(a).any() and np.isfinite(a).any()
    for n, gaps, cap in ((14, [1, 2, 4], 24), (35, [1, 2, 4], 35), (4, [1, 2], 24)):
        jax_pairs = []
        for g in gaps:   # JAX eval_matcher.py:162-167
            jax_pairs += [(i + g, i) for i in range(0, n - g, max(1, (n - g) * len(gaps) // cap))]
        assert tmatch.pair_ids_for(n, gaps, cap) == jax_pairs


def test_eval_matcher_main_matches_jax(video, tmp_path, monkeypatch):
    """eval_matcher's main on the same fixture with the corner engine: the
    same report, key for key and number for number, as the JAX script's
    (crop warp, matcher and scoring are held equal)."""
    out_t, out_j = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    rep = tmatch.main(["--video", video, "--matchers", "corner", "--gaps", "1,2",
                       "--device", "cpu", "--out", out_t])
    monkeypatch.setattr(sys, "argv", ["eval_matcher.py", "--video", video, "--matchers",
                                      "corner", "--gaps", "1,2", "--out", out_j])
    jmatch.main()
    with open(out_t) as f, open(out_j) as g:
        assert json.load(f) == json.load(g) == json.loads(json.dumps(rep))
    assert rep["n_pairs"] == 5 and rep["corner"]["matches_per_pair"] > 0


def _fake_run(video, out, jitter=0.004):
    """An out-folder as the online loop leaves it: noisy poses under
    ob_in_cam/ and a mesh of surface points in the first prediction's
    object frame."""
    gts = np.load(os.path.join(video, "gt_ob_in_cam.npy"))
    rng = np.random.default_rng(1)
    os.makedirs(os.path.join(out, "ob_in_cam"))
    preds = []
    for k, g in enumerate(gts):
        p = g.copy()
        p[:3, 3] += rng.normal(0, jitter, 3)
        preds.append(p)
        np.savetxt(os.path.join(out, "ob_in_cam", f"{k:05d}.txt"), p)
    T = np.linalg.inv(np.linalg.inv(gts[0]) @ preds[0])
    v = thard.blob_surface_points(n=400) + rng.normal(0, 0.002, (1, 3))
    v = np.concatenate([v, [[1.0, 1.0, 1.0]]]) @ T[:3, :3].T + T[:3, 3]
    with open(os.path.join(out, "mesh_online.obj"), "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in v)


def test_evaluations_match_jax(video, tmp_path):
    """benchmark_synth's and benchmark_long's ``evaluate`` on the same
    out-folder equal the JAX scripts'."""
    out = str(tmp_path / "out")
    _fake_run(video, out)
    a, b = tsynth.evaluate(video, out), jsynth.evaluate(video, out)
    assert a == b and "mesh_mean_dist_cm" in a and a["n_frames"] == 4
    assert tlong.evaluate(video, out) == jlong.evaluate(video, out)
