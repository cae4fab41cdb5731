"""The online joint loop under data parallelism (``parallel/joint.py``):
``BundleSdf`` with ``dp_devices: 2`` over 2 gloo ranks on the CPU
(``tests/port_dp_worker.py``), rank 0 the tracker of record, against the
port's 1-rank loop on the 96 x 96 cube with the same draws (each rank's
generators seeded as the 1-rank run's).  The bounds are those of the joint
loop's JAX comparison (tests/test_torch_pipeline.py::_joint_pair): equal
keyframes, round starts, nerfed set and steps; poses within 1 mm and
0.2 deg."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from bundlesdf_tpu_torch import entry
from bundlesdf_tpu_torch.config import Cfg, default_nof_config, default_track_config
from bundlesdf_tpu_torch.utils import metrics

sys.path.insert(0, os.path.dirname(__file__))
from port_dp_worker import run_frames, start_ranks  # noqa: E402
from synthetic_cube import cube_model_points, make_cube_sequence  # noqa: E402

torch.set_num_threads(2)

N_FRAMES = 6


def small_track():
    """tests/test_pipeline.py::small_track_cfg on the port's config."""
    cfg = default_track_config()
    cfg["feature_corres"]["resize"] = 160
    cfg["feature_corres"]["max_matches_per_pair"] = 256
    cfg["ransac"]["max_iter"] = 512
    cfg["bundle"]["max_BA_frames"] = 5
    cfg["bundle"]["image_downscale"] = 4
    cfg["depth_processing"]["percentile"] = 100
    return cfg


def small_nof():
    """tests/test_pipeline.py::small_nof_cfg on the port's config."""
    return default_nof_config().merged(dict(
        n_step=30, N_rand=256, N_samples=24, N_samples_around_depth=12, num_levels=4,
        finest_res=64, log2_hashmap_size=16, octree_smallest_voxel_size=0.05,
        octree_dilate_size=0.05, max_kf_pool=32, mesh_resolution=0.04))


def plain(cfg) -> dict:
    return json.loads(json.dumps(cfg))


def pose_diff(a, b):
    """Translation (m) and rotation (deg) between two poses."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / 2 ** 1.5
    return np.linalg.norm(a[:3, 3] - b[:3, 3]), np.degrees(2 * np.arcsin(min(1.0, chord)))


def cube_surface_dist(vertices, first_pose, data):
    """Median distance of mesh vertices to the cube (tests/test_pipeline.py
    :114-130)."""
    inv_T = np.linalg.inv(first_pose @ data["gt_ob_in_cam"][0])
    v = vertices @ inv_T[:3, :3].T + inv_T[:3, 3]
    q = np.abs(v) - data["half"]
    return np.median(np.abs(np.linalg.norm(np.maximum(q, 0), axis=-1)
                            + np.minimum(q.max(axis=-1), 0)))


def assert_same_loop(out, ref):
    """The equalities and bounds of a dp run against a reference run."""
    assert out["kfs"] == ref["kfs"] and out["status"] == ref["status"]
    assert out["starts"] == ref["starts"] and len(ref["starts"]) >= 1
    assert out["nerfed"] == ref["nerfed"] and len(ref["nerfed"]) >= 3
    assert out["steps"] == ref["steps"] > 0
    for a, b in zip(out["poses"], ref["poses"]):
        dt, dr = pose_diff(a, b)
        assert dt < 1e-3 and dr < 0.2, (dt, dr)


@pytest.fixture(scope="module")
def joint_runs(tmp_path_factory):
    """The 2-rank loop (in its ranks) and the 1-rank loop (here), at once."""
    inp = {"track": plain(small_track()), "nof": plain(small_nof()), "start": 3,
           "n_frames": N_FRAMES, "deg": 3.0}
    collect = start_ranks("joint", 2, inp, tmp_path_factory.mktemp("joint"), timeout=150)
    pipe = entry.build_pipeline(Cfg.wrap(inp["track"]), Cfg.wrap(inp["nof"]),
                                start_nerf_keyframes=3, device="cpu")
    data = make_cube_sequence(n_frames=N_FRAMES, deg_per_frame=3.0)
    one = run_frames(pipe, data, N_FRAMES)
    return data, one, collect()


def test_two_ranks_match_one_rank(joint_runs):
    """Keyframes, round starts, the nerfed set and the steps equal the
    1-rank loop's, poses within 1 mm and 0.2 deg; both ranks train every
    step and hold the same table; the mesh covers the cube."""
    data, one, (r0, r1) = joint_runs
    assert_same_loop(r0, one)
    assert r0["runner_steps"] == r1["runner_steps"] == one["steps"]
    assert r0["n_frames_nof"] == r1["n_frames_nof"] == len(one["kfs"])
    for k in ("table", "pose_array", "c2w"):    # the followed state is rank 0's
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    res = metrics.trajectory_add_auc(r0["poses"], data["gt_ob_in_cam"],
                                     cube_model_points(data["half"]))
    assert res["mean_add"] < 0.01, res
    assert len(r0["mesh_vertices"]) > 50
    assert cube_surface_dist(r0["mesh_vertices"], r0["first_pose"], data) < 0.03


def test_rank1_never_tracks(joint_runs):
    """Rank 0 alone builds Frames and tracks; rank 1 has no tracker, no
    track span and trains in the NOF spans only."""
    _, _, (r0, r1) = joint_runs
    assert r0["lead"] and r0["bundler"] and r0["frames_built"] == N_FRAMES
    assert not r1["lead"] and not r1["bundler"] and r1["frames_built"] == 0
    assert any(s.startswith("track/") for s in r0["spans"])
    assert not any(s.startswith(("track/", "corres/", "artifacts/")) for s in r1["spans"])
    assert "nof/train_advance" in r1["spans"]


@pytest.mark.parametrize("rank", [0, 1])
def test_a_raising_rank_fails_every_rank(rank, tmp_path):
    """A rank that raises in ``train_advance`` ends both ranks with an error
    within the time limit: rank 0 before it sends the command (rank 1
    waits for one), rank 1 after it (rank 0 is in the step's
    collectives)."""
    inp = {"track": plain(small_track()), "nof": plain(small_nof()), "start": 1,
           "n_frames": 2, "deg": 3.0, "fail": (rank, "train_advance")}
    with pytest.raises(AssertionError, match="a rank failed") as err:
        start_ranks("joint", 2, inp, tmp_path, timeout=90)()
    msg = str(err.value)
    assert "rank 0 rc 0" not in msg and "rank 1 rc 0" not in msg
    assert f"injected fault on rank {rank}" in msg
