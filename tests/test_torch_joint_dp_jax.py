"""The port's online joint loop over 2 gloo ranks (rank 0 the tracker of
record, ``parallel/joint.py``) against the JAX loop under ``dp_devices: 2``
on the conftest's 8-device CPU mesh, on the 96 x 96 cube.

Both sides get the same randomness: the JAX key's RANSAC uniforms (handed
to rank 0 as a table by frame and shape: the ranks run without JAX), the
JAX runner's initial weights, and the rays each JAX dp step drew (the JAX
dp step draws as the single step does, bundlesdf_tpu/parallel/
nof_shard.py:65-72), found in each rank's pool by frame and pixel, with the
step's jitter, as tests/test_torch_pipeline.py::JaxBatches replays them.  The bounds are
that file's ``_joint_pair``'s."""
import json
import os
import sys

import jax
import numpy as np

from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu.pipeline.bundlesdf import BundleSdf as JBundleSdf
from bundlesdf_tpu_torch.config import default_nof_config, default_track_config
from bundlesdf_tpu_torch.nof import render as trender
from bundlesdf_tpu_torch.nof import runner as trunner
from bundlesdf_tpu_torch.utils import metrics

sys.path.insert(0, os.path.dirname(__file__))
from port_dp_worker import start_ranks, stream_put  # noqa: E402
from synthetic_cube import cube_model_points, make_cube_sequence  # noqa: E402
from test_pipeline import small_nof_cfg, small_track_cfg  # noqa: E402
from test_torch_joint_dp import assert_same_loop, cube_surface_dist  # noqa: E402
from test_torch_pipeline import _ray_keys, _run  # noqa: E402
from test_torch_train import _step_draws  # noqa: E402

N_FRAMES = 6
PAIR_COUNTS = (1, 2, 4, 8, 12, 16, 32)   # the padded pair buckets of the small config


def _plain(cfg):
    return json.loads(json.dumps(cfg))


def _statics(nof):
    """The port's statics that ``_step_draws`` reads."""
    n_rand, n_s, n_a = int(nof["N_rand"]), int(nof["N_samples"]), int(nof["N_samples_around_depth"])
    return trunner.TrainStatics(
        spec=None, weights=None, n_step=0, trunc=0, trunc_start=0, trunc_decay_type="",
        sc_factor=1.0, n_rand=n_rand,
        rcfg=trender.RenderCfg(n_samples=n_s, n_samples_around_depth=n_a),
        microbatch=trunner._pick_microbatch(n_rand, n_s + n_a, int(nof["num_levels"]), 0))


def test_two_ranks_match_jax_dp(tmp_path, monkeypatch):
    """The ranks run while the JAX loop does: the JAX runner's initial
    weights and each JAX step's drawn rays reach them as a stream of files
    (``port_dp_worker.Stream``)."""
    data = make_cube_sequence(n_frames=N_FRAMES, deg_per_frame=3.0)
    track, nof = _plain(small_track_cfg()), _plain(small_nof_cfg())
    port_nof = _plain(default_nof_config().merged(nof))
    n_trials = int(track["ransac"]["max_iter"])
    ransac = {(fid, (p, n_trials, 3)): np.array(jax.random.uniform(
        jax.random.PRNGKey(fid), (p, n_trials, 3))) for fid in range(N_FRAMES)
        for p in PAIR_COUNTS}
    folder = str(tmp_path / "stream")
    os.makedirs(folder)
    inp = {"track": _plain(default_track_config().merged(track)), "nof": port_nof,
           "start": 3, "n_frames": N_FRAMES, "deg": 3.0, "stream": folder, "ransac": ransac}
    collect = start_ranks("joint", 2, inp, tmp_path / "ranks", timeout=150)

    st, n_steps = _statics(port_nof), [0]
    init, advance = jrunner.NofRunner.__init__, jrunner.NofRunner.train_advance

    def created(runner, *a, **k):
        init(runner, *a, **k)
        stream_put(folder, 0, jax.tree_util.tree_map(np.asarray, runner.params))

    def record(runner, n):
        for i in range(n):
            jstep = runner.global_step + i
            idx, draws = _step_draws(jax.random.PRNGKey(42), jstep, st, len(runner.rays_np))
            idx = idx.numpy()
            n_steps[0] += 1
            stream_put(folder, n_steps[0], (
                jstep, _ray_keys(runner.rays_np[idx]), idx,
                tuple(None if u is None else u.numpy() for u in draws)))
        return advance(runner, n)

    monkeypatch.setattr(jrunner.NofRunner, "__init__", created)
    monkeypatch.setattr(jrunner.NofRunner, "train_advance", record)
    jpipe = JBundleSdf(cfg_track=small_track_cfg(),
                       cfg_nof=small_nof_cfg().merged({"dp_devices": 2}),
                       start_nerf_keyframes=3, use_nof=True, out_dir=str(tmp_path / "jax"))
    ref = _run(jpipe, data)
    assert jpipe.nof._mesh is not None and jpipe.nof._mesh.size == 2
    r0, r1 = collect()

    assert_same_loop(r0, ref)
    assert r0["steps"] == n_steps[0] == r0["replayed"][0] == r1["replayed"][0]
    for k, n in (r0["replayed"], r1["replayed"]):
        assert n <= 0.001 * k * int(port_nof["N_rand"]), n
    assert r1["frames_built"] == 0 and r1["runner_steps"] == r0["steps"]
    res = metrics.trajectory_add_auc(r0["poses"], data["gt_ob_in_cam"],
                                     cube_model_points(data["half"]))
    assert res["mean_add"] < 0.01, res
    assert cube_surface_dist(r0["mesh_vertices"], r0["first_pose"], data) < 0.03
