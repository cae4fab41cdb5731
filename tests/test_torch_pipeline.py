"""The port's joint tracking + NOF loop (``BundleSdf(use_nof=True)``)
against the JAX package's on the 96 x 96 cube sequence.

Both sides get the same randomness: the JAX key's RANSAC uniforms, the JAX
init's NOF weights, and the NOF batches the JAX steps drew.  A batch index
points into the ray pool, and the two pools differ by a few rows: the
tracker's poses differ by ~0.3 mm (XLA's whole-program fusion, see
tests/test_torch_tracker.py), which moves points of the fused cloud across
occupancy voxels and rays across the denoise radius.  So the port's draw
source takes the rays the JAX step drew, found in the port's pool by frame
and pixel (``JaxBatches``), with the JAX step's jitter."""
import jax
import numpy as np
import pytest
import torch

from synthetic_cube import cube_model_points, make_cube_sequence
from test_pipeline import small_nof_cfg, small_track_cfg
from test_torch_train import _step_draws
from bundlesdf_tpu.models import nof as jnof
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu.ops import hashgrid as jhash
from bundlesdf_tpu.pipeline.bundlesdf import BundleSdf as JBundleSdf
from bundlesdf_tpu_torch import entry
from bundlesdf_tpu_torch.config import Cfg, default_nof_config, default_track_config
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.nof import runner as trunner
from bundlesdf_tpu_torch.tracking import corres as tcorres
from bundlesdf_tpu_torch.utils import metrics

torch.set_num_threads(2)

N_FRAMES = 6


def jax_draws(seed, shape):
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape)))


def jax_init(spec, seed=0, device=None):
    """The JAX runner's initial weights (PRNGKey(0)) for the port's spec."""
    jspec = jnof.NofSpec(**{**spec._asdict(),
                            "grid": jhash.HashGridSpec(**spec.grid._asdict())})
    p = jnof.init_nof_params(jax.random.PRNGKey(seed), jspec)
    return tnof.params_from_jax(jax.tree_util.tree_map(np.asarray, p), device=device)


def _ray_keys(rows):
    """A ray's identity: its frame and its pixel's direction (bitwise)."""
    return [tuple(r) for r in np.ascontiguousarray(rows[:, [0, 1, 8]]).view(np.int32)]


class JaxBatches:
    """Records every JAX step's ray pool; replays each step's drawn rays and
    jitter as the port's draws (a ray missing from the port's pool takes
    the row at the same index)."""

    def __init__(self, monkeypatch):
        self.log, self.k, self.pipe, self.misses, self._map = [], 0, None, 0, None
        orig = jrunner.NofRunner.train_advance

        def record(runner, n):
            self.log.extend((runner.global_step + i, runner.rays_np) for i in range(n))
            return orig(runner, n)

        monkeypatch.setattr(jrunner.NofRunner, "train_advance", record)

    def __call__(self, step, n_rays):
        jstep, jpool = self.log[self.k]
        self.k += 1
        assert jstep == step, (jstep, step)
        nof = self.pipe.nof
        idx, draws = _step_draws(jax.random.PRNGKey(42), step, nof.statics, len(jpool))
        if self._map is None or self._map[0] is not nof.rays_np:
            self._map = (nof.rays_np, {k: i for i, k in enumerate(_ray_keys(nof.rays_np))})
        rows = self._map[1]
        idx = idx.numpy()
        keys = _ray_keys(jpool[idx])
        self.misses += sum(k not in rows for k in keys)
        out = [rows.get(k, min(int(i), n_rays - 1)) for k, i in zip(keys, idx)]
        return torch.tensor(out), draws


def _run(pipe, data):
    starts = []
    orig = pipe._nof_round_start

    def counting():
        orig()
        starts.append((pipe.cnt, pipe._nof_steps_left))

    pipe._nof_round_start = counting
    status = [pipe.run(data["colors"][k], data["depths"][k], data["K"], f"{k:04d}",
                       mask=data["masks"][k]).status for k in range(N_FRAMES)]
    nerfed_at = [f.id for f in pipe.bundler.keyframes if f.nerfed]
    mesh = pipe.on_finish()
    poses = np.stack([pipe.poses_log[f"{k:04d}"] for k in range(N_FRAMES)])
    return {"poses": poses, "status": status, "starts": starts, "mesh": mesh,
            "kfs": [f.id for f in pipe.bundler.keyframes], "nerfed": nerfed_at,
            "steps": pipe.nof.total_step}


def _pose_diff(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / 2 ** 1.5
    return np.linalg.norm(a[:3, 3] - b[:3, 3]), np.degrees(2 * np.arcsin(min(1.0, chord)))


def _surface_dist(mesh, pipe, data):
    """Median distance of the mesh's vertices to the true cube surface
    (tests/test_pipeline.py:114-130)."""
    T = pipe.bundler.firstframe.pose_in_model @ data["gt_ob_in_cam"][0]
    inv_T = np.linalg.inv(T)
    v = mesh.vertices @ inv_T[:3, :3].T + inv_T[:3, 3]
    q = np.abs(v) - data["half"]
    return np.median(np.abs(np.linalg.norm(np.maximum(q, 0), axis=-1)
                            + np.minimum(q.max(axis=-1), 0)))


def _invalidations(pipe):
    """Record the keyframe ids whose matches the NOF feedback invalidates."""
    log = []
    store = pipe.bundler.store
    orig = store.invalidate_matches

    def spy(fid):
        log.append((pipe.cnt, fid))
        return orig(fid)

    store.invalidate_matches = spy
    return log


def _joint_pair(monkeypatch, tmp_path, rematch: bool):
    """The joint loop in both packages on the cube sequence with shared
    draws and weights; ``rematch`` sets feature_corres.rematch_after_nerf."""
    data = make_cube_sequence(n_frames=N_FRAMES, deg_per_frame=3.0)
    track = small_track_cfg()
    track["feature_corres"]["rematch_after_nerf"] = rematch
    batches = JaxBatches(monkeypatch)
    jpipe = JBundleSdf(cfg_track=track, cfg_nof=small_nof_cfg(),
                       start_nerf_keyframes=3, use_nof=True, out_dir=str(tmp_path))
    jinv = _invalidations(jpipe)
    ref = _run(jpipe, data)

    monkeypatch.setattr(trunner.nof_model, "init_nof_params", jax_init)
    pipe = entry.build_pipeline(
        Cfg.wrap(default_track_config().merged(track)),
        Cfg.wrap(default_nof_config().merged(small_nof_cfg())),
        start_nerf_keyframes=3, device="cpu", ransac_draws=jax_draws,
        nof_draws=batches)
    batches.pipe = pipe
    tinv = _invalidations(pipe)
    out = _run(pipe, data)

    assert out["kfs"] == ref["kfs"] and out["status"] == ref["status"]
    assert out["starts"] == ref["starts"] and len(ref["starts"]) >= 1
    assert out["nerfed"] == ref["nerfed"] and len(ref["nerfed"]) >= 3
    assert out["steps"] == ref["steps"] == batches.k == len(batches.log)
    assert batches.misses <= 0.001 * batches.k * 256, batches.misses
    for a, b in zip(out["poses"], ref["poses"]):
        dt, dr = _pose_diff(a, b)
        assert dt < 1e-3 and dr < 0.2, (dt, dr)
    res = metrics.trajectory_add_auc(out["poses"], data["gt_ob_in_cam"],
                                     cube_model_points(data["half"]))
    assert res["mean_add"] < 0.01, res
    return data, (ref, jpipe, jinv), (out, pipe, tinv)


def test_joint_loop_matches_jax(monkeypatch, tmp_path):
    data, (ref, jpipe, _), (out, pipe, _) = _joint_pair(monkeypatch, tmp_path, False)
    # both meshes cover the observed cube shell
    for m, p in ((out["mesh"], pipe), (ref["mesh"], jpipe)):
        assert len(m.vertices) > 50
        assert _surface_dist(m, p, data) < 0.03
    assert abs(pipe.sc_factor - jpipe.sc_factor) < 1e-3 * jpipe.sc_factor


def _jolt_keyframe_1(monkeypatch, runner_cls):
    """Move keyframe 1 by 6 mm in the first round's exported poses (as
    chip_smoke.py's joint_rematch does): on the cube the NOF's own
    corrections stay under the 5 mm / 5 deg rematch gate, so without a jolt
    nothing would be invalidated.  Applied to both packages' runners."""
    orig = runner_cls.get_optimized_poses_in_real_world
    calls = []

    def jolted(self):
        poses, offset = orig(self)
        calls.append(1)
        if len(calls) == 1 and len(poses) > 1:
            poses = poses.copy()
            poses[1, :3, 3] += np.float32(0.006)
        return poses, offset

    monkeypatch.setattr(runner_cls, "get_optimized_poses_in_real_world", jolted)


def test_joint_loop_rematch_after_nerf_matches_jax(monkeypatch, tmp_path):
    """feature_corres.rematch_after_nerf with keyframe 1 jolted by 6 mm in
    the first round's poses: the same keyframes invalidated after the same
    frames as in the JAX loop, their pairs re-gated from the raw tables
    (RANSAC launches without a matcher launch), and the poses within 1 mm
    and 0.2 deg of the JAX run."""
    from bundlesdf_tpu_torch.utils import profiler as tprof

    _jolt_keyframe_1(monkeypatch, jrunner.NofRunner)
    _jolt_keyframe_1(monkeypatch, trunner.NofRunner)
    regated = []
    orig = tcorres._find_corres_legacy

    def legacy(store, pairs, *args, **kw):
        regated.append((len(pairs), sum((fa.id, fb.id) in store.raw for fa, fb in pairs)))
        return orig(store, pairs, *args, **kw)

    monkeypatch.setattr(tcorres, "_find_corres_legacy", legacy)
    tprof.reset()
    _, (_, _, jinv), (_, _, tinv) = _joint_pair(monkeypatch, tmp_path, True)
    assert tinv == jinv and len(jinv) >= 1, (tinv, jinv)
    # the fused path sends only raw-table pairs here: no matcher runs
    assert regated and all(n == n_raw > 0 for n, n_raw in regated), regated
    assert tprof.stats()["launch/ransac"]["count"] == len(regated)
