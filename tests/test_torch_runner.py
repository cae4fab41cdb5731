"""The port's NofRunner against the JAX NofRunner on the same frames: the
occupancy grid, the ray pool (construction, extension, the in-place append,
the pool cap, a saturated keyframe pool), a round of training from the same
weights and draws, pose export, and the mesh of equal parameters."""
import jax
import numpy as np
import pytest
import torch

from synthetic_cube import make_cube_sequence
from test_pipeline import small_nof_cfg
from test_torch_train import _step_draws
from bundlesdf_tpu.io import scene_bounds as jsb
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu_torch.config import Cfg
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.nof import render as trender
from bundlesdf_tpu_torch.nof import runner as trunner
from bundlesdf_tpu_torch.utils.geometry import GLCAM_IN_CVCAM

torch.set_num_threads(2)

N_FRAMES = 5


@pytest.fixture(scope="module")
def frames():
    """Normalized NOF inputs of 5 cube frames, 6 deg apart, at their true
    poses (BundleSdf._preprocess), with the scene bounds of frames 0..2."""
    data = make_cube_sequence(n_frames=N_FRAMES, deg_per_frame=6.0)
    rgbs = np.stack(data["colors"]).astype(np.float32) / 255.0
    depths = np.stack(data["depths"]).astype(np.float32)
    masks = np.stack(data["masks"]).astype(np.float32)
    glc = np.stack([np.linalg.inv(T) for T in data["gt_ob_in_cam"]]) @ GLCAM_IN_CVCAM
    sc, tr, pcd, _ = jsb.compute_scene_bounds(rgbs[:3], depths[:3], masks[:3],
                                              data["K"], glc[:3])
    sc *= 0.7
    rgbs[masks == 0] = trunner.BAD_COLOR / 255.0
    depths[depths < 0.1] = trunner.BAD_DEPTH
    depths[masks == 0] = trunner.BAD_DEPTH
    depths *= sc
    poses = glc.copy()
    poses[:, :3, 3] = (poses[:, :3, 3] + tr) * sc
    cfg = small_nof_cfg()
    cfg["sc_factor"] = float(sc)
    cfg["translation"] = tr.tolist()
    return {"rgb": rgbs, "depth": depths, "mask": masks, "pose": poses.astype(np.float32),
            "K": data["K"], "pcd": (pcd + tr) * sc, "cfg": cfg}


def _inputs(f, sl):
    return f["rgb"][sl], f["depth"][sl], f["mask"][sl], f["pose"][sl]


def _pair(f, over=None, n0=3, jax_params=True):
    """A JAX runner and a port runner (CPU) on frames 0..n0-1; the port one
    starts from the JAX weights and draws the JAX key's batches."""
    cfg = f["cfg"].merged(over or {})
    J = jrunner.NofRunner(cfg, *_inputs(f, slice(0, n0)), f["K"], f["pcd"])
    params = (tnof.params_from_jax(jax.tree_util.tree_map(np.asarray, J.params),
                                   device="cpu") if jax_params else None)
    T = trunner.NofRunner(Cfg.wrap(dict(cfg)), *_inputs(f, slice(0, n0)), f["K"],
                          f["pcd"], device="cpu", params=params)
    T.train_draws = lambda step, n: _step_draws(jax.random.PRNGKey(42), step,
                                                T.statics, n)
    return J, T


def _extend(R, f, sl):
    R.add_new_frames(f["rgb"][sl], f["depth"][sl], f["mask"][sl],
                     f["pose"][: sl.stop], f["pcd"])


@pytest.fixture(scope="module")
def pair(frames):
    return _pair(frames)


def test_runner_statics_equal_jax(pair):
    J, T = pair
    assert T.occ_resolution == J.occ_resolution and T.occ_dilate == J.occ_dilate
    assert tuple(T.rcfg) == tuple(J.rcfg)
    assert tuple(T.weights) == tuple(J.weights)
    assert T.statics.microbatch == jrunner._pick_microbatch(256, 24 + 12, 4) == 0
    assert (T.spec.num_frames, T.spec.max_trans) == (J.spec.num_frames, J.spec.max_trans)
    assert T.spec.grid.reduce == "conv" and T.spec.grid.big_dtype == J.spec.grid.big_dtype
    assert (trunner.BAD_DEPTH, trunner.BAD_COLOR) == (jrunner.BAD_DEPTH, jrunner.BAD_COLOR)


def test_occupancy_and_ray_pool_equal_jax(frames):
    # a pool reserved at 2^17 rows takes the new frame's rays in place
    J, T = _pair(frames, {"ray_pool_reserve_log2": 17}, jax_params=False)
    np.testing.assert_array_equal(T.occ_grid.numpy(), np.asarray(J.occ_grid))
    assert T.occ_grid.sum() > 100
    assert len(T.rays_np) > 10000
    np.testing.assert_array_equal(T.rays_np, J.rays_np)
    assert T.n_rays == int(J.n_rays) and isinstance(T.n_rays, int)
    np.testing.assert_array_equal(T.rays_dev[: T.n_rays].numpy(), T.rays_np)
    assert T.rays_dev.shape == J.rays_dev.shape
    # extension: one new frame, poses of all four, denoise on
    assert bool(T.cfg["denoise_depth_use_octree_cloud"])
    n0, ptr = T.n_rays, T.rays_dev.data_ptr()
    for R in (J, T):
        _extend(R, frames, slice(3, 4))
    np.testing.assert_array_equal(T.occ_grid.numpy(), np.asarray(J.occ_grid))
    np.testing.assert_array_equal(T.rays_np, J.rays_np)
    np.testing.assert_array_equal(T.c2w_np, J.c2w_np)
    assert T.n_frames == J.n_frames == 4 and T.n_rays > n0
    # the in-place append wrote the new rows into the same pool, which
    # equals a full upload of the grown pool
    assert T.rays_dev.data_ptr() == ptr
    full = torch.zeros_like(T.rays_dev)
    full[: T.n_rays] = torch.from_numpy(T.rays_np)
    torch.testing.assert_close(T.rays_dev, full, rtol=0, atol=0)
    np.testing.assert_array_equal(T.c2w_dev.numpy(), T.c2w_np)


def test_pool_cap_keeps_the_same_rows(frames):
    """ray_pool_max_log2 below the pool: the same uniform subsample."""
    J, T = _pair(frames, {"ray_pool_max_log2": 14}, jax_params=False)
    assert len(T.rays_np) == 1 << 14
    np.testing.assert_array_equal(T.rays_np, J.rays_np)
    for R in (J, T):
        _extend(R, frames, slice(3, 4))
    assert len(T.rays_np) == 1 << 14
    np.testing.assert_array_equal(T.rays_np, J.rays_np)
    np.testing.assert_array_equal(T.rays_dev.numpy(), np.asarray(J.rays_dev))


# the rounds of the capped-pool tests: new frames (again from the cube's
# five) and the poses of every frame so far
CAPPED_ROUNDS = ((3, 4), (4, 5), (0, 1), (1, 3))


def _round_inputs(f, k):
    """Round ``k`` of CAPPED_ROUNDS after a runner on frames 0..2: the new
    frames' images, depths, masks, and the poses of every frame so far."""
    order = [0, 1, 2] + [i for a, b in CAPPED_ROUNDS[: k + 1] for i in range(a, b)]
    lo, hi = CAPPED_ROUNDS[k]
    return (f["rgb"][lo:hi], f["depth"][lo:hi], f["mask"][lo:hi],
            f["pose"][order]), order


def _old_rule(pool, rows, cap):
    """The pool rule as host numpy: concatenate, and past ``cap`` rows keep
    the sorted ``default_rng(len).choice`` (the JAX runner's)."""
    pool = np.concatenate([pool, rows])
    if len(pool) > cap:
        keep = np.random.default_rng(len(pool)).choice(len(pool), cap, replace=False)
        return pool[np.sort(keep)], True
    return pool, False


def test_capped_pool_grows_on_the_device(frames, monkeypatch):
    """ray_pool_max_log2 14, built past the cap and extended over four
    rounds past it: after each, the pool on the device and ``rays_np``
    equal the old host rule bit for bit, in the same storage (no new pool:
    a captured step stays valid), and the counters hold the rounds that
    subsampled and the bytes that left the host (the new rows and the
    draws of int32 indices)."""
    from bundlesdf_tpu_torch.utils import profiler

    cap = 1 << 14
    built = []
    build = trunner.NofRunner._build_all_rays

    def spy(self, ids):
        built.append(build(self, ids))
        return built[-1]

    monkeypatch.setattr(trunner.NofRunner, "_build_all_rays", spy)
    profiler.reset()
    cfg = frames["cfg"].merged({"ray_pool_max_log2": 14})
    T = trunner.NofRunner(Cfg.wrap(dict(cfg)), *_inputs(frames, slice(0, 3)), frames["K"],
                          frames["pcd"], device="cpu")
    model, capped = _old_rule(np.zeros((0, trender.RAY_DIM), np.float32), built[0], cap)
    assert capped and T.n_rays == cap
    n_capped = 1
    ptr, allocs = T.rays_dev.data_ptr(), T.ray_pool_allocations
    for k in range(len(CAPPED_ROUNDS)):
        (rgb, depth, mask, poses), _ = _round_inputs(frames, k)
        T.add_new_frames(rgb, depth, mask, poses, frames["pcd"])
        assert len(built) == k + 2 and len(built[-1]) > 1000
        model, capped = _old_rule(model, built[-1], cap)
        assert capped
        n_capped += 1
        np.testing.assert_array_equal(T.rays_np, model)
        np.testing.assert_array_equal(T.rays_dev[: T.n_rays].numpy(), model)
        assert T.rays_dev.shape[0] == cap
        assert T.rays_dev.data_ptr() == ptr and T.ray_pool_allocations == allocs
    st = profiler.stats()
    assert st["nof/pool_subsample"]["count"] == n_capped == 5
    rows_bytes = sum(len(b) * trender.RAY_DIM * 4 for b in built)
    assert st["nof/pool_upload_bytes"]["count"] == rows_bytes + n_capped * cap * 4
    assert st["nof/upload_rays/draw"]["count"] == n_capped
    assert st["nof/upload_rays/device"]["count"] == n_capped


def test_frames_fill_in_place(frames):
    """The frame buffers are filled in place round by round: their
    ``[:n_frames]`` views equal the inputs concatenated."""
    T = trunner.NofRunner(Cfg.wrap(dict(frames["cfg"])), *_inputs(frames, slice(0, 3)),
                          frames["K"], frames["pcd"], device="cpu")
    buffers = (T._images, T._depths, T._masks)
    for k in range(3):
        (rgb, depth, mask, poses), order = _round_inputs(frames, k)
        T.add_new_frames(rgb, depth, mask, poses, frames["pcd"])
        assert T.n_frames == len(order)
        for got, key in ((T.images, "rgb"), (T.depths, "depth"), (T.masks, "mask")):
            np.testing.assert_array_equal(got, frames[key][order])
        assert all(np.shares_memory(v, b) for v, b in zip((T.images, T.depths, T.masks),
                                                          buffers))
    assert T.occ_masks is None and len(T._images) == T.max_frames


def test_rays_np_is_a_copy_until_the_pool_changes(frames):
    """``rays_np`` is the same read-only host copy between pool changes and
    a new one after each; a copy kept from before a round still holds the
    old rows.  Assigning a whole pool writes it in place and zeroes the
    rows it no longer has."""
    cfg = frames["cfg"].merged({"ray_pool_max_log2": 14})
    T = trunner.NofRunner(Cfg.wrap(dict(cfg)), *_inputs(frames, slice(0, 3)), frames["K"],
                          frames["pcd"], device="cpu")
    a = T.rays_np
    assert T.rays_np is a and not a.flags.writeable
    saved = a.copy()
    T.set_poses(frames["pose"][:3])
    assert T.rays_np is a
    (rgb, depth, mask, poses), _ = _round_inputs(frames, 0)
    T.add_new_frames(rgb, depth, mask, poses, frames["pcd"])
    b = T.rays_np
    assert b is not a and T.rays_np is b
    np.testing.assert_array_equal(a, saved)
    assert not np.array_equal(a, b)
    ptr = T.rays_dev.data_ptr()
    T.rays_np = b[:100]
    assert T.n_rays == 100 and T.rays_dev.data_ptr() == ptr
    np.testing.assert_array_equal(T.rays_np, b[:100])
    assert not T.rays_dev[100:].any()


def test_keyframe_pool_saturation(frames, caplog):
    """max_kf_pool 4: of two new frames one fits; a third round adds none
    but still takes the poses and rebuilds the occupancy grid."""
    J, T = _pair(frames, {"max_kf_pool": 4}, jax_params=False)
    for R in (J, T):
        _extend(R, frames, slice(3, 5))
    assert T.n_frames == J.n_frames == 4
    assert "pool full" in caplog.text
    np.testing.assert_array_equal(T.rays_np, J.rays_np)
    n_rays = T.n_rays
    for R in (J, T):
        R.add_new_frames(frames["rgb"][4:5], frames["depth"][4:5], frames["mask"][4:5],
                         frames["pose"][:5] * 1.0, frames["pcd"][::2])
    assert T.n_frames == 4 and T.n_rays == n_rays
    np.testing.assert_array_equal(T.c2w_np, J.c2w_np)
    np.testing.assert_array_equal(T.occ_grid.numpy(), np.asarray(J.occ_grid))


def _mlp_and_pose_close(tp, jp, pose_atol=2e-5):
    """MLP weights within 2e-5 (the tolerance of tests/test_torch_train.py),
    the pose array within ``pose_atol``."""
    for path, ref in jax.tree_util.tree_leaves_with_path(
            {k: v for k, v in jp.items() if k != "table"}):
        t = tp
        for p in path:
            t = t[p.key]
        atol = pose_atol if path[0].key == "pose_array" else 2e-5
        np.testing.assert_allclose(t.detach().numpy(), ref, rtol=0, atol=atol,
                                   err_msg=str(path))


def _table_close(tt, jt, table0, n_steps):
    """tests/test_torch_train.py's table rule: Adam's eps of 1e-15 turns a
    near-zero gradient into a +-lr step whose sign follows summation order,
    so at most 1% of the touched entries may be off by more than 2e-5, and
    none by more than 3 lr a step taken."""
    touched = jt != table0
    assert touched.sum() > 1000
    off = np.abs(tt - jt) > 2e-5
    assert off.sum() <= 0.01 * touched.sum(), (off.sum(), touched.sum())
    assert np.all(np.abs(tt - jt) <= 3 * 0.01 * n_steps + 1e-6)


def _poses_close(T, J, atol):
    pt, ot = T.get_optimized_poses_in_real_world()
    pj, oj = J.get_optimized_poses_in_real_world()
    assert pt.shape == (T.n_frames, 4, 4)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=atol)
    np.testing.assert_allclose(ot, oj, rtol=0, atol=atol)


def test_round_of_training_matches_jax(frames):
    """5 steps, add_new_frames, 5 more, from the same weights and the JAX
    key's draws.  After the first 5 steps the parameters agree within the
    tolerances of tests/test_torch_train.py and the exported poses within
    1e-5.  After the extension round the MLP and table still do; the pose
    array of the newest frame drifts to 5.9e-5 (2 of its 192 entries, the
    exported poses to 2.1e-5): the ~1e-6 drift of the other weights moves
    a sample across a mask edge (the cube, the depth band or an occupied
    voxel) in one run and not the other, and the first steps after the
    optimizer's reset follow each gradient's sign, so that one sample's
    term shows.  The looser bounds hold that measured drift with 1.7x and
    5x room."""
    J, T = _pair(frames)
    table0 = np.asarray(J.params["table"])
    for R in (J, T):
        R.train_advance(5)
        R.train_drain()
    jp = jax.tree_util.tree_map(np.asarray, J.params)
    _mlp_and_pose_close(T.params, jp)
    _table_close(T.params["table"].detach().numpy(), jp["table"], table0, 5)
    _poses_close(T, J, 1e-5)
    pose_t = T.params["pose_array"]
    for R in (J, T):
        _extend(R, frames, slice(3, 5))
    # fresh pose corrections and optimizer on the tensors the optimizer holds
    assert T.params["pose_array"] is pose_t and not pose_t.any()
    assert any(p is pose_t for g in T.optimizer.groups for p in g["params"])
    assert T.optimizer.count == 0 and not any(
        t.any() for g in T.optimizer.groups for t in g["exp_avg"] + g["exp_avg_sq"])
    assert T.global_step == J.global_step == 0 and T.total_step == J.total_step == 5
    for R in (J, T):
        R.train_advance(5)
        m = R.train_drain()
    assert T.optimizer.count == 5 and np.isfinite(m["loss"])
    jp = jax.tree_util.tree_map(np.asarray, J.params)
    _mlp_and_pose_close(T.params, jp, pose_atol=1e-4)
    _table_close(T.params["table"].detach().numpy(), jp["table"], table0, 10)
    _poses_close(T, J, 1e-4)


def test_mesh_from_equal_params(pair):
    """The same weights, shifted so that the SDF crosses zero inside the
    occupied space: vertex counts within 1%, symmetric distance within a
    voxel."""
    J, T = pair
    lin = np.linspace(-1, 1, 33, dtype=np.float32)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    occ = trunner.occ_ops.query_occupancy(T.occ_grid, torch.from_numpy(pts)).numpy()
    with torch.no_grad():
        sdf = tnof.nof_sdf(T.params, T.spec, torch.from_numpy(pts[occ])).numpy()
        shift = float(np.median(sdf))
        T.params["sigma"]["b1"][0] -= shift
    J.params["sigma"]["b1"] = J.params["sigma"]["b1"].at[0].add(-shift)
    vox = 0.01
    mt, mj = T.extract_mesh(voxel_size=vox), J.extract_mesh(voxel_size=vox)
    assert len(mj.vertices) > 200
    assert abs(len(mt.vertices) - len(mj.vertices)) <= 0.01 * len(mj.vertices)
    from scipy.spatial import cKDTree

    d1 = cKDTree(mj.vertices).query(mt.vertices)[0].max()
    d2 = cKDTree(mt.vertices).query(mj.vertices)[0].max()
    assert max(d1, d2) <= vox * float(T.cfg["sc_factor"]), (d1, d2)
    mw = trunner.mesh_to_real_world(mt.copy(), np.eye(4), T.cfg["translation"],
                                    T.cfg["sc_factor"])
    mwj = jrunner.mesh_to_real_world(mt.copy(), np.eye(4), T.cfg["translation"],
                                     T.cfg["sc_factor"])
    np.testing.assert_allclose(mw.vertices, mwj.vertices, rtol=0, atol=1e-12)


def test_training_surface_on_cpu(frames, tmp_path):
    """Synchronous chunks on the CPU (nothing pending), the calibration
    chunk, the default generator draws, and a due checkpoint written at the
    next drain."""
    cfg = frames["cfg"].merged({"loop_chunk": 4})
    runs = []
    for _ in range(2):
        T = trunner.NofRunner(Cfg.wrap(dict(cfg)), *_inputs(frames, slice(0, 3)),
                              frames["K"], frames["pcd"], device="cpu")
        assert T.train_drain() == {} and T.pending_chunks() == 0
        T.train_advance(6)
        assert T.train_queue_ready() and T.global_step == 6
        ms = T.calibrate_step_ms()
        assert ms > 0 and T._calibrate_steps == 12 and T.total_step == 18
        assert T.calibrate_step_ms() == ms  # cached
        m = T.train(3)
        assert set(m) >= {"loss", "rgb_loss", "fs_loss", "sdf_loss"}
        runs.append(T)
    for a, b in zip(trunner.param_leaves(runs[0].params), trunner.param_leaves(runs[1].params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    T = runs[0]
    T.cfg["i_weights"] = 25
    T.cfg["save_dir"] = str(tmp_path)
    T.train_advance(3)
    T.train_drain()
    assert not (tmp_path / "model_latest.pth").exists()
    T.train_advance(4)
    T.train_drain()
    assert trunner.load_checkpoint(str(tmp_path / "model_latest.pth"))["total_step"] == 28
    # dp_devices > 1 is ported (parallel/): without a process group of two
    # ranks it raises, and says how to launch them
    with pytest.raises(RuntimeError, match="BSDF_NUM_PROCESSES"):
        trunner.NofRunner(Cfg.wrap(dict(cfg, dp_devices=2)), *_inputs(frames, slice(0, 3)),
                          frames["K"], frames["pcd"], device="cpu")


def test_train_loop_takes_a_draw_source():
    """make_train_loop hands each step its (step, n_rays) draws."""
    from bundlesdf_tpu_torch import entry

    small = dict(n_rand=32, n_samples=8, n_around=4, num_levels=2, finest_res=16,
                 log2_hashmap=14, n_march=16, num_frames=2, occ_res=8)
    spec, rcfg, weights, params, rays, c2w, grid = entry.build_nof(**small, device="cpu")
    st = trunner.TrainStatics(spec, rcfg, weights, 32, 500, 0.01, 0.01, "", 1.0)
    seen = []

    def draws(step, n_rays):
        seen.append((step, n_rays))
        g = torch.Generator().manual_seed(step)
        return (torch.randint(0, n_rays, (32,), generator=g),
                trender.SampleDraws(torch.rand((32, 8), generator=g),
                                    torch.rand((32, 4), generator=g),
                                    torch.rand((32, 4), generator=g)))

    loop = trunner.make_train_loop(st, trunner.make_optimizer(small_nof_cfg(), params))
    m = loop(params, 7, rays, 32, grid, c2w, 3, draws=draws)
    assert seen == [(7, 32), (8, 32), (9, 32)] and np.isfinite(float(m["loss"]))
