"""The NOF training loop as one device program (``nof/runner.py::
TrainLoop``), on the CPU, where the same step runs eagerly on the loop's
device inputs: the loop against the JAX ``make_train_loop`` (its scanned
chunks) from the same weights and the JAX key's draws, the device-side lr
schedule and Adam against optax, the truncation on a step tensor against
the JAX one on a traced step, the runner's inputs written in place (so a
captured step stays valid), the eager rule, and the launch counts that a
replay adds."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from synthetic import make_sphere_dataset
from test_nof import tiny_cfg
from test_torch_train import SMALL, _rand_tree, _step_draws, _tree_np
from bundlesdf_tpu.config import default_nof_config as jax_cfg
from bundlesdf_tpu.nof import losses as jlosses
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu_torch import entry as tentry
from bundlesdf_tpu_torch.config import Cfg, default_nof_config as port_cfg
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.nof import losses as tlosses
from bundlesdf_tpu_torch.nof import runner as trunner
from bundlesdf_tpu_torch.ops import (_cuda_lib, build_rays_cuda, covisibility_cuda, depth_cuda,
                                     fuse_cloud_cuda, hashgrid_cuda, reduce_cuda)

torch.set_num_threads(2)

N_INNER = 3


@pytest.mark.parametrize("microbatch,decay,lrate_pose", [(0, "", None),
                                                         (32, "linear", 0.003)])
def test_loop_matches_jax_make_train_loop(microbatch, decay, lrate_pose):
    """Two chunks of N_INNER steps: the port's loop (steps on its device
    inputs, given the JAX key's batches and jitter) against the JAX
    scanned loop.  Each chunk's last-step metrics within rtol 1e-4 and the
    parameters after each chunk within tests/test_torch_train.py's bounds
    (the table's scaled by the steps taken, as tests/test_torch_runner.py
    does)."""
    over = {} if lrate_pose is None else {"lrate_pose": lrate_pose}
    spec, rcfg, weights, jp0, rays, c2w, grid = __graft_entry__._build_nof(**SMALL)
    st = jrunner.TrainStatics(spec=spec, rcfg=rcfg, weights=weights,
                              n_rand=SMALL["n_rand"], n_step=500, trunc=0.01,
                              trunc_start=0.02, trunc_decay_type=decay,
                              sc_factor=1.0, microbatch=microbatch)
    opt = jrunner.make_optimizer(jax_cfg().merged(over))
    jloop = jrunner.make_train_loop(st, opt)
    pool = jnp.concatenate([rays, rays[::-1]])
    n_rays = int(pool.shape[0])
    jp, jstate = jax.tree_util.tree_map(jnp.array, jp0), opt.init(jp0)

    tspec, trcfg, tweights, _, _, tc2w, tgrid = tentry.build_nof(**SMALL, device="cpu")
    tst = trunner.TrainStatics(tspec, trcfg, tweights, SMALL["n_rand"], 500, 0.01,
                               0.02, decay, 1.0, microbatch)
    tp = tnof.params_from_jax(_tree_np(jp0), device="cpu")
    topt = trunner.make_optimizer(port_cfg().merged(over), tp)
    tloop = trunner.make_train_loop(tst, topt)
    assert not tloop.graphed
    tpool = torch.from_numpy(np.array(pool))
    key = jax.random.PRNGKey(3)
    table0 = np.asarray(jp0["table"])

    for chunk in range(2):
        step0 = chunk * N_INNER
        jp, jstate, jm = jloop(jp, jstate, step0, key, pool,
                               jnp.asarray(n_rays, jnp.int32), grid, c2w, n_inner=N_INNER)
        tm = tloop(tp, step0, tpool, n_rays, tgrid, tc2w, N_INNER,
                   draws=lambda s, n: _step_draws(key, s, st, n))
        assert int(tloop.step) == step0 + N_INNER and int(topt.count) == step0 + N_INNER
        assert float(tm["valid_rays"]) == float(jm["valid_rays"])
        for k in ("loss", "rgb_loss", "fs_loss", "sdf_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"chunk {chunk} {k}")
        jn = _tree_np(jp)
        for path, ref in jax.tree_util.tree_leaves_with_path(
                {k: v for k, v in jn.items() if k != "table"}):
            t = tp
            for p in path:
                t = t[p.key]
            np.testing.assert_allclose(t.detach().numpy(), ref, rtol=0, atol=2e-5,
                                       err_msg=f"chunk {chunk} {path}")
        tt, jt = tp["table"].detach().numpy(), jn["table"]
        touched = jt != table0
        assert touched.sum() > 1000
        off = np.abs(tt - jt) > 2e-5
        assert off.sum() <= 0.01 * touched.sum(), (off.sum(), touched.sum())
        assert np.all(np.abs(tt - jt) <= 3 * 0.01 * (step0 + N_INNER) + 1e-6)
    assert tloop.eager_steps == 2 * N_INNER and tloop.replays == tloop.captures == 0


def _set_count(state, count):
    """An optax state with every update count (the int32 leaves) at ``count``."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(count, x.dtype) if x.dtype == jnp.int32 else x, state)


@pytest.mark.parametrize("lrate_pose", [0.01, 0.003])
@pytest.mark.parametrize("count", [0, 9, 10, 19])
def test_device_schedule_matches_optax(count, lrate_pose):
    """One update from zero moments at update count ``count`` (n_step 20:
    counts 0, 9, 10 and n_step - 1): the bias correction and the lr
    schedule, both computed on the device from the count tensor, give
    optax's update within rtol 1e-5; the schedule is an f32 tensor."""
    over = {"n_step": 20, "lrate_pose": lrate_pose}
    cfg_j, cfg_t = jax_cfg().merged(over), port_cfg().merged(over)
    p0 = _rand_tree(1)
    g = _rand_tree(7, scale=0.05)
    opt = jrunner.make_optimizer(cfg_j)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    upd, _ = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                        _set_count(opt.init(jp), count), jp)
    jp = optax.apply_updates(jp, upd)

    tp = tnof.params_from_jax(p0, device="cpu")
    topt = trunner.make_optimizer(cfg_t, tp)
    topt.count.fill_(count)
    scale = topt.schedule(topt.count)
    assert scale.dtype == torch.float32 and scale.shape == ()
    np.testing.assert_allclose(float(scale), 0.1 ** ((count // 10) * 10 / 20), rtol=1e-6)
    leaves = jax.tree_util.tree_leaves(tp)
    for t, gv in zip(leaves, jax.tree_util.tree_leaves(g)):
        t.grad = torch.from_numpy(gv.copy())
    topt.step()
    assert int(topt.count) == count + 1
    for a, b in zip(leaves, jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("decay", ["", "linear", "exp"])
def test_truncation_on_a_step_tensor_matches_jax(decay):
    """truncation_value on an int64 step tensor (f32 on its device) against
    the JAX function on a traced int32 step, at the start, inside and past
    the decay."""
    jfn = jax.jit(lambda s: jlosses.truncation_value(s, 500, 0.01, 0.04, 2.0, decay))
    for step in (0, 37, 125, 499, 500, 900):
        got = tlosses.truncation_value(torch.tensor(step), 500, 0.01, 0.04, 2.0, decay)
        want = np.asarray(jfn(jnp.int32(step)))
        if decay:
            assert got.dtype == torch.float32
        np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-6,
                                   err_msg=f"{decay} {step}")


def test_draw_batch_bound_on_the_device():
    """The batch rows lie in [0, max(n_rays, 1)) for an int or a tensor
    bound, and the same generator state draws the same rows either way."""
    for n in (0, 1, 7, 40_000):
        rows = []
        for bound in (n, torch.tensor(n)):
            g = torch.Generator().manual_seed(5)
            rows.append(trunner.draw_batch(4096, bound, g, torch.device("cpu")))
        assert torch.equal(rows[0], rows[1]) and rows[0].dtype == torch.int64
        assert int(rows[0].min()) >= 0 and int(rows[0].max()) < max(n, 1)
        if n > 1000:
            assert len(torch.unique(rows[0])) > 3500


def test_loop_step_equals_the_plain_step():
    """The loop's step on its device inputs (step and n_rays tensors, the
    batch drawn into its buffer) equals the step called with Python numbers
    on the same generator state, bit for bit, over 3 steps."""
    out = []
    for use_loop in (True, False):
        spec, rcfg, weights, params, rays, c2w, grid = tentry.build_nof(**SMALL,
                                                                        device="cpu")
        st = trunner.TrainStatics(spec, rcfg, weights, SMALL["n_rand"], 500, 0.01,
                                  0.02, "exp", 1.0)
        opt = trunner.make_optimizer(port_cfg(), params)
        gen = torch.Generator().manual_seed(11)
        if use_loop:
            loop = trunner.make_train_loop(st, opt)
            m = loop(params, 4, rays, rays.shape[0], grid, c2w, 3, generator=gen)
            assert torch.all(loop.batch_idx < rays.shape[0])
        else:
            step = trunner.make_train_step(st, opt)
            for i in range(3):
                m = step(params, 4 + i, rays, rays.shape[0], grid, c2w, generator=gen)
        out.append((m, [p.detach().clone() for p in trunner.param_leaves(params)],
                    gen.get_state()))
    (m0, p0, g0), (m1, p1, g1) = out
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    assert torch.equal(g0, g1)


def _sphere_runner(cfg=None):
    data = make_sphere_dataset(n_views=2, H=32, W=32)
    cfg = cfg or tiny_cfg()
    cfg.update(N_rand=128, loop_chunk=2)
    runner = trunner.NofRunner(Cfg.wrap(dict(cfg)), data["images"], data["depths"],
                               data["masks"], data["poses"], data["K"], data["cloud"],
                               device="cpu")
    return runner, data


def _inputs(runner):
    """Every tensor a captured step reads, by name."""
    loop, opt = runner._train_many, runner.optimizer
    out = {"rays": runner.rays_dev, "occ_grid": runner.occ_grid, "c2w": runner.c2w_dev,
           "count": opt.count, "step": loop.step, "n_rays": loop.n_rays,
           "batch_idx": loop.batch_idx}
    for gi, g in enumerate(opt.groups):
        for i, p in enumerate(g["params"]):
            out[f"g{gi}/p{i}"] = p
            out[f"g{gi}/m{i}"] = g["exp_avg"][i]
            out[f"g{gi}/v{i}"] = g["exp_avg_sq"][i]
    return out


def test_runner_writes_the_step_inputs_in_place(tmp_path):
    """optimizer.reset(), a pose sync (set_poses, update_c2w), an occupancy
    rebuild and load_weights keep every input tensor's storage, and each
    write lands: zero moments and count, the new poses, the new grid, the
    saved weights and state."""
    runner, data = _sphere_runner()
    runner.train(2)
    ckpt = str(tmp_path / "w.pth")
    runner.save_weights(ckpt)
    saved = {k: v.detach().clone() for k, v in _inputs(runner).items()}
    ptrs = {k: v.data_ptr() for k, v in _inputs(runner).items()}
    runner.train(2)
    assert int(runner.optimizer.count) == 4

    runner.optimizer.reset()
    assert int(runner.optimizer.count) == 0
    assert not any(t.any() for g in runner.optimizer.groups
                   for t in g["exp_avg"] + g["exp_avg_sq"])
    poses = runner.c2w_np[: runner.n_frames].copy()
    poses[:, :3, 3] += 0.01
    runner.set_poses(poses)
    np.testing.assert_array_equal(runner.c2w_dev.numpy(), runner.c2w_np)
    runner.build_occupancy(data["cloud"][::3] * 0.5)
    fresh = trunner.occ_ops.dilate_grid(trunner.occ_ops.build_occupancy_grid(
        *_padded(data["cloud"][::3] * 0.5), runner.occ_resolution), runner.occ_dilate)
    assert torch.equal(runner.occ_grid, fresh)
    assert {k: v.data_ptr() for k, v in _inputs(runner).items()} == ptrs

    runner.load_weights(ckpt)
    now = _inputs(runner)
    assert {k: v.data_ptr() for k, v in now.items()} == ptrs
    assert runner.global_step == 2 and runner.loads == 1
    for k in ("occ_grid", "c2w", "count") + tuple(k for k in saved if k.startswith("g")):
        assert torch.equal(now[k], saved[k]), k
    runner.train(2)
    st = runner.graph_stats()
    assert not st["graphed"] and st["captures"] == st["replays"] == 0
    assert st["eager_steps"] == 6 and st["ray_pool_allocations"] == 1


def _padded(pts):
    """build_occupancy's padded cloud and validity."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    cap = 1 << max(10, (len(pts) - 1).bit_length())
    pad = np.zeros((cap, 3), np.float32)
    pad[: len(pts)] = pts
    valid = np.zeros(cap, bool)
    valid[: len(pts)] = True
    return torch.from_numpy(pad), torch.from_numpy(valid)


def test_ray_pool_growth_allocates_a_new_pool():
    """A pool that outgrows its power-of-2 capacity is allocated anew (the
    one event that makes a CUDA runner capture again); an append that fits
    writes in place."""
    runner, _ = _sphere_runner()
    ptr, cap = runner.rays_dev.data_ptr(), runner.rays_dev.shape[0]
    rows = runner.rays_np
    rows = np.concatenate([rows, rows[:10]])
    runner._upload_rays(rows[-10:])
    assert runner.rays_dev.data_ptr() == ptr and runner.ray_pool_allocations == 1
    while len(rows) <= cap:
        runner._upload_rays(rows)
        rows = np.concatenate([rows, rows])
    assert runner.rays_dev.shape[0] == 2 * cap and runner.ray_pool_allocations == 2
    np.testing.assert_array_equal(runner.rays_dev[: runner.n_rays].numpy(), rows)
    np.testing.assert_array_equal(runner.rays_np, rows)
    m = runner.train(2)
    assert np.isfinite(m["loss"]) and int(runner._train_many.n_rays) == runner.n_rays


def test_eager_by_rule():
    """The step is captured on a CUDA device with one rank; on the CPU and
    under a mesh (dp_devices > 1: gloo's collectives) it runs eagerly.  The
    rule is taken at construction, and the CPU runner's loop follows it."""
    assert trunner.TrainLoop.uses_graph(torch.device("cuda", 0), None)
    assert not trunner.TrainLoop.uses_graph(torch.device("cpu"), None)
    assert not trunner.TrainLoop.uses_graph(torch.device("cuda", 0), object())
    runner, _ = _sphere_runner()
    assert isinstance(runner._train_many, trunner.TrainLoop)
    assert not runner._train_many.graphed
    before = dict(trunner.graph_counts)
    runner.train_advance(3)
    runner.train_drain()
    assert trunner.graph_counts["eager_steps"] - before["eager_steps"] == 3
    assert trunner.graph_counts["replays"] == before["replays"]


def test_replays_add_their_captured_launches(monkeypatch):
    """add_launches adds what a capture counted, per replay, to each kernel
    wrapper's ``launches`` (and takes a capture's own calls back off)."""
    monkeypatch.setattr(reduce_cuda, "launches", 5)
    monkeypatch.setattr(hashgrid_cuda, "launches", 1)
    monkeypatch.setattr(depth_cuda, "launches", 3)
    monkeypatch.setattr(covisibility_cuda, "launches", 7)
    monkeypatch.setattr(fuse_cloud_cuda, "launches", 9)
    monkeypatch.setattr(build_rays_cuda, "launches", 11)
    assert _cuda_lib.launch_counts() == {"reduce_cuda": 5, "hashgrid_cuda": 1,
                                         "depth_cuda": 3, "covisibility_cuda": 7,
                                         "fuse_cloud_cuda": 9, "build_rays_cuda": 11}
    per = {"reduce_cuda": 2, "hashgrid_cuda": 1, "depth_cuda": 0, "covisibility_cuda": 0,
           "fuse_cloud_cuda": 0, "build_rays_cuda": 0}
    _cuda_lib.add_launches(per, -1)
    _cuda_lib.add_launches(per, 16)
    assert (reduce_cuda.launches, hashgrid_cuda.launches, depth_cuda.launches,
            covisibility_cuda.launches, fuse_cloud_cuda.launches,
            build_rays_cuda.launches) == (35, 16, 3, 7, 9, 11)
