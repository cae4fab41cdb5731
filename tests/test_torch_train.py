"""NOF optimizer and training step of the PyTorch port against the JAX
package: the inf-norm clip, the Adam chain and its schedule against optax,
and three train steps from the same converted weights, batch indices and
jitter against the JAX ``make_train_step``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from bundlesdf_tpu.config import default_nof_config as jax_cfg
from bundlesdf_tpu.nof import losses as jlosses
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu_torch import entry as tentry
from bundlesdf_tpu_torch.config import default_nof_config as port_cfg
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.nof import losses as tlosses
from bundlesdf_tpu_torch.nof import render as trender
from bundlesdf_tpu_torch.nof import runner as trunner

torch.set_num_threads(2)

SMALL = dict(n_rand=64, n_samples=16, n_around=8, num_levels=2, finest_res=32,
             log2_hashmap=22, n_march=32, num_frames=4, occ_res=16)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"table": (rng.normal(size=50) * scale).astype(np.float32),
            "sigma": {"w0": (rng.normal(size=(3, 4)) * scale).astype(np.float32)},
            "pose_array": (rng.normal(size=(4, 6)) * scale).astype(np.float32)}


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_inf_norm(scale):
    g = _rand_tree(0, scale)
    init, update = jrunner.clip_by_global_inf_norm(0.1)
    ref, _ = update(jax.tree_util.tree_map(jnp.asarray, g), init(g))
    out = [torch.from_numpy(v.copy()) for v in jax.tree_util.tree_leaves(g)]
    trunner.clip_by_global_inf_norm(out, 0.1)
    for a, b in zip(out, jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


@pytest.mark.parametrize("lrate_pose", [0.01, 0.003])
def test_optimizer_matches_optax(lrate_pose):
    """12 updates (the lr schedule steps at 10) with a separate pose chain
    when lrate_pose != lrate; Adam in a different f32 order: rtol 1e-5."""
    over = {"n_step": 20, "lrate_pose": lrate_pose, "gradient_max_norm": 0.5}
    cfg_j, cfg_t = jax_cfg().merged(over), port_cfg().merged(over)
    p0 = _rand_tree(1)
    opt = jrunner.make_optimizer(cfg_j)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = opt.init(jp)
    tp = tnof.params_from_jax(p0, device="cpu")
    topt = trunner.make_optimizer(cfg_t, tp)
    leaves_t = jax.tree_util.tree_leaves(tp)
    for k in range(12):
        g = _rand_tree(100 + k, scale=0.3 * (k + 1))
        upd, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, gv in zip(leaves_t, jax.tree_util.tree_leaves(g)):
            t.grad = torch.from_numpy(gv.copy())
        topt.step()
        topt.zero_grad()
    assert topt.count == 12
    for a, b in zip(leaves_t, jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_schedule_and_microbatch_pick():
    opt = trunner.make_optimizer(port_cfg(), tnof.params_from_jax(_rand_tree(2),
                                                                  device="cpu"))
    for count in (0, 9, 10, 255, 499):
        assert opt.schedule(count) == pytest.approx(
            0.1 ** ((count // 10) * 10 / 500), rel=1e-12)
    for args in ((2048, 192, 4), (2048, 320, 16), (100, 320, 16), (64, 24, 2, 16)):
        assert trunner._pick_microbatch(*args) == jrunner._pick_microbatch(*args)


def _step_draws(key, step, st, n_rays):
    """Batch indices and jitter uniforms that the JAX step draws at
    ``step`` (fold_in, split into batch and render keys; one render key per
    microbatch chunk), as the port's arguments."""
    kb, kr = jax.random.split(jax.random.fold_in(key, step))
    idx = jax.random.randint(kb, (st.n_rand,), 0,
                             jnp.maximum(jnp.asarray(n_rays, jnp.int32), 1))
    mb = st.microbatch
    if mb and mb < st.n_rand:
        n_chunks = -(-st.n_rand // mb)
        keys, n = list(jax.random.split(kr, n_chunks)), mb
    else:
        keys, n = [kr], st.n_rand
    parts = []
    for k in keys:
        k, _ = jax.random.split(k)
        k1, k2, k3 = jax.random.split(k, 3)
        parts.append([np.array(jax.random.uniform(kk, (n, s))) for kk, s in (
            (k1, st.rcfg.n_samples), (k2, st.rcfg.n_samples_around_depth),
            (k3, st.rcfg.n_samples_around_depth))])
    draws = trender.SampleDraws(*(torch.from_numpy(np.concatenate(u))
                                  for u in zip(*parts)))
    return torch.from_numpy(np.array(idx)).long(), draws


@pytest.mark.parametrize("microbatch", [0, 32])
def test_three_train_steps_match_jax(microbatch):
    spec, rcfg, weights, jp0, rays, c2w, grid = __graft_entry__._build_nof(**SMALL)
    st = jrunner.TrainStatics(spec=spec, rcfg=rcfg, weights=weights,
                              n_rand=SMALL["n_rand"], n_step=500, trunc=0.01,
                              trunc_start=0.01, trunc_decay_type="",
                              sc_factor=1.0, microbatch=microbatch)
    opt = jrunner.make_optimizer(jax_cfg())
    jstep, _ = jrunner.make_train_step(st, opt)
    jp, jstate = jp0, opt.init(jp0)
    pool = jnp.concatenate([rays, rays[::-1]])  # 2 x n_rand rows to draw from
    n_rays = int(pool.shape[0])

    tspec, trcfg, tweights, _, _, tc2w, tgrid = tentry.build_nof(**SMALL,
                                                                device="cpu")
    tst = trunner.TrainStatics(tspec, trcfg, tweights, SMALL["n_rand"], 500, 0.01,
                               0.01, "", 1.0, microbatch)
    tp = tnof.params_from_jax(_tree_np(jp0), device="cpu")
    tstep = trunner.make_train_step(tst, trunner.make_optimizer(port_cfg(), tp))
    tpool = torch.from_numpy(np.array(pool))

    key = jax.random.PRNGKey(3)
    for step in range(3):
        jp, jstate, jm = jstep(jp, jstate, step, key, pool,
                               jnp.asarray(n_rays, jnp.int32), grid, c2w)
        idx, draws = _step_draws(key, step, st, n_rays)
        tm = tstep(tp, step, tpool, n_rays, tgrid, tc2w, batch_idx=idx, draws=draws)
        assert float(tm["valid_rays"]) == float(jm["valid_rays"])
        for k in ("loss", "rgb_loss", "fs_loss", "sdf_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {step} {k}")
    jp = _tree_np(jp)
    # MLP weights and pose array: Adam moves each entry by ~lr per step;
    # gradients agree to f32 summation order, so updates agree to ~1e-6
    for path, ref in jax.tree_util.tree_leaves_with_path(
            {k: v for k, v in jp.items() if k != "table"}):
        t = tp
        for p in path:
            t = t[p.key]
        np.testing.assert_allclose(t.detach().numpy(), ref, rtol=0, atol=2e-5,
                                   err_msg=str(path))
    # table: Adam's eps of 1e-15 turns an entry whose gradient is near zero
    # into a +-lr step whose sign depends on summation order, so entries may
    # differ by up to 3 * lr.  At most 1% of the touched entries may do so;
    # all others agree to 2e-5.
    tt = tp["table"].detach().numpy()
    jt = jp["table"]
    touched = jt != np.asarray(jp0["table"])
    assert touched.sum() > 1000
    off = np.abs(tt - jt) > 2e-5
    assert off.sum() <= 0.01 * touched.sum(), (off.sum(), touched.sum())
    assert np.all(np.abs(tt - jt) <= 3 * 0.01 + 1e-6)


def test_train_loop():
    tspec, trcfg, tweights, tp, trays, tc2w, tgrid = tentry.build_nof(
        **SMALL, device="cpu")
    st = trunner.TrainStatics(tspec, trcfg, tweights, SMALL["n_rand"], 500, 0.01,
                              0.01, "", 1.0)
    opt = trunner.make_optimizer(port_cfg(), tp)
    loop = trunner.make_train_loop(st, opt)
    m = loop(tp, 0, trays, trays.shape[0], tgrid, tc2w, 4,
             generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"])) and opt.count == 4
    assert jlosses.LossWeights()._fields == tlosses.LossWeights()._fields
