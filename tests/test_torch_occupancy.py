"""Occupancy grid and occupied-space sampling of the PyTorch port against the
JAX package, on the same numpy inputs and the same jitter uniforms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.ops import occupancy as jocc
from bundlesdf_tpu.utils import geometry as jgeo
from bundlesdf_tpu_torch.ops import occupancy as tocc
from bundlesdf_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(2)

R_GRID = 32
N_RAYS = 96
N_MARCH = 64


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(1500, 3)).astype(np.float32)
    pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True) * 0.4
    pts[:20] *= 4.0  # a few outside the cube: not scattered
    valid = rng.uniform(size=1500) > 0.1
    o = np.tile(np.array([[0.0, 0.0, 1.6]], np.float32), (N_RAYS, 1))
    o[:, :2] = rng.uniform(-0.2, 0.2, (N_RAYS, 2))
    d = np.stack([rng.uniform(-0.4, 0.4, N_RAYS), rng.uniform(-0.4, 0.4, N_RAYS),
                  -np.ones(N_RAYS)], -1).astype(np.float32)
    d[-4:] = [0.0, 1.0, 0.0]  # misses the box
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    depth = rng.uniform(1.0, 2.2, N_RAYS).astype(np.float32)
    depth[:8] = 0.0  # invalid depth: no clip
    return pts, valid, o, d, depth


def _grids(pts, valid):
    jg = jocc.dilate_grid(jocc.build_occupancy_grid(
        jnp.asarray(pts), jnp.asarray(valid), R_GRID), 1)
    tg = tocc.dilate_grid(tocc.build_occupancy_grid(
        torch.from_numpy(pts), torch.from_numpy(valid), R_GRID), 1)
    return jg, tg


def test_build_and_dilate_equal():
    pts, valid, *_ = _scene()
    raw_j = np.asarray(jocc.build_occupancy_grid(jnp.asarray(pts),
                                                 jnp.asarray(valid), R_GRID))
    raw_t = tocc.build_occupancy_grid(torch.from_numpy(pts),
                                      torch.from_numpy(valid), R_GRID)
    assert raw_t.dtype == torch.bool
    np.testing.assert_array_equal(raw_t.numpy(), raw_j)
    for it in (1, 2):
        np.testing.assert_array_equal(
            tocc.dilate_grid(raw_t, it).numpy(),
            np.asarray(jocc.dilate_grid(jnp.asarray(raw_j), it)))


def test_ray_box_intersection():
    _, _, o, d, _ = _scene(1)
    o = o.copy()
    o[:5] = 0.0  # starting inside the box
    lo, hi = np.full(3, -1.0, np.float32), np.ones(3, np.float32)
    jt = jgeo.ray_box_intersection(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(lo), jnp.asarray(hi))
    tt = tgeo.ray_box_intersection(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(lo), torch.from_numpy(hi))
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert np.all(tt[0].numpy()[-4:] == -1.0)


def test_march_occupancy():
    pts, valid, o, d, _ = _scene()
    jg, tg = _grids(pts, valid)
    jr = jocc._march_occupancy(jg, jnp.asarray(o), jnp.asarray(d), N_MARCH)
    tr = tocc._march_occupancy(tg, torch.from_numpy(o), torch.from_numpy(d), N_MARCH)
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))  # occupancy
    assert tr[0].any()
    for a, b in zip(tr[1:], jr[1:]):  # t0, dt, t_mid
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_cdf_rank_equals_rank_count():
    """The port's searchsorted rank == the JAX compare-count rank, including
    ties (flat cdf runs over empty steps) and targets at the ends."""
    rng = np.random.default_rng(2)
    occ = rng.uniform(size=(64, 40)) > 0.6
    cdf = np.cumsum(np.where(occ, 0.05, 0.0), axis=-1).astype(np.float32)
    s = rng.uniform(0, 1, (64, 25)).astype(np.float32) * cdf[:, -1:]
    s[:, 0] = 0.0
    s[:, 1] = cdf[:, -1]
    s[:, 2] = cdf[:, 5]  # exactly on a cdf value
    ref = np.sum(cdf[:, None, :] <= s[:, :, None], axis=-1)
    out = tocc._cdf_rank(torch.from_numpy(cdf), torch.from_numpy(s))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("perturb", [True, False])
def test_sampling_with_fallback(perturb):
    pts, valid, o, d, depth = _scene()
    jg, tg = _grids(pts, valid)
    k_main, k_fb = jax.random.split(jax.random.PRNGKey(7))
    n_s, n_fb = 32, 16
    jz, jzfb, jhit = jocc.sample_rays_occupied_with_fallback(
        k_main, k_fb, jg, jnp.asarray(o), jnp.asarray(d), N_MARCH, n_s, n_fb,
        jnp.asarray(depth), 0.05, perturb)
    u_main = torch.from_numpy(np.array(jax.random.uniform(k_main, (N_RAYS, n_s))))
    u_fb = torch.from_numpy(np.array(jax.random.uniform(k_fb, (N_RAYS, n_fb))))
    tz, tzfb, thit = tocc.sample_rays_occupied_with_fallback(
        tg, torch.from_numpy(o), torch.from_numpy(d), N_MARCH, n_s, n_fb,
        torch.from_numpy(depth), 0.05, perturb, u_main=u_main, u_fb=u_fb)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    assert thit.any() and not thit.all()
    # z = t0 + k*dt + residual: f32 sums of up to N_MARCH step lengths
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tzfb.numpy(), np.asarray(jzfb), rtol=0, atol=2e-5)


def test_sample_in_occupied_space_near_far():
    pts, valid, o, d, depth = _scene(3)
    jg, tg = _grids(pts, valid)
    key = jax.random.PRNGKey(11)
    jout = jocc.sample_rays_in_occupied_space(
        key, jg, jnp.asarray(o), jnp.asarray(d), N_MARCH, 24,
        depth=jnp.asarray(depth), trunc=0.02, perturb=True)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (N_RAYS, 24))))
    tout = tocc.sample_rays_in_occupied_space(
        tg, torch.from_numpy(o), torch.from_numpy(d), N_MARCH, 24,
        depth=torch.from_numpy(depth), trunc=0.02, perturb=True, u=u)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    for a, b in zip((tout[0], tout[2], tout[3]), (jout[0], jout[2], jout[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)


@pytest.mark.parametrize("perturb", [True, False])
def test_sample_rays_uniform(perturb):
    rng = np.random.default_rng(4)
    near = rng.uniform(0.5, 1.0, 50).astype(np.float32)
    far = near + rng.uniform(0.01, 0.1, 50).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jz = np.asarray(jocc.sample_rays_uniform(key, jnp.asarray(near),
                                             jnp.asarray(far), 16, perturb))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (50, 16))))
    tz = tocc.sample_rays_uniform(torch.from_numpy(near), torch.from_numpy(far),
                                  16, perturb, u=u)
    np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-6, atol=1e-6)


def test_draws_come_from_the_generator_when_absent():
    near = torch.zeros(8)
    far = torch.ones(8)
    a = tocc.sample_rays_uniform(near, far, 4, True,
                                 generator=torch.Generator().manual_seed(0))
    b = tocc.sample_rays_uniform(near, far, 4, True,
                                 generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool(torch.all(a >= 0) & torch.all(a <= 1))
