"""Multi-pair RANSAC of the port (bundlesdf_tpu_torch.ops.ransac) against the
JAX package's ops/ransac.py, with the port given the JAX key's own uniform
draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from bundlesdf_tpu.ops import ransac as jr
from bundlesdf_tpu_torch.ops import ransac as tr

torch.set_num_threads(2)


def jax_draws(seed, shape):
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape)))


def make_pairs(P=3, M=96, n_out=30, seed=0):
    """Inliers with 0.2 mm noise and outliers 5-20 cm off: no row lies near
    the 5 mm gate.  Pair 1 has some invalid rows, pair P-1 has none valid."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.1, 0.1, (P, M, 3)).astype(np.float32)
    R = Rotation.from_rotvec(rng.normal(size=(P, 3)) * 0.1).as_matrix()
    t = rng.normal(size=(P, 3)) * 0.005
    dst = np.einsum("pij,pmj->pmi", R, src) + t[:, None]
    dst += rng.normal(0, 2e-4, dst.shape)
    for p in range(P):
        idx = rng.permutation(M)[:n_out]
        dst[p, idx] += rng.uniform(0.05, 0.2, (n_out, 3)) * rng.choice([-1, 1], (n_out, 3))
    nrm = rng.normal(size=(P, M, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm_b = np.einsum("pij,pmj->pmi", R, nrm)
    valid = np.ones((P, M), bool)
    valid[1, ::7] = False
    valid[P - 1] = False
    return [a.astype(np.float32) for a in (src, dst, nrm, nrm_b)] + [valid]


def test_sample_indices_equal_jax():
    _, _, _, _, valid = make_pairs()
    valid[0, 10:20] = False
    P, M = valid.shape
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jr._sample_indices(key, P, 300, M, jnp.asarray(valid)))
    out = tr._sample_indices(jax_draws(7, (P, 300, 3)), P, 300, M, torch.from_numpy(valid))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert valid[0][out[0].numpy()].all()


def test_tri_rigid_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(-0.1, 0.1, (5, 40, 3, 3)).astype(np.float32)
    b = (a @ Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix().T.astype(np.float32)
         + np.float32(0.01))
    out = tr._tri_rigid(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jr._tri_rigid(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("caps", [False, True])
def test_ransac_multi_pair_matches_jax(caps):
    src, dst, na, nb, valid = make_pairs()
    P = src.shape[0]
    params = jr.RansacParams(n_trials=400, max_trans=0.05, max_rot_deg=45.0)
    tparams = tr.RansacParams(n_trials=400, max_trans=0.05, max_rot_deg=45.0)
    mt = np.array([0.02, 0.1, 0.1][:P], np.float32) if caps else None
    mr = np.array([30.0, 60.0, 60.0][:P], np.float32) if caps else None
    ref = jr.ransac_multi_pair(
        jax.random.PRNGKey(3), *(jnp.asarray(x) for x in (src, dst, na, nb, valid)),
        params, None if mt is None else jnp.asarray(mt),
        None if mr is None else jnp.asarray(mr))
    out = tr.ransac_multi_pair(
        jax_draws(3, (P, 400, 3)), *(torch.from_numpy(x) for x in (src, dst, na, nb, valid)),
        tparams, None if mt is None else torch.from_numpy(mt),
        None if mr is None else torch.from_numpy(mr))
    ok = np.asarray(ref["ok"])
    np.testing.assert_array_equal(out["ok"].numpy(), ok)
    assert ok[0] and not ok[-1]
    pose = np.asarray(ref["pose"])
    np.testing.assert_allclose(out["pose"].numpy(), pose, rtol=0, atol=1e-4)
    # inlier masks equal except rows within 1e-6 m^2 of the 5 mm gate
    moved = np.einsum("pij,pmj->pmi", pose[:, :3, :3], src) + pose[:, None, :3, 3]
    near = np.abs(((moved - dst) ** 2).sum(-1) - 0.005 ** 2) < 1e-6
    inl_t, inl_j = out["inliers"].numpy(), np.asarray(ref["inliers"])
    np.testing.assert_array_equal(inl_t[~near], inl_j[~near])
    np.testing.assert_array_equal(out["n_inliers"].numpy(), np.asarray(ref["n_inliers"]))
    assert np.isfinite(out["pose"].numpy()).all()
    np.testing.assert_array_equal(out["pose"][-1].numpy(), np.eye(4))


def test_zero_inlier_pair_returns_identity():
    src, dst, na, nb, valid = make_pairs(P=2)
    valid[:] = False
    out = tr.ransac_multi_pair(
        jax_draws(0, (2, 64, 3)), *(torch.from_numpy(x) for x in (src, dst, na, nb, valid)),
        tr.RansacParams(n_trials=64))
    assert not out["ok"].any() and not out["inliers"].any()
    np.testing.assert_array_equal(out["pose"].numpy(), np.tile(np.eye(4), (2, 1, 1)))
    np.testing.assert_array_equal(out["n_inliers"].numpy(), 0)


def test_procrustes_by_correspondence_matches_jax():
    src, dst, _, _, valid = make_pairs(P=2)
    inl = valid & (np.linalg.norm(dst - src, axis=-1) < 0.05)
    out = tr.procrustes_by_correspondence(*(torch.from_numpy(x) for x in (src, dst, inl)))
    ref = jr.procrustes_by_correspondence(*(jnp.asarray(x) for x in (src, dst, inl)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_draw_uniforms_sources():
    """A given source is used as is (and its shape checked); without one the
    draws come from a generator seeded with the frame id."""
    u = tr.draw_uniforms(5, (2, 8, 3), "cpu", jax_draws)
    np.testing.assert_array_equal(u.numpy(), jax_draws(5, (2, 8, 3)).numpy())
    a = tr.draw_uniforms(5, (2, 8, 3), "cpu")
    b = tr.draw_uniforms(5, (2, 8, 3), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, tr.draw_uniforms(6, (2, 8, 3), "cpu"))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    with pytest.raises(ValueError):
        tr.draw_uniforms(5, (2, 8, 3), "cpu", lambda s, shape: torch.zeros(3))
