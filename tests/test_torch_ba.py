"""Bundle adjustment of the port (bundlesdf_tpu_torch.tracking.ba) against the
JAX package's tracking/ba.py on the fixtures of tests/test_ba.py: the feature
term (clean, fixed frames, outliers) and the dense point-to-plane term."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import build_sparse_edges, empty_dense, make_pose_graph
from bundlesdf_tpu.tracking import ba as jba
from bundlesdf_tpu.utils import se3 as jse3
from bundlesdf_tpu_torch.tracking import ba as tba

torch.set_num_threads(2)


def _perturb(poses, frames, seed):
    rng = np.random.default_rng(seed)
    out = poses.copy()
    for k in frames:
        xi = np.r_[rng.normal(0, 0.01, 3), rng.normal(0, 0.02, 3)].astype(np.float32)
        out[k] = np.asarray(jse3.se3_exp(jnp.asarray(xi))) @ out[k]
    return out


def _run_both(init, fixed, ii, jj, pi, pj, cvalid, dense, n, **kw):
    args = [init, fixed, ii, jj, pi, pj, cvalid, dense["pair_i"], dense["pair_j"],
            dense["pair_valid"], dense["xyz_ds"], dense["normal_ds"],
            dense["valid_ds"], dense["K_ds"]]
    ref, rinfo = jba.bundle_adjust(*(jnp.asarray(a) for a in args),
                                   jba.BAParams(**kw), n)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    for i in (2, 3, 7, 8):  # index arrays
        targs[i] = targs[i].long()
    out, info = tba.bundle_adjust(*targs, tba.BAParams(**kw), n)
    return out.numpy(), np.asarray(ref), info, rinfo


def rot_angle(a, b):
    """Angle between two rotations from their chord, 2 asin(|A - B|_F / 2^1.5)
    (well-conditioned near 0, unlike the arccos of the trace in f32)."""
    d = np.linalg.norm(a.astype(np.float64) - b.astype(np.float64))
    return 2.0 * np.arcsin(min(1.0, d / 2 ** 1.5))


def _assert_poses_close(out, ref):
    np.testing.assert_allclose(out[:, :3, 3], ref[:, :3, 3], rtol=0, atol=1e-5)
    for a, b in zip(out, ref):
        assert rot_angle(a[:3, :3], b[:3, :3]) < 1e-4


@pytest.mark.parametrize("case", ["perturbed", "fixed_frames", "outliers"])
def test_feature_ba_matches_jax(case):
    n = 3 if case == "outliers" else 5 if case == "perturbed" else 4
    gt, cams, _ = make_pose_graph(n, n_pts=150 if case == "outliers" else 200)
    if case == "outliers":
        rng = np.random.default_rng(3)
        bad = rng.permutation(cams.shape[1])[:30]
        cams = cams.copy()
        cams[2, bad] += rng.uniform(0.05, 0.2, (30, 3)).astype(np.float32)
    ii, jj, pi, pj = build_sparse_edges(n, cams, cams.shape[1])
    fixed = {"perturbed": [True] + [False] * 4, "fixed_frames": [True, True, False, True],
             "outliers": [True, False, False]}[case]
    init = _perturb(gt, [k for k in range(n) if not fixed[k]], seed=1)
    cvalid = np.ones(len(ii), bool)
    cvalid[::11] = False
    out, ref, info, rinfo = _run_both(
        init, np.array(fixed), ii, jj, pi, pj, cvalid, empty_dense(n), n,
        num_iter_outer=7, w_p2p=0.0, robust_delta=0.005)
    _assert_poses_close(out, ref)
    for k in np.nonzero(fixed)[0]:
        np.testing.assert_array_equal(out[k], init[k])
    np.testing.assert_allclose(info["chi2_feature"].numpy(),
                               np.asarray(rinfo["chi2_feature"]), rtol=1e-3, atol=1e-9)


def test_dense_ba_matches_jax():
    """The sloped-plane fixture of test_ba_dense_term_aligns_planes, both
    terms on, with a padded third frame."""
    h = w = 32
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    jg, ig = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = (ig - K[0, 2]) / K[0, 0]
    y = (jg - K[1, 2]) / K[1, 1]
    z = 0.5 / (1 - 0.2 * x - 0.1 * y)
    xyz = np.stack([x * z, y * z, z], -1).astype(np.float32)
    nrm = -np.array([-0.2, -0.1, 1.0]) / np.linalg.norm([-0.2, -0.1, 1.0])
    normals = np.broadcast_to(nrm.astype(np.float32), xyz.shape).copy()
    init = np.stack([np.eye(4, dtype=np.float32)] * 3)
    init[1][:3, 3] += (0.01 * nrm).astype(np.float32)
    dense = dict(pair_i=np.array([1, 2, 2], np.int32), pair_j=np.array([0, 0, 1], np.int32),
                 pair_valid=np.array([True, False, False]),
                 xyz_ds=np.stack([xyz, xyz, np.zeros_like(xyz)]),
                 normal_ds=np.stack([normals, normals, np.zeros_like(normals)]),
                 valid_ds=np.stack([np.ones((h, w), bool)] * 2 + [np.zeros((h, w), bool)]),
                 K_ds=K)
    one = np.zeros(1, np.int32)
    out, ref, info, rinfo = _run_both(
        init, np.array([True, False, True]), one, one, np.zeros((1, 3), np.float32),
        np.zeros((1, 3), np.float32), np.zeros(1, bool), dense, 3,
        num_iter_outer=7, dense_max_dist=0.05)
    _assert_poses_close(out, ref)
    off0 = abs(init[1][:3, 3] @ nrm)
    assert abs(out[1][:3, 3] @ nrm) < 0.2 * off0
    np.testing.assert_allclose(info["chi2_dense"].numpy(), np.asarray(rinfo["chi2_dense"]),
                               rtol=1e-3, atol=1e-9)


def test_solve_gn_step_matches_jax():
    rng = np.random.default_rng(4)
    n = 4
    J = rng.normal(size=(50, 6 * n)).astype(np.float32)
    A = (J.T @ J).reshape(n, 6, n, 6).transpose(0, 2, 1, 3).copy()
    b = rng.normal(size=(n, 6)).astype(np.float32)
    fixed = np.array([True, False, False, True])
    out = tba.solve_gn_step(torch.from_numpy(A), torch.from_numpy(b),
                            torch.from_numpy(fixed), n, 1e-4).numpy()
    ref = np.asarray(jba.solve_gn_step(jnp.asarray(A), jnp.asarray(b), jnp.asarray(fixed),
                                       n, 1e-4))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out[fixed], 0.0)
