"""SE(3) exponential maps of the PyTorch port against the JAX package, at
ordinary angles and inside the small-angle Taylor branch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.utils import se3 as jse3
from bundlesdf_tpu_torch.utils import se3 as tse3

torch.set_num_threads(2)


def _tangents(scale, seed=0):
    rng = np.random.default_rng(seed)
    xi = (rng.normal(size=(64, 6)) * scale).astype(np.float32)
    xi[0] = 0.0  # identity
    return xi


# At |w| ~ 1e-2 the JAX formulas (1 - cos t)/t^2 and (t - sin t)/t^3 cancel
# in f32: one ulp of cos near 1 (6e-8) over t^2 ~ 1e-4 is a ~1e-3 relative
# error in the coefficient, ~1e-5 absolute on entries of size ~1e-2, and the
# two frameworks' cos/sin may differ by that ulp.  Elsewhere: 1e-6.
@pytest.mark.parametrize("scale,atol", [(1e-5, 1e-6), (1e-2, 2e-5), (0.7, 1e-6)])
def test_exp_maps_match_jax(scale, atol):
    xi = _tangents(scale)
    w = xi[:, 3:]
    x = torch.from_numpy(xi)
    np.testing.assert_allclose(tse3.hat(torch.from_numpy(w)).numpy(),
                               np.asarray(jse3.hat(jnp.asarray(w))), atol=0)
    for port, ref, arg in ((tse3.so3_exp, jse3.so3_exp, w),
                           (tse3._v_matrix, jse3._v_matrix, w),
                           (tse3.se3_exp, jse3.se3_exp, xi)):
        out = port(torch.from_numpy(arg)).numpy()
        np.testing.assert_allclose(out, np.asarray(ref(jnp.asarray(arg))),
                                   rtol=0, atol=atol)
    T = tse3.se3_exp(x)
    assert T.shape == (64, 4, 4)
    np.testing.assert_allclose(T[:, 3].numpy(), np.tile([0, 0, 0, 1.0], (64, 1)))


def test_pack_pose_broadcasts():
    R = torch.eye(3)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ref = np.asarray(jse3.pack_pose(jnp.eye(3), jnp.asarray(t.numpy())))
    np.testing.assert_array_equal(tse3.pack_pose(R, t).numpy(), ref)


def test_exp_gradient_finite_at_identity():
    xi = torch.zeros((3, 6), requires_grad=True)
    tse3.se3_exp(xi).sum().backward()
    assert torch.isfinite(xi.grad).all()


def _rotations(n=32, seed=1, scale=1.0):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    R = Rotation.from_rotvec(rng.normal(size=(n, 3)) * scale).as_matrix()
    return R.astype(np.float32)


def test_log_maps_and_pose_helpers_match_jax():
    """so3/se3 logs, inverse, transform and the geodesic distances (also
    near pi and at the identity); 1e-5 absolute."""
    R = _rotations()
    R[0] = np.eye(3, dtype=np.float32)
    R[1] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)  # angle pi
    rng = np.random.default_rng(2)
    T = np.tile(np.eye(4, dtype=np.float32), (len(R), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(len(R), 3)) * 0.1
    pts = rng.normal(size=(len(R), 7, 3)).astype(np.float32)
    pairs = [(tse3.so3_log, jse3.so3_log, (R,)),
             (tse3.rotation_to_quat, jse3.rotation_to_quat, (R,)),
             (tse3.se3_log, jse3.se3_log, (T[2:],)),
             (tse3.inv_pose, jse3.inv_pose, (T,)),
             (tse3.transform_points, jse3.transform_points, (T, pts)),
             (tse3.transform_points, jse3.transform_points, (T, pts[:, 0])),
             (tse3.rotation_geodesic_distance, jse3.rotation_geodesic_distance, (R, R[::-1])),
             (tse3.rotation_geodesic_distance_ignore_cam_z,
              jse3.rotation_geodesic_distance_ignore_cam_z, (R[2:], R[2:][::-1])),
             (tse3.normalize_rotation, jse3.normalize_rotation, (T * 1.001,))]
    for port, ref, args in pairs:
        out = port(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args)).numpy()
        exp = np.asarray(ref(*(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(out, exp, rtol=0, atol=1e-5, err_msg=port.__name__)


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_matches_jax(weighted):
    rng = np.random.default_rng(3)
    R = _rotations(4, seed=4, scale=0.3)
    src = rng.uniform(-0.1, 0.1, (4, 50, 3)).astype(np.float32)
    dst = np.einsum("pij,pnj->pni", R, src) + rng.normal(0, 0.05, (4, 1, 3))
    dst = (dst + rng.normal(0, 1e-3, dst.shape)).astype(np.float32)
    w = (rng.uniform(size=(4, 50)) > 0.3).astype(np.float32) if weighted else None
    out = tse3.kabsch(torch.from_numpy(src), torch.from_numpy(dst),
                      None if w is None else torch.from_numpy(w)).numpy()
    ref = np.asarray(jse3.kabsch(jnp.asarray(src), jnp.asarray(dst),
                                 None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_kabsch_zero_weights_is_finite():
    src = torch.rand((2, 10, 3))
    T = tse3.kabsch(src, src + 0.1, torch.zeros((2, 10)))
    assert torch.isfinite(T).all()
    np.testing.assert_allclose(torch.linalg.det(T[:, :3, :3]).numpy(), 1.0, atol=1e-5)


def test_numpy_rotation_distances_equal_jax():
    R = _rotations(8, seed=5).astype(np.float64)
    for a, b in zip(R, R[::-1]):
        assert tse3.rotation_geodesic_distance_np(a, b) == \
            jse3.rotation_geodesic_distance_np(a, b)
        assert tse3.rotation_geodesic_distance_ignore_cam_z_np(a, b) == \
            jse3.rotation_geodesic_distance_ignore_cam_z_np(a, b)
