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
