"""Spherical-harmonics encoding of the PyTorch port against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.ops import sh as jsh
from bundlesdf_tpu_torch.ops import sh as tsh

torch.set_num_threads(2)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode_matches_jax(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(7, 33, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(jsh.sh_encode(jnp.asarray(d), degree))
    out = tsh.sh_encode(torch.from_numpy(d), degree)
    assert out.shape == ref.shape == (7, 33, tsh.sh_out_dim(degree))
    assert tsh.sh_out_dim(degree) == jsh.sh_out_dim(degree)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_sh_degree_out_of_range():
    with pytest.raises(ValueError):
        tsh.sh_encode(torch.zeros((2, 3)), 5)
