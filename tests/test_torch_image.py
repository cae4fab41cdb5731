"""Depth pipeline and image helpers of the port (bundlesdf_tpu_torch.ops.image)
against the JAX package's ops/image.py on the same seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.ops import image as jimage
from bundlesdf_tpu.utils import geometry as jgeom
from bundlesdf_tpu_torch.ops import image as timage
from bundlesdf_tpu_torch.utils import geometry as tgeom

torch.set_num_threads(2)

K = np.array([[120.0, 0, 40.0], [0, 118.0, 31.0], [0, 0, 1]], np.float32)


def _depth(seed=0, H=64, W=80):
    """A sloped surface at ~0.5 m with a step, holes and a far patch."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    d = 0.45 + 0.001 * u + 0.0005 * v + rng.normal(0, 2e-4, (H, W))
    d[:, W // 2:] += 0.05                        # depth step
    d[rng.uniform(size=(H, W)) < 0.03] = 0.0     # holes
    d[5:12, 5:15] = 1.5                          # beyond zfar
    return d.astype(np.float32)


PARAMS = dict(zfar=1.0, erode_radius=1, erode_diff=0.001, erode_ratio=0.8,
              bilateral_radius=2, sigma_d=2.0, sigma_r=100000.0,
              edge_normal_thres_deg=10.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_process_depth_frame_np_bitwise(seed):
    d = _depth(seed)
    out = timage.process_depth_frame_np(d, K, **PARAMS)
    ref = jimage.process_depth_frame_np(d, K, **PARAMS)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_process_depth_frame_matches_jax(seed):
    """Torch pipeline vs the jitted JAX one: depth and xyz within 1e-5 (f32
    exp/division rounding), valid masks equal."""
    d = _depth(seed)
    out = timage.process_depth_frame(torch.from_numpy(d), torch.from_numpy(K), **PARAMS)
    ref = jimage.process_depth_frame(jnp.asarray(d), jnp.asarray(K), **PARAMS)
    dep, xyz, nrm, valid = (o.numpy() for o in out)
    np.testing.assert_array_equal(valid, np.asarray(ref[3]))
    assert valid.sum() > 1000
    np.testing.assert_allclose(dep, np.asarray(ref[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xyz, np.asarray(ref[1]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nrm, np.asarray(ref[2]), rtol=0, atol=1e-4)


def test_depth_stages_match_jax():
    d = np.where(_depth(2) < 1.0, _depth(2), 0.0).astype(np.float32)
    dt = torch.from_numpy(d)
    np.testing.assert_array_equal(timage.erode_depth(dt).numpy(),
                                  np.asarray(jimage.erode_depth(jnp.asarray(d))))
    np.testing.assert_allclose(timage.bilateral_filter_depth(dt).numpy(),
                               np.asarray(jimage.bilateral_filter_depth(jnp.asarray(d))),
                               rtol=0, atol=1e-6)
    xyz_t = tgeom.depth_to_xyz(dt, torch.from_numpy(K))
    xyz_j = jgeom.depth_to_xyz(jnp.asarray(d), jnp.asarray(K))
    np.testing.assert_array_equal(xyz_t.numpy(), np.asarray(xyz_j))
    n_t = tgeom.xyz_to_normals(xyz_t, dt > 0.1)
    n_j = jgeom.xyz_to_normals(xyz_j, jnp.asarray(d) > 0.1)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tgeom.depth_to_xyz_np(d, K), jgeom.depth_to_xyz_np(d, K))


def test_gray_and_downscale_match_jax():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    np.testing.assert_allclose(timage.rgb_to_gray(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jimage.rgb_to_gray(jnp.asarray(rgb))),
                               rtol=1e-7, atol=1e-5)
    img = rng.normal(size=(24, 32)).astype(np.float32)
    img3 = rng.normal(size=(24, 32, 3)).astype(np.float32)
    for x in (img, img3):
        for f in (1, 2, 4):
            out = timage.downscale_image(torch.from_numpy(x), f).numpy()
            ref = np.asarray(jimage.downscale_image(jnp.asarray(x), f))
            assert out.shape == ref.shape
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    for f in (1, 3):
        np.testing.assert_array_equal(
            timage.downscale_depth_nearest(torch.from_numpy(img), f).numpy(),
            np.asarray(jimage.downscale_depth_nearest(jnp.asarray(img), f)))
