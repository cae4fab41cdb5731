"""The port's counterparts of the JAX package's last public names that no
JAX code path calls, against the JAX functions on the same inputs:
``utils/profiler.py``'s ``enable``, ``utils/geometry.py``'s device
``compute_covisibility``, ``utils/se3.py``'s ``transform_dirs`` and
``to_homo``, and ``viz/renderer.py``'s ``rasterize_mesh``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.utils import geometry as jgeometry
from bundlesdf_tpu.utils import profiler as jprofiler
from bundlesdf_tpu.utils import se3 as jse3
from bundlesdf_tpu.viz import renderer as jrenderer
from bundlesdf_tpu_torch.utils import geometry as tgeometry
from bundlesdf_tpu_torch.utils import profiler as tprofiler
from bundlesdf_tpu_torch.utils import se3 as tse3
from bundlesdf_tpu_torch.utils.mesh import Mesh
from bundlesdf_tpu_torch.viz import renderer as trenderer
from port_native import require_native
from test_geometry import make_K

torch.set_num_threads(2)


@pytest.fixture
def profiler_state():
    yield
    tprofiler.enable(True)
    tprofiler.reset()
    jprofiler.enable(True)
    jprofiler.reset()


def test_profiler_enable_switches_recording(profiler_state):
    """While off, span and count record nothing (the span's body still
    runs); switched on again they record, as the JAX profiler does."""
    for mod in (tprofiler, jprofiler):
        mod.reset()
        mod.enable(False)
        ran = []
        with mod.span("off/span"):
            ran.append(1)
        mod.count("off/count", 3)
        assert ran == [1] and mod.stats() == {}
        mod.enable(True)
        with mod.span("on/span"):
            pass
        mod.count("on/count", 3)
    assert {k: v["count"] for k, v in tprofiler.stats().items()} == {
        k: v["count"] for k, v in jprofiler.stats().items()} == {"on/span": 1, "on/count": 3}


def _plane(K, tilt=0.0):
    H, W = 48, 64
    u = np.arange(W, dtype=np.float32)[None, :]
    depth = np.broadcast_to(1.0 + tilt * (u - 32) / 64, (H, W)).astype(np.float32)
    return depth


@pytest.mark.parametrize("case", ["same_pose", "opposite_view", "turned", "tilted"])
def test_compute_covisibility_matches_jax(case):
    """tests/test_geometry.py:52-70's plane and poses (and a turned pose
    and a tilted plane): the port's device covisibility on the port's
    points and normals equals JAX's."""
    K = make_K()
    depth = _plane(K, 0.6 if case == "tilted" else 0.0)
    pose_b = np.eye(4, dtype=np.float32)
    if case == "opposite_view":
        pose_b[:3, :3] = np.diag([1.0, -1.0, -1.0])
        pose_b[2, 3] = 2.0
    elif case == "turned":
        a = np.deg2rad(55.0)
        pose_b[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        pose_b[0, 3] = -0.8
    eye = np.eye(4, dtype=np.float32)
    xyz = jgeometry.depth_to_xyz(jnp.asarray(depth), jnp.asarray(K))
    normals = jgeometry.xyz_to_normals(xyz, jnp.asarray(depth > 0))
    valid = jnp.linalg.norm(normals, axis=-1) > 0.5
    ref = float(jgeometry.compute_covisibility(xyz, normals, valid, jnp.asarray(eye),
                                               jnp.asarray(pose_b), 70.0))
    txyz = tgeometry.depth_to_xyz(torch.from_numpy(depth.copy()), torch.from_numpy(K))
    tn = tgeometry.xyz_to_normals(txyz, torch.from_numpy(depth > 0))
    cov = tgeometry.compute_covisibility(txyz, tn, torch.linalg.norm(tn, dim=-1) > 0.5,
                                         torch.from_numpy(eye), torch.from_numpy(pose_b), 70.0)
    assert cov.dtype == torch.float32 and cov.ndim == 0
    assert float(cov) == pytest.approx(ref, abs=1e-6)
    if case == "same_pose":
        assert ref > 0.95
    if case == "opposite_view":
        assert ref < 0.05


@pytest.mark.parametrize("batch", [(), (2,)])
def test_transform_dirs_and_to_homo_match_jax(batch):
    rng = np.random.default_rng(0)
    T = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=batch + (6,)).astype(np.float32))))
    dirs = rng.normal(size=batch + (5, 3)).astype(np.float32)
    for d in (dirs, dirs[..., 0, :]):
        ref = np.asarray(jse3.transform_dirs(jnp.asarray(T), jnp.asarray(d)))
        out = tse3.transform_dirs(torch.from_numpy(T), torch.from_numpy(d.copy())).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    ref = np.asarray(jse3.to_homo(jnp.asarray(dirs)))
    np.testing.assert_array_equal(tse3.to_homo(torch.from_numpy(dirs)).numpy(), ref)


def test_rasterize_mesh_matches_jax():
    """rasterize_mesh with the JAX signature against JAX's, which calls the
    native rasterizer: equal face ids, depth (float64, 0 where empty)
    within test_torch_texture.py's 1e-5 relative (the native build fuses
    multiply-adds)."""
    require_native()
    verts = np.array([[-0.1, -0.1, 0.0], [0.1, -0.1, 0.0], [0.1, 0.1, 0.0], [-0.1, 0.1, 0.0],
                      [0.0, 0.0, -0.05]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [0, 1, 4], [1, 2, 4]], np.int32)
    K = make_K()
    ob_in_cam = np.eye(4, dtype=np.float32)
    ob_in_cam[2, 3] = 0.6
    depth_j, face_j = jrenderer.rasterize_mesh(Mesh(verts, faces), ob_in_cam, K, 48, 64)
    depth_t, face_t = trenderer.rasterize_mesh(Mesh(verts, faces), ob_in_cam, K, 48, 64,
                                               device="cpu")
    assert depth_t.dtype == np.float64 and face_t.dtype == np.int64
    assert (face_t >= 0).sum() > 100
    np.testing.assert_array_equal(face_t, face_j)
    np.testing.assert_allclose(depth_t, depth_j, rtol=1e-5, atol=0)
    assert np.all(depth_t[face_t < 0] == 0)
