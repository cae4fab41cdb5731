"""Host-side pieces of the port's NOF half against the JAX package and the
libraries it uses: the cv2-free mask dilation against ``cv2.dilate``, the
scene bounds (DBSCAN through connected components, with border points
and noise at min_samples > 1) against sklearn,
meshing, and the geometry and occupancy helpers of the ray pool."""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN

from synthetic_cube import make_cube_sequence
from bundlesdf_tpu.io import scene_bounds as jsb
from bundlesdf_tpu.ops import occupancy as jocc
from bundlesdf_tpu.utils import geometry as jgeo
from bundlesdf_tpu.utils import mesh as jmesh
from bundlesdf_tpu_torch.io import scene_bounds as tsb
from bundlesdf_tpu_torch.nof.runner import dilate_mask_square
from bundlesdf_tpu_torch.ops import occupancy as tocc
from bundlesdf_tpu_torch.utils import geometry as tgeo
from bundlesdf_tpu_torch.utils import mesh as tmesh

torch.set_num_threads(2)


def _mask(seed, H=97, W=131):
    rng = np.random.default_rng(seed)
    m = (rng.uniform(size=(H, W)) > 0.995).astype(np.uint8)
    # lit pixels on every border and corner
    m[0, W // 3] = m[H - 1, W // 2] = m[H // 4, 0] = m[H // 2, W - 1] = 1
    m[0, 0] = m[H - 1, W - 1] = 1
    return m


@pytest.mark.parametrize("k", [100, 60, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_dilation_equals_cv2(k, seed):
    m = _mask(seed)
    ref = cv2.dilate(m, np.ones((k, k), np.uint8), iterations=1)
    out = dilate_mask_square(m, k)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_dilation_window_offsets():
    """One lit pixel spreads to [-49, +50] for k = 100 and [-2, +2] for 5."""
    m = np.zeros((301, 301), np.uint8)
    m[150, 150] = 1
    for k, lo, hi in ((100, -49, 50), (60, -29, 30), (5, -2, 2)):
        rows = np.flatnonzero(dilate_mask_square(m, k)[:, 150]) - 150
        cols = np.flatnonzero(dilate_mask_square(m, k)[150]) - 150
        assert (rows.min(), rows.max(), cols.min(), cols.max()) == (lo, hi, lo, hi)


def _clusters(seed, sizes, spread=0.012):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (len(sizes), 3)) * 2.0
    pts = np.concatenate([c + rng.normal(0, spread, (n, 3)) for c, n in zip(centers, sizes)])
    pts = np.concatenate([pts, rng.uniform(-3, 3, (15, 3))])  # isolated points
    return pts[rng.permutation(len(pts))]


@pytest.mark.parametrize("seed,sizes", [(0, [300, 120, 40]), (1, [80, 80, 30]),
                                        (2, [50, 200, 200, 10])])
def test_cluster_labels_equal_dbscan(seed, sizes):
    """Labels equal sklearn's DBSCAN at min_samples 1 (the same numbering),
    and the kept set equals the JAX function's, with ties of size."""
    pts = _clusters(seed, sizes)
    ref = DBSCAN(eps=0.06, min_samples=1).fit(pts).labels_
    np.testing.assert_array_equal(tsb.cluster_labels(pts, 0.06), ref)
    kept_t, keep_t = tsb.find_biggest_cluster(pts, 0.06, 1)
    kept_j, keep_j = jsb.find_biggest_cluster(pts, 0.06, 1)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_array_equal(kept_t, kept_j)
    assert keep_t.sum() == max(sizes)


def test_find_biggest_cluster_raises():
    for min_samples in (1, 3):
        with pytest.raises(ValueError, match="empty"):
            tsb.find_biggest_cluster(np.zeros((0, 3)), 0.06, min_samples)


def _sparse_clusters(seed, sizes, spread):
    """Gaussian blobs whose tails thin out into border points, a uniform
    scatter of noise, and one chain of points 0.05 apart joining two blobs
    (border points reachable from two clusters)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (len(sizes), 3))
    pts = [c + rng.normal(0, spread, (n, 3)) for c, n in zip(centers, sizes)]
    t = np.linspace(0, 1, 12)[:, None]
    pts.append(centers[0] + t * (centers[1] - centers[0]))
    pts.append(rng.uniform(-1.5, 1.5, (60, 3)))
    pts = np.concatenate(pts)
    return pts[rng.permutation(len(pts))]


@pytest.mark.parametrize("min_samples", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_dbscan_labels_equal_sklearn(min_samples, seed):
    """Labels equal sklearn's DBSCAN, noise (-1) and border points
    included, and the kept set equals the JAX function's."""
    pts = _sparse_clusters(seed, [150, 90, 40], 0.03)
    ref = DBSCAN(eps=0.06, min_samples=min_samples).fit(pts).labels_
    out = tsb.dbscan_labels(pts, 0.06, min_samples)
    np.testing.assert_array_equal(out, ref)
    assert (ref == -1).sum() > 0 and ref.max() >= 1
    core = np.zeros(len(pts), bool)
    core[DBSCAN(eps=0.06, min_samples=min_samples).fit(pts).core_sample_indices_] = True
    # border points (at min_samples 2 a point with a neighbour is a core point)
    assert ((ref >= 0) & ~core).any() == (min_samples > 2)
    kept_t, keep_t = tsb.find_biggest_cluster(pts, 0.06, min_samples)
    kept_j, keep_j = jsb.find_biggest_cluster(pts, 0.06, min_samples)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_array_equal(kept_t, kept_j)


def test_find_biggest_cluster_takes_the_noise_like_jax():
    """When the noise outnumbers every cluster, the JAX function (its
    np.unique vote counts the -1 label) keeps the noise; so does the port."""
    rng = np.random.default_rng(3)
    blob = rng.normal(0, 0.02, (40, 3))
    noise = rng.uniform(-3, 3, (200, 3))
    pts = np.concatenate([blob, noise])
    kept_j, keep_j = jsb.find_biggest_cluster(pts, 0.06, 4)
    kept_t, keep_t = tsb.find_biggest_cluster(pts, 0.06, 4)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_array_equal(kept_t, kept_j)
    assert keep_t.sum() > 150 and not keep_t[:40].any()


def test_compute_scene_bounds_equal_jax():
    data = make_cube_sequence(n_frames=3, deg_per_frame=6.0)
    rgbs = np.stack(data["colors"]).astype(np.float32) / 255.0
    depths = np.stack(data["depths"])
    masks = np.stack(data["masks"]).astype(np.float32)
    glc = np.stack([np.linalg.inv(T) for T in data["gt_ob_in_cam"]]) @ tgeo.GLCAM_IN_CVCAM
    ref = jsb.compute_scene_bounds(rgbs, depths, masks, data["K"], glc)
    out = tsb.compute_scene_bounds(rgbs, depths, masks, data["K"], glc)
    assert abs(out[0] - ref[0]) <= 1e-6 * ref[0]
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-6)
    assert len(out[2]) > 100
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_array_equal(out[3], ref[3])
    # the fixed-normalization branch and the per-frame fuse
    ref2 = jsb.compute_scene_bounds(rgbs, depths, masks, data["K"], glc,
                                    translation=ref[1], sc_factor=ref[0] * 1.5)
    out2 = tsb.compute_scene_bounds(rgbs, depths, masks, data["K"], glc,
                                    translation=ref[1], sc_factor=ref[0] * 1.5)
    np.testing.assert_array_equal(out2[2], ref2[2])
    pj, cj = jsb.fuse_frame_cloud(depths[1], rgbs[1], masks[1], data["K"], glc[1])
    pt, ct = tsb.fuse_frame_cloud(depths[1], rgbs[1], masks[1], data["K"], glc[1])
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ct, cj)


def _sphere_sdf(R=40, r=0.55):
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    sdf = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - r
    # a second, smaller blob: two components
    sdf = np.minimum(sdf, np.sqrt((X - 0.8) ** 2 + (Y - 0.8) ** 2 + (Z - 0.8) ** 2) - 0.12)
    return sdf.astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_marching_tetrahedra_and_largest_component_equal_jax(masked):
    sdf = _sphere_sdf()
    mask = (np.abs(sdf) < 0.3) if masked else None
    ref = jmesh.marching_tetrahedra(sdf, mask=mask)
    out = tmesh.marching_tetrahedra(sdf, mask=mask)
    assert len(ref.faces) > 1000
    np.testing.assert_array_equal(out.vertices, ref.vertices)
    np.testing.assert_array_equal(out.faces, ref.faces)
    lc_ref, lc_out = jmesh.largest_component(ref), tmesh.largest_component(out)
    assert len(lc_out.faces) < len(out.faces)
    np.testing.assert_array_equal(lc_out.vertices, lc_ref.vertices)
    np.testing.assert_array_equal(lc_out.faces, lc_ref.faces)
    np.testing.assert_array_equal(tmesh._CASE_TABLE, jmesh._CASE_TABLE)
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 0.3]
    np.testing.assert_array_equal(out.copy().apply_transform(T).vertices,
                                  ref.copy().apply_transform(T).vertices)
    assert len(tmesh.marching_tetrahedra(np.ones((4, 4, 4))).faces) == 0


def test_geometry_helpers_equal_jax():
    K = np.array([[120.0, 0, 47.5], [0, 110.0, 40.0], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(tgeo.camera_rays_gl_np(80, 96, K),
                                  jgeo.camera_rays_gl_np(80, 96, K))
    np.testing.assert_allclose(tgeo.camera_rays_gl(80, 96, torch.from_numpy(K)).numpy(),
                               np.asarray(jgeo.camera_rays_gl(80, 96, jnp.asarray(K))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tgeo.GLCAM_IN_CVCAM, np.asarray(jgeo.GLCAM_IN_CVCAM))
    rng = np.random.default_rng(3)
    o = rng.uniform(-2, 2, (200, 3))
    d = rng.normal(size=(200, 3))
    d[:5, 0] = 0.0
    lo, hi = -np.ones(3), np.ones(3)
    for a, b in zip(tgeo.ray_box_intersection_np(o, d, lo, hi),
                    jgeo.ray_box_intersection_np(o, d, lo, hi)):
        np.testing.assert_array_equal(a, b)


def test_query_occupancy_and_centers_equal_jax():
    rng = np.random.default_rng(4)
    grid = rng.uniform(size=(16, 16, 16)) > 0.7
    pts = rng.uniform(-1.2, 1.2, (2000, 3)).astype(np.float32)
    ref = np.asarray(jocc.query_occupancy(jnp.asarray(grid), jnp.asarray(pts)))
    out = tocc.query_occupancy(torch.from_numpy(grid), torch.from_numpy(pts))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0 < ref.sum() < len(pts)
    c_ref, _ = jocc.grid_occupied_centers(jnp.asarray(grid))
    c_out, g = tocc.grid_occupied_centers(torch.from_numpy(grid))
    np.testing.assert_allclose(c_out.numpy(), np.asarray(c_ref), rtol=0, atol=1e-7)
    assert g.shape == (16, 16, 16)
