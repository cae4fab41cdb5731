"""The port's rasterizer and texture bake against the JAX package's: the
z-buffer rasterizer against ``bundlesdf_tpu.native.rasterize``, the two UV
atlases, the vertex-color and texel bakes, the textured OBJ export, and the
cases of tests/test_texture.py on the port."""
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from port_native import require_native
from test_texture import _cube_mesh, _sphere_mesh
from bundlesdf_tpu.nof import texture as jtex
from bundlesdf_tpu_torch.io.png import read_png
from bundlesdf_tpu_torch.nof import texture as ttex
from bundlesdf_tpu_torch.ops.raster import rasterize
from bundlesdf_tpu_torch.utils.mesh import Mesh

torch.set_num_threads(2)

K120 = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)


def _raster(mesh, K, T, H, W):
    return [t.numpy() for t in rasterize(mesh.vertices, mesh.faces, K, T, H, W,
                                         device="cpu")]


def _pose(seed, z=1.2):
    rng = np.random.default_rng(seed)
    T = np.eye(4)
    T[:3, :3] = Rotation.random(random_state=seed).as_matrix()
    T[:3, 3] = [rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), z]
    return T


def _soup(seed, n=300):
    """Seeded random triangles in a 0.6 m box: overlaps, slivers, faces
    crossing the image border."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.3, 0.3, (n, 1, 3))
    v = (c + rng.normal(scale=0.06, size=(n, 3, 3))).reshape(-1, 3)
    return Mesh(v, np.arange(3 * n).reshape(n, 3))


@pytest.mark.parametrize("name,seed", [("sphere", 0), ("sphere", 1), ("cube", 2),
                                       ("soup", 3), ("soup", 4)])
def test_rasterizer_matches_native(name, seed):
    """Same coverage; face ids equal except at tie or edge pixels, where
    the two f32 evaluations may round an edge weight to the other side of
    0 (at most 0.5% of the covered pixels; measured 0 on these meshes);
    depth within 1e-5 relative (measured 2.7e-6: the native build contracts
    products into fused multiply-adds); perspective-correct barycentrics
    within 1e-3 where the face agrees (measured 2.6e-4, on slivers)."""
    mesh = {"sphere": lambda: _sphere_mesh(24, 0.3), "cube": lambda: _cube_mesh(0.3),
            "soup": lambda: _soup(seed)}[name]()
    T = _pose(seed)
    H, W = 120, 160
    native = require_native()
    d0, f0, b0 = native.rasterize(mesh.vertices, mesh.faces, K120, T, H, W)
    d1, f1, b1 = _raster(mesh, K120, T, H, W)
    assert d1.dtype == np.float32 and f1.dtype == np.int32 and b1.shape == (H, W, 3)
    cov0, cov1 = f0 >= 0, f1 >= 0
    assert cov0.sum() > 1000
    assert (cov0 != cov1).sum() <= 0.005 * cov0.sum()
    both = cov0 & cov1
    same = both & (f0 == f1)
    assert (~same[both]).sum() <= 0.005 * both.sum()
    np.testing.assert_allclose(d1[both], d0[both], rtol=1e-5, atol=0)
    np.testing.assert_allclose(b1[same], b0[same], rtol=0, atol=1e-3)
    assert np.all(d1[~cov1] == 0) and np.all(b1[~cov1] == 0)


def test_rasterizer_tie_and_near_rules():
    """A face repeated under three ids: the lowest id wins every pixel, as
    the native strict < test gives; a face with a vertex nearer than znear
    is dropped whole."""
    mesh = _cube_mesh(0.3)
    f = np.concatenate([mesh.faces[10:12], mesh.faces[10:12], mesh.faces[10:12]])
    dup = Mesh(mesh.vertices, f[[2, 0, 4, 3, 1, 5]])
    T = np.eye(4)
    T[2, 3] = 1.0
    # ids 0-2 repeat face 10, ids 3-5 face 11
    native = require_native()
    for fn in (native.rasterize, lambda *a: _raster(Mesh(a[0], a[1]), *a[2:])):
        _, fid, _ = fn(dup.vertices, dup.faces, K120, T, 120, 160)
        assert set(np.unique(fid[fid >= 0]).tolist()) == {0, 3}
    near = T.copy()
    near[2, 3] = 0.25  # the -z face's vertices sit at z = -0.05
    z = mesh.vertices[:, 2] + near[2, 3]
    culled = np.nonzero((z[mesh.faces] < 0.001).any(axis=1))[0]
    assert len(culled) == 10
    _, f0, _ = native.rasterize(mesh.vertices, mesh.faces, K120, near, 120, 160)
    _, f1, _ = _raster(mesh, K120, near, 120, 160)
    assert not np.isin(culled, f0).any() and not np.isin(culled, f1).any()
    # the two kept faces cover the same pixels but for their shared edge
    assert (f1 >= 0).sum() > 5000 and (f1 != f0).sum() <= 0.001 * f1.size


@pytest.mark.parametrize("n_faces,tex,cell", [(12, 256, 32), (5000, 512, 4)])
def test_triangle_atlas_equals_jax(n_faces, tex, cell):
    for a, b in zip(ttex._triangle_atlas(n_faces, tex, cell),
                    jtex._triangle_atlas(n_faces, tex, cell)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh_fn", [lambda: _cube_mesh(0.3), lambda: _sphere_mesh(12)],
                         ids=["cube", "sphere"])
def test_charted_atlas_equals_jax(mesh_fn):
    mesh = mesh_fn()
    for a, b in zip(ttex._charted_atlas(mesh.vertices, mesh.faces, mesh.face_normals, 256),
                    jtex._charted_atlas(mesh.vertices, mesh.faces, mesh.face_normals, 256)):
        np.testing.assert_array_equal(a, b)


# A generic tilt of the six views: axis-aligned views of the subdivided
# sphere put its vertices and edges on pixel centres, where the two
# rasterizers' f32 rounding (the native build contracts products into fused
# multiply-adds) opens cracks at different pixels.
TILT = Rotation.from_euler("xyz", [17, -23, 31], degrees=True).as_matrix()


def _six_views(mesh, H=128, W=128, f=128.0, dist=1.5, tilt=np.eye(3)):
    """Six views along the axes of ``tilt``, rendered with the port's
    rasterizer; each pixel colored by its 3D point (an affine map)."""
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    rgbs, depths, masks, cams = [], [], [], []
    for axis, sign in (((0, 0, 1), 1), ((0, 0, 1), -1), ((0, 1, 0), 1),
                       ((0, 1, 0), -1), ((1, 0, 0), 1), ((1, 0, 0), -1)):
        z = np.asarray(axis, np.float64) * sign
        up = np.array([0.0, 1.0, 0.0]) if abs(z[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
        xcam = np.cross(up, z)
        xcam /= np.linalg.norm(xcam)
        T = np.eye(4)
        T[:3, :3] = np.stack([xcam, np.cross(z, xcam), z]) @ tilt.T
        T[2, 3] = dist
        depth, fid, bar = _raster(mesh, K, T, H, W)
        mask = (depth > 0).astype(np.float32)
        tri = mesh.vertices[mesh.faces[np.maximum(fid, 0)]]
        pts = np.einsum("hwk,hwkc->hwc", bar, tri)
        rgb = np.clip(pts / 0.6 + 0.5, 0, 1).astype(np.float32) * mask[..., None]
        rgbs.append(rgb)
        depths.append(depth)
        masks.append(mask)
        cams.append(np.linalg.inv(T))
    return np.stack(rgbs), np.stack(depths), np.stack(masks), np.stack(cams), K


@pytest.mark.parametrize("atlas", ["charted", "triangle"])
def test_texture_bake_matches_jax(atlas):
    """The texel bake on a 768-face sphere from six tilted views: the same
    atlas and UVs; texels within 1 (uint8) but where a pixel on an edge
    between two faces is covered by another face in each rasterizer (their
    f32 rounding differs there): at most 0.1% of the baked texels
    (measured: 1 such pixel in 6 views, 2 of 23,726 charted and 6 of
    55,296 triangle-atlas texels)."""
    mesh = _sphere_mesh(8, 0.3)
    rgbs, depths, masks, cams, K = _six_views(mesh, tilt=TILT)
    require_native()  # the JAX bake's depth test rasterizes natively
    jm, jt = jtex.bake_texture_from_train_images(mesh, rgbs, depths, masks, cams, K,
                                                 tex_size=256, atlas=atlas)
    tm, tt = ttex.bake_texture_from_train_images(mesh, rgbs, depths, masks, cams, K,
                                                 tex_size=256, atlas=atlas, device="cpu")
    assert tm.atlas == atlas
    np.testing.assert_array_equal(tm.face_uv, jm.face_uv)
    assert tt.shape == jt.shape and tt.dtype == np.uint8
    baked = (jt != 128).any(-1)
    off = np.abs(tt.astype(int) - jt).max(-1) > 1
    assert off.sum() <= 1e-3 * baked.sum(), (off.sum(), baked.sum())
    assert baked.mean() > 0.2


def test_vertex_colors_match_jax():
    """Vertex colors from six tilted views, in f64 on both sides: within 1."""
    mesh = _sphere_mesh(10, 0.3)
    rgbs, depths, masks, cams, K = _six_views(mesh, tilt=TILT)
    want = jtex.bake_vertex_colors(mesh, None, rgbs, depths, masks, cams, K).vertex_colors
    got = ttex.bake_vertex_colors(mesh, None, rgbs, depths, masks, cams, K,
                                  device="cpu").vertex_colors
    assert got.dtype == np.uint8 and np.abs(got.astype(int) - want).max() <= 1
    assert (got != 127).any(axis=1).mean() > 0.9


def test_vertex_colors_from_field_match_jax():
    import jax

    from synthetic import make_sphere_dataset
    from test_nof import tiny_cfg
    from bundlesdf_tpu.nof.runner import NofRunner as JRunner
    from bundlesdf_tpu_torch.config import Cfg
    from bundlesdf_tpu_torch.models import nof as tnof
    from bundlesdf_tpu_torch.nof.runner import NofRunner as TRunner

    data = make_sphere_dataset(n_views=2, H=16, W=16)
    cfg = tiny_cfg()
    cfg.update(N_rand=64, frame_features=2)
    args = (data["images"], data["depths"], data["masks"], data["poses"], data["K"],
            data["cloud"])
    J = JRunner(cfg, *args)
    T = TRunner(Cfg.wrap(dict(cfg)), *args, device="cpu",
                params=tnof.params_from_jax(jax.tree_util.tree_map(np.asarray, J.params),
                                            device="cpu"))
    mesh = _sphere_mesh(10, 0.3)
    want = jtex.vertex_colors_from_field(mesh, J)
    got = ttex.vertex_colors_from_field(mesh, T)
    assert got.shape == (len(mesh.vertices), 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1


def test_export_textured_obj_round_trip(tmp_path):
    """The port writes the JAX package's OBJ and MTL text and the same PNG
    pixels; the files read back to the mesh, UVs and texture."""
    mesh = _cube_mesh(0.3)
    rgbs, depths, masks, cams, K = _six_views(mesh)
    out, tex = ttex.bake_texture_from_train_images(mesh, rgbs, depths, masks, cams, K,
                                                   tex_size=128, device="cpu")
    ttex.export_textured_obj(out, tex, str(tmp_path / "t.obj"))
    jtex.export_textured_obj(out, tex, str(tmp_path / "j.obj"))
    for ext in (".obj", ".mtl"):
        assert (tmp_path / f"t{ext}").read_text().replace("t.", "j.") == \
            (tmp_path / f"j{ext}").read_text()
    np.testing.assert_array_equal(read_png(str(tmp_path / "t.png")),
                                  read_png(str(tmp_path / "j.png")))
    back, tex2 = ttex.load_textured_obj(str(tmp_path / "t.obj"))
    np.testing.assert_allclose(back.vertices, out.vertices, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(back.faces, out.faces)
    np.testing.assert_allclose(back.face_uv, out.face_uv, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tex2, tex)


# ------------------------------------------- tests/test_texture.py on the port
def test_triangle_atlas_covers_all_faces():
    uv, face_of, bary_of = ttex._triangle_atlas(12, 256, 32)
    assert set(np.unique(face_of[face_of >= 0]).tolist()) == set(range(12))
    np.testing.assert_allclose(bary_of[face_of >= 0].sum(-1), 1.0, atol=1e-5)
    assert uv.shape == (12, 3, 2) and uv.min() >= 0 and uv.max() <= 1


def test_bake_texture_red_camera_view(tmp_path):
    """One camera on the +z face under uniform red light: its texels bake
    red, the unseen -z face keeps the 0.5 default (test_texture.py:38-93)."""
    mesh = _cube_mesh(0.3)
    H = W = 96
    K = np.array([[96.0, 0, 48], [0, 96.0, 48], [0, 0, 1]], np.float32)
    ob_in_cam = np.eye(4)
    ob_in_cam[0, 0] = ob_in_cam[2, 2] = -1.0
    ob_in_cam[2, 3] = 2.0
    rgb = np.zeros((H, W, 3), np.float32)
    rgb[..., 0] = 1.0
    depth, _, _ = _raster(mesh, K, ob_in_cam, H, W)
    mask = (depth > 0).astype(np.float32)
    out, tex = ttex.bake_texture_from_train_images(
        mesh, rgb[None], depth[None], mask[None], np.linalg.inv(ob_in_cam)[None], K,
        tex_size=256, device="cpu")
    assert out.face_uv.shape == (12, 3, 2)
    for fid, red in ((10, True), (11, True), (8, False), (9, False)):
        x, y = (out.face_uv[fid].mean(axis=0) * 256).astype(int)
        texel = tex[y, x]
        if red:
            assert texel[0] > 200 and texel[1] < 60, (fid, texel)
        else:
            assert abs(int(texel[0]) - 128) < 10, (fid, texel)
    ttex.export_textured_obj(out, tex, str(tmp_path / "m.obj"))
    txt = (tmp_path / "m.obj").read_text()
    assert "vt " in txt and "mtllib" in txt
    assert (tmp_path / "m.mtl").exists() and (tmp_path / "m.png").exists()


def test_triangle_atlas_auto_grows_for_dense_mesh():
    """The bake grows the atlas when 2 faces a 4 x 4 cell do not fit
    (test_texture.py:96-115): every face owns a texel."""
    F = 218076
    cell = 4
    need_cols = int(np.ceil(np.sqrt(np.ceil(F / 2))))
    uv, face_of, bary_of = ttex._triangle_atlas(F, cell * need_cols, cell)
    assert uv.shape == (F, 3, 2) and uv.min() >= 0 and uv.max() <= 1
    assert len(np.unique(face_of)) == F + 1
    np.testing.assert_allclose(bary_of[face_of >= 0].sum(-1), 1.0, atol=1e-5)


def test_charted_atlas_cube_coverage_and_roundtrip():
    mesh = _cube_mesh(0.3)
    uv, face_of, bary_of = ttex._charted_atlas(mesh.vertices, mesh.faces,
                                               mesh.face_normals, 256)
    assert uv.shape == (12, 3, 2) and uv.min() >= 0 and uv.max() <= 1
    m = face_of >= 0
    assert set(np.unique(face_of[m]).tolist()) == set(range(12))
    ys, xs = np.nonzero(m)
    w = bary_of[ys, xs]
    uv_pt = np.einsum("mk,mkc->mc", w, uv[face_of[ys, xs]]) * 256
    err = np.abs(uv_pt - np.stack([xs + 0.0, ys + 0.0], -1))
    interior = w.min(-1) > 0.05
    assert interior.sum() > 100 and err[interior].max() < 1.5


def test_bake_texture_charted_reproduces_a_color_field():
    """The charted bake reproduces the xyz-keyed color field at the face
    centroids within 0.15 (test_texture.py:217-260)."""
    mesh = _cube_mesh(0.3)
    rgbs, depths, masks, cams, K = _six_views(mesh)
    out, tex = ttex.bake_texture_from_train_images(mesh, rgbs, depths, masks, cams, K,
                                                   tex_size=256, atlas="charted",
                                                   device="cpu")
    assert out.atlas == "charted"
    want = np.clip(mesh.vertices[mesh.faces].mean(1) / 0.6 + 0.5, 0, 1)
    uvm = out.face_uv.mean(1)
    got = tex[(uvm[:, 1] * 256).astype(int), (uvm[:, 0] * 256).astype(int)]
    assert np.abs(got / 255.0 - want).max() < 0.15


def test_charted_atlas_folded_face_split_no_uv_overlap():
    """A face wound against its neighbours is split out of the chart: every
    UV triangle has positive signed area (test_texture.py:263-291)."""
    V = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0],
                  [0.0, 1.0, 0.0], [-1.0, 0.5, 0.0], [-0.5, -0.8, 0.0]])
    F = np.array([[0, 1, 2], [0, 2, 3], [3, 4, 0], [0, 5, 4]])
    n = Mesh(V, F).face_normals
    assert n[3, 2] < 0 and n[0, 2] > 0
    uv, face_of, _ = ttex._charted_atlas(V, F, n, 128)
    assert set(np.unique(face_of[face_of >= 0]).tolist()) == {0, 1, 2, 3}
    e1, e2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
    assert ((e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) > 0).all()


def test_bake_falls_back_to_the_triangle_atlas(caplog):
    """Charts the atlas cannot pack (6,912 faces into 16 x 16 texels) take
    the triangle atlas, grown to fit, and the fallback is logged, as in the
    JAX package; both give the same UVs and texels within 1."""
    mesh = _sphere_mesh(24, 0.3)
    rgbs, depths, masks, cams, K = _six_views(mesh, tilt=TILT)
    out, tex = ttex.bake_texture_from_train_images(mesh, rgbs[:1], depths[:1], masks[:1],
                                                   cams[:1], K, tex_size=16, device="cpu")
    assert out.atlas == "triangle" and "falling back" in caplog.text
    assert tex.shape[0] > 16
    require_native()
    jm, jt = jtex.bake_texture_from_train_images(mesh, rgbs[:1], depths[:1], masks[:1],
                                                 cams[:1], K, tex_size=16)
    np.testing.assert_array_equal(out.face_uv, jm.face_uv)
    assert tex.shape == jt.shape
    assert (np.abs(tex.astype(int) - jt).max(-1) > 1).mean() <= 1e-3
