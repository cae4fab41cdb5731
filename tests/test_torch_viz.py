"""The port's overlays and dashboard against the JAX package's
(``bundlesdf_tpu/viz``): the numpy line rasterizer against ``cv2.line``,
``draw_xyz_axis`` / ``draw_posed_3d_box``, ``render_mesh_splat`` (in torch
on the CPU here), ``Dashboard.update``'s PNG, and the committed caption
glyph table, regenerated with cv2.

Agreements: segments whose strokes stay inside the image are pixel for
pixel cv2's; where a stroke runs off the image, cv2 clips the segment
before walking it and the port does not, and the pixels that differ lie on
the edge of cv2's stroke at the image border (measured: 45 of 177,300
stroke pixels over the 900 random segments below, half of them free to
run off the image, 0.025%).  Overlays, splat renders
and dashboards are equal; so is a caption of digits, spaces and ``kf=``
(letters may be kerned by cv2's text engine, which the table's whole-pixel
advances do not reproduce)."""
import math
import os
import sys

import cv2
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from bundlesdf_tpu.utils.mesh import Mesh as JMesh
from bundlesdf_tpu.viz import draw as jdraw
from bundlesdf_tpu.viz import gui as jgui
from bundlesdf_tpu.viz import renderer as jrenderer
from bundlesdf_tpu_torch.io.png import read_png
from bundlesdf_tpu_torch.utils.mesh import Mesh
from bundlesdf_tpu_torch.viz import draw, glyphs, gui, renderer

torch.set_num_threads(2)


def render_glyph_table() -> dict:
    """The caption glyphs as cv2 draws them (``glyphs.TABLE``'s source):
    each character alone at FONT_HERSHEY_SIMPLEX, scale 0.6, thickness 1,
    origin on a whole pixel; its advance from the widths of one and two
    copies at scale 60 (1/100 pixel at 0.6), floored to whole pixels."""
    font = cv2.FONT_HERSHEY_SIMPLEX
    out = {}
    for ch in glyphs.CHARS:
        img = np.zeros((60, 80), np.uint8)
        cv2.putText(img, ch, (20, 40), font, 0.6, 255, 1)
        ys, xs = np.nonzero(img)
        if len(ys):
            y0, x0 = ys.min(), xs.min()
            cov = img[y0:ys.max() + 1, x0:xs.max() + 1]
        else:
            y0, x0, cov = 40, 20, np.zeros((0, 0), np.uint8)
        w2 = cv2.getTextSize(ch * 2, font, 60.0, 1)[0][0]
        w1 = cv2.getTextSize(ch, font, 60.0, 1)[0][0]
        out[ch] = (math.floor((w2 - w1) / 100), int(y0 - 40), int(x0 - 20), cov)
    return out


def test_glyph_table_matches_cv2():
    """The committed table equals cv2's glyphs, read back through the
    table's own encoding."""
    table = glyphs.decode_table()
    fresh = glyphs.decode_table(glyphs.encode_table(render_glyph_table()))
    for ch in glyphs.CHARS:
        assert table[ch][:3] == fresh[ch][:3], ch
        assert np.array_equal(table[ch][3], fresh[ch][3]), ch


@pytest.mark.parametrize("text", ["0000123  kf=12", "00005  kf=3", "1581  kf=0"])
def test_caption_matches_cv2(text):
    rng = np.random.default_rng(0)
    bg = rng.integers(0, 256, (40, 220, 3)).astype(np.uint8)
    ref = bg.copy()
    cv2.putText(ref, text, (8, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 1)
    assert np.array_equal(glyphs.draw_text(bg.copy(), text, (8, 20)), ref)


def _on_stroke_edge(ref, ys, xs):
    """Whether each pixel is a stroke pixel with a 4-neighbour off the
    stroke or off the image (or a non-stroke pixel next to the stroke)."""
    H, W = ref.shape
    pad = np.pad(ref > 0, 1, constant_values=False)
    y, x = ys + 1, xs + 1
    nb = [pad[y - 1, x], pad[y + 1, x], pad[y, x - 1], pad[y, x + 1]]
    inside = pad[y, x]
    border = (ys == 0) | (xs == 0) | (ys == H - 1) | (xs == W - 1)
    return np.where(inside, border | ~np.all(nb, axis=0), np.any(nb, axis=0))


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_line_rasterizer_matches_cv2(thickness):
    rng = np.random.default_rng(thickness)
    H, W = 120, 160
    m = thickness + 1
    n_px = n_diff = 0
    for i in range(300):
        inner = i % 2 == 0
        lo, hi = ([m, m], [W - m, H - m]) if inner else ([0, 0], [W, H])
        p0 = tuple(int(v) for v in rng.integers(lo, hi))
        p1 = tuple(int(v) for v in rng.integers(lo, hi))
        if i % 10 == 0:  # short segments, down to a point
            p1 = (int(np.clip(p0[0] + rng.integers(-3, 4), lo[0], hi[0] - 1)),
                  int(np.clip(p0[1] + rng.integers(-3, 4), lo[1], hi[1] - 1)))
        ref = np.zeros((H, W), np.uint8)
        cv2.line(ref, p0, p1, 255, thickness)
        out = np.zeros((H, W), np.uint8)
        ys, xs = draw.line_pixels(H, W, p0, p1, thickness)
        out[ys, xs] = 255
        diff = np.nonzero(out != ref)
        if inner:
            assert not len(diff[0]), (p0, p1)
        assert _on_stroke_edge(ref, *diff).all(), (p0, p1)
        n_px += int((ref > 0).sum())
        n_diff += len(diff[0])
    assert n_diff <= 0.005 * n_px, (n_diff, n_px)


def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
        T[:3, 3] = [rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), rng.uniform(0.4, 0.7)]
        out.append(T)
    return out


K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]])


def test_overlays_match_jax():
    """Poses whose overlays stay inside the image (see the module's note on
    clipping)."""
    rng = np.random.default_rng(3)
    color = rng.integers(0, 256, (240, 320, 3)).astype(np.uint8)
    K2 = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    bbox = np.array([[-0.04, -0.03, -0.05], [0.05, 0.04, 0.03]])
    for T in _poses(8):
        for scale in (0.05, 0.1):
            a = draw.draw_xyz_axis(color, T, K2, scale=scale)
            assert np.array_equal(a, jdraw.draw_xyz_axis(color, T, K2, scale=scale))
        assert np.array_equal(draw.draw_posed_3d_box(color, T, K2, bbox),
                              jdraw.draw_posed_3d_box(color, T, K2, bbox))
    # the JAX channel order: the x axis's (0, 0, 255) lands in channel 2
    T = np.eye(4)
    T[2, 3] = 0.5
    a = draw.draw_xyz_axis(np.zeros((120, 160, 3), np.uint8), T, K, scale=0.05)
    assert a[60, 100].tolist() == [0, 0, 255]


def _meshes(seed=0, colors=False):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(300, 3)) * 0.05
    f = rng.integers(0, 300, (500, 3))
    vc = rng.integers(0, 256, (300, 3)).astype(np.uint8) if colors else None
    return Mesh(v, f, vc), JMesh(v, f, vc)


@pytest.mark.parametrize("colors", [False, True])
def test_render_mesh_splat_matches_jax(colors):
    port_mesh, jax_mesh = _meshes(1, colors)
    for T in _poses(3, 5):
        c, d = renderer.render_mesh_splat(port_mesh, T, K, 120, 160, n_points=20000,
                                          device="cpu")
        rc, rd = jrenderer.render_mesh_splat(jax_mesh, T, K, 120, 160, n_points=20000)
        assert np.array_equal(c, rc) and np.array_equal(d, rd)


def test_render_mesh_splat_keeps_the_last_point_of_a_pixel():
    """Two visible points on one pixel at one depth: numpy's fancy
    assignment keeps the later one, and so does the port."""
    v = np.array([[0.0, 0.0, 0.0], [1e-5, 0.0, 0.0], [0.01, 0.0, 0.0]])
    vc = np.array([[10, 20, 30], [200, 100, 50], [1, 2, 3]], np.uint8)
    f = np.array([[0, 1, 2]])
    T = np.eye(4)
    T[2, 3] = 0.5
    c, d = renderer.render_mesh_splat(Mesh(v, f, vc), T, K, 120, 160, device="cpu")
    rc, rd = jrenderer.render_mesh_splat(JMesh(v, f, vc), T, K, 120, 160)
    assert np.array_equal(c, rc) and np.array_equal(d, rd)
    assert c[60, 80].tolist() == [200, 100, 50]


def test_dashboard_png_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    port_mesh, jax_mesh = _meshes(2)
    boards = (gui.Dashboard(str(tmp_path / "port"), device="cpu"),
              jgui.Dashboard(str(tmp_path / "jax")))
    T = _poses(1, 9)[0]
    for k in range(3):
        color = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
        if k == 2:
            color = color.astype(np.float32) / 255.0  # a float frame is scaled
        mask = (rng.random((120, 160)) > 0.3).astype(np.uint8)
        for board, mesh in zip(boards, (port_mesh, jax_mesh)):
            board.update(color, mask, T, K, f"{k:05d}", mesh=mesh if k else None,
                         n_keyframes=k + 3)
        a = read_png(str(tmp_path / "port" / "dashboard" / f"{k:05d}.png"))
        b = read_png(str(tmp_path / "jax" / "dashboard" / f"{k:05d}.png"))
        assert a.shape == (120, 480, 3) and np.array_equal(a, b), k
