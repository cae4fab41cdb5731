"""The port's dataset readers against the JAX package's on the same folders
(written here with cv2 and PIL): ``YcbineoatReader`` at full size and at
shorter sides that force non-integer scales, its prefetch thread against
plain reads, its colour getter on every PNG colour kind (16-bit colour
reads as its high byte, as imageio reads it) and on a folder of
Adam7-interlaced PNGs, ``read_png`` on palette, low-bit-depth, tRNS and
Adam7 files (``tests/port_codecs.py`` writes these) against cv2,
``resize_nearest`` and ``erode_square`` against cv2, ``Ho3dReader`` on a
synthetic HO3D folder (cv2 JPEGs at 4:4:4, 4:2:2 and 4:2:0, with and
without restart markers, and progressive, 4:4:0 and CMYK ones; packed
depth; pickled meta), and ``Segmenter``.

Tolerances: images, masks, intrinsics and ids equal; depth within 1e-6 m;
ground-truth poses within 1e-12 (cv2.Rodrigues against scipy, both f64)."""
import os
import pickle
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from bundlesdf_tpu.io import readers as jreaders
from bundlesdf_tpu.io.segmentation import Segmenter as JSegmenter
from bundlesdf_tpu.utils.mesh import Mesh as JMesh
from bundlesdf_tpu.utils.mesh import export_obj as jexport_obj
from bundlesdf_tpu_torch.io import readers as treaders
from bundlesdf_tpu_torch.io.imgproc import erode_square, resize_nearest
from bundlesdf_tpu_torch.io.imread import imread_unchanged
from bundlesdf_tpu_torch.io.png import read_png
from bundlesdf_tpu_torch.io.png import write_png
from bundlesdf_tpu_torch.io.segmentation import Segmenter

sys.path.insert(0, os.path.dirname(__file__))
import port_codecs  # noqa: E402

torch.set_num_threads(2)


def _write_ycb(root, H=60, W=80, n=4, seed=0):
    """A YCBInEOAT folder with cv2: RGB frames, mm depth, masks in four
    encodings (gray 0/255, RGB, palette, missing), hand masks (gray and a
    colour one whose channel sum wraps past 255), two GT poses."""
    rng = np.random.default_rng(seed)
    for sub in ("rgb", "depth", "masks", "masks_hand", "masks_hand_right",
                "annotated_poses"):
        os.makedirs(root / sub, exist_ok=True)
    K = np.array([[300.0, 0, W / 2], [0, 310.0, H / 2], [0, 0, 1]])
    np.savetxt(root / "cam_K.txt", K)
    for i in range(n):
        name = f"{i:07d}.png"
        rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        cv2.imwrite(str(root / "rgb" / name), rgb[..., ::-1])
        depth = rng.integers(0, 2000, (H, W)).astype(np.uint16)
        cv2.imwrite(str(root / "depth" / name), depth)
        m = (rng.random((H, W)) > 0.5).astype(np.uint8)
        if i == 0:
            cv2.imwrite(str(root / "masks" / name), m * 255)
        elif i == 1:
            cv2.imwrite(str(root / "masks" / name), np.stack([m * 0, m * 0, m * 7], -1))
        elif i == 2:
            im = Image.fromarray(m, "P")
            im.putpalette([0, 0, 0, 200, 10, 30] + [0] * 762)
            im.save(root / "masks" / name)
        cv2.imwrite(str(root / "masks_hand" / name), (rng.random((H, W)) > 0.9) * 255)
        hand = np.zeros((H, W, 3), np.uint8)
        hand[: H // 2] = (128, 128, 0)        # sums to 256: wraps to 0 in uint8
        hand[H // 2:, : W // 2] = (1, 0, 0)
        cv2.imwrite(str(root / "masks_hand_right" / name), hand)
        if i < 2:
            np.savetxt(root / "annotated_poses" / f"{i:07d}.txt", np.eye(4) * (i + 1))
    return root


@pytest.mark.parametrize("shorter_side", [None, 45, 61, 480])
def test_ycbineoat_reader_matches_jax(tmp_path, shorter_side):
    root = _write_ycb(tmp_path / "mustard0")
    ref = jreaders.YcbineoatReader(str(root), shorter_side=shorter_side, prefetch=False)
    port = treaders.YcbineoatReader(str(root), shorter_side=shorter_side, prefetch=False)
    assert (port.H, port.W) == (ref.H, ref.W)
    assert port.id_strs == ref.id_strs and len(port) == len(ref)
    np.testing.assert_array_equal(port.K, ref.K)
    assert port.get_video_name() == ref.get_video_name() == "mustard0"
    for i in range(len(ref)):
        c, rc = port.get_color(i), ref.get_color(i)
        assert c.dtype == rc.dtype and np.array_equal(c, rc), i
        m, rm = port.get_mask(i), ref.get_mask(i)
        assert m.dtype == rm.dtype and np.array_equal(m, rm), i
        o, ro = port.get_occ_mask(i), ref.get_occ_mask(i)
        assert o.dtype == ro.dtype and np.array_equal(o, ro), i
        d, rd = port.get_depth(i), ref.get_depth(i)
        assert d.dtype == rd.dtype == np.float32 and np.abs(d - rd).max() <= 1e-6
        gp, rp = port.get_gt_pose(i), ref.get_gt_pose(i)
        assert (gp is None) == (rp is None) and (gp is None or np.array_equal(gp, rp))


def test_prefetch_equals_plain_reads(tmp_path):
    root = _write_ycb(tmp_path / "v", n=12)
    plain = treaders.YcbineoatReader(str(root), shorter_side=45, prefetch=False)
    pre = treaders.YcbineoatReader(str(root), shorter_side=45)
    try:
        for i in [0, 1, 2, 2, 1, 5, 11, 3, 4]:
            for get in ("get_color", "get_depth", "get_mask"):
                np.testing.assert_array_equal(getattr(pre, get)(i), getattr(plain, get)(i))
        assert all(j > 4 for j in pre._futures)
    finally:
        pre.close()
    assert pre._pool is None


def _gray_png(path, vals, depth):
    """A gray PNG at bit depth 2 or 4 (PIL writes gray at 1 and 8 bits only)."""
    H, W = vals.shape
    per = 8 // depth
    pad = (-W) % per
    v = np.pad(vals, ((0, 0), (0, pad))).reshape(H, -1, per).astype(np.uint8)
    packed = np.zeros(v.shape[:2], np.uint8)
    for k in range(per):
        packed |= v[..., k] << (8 - depth * (k + 1))
    raw = np.concatenate([np.ones((H, 1), np.uint8), packed], 1)  # Sub filter
    raw[:, 2:] = (packed[:, 1:].astype(int) - packed[:, :-1]) % 256

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, 0,
                                                                   0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["P1", "P2", "P4", "P8", "P1t", "P2t", "P4t", "P8t",
                                  "L1", "L2", "L4"])
def test_read_png_palette_and_low_bit_depths_match_cv2(tmp_path, kind):
    rng = np.random.default_rng(len(kind) + int(kind[1]))
    H, W = 23, 37
    bits = int(kind[1])
    path = str(tmp_path / f"{kind}.png")
    if kind[0] == "P":
        n = 1 << bits
        im = Image.fromarray(rng.integers(0, n, (H, W)).astype(np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * n).tolist())
        kw = {"transparency": bytes(rng.integers(0, 256, n // 2 + 1).tolist())} \
            if kind.endswith("t") else {}
        im.save(path, bits=bits, **kw)
    elif bits == 1:
        Image.fromarray(rng.integers(0, 2, (H, W)).astype(bool)).save(path)
    else:
        _gray_png(path, rng.integers(0, 1 << bits, (H, W)), bits)
    with open(path, "rb") as f:
        assert f.read()[24] == bits  # the IHDR bit depth the case is about
    ref = cv2.imread(path, -1)
    if ref.ndim == 3:
        ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
    out = read_png(path)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)


def test_read_png_rejects_interlaced(tmp_path):
    """An Adam7 file (written by port_codecs: PIL and cv2 write none) reads
    as cv2 reads it; an interlace method other than 0 and 1 raises."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "i.png")
    port_codecs.write_adam7_png(path, rng.integers(0, 256, (9, 11, 3)), 8, 2)
    assert np.array_equal(read_png(path), cv2.imread(path, -1)[..., ::-1])
    with open(path, "rb") as f:
        data = bytearray(f.read())
    assert data[28] == 1  # IHDR's interlace byte
    data[28] = 2
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="interlace method 2"):
        read_png(path)


# (colour type, bit depth, tRNS) of every kind read_png reads
_KINDS = [(0, d, False) for d in (1, 2, 4, 8, 16)] + [(0, 8, True), (0, 16, True)] + [
    (2, 8, False), (2, 16, False), (2, 8, True), (4, 8, False), (4, 16, False),
    (6, 8, False), (6, 16, False)] + [(3, d, t) for d in (1, 2, 4, 8) for t in (False, True)]


@pytest.mark.parametrize("ctype,depth,trns", _KINDS)
@pytest.mark.parametrize("size", [(23, 37), (3, 2), (1, 1)])
def test_read_png_adam7_matches_cv2(tmp_path, ctype, depth, trns, size):
    """Adam7 over every colour type and bit depth, the passes' rows cycling
    through the five filters, 7 passes down to empty ones.  Against
    ``cv2.imread(-1)`` in RGB order, which expands gray + alpha to 4
    channels (B = G = R) and turns an RGB file's tRNS into alpha:
    ``read_png`` keeps the file's channels, so those two are compared on
    them."""
    rng = np.random.default_rng(depth * 10 + ctype)
    C = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    samples = rng.integers(0, 1 << depth, size + (C,))
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    t = None
    if trns:
        t = (bytes(rng.integers(0, 256, (1 << depth) // 2 + 1).tolist()) if ctype == 3
             else np.asarray(samples[0, 0], ">u2").tobytes())
    path = str(tmp_path / "a.png")
    port_codecs.write_adam7_png(path, samples, depth, ctype, palette, t)
    ref = cv2.imread(path, -1)
    if ref.ndim == 3:
        ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
    if ctype == 4:
        assert np.array_equal(ref[..., 0], ref[..., 2]) and np.array_equal(ref[..., 1], ref[..., 2])
        ref = ref[..., [0, 3]]
    if ctype == 2 and trns:
        ref = ref[..., :3]
    out = read_png(path)
    assert out.dtype == ref.dtype and out.shape == ref.shape and np.array_equal(out, ref)


def _color_png(path, kind, rng, H=8, W=10):
    """One colour frame of ``kind``: cv2 writes 8/16-bit gray, RGB and RGBA,
    PIL gray + alpha and palettes, io/png.py 16-bit gray + alpha (neither
    cv2 nor PIL writes it)."""
    if kind in ("gray8", "gray16", "rgb8", "rgb16", "rgba8", "rgba16"):
        C = {"gray": 1, "rgb": 3, "rgba": 4}[kind.rstrip("0123456789")]
        dtype = np.uint16 if kind.endswith("16") else np.uint8
        img = rng.integers(0, np.iinfo(dtype).max + 1, (H, W, C)).astype(dtype)
        assert cv2.imwrite(path, img[..., 0] if C == 1 else img)
    elif kind == "gray_alpha8":
        Image.fromarray(rng.integers(0, 256, (H, W, 2)).astype(np.uint8), "LA").save(path)
    elif kind == "gray_alpha16":
        write_png(path, rng.integers(0, 65536, (H, W, 2)).astype(np.uint16))
    else:
        im = Image.fromarray(rng.integers(0, 16, (H, W)).astype(np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 48).tolist())
        im.save(path, **({"transparency": 3} if kind == "palette_trns" else {}))


@pytest.mark.parametrize("kind", ["rgb16", "rgba16", "gray8", "gray16", "gray_alpha8",
                                  "gray_alpha16", "palette", "palette_trns", "rgb8", "rgba8"])
def test_ycbineoat_color_kinds_match_jax(tmp_path, kind):
    """The colour getter against the JAX plain getter (imageio, then
    cv2.resize) on each PNG colour kind.  16-bit RGB and RGBA read as their
    high byte (they read as uint16 before), 16-bit gray + alpha as its gray
    high byte thrice; 16-bit gray stays 16-bit, as imageio keeps it."""
    rng = np.random.default_rng(11)
    root = tmp_path / "v"
    os.makedirs(root / "rgb")
    np.savetxt(root / "cam_K.txt", np.eye(3))
    for i in range(2):
        _color_png(str(root / "rgb" / f"{i:07d}.png"), kind, rng)
    for side in (None, 5):
        ref = jreaders.YcbineoatReader(str(root), shorter_side=side, prefetch=False)
        port = treaders.YcbineoatReader(str(root), shorter_side=side, prefetch=False)
        for i in range(2):
            c, rc = port.get_color(i), ref.get_color(i)
            assert c.dtype == rc.dtype and c.shape == rc.shape and np.array_equal(c, rc), i


def test_ycbineoat_reader_adam7_matches_jax(tmp_path):
    """A YCBInEOAT folder of Adam7 PNGs only: RGB colour, 16-bit depth,
    palette (tRNS) and 1-bit gray masks, gray hand masks."""
    rng = np.random.default_rng(5)
    root = tmp_path / "mustard0"
    for sub in ("rgb", "depth", "masks", "masks_hand"):
        os.makedirs(root / sub)
    np.savetxt(root / "cam_K.txt", np.array([[300.0, 0, 20], [0, 310.0, 15], [0, 0, 1]]))
    H, W = 29, 43
    for i in range(3):
        name = f"{i:07d}.png"
        port_codecs.write_adam7_png(str(root / "rgb" / name), rng.integers(0, 256, (H, W, 3)),
                                    8, 2)
        port_codecs.write_adam7_png(str(root / "depth" / name),
                                    rng.integers(0, 2000, (H, W)), 16, 0)
        m = rng.integers(0, 2, (H, W))
        if i == 1:
            port_codecs.write_adam7_png(str(root / "masks" / name), m, 1, 0)
        else:
            port_codecs.write_adam7_png(str(root / "masks" / name), m * 3, 2, 3,
                                        rng.integers(0, 256, (4, 3)), bytes([0, 255]))
        port_codecs.write_adam7_png(str(root / "masks_hand" / name),
                                    (rng.random((H, W)) > 0.8) * 255, 8, 0)
    for side in (None, 20):
        ref = jreaders.YcbineoatReader(str(root), shorter_side=side, prefetch=False)
        port = treaders.YcbineoatReader(str(root), shorter_side=side, prefetch=False)
        assert (port.H, port.W) == (ref.H, ref.W)
        for i in range(3):
            for get in ("get_color", "get_mask", "get_occ_mask"):
                a, b = getattr(port, get)(i), getattr(ref, get)(i)
                assert a.dtype == b.dtype and np.array_equal(a, b), (get, i)
            d, rd = port.get_depth(i), ref.get_depth(i)
            assert d.dtype == rd.dtype and np.abs(d - rd).max() <= 1e-6


@pytest.mark.parametrize("src,dst", [((480, 640), (360, 480)), ((481, 640), (480, 639)),
                                     ((100, 100), (37, 211)), ((3, 5), (17, 2)),
                                     ((720, 1280), (480, 853))])
def test_resize_nearest_matches_cv2(src, dst):
    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 65535, src).astype(np.uint16),
                rng.integers(0, 256, src + (3,)).astype(np.uint8),
                rng.random(src)):
        ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(resize_nearest(img, dst[1], dst[0]), ref)


@pytest.mark.parametrize("shape", [(96, 96), (5, 7), (1, 3), (61, 80)])
def test_erode_square_matches_cv2(shape):
    rng = np.random.default_rng(1)
    m = (rng.random(shape) > 0.2).astype(np.uint8) * 255
    ref = cv2.erode(m, np.ones((5, 5), np.uint8))
    assert np.array_equal(erode_square(m, 5), ref)


_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _write_ho3d(root, sampling, restart, n=3, H=45, W=70, seed=0, progressive=False):
    """A synthetic HO3D_v3 folder of video SM1: cv2 JPEGs (baseline or
    progressive; ``sampling`` "cmyk": PIL CMYK JPEGs), packed depth,
    pickled meta (camMat, objTrans, objRot as Rodrigues vectors), XMem
    masks, the model OBJ.  Returns the video folder."""
    rng = np.random.default_rng(seed)
    vdir = root / "evaluation" / "SM1"
    for d in (vdir / "rgb", vdir / "depth", vdir / "meta", root / "masks_XMem" / "SM1",
              root / "masks_XMem" / "SM1_hand", root / "models" / "006_mustard_bottle"):
        os.makedirs(d, exist_ok=True)
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(n):
        rgb = np.stack([(3 * xx + 5 * i) % 256, (2 * yy) % 256, (xx * yy) % 256], -1)
        rgb = (rgb + rng.integers(-30, 30, rgb.shape)).clip(0, 255).astype(np.uint8)
        jpg = str(vdir / "rgb" / f"{i:04d}.jpg")
        if sampling == "cmyk":
            cmyk = np.concatenate([rgb, rgb[..., :1] // 2], -1)
            Image.fromarray(cmyk, "CMYK").save(jpg, quality=90, progressive=progressive)
        else:
            cv2.imwrite(jpg, rgb[..., ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         _SAMPLING[sampling], cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                         cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
        packed = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        cv2.imwrite(str(vdir / "depth" / f"{i:04d}.png"), packed)
        meta = {"camMat": np.array([[400.0, 0, 35], [0, 401.0, 22], [0, 0, 1]]),
                "objTrans": rng.normal(size=3) if i != 1 else None,
                "objRot": rng.normal(size=(3, 1))}
        with open(vdir / "meta" / f"{i:04d}.pkl", "wb") as f:
            pickle.dump(meta, f)
        cv2.imwrite(str(root / "masks_XMem" / "SM1" / f"{i:05d}.png"),
                    (rng.random((H, W)) > 0.5).astype(np.uint8) * 255)
        if i != 2:
            cv2.imwrite(str(root / "masks_XMem" / "SM1_hand" / f"{i:04d}.png"),
                        (rng.random((H, W)) > 0.8).astype(np.uint8) * 255)
    jexport_obj(JMesh(rng.normal(size=(8, 3)), rng.integers(0, 8, (6, 3))),
                str(root / "models" / "006_mustard_bottle" / "textured_simple.obj"))
    return vdir


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("restart", [0, 2])
def test_ho3d_reader_matches_jax(tmp_path, sampling, restart):
    vdir = _write_ho3d(tmp_path / "HO3D_v3", sampling, restart)
    ref = jreaders.Ho3dReader(str(vdir))
    port = treaders.Ho3dReader(str(vdir))
    assert (port.H, port.W) == (ref.H, ref.W) and port.id_strs == ref.id_strs
    np.testing.assert_array_equal(port.K, ref.K)
    assert port.ho3d_root == ref.ho3d_root
    assert port.get_video_name() == ref.get_video_name() == "SM1"
    for i in range(len(ref)):
        assert np.array_equal(port.get_color(i), ref.get_color(i)), i
        d, rd = port.get_depth(i), ref.get_depth(i)
        assert d.dtype == rd.dtype and np.abs(d - rd).max() <= 1e-6
        for get in ("get_mask", "get_occ_mask"):
            a, b = getattr(port, get)(i), getattr(ref, get)(i)
            assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
        p, rp = port.get_gt_pose(i), ref.get_gt_pose(i)
        assert (p is None) == (rp is None)
        if p is not None:
            assert np.abs(p - rp).max() <= 1e-12
    assert np.array_equal(port.get_gt_mesh().vertices, ref.get_gt_mesh().vertices)


@pytest.mark.parametrize("sampling,restart", [("420", 0), ("440", 2), ("444", 3),
                                              ("cmyk", 0)])
def test_ho3d_reader_progressive_matches_jax(tmp_path, sampling, restart):
    """The HO3D colour getter on progressive frames, on 4:4:0 and on CMYK
    ones (the JAX getter keeps imageio's first three, inverted, channels)."""
    vdir = _write_ho3d(tmp_path / "HO3D_v3", sampling, restart, n=2, progressive=True)
    ref = jreaders.Ho3dReader(str(vdir))
    port = treaders.Ho3dReader(str(vdir))
    assert (port.H, port.W) == (ref.H, ref.W)
    for i in range(len(ref)):
        c, rc = port.get_color(i), ref.get_color(i)
        assert c.dtype == rc.dtype and c.shape == rc.shape and np.array_equal(c, rc), i


def test_segmenter_matches_jax(tmp_path):
    root = _write_ycb(tmp_path / "v")
    for i, f in enumerate(sorted(os.listdir(root / "rgb"))[:3]):
        color = str(root / "rgb" / f)
        for size in (None, (53, 41)):
            assert np.array_equal(Segmenter().run(color, size), JSegmenter().run(color, size))
        a = Segmenter(str(root / "masks")).run(color)
        assert np.array_equal(a, JSegmenter(str(root / "masks")).run(color)), i
    with pytest.raises(FileNotFoundError):
        Segmenter().run(str(root / "rgb" / "0000003.png"))


# --------------------------------------------- cv2.imread(path, -1)'s layout ---

# (colour type, bit depth, tRNS) of every legal PNG kind: tRNS on gray, RGB
# and palette files, an alpha channel on gray + alpha and RGBA ones
_ALL_KINDS = ([(0, d, t) for d in (1, 2, 4, 8, 16) for t in (False, True)]
              + [(2, d, t) for d in (8, 16) for t in (False, True)]
              + [(3, d, t) for d in (1, 2, 4, 8) for t in (False, True)]
              + [(4, 8, False), (4, 16, False), (6, 8, False), (6, 16, False)])


@pytest.mark.parametrize("ctype,depth,trns", _ALL_KINDS)
@pytest.mark.parametrize("interlace", [False, True])
def test_imread_unchanged_matches_cv2_png(tmp_path, ctype, depth, trns, interlace):
    """``imread_unchanged`` against ``cv2.imread(p, -1)`` in dtype, shape
    and values on every PNG colour type x bit depth x tRNS x Adam7: gray
    (tRNS ignored, low depths scaled), BGR, BGRA from an RGB or palette
    file's tRNS (an RGB pixel equal to the tRNS colour transparent), gray +
    alpha as four channels, 16 bits kept."""
    rng = np.random.default_rng(depth * 10 + ctype + 100 * trns)
    C = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    samples = rng.integers(0, 1 << depth, (9, 11, C))
    samples[2:4, 3:6] = samples[0, 0]           # pixels that match a tRNS colour
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    t = None
    if trns:
        t = (bytes(rng.integers(0, 256, (1 << depth) // 2 + 1).tolist()) if ctype == 3
             else np.asarray(samples[0, 0], ">u2").tobytes())
    path = str(tmp_path / "a.png")
    port_codecs.write_adam7_png(path, samples, depth, ctype, palette, t, interlace=interlace)
    ref = cv2.imread(path, -1)
    out = imread_unchanged(path)
    assert out.dtype == ref.dtype and out.shape == ref.shape and np.array_equal(out, ref)


def _jpeg_kind(path, kind, rng):
    """A JPEG of ``kind``: gray, 4:2:0 colour with restarts, progressive,
    CMYK (PIL), EXIF orientation 6 (cv2.imread(-1) does not rotate), YCCK,
    lossless and arithmetic-coded (tests/port_codecs.py)."""
    img = rng.integers(0, 256, (21, 30, 3)).astype(np.uint8)
    if kind == "gray":
        cv2.imwrite(path, img[..., 0])
    elif kind == "ycc420":
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                                cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    elif kind == "progressive":
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    elif kind == "cmyk":
        cmyk = np.concatenate([img, img[..., :1] // 3], -1)
        Image.fromarray(cmyk, "CMYK").save(path, quality=90)
    elif kind == "exif_rotated":
        exif = Image.Exif()
        exif[0x0112] = 6
        Image.fromarray(img).save(path, exif=exif)
    elif kind == "ycck":
        data = port_codecs.encode_jpeg(np.concatenate([img, img[..., :1]], -1),
                                       [(2, 2), (1, 1), (1, 1), (2, 2)], color="ycck")
    else:
        data = (port_codecs.write_lossless_jpeg([img[..., k] for k in range(3)], predictor=4)
                if kind == "lossless" else
                port_codecs.encode_jpeg(img, [(2, 2), (1, 1), (1, 1)], arithmetic=True))
    if kind in ("ycck", "lossless", "arithmetic"):
        with open(path, "wb") as f:
            f.write(data)


@pytest.mark.parametrize("kind", ["gray", "ycc420", "progressive", "cmyk", "exif_rotated",
                                  "ycck", "lossless", "arithmetic"])
def test_imread_unchanged_matches_cv2_jpeg(tmp_path, kind):
    """JPEGs through ``imread_unchanged``, named .png as a mask may be: cv2
    picks the decoder by content and returns gray, BGR, or BGR converted
    from CMYK (and from YCCK, converted to CMYK by libjpeg)."""
    path = str(tmp_path / "m.png")
    _jpeg_kind(str(tmp_path / "m.jpg"), kind, np.random.default_rng(len(kind)))
    os.replace(tmp_path / "m.jpg", path)
    with open(path, "rb") as f:
        assert f.read(2) == b"\xff\xd8"
    ref = cv2.imread(path, -1)
    out = imread_unchanged(path)
    assert out.dtype == ref.dtype and out.shape == ref.shape and np.array_equal(out, ref)


def test_imread_unchanged_missing_and_unknown(tmp_path):
    """A missing file reads as None, as cv2's does; a file that is neither
    PNG nor JPEG raises naming what it found, where cv2 returns None."""
    assert imread_unchanged(str(tmp_path / "none.png")) is None
    assert cv2.imread(str(tmp_path / "none.png"), -1) is None
    path = tmp_path / "a.png"
    path.write_bytes(b"GIF89a....")
    assert cv2.imread(str(path), -1) is None
    with pytest.raises(ValueError, match="GIF89a"):
        imread_unchanged(str(path))


def _mask_file(path, kind, m, rng):
    """A mask (``m``: 0/1) in a file of ``kind``: gray + alpha whose channel
    sums wrap past 255 in uint8 as cv2's four channels and not as two;
    RGB with tRNS (black object pixels, tRNS-coloured background, a grid
    of (1, 0, 0) pixels); palette, with and without tRNS; a gray JPEG."""
    H, W = m.shape
    if kind == "gray_alpha":
        port_codecs.write_adam7_png(path, np.stack([m * 64, np.full((H, W), 64)], -1), 8, 4,
                                    interlace=False)
    elif kind == "rgb_trns":
        px = np.repeat(np.where(m, 0, 9)[..., None], 3, -1)
        px[::3, ::4] = (1, 0, 0)
        port_codecs.write_adam7_png(path, px, 8, 2, trns=bytes([0, 9] * 3), interlace=False)
    elif kind in ("palette", "palette_trns"):
        port_codecs.write_adam7_png(path, m, 8, 3, [[0, 0, 0], [200, 10, 30]],
                                    bytes([0, 128]) if kind == "palette_trns" else None,
                                    interlace=False)
    else:
        with open(path, "wb") as f:
            f.write(cv2.imencode(".jpg", (m * 255).astype(np.uint8))[1].tobytes())


def _depth_file(path, kind, rng, H, W):
    """Depth in a file of ``kind``: 16-bit gray + alpha, 16-bit RGB with
    tRNS, 8-bit palette with and without tRNS, a colour JPEG."""
    if kind == "gray_alpha":
        port_codecs.write_adam7_png(path, rng.integers(0, 65536, (H, W, 2)), 16, 4,
                                    interlace=False)
    elif kind == "rgb_trns":
        px = rng.integers(0, 65536, (H, W, 3))
        px[:2, :3] = px[0, 0]
        port_codecs.write_adam7_png(path, px, 16, 2, trns=np.asarray(px[0, 0], ">u2").tobytes(),
                                    interlace=False)
    elif kind in ("palette", "palette_trns"):
        port_codecs.write_adam7_png(path, rng.integers(0, 16, (H, W)), 8, 3,
                                    rng.integers(0, 256, (16, 3)),
                                    bytes(range(0, 160, 20)) if kind == "palette_trns" else None,
                                    interlace=False)
    else:
        with open(path, "wb") as f:
            f.write(cv2.imencode(".jpg", rng.integers(0, 256, (H, W, 3)).astype(np.uint8))[1]
                    .tobytes())


_MASK_KINDS = ["gray_alpha", "rgb_trns", "palette", "palette_trns", "jpeg"]


@pytest.mark.parametrize("kind", _MASK_KINDS)
def test_ycbineoat_mask_and_depth_kinds_match_jax(tmp_path, kind):
    """The YCBInEOAT mask, hand-mask and depth getters against the JAX plain
    getters (cv2.imread(-1)) on masks and depth of ``kind``, full size and
    resized: gray + alpha hand masks sum 4 channels in uint8 (3 g + a), an
    RGB mask's tRNS makes its black pixels opaque, RGB depth comes back
    BGR, and JPEG bytes under a .png name decode by content."""
    rng = np.random.default_rng(len(kind))
    root = tmp_path / "mustard0"
    for sub in ("rgb", "depth", "masks", "masks_hand", "masks_hand_right"):
        os.makedirs(root / sub)
    np.savetxt(root / "cam_K.txt", np.array([[300.0, 0, 20], [0, 310.0, 15], [0, 0, 1]]))
    H, W = 24, 31
    for i in range(2):
        name = f"{i:07d}.png"
        cv2.imwrite(str(root / "rgb" / name), rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
        _depth_file(str(root / "depth" / name), kind, rng, H, W)
        for sub in ("masks", "masks_hand", "masks_hand_right"):
            _mask_file(str(root / sub / name), kind, rng.random((H, W)) > 0.5, rng)
    for side in (None, 17):
        ref = jreaders.YcbineoatReader(str(root), shorter_side=side, prefetch=False)
        port = treaders.YcbineoatReader(str(root), shorter_side=side, prefetch=False)
        for i in range(2):
            for get in ("get_mask", "get_occ_mask"):
                a, b = getattr(port, get)(i), getattr(ref, get)(i)
                assert a.dtype == b.dtype and np.array_equal(a, b), (get, i)
            d, rd = port.get_depth(i), ref.get_depth(i)
            assert d.dtype == rd.dtype and d.shape == rd.shape and np.abs(d - rd).max() <= 1e-6


@pytest.mark.parametrize("kind", _MASK_KINDS)
def test_ho3d_mask_and_depth_kinds_match_jax(tmp_path, kind):
    """The HO3D mask getters return the file as cv2.imread(-1) does (BGR,
    BGRA, four channels for gray + alpha), and the packed depth takes
    channels 2 and 1 of its BGR, on XMem masks and depth of ``kind``."""
    vdir = _write_ho3d(tmp_path / "HO3D_v3", "420", 0, n=2)
    root = tmp_path / "HO3D_v3"
    rng = np.random.default_rng(len(kind))
    for i in range(2):
        m = rng.random((45, 70)) > 0.5
        _mask_file(str(root / "masks_XMem" / "SM1" / f"{i:05d}.png"), kind, m, rng)
        _mask_file(str(root / "masks_XMem" / "SM1_hand" / f"{i:04d}.png"), kind, ~m, rng)
        _depth_file(str(vdir / "depth" / f"{i:04d}.png"), kind, rng, 45, 70)
    ref = jreaders.Ho3dReader(str(vdir))
    port = treaders.Ho3dReader(str(vdir))
    for i in range(2):
        for get in ("get_mask", "get_occ_mask"):
            a, b = getattr(port, get)(i), getattr(ref, get)(i)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), (get, i)
        d, rd = port.get_depth(i), ref.get_depth(i)
        assert d.dtype == rd.dtype and np.abs(d - rd).max() <= 1e-6


@pytest.mark.parametrize("kind", ["jpeg_gray", "jpeg_color", "palette", "gray_alpha"])
def test_segmenter_reads_masks_by_content(tmp_path, kind):
    """``Segmenter.run`` on an HO3D colour file takes ``masks/0000.jpg``, a
    .jpg name; cv2 reads it by its content, JPEG or PNG, as the port does."""
    rng = np.random.default_rng(len(kind))
    for sub in ("rgb", "masks"):
        os.makedirs(tmp_path / sub)
    color = str(tmp_path / "rgb" / "0000.jpg")
    cv2.imwrite(color, rng.integers(0, 256, (20, 28, 3)).astype(np.uint8))
    m = rng.random((20, 28)) > 0.5
    path = str(tmp_path / "masks" / "0000.jpg")
    if kind.startswith("jpeg"):
        img = (m * 255).astype(np.uint8)
        img = img if kind == "jpeg_gray" else np.stack([img, img // 2, 255 - img], -1)
        with open(path, "wb") as f:
            f.write(cv2.imencode(".jpg", img)[1].tobytes())
    else:
        _mask_file(path, kind, m, rng)
    for size in (None, (13, 9)):
        a, b = Segmenter().run(color, size), JSegmenter().run(color, size)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["arithmetic", "arithmetic_progressive", "lossless"])
def test_ho3d_reader_lossless_and_arithmetic_match_jax(tmp_path, kind):
    """The HO3D colour getter on arithmetic-coded (4:2:0, restarts;
    sequential and libjpeg's simple progression) and lossless (predictor 4)
    frames, against the JAX getter's imageio."""
    vdir = _write_ho3d(tmp_path / "HO3D_v3", "420", 0, n=2)
    rng = np.random.default_rng(len(kind))
    for i in range(2):
        rgb = rng.integers(0, 256, (45, 70, 3)).astype(np.uint8)
        if kind == "lossless":
            data = port_codecs.write_lossless_jpeg([rgb[..., k] for k in range(3)], predictor=4,
                                                   restart_rows=5)
        else:
            progressive = kind.endswith("progressive")
            data = port_codecs.encode_jpeg(
                rgb, [(2, 2), (1, 1), (1, 1)], port_codecs.SIMPLE_PROGRESSION if progressive
                else None, progressive, restart=3, arithmetic=True)
        with open(vdir / "rgb" / f"{i:04d}.jpg", "wb") as f:
            f.write(data)
    ref = jreaders.Ho3dReader(str(vdir))
    port = treaders.Ho3dReader(str(vdir))
    assert (port.H, port.W) == (ref.H, ref.W)
    for i in range(2):
        c, rc = port.get_color(i), ref.get_color(i)
        assert c.dtype == rc.dtype and c.shape == rc.shape and np.array_equal(c, rc), i
