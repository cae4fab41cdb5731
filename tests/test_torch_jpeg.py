"""The port's JPEG decoder (``io/jpeg.py``) against the JAX HO3D reader's
decoder, ``imageio.imread`` (libjpeg-turbo under PIL), on files that
libjpeg wrote through cv2 and PIL: baseline and progressive, 4:4:4, 4:2:2,
4:2:0, 4:4:0 and 4:1:1, restart intervals, gray, odd sizes, APPn and COM
segments, CMYK and RGB; and on files that ``tests/port_codecs.py`` wrote
from quantized coefficients, judged by PIL: sequential files of several
scans, interleaved or not, progressive scripts cut short (block
smoothing), YCCK.  Tolerance: bit equal (max abs difference 0).  Also:
``chip_smoke.py``'s encoder, baseline and progressive, read by PIL and by
the port, equal; the kinds that stay refused raise."""
import io
import os
import struct
import sys

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from bundlesdf_tpu_torch.io import jpeg as port_jpeg
from bundlesdf_tpu_torch.io.jpeg import decode_jpeg, read_jpeg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))
import chip_smoke  # noqa: E402
import port_codecs  # noqa: E402

torch.set_num_threads(2)

_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
# (h, v) of each component for port_codecs.encode_jpeg
_FACTORS = {"444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)],
            "420": [(2, 2), (1, 1), (1, 1)], "440": [(1, 2), (1, 1), (1, 1)],
            "mixed": [(2, 2), (1, 2), (2, 1)]}


def _image(H, W, seed=0, noise=25):
    """Smooth ramps under noise, so that every coefficient band is used."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    rgb = np.stack([(2 * xx + yy) % 256, (3 * yy) % 256, (xx * yy // 7) % 256], -1)
    return (rgb + rng.integers(-noise, noise + 1, rgb.shape)).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("quality,size", [(95, (64, 96)), (75, (37, 53)), (50, (121, 203))])
def test_decoder_matches_imageio(tmp_path, sampling, restart, quality, size):
    path = str(tmp_path / "a.jpg")
    assert cv2.imwrite(path, _image(*size)[..., ::-1],
                       [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        _SAMPLING[sampling], cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    ref = imageio.imread(path)
    out = read_jpeg(path)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.abs(out.astype(int) - ref).max() == 0


def test_decoder_gray_and_segments_match_imageio(tmp_path):
    """A one-component file, and one with COM and EXIF (APP1) segments."""
    path = str(tmp_path / "g.jpg")
    cv2.imwrite(path, _image(50, 77)[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 85])
    assert np.array_equal(read_jpeg(path), imageio.imread(path))
    buf = io.BytesIO()
    exif = Image.Exif()
    exif[0x010E] = "a description"
    Image.fromarray(_image(40, 61, 1)).save(buf, "JPEG", quality=80, comment=b"note",
                                            exif=exif, subsampling=2)
    assert np.array_equal(decode_jpeg(buf.getvalue()),
                          np.asarray(Image.open(io.BytesIO(buf.getvalue()))))


def test_chip_smoke_encoder_read_by_pil_and_port():
    rgb = _image(48, 80, 2, noise=3)
    data = chip_smoke.jpeg_encode(rgb, quality=90)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    out = decode_jpeg(data)
    assert np.array_equal(out, pil)
    mse = np.mean((out.astype(float) - rgb) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) > 25  # within JPEG loss of its input


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _assert_equal(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.abs(out.astype(int) - ref).max() == 0


@pytest.mark.parametrize("writer,sampling", [
    ("cv2", "444"), ("cv2", "422"), ("cv2", "420"), ("cv2", "440"),
    ("pil", "444"), ("pil", "422"), ("pil", "420")])
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("size", [(37, 53), (121, 203), (9, 2)])
def test_progressive_matches_imageio(tmp_path, writer, sampling, restart, size):
    """libjpeg's default progressive script (10 scans for colour), written
    by cv2 and by PIL (PIL has no 4:4:0)."""
    path = str(tmp_path / "p.jpg")
    img = _image(*size, seed=restart)
    if writer == "cv2":
        assert cv2.imwrite(path, img[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[sampling],
            cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    else:
        Image.fromarray(img).save(path, "JPEG", quality=80, progressive=True,
                                  subsampling=f"{sampling[0]}:{sampling[1]}:{sampling[2]}",
                                  restart_marker_blocks=restart)
    with open(path, "rb") as f:
        data = f.read()
    assert data[data.index(b"\xff\xc2") + 1] == 0xC2 and data.count(b"\xff\xda") >= 6
    _assert_equal(read_jpeg(path), imageio.imread(path))


def test_progressive_gray_matches_imageio(tmp_path):
    path = str(tmp_path / "g.jpg")
    Image.fromarray(_image(50, 61, 3)[..., 1]).save(path, "JPEG", progressive=True,
                                                    quality=70)
    _assert_equal(read_jpeg(path), imageio.imread(path))


# Scan scripts of sequential files (components, Ss, Se, Ah, Al): one scan a
# component, and the chroma interleaved before the luma.
_SEQUENTIAL = {"per_component": [((0,), 0, 63, 0, 0), ((1,), 0, 63, 0, 0), ((2,), 0, 63, 0, 0)],
               "chroma_first": [((1, 2), 0, 63, 0, 0), ((0,), 0, 63, 0, 0)]}


@pytest.mark.parametrize("script", sorted(_SEQUENTIAL))
@pytest.mark.parametrize("sampling", ["444", "420", "440", "mixed"])
@pytest.mark.parametrize("restart,sof", [(0, 0xC0), (2, 0xC1)])
def test_multiscan_sequential_matches_pil(script, sampling, restart, sof):
    """Sequential files of several scans, non-interleaved ones over each
    component's own block grid (37 x 53 leaves it short of the MCU grid),
    new Huffman tables before each scan, restart intervals counted in
    MCUs or in blocks."""
    data = port_codecs.encode_jpeg(_image(37, 53, 4), _FACTORS[sampling], _SEQUENTIAL[script],
                                   restart=restart, sof=sof)
    assert data.count(b"\xff\xda") == len(_SEQUENTIAL[script])
    _assert_equal(decode_jpeg(data), _pil(data))


# Progressive scripts that leave some of the first 9 AC coefficients short
# of full precision or unsent, so that libjpeg smooths: the simple script
# without its last 4 scans, DC alone, DC at Al 2 refined once, and a
# script whose luma band 3..63 is never sent.
_SHORT = {
    "no_refinement": port_codecs.SIMPLE_PROGRESSION[:6],
    "dc_only": [((0, 1, 2), 0, 0, 0, 0)],
    "dc_refined": [((0, 1, 2), 0, 0, 0, 2), ((0,), 0, 0, 2, 1)],
    "bands": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 2, 0, 0), ((1,), 1, 9, 0, 3),
              ((2,), 3, 63, 0, 0), ((1,), 1, 9, 3, 2)],
}


@pytest.mark.parametrize("script", sorted(_SHORT))
@pytest.mark.parametrize("sampling", ["444", "420", "440", "mixed"])
@pytest.mark.parametrize("size,restart", [((37, 53), 0), ((71, 33), 1), ((9, 9), 0)])
def test_progressive_smoothing_matches_pil(script, sampling, size, restart):
    data = port_codecs.encode_jpeg(_image(*size, 5), _FACTORS[sampling], _SHORT[script],
                                   progressive=True, restart=restart)
    _assert_equal(decode_jpeg(data), _pil(data))


def test_progressive_smoothing_is_needed(monkeypatch):
    """The smoothing cases are about smoothing: without it the decode
    differs from PIL's, and a complete script is not smoothed."""
    img = _image(37, 53, 6)
    short = port_codecs.encode_jpeg(img, _FACTORS["420"], _SHORT["no_refinement"],
                                    progressive=True)
    full = port_codecs.encode_jpeg(img, _FACTORS["420"], port_codecs.SIMPLE_PROGRESSION,
                                   progressive=True)
    monkeypatch.setattr(port_jpeg, "_smooth", lambda blocks, hb, wb, *a: blocks[:hb, :wb])
    assert np.abs(decode_jpeg(short).astype(int) - _pil(short)).max() > 0
    _assert_equal(decode_jpeg(full), _pil(full))


@pytest.mark.parametrize("kind", ["cmyk", "cmyk_progressive", "ycck", "rgb", "rgb_adobe"])
def test_cmyk_ycck_and_rgb_match_pil(kind):
    """CMYK as PIL writes it (Adobe transform 0, inverted samples) and reads
    it (inverted back), YCCK (Adobe transform 2) from port_codecs, and RGB
    files: PIL's keep_rgb (ids 'R', 'G', 'B' and an Adobe marker) and
    port_codecs' (ids 'R', 'G', 'B' alone)."""
    rng = np.random.default_rng(7)
    img4 = np.concatenate([_image(41, 50, 7), rng.integers(0, 256, (41, 50, 1))], -1)
    img4 = img4.astype(np.uint8)
    buf = io.BytesIO()
    if kind.startswith("cmyk"):
        Image.fromarray(img4, "CMYK").save(buf, "JPEG", quality=90,
                                          progressive=kind.endswith("progressive"))
        data = buf.getvalue()
    elif kind == "ycck":
        data = port_codecs.encode_jpeg(img4, [(2, 2), (1, 1), (1, 1), (2, 2)], color="ycck")
    elif kind == "rgb":
        Image.fromarray(img4[..., :3]).save(buf, "JPEG", quality=90, keep_rgb=True)
        data = buf.getvalue()
    else:
        data = port_codecs.encode_jpeg(img4[..., :3], [(1, 1)] * 3, color="rgb")
    ref = _pil(data)
    _assert_equal(decode_jpeg(data), ref)
    assert ref.shape[-1] == (4 if kind[0] in "cy" else 3)


def test_chip_smoke_progressive_encoder_read_by_pil_and_port():
    """chip_smoke.jpeg_encode(progressive=True): the baseline file's
    coefficients as libjpeg's simple progression; PIL and the port decode
    it equal, and the port decodes it equal to the baseline file."""
    rgb = _image(48, 80, 2, noise=3)
    base = chip_smoke.jpeg_encode(rgb, quality=90)
    prog = chip_smoke.jpeg_encode(rgb, quality=90, progressive=True)
    assert prog.count(b"\xff\xda") == len(port_codecs.SIMPLE_PROGRESSION)
    out = decode_jpeg(prog)
    assert np.array_equal(out, np.asarray(Image.open(io.BytesIO(prog)).convert("RGB")))
    assert np.array_equal(out, decode_jpeg(base))


def _refused_by_pil(data: bytes, match: str) -> None:
    """The port raises NotImplementedError naming ``match``; PIL refuses
    the file too."""
    with pytest.raises(NotImplementedError, match=match):
        decode_jpeg(data)
    with pytest.raises(OSError):    # UnidentifiedImageError is one
        _pil(data)


def test_progressive_raises(tmp_path):
    """A progressive file decodes (it raised before), and so do lossless
    (SOF3) and arithmetic-coded (SOF9, SOF10) ones
    (test_lossless_matches_imageio_and_cv2,
    test_arithmetic_matches_imageio_and_cv2).  What stays refused raises
    naming the kind, and PIL refuses each too: 12-bit samples, DCT or
    lossless, and 16-bit lossless; hierarchical frames (libjpeg has no
    decoder for them); arithmetic lossless (SOF11; libjpeg-turbo has none);
    lossless YCbCr under a JFIF or Adobe marker (libjpeg-turbo will not
    convert it); 2 components; fractional sampling.  A lossless restart
    interval that is not whole MCU rows raises ValueError, and PIL
    refuses it."""
    path = str(tmp_path / "p.jpg")
    Image.fromarray(_image(32, 32)).save(path, "JPEG", progressive=True)
    _assert_equal(read_jpeg(path), imageio.imread(path))
    with open(path, "rb") as f:
        data = f.read()
    sof = data.index(b"\xff\xc2")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    _refused_by_pil(bytes(twelve), "12-bit")
    for marker, name in [(0xC5, "hierarchical"), (0xC6, "hierarchical"),
                         (0xC7, "hierarchical"), (0xCD, "hierarchical"),
                         (0xCE, "hierarchical"), (0xCF, "hierarchical")]:
        other = bytearray(data)
        other[sof + 1] = marker
        _refused_by_pil(bytes(other), name)
    dhp = data[:2] + b"\xff\xde" + struct.pack(">H", 8) + data[sof + 4:sof + 10] + data[2:]
    with pytest.raises(NotImplementedError, match="hierarchical"):
        decode_jpeg(dhp)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG....")
    img = _image(16, 24, 10)
    planes = [img[..., k] for k in range(3)]
    for precision in (12, 16):
        _refused_by_pil(port_codecs.write_lossless_jpeg(
            [img[..., 0].astype(np.int64) * 9], precision=precision),
            f"{precision}-bit lossless")
    sof11 = bytearray(port_codecs.write_lossless_jpeg(planes))
    sof11[sof11.index(b"\xff\xc3") + 1] = 0xCB
    _refused_by_pil(bytes(sof11), "arithmetic lossless \\(SOF11\\)")
    for app in (port_codecs._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
                port_codecs._segment(0xEE, b"Adobe\x00\x64" + bytes(4) + b"\x01")):
        _refused_by_pil(port_codecs.write_lossless_jpeg(planes, app=app), "lossless YCbCr")
    _refused_by_pil(port_codecs.write_lossless_jpeg(planes[:2]), "2 components")
    _refused_by_pil(port_codecs.encode_jpeg(img[..., :2], [(1, 1)] * 2, color="rgb"),
                    "2 components")
    _refused_by_pil(port_codecs.write_lossless_jpeg(
        [img[..., 0], img[:, :16, 1], img[:, :8, 2]], [(3, 1), (2, 1), (1, 1)]),
        "non-integral sampling")
    odd = bytearray(port_codecs.write_lossless_jpeg(planes, restart_rows=1))
    odd[odd.index(b"\xff\xdd") + 5] = 3         # 3 MCUs, rows of 24
    with pytest.raises(ValueError, match="whole number of MCU rows"):
        decode_jpeg(bytes(odd))
    with pytest.raises(OSError):
        _pil(bytes(odd))


def test_chip_smoke_codecs_phase_on_cpu(tmp_path):
    """chip_smoke.py's codecs phase at a small frame size on the CPU: the
    committed fixtures' digests, the progressive, arithmetic and lossless
    HO3D folders against the baseline one, no kernel launch."""
    video = chip_smoke.synth_video(chip_smoke.CLI_FRAMES, 40, 56, chip_smoke.TRACK_DEG,
                                   f=600.0 * 56 / 640)
    base = chip_smoke.write_ho3d_folder(video, range(chip_smoke.CLI_FRAMES),
                                        str(tmp_path / "HO3D_v3"))
    res = chip_smoke.phase_codecs(video, base, str(tmp_path / "HO3D_codecs"), "cpu")
    assert sorted(res["kinds"]) == sorted(chip_smoke.CODEC_FRAMES)
    for kind, r in res["kinds"].items():
        assert len(r["bit_equal"]) == chip_smoke.CODEC_FRAMES[kind], kind
        assert all(r["bit_equal"]) and all(r["ho3d_reader_equal"]), kind
    assert len(res["fixtures"]) == 17
    assert {r["read"] for r in res["fixtures"]} == {"read_jpeg", "read_png", "imread_unchanged"}
    assert not any(res["kernel_launches"].values())


@pytest.mark.parametrize("kind", ["baseline", *chip_smoke.CODEC_FRAMES])
def test_chip_smoke_ho3d_kinds_read_by_pil(kind):
    """chip_smoke.ho3d_jpeg's files, judged by PIL: each kind decodes equal
    to the baseline file (arithmetic and progressive ones carry the same
    coefficients, lossless ones the baseline decode), as the port decodes
    it; at 64 x 80 every file fits PIL's first read."""
    rgb = _image(64, 80, 2, noise=3)
    base = _pil(chip_smoke.ho3d_jpeg(rgb, 2, "baseline"))
    data = chip_smoke.ho3d_jpeg(rgb, 2, kind)
    _assert_equal(_pil(data), base)
    _assert_equal(decode_jpeg(data), base)


def test_codec_fixtures_match_jax_calls():
    """The committed fixtures' expected.json holds what the JAX readers'
    calls return (imageio for a colour JPEG; cv2.imread(-1), in RGB order
    for the PNGs read_png reads and in its own layout for the masks and
    depth imread_unchanged reads), so the card's digests carry the
    reference."""
    import hashlib
    import json

    folder = os.path.join(os.path.dirname(__file__), "data", "codecs")
    with open(os.path.join(folder, "expected.json")) as f:
        expected = json.load(f)
    assert len(expected) == 17
    assert set(chip_smoke.CODEC_CALLS) == {w["call"] for w in expected.values()}
    for name, want in expected.items():
        path = os.path.join(folder, name)
        if want["call"] == "imageio.imread":
            ref = imageio.imread(path)
        else:
            ref = cv2.imread(path, -1)
            if want["call"].endswith("RGB order") and ref.ndim == 3:
                ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
        digest = hashlib.sha256(np.ascontiguousarray(ref).tobytes()).hexdigest()
        assert [list(ref.shape), str(ref.dtype), digest] == [
            want["shape"], want["dtype"], want["sha256"]], name


# ------------------------------------------------ lossless and arithmetic ---

def _judges(tmp_path, data: bytes, gray: bool = False) -> np.ndarray:
    """What imageio.imread (PIL) reads from ``data``, held equal to
    cv2.imread(-1) in RGB order."""
    path = str(tmp_path / "j.jpg")
    with open(path, "wb") as f:
        f.write(data)
    ref = imageio.imread(path)
    other = cv2.imread(path, -1)
    _assert_equal(other if gray else other[..., ::-1], ref)
    return ref


# Lossless files (tests/port_codecs.py::write_lossless_jpeg): components'
# planes, sampling, scans (None: one interleaved scan), marker segments.
def _lossless_case(kind, img):
    if kind == "gray":
        return [img[..., 0]], None, None, b""
    if kind == "rgb":
        return [img[..., k] for k in range(3)], None, None, b""
    if kind == "420":
        return ([img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]],
                [(2, 2), (1, 1), (1, 1)], None, b"")
    # one scan of the luma, one of the chroma interleaved; Adobe transform 0
    return ([img[..., 0], img[:, ::2, 1], img[:, ::2, 2]], [(2, 1), (1, 1), (1, 1)],
            [(0,), (1, 2)], port_codecs._segment(0xEE, b"Adobe\x00\x64" + bytes(5)))


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("kind,al,restart_rows", [("gray", 0, 0), ("rgb", 2, 1),
                                                  ("420", 0, 2), ("scans", 2, 3)])
def test_lossless_matches_imageio_and_cv2(tmp_path, predictor, kind, al, restart_rows):
    """Lossless (SOF3, 8-bit) files decode bit-equal to imageio and cv2:
    predictors 1-7 with H.1.2.1's first line, first column and restarts
    (whole MCU rows, as libjpeg-turbo takes them), the point transform
    (samples shifted back, as libjpeg-turbo does), subsampling (replicated,
    not fancy), one scan or several; no colour transform."""
    img = _image(23, 37, predictor)
    planes, sampling, scans, app = _lossless_case(kind, img)
    data = port_codecs.write_lossless_jpeg(planes, sampling, predictor, al, restart_rows, app,
                                           scans=scans, size=(23, 37))
    ref = _judges(tmp_path, data, gray=kind == "gray")
    _assert_equal(decode_jpeg(data), ref)
    if kind == "rgb":
        _assert_equal(ref, (img >> al) << al)   # the samples, as stored


def test_lossless_wraps_and_cmyk_match_imageio(tmp_path):
    """Samples past 8 bits, reconstructed modulo 2^16 and truncated to 8
    bits as libjpeg-turbo does, with a difference of 32768 (category 16,
    no extra bits); 4 components read as PIL's inverted CMYK."""
    img = _image(19, 26, 9).astype(np.int64)
    x = img[..., 0].copy()
    x[0, 0] += 32768            # init 128: the first difference is 32768
    x[5:9, 3:20] += 40000
    x[11, ::3] = 65535
    for predictor in (1, 6, 7):
        data = port_codecs.write_lossless_jpeg([x], predictor=predictor)
        ref = _judges(tmp_path, data, gray=True)
        _assert_equal(decode_jpeg(data), ref)
        _assert_equal(ref, (x & 255).astype(np.uint8))
    cmyk = np.concatenate([img, img[..., :1] // 2], -1)
    data = port_codecs.write_lossless_jpeg([cmyk[..., k] for k in range(4)], predictor=2)
    ref = _pil(data)
    _assert_equal(decode_jpeg(data), ref)
    _assert_equal(ref, (255 - cmyk).astype(np.uint8))


# DAC conditioning: DC table 0 (L, U) = (2, 5), table 1 (0, 0); AC Kx 2, 40
_DAC = {(0, 0): (2, 5), (0, 1): (0, 0), (1, 0): 2, (1, 1): 40}
_ARITH = {"sequential": None, "simple": port_codecs.SIMPLE_PROGRESSION,
          "no_refinement": _SHORT["no_refinement"], "dc_refined": _SHORT["dc_refined"],
          "bands": _SHORT["bands"]}


@pytest.mark.parametrize("script", sorted(_ARITH))
@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("restart,dac", [(0, None), (3, _DAC)])
def test_arithmetic_matches_imageio_and_cv2(tmp_path, script, sampling, restart, dac):
    """Arithmetic-coded files (SOF9, SOF10; tests/port_codecs.py encodes
    as libjpeg's jcarith.c) decode bit-equal to imageio and cv2, and to the
    same coefficients Huffman-coded: the DC contexts under the default and
    a DAC's L and U, the AC bins split at Kx, statistics shared by the
    chroma's table and reset at each restart, progressive first and
    refinement scans (fixed-probability bits), block smoothing of scripts
    cut short."""
    img = _image(37, 53, 11)
    progressive = _ARITH[script] is not None
    kw = dict(sampling=_FACTORS[sampling], script=_ARITH[script], progressive=progressive,
              restart=restart)
    data = port_codecs.encode_jpeg(img, arithmetic=True, dac=dac, **kw)
    assert data[data.index(b"\xff\xd8\xff") + 2:].count(b"\xff\xcc") == (dac is not None)
    assert (b"\xff\xca" if progressive else b"\xff\xc9") in data
    out = decode_jpeg(data)
    _assert_equal(out, _judges(tmp_path, data))
    _assert_equal(out, decode_jpeg(port_codecs.encode_jpeg(img, **kw)))


def test_arithmetic_gray_matches_imageio(tmp_path):
    img = _image(29, 41, 12)[..., 1]
    for script in (None, [((0,), 0, 0, 0, 1), ((0,), 1, 9, 0, 1), ((0,), 10, 63, 0, 0),
                          ((0,), 0, 0, 1, 0), ((0,), 1, 9, 1, 0)]):
        data = port_codecs.encode_jpeg(img, [(1, 1)], script, progressive=script is not None,
                                       color="gray", arithmetic=True, restart=4)
        _assert_equal(decode_jpeg(data), _judges(tmp_path, data, gray=True))


def test_arithmetic_past_pil_buffer_matches_cv2(tmp_path):
    """PIL decodes an arithmetic-coded file only when it fits PIL's first
    read (ImageFile's 65,536 bytes): libjpeg's arithmetic decoder cannot
    wait for more input, so PIL raises.  cv2 reads the whole file and
    decodes it; the port equals cv2."""
    img = np.random.default_rng(13).integers(0, 256, (176, 224, 3)).astype(np.uint8)
    data = port_codecs.encode_jpeg(img, [(1, 1)] * 3, quality=95, arithmetic=True)
    assert len(data) > 65536
    with pytest.raises(OSError):
        _pil(data)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), -1)[..., ::-1]
    _assert_equal(decode_jpeg(data), ref)
    small = port_codecs.encode_jpeg(img[:48, :64], [(1, 1)] * 3, quality=95, arithmetic=True)
    _assert_equal(decode_jpeg(small), _pil(small))
