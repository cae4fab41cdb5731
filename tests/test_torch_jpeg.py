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


def test_progressive_raises(tmp_path):
    """A progressive file decodes (it raised before); what stays refused
    raises naming the kind: 12-bit samples (PIL refuses them too) and
    hierarchical frames (libjpeg has no decoder for them), as do
    arithmetic-coded and lossless frames (neither cv2 nor PIL writes them)."""
    path = str(tmp_path / "p.jpg")
    Image.fromarray(_image(32, 32)).save(path, "JPEG", progressive=True)
    _assert_equal(read_jpeg(path), imageio.imread(path))
    with open(path, "rb") as f:
        data = f.read()
    sof = data.index(b"\xff\xc2")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    with pytest.raises(NotImplementedError, match="12-bit"):
        decode_jpeg(bytes(twelve))
    for marker, name in [(0xC5, "hierarchical"), (0xC6, "hierarchical"),
                         (0xC7, "hierarchical"), (0xC3, "lossless"), (0xC9, "arithmetic"),
                         (0xCA, "arithmetic")]:
        other = bytearray(data)
        other[sof + 1] = marker
        with pytest.raises(NotImplementedError, match=name):
            decode_jpeg(bytes(other))
    dhp = data[:2] + b"\xff\xde" + struct.pack(">H", 8) + data[sof + 4:sof + 10] + data[2:]
    with pytest.raises(NotImplementedError, match="hierarchical"):
        decode_jpeg(dhp)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG....")


def test_chip_smoke_codecs_phase_on_cpu(tmp_path):
    """chip_smoke.py's codecs phase at a small frame size on the CPU: the
    committed fixtures' digests, the progressive HO3D folder against the
    baseline one, no kernel launch."""
    video = chip_smoke.synth_video(chip_smoke.CLI_FRAMES, 40, 56, chip_smoke.TRACK_DEG,
                                   f=600.0 * 56 / 640)
    base = chip_smoke.write_ho3d_folder(video, range(chip_smoke.CLI_FRAMES),
                                        str(tmp_path / "HO3D_v3"))
    res = chip_smoke.phase_codecs(video, base, str(tmp_path / "HO3D_progressive"), "cpu")
    assert all(res["transcode"]["bit_equal"]) and len(res["transcode"]["bit_equal"]) == 6
    assert all(res["ho3d_reader_progressive_equal"])
    assert len(res["fixtures"]) == 8
    assert not any(res["kernel_launches"].values())


def test_codec_fixtures_match_jax_calls():
    """The committed fixtures' expected.json holds what the JAX readers'
    calls return (imageio for a JPEG, cv2.imread(-1) in RGB order for a
    PNG), so the card's digests carry the reference."""
    import hashlib
    import json

    folder = os.path.join(os.path.dirname(__file__), "data", "codecs")
    with open(os.path.join(folder, "expected.json")) as f:
        expected = json.load(f)
    assert len(expected) == 8
    for name, want in expected.items():
        path = os.path.join(folder, name)
        if name.endswith(".jpg"):
            ref = imageio.imread(path)
        else:
            ref = cv2.imread(path, -1)
            ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]] if ref.ndim == 3 else ref
        digest = hashlib.sha256(np.ascontiguousarray(ref).tobytes()).hexdigest()
        assert [list(ref.shape), str(ref.dtype), digest] == [
            want["shape"], want["dtype"], want["sha256"]], name
