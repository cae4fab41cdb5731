"""The port's baseline JPEG decoder (``io/jpeg.py``) against the JAX HO3D
reader's decoder, ``imageio.imread`` (libjpeg-turbo under PIL), on files
that libjpeg wrote through cv2 and PIL: 4:4:4, 4:2:2 and 4:2:0, restart
intervals, gray, odd sizes, APPn and COM segments.  Tolerance: bit equal
(max abs difference 0).  Also: ``chip_smoke.py``'s encoder read by PIL and
by the port, equal; progressive files raise."""
import io
import os
import sys

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from bundlesdf_tpu_torch.io.jpeg import decode_jpeg, read_jpeg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


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


def test_progressive_raises(tmp_path):
    path = str(tmp_path / "p.jpg")
    Image.fromarray(_image(32, 32)).save(path, "JPEG", progressive=True)
    with pytest.raises(NotImplementedError, match="progressive"):
        read_jpeg(path)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG....")
