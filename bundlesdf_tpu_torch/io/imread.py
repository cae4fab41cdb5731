"""``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` without OpenCV.

The JAX readers read masks, hand masks and depth with ``cv2.imread(path,
-1)`` (``bundlesdf_tpu/io/readers.py:99, 109, 119, 183, 189, 192``;
``bundlesdf_tpu/io/segmentation.py:28``), which picks the decoder by the
file's first bytes, whatever its name, and returns None for a missing file.
``imread_unchanged`` does the same with ``io/png.py`` and ``io/jpeg.py``.
A file that neither decodes raises, where cv2 returns None.
"""
from __future__ import annotations

import os

import numpy as np

from .jpeg import read_jpeg
from .png import _SIGNATURE, read_png_unchanged


def imread_unchanged(path: str):
    """The image in ``cv2.imread(path, -1)``'s layout: a PNG as
    ``read_png_unchanged`` reads it; a JPEG as (H, W) gray or BGR, a
    4-component one converted to BGR as OpenCV converts libjpeg's CMYK
    (B = K - (255 - Y) K / 256, with libjpeg's inverted samples); None for a
    missing file."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _SIGNATURE:
        return read_png_unchanged(path)
    if head[:2] == b"\xff\xd8":
        img = read_jpeg(path)
        if img.ndim == 2:
            return img
        if img.shape[2] == 3:
            return img[..., ::-1].copy()
        # read_jpeg inverts libjpeg's CMYK as PIL does: 255 - sample
        p = img.astype(np.int32)
        k = 255 - p[..., 3:]
        return (k - ((p[..., 2::-1] * k) >> 8)).astype(np.uint8)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file (first bytes {head!r})")
