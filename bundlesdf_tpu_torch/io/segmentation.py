"""First-frame / per-frame object segmentation provider (port of
``bundlesdf_tpu/io/segmentation.py:17-35``).

The reference ships a thin stub that reads precomputed mask PNGs (XMem is
excluded for license reasons, readme.md:67; segmentation_utils.py:13-18).
Same contract here: ``Segmenter.run(color_file, ...)`` returns the mask for
that frame from a sibling ``masks/`` directory (or ``mask_dir``), so any
external video segmenter can drop its outputs there.
"""
from __future__ import annotations

import os

import numpy as np

from .imgproc import resize_nearest
from .imread import imread_unchanged


class Segmenter:
    """Reads precomputed masks (reference segmentation_utils.Segmenter)."""

    def __init__(self, mask_dir: str | None = None):
        self.mask_dir = mask_dir

    def run(self, color_file: str, out_size=None):
        """The mask of ``color_file``'s frame, read as ``cv2.imread(path,
        -1)`` reads it (by its content, whatever its name): 0/255 uint8 for
        a file of several channels, the file's values for a gray one;
        resized to ``out_size`` (W, H) by nearest neighbour when given."""
        if self.mask_dir is not None:
            path = os.path.join(self.mask_dir, os.path.basename(color_file))
        else:
            path = color_file.replace("rgb", "masks")
        mask = imread_unchanged(path)
        if mask is None:
            raise FileNotFoundError(f"mask not found: {path}")
        if mask.ndim == 3:
            mask = (mask.sum(axis=-1) > 0).astype(np.uint8) * 255
        if out_size is not None:
            mask = resize_nearest(mask, *out_size)
        return mask
