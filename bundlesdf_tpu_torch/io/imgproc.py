"""numpy stand-ins for the OpenCV image calls of the JAX readers and scripts,
as ``io/png.py`` is for ``cv2.imwrite`` / ``cv2.imread``: the card's machine
has no OpenCV.

  * ``resize_nearest``: ``cv2.resize(img, (W, H), interpolation=
    cv2.INTER_NEAREST)`` (``bundlesdf_tpu/io/readers.py:94, 104, 110, 123``,
    ``io/segmentation.py:34``);
  * ``erode_square``: ``cv2.erode(mask, np.ones((k, k)))``, the first
    frame's 5 x 5 erosion of ``scripts/run_custom.py:67``.
    ``nof/runner.py::dilate_mask_square`` is the dilation counterpart.
"""
from __future__ import annotations

import numpy as np


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """OpenCV's nearest-neighbour source index along one axis (resizeNN):
    ``min(floor(x * ifx), src - 1)`` with ``ifx = 1 / (dst / src)`` in
    double precision."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """Nearest-neighbour resize of an (h, w) or (h, w, C) image to H x W."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img.copy()
    return img[_nearest_index(h, H)[:, None], _nearest_index(w, W)[None, :]]


def erode_square(mask: np.ndarray, k: int = 5) -> np.ndarray:
    """Erosion by a k x k square (k odd): each pixel takes the minimum of its
    window's pixels inside the image.  OpenCV's default border for erosion
    is +inf, so pixels outside the image never erode the edge."""
    mask = np.asarray(mask)
    r = k // 2
    if np.issubdtype(mask.dtype, np.integer):
        top = np.iinfo(mask.dtype).max
    else:
        top = np.inf
    out = mask
    for axis in (0, 1):
        pad = [(0, 0)] * mask.ndim
        pad[axis] = (r, r)
        p = np.pad(out, pad, constant_values=top)
        n = mask.shape[axis]
        out = np.min(np.stack([np.take(p, range(i, i + n), axis=axis)
                               for i in range(k)]), axis=0)
    return out.astype(mask.dtype)
