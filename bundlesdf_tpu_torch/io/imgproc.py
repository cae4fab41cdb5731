"""Stand-ins for the OpenCV image calls of the JAX package, as ``io/png.py``
is for ``cv2.imwrite`` / ``cv2.imread``: the card's machine has no OpenCV.

  * ``resize_nearest``: ``cv2.resize(img, (W, H), interpolation=
    cv2.INTER_NEAREST)`` (``bundlesdf_tpu/io/readers.py:94, 104, 110, 123``,
    ``io/segmentation.py:34``);
  * ``erode_square``: ``cv2.erode(mask, np.ones((k, k)))``, the first
    frame's 5 x 5 erosion of ``scripts/run_custom.py:67``.
    ``nof/runner.py::dilate_mask_square`` is the dilation counterpart;
  * ``warp_perspective``: ``cv2.warpPerspective(img_f32, M, dsize)`` with
    ``INTER_LINEAR`` and ``BORDER_CONSTANT`` 0, the pair warp of the
    host-warp correspondence path (``bundlesdf_tpu/tracking/corres.py:
    103-104``), in torch on the image's device.

The first two are numpy.
"""
from __future__ import annotations

import numpy as np
import torch


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


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the f32
    product is exact in f64, so only the sum rounds (then to f32)."""
    return (a.double() * b + c.double()).float()


def warp_perspective(img: torch.Tensor, M: np.ndarray, dsize: tuple) -> torch.Tensor:
    """``cv2.warpPerspective(img, M, dsize)`` of an (H, W) f32 image with
    bilinear taps and a constant 0 border; ``dsize`` = (width, height).

    OpenCV 5's float path, reproduced to the bit on its vector blocks (not a
    continuous bilinear with f64 coordinates, which differs by up to 4e-3
    of a grey level on a noise image): M inverted in f64, then cast to f32;
    per row the terms ``y * M[k][1] + M[k][2]`` in f32, per pixel one fused
    ``x * M[k][0] + row`` for the numerator and w, ``sx = X / w`` in f32;
    ``ix = floor(sx)``, ``fx = sx - ix``, each tap outside the image reads
    0, and two fused lerps in x and one in y.  OpenCV computes the last
    ``width mod 16`` columns of a row with its scalar code, which fuses
    ``x * M[k][0] + y * M[k][1]`` before adding ``M[k][2]`` (within 3e-3
    there); the tracker's crops (resize 400) are a multiple of 16 wide."""
    Wo, Ho = int(dsize[0]), int(dsize[1])
    H, W = img.shape
    dev = img.device
    Mi = torch.from_numpy(np.linalg.inv(np.asarray(M, np.float64)).astype(np.float32)).to(dev)
    x = torch.arange(Wo, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(Ho, dtype=torch.float32, device=dev)[:, None]

    def lin(k):
        row = y * Mi[k, 1] + Mi[k, 2]                   # (Ho, 1), f32
        return _fma(x, Mi[k, 0].double(), row)          # (Ho, Wo)

    w = lin(2)
    sx = lin(0) / w
    sy = lin(1) / w
    # non-finite or far-out coordinates read only border taps: clamp them
    # where every tap stays outside
    sx = torch.nan_to_num(sx, nan=-2.0).clamp(-2.0, W + 1.0)
    sy = torch.nan_to_num(sy, nan=-2.0).clamp(-2.0, H + 1.0)
    fx0, fy0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - fx0, sy - fy0
    ix, iy = fx0.to(torch.int64), fy0.to(torch.int64)
    flat = img.to(torch.float32).reshape(-1)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = flat[(yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(-1)].reshape(yy.shape)
        return torch.where(ok, v, torch.zeros((), dtype=v.dtype, device=dev))

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = _fma(fx, (p01 - p00).double(), p00)
    v1 = _fma(fx, (p11 - p10).double(), p10)
    return _fma(fy, (v1 - v0).double(), v0)
