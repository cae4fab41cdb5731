"""A minimal PNG codec on the standard library's ``zlib`` and numpy.

It stands in for ``cv2.imwrite`` / ``cv2.imread`` where the JAX package
writes and reads its artifact trail (``pipeline/artifacts.py``) and the
texture of a textured OBJ (``nof/texture.py``): the port needs neither
OpenCV nor PIL.

  * ``write_png`` writes 8-bit or 16-bit gray, gray + alpha, RGB or RGBA,
    non-interlaced, 16-bit samples big-endian as the PNG specification
    requires.  Every row uses the Up filter, which encodes and decodes as
    one numpy subtraction or addition.
  * ``read_png`` reads the same formats with any of the five filter types,
    since other writers (libpng under cv2) choose a filter per row: None,
    Sub and Up rows decode as numpy operations, Average and Paeth rows in
    a loop along the row (each byte depends on the decoded byte to its
    left).  It also reads what mask tools write: palette images (color
    type 3, bit depths 1, 2, 4 and 8), expanded to RGB, or to RGBA when a
    ``tRNS`` chunk gives the palette alpha, and gray at bit depths 1, 2 and
    4, scaled to 0..255.  That is what ``cv2.imread(path, -1)`` returns for
    them (in BGR order), so ``mask.sum(-1) > 0`` reads a paletted mask as
    the JAX readers do (``bundlesdf_tpu/io/readers.py:99, 183, 189``).
    Every one of these may be Adam7-interlaced: each of the 7 passes is a
    small image of its own (its own row length, its rows filtered from a
    zero row, sub-byte samples packed per pass row, no bytes at all for an
    empty pass), and the passes' samples are put back in place before the
    palette and gray expansion.  Other interlace methods raise.

Arrays are (H, W) for gray and (H, W, C) otherwise, channels in the file's
order (RGB, not OpenCV's BGR).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels -> PNG color type, and back
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 or uint16 image, (H, W) or (H, W, C) with C in 1..4."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        depth = 8
    elif img.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"write_png takes uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1..4), not {img.shape}")
    H, W, C = img.shape
    raw = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = raw.view(np.uint8).reshape(H, W * C * depth // 8)
    up = rows.copy()
    up[1:] -= rows[:-1]  # Up filter: the byte minus the byte above, mod 256
    lines = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(lines.tobytes()))
                + _chunk(b"IEND", b""))


def _unfilter_avg(x: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(len(x))
    for i in range(len(x)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (x[i] + ((a + prev[i]) >> 1)) & 255
    return out


def _unfilter_paeth(x: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(len(x))
    for i in range(len(x)):
        b = prev[i]
        if i < bpp:
            out[i] = (x[i] + b) & 255  # a = c = 0: the predictor is b
            continue
        a, c = out[i - bpp], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pr = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x[i] + pr) & 255
    return out


def _unpack_bits(rows: np.ndarray, depth: int, n: int) -> np.ndarray:
    """(H, stride) packed samples of ``depth`` < 8 bits, first sample in the
    high bits -> (H, n) uint8 sample values."""
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :n]


def _unfilter(lines: np.ndarray, bpp: int, path: str) -> np.ndarray:
    """(h, 1 + stride) filtered scanlines -> (h, stride) bytes; the row
    above the first is zero."""
    h, stride = lines.shape[0], lines.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        ft, x = lines[r, 0], lines[r, 1:]
        if ft == 0:
            row = x
        elif ft == 1:  # Sub: a running sum along the row, per byte of a pixel
            row = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ft == 2:
            row = x + prev
        elif ft == 3:
            row = np.frombuffer(_unfilter_avg(x.tobytes(), prev.tobytes(), bpp), np.uint8)
        elif ft == 4:
            row = np.frombuffer(_unfilter_paeth(x.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"{path}: row {r} has filter type {ft}")
        out[r] = row
        prev = out[r]
    return out


def _samples(rows: np.ndarray, w: int, C: int, depth: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, w, C) sample values: uint8 up to
    8 bits, uint16 at 16 (big-endian in the file)."""
    if depth < 8:
        return _unpack_bits(rows, depth, w)[..., None]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(-1, w, C)
    return rows.reshape(-1, w, C)


# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def read_png(path: str) -> np.ndarray:
    """Read a PNG, interlaced or not: 8- or 16-bit gray, gray + alpha, RGB
    or RGBA into uint8 / uint16; 1-, 2- or 4-bit gray scaled to uint8; a
    palette image (1-8 bits) expanded to uint8 RGB, or RGBA with ``tRNS``.
    (H, W) for gray and (H, W, C) otherwise."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = hdr
    palette = ctype == 3
    depths = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8, 16))
    if (ctype not in _CHANNELS and not palette) or depth not in depths or interlace > 1:
        raise ValueError(f"{path}: unsupported PNG (color type {ctype}, bit depth "
                         f"{depth}, interlace method {interlace})")
    if palette and plte is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    C = 1 if palette else _CHANNELS[ctype]
    bpp = max(1, C * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    # Adam7: each pass is an image of its own, rows filtered from a zero row
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.empty((H, W, C), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in passes:
        w, h = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if w <= 0 or h <= 0:
            continue  # an empty pass has no bytes
        stride = (w * C * depth + 7) // 8
        lines = raw[at:at + h * (stride + 1)].reshape(h, stride + 1)
        at += h * (stride + 1)
        samples[y0::dy, x0::dx] = _samples(_unfilter(lines, bpp, path), w, C, depth)
    if palette:
        lut = plte
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[:min(len(trns), len(plte))] = trns[:len(plte)]
            lut = np.concatenate([plte, alpha[:, None]], axis=1)
        # an index past the palette reads black (opaque), as libpng does
        lut = np.concatenate([lut, np.zeros((256 - len(lut), lut.shape[1]), np.uint8)])
        if lut.shape[1] == 4:
            lut[len(plte):, 3] = 255
        return lut[samples[..., 0]]
    if depth < 8:  # gray: scale to 0..255, as libpng's expand does
        return samples[..., 0] * np.uint8(255 // ((1 << depth) - 1))
    return samples[..., 0] if C == 1 else samples
