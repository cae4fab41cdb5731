"""A JPEG decoder in numpy.  It stands in for ``imageio.imread`` (libjpeg-
turbo under PIL), with which the JAX HO3D reader reads ``rgb/*.jpg``
(``bundlesdf_tpu/io/readers.py:177-178``), and for cv2's JPEG decoder where
the JAX readers read a mask or depth file with ``cv2.imread(path, -1)``
(``io/imread.py``).  The card's machine has no OpenCV, PIL or imageio.

Supported: sequential (SOF0, SOF1) and progressive (SOF2) frames, Huffman-
or arithmetic-coded (SOF9, SOF10, DAC conditioning), of 8-bit samples with
1 (gray), 3 (YCbCr or RGB) or 4 (CMYK or YCCK) components, in any number of
scans, interleaved or not, with DHT, DAC and DRI segments between them;
lossless frames (SOF3) of 8-bit samples, predictors 1-7 and any point
transform; restart intervals (DRI / RSTn); integral sampling factors (4:4:4,
4:2:2, 4:2:0, 4:4:0, 4:1:1, ...); byte stuffing; APPn and COM segments.
``NotImplementedError`` names what it refuses, each of which PIL refuses
too: 12- and 16-bit samples, hierarchical frames (SOF5-7, SOF13-15, DHP;
libjpeg has no decoder for them), arithmetic lossless frames (SOF11;
libjpeg-turbo has no such decoder) and lossless YCbCr or YCCK (libjpeg-
turbo will not convert them).

It decodes as libjpeg-turbo does under PIL, with libjpeg's defaults:
  * the integer "islow" IDCT (jidctint.c) with its post-IDCT range limit;
  * "fancy" triangle upsampling of the chroma (jdsample.c: h2v1, h2v2 on
    planes wider than 2 samples, and h1v2, whose rounding bias alternates
    by output row; edges replicated at the component's true size); other
    factors, and every lossless frame, replicate samples;
  * the colour space guessed from the markers as jdapimin.c does: a JFIF
    file, an Adobe APP14 transform of 1 and component ids 1, 2, 3 are
    YCbCr; Adobe transform 0 and ids 'R', 'G', 'B' are RGB; 4 components
    are CMYK, or YCCK under an Adobe transform other than 0; jdcolor.c's
    fixed-point conversions.  A lossless file without a JFIF or Adobe
    marker is RGB whatever its ids.  CMYK comes back inverted, as PIL reads
    every 4-component JPEG (its "CMYK;I", the Adobe convention);
  * block smoothing of progressive files (jdcoefct.c's
    ``decompress_smooth_data``, libjpeg-turbo's 5 x 5 window).  Where the
    scans leave one of the first 9 zigzag AC coefficients of a component
    short of full precision, or never send it, a zero coefficient is
    estimated from the DC values of the block and its 24 neighbours; where
    none of the 9 was sent, the DC is smoothed too.  A file whose scans end
    at full precision, as libjpeg's default script does, is not smoothed;
  * a lossless frame's samples shifted back by the point transform and
    truncated to 8 bits, as libjpeg-turbo's upscaling does.

Only the entropy decode is a Python loop, one per kind of scan.  Huffman
scans (T.81 F.2.2, G.1.2, H.1.2; libjpeg's jdhuff.c, jdphuff.c, jdlhuff.c)
read through a table indexed by the next 16 bits, which gives a code's
length with its extra bits, run and value in one lookup wherever code and
extra bits fit in 16 bits (a short path decodes the rest).  Arithmetic
scans (T.81 D.2, F.2.4, G.1.3; jdarith.c) run the QM decoder one decision
at a time over each restart interval's bytes.  Dequantization, smoothing,
the IDCT, lossless undifferencing (as prefix sums where the predictor is
linear), upsampling and colour conversion run over all blocks at once.

PIL decodes an arithmetic-coded file only when it fits PIL's first read
(65,536 bytes): libjpeg's arithmetic decoder cannot wait for more input,
and PIL raises.  This decoder, like cv2, decodes the larger ones too.
"""
from __future__ import annotations

import struct

import numpy as np

# zigzag order: the k-th coefficient of a scan is natural index ZIGZAG[k]
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_UNSUPPORTED = {
    0xC5: "hierarchical differential sequential (SOF5)",
    0xC6: "hierarchical differential progressive (SOF6)",
    0xC7: "hierarchical differential lossless (SOF7)",
    0xCB: "arithmetic lossless (SOF11)",
    0xCD: "arithmetic hierarchical differential sequential (SOF13)",
    0xCE: "arithmetic hierarchical differential progressive (SOF14)",
    0xCF: "arithmetic hierarchical differential lossless (SOF15)",
    0xDE: "hierarchical (DHP)",
}
# The frames decoded, by SOF marker: (progressive, arithmetic, lossless).
_FRAMES = {0xC0: (False, False, False), 0xC1: (False, False, False),
           0xC2: (True, False, False), 0xC3: (False, False, True),
           0xC9: (False, True, False), 0xCA: (True, True, False)}

# T.81 Table D.3 (libjpeg's jaricom.c): per state of the QM coder, Qe, the
# next state after an LPS (bit 7: the MPS flips) and after an MPS.  State
# 113, libjpeg's, codes sign and refinement bits at the fixed probability
# 0.5 (T.851 Table 5).
_QE = (0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036, 0x001a,
       0x000d, 0x0006, 0x0003, 0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c, 0x17b9, 0x1182,
       0x0cef, 0x09a1, 0x072f, 0x055c, 0x0406, 0x0303, 0x0240, 0x01b1, 0x0144, 0x00f5,
       0x00b7, 0x008a, 0x0068, 0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d, 0x2ef1,
       0x261f, 0x1f33, 0x19a8, 0x1518, 0x1177, 0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706,
       0x05cd, 0x04de, 0x040f, 0x0363, 0x02d4, 0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125,
       0x00f6, 0x00cb, 0x00ab, 0x008f, 0x5b12, 0x4d04, 0x412c, 0x37d8, 0x2fe8, 0x293c,
       0x2379, 0x1edf, 0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b, 0x0d51, 0x0bb6, 0x0a40,
       0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516, 0x5570, 0x4ca9,
       0x44d9, 0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf, 0x3c3d,
       0x375e, 0x5231, 0x4c0f, 0x4639, 0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f,
       0x5a10, 0x5522, 0x59eb, 0x5a1d)
_NEXT_LPS = (
    1 | 128, 14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9, 10, 12, 15 | 128, 36, 38, 39, 40, 42,
    43, 45, 46, 48, 49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32, 33, 37 | 128, 64, 65, 67, 68,
    69, 70, 72, 73, 74, 75, 77, 78, 79, 48, 50, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61,
    65 | 128, 80, 81, 82, 83, 84, 86, 87, 87, 72, 72, 74, 74, 75, 77, 77, 80 | 128, 88, 89,
    90, 91, 92, 93, 86, 88 | 128, 95, 96, 97, 99, 99, 93, 95 | 128, 101, 102, 103, 104, 99,
    105, 106, 107, 103, 105 | 128, 108, 109, 110, 111, 110 | 128, 112, 112 | 128, 113)
_NEXT_MPS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 13, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 9, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
    49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 32, 65, 66, 67, 68, 69, 70, 71,
    72, 73, 74, 75, 76, 77, 78, 79, 48, 81, 82, 83, 84, 85, 86, 87, 71, 89, 90, 91, 92, 93, 94,
    86, 96, 97, 98, 99, 100, 93, 102, 103, 104, 99, 106, 107, 103, 109, 107, 111, 109, 111, 113)
_FIXED_BIN = 113


class _Huffman:
    """Lookup tables of one Huffman table over all 16-bit peeks: the code's
    length and symbol, and the fast path's total length (code + extra bits;
    0 where they do not fit in 16 bits), symbol, run and decoded value."""

    def __init__(self, counts, symbols, ac: bool, lossless: bool = False):
        lengths = np.repeat(np.arange(1, 17), counts)
        code, codes = 0, []
        for L in range(1, 17):
            for _ in range(counts[L - 1]):
                codes.append(code)
                code += 1
            code <<= 1
        codes = np.asarray(codes, np.int64)
        span = 1 << (16 - lengths)
        start = codes << (16 - lengths)
        self.length = np.zeros(65536, np.int64)
        self.symbol = np.zeros(65536, np.int64)
        if len(codes):
            at = np.repeat(start, span) + (np.arange(span.sum())
                                           - np.repeat(np.cumsum(span) - span, span))
            self.length[at] = np.repeat(lengths, span)
            self.symbol[at] = np.repeat(np.asarray(symbols, np.int64), span)
        peek = np.arange(65536, dtype=np.int64)
        # a lossless difference's category is the symbol, 0-16; 16 has no
        # extra bits and means 32768 (T.81 H.1.2.2)
        s = np.where(self.symbol < 16, self.symbol, 0) if lossless else self.symbol & 15
        total = self.length + s
        fits = (self.length > 0) & (total <= 16)
        bits = (peek >> np.maximum(16 - total, 0)) & ((1 << s) - 1)
        value = np.where(s == 0, 0, np.where(bits < (1 << np.maximum(s - 1, 0)),
                                             bits - (1 << s) + 1, bits))
        if lossless:
            value = np.where(self.symbol == 16, 32768, value)
        run = self.symbol >> 4
        if ac:
            run = np.where(self.symbol == 0, -1, run)  # EOB ends the block
        self.fast_len = np.where(fits, total, 0).tolist()
        self.fast_sym = self.symbol.tolist()
        self.fast_run = run.tolist()
        self.fast_val = value.tolist()
        self.length_l = self.length.tolist()


def _unstuff(scan: np.ndarray):
    """Entropy-coded bytes of a scan, stuffed 0x00s removed, up to the first
    marker that is not RSTn.  Returns (bytes, byte offset where each restart
    interval starts, length of the scan data in the file)."""
    ff = np.flatnonzero(scan[:-1] == 0xFF)
    nxt = scan[ff + 1]
    end = len(scan)
    stop = ff[(nxt != 0x00) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
    if len(stop):
        end = int(stop[0])
    keep = np.ones(end, bool)
    sel = ff < end
    ff, nxt = ff[sel], nxt[sel]
    keep[ff[nxt == 0x00] + 1] = False          # stuffed zero
    keep[ff[nxt == 0xFF]] = False              # fill byte before a marker
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    keep[rst] = False
    keep[rst + 1] = False
    out = scan[:end][keep]
    # restart intervals start where the kept bytes after each RSTn begin
    starts = [0] + (np.cumsum(keep)[rst + 1]).tolist()
    return out, starts, end


def _windows(scan: np.ndarray) -> list:
    """Per byte of a scan's entropy-coded data, that byte and the next two
    as one 24-bit int, for the Huffman loops' 16-bit peeks."""
    padded = np.concatenate([scan, np.zeros(4, np.uint8)]).astype(np.int64)
    return ((padded[:-2] << 16) | (padded[1:-1] << 8) | padded[2:]).tolist()


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_idct_islow over (n, 8, 8) dequantized int64
    coefficients (row = vertical frequency) -> (n, 8, 8) samples 0..255."""
    CB, P1 = 13, 2

    def one_d(x, axis, shift):
        g = [np.take(x, i, axis=axis) for i in range(8)]
        z2, z3 = g[2], g[6]
        z1 = (z2 + z3) * 4433
        t2 = z1 + z3 * -15137
        t3 = z1 + z2 * 6270
        t0 = (g[0] + g[4]) << CB
        t1 = (g[0] - g[4]) << CB
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        o0, o1, o2, o3 = g[7], g[5], g[3], g[1]
        z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
        z5 = (z3 + z4) * 9633
        o0 = o0 * 2446
        o1 = o1 * 16819
        o2 = o2 * 25172
        o3 = o3 * 12299
        z1 = z1 * -7373
        z2 = z2 * -20995
        z3 = z3 * -16069 + z5
        z4 = z4 * -3196 + z5
        o0 = o0 + z1 + z3
        o1 = o1 + z2 + z4
        o2 = o2 + z2 + z3
        o3 = o3 + z1 + z4
        r = 1 << (shift - 1)
        outs = [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                t13 - o0, t12 - o1, t11 - o2, t10 - o3]
        return np.stack([(v + r) >> shift for v in outs], axis=axis)

    ws = one_d(coef, 1, CB - P1)              # columns: along the rows axis
    out = one_d(ws, 2, CB + P1 + 3)           # rows
    m = out & 1023                            # libjpeg's post-IDCT range limit
    s = np.where(m < 512, m, m - 1024)
    return np.clip(s + 128, 0, 255)


def _upsample(plane: np.ndarray, h: int, v: int) -> np.ndarray:
    """libjpeg's upsampling by integral factors (h, v) of an int64 plane:
    fancy h2v1 and h2v2 on planes wider than 2 samples, fancy h1v2, else
    replication (edges replicated)."""
    if v == 2 and h == 2 and plane.shape[1] > 2:
        up = np.pad(plane, ((1, 1), (0, 0)), mode="edge")
        near = plane * 3
        rows = np.empty((2 * plane.shape[0], plane.shape[1]), np.int64)
        rows[0::2] = near + up[:-2]
        rows[1::2] = near + up[2:]
        side = np.pad(rows, ((0, 0), (1, 1)), mode="edge")
        out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int64)
        out[:, 0::2] = (rows * 3 + side[:, :-2] + 8) >> 4
        out[:, 1::2] = (rows * 3 + side[:, 2:] + 7) >> 4
        return out
    if v == 1 and h == 2 and plane.shape[1] > 2:
        side = np.pad(plane, ((0, 0), (1, 1)), mode="edge")
        out = np.empty((plane.shape[0], 2 * plane.shape[1]), np.int64)
        out[:, 0::2] = (plane * 3 + side[:, :-2] + 1) >> 2
        out[:, 1::2] = (plane * 3 + side[:, 2:] + 2) >> 2
        return out
    if v == 2 and h == 1:           # h1v2_fancy_upsample: any width
        up = np.pad(plane, ((1, 1), (0, 0)), mode="edge")
        out = np.empty((2 * plane.shape[0], plane.shape[1]), np.int64)
        out[0::2] = (plane * 3 + up[:-2] + 1) >> 2
        out[1::2] = (plane * 3 + up[2:] + 2) >> 2
        return out
    return np.repeat(np.repeat(plane, v, axis=0), h, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's fixed-point conversion (16 fraction bits), unclipped."""
    half = 1 << 15
    xcb, xcr = cb - 128, cr - 128
    r = y + ((91881 * xcr + half) >> 16)
    g = y + ((-22554 * xcb - 46802 * xcr + half) >> 16)
    b = y + ((116130 * xcb + half) >> 16)
    return np.stack([r, g, b], axis=-1)


# Block smoothing (jdcoefct.c): the first 9 zigzag AC coefficients' natural
# positions, and each one's estimate from the 5 x 5 DC neighbourhood
# (row-major, the block at the centre), without and with DC smoothing.
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
_SMOOTH_AC = (
    [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7], [0] * 5, [0] * 5],
    [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0] * 5, [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]],
    [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0],
     [0, 0, -1, 0, 0]],
    [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5, [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]],
    [[0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5],
)
_SMOOTH_AC_DC = (
    [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
     [-1, -1, 0, 1, 1]],
    [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0] * 5, [1, -13, -38, -13, 1],
     [1, 3, 3, 3, 1]],
    [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],
    [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5, [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
    [[0] * 5, [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0] * 5],
    [[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0] * 5],
    [[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0], [0] * 5],
    [[0] * 5, [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0], [0] * 5],
    [[0] * 5, [0, 1, 2, 1, 0], [0] * 5, [0, -1, -2, -1, 0], [0] * 5],
)
_SMOOTH_DC = [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
              [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]]


def _smooth(blocks: np.ndarray, hb: int, wb: int, v: int, last: int, bits: list,
            qt: np.ndarray) -> np.ndarray:
    """decompress_smooth_data over one component: ``blocks``, its (by, bx,
    64) quantized coefficients (natural order) on the MCU-padded grid;
    ``hb`` x ``wb``, its own block grid; ``v``, its block rows an iMCU row;
    ``last``, the last iMCU row; ``bits``, per zigzag index the low bits
    still unsent (-1: never sent).  Returns the smoothed (hb, wb, 64).
    Neighbours above and beside the grid repeat its edge; below it they
    are the MCU padding's blocks, but from the last iMCU row the last real
    row repeats, as libjpeg-turbo reads its buffer."""
    R = np.arange(hb)
    below = np.where(R // v == last, hb - 1, blocks.shape[0] - 1)
    rows = np.clip(R[:, None] + np.arange(-2, 3), 0, below[:, None])
    cols = np.clip(np.arange(wb)[:, None] + np.arange(-2, 3), 0, wb - 1)
    dc = blocks[..., 0]
    win = np.stack([dc[rows[:, i]][:, cols] for i in range(5)], axis=2)
    # win: (hb, wb, 5 rows, 5 cols) of DC values
    change_dc = all(bits[k] == -1 for k in range(1, 10))
    blocks = blocks[:hb, :wb]
    out = blocks.copy()
    q00 = int(qt[0])
    kernels = _SMOOTH_AC_DC if change_dc else _SMOOTH_AC
    for k, kern in enumerate(kernels, start=1):
        al = bits[k]
        pos = _SMOOTH_POS[k - 1]
        if al == 0:
            continue
        num = q00 * np.einsum("hwij,ij->hw", win, np.asarray(kern, np.int64))
        q = int(qt[pos])
        pred = ((q << 7) + np.abs(num)) // (q << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        out[..., pos] = np.where(blocks[..., pos] == 0, pred, blocks[..., pos])
    if change_dc:
        num = q00 * np.einsum("hwij,ij->hw", win, np.asarray(_SMOOTH_DC, np.int64))
        pred = ((q00 << 7) + np.abs(num)) // (q00 << 8)
        out[..., 0] = np.where(num >= 0, pred, -pred)
    return out


class _Component:
    """One frame component: id, sampling factors, quantization table
    selector (and the table latched at its first scan), where its blocks
    lie in the coefficient list (an MCU-padded grid of ``by`` x ``bx``),
    its own block grid (``hb`` x ``wb``) and true size (``ch`` x ``cw``),
    and per zigzag index the low bits no scan has sent yet (-1: none sent)."""

    def __init__(self, cid, h, v, tq, offset, bx, by, cw, ch):
        self.cid, self.h, self.v, self.tq, self.qt = cid, h, v, tq, None
        self.offset, self.bx, self.by = offset, bx, by
        self.cw, self.ch = cw, ch
        self.wb, self.hb = -(-cw // 8), -(-ch // 8)
        self.bits = [-1] * 64
        self.samples, self.al = None, 0    # a lossless frame's samples


class _Frame:
    """A frame and the decoder's state across its scans: the quantized
    coefficients of every component in one flat list, natural order."""

    def __init__(self, seg: bytes, progressive: bool, arithmetic: bool = False,
                 lossless: bool = False):
        prec, H, W, nc = struct.unpack(">BHHB", seg[:6])
        if prec != 8:
            kind = "lossless (SOF3) " if lossless else ""
            raise NotImplementedError(f"JPEG: {prec}-bit {kind}samples are not supported")
        if nc not in (1, 3, 4):
            raise NotImplementedError(f"JPEG: {nc} components are not supported")
        if H == 0:
            raise NotImplementedError("JPEG: a height given by a DNL segment is not supported")
        raw = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15, seg[8 + 3 * k])
               for k in range(nc)]
        self.hmax = max(c[1] for c in raw)
        self.vmax = max(c[2] for c in raw)
        if any(self.hmax % h or self.vmax % v for _, h, v, _ in raw):
            raise NotImplementedError("JPEG: non-integral sampling factors are not supported")
        self.H, self.W, self.progressive = H, W, progressive
        self.arithmetic, self.lossless = arithmetic, lossless
        unit = 1 if lossless else 8     # a lossless "block" is one sample
        self.mcux = -(-W // (unit * self.hmax))
        self.mcuy = -(-H // (unit * self.vmax))
        self.comps, offset = [], 0
        for cid, h, v, tq in raw:
            bx, by = self.mcux * h, self.mcuy * v
            self.comps.append(_Component(cid, h, v, tq, offset, bx, by,
                                         -(-W * h // self.hmax), -(-H * v // self.vmax)))
            offset += bx * by * 64
        self.coef = [] if lossless else [0] * offset
        self.n_scans = 0
        self.tables = {}            # (class, id) -> (the DHT's tables, _Huffman)

    def table(self, hts: dict, tc: int, th: int) -> _Huffman:
        """Huffman table ``th`` of class ``tc`` as the last DHT defined it,
        built once."""
        if (tc, th) not in hts:
            raise ValueError(f"JPEG: Huffman table {tc}/{th} is not defined")
        raw = hts[(tc, th)]
        built = self.tables.get((tc, th))
        if built is None or built[0] is not raw:
            built = self.tables[(tc, th)] = (raw, _Huffman(*raw, ac=tc == 1,
                                                           lossless=self.lossless))
        return built[1]

    def decode_scan(self, sos: bytes, qt: dict, hts: dict, dac: dict, ri: int,
                    rest: np.ndarray) -> int:
        """Decode one scan into the coefficients (the samples of a lossless
        frame); returns the bytes of entropy-coded data it took from
        ``rest``.  ``hts``: Huffman tables, (counts, symbols) by (class,
        id); ``dac``: arithmetic conditioning (L, U) by DC table and Kx
        by AC table."""
        ns = sos[0]
        by_id = {c.cid: i for i, c in enumerate(self.comps)}
        idx, sel = [], []
        for k in range(ns):
            cid, t = sos[1 + 2 * k], sos[2 + 2 * k]
            if cid not in by_id:
                raise ValueError(f"JPEG: scan names component {cid}, not in the frame")
            idx.append(by_id[cid])
            sel.append((t >> 4, t & 15))
        ss, se, a = sos[1 + 2 * ns], sos[2 + 2 * ns], sos[3 + 2 * ns]
        ah, al = a >> 4, a & 15
        if self.lossless:
            return self._lossless_scan(idx, sel, ss, al, hts, ri, rest)
        for i in idx:
            c = self.comps[i]
            if c.qt is None:        # libjpeg latches a table at its first scan
                if c.tq not in qt:
                    raise ValueError(f"JPEG: quantization table {c.tq} is not defined")
                c.qt = qt[c.tq]
        if ns == 1:                 # one block an MCU over the component's own grid
            c = self.comps[idx[0]]
            yy, xx = np.meshgrid(np.arange(c.hb), np.arange(c.wb), indexing="ij")
            bases = (c.offset + (yy * c.bx + xx) * 64).ravel()
            comp_ids = np.zeros(bases.shape, np.int64)
            per = 1
        else:                       # MCU by MCU, in each the components' h x v blocks
            my, mx = np.meshgrid(np.arange(self.mcuy), np.arange(self.mcux), indexing="ij")
            my, mx = my.ravel(), mx.ravel()
            bases, comp_ids = [], []
            for j, i in enumerate(idx):
                c = self.comps[i]
                yy, xx = np.meshgrid(np.arange(c.v), np.arange(c.h), indexing="ij")
                b = c.offset + ((my[:, None] * c.v + yy.ravel()) * c.bx
                                + mx[:, None] * c.h + xx.ravel()) * 64
                bases.append(b)
                comp_ids.append(np.full(b.shape, j))
            bases = np.concatenate(bases, axis=1).ravel()
            comp_ids = np.concatenate(comp_ids, axis=1).ravel()
            per = len(bases) // (self.mcux * self.mcuy)
        blocks = list(zip(comp_ids.tolist(), bases.tolist()))
        if self.progressive and ss == 0 and se != 0:
            raise ValueError("JPEG: a progressive DC scan with AC coefficients")
        if self.progressive and ss and (ns != 1 or se < ss or se > 63):
            raise ValueError(f"JPEG: a progressive AC scan of {ns} components, "
                             f"band {ss}..{se}")

        def table(tc, th):
            return self.table(hts, tc, th)

        scan, starts, used = _unstuff(rest)
        if self.arithmetic:
            bounds = starts + [len(scan)]
            _arith_scan([scan[a:b].tobytes() for a, b in zip(bounds[:-1], bounds[1:])],
                        blocks, ri * per, self.coef, sel, dac, self.progressive, ss, se, ah, al)
        else:
            run = (_windows(scan), starts, blocks, ri * per, self.coef)
            if not self.progressive:
                _scan_sequential(*run, [(table(0, td), table(1, ta)) for td, ta in sel])
            elif ss == 0 and ah == 0:
                _scan_dc_first(*run, [table(0, td) for td, _ in sel], al)
            elif ss == 0:
                _scan_dc_refine(*run, al)
            elif ah == 0:
                _scan_ac_first(*run, table(1, sel[0][1]), ss, se, al)
            else:
                _scan_ac_refine(*run, table(1, sel[0][1]), ss, se, al)
        lo, hi = (0, 63) if not self.progressive else (ss, se)
        for i in idx:
            self.comps[i].bits[lo:hi + 1] = [al] * (hi + 1 - lo)
        self.n_scans += 1
        return used

    def _lossless_scan(self, idx, sel, ss, al, hts, ri, rest) -> int:
        """A lossless scan (T.81 H.1.2, libjpeg-turbo's jdlhuff.c and
        jdlossls.c): every sample's difference decoded first (they do not
        depend on the samples), then undifferenced component by component
        from the predictor ``ss`` (1-7), rows starting the scan and each
        restart interval predicted as a first line."""
        if not 1 <= ss <= 7:
            raise ValueError(f"JPEG: lossless predictor {ss} is not 1-7")
        comps = [self.comps[i] for i in idx]
        if len(idx) == 1:           # one sample a unit over the component's own grid
            c = comps[0]
            rows, cols = [c.ch], [c.cw]
            mcux, n_units = c.cw, c.ch * c.cw
            layout = [(0, 0, 0)]
        else:                       # MCU by MCU, in each the components' h x v samples
            rows = [self.mcuy * c.v for c in comps]
            cols = [self.mcux * c.h for c in comps]
            mcux, n_units = self.mcux, self.mcux * self.mcuy
            layout = [(j, dy, dx) for j, c in enumerate(comps)
                      for dy in range(c.v) for dx in range(c.h)]
        if ri % mcux:
            raise ValueError(f"JPEG: a lossless restart interval of {ri} MCUs is not a "
                             f"whole number of MCU rows of {mcux}")
        scan, starts, used = _unstuff(rest)
        diffs = np.asarray(_scan_lossless(_windows(scan), starts, n_units, ri, [
            self.table(hts, 0, sel[j][0]) for j, _, _ in layout]), np.int64)
        diffs = diffs.reshape(-1, len(layout))
        my, mx = np.divmod(np.arange(n_units), mcux)
        for j, c in enumerate(comps):
            v, h = (c.v, c.h) if len(idx) > 1 else (1, 1)
            d = np.zeros((rows[j], cols[j]), np.int64)
            for k, (jj, dy, dx) in enumerate(layout):
                if jj == j:
                    d[my * v + dy, mx * h + dx] = diffs[:, k]
            first = range(0, rows[j], v * (ri // mcux) if ri else rows[j])
            c.samples = _undifference(d, ss, 1 << (7 - al), first)
            c.al = al
        self.n_scans += 1
        return used

    def image(self, jfif: bool, adobe) -> np.ndarray:
        """Dequantize, smooth, IDCT, upsample and convert the colour."""
        if self.lossless:
            return self._lossless_image(jfif, adobe)
        coef = np.asarray(self.coef, np.int64)
        smoothing = self.progressive and all(c.bits[0] >= 0 for c in self.comps) and any(
            b != 0 for c in self.comps for b in c.bits[1:10])
        planes = []
        for c in self.comps:
            if c.qt is None:
                raise ValueError(f"JPEG: component {c.cid} is in no scan")
            blocks = coef[c.offset:c.offset + c.bx * c.by * 64].reshape(c.by, c.bx, 64)
            if smoothing:
                blocks = blocks.copy()
                blocks[:c.hb, :c.wb] = _smooth(blocks, c.hb, c.wb, c.v, self.mcuy - 1,
                                               c.bits, c.qt)
            pix = _idct_islow((blocks.reshape(-1, 64) * c.qt).reshape(-1, 8, 8))
            plane = pix.reshape(c.by, c.bx, 8, 8).transpose(0, 2, 1, 3).reshape(
                c.by * 8, c.bx * 8)
            # the component's true size, then libjpeg's upsampling to the image
            plane = _upsample(plane[:c.ch, :c.cw], self.hmax // c.h, self.vmax // c.v)
            planes.append(plane[:self.H, :self.W])
        if len(planes) == 1:
            return planes[0].astype(np.uint8)
        if len(planes) == 3:        # jdapimin.c's guess: JFIF, then Adobe, then ids
            if jfif:
                rgb = False
            elif adobe is not None:
                rgb = adobe == 0
            else:
                rgb = tuple(c.cid for c in self.comps) == (82, 71, 66)
            out = np.stack(planes, -1) if rgb else _ycc_to_rgb(*planes)
            return np.clip(out, 0, 255).astype(np.uint8)
        if adobe not in (None, 0):  # YCCK -> CMYK: inverted RGB, K as it is
            planes = [*np.moveaxis(255 - np.clip(_ycc_to_rgb(*planes[:3]), 0, 255), -1, 0),
                      planes[3]]
        return (255 - np.stack(planes, -1)).astype(np.uint8)  # PIL's inverted CMYK

    def _lossless_image(self, jfif: bool, adobe) -> np.ndarray:
        """The samples shifted back by the point transform into 8 bits (as
        libjpeg-turbo's upscale truncates), upsampled by replication (libjpeg
        has no fancy upsampling of one-sample blocks), and no colour
        transform: libjpeg-turbo refuses a lossless file's YCbCr and YCCK
        (a JFIF marker, an Adobe transform other than 0), as PIL does."""
        planes = []
        for c in self.comps:
            if c.samples is None:
                raise ValueError(f"JPEG: component {c.cid} is in no scan")
            x = (c.samples[:c.ch, :c.cw] << c.al) & 255
            x = np.repeat(np.repeat(x, self.vmax // c.v, axis=0), self.hmax // c.h, axis=1)
            planes.append(x[:self.H, :self.W])
        if len(planes) > 1 and (jfif or adobe not in (None, 0)):
            raise NotImplementedError("JPEG: lossless YCbCr or YCCK (a JFIF marker or an "
                                      "Adobe transform) is not supported; libjpeg-turbo "
                                      "refuses the colour conversion")
        out = np.stack(planes, -1) if len(planes) > 1 else planes[0]
        if len(planes) == 4:
            out = 255 - out         # PIL's inverted CMYK
        return out.astype(np.uint8)


def _scan_sequential(data, starts, blocks, ri_blocks, coef, tables):
    """A sequential scan: per block the DC difference, then the AC
    coefficients up to EOB.  ``blocks``: per block in decode order (index in
    the scan's components, coefficient offset); ``ri_blocks``: blocks per
    restart interval (0: none); ``tables``: per component (DC, AC)."""
    zz = ZIGZAG.tolist()
    n_comp = len(tables)
    pred = [0] * n_comp
    p = 0
    interval = 0
    for j, (c, base) in enumerate(blocks):
        if ri_blocks and j and j % ri_blocks == 0:
            interval += 1
            p = starts[interval] * 8
            pred = [0] * n_comp
        dc, ac = tables[c]
        pk = (data[p >> 3] >> (8 - (p & 7))) & 65535
        n = dc.fast_len[pk]
        if n:
            p += n
            diff = dc.fast_val[pk]
        else:
            p, _, diff = _slow(data, p, dc, pk)
        pred[c] += diff
        coef[base] = pred[c]
        fl, fr, fv = ac.fast_len, ac.fast_run, ac.fast_val
        k = 1
        while k < 64:
            pk = (data[p >> 3] >> (8 - (p & 7))) & 65535
            n = fl[pk]
            if n:
                p += n
                r = fr[pk]
                if r < 0:
                    break
                k += r
                coef[base + zz[k]] = fv[pk]
            else:
                p, sym, v = _slow(data, p, ac, pk)
                if sym == 0:
                    break
                k += sym >> 4
                coef[base + zz[k]] = v
            k += 1


def _scan_dc_first(data, starts, blocks, ri_blocks, coef, tables, al):
    """Progressive DC first scan: the DC difference of each block, its value
    shifted up by the point transform ``al``."""
    pred = [0] * len(tables)
    p = interval = 0
    for j, (c, base) in enumerate(blocks):
        if ri_blocks and j and j % ri_blocks == 0:
            interval += 1
            p = starts[interval] * 8
            pred = [0] * len(tables)
        dc = tables[c]
        pk = (data[p >> 3] >> (8 - (p & 7))) & 65535
        n = dc.fast_len[pk]
        if n:
            p += n
            diff = dc.fast_val[pk]
        else:
            p, _, diff = _slow(data, p, dc, pk)
        pred[c] += diff
        coef[base] = pred[c] << al


def _scan_dc_refine(data, starts, blocks, ri_blocks, coef, al):
    """Progressive DC refinement: one bit of each block's DC."""
    bit = 1 << al
    p = interval = 0
    for j, (_, base) in enumerate(blocks):
        if ri_blocks and j and j % ri_blocks == 0:
            interval += 1
            p = starts[interval] * 8
        if (data[p >> 3] >> (23 - (p & 7))) & 1:
            coef[base] |= bit
        p += 1


def _scan_ac_first(data, starts, blocks, ri_blocks, coef, ac, ss, se, al):
    """Progressive AC first scan of band ss..se of one component: runs,
    values shifted up by ``al``, and end-of-band runs (EOBRUN) that cover
    the next blocks too and end at a restart."""
    zz = ZIGZAG.tolist()
    fl, fs, fv = ac.fast_len, ac.fast_sym, ac.fast_val
    p = interval = eobrun = 0
    for j, (_, base) in enumerate(blocks):
        if ri_blocks and j and j % ri_blocks == 0:
            interval += 1
            p = starts[interval] * 8
            eobrun = 0
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            pk = (data[p >> 3] >> (8 - (p & 7))) & 65535
            n = fl[pk]
            if n:
                p += n
                sym, v = fs[pk], fv[pk]
            else:
                p, sym, v = _slow(data, p, ac, pk)
            if sym & 15:
                k += sym >> 4
                coef[base + zz[k]] = v << al
            elif sym == 0xF0:
                k += 15
            else:
                r = sym >> 4
                eobrun = (1 << r) - 1
                if r:
                    eobrun += ((data[p >> 3] >> (8 - (p & 7))) & 65535) >> (16 - r)
                    p += r
                break
            k += 1


def _scan_ac_refine(data, starts, blocks, ri_blocks, coef, ac, ss, se, al):
    """Progressive AC refinement of band ss..se of one component, as
    libjpeg's decode_mcu_AC_refine: a newly nonzero coefficient (+-1 << al)
    after a run of zero ones, and a correction bit for each coefficient
    already nonzero that the run passes or the band's end-of-band run
    covers."""
    zz = ZIGZAG.tolist()
    fl, fs, fv = ac.fast_len, ac.fast_sym, ac.fast_val
    p1 = 1 << al
    p = interval = eobrun = 0
    for j, (_, base) in enumerate(blocks):
        if ri_blocks and j and j % ri_blocks == 0:
            interval += 1
            p = starts[interval] * 8
            eobrun = 0
        k = ss
        if not eobrun:
            while k <= se:
                pk = (data[p >> 3] >> (8 - (p & 7))) & 65535
                n = fl[pk]
                if n:
                    p += n
                    sym, v = fs[pk], fv[pk]
                else:
                    p, sym, v = _slow(data, p, ac, pk)
                r = sym >> 4
                if sym & 15:
                    v *= p1         # the sign bit: +-1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += ((data[p >> 3] >> (8 - (p & 7))) & 65535) >> (16 - r)
                        p += r
                    break
                while k <= se:
                    pos = base + zz[k]
                    t = coef[pos]
                    if t:
                        if (data[p >> 3] >> (23 - (p & 7))) & 1 and not t & p1:
                            coef[pos] = t + p1 if t >= 0 else t - p1
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if v:
                    coef[base + zz[k]] = v
                k += 1
        if eobrun:
            while k <= se:
                pos = base + zz[k]
                t = coef[pos]
                if t:
                    if (data[p >> 3] >> (23 - (p & 7))) & 1 and not t & p1:
                        coef[pos] = t + p1 if t >= 0 else t - p1
                    p += 1
                k += 1
            eobrun -= 1


def _scan_lossless(data, starts, n_units, ri, tabs):
    """A lossless scan's differences in decode order, MCU by MCU: ``tabs``,
    the Huffman table of each sample of an MCU; ``ri``, MCUs a restart
    interval (0: none).  A difference's category is its symbol; 16 means
    32768 with no extra bits."""
    out = []
    append = out.append
    p = interval = 0
    for u in range(n_units):
        if ri and u and u % ri == 0:
            interval += 1
            p = starts[interval] * 8
        for t in tabs:
            pk = (data[p >> 3] >> (8 - (p & 7))) & 65535
            n = t.fast_len[pk]
            if n:
                p += n
                append(t.fast_val[pk])
            else:
                p, sym, v = _slow(data, p, t, pk)
                append(32768 if sym == 16 else v)
    return out


def _undifference(d: np.ndarray, predictor: int, init: int, first) -> np.ndarray:
    """libjpeg-turbo's undifferencing (jdlossls.c) of one component's
    differences ``d`` (rows x columns, int64): a row in ``first`` (the
    scan's first and each restart interval's, ascending) is a first line, its first
    sample predicted by ``init`` and the rest by the sample to the left
    (Ra); in the other rows the first sample by the one above (Rb), the
    rest by ``predictor``: 1 Ra, 2 Rb, 3 Rc, 4 Ra + Rb - Rc, 5 Ra + ((Rb -
    Rc) >> 1), 6 Rb + ((Ra - Rc) >> 1), 7 (Ra + Rb) >> 1.  Samples are kept
    modulo 2^16.  1, 2 and 4 are prefix sums of the differences, 3 and 5
    one numpy step a row; 6 and 7 loop over the samples."""
    rows, cols = d.shape
    x = np.empty_like(d)
    bounds = list(first) + [rows]
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        seg = d[r0:r1].copy()
        seg[0, 0] += init
        if predictor == 1:          # the first column down, then each row along
            seg[:, 0] = np.cumsum(seg[:, 0])
            x[r0:r1] = np.cumsum(seg, axis=1) & 0xFFFF
            continue
        x[r0] = np.cumsum(seg[0]) & 0xFFFF
        if predictor == 2:
            seg[0] = x[r0]
            x[r0:r1] = np.cumsum(seg, axis=0) & 0xFFFF
            continue
        if predictor == 4:          # first row and column 1-D: a 2-D prefix sum
            x[r0:r1] = np.cumsum(np.cumsum(seg, axis=0), axis=1) & 0xFFFF
            continue
        for r in range(r0 + 1, r1):
            prev, e = x[r - 1], seg[r - r0]
            if predictor == 3:
                x[r, 0] = (prev[0] + e[0]) & 0xFFFF
                x[r, 1:] = (prev[:-1] + e[1:]) & 0xFFFF
            elif predictor == 5:
                e = e.copy()
                e[0] += prev[0]
                e[1:] += (prev[1:] - prev[:-1]) >> 1
                x[r] = np.cumsum(e) & 0xFFFF
            else:
                up, dr = prev.tolist(), e.tolist()
                row = [0] * cols
                a = row[0] = (up[0] + dr[0]) & 0xFFFF
                for c in range(1, cols):
                    b = up[c]
                    pred = b + ((a - up[c - 1]) >> 1) if predictor == 6 else (a + b) >> 1
                    a = row[c] = (dr[c] + pred) & 0xFFFF
                x[r] = row
    return x


def _arith_decoder(data: bytes):
    """The QM decoder over one restart interval's bytes, stuffing removed
    (T.81 D.2, libjpeg's jdarith.c ``arith_decode``): ``decode(stats, i)``
    returns the bit coded in bin ``stats[i]`` (its state, the MPS in bit 7)
    and moves the bin's state.  Past the bytes it reads zeros, as libjpeg
    does once it meets a marker (D.2.6)."""
    n = len(data)
    c = a = pos = 0
    ct = -16                        # the first calls read 2 bytes into C

    def decode(st, i):
        nonlocal c, a, ct, pos
        while a < 0x8000:           # renormalization and data input (D.2.6)
            ct -= 1
            if ct < 0:
                c = (c << 8) | (data[pos] if pos < n else 0)
                pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        s = sv & 127
        qe = _QE[s]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:              # conditional exchange: the MPS after all
                a = qe
                st[i] = (sv & 128) ^ _NEXT_MPS[s]
                return sv >> 7
            a = qe
            st[i] = (sv & 128) ^ _NEXT_LPS[s]
            return (sv >> 7) ^ 1
        if a < 0x8000:
            if a < qe:              # conditional exchange: the LPS
                st[i] = (sv & 128) ^ _NEXT_LPS[s]
                return (sv >> 7) ^ 1
            st[i] = (sv & 128) ^ _NEXT_MPS[s]
        return sv >> 7

    return decode


def _arith_dc(dec, st, ctx, L, U):
    """F.2.4.1: a DC difference from DC statistics ``st`` in context
    ``ctx``; returns (difference, the next block's context): 0 after a
    zero or small difference (magnitude below 2^L / 2), 12 (+4 negative)
    after a large one (above 2^U / 2), 4 (+4) otherwise."""
    if not dec(st, ctx):
        return 0, 0
    sign = dec(st, ctx + 1)
    i = ctx + 2 + sign
    m = dec(st, i)
    if m:
        i = 20
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                raise ValueError("JPEG: an arithmetic-coded magnitude overflows")
            i += 1
    nxt = 0 if m < (1 << L) >> 1 else (12 if m > (1 << U) >> 1 else 4) + 4 * sign
    v, i, m = m, i + 14, m >> 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    return (-v - 1 if sign else v + 1), nxt


def _arith_ac(dec, st, i, x2, fixed):
    """F.2.4.2: a nonzero AC coefficient: its sign at the fixed
    probability, its magnitude category in bin ``i`` (S0 + 2 of its zigzag
    index) and then from ``x2`` (189 up to Kx, 217 past it), its magnitude
    bits 14 bins on."""
    sign = dec(fixed, 0)
    m = dec(st, i)
    if m and dec(st, i):
        m, i = 2, x2
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                raise ValueError("JPEG: an arithmetic-coded magnitude overflows")
            i += 1
    v, i, m = m, i + 14, m >> 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    return -v - 1 if sign else v + 1


def _arith_scan(intervals, blocks, ri_blocks, coef, sel, dac, progressive, ss, se, ah, al):
    """One arithmetic-coded scan (T.81 F.2.4 and G.1.3, libjpeg's
    jdarith.c): ``intervals``, each restart interval's bytes; ``blocks``,
    ``ri_blocks`` and ``coef`` as the Huffman scans'; ``sel``, each scan
    component's (DC, AC) conditioning table.  The statistics (64 bins a DC
    table, 256 an AC table, shared by the components that name the table),
    the DC predictions and contexts, and the decoder restart with every
    interval.  Sequential blocks and progressive first scans code their
    values; DC refinement scans one bit a block, and AC refinement scans a
    correction bit for each coefficient already nonzero, at the fixed
    probability."""
    zz = ZIGZAG.tolist()
    fixed = [_FIXED_BIN]
    cond = [dac.get((0, td), (0, 1)) for td, _ in sel]
    kx = [dac.get((1, ta), 5) for _, ta in sel]
    dc_scan = not progressive or (ss == 0 and ah == 0)
    lo, hi = (ss, se) if progressive else (1, 63)
    al = al if progressive else 0   # a sequential scan's point transform is unused
    p1 = 1 << al
    for j, (c, base) in enumerate(blocks):
        if j == 0 or (ri_blocks and j % ri_blocks == 0):
            k = j // ri_blocks if ri_blocks else 0
            dec = _arith_decoder(intervals[k] if k < len(intervals) else b"")
            dc_stats = {td: [0] * 64 for td, _ in sel}
            ac_stats = {ta: [0] * 256 for _, ta in sel}
            pred = [0] * len(sel)
            ctx = [0] * len(sel)
        td, ta = sel[c]
        if dc_scan:
            diff, ctx[c] = _arith_dc(dec, dc_stats[td], ctx[c], *cond[c])
            pred[c] = (pred[c] + diff) & 0xFFFF
            v = (pred[c] << al) & 0xFFFF    # libjpeg's 16-bit JCOEF
            coef[base] = v - 65536 if v >= 32768 else v
        elif ss == 0:
            if dec(fixed, 0):
                coef[base] |= p1
        if progressive and ss == 0:
            continue
        st, K = ac_stats[ta], kx[c]
        if not ah:                  # sequential, or a progressive first scan
            k = lo
            while k <= hi:
                i = 3 * (k - 1)
                if dec(st, i):      # end of block
                    break
                while not dec(st, i + 1):
                    i += 3
                    k += 1
                    if k > hi:
                        raise ValueError("JPEG: arithmetic-coded coefficients run past "
                                         "the band")
                coef[base + zz[k]] = _arith_ac(dec, st, i + 2, 189 if k <= K else 217,
                                               fixed) << al
                k += 1
            continue
        kex = hi                    # the previous scans' end of block
        while kex > 0 and not coef[base + zz[kex]]:
            kex -= 1
        k = lo
        while k <= hi:
            i = 3 * (k - 1)
            if k > kex and dec(st, i):
                break
            while True:
                pos = base + zz[k]
                t = coef[pos]
                if t:               # already nonzero: a correction bit
                    if dec(st, i + 2):
                        coef[pos] = t - p1 if t < 0 else t + p1
                    break
                if dec(st, i + 1):  # newly nonzero: +-1 << al
                    coef[pos] = -p1 if dec(fixed, 0) else p1
                    break
                i += 3
                k += 1
                if k > hi:
                    raise ValueError("JPEG: arithmetic-coded coefficients run past the band")
            k += 1


def _slow(data, p, tab, pk):
    """Decode one code whose extra bits do not fit the fast path: returns
    (new bit position, symbol, value of its extra bits)."""
    L = tab.length_l[pk]
    if L == 0:
        raise ValueError("JPEG: invalid Huffman code in the scan")
    sym = tab.fast_sym[pk]
    p += L
    s = sym & 15
    if s == 0:
        return p, sym, 0
    bits = ((data[p >> 3] >> (8 - (p & 7))) & 65535) >> (16 - s)
    p += s
    return p, sym, bits if bits >= (1 << (s - 1)) else bits - (1 << s) + 1


def decode_jpeg(buf: bytes) -> np.ndarray:
    """Decode a JPEG (baseline, extended, progressive, lossless; Huffman or
    arithmetic) as PIL does: (H, W, 3) uint8 RGB, (H, W) for gray, or
    (H, W, 4) inverted CMYK for 4 components."""
    arr = np.frombuffer(buf, np.uint8)
    if buf[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qt, hts, dac, frame, ri, jfif, adobe = {}, {}, {}, None, 0, False, None
    pos = 2
    while pos < len(buf):
        if buf[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        marker = buf[pos + 1]
        pos += 2
        if marker == 0xFF:          # fill byte
            pos -= 1
            continue
        if marker == 0xD9:          # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (seg_len,) = struct.unpack(">H", buf[pos:pos + 2])
        seg = buf[pos + 2:pos + seg_len]
        pos += seg_len
        if marker in _UNSUPPORTED:
            raise NotImplementedError(f"JPEG: {_UNSUPPORTED[marker]} is not supported")
        if marker == 0xDB:          # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                q = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = q
                qt[tq] = nat
                i += 1 + n
        elif marker == 0xC4:        # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                n = sum(counts)
                hts[(tc, th)] = (counts, list(seg[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker == 0xCC:        # DAC: (L, U) of a DC table, Kx of an AC table
            for i in range(0, len(seg) - 1, 2):
                tc, tb, val = seg[i] >> 4, seg[i] & 15, seg[i + 1]
                if tc == 0 and (val & 15) > val >> 4:
                    raise ValueError(f"JPEG: DAC L {val & 15} above U {val >> 4}")
                dac[(tc, tb)] = val if tc else (val & 15, val >> 4)
        elif marker in _FRAMES:     # SOF0-3, SOF9, SOF10
            if frame is not None:
                raise ValueError("JPEG: a second frame header")
            frame = _Frame(seg, *_FRAMES[marker])
        elif marker == 0xDD:        # DRI
            (ri,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            adobe = seg[11]         # the colour transform
        elif marker == 0xDA:        # SOS
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            pos += frame.decode_scan(seg, qt, hts, dac, ri, arr[pos:])
        # other APPn, COM and other segments: skipped
    if frame is None or not frame.n_scans:
        raise ValueError("JPEG: no scan")
    return frame.image(jfif, adobe)


def read_jpeg(path: str) -> np.ndarray:
    """Read a JPEG file as ``decode_jpeg`` decodes it."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
