"""A JPEG decoder in numpy, for the HO3D reader's colour frames
(``bundlesdf_tpu/io/readers.py:177-178`` reads ``rgb/*.jpg`` with
``imageio.imread``, libjpeg-turbo under PIL; the card's machine has no
OpenCV, PIL or imageio).

Supported: Huffman-coded sequential (SOF0, SOF1) and progressive (SOF2)
frames of 8-bit samples with 1 (gray), 3 (YCbCr or RGB) or 4 (CMYK or YCCK)
components, in any number of scans, interleaved or not, with DHT and DRI
segments between them; restart intervals (DRI / RSTn); integral sampling
factors (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...); byte stuffing; APPn and COM
segments.  ``NotImplementedError`` names what it refuses: 12-bit samples
(PIL refuses them too), hierarchical frames (SOF5-7, DHP; libjpeg has no
decoder for them), and lossless (SOF3) and arithmetic-coded (SOF9-11, DAC)
files, which neither OpenCV nor PIL writes.

It decodes as libjpeg-turbo does under PIL, with libjpeg's defaults:
  * the integer "islow" IDCT (jidctint.c) with its post-IDCT range limit;
  * "fancy" triangle upsampling of the chroma (jdsample.c: h2v1, h2v2 on
    planes wider than 2 samples, and h1v2, whose rounding bias alternates
    by output row; edges replicated at the component's true size); other
    factors replicate samples;
  * the colour space guessed from the markers as jdapimin.c does: a JFIF
    file, an Adobe APP14 transform of 1 and component ids 1, 2, 3 are
    YCbCr; Adobe transform 0 and ids 'R', 'G', 'B' are RGB; 4 components
    are CMYK, or YCCK under an Adobe transform other than 0; jdcolor.c's
    fixed-point conversions.  CMYK comes back inverted, as PIL reads every
    4-component JPEG (its "CMYK;I", the Adobe convention);
  * block smoothing of progressive files (jdcoefct.c's
    ``decompress_smooth_data``, libjpeg-turbo's 5 x 5 window).  Where the
    scans leave one of the first 9 zigzag AC coefficients of a component
    short of full precision, or never send it, a zero coefficient is
    estimated from the DC values of the block and its 24 neighbours; where
    none of the 9 was sent, the DC is smoothed too.  A file whose scans end
    at full precision, as libjpeg's default script does, is not smoothed.

Only the entropy decode is a Python loop, one per kind of scan: sequential,
and the progressive DC first, DC refinement, AC first and AC refinement
scans (T.81 G.1.2, libjpeg's jdphuff.c).  It reads the scan through a table
indexed by the next 16 bits, which gives a code's length with its extra
bits, run and value in one lookup wherever code and extra bits fit in 16
bits (a short path decodes the rest).  Dequantization, smoothing, the IDCT,
upsampling and colour conversion run over all blocks at once.
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
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical differential sequential (SOF5)",
    0xC6: "hierarchical differential progressive (SOF6)",
    0xC7: "hierarchical differential lossless (SOF7)",
    0xC9: "arithmetic sequential (SOF9)", 0xCA: "arithmetic progressive (SOF10)",
    0xCB: "arithmetic lossless (SOF11)",
    0xCD: "arithmetic hierarchical differential sequential (SOF13)",
    0xCE: "arithmetic hierarchical differential progressive (SOF14)",
    0xCF: "arithmetic hierarchical differential lossless (SOF15)",
    0xCC: "arithmetic conditioning (DAC)", 0xDE: "hierarchical (DHP)",
}


class _Huffman:
    """Lookup tables of one Huffman table over all 16-bit peeks: the code's
    length and symbol, and the fast path's total length (code + extra bits;
    0 where they do not fit in 16 bits), symbol, run and decoded value."""

    def __init__(self, counts, symbols, ac: bool):
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
        s = self.symbol & 15
        total = self.length + s
        fits = (self.length > 0) & (total <= 16)
        bits = (peek >> np.maximum(16 - total, 0)) & ((1 << s) - 1)
        value = np.where(s == 0, 0, np.where(bits < (1 << np.maximum(s - 1, 0)),
                                             bits - (1 << s) + 1, bits))
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


class _Frame:
    """A frame and the decoder's state across its scans: the quantized
    coefficients of every component in one flat list, natural order."""

    def __init__(self, seg: bytes, progressive: bool):
        prec, H, W, nc = struct.unpack(">BHHB", seg[:6])
        if prec != 8:
            raise NotImplementedError(f"JPEG: {prec}-bit samples are not supported")
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
        self.mcux = -(-W // (8 * self.hmax))
        self.mcuy = -(-H // (8 * self.vmax))
        self.comps, offset = [], 0
        for cid, h, v, tq in raw:
            bx, by = self.mcux * h, self.mcuy * v
            self.comps.append(_Component(cid, h, v, tq, offset, bx, by,
                                         -(-W * h // self.hmax), -(-H * v // self.vmax)))
            offset += bx * by * 64
        self.coef = [0] * offset
        self.n_scans = 0

    def decode_scan(self, sos: bytes, qt: dict, hts: dict, ri: int, rest: np.ndarray) -> int:
        """Decode one scan into the coefficients; returns the bytes of
        entropy-coded data it took from ``rest``."""
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

        def table(tc, th):
            if (tc, th) not in hts:
                raise ValueError(f"JPEG: Huffman table {tc}/{th} is not defined")
            return hts[(tc, th)]

        scan, starts, used = _unstuff(rest)
        padded = np.concatenate([scan, np.zeros(4, np.uint8)]).astype(np.int64)
        data = ((padded[:-2] << 16) | (padded[1:-1] << 8) | padded[2:]).tolist()
        run = (data, starts, blocks, ri * per, self.coef)
        if not self.progressive:
            _scan_sequential(*run, [(table(0, td), table(1, ta)) for td, ta in sel])
        elif ss == 0:
            if se != 0:
                raise ValueError("JPEG: a progressive DC scan with AC coefficients")
            if ah == 0:
                _scan_dc_first(*run, [table(0, td) for td, _ in sel], al)
            else:
                _scan_dc_refine(*run, al)
        else:
            if ns != 1 or se < ss or se > 63:
                raise ValueError(f"JPEG: a progressive AC scan of {ns} components, "
                                 f"band {ss}..{se}")
            if ah == 0:
                _scan_ac_first(*run, table(1, sel[0][1]), ss, se, al)
            else:
                _scan_ac_refine(*run, table(1, sel[0][1]), ss, se, al)
        lo, hi = (0, 63) if not self.progressive else (ss, se)
        for i in idx:
            self.comps[i].bits[lo:hi + 1] = [al] * (hi + 1 - lo)
        self.n_scans += 1
        return used

    def image(self, jfif: bool, adobe) -> np.ndarray:
        """Dequantize, smooth, IDCT, upsample and convert the colour."""
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
    """Decode a JPEG as PIL does: (H, W, 3) uint8 RGB, (H, W) for gray, or
    (H, W, 4) inverted CMYK for 4 components."""
    arr = np.frombuffer(buf, np.uint8)
    if buf[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qt, hts, frame, ri, jfif, adobe = {}, {}, None, 0, False, None
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
                hts[(tc, th)] = _Huffman(counts, list(seg[i + 17:i + 17 + n]), ac=tc == 1)
                i += 17 + n
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0 / SOF1 / SOF2
            if frame is not None:
                raise ValueError("JPEG: a second frame header")
            frame = _Frame(seg, progressive=marker == 0xC2)
        elif marker == 0xDD:        # DRI
            (ri,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            adobe = seg[11]         # the colour transform
        elif marker == 0xDA:        # SOS
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            pos += frame.decode_scan(seg, qt, hts, ri, arr[pos:])
        # other APPn, COM and other segments: skipped
    if frame is None or not frame.n_scans:
        raise ValueError("JPEG: no scan")
    return frame.image(jfif, adobe)


def read_jpeg(path: str) -> np.ndarray:
    """Read a JPEG file as ``decode_jpeg`` decodes it."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
