"""A baseline JPEG decoder in numpy, for the HO3D reader's colour frames
(``bundlesdf_tpu/io/readers.py:177-178`` reads ``rgb/*.jpg`` with
``imageio.imread``; the card's machine has no OpenCV, PIL or imageio).

Supported: Huffman-coded baseline and extended sequential frames (SOF0,
SOF1) of 8-bit samples, 1 or 3 components in one interleaved scan, chroma
sampled 4:4:4, 4:2:2 or 4:2:0, restart intervals (DRI / RSTn), byte
stuffing, and APPn / COM segments (skipped).  Progressive, lossless,
hierarchical and arithmetic-coded files raise ``NotImplementedError``
naming their marker.

It decodes as the JAX reader's decoder does (libjpeg under PIL) with
libjpeg's defaults: the integer "islow" IDCT (jidctint.c), "fancy"
triangle upsampling of the chroma (jdsample.c: h2v1 / h2v2, edges
replicated at the component's true size) and the fixed-point YCbCr -> RGB
of jdcolor.c, including libjpeg's range limit after the IDCT.

Only the entropy decode is a Python loop.  It reads the scan through a
table indexed by the next 16 bits, which gives a code's length with its
extra bits, run and value in one lookup wherever code and extra bits fit
in 16 bits (a short path decodes the rest).  Dequantization, the IDCT,
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
    0xC2: "progressive DCT (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)", 0xC9: "arithmetic sequential (SOF9)",
    0xCA: "arithmetic progressive (SOF10)", 0xCB: "arithmetic lossless (SOF11)",
    0xCD: "arithmetic differential sequential (SOF13)",
    0xCE: "arithmetic differential progressive (SOF14)",
    0xCF: "arithmetic differential lossless (SOF15)",
    0xCC: "arithmetic conditioning (DAC)", 0xDE: "hierarchical (DHP)",
}


class _Huffman:
    """Lookup tables of one Huffman table over all 16-bit peeks: the code's
    length and symbol, and the fast path's total length (code + extra bits;
    0 where they do not fit in 16 bits), run and decoded value."""

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
        self.fast_run = run.tolist()
        self.fast_val = value.tolist()
        self.length_l = self.length.tolist()
        self.symbol_l = self.symbol.tolist()


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
    """libjpeg's fancy upsampling by (h, v) in {1, 2}^2 of an int64 plane
    (edges replicated)."""
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
    if h == 1 and v == 1:
        return plane
    if v == 2 and h == 1:
        raise NotImplementedError("JPEG chroma sampled 4:4:0 (h1v2) is not supported")
    # narrow planes: libjpeg replicates samples instead
    return np.repeat(np.repeat(plane, v, axis=0), h, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's fixed-point conversion (16 fraction bits)."""
    half = 1 << 15
    xcb, xcr = cb - 128, cr - 128
    r = y + ((91881 * xcr + half) >> 16)
    g = y + ((-22554 * xcb - 46802 * xcr + half) >> 16)
    b = y + ((116130 * xcb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _decode_scan(data: list, starts: list, blocks: list, ri_blocks: int, tables):
    """The entropy decode of one interleaved scan.  ``blocks``: per block in
    decode order (component, coefficient offset); ``ri_blocks``: blocks per
    restart interval (0: none); ``tables``: per component (DC, AC) tables.
    Returns (flat positions, values) of the decoded coefficients."""
    pos, val = [], []
    pos_append, val_append = pos.append, val.append
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
        pos_append(base)
        val_append(pred[c])
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
                pos_append(base + zz[k])
                val_append(fv[pk])
            else:
                p, r, v = _slow(data, p, ac, pk)
                if r < 0:
                    break
                k += r
                pos_append(base + zz[k])
                val_append(v)
            k += 1
    return pos, val


def _slow(data, p, tab, pk):
    """Decode one code whose extra bits do not fit the fast path: returns
    (new bit position, run (-1 for EOB), value)."""
    L = tab.length_l[pk]
    if L == 0:
        raise ValueError("JPEG: invalid Huffman code in the scan")
    sym = tab.symbol_l[pk]
    p += L
    s = sym & 15
    r = sym >> 4
    if sym == 0 and tab.fast_run[pk] < 0:
        return p, -1, 0
    if s == 0:
        return p, r, 0
    bits = ((data[p >> 3] >> (8 - (p & 7))) & 65535) >> (16 - s)
    p += s
    return p, r, bits if bits >= (1 << (s - 1)) else bits - (1 << s) + 1


def decode_jpeg(buf: bytes) -> np.ndarray:
    """Decode a baseline JPEG: (H, W, 3) uint8 RGB, or (H, W) for gray."""
    arr = np.frombuffer(buf, np.uint8)
    if buf[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qt, hts, frame, ri = {}, {}, None, 0
    pos = 2
    out = None
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
        elif marker in (0xC0, 0xC1):  # SOF0 / SOF1
            prec, H, W, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise NotImplementedError(f"JPEG: {prec}-bit samples are not supported")
            if nc not in (1, 3):
                raise NotImplementedError(f"JPEG: {nc} components are not supported")
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15,
                      seg[8 + 3 * k]) for k in range(nc)]
            frame = (H, W, comps)
        elif marker == 0xDD:        # DRI
            (ri,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:        # SOS
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            if out is not None:
                raise NotImplementedError("JPEG: files with several scans are not supported")
            out, used = _decode_frame(frame, qt, hts, ri, seg, arr[pos:])
            pos += used
        # APPn, COM and other segments: skipped
    if out is None:
        raise ValueError("JPEG: no scan")
    return out


def _decode_frame(frame, qt, hts, ri, sos: bytes, rest: np.ndarray):
    H, W, comps = frame
    ns = sos[0]
    if ns != len(comps):
        raise NotImplementedError("JPEG: non-interleaved scans are not supported")
    sel = {sos[1 + 2 * k]: (sos[2 + 2 * k] >> 4, sos[2 + 2 * k] & 15) for k in range(ns)}
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if len(comps) == 1:             # a non-interleaved scan: one block an MCU
        comps = [(comps[0][0], 1, 1, comps[0][3])]
        hmax = vmax = 1
    mcux = -(-W // (8 * hmax))
    mcuy = -(-H // (8 * vmax))
    tables, layout, offset = [], [], 0
    per_mcu = []
    for c, (cid, h, v, tq) in enumerate(comps):
        td, ta = sel[cid]
        tables.append((hts[(0, td)], hts[(1, ta)]))
        bx, by = mcux * h, mcuy * v
        layout.append((offset, bx, by, h, v, tq))
        yy, xx = np.meshgrid(np.arange(v), np.arange(h), indexing="ij")
        per_mcu.append((c, offset, bx, h, v, yy.ravel(), xx.ravel()))
        offset += bx * by * 64
    # block order: MCU by MCU, in each the components' h x v blocks
    my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
    my, mx = my.ravel(), mx.ravel()
    comp_ids, bases = [], []
    for c, off, bx, h, v, yy, xx in per_mcu:
        b = off + ((my[:, None] * v + yy[None]) * bx + mx[:, None] * h + xx[None]) * 64
        bases.append(b)
        comp_ids.append(np.full(b.shape, c))
    bases = np.concatenate(bases, axis=1).ravel().tolist()
    comp_ids = np.concatenate(comp_ids, axis=1).ravel().tolist()
    per = len(bases) // (mcux * mcuy)

    scan, starts, used = _unstuff(rest)
    padded = np.concatenate([scan, np.zeros(4, np.uint8)]).astype(np.int64)
    data = ((padded[:-2] << 16) | (padded[1:-1] << 8) | padded[2:]).tolist()
    pos, val = _decode_scan(data, starts, list(zip(comp_ids, bases)), ri * per, tables)
    coef = np.zeros(offset, np.int64)
    coef[np.asarray(pos, np.int64)] = np.asarray(val, np.int64)

    planes = []
    for off, bx, by, h, v, tq in layout:
        blocks = coef[off:off + bx * by * 64].reshape(-1, 8, 8) * qt[tq].reshape(8, 8)
        pix = _idct_islow(blocks).reshape(by, bx, 8, 8).transpose(0, 2, 1, 3)
        plane = pix.reshape(by * 8, bx * 8)
        # the component's true size, then libjpeg's upsampling to the image
        cw, ch = -(-W * h // hmax), -(-H * v // vmax)
        plane = _upsample(plane[:ch, :cw], hmax // h, vmax // v)
        planes.append(plane[:H, :W])
    if len(planes) == 1:
        return planes[0].astype(np.uint8), used
    return _ycc_to_rgb(*planes), used


def read_jpeg(path: str) -> np.ndarray:
    """Read a baseline JPEG file: (H, W, 3) uint8 RGB, or (H, W) for gray."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
