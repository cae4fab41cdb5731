"""Small encoders for the image kinds that neither cv2 nor PIL writes the
way a test needs: JPEGs from quantized coefficients under any scan script
(sequential files of several scans, interleaved or not; progressive files,
whole or cut short; YCCK), Huffman- or arithmetic-coded (T.81 Annex D, as
libjpeg's jcarith.c codes, with DAC conditioning); lossless JPEGs (Annex H:
predictors 1-7, point transform, restarts, subsampling, one scan or
several); and PNGs of every colour type and bit depth, Adam7-interlaced or
not.  The decoders of cv2 and PIL judge what they write, so an encoder
fault cannot hide a fault of the port's decoders
(``tests/test_torch_jpeg.py``, ``tests/test_torch_readers.py``).
``chip_smoke.py`` writes its HO3D frames with ``encode_jpeg`` (baseline,
progressive, arithmetic sequential and progressive) and
``write_lossless_jpeg``."""
import struct
import zlib

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# libjpeg's jpeg_simple_progression for 3 YCbCr components (jcparam.c):
# (components, Ss, Se, Ah, Al); 10 scans.
SIMPLE_PROGRESSION = [
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0)]

# T.81 Annex K.1 and K.2 quantization tables, natural order.
Q_LUMA = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                   14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                   18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                   49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
Q_CHROMA = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
                    + [99] * 32)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """An Annex K table scaled to ``quality`` as libjpeg scales it."""
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _huffman_table(freq) -> tuple[list, list]:
    """libjpeg's jpeg_gen_optimal_table: (counts of codes of length 1..16,
    symbols), no code longer than 16 bits and none all ones."""
    freq = list(freq) + [1]     # symbol 256 reserves the all-ones code
    size, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if freq[i]]
        c1 = max(live, key=lambda i: (-freq[i], i))
        rest = [i for i in live if i != c1]
        if not rest:
            break
        c2 = max(rest, key=lambda i: (-freq[i], i))
        freq[c1] += freq[c2]
        freq[c2] = 0
        for c in (c1, c2):
            size[c] += 1
            while others[c] >= 0:
                c = others[c]
                size[c] += 1
        while others[c1] >= 0:
            c1 = others[c1]
        others[c1] = c2
    bits = [0] * 33
    for s in size:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [s for L in range(1, 33) for s in range(256) if size[s] == L]
    return bits[1:17], vals


def _category(v: int) -> tuple[int, int]:
    """(size category, extra bits) of a coefficient or difference."""
    s = abs(int(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


class _Scan:
    """The symbols of one scan, recorded before its Huffman tables exist:
    ('dc' | 'ac', symbol, extra bits, n extra bits), ('bits', value, n), or
    ('rst', n) for a restart marker."""

    def __init__(self):
        self.events = []
        self.eobrun = 0
        self.corr = []          # correction bits owed after the pending EOBRUN

    def sym(self, kind, symbol, extra=0, n=0):
        self.events.append((kind, symbol, extra, n))

    def flush_eobrun(self):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            self.sym("ac", n << 4, self.eobrun & ((1 << n) - 1), n)
            self.eobrun = 0
        for b in self.corr:
            self.events.append(("bits", b, 1))
        self.corr = []


def _block_sequential(scan, blk, pred):
    """A sequential block (zigzag ints); returns its DC for the predictor."""
    s, extra = _category(blk[0] - pred)
    scan.sym("dc", s, extra, s)
    run = 0
    last = max((k for k in range(1, 64) if blk[k]), default=0)
    for k in range(1, last + 1):
        if blk[k] == 0:
            run += 1
            continue
        while run > 15:
            scan.sym("ac", 0xF0)
            run -= 16
        s, extra = _category(blk[k])
        scan.sym("ac", (run << 4) | s, extra, s)
        run = 0
    if last < 63:
        scan.sym("ac", 0x00)
    return blk[0]


def _block_ac_first(scan, blk, ss, se, al):
    run = 0
    for k in range(ss, se + 1):
        v = blk[k]
        t = (abs(v) >> al) * (1 if v >= 0 else -1)
        if t == 0:
            run += 1
            continue
        scan.flush_eobrun()
        while run > 15:
            scan.sym("ac", 0xF0)
            run -= 16
        s, extra = _category(t)
        scan.sym("ac", (run << 4) | s, extra, s)
        run = 0
    if run:
        scan.eobrun += 1
        if scan.eobrun == 0x7FFF:
            scan.flush_eobrun()


def _block_ac_refine(scan, blk, ss, se, al):
    """libjpeg's encode_mcu_AC_refine."""
    absv = [abs(blk[k]) >> al for k in range(64)]
    eob = max((k for k in range(ss, se + 1) if absv[k] == 1), default=0)
    run, pending = 0, []
    for k in range(ss, se + 1):
        t = absv[k]
        if t == 0:
            run += 1
            continue
        while run > 15 and k <= eob:
            scan.flush_eobrun()
            scan.sym("ac", 0xF0)
            run -= 16
            for b in pending:
                scan.events.append(("bits", b, 1))
            pending = []
        if t > 1:
            pending.append(t & 1)
            continue
        scan.flush_eobrun()
        scan.sym("ac", (run << 4) | 1, 1 if blk[k] >= 0 else 0, 1)
        for b in pending:
            scan.events.append(("bits", b, 1))
        pending, run = [], 0
    if run or pending:
        scan.eobrun += 1
        scan.corr += pending
        if scan.eobrun == 0x7FFF or len(scan.corr) > 1000 - 63:
            scan.flush_eobrun()


def _scan_units(comps, H, W, idx, unit: int = 8):
    """The MCUs of a scan of components ``idx``, in order, each a list of
    (component, block row, block column): one block a unit over the
    component's own grid for one component, the components' h x v blocks
    an MCU otherwise.  ``unit``: samples a block side (1 for lossless)."""
    hmax = max(x[1] for x in comps)
    vmax = max(x[2] for x in comps)
    if len(idx) == 1:           # non-interleaved: the component's own grid
        c = idx[0]
        _, h, v = comps[c][:3]
        wb = -(-(-(-W * h // hmax)) // unit)
        hb = -(-(-(-H * v // vmax)) // unit)
        return [[(c, y, x)] for y in range(hb) for x in range(wb)]
    mcux, mcuy = -(-W // (unit * hmax)), -(-H // (unit * vmax))
    return [[(c, my * comps[c][2] + dy, mx * comps[c][1] + dx)
             for c in idx for dy in range(comps[c][2]) for dx in range(comps[c][1])]
            for my in range(mcuy) for mx in range(mcux)]


def _scan_events(coefs, comps, H, W, spec, progressive, restart):
    """Record one scan.  ``coefs``: per component (by, bx, 64) zigzag ints
    on the MCU-padded grid; ``comps``: (id, h, v, tq); ``spec``: (component
    indices, Ss, Se, Ah, Al)."""
    idx, ss, se, ah, al = spec
    scan = _Scan()
    units = _scan_units(comps, H, W, idx)
    pred = [0] * len(comps)
    for u, unit in enumerate(units):
        if restart and u and u % restart == 0:
            scan.flush_eobrun()
            scan.events.append(("rst", (u // restart - 1) % 8))
            pred = [0] * len(comps)
        for c, y, x in unit:
            blk = [int(b) for b in coefs[c][y, x]]
            if not progressive:
                pred[c] = _block_sequential(scan, blk, pred[c])
            elif ss == 0 and ah == 0:
                dc = blk[0] >> al
                s, extra = _category(dc - pred[c])
                scan.sym("dc", s, extra, s)
                pred[c] = dc
            elif ss == 0:
                scan.events.append(("bits", (blk[0] >> al) & 1, 1))
            elif ah == 0:
                _block_ac_first(scan, blk, ss, se, al)
            else:
                _block_ac_refine(scan, blk, ss, se, al)
    scan.flush_eobrun()
    return scan.events


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def write_jpeg(coefs, comps, qts, H: int, W: int, script, progressive: bool,
               restart: int = 0, app: bytes = b"", sof: int | None = None) -> bytes:
    """A JPEG from quantized coefficients.  ``coefs``: per component
    (by, bx, 64) ints in natural order on the MCU-padded block grid;
    ``comps``: per component (id, h, v, quantization table index); ``qts``:
    tables (natural order) by index; ``script``: the scans, (component
    indices, Ss, Se, Ah, Al) each; ``restart``: MCUs (blocks in a
    non-interleaved scan) a restart interval; ``app``: marker segments
    after SOI (JFIF, Adobe); ``sof``: the frame marker (SOF0 or SOF2 by
    default, SOF1 allowed).  Each scan gets optimal Huffman tables of its
    own, written before it."""
    zz = [np.asarray(c)[..., ZIGZAG] for c in coefs]
    out = bytearray(b"\xff\xd8" + app)
    for t, q in qts.items():
        out += _segment(0xDB, bytes([t]) + bytes(np.asarray(q)[ZIGZAG].tolist()))
    sof = sof if sof is not None else (0xC2 if progressive else 0xC0)
    out += _segment(sof, struct.pack(">BHHB", 8, H, W, len(comps)) + b"".join(
        bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq in comps))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    for spec in script:
        events = _scan_events(zz, comps, H, W, spec, progressive, restart)
        tables = {}
        for tc, kind in enumerate(("dc", "ac")):
            freq = [0] * 256
            for e in events:
                if e[0] == kind:
                    freq[e[1]] += 1
            if any(freq):
                bits, vals = _huffman_table(freq)
                out += _segment(0xC4, bytes([tc << 4]) + bytes(bits) + bytes(vals))
                codes, code, k = {}, 0, 0
                for length in range(1, 17):
                    for _ in range(bits[length - 1]):
                        codes[vals[k]] = (code, length)
                        code += 1
                        k += 1
                    code <<= 1
                tables[kind] = codes
        idx = spec[0]
        out += _segment(0xDA, bytes([len(idx)]) + b"".join(
            bytes([comps[c][0], 0]) for c in idx) + bytes(spec[1:3])
            + bytes([(spec[3] << 4) | spec[4]]))
        out += _entropy_bytes(events, tables)
    return bytes(out + b"\xff\xd9")


def _entropy_bytes(events, tables) -> bytes:
    out, acc, nbits = bytearray(), 0, 0

    def put(code, length):
        nonlocal acc, nbits
        acc = (acc << length) | code
        nbits += length
        while nbits >= 8:
            nbits -= 8
            byte = (acc >> nbits) & 255
            out.append(byte)
            if byte == 255:
                out.append(0)
        acc &= (1 << nbits) - 1

    def pad():
        if nbits:
            put((1 << (8 - nbits)) - 1, 8 - nbits)

    for e in events:
        if e[0] == "rst":
            pad()
            out.extend((0xFF, 0xD0 + e[1]))
        elif e[0] == "bits":
            put(e[1], e[2])
        else:
            put(*tables[e[0]][e[1]])
            if e[3]:
                put(e[2], e[3])
    pad()
    return bytes(out)


def dct_quantize(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(8 by, 8 bx) samples -> (by, bx, 64) quantized DCT coefficients,
    natural order (a float DCT)."""
    k = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * k[None] + 1) * k[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    h, w = plane.shape
    x = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) - 128.0
    c = np.einsum("ui,abij,vj->abuv", dct, x, dct).reshape(h // 8, w // 8, 64)
    return np.rint(c / q.reshape(64)).astype(np.int64)


def encode_jpeg(img: np.ndarray, sampling, script=None, progressive: bool = False,
                quality: int = 85, restart: int = 0, color: str = "ycc",
                sof: int | None = None, arithmetic: bool = False, dac=None) -> bytes:
    """Encode (H, W) or (H, W, C) uint8 samples.  ``sampling``: per
    component (h, v); ``color``: 'gray', 'ycc' (JFIF YCbCr), 'rgb' (ids
    'R', 'G', 'B', no JFIF), 'cmyk' (Adobe transform 0, samples inverted as
    PIL writes them) or 'ycck' (Adobe transform 2: the inverted CMY as
    YCbCr, K inverted); ``script``: as write_jpeg's, by default one
    interleaved sequential scan; ``arithmetic``: the same coefficients
    arithmetic-coded (write_arith_jpeg, with ``dac``)."""
    x = np.asarray(img, np.float64)
    x = x[..., None] if x.ndim == 2 else x
    H, W = x.shape[:2]
    if color == "ycc":
        r, g, b = np.moveaxis(x, -1, 0)
        x = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                      -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                      0.5 * r - 0.418688 * g - 0.081312 * b + 128], -1)
    elif color == "cmyk":
        x = 255 - x
    elif color == "ycck":
        r, g, b = np.moveaxis(x[..., :3], -1, 0)
        x = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                      -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                      0.5 * r - 0.418688 * g - 0.081312 * b + 128, 255 - x[..., 3]], -1)
    nc = x.shape[-1]
    ids = {"gray": [1], "ycc": [1, 2, 3], "rgb": [82, 71, 66]}.get(color, [1, 2, 3, 4])
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    pw, ph = mcux * 8 * hmax, mcuy * 8 * vmax
    x = np.pad(x, ((0, ph - H), (0, pw - W), (0, 0)), mode="edge")
    qts = {0: quant_table(Q_LUMA, quality), 1: quant_table(Q_CHROMA, quality)}
    comps, coefs = [], []
    for c in range(nc):
        h, v = sampling[c]
        fh, fv = hmax // h, vmax // v
        plane = x[..., c].reshape(ph // fv, fv, pw // fh, fh).mean(axis=(1, 3))
        tq = 1 if color == "ycc" and c else 0
        comps.append((ids[c], h, v, tq))
        coefs.append(dct_quantize(plane, qts[tq]))
    app = b""
    if color in ("ycc", "gray"):
        app = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif color in ("cmyk", "ycck"):
        app = _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([2 * (color == "ycck")]))
    script = script or [(tuple(range(nc)), 0, 63, 0, 0)]
    qts = {t: qts[t] for t in {c[3] for c in comps}}
    if arithmetic:
        return write_arith_jpeg(coefs, comps, qts, H, W, script, progressive, restart, app, dac)
    return write_jpeg(coefs, comps, qts, H, W, script, progressive, restart, app, sof)


# ------------------------------------------------------------ lossless JPEG ---

def _lossless_diffs(x: np.ndarray, predictor: int, init: int, first_rows) -> np.ndarray:
    """T.81 H.1.2.1's differences of one component's samples ``x`` (int64,
    rows x columns): the first sample of a row in ``first_rows`` (the
    scan's first and each restart interval's) is predicted by ``init``, the
    rest of such a row by the sample to its left; in other rows the first
    sample by the one above, the rest by ``predictor`` (1-7).  Each
    difference is taken modulo 2^16 into -32767..32768."""
    d = np.empty_like(x)
    for r in range(x.shape[0]):
        row = x[r]
        if r in first_rows:
            pred = np.concatenate([[init], row[:-1]])
        else:
            a, b, c = row[:-1], x[r - 1, 1:], x[r - 1, :-1]
            p = {1: a, 2: b, 3: c, 4: a + b - c, 5: a + ((b - c) >> 1),
                 6: b + ((a - c) >> 1), 7: (a + b) >> 1}[predictor]
            pred = np.concatenate([[x[r - 1, 0]], p])
        d[r] = (row - pred + 32767) % 65536 - 32767
    return d


def write_lossless_jpeg(planes, sampling=None, predictor: int = 1, al: int = 0,
                        restart_rows: int = 0, app: bytes = b"", ids=None, scans=None,
                        precision: int = 8, sof: int = 0xC3, size=None) -> bytes:
    """A lossless JPEG (T.81 Annex H, Huffman-coded).  ``planes``: per
    component its samples at the component's own size, 0 .. 2^16 - 1;
    ``size``: the image's (H, W), the first plane's by default; ``sampling``: per component
    (h, v), 1 x 1 by default; ``predictor``: the scans' Ss (1-7); ``al``:
    the point transform (samples shifted down by it); ``restart_rows``: MCU
    rows a restart interval (libjpeg-turbo takes only whole rows);
    ``app``: marker segments after SOI; ``ids``: component ids (1, 2, ...
    by default); ``scans``: the component indices of each scan, one
    interleaved scan by default.  Samples past a component's edge in an
    interleaved scan's last MCUs repeat the edge.  Each scan gets an
    optimal Huffman table of its own, written before it."""
    planes = [np.asarray(p, np.int64) for p in planes]
    nc = len(planes)
    sampling = sampling or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    comps = [(ids[c], *sampling[c]) for c in range(nc)]
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    H, W = size or planes[0].shape
    scans = scans or [tuple(range(nc))]
    out = bytearray(b"\xff\xd8" + app)
    out += _segment(sof, struct.pack(">BHHB", precision, H, W, nc) + b"".join(
        bytes([cid, (h << 4) | v, 0]) for cid, h, v in comps))
    for idx in scans:
        units = _scan_units(comps, H, W, idx, unit=1)
        mcux = -(-W // hmax) if len(idx) > 1 else -(-W * comps[idx[0]][1] // hmax)
        restart = restart_rows * mcux
        if restart:
            out += _segment(0xDD, restart.to_bytes(2, "big"))
        diffs = {}
        for c in idx:
            _, h, v = comps[c]
            rows = len(units) // mcux * (v if len(idx) > 1 else 1)
            cols = mcux * (h if len(idx) > 1 else 1)
            x = planes[c] >> al
            x = np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])), mode="edge")
            per = (v if len(idx) > 1 else 1) * (restart_rows or rows)
            diffs[c] = _lossless_diffs(x, predictor, 1 << (precision - al - 1),
                                       set(range(0, rows, per)))
        events = []
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                events.append(("rst", (u // restart - 1) % 8))
            for c, y, x in unit:
                s, extra = _category(int(diffs[c][y, x]))
                events.append(("dc", s, extra, 0 if s == 16 else s))
        freq = [0] * 256
        for e in events:
            if e[0] == "dc":
                freq[e[1]] += 1
        bits, vals = _huffman_table(freq)
        out += _segment(0xC4, bytes([0]) + bytes(bits) + bytes(vals))
        codes, code, k = {}, 0, 0
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                codes[vals[k]] = (code, length)
                code += 1
                k += 1
            code <<= 1
        out += _segment(0xDA, bytes([len(idx)]) + b"".join(
            bytes([comps[c][0], 0]) for c in idx) + bytes([predictor, 0, al]))
        out += _entropy_bytes(events, {"dc": codes})
    return bytes(out + b"\xff\xd9")


# ------------------------------------------------------- arithmetic coding ---

# T.81 Table D.3 (libjpeg's jaricom.c): per state (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS).  State 113, libjpeg's, is the fixed
# probability 0.5 of sign and refinement bits (T.851 Table 5).
_QE = [(0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
       (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
       (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
       (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
       (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
       (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
       (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
       (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
       (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
       (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
       (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
       (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
       (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
       (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
       (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
       (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
       (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
       (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
       (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
       (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
       (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
       (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
       (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
       (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
       (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
       (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
       (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
       (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
       (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
FIXED_BIN = 113


class _ArithEncoder:
    """libjpeg's jcarith.c QM encoder (T.81 D.1): ``encode(stats, i, bit)``
    codes one decision in bin ``stats[i]`` (a state index, MPS in bit 7);
    ``finish()`` flushes (D.1.8) and returns the scan's stuffed bytes."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _flush_stack(self, byte):
        """Emit the pending zero bytes, ``byte`` and the stacked 0xFFs."""
        if byte == 0:
            self.zc += 1
        elif byte >= 0:
            self.out += b"\x00" * self.zc
            self.zc = 0
            self._emit(byte)
        if self.sc:
            self.out += b"\x00" * self.zc
            self.zc = 0
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self):
        if self.buffer >= 0:
            self.out += b"\x00" * self.zc
            self.zc = 0
            self._emit(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, stats, i, val):
        sv = stats[i]
        qe, nlps, nmps, switch = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ (switch << 7) ^ nlps
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nmps
        while True:                 # renormalization and output (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stack(self.buffer)
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._flush_stack(self.buffer)
        if self.c & 0x7FFF800:
            self.out += b"\x00" * self.zc
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _arith_value(enc, stats, s0, x1, v, fixed=None):
    """F.1.4.4.1 (DC, ``fixed`` None: sign in s0 + 1) and F.1.4.4.2 (AC:
    sign in the fixed bin) after the nonzero decision: sign, magnitude
    category (first in s0 + 2 or + 3, then ``x1`` on), magnitude bits
    (14 bins on).  Returns the category's top bit m (0 for |v| = 1)."""
    neg = v < 0
    v = abs(v) - 1
    if fixed is None:
        enc.encode(stats, s0 + 1, int(neg))
        st = s0 + 2 + neg
    else:
        enc.encode(fixed, 0, int(neg))
        st = s0 + 2
    m = 0
    if v:
        enc.encode(stats, st, 1)
        m, v2 = 1, v >> 1
        if fixed is not None and v2:
            enc.encode(stats, st, 1)    # AC: the second decision stays in S0 + 2
            m, v2 = 2, v2 >> 1
            st = x1
        elif fixed is None:
            st = x1
        while v2:
            enc.encode(stats, st, 1)
            m <<= 1
            v2 >>= 1
            st += 1
    enc.encode(stats, st, 0)
    st += 14
    bit = m >> 1
    while bit:
        enc.encode(stats, st, int(bool(bit & v)))
        bit >>= 1
    return m


def _arith_scan(zz, comps, H, W, spec, progressive, restart, tables, dac) -> bytes:
    """One arithmetic-coded scan (T.81 F.1.4, G.1.3; libjpeg's jcarith.c)
    of zigzag coefficients ``zz``: statistics per conditioning table
    (``tables[c]``, the component's DC and AC table), reset with the
    registers at every restart; ``dac``: (L, U) of DC tables and Kx of AC
    tables by table."""
    idx, ss, se, ah, al = spec
    units = _scan_units(comps, H, W, idx)
    fixed = [FIXED_BIN]
    dc_scan = not progressive or (ss == 0 and ah == 0)
    ac_scan = not progressive or ss > 0
    out = bytearray()
    enc = None
    for u, unit in enumerate(units):
        if u == 0 or (restart and u % restart == 0):
            if enc is not None:
                out += enc.finish() + bytes([0xFF, 0xD0 + (u // restart - 1) % 8])
            enc = _ArithEncoder()
            dc_stats = {tables[c][0]: [0] * 64 for c in idx}
            ac_stats = {tables[c][1]: [0] * 256 for c in idx}
            pred = [0] * len(comps)
            ctx = [0] * len(comps)
        for c, y, x in unit:
            blk = [int(b) for b in zz[c][y, x]]
            if dc_scan:
                td = tables[c][0]
                st, L, U = dc_stats[td], *dac.get((0, td), (0, 1))
                dc = blk[0] >> al if progressive else blk[0]
                v = dc - pred[c]
                pred[c] = dc
                enc.encode(st, ctx[c], int(v != 0))
                if v == 0:
                    ctx[c] = 0
                else:
                    m = _arith_value(enc, st, ctx[c], 20, v)
                    sign = 4 * (v < 0)
                    ctx[c] = (0 if m < (1 << L) >> 1 else
                              12 + sign if m > (1 << U) >> 1 else 4 + sign)
            elif ss == 0:
                enc.encode(fixed, 0, (blk[0] >> al) & 1)
            if not ac_scan:
                continue
            ta = tables[c][1]
            st, K = ac_stats[ta], dac.get((1, ta), 5)
            lo, hi = (ss, se) if progressive else (1, 63)
            mag = [abs(b) >> al for b in blk]
            ke = max((k for k in range(lo, hi + 1) if mag[k]), default=0)
            kex = 0
            if progressive and ah:
                kex = max((k for k in range(lo, ke + 1) if abs(blk[k]) >> ah), default=0)
            k = lo
            while k <= ke:
                s0 = 3 * (k - 1)
                if k > kex:
                    enc.encode(st, s0, 0)           # not the end of the block
                while not mag[k]:
                    enc.encode(st, s0 + 1, 0)
                    s0 += 3
                    k += 1
                if progressive and ah and mag[k] > 1:   # a correction bit
                    enc.encode(st, s0 + 2, mag[k] & 1)
                elif progressive and ah:                # newly nonzero
                    enc.encode(st, s0 + 1, 1)
                    enc.encode(fixed, 0, int(blk[k] < 0))
                else:
                    enc.encode(st, s0 + 1, 1)
                    t = mag[k] if blk[k] >= 0 else -mag[k]
                    _arith_value(enc, st, s0, 189 if k <= K else 217, t, fixed)
                k += 1
            if k <= hi:
                enc.encode(st, 3 * (k - 1), 1)      # end of block
    return bytes(out + enc.finish())


def write_arith_jpeg(coefs, comps, qts, H: int, W: int, script, progressive: bool,
                     restart: int = 0, app: bytes = b"", dac=None) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with ``progressive``) from
    quantized coefficients, arguments as write_jpeg's.  The first
    component uses conditioning table 0, the others table 1; ``dac``:
    {(0, table): (L, U), (1, table): Kx}, written as one DAC segment (the
    defaults 0, 1 and 5 otherwise)."""
    dac = dac or {}
    zz = [np.asarray(c)[..., ZIGZAG] for c in coefs]
    tables = [(min(c, 1), min(c, 1)) for c in range(len(comps))]
    out = bytearray(b"\xff\xd8" + app)
    for t, q in qts.items():
        out += _segment(0xDB, bytes([t]) + bytes(np.asarray(q)[ZIGZAG].tolist()))
    out += _segment(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, H, W, len(comps))
                    + b"".join(bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq in comps))
    if dac:
        out += _segment(0xCC, b"".join(
            bytes([(tc << 4) | tb, (val[1] << 4) | val[0] if tc == 0 else val])
            for (tc, tb), val in sorted(dac.items())))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    for spec in script:
        idx = spec[0]
        out += _segment(0xDA, bytes([len(idx)]) + b"".join(
            bytes([comps[c][0], (tables[c][0] << 4) | tables[c][1]]) for c in idx)
            + bytes(spec[1:3]) + bytes([(spec[3] << 4) | spec[4]]))
        out += _arith_scan(zz, comps, H, W, spec, progressive, restart, tables, dac)
    return bytes(out + b"\xff\xd9")


# --------------------------------------------------------------- Adam7 PNG ---

# pass: (x0, y0, dx, dy)
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2)]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w * C) sample values -> (h, stride) bytes at ``depth`` bits."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    h, n = samples.shape
    v = np.pad(samples, ((0, 0), (0, (-n) % per))).reshape(h, -1, per).astype(np.uint8)
    packed = np.zeros(v.shape[:2], np.uint8)
    for k in range(per):
        packed |= v[..., k] << (8 - depth * (k + 1))
    return packed


def _filter_row(ft: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    x = row.astype(np.int64)
    b = prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if ft == 0:
        pred = 0
    elif ft == 1:
        pred = a
    elif ft == 2:
        pred = b
    elif ft == 3:
        pred = (a + b) // 2
    else:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) % 256).astype(np.uint8)


def write_adam7_png(path: str, samples: np.ndarray, depth: int, color_type: int,
                    palette=None, trns: bytes | None = None, interlace: bool = True) -> None:
    """An Adam7-interlaced PNG (one pass, not interlaced, without
    ``interlace``) of any colour type and bit depth.  ``samples``: (H, W)
    or (H, W, C) sample values (palette indices for colour type 3); each
    pass's rows cycle through the five filter types, each pass starting
    from a zero row."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    H, W, C = s.shape
    bpp = max(1, C * depth // 8)
    raw = bytearray()
    row_no = 0
    for x0, y0, dx, dy in ADAM7 if interlace else [(0, 0, 1, 1)]:
        sub = s[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _pack_rows(sub.reshape(sub.shape[0], -1), depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for r in rows:
            ft = row_no % 5
            row_no += 1
            raw.append(ft)
            raw += _filter_row(ft, r, prev, bpp).tobytes()
            prev = r
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0,
                                           int(interlace)))]
    if palette is not None:
        chunks.append(_chunk(b"PLTE", bytes(np.asarray(palette, np.uint8).ravel().tolist())))
    if trns is not None:
        chunks.append(_chunk(b"tRNS", trns))
    # two IDAT chunks: a decoder must join them
    z = zlib.compress(bytes(raw))
    chunks += [_chunk(b"IDAT", z[:len(z) // 2]), _chunk(b"IDAT", z[len(z) // 2:])]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"".join(chunks) + _chunk(b"IEND", b""))


# ------------------------------------------------------ committed fixtures ---

def write_codec_fixtures(out_dir: str) -> dict:
    """Write the codec fixtures that ``chip_smoke.py``'s ``codecs`` phase
    decodes on the card's machine (where there is no cv2, PIL or imageio),
    and ``expected.json``: each file's shape, dtype and the sha256 of what
    the JAX readers' call returns for it (``imageio.imread`` for a colour
    JPEG; ``cv2.imread(path, -1)``, in RGB order for the two Adam7 PNGs that
    ``read_png`` reads, in its own layout for the masks and depth that
    ``imread_unchanged`` reads).  Run on a machine with cv2 and PIL:
    python tests/port_codecs.py tests/data/codecs"""
    import hashlib
    import json
    import os
    import sys

    import cv2
    import imageio.v2 as imageio
    from PIL import Image

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from synthetic_cube import render_cube_rgbd

    os.makedirs(out_dir, exist_ok=True)
    H, W = 480, 640
    K = np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = np.array([[0.8, -0.36, 0.48], [0.6, 0.48, -0.64], [0, 0.8, 0.6]])
    T[:3, 3] = [0.0, 0.0, 0.7]
    rgb, depth, mask = render_cube_rgbd(T, K, H, W, texture="dots")
    rgb = rgb.astype(np.uint8)
    small = rgb[240:368:2, 420:548:2]           # 64 x 64 at the cube's edge
    files = {}

    def jpeg(name, data=None):
        path = os.path.join(out_dir, name)
        if data is not None:
            with open(path, "wb") as f:
                f.write(data)
        files[name] = ("imageio.imread", imageio.imread(path))

    path = os.path.join(out_dir, "progressive_420_rst.jpg")
    cv2.imwrite(path, rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 75,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                                       cv2.IMWRITE_JPEG_RST_INTERVAL, 4,
                                       cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    jpeg("progressive_420_rst.jpg")
    Image.fromarray(small[..., 1]).save(os.path.join(out_dir, "progressive_gray.jpg"),
                                        quality=80, progressive=True)
    jpeg("progressive_gray.jpg")
    jpeg("multiscan_sequential.jpg", encode_jpeg(
        small, [(2, 2), (1, 1), (1, 1)], [((1, 2), 0, 63, 0, 0), ((0,), 0, 63, 0, 0)],
        restart=3))
    jpeg("progressive_smoothed.jpg", encode_jpeg(
        small, [(1, 2), (1, 1), (1, 1)], SIMPLE_PROGRESSION[:6], progressive=True))
    cv2.imwrite(os.path.join(out_dir, "sampling_440.jpg"), small[..., ::-1],
                [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    jpeg("sampling_440.jpg")
    cmyk = np.concatenate([small, small[..., :1] // 3], -1)
    Image.fromarray(cmyk, "CMYK").save(os.path.join(out_dir, "cmyk.jpg"), quality=85)
    jpeg("cmyk.jpg")
    for name, samples, depth_bits, ctype, palette, trns in [
            ("adam7_depth16.png", (depth * 1000).astype(np.uint16)[240:368, 420:548], 16, 0,
             None, None),
            ("adam7_palette_mask.png", (mask[240:368, 420:548] > 0).astype(np.uint8), 1, 3,
             [[0, 0, 0], [255, 255, 255]], bytes([0]))]:
        path = os.path.join(out_dir, name)
        write_adam7_png(path, samples, depth_bits, ctype, palette, trns)
        ref = cv2.imread(path, -1)
        if ref.ndim == 3:
            ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
        files[name] = ("cv2.imread(path, -1), channels in RGB order", ref)
    # arithmetic-coded (4:2:0, a restart each MCU row, DAC conditioning;
    # libjpeg's simple progression) and lossless (predictor 7 with restarts;
    # 4:2:0 at predictor 5 and point transform 2) files, read by imageio
    jpeg("arithmetic_420_rst_dac.jpg", encode_jpeg(
        small, [(2, 2), (1, 1), (1, 1)], restart=4, arithmetic=True,
        dac={(0, 0): (1, 3), (0, 1): (0, 2), (1, 0): 8, (1, 1): 3}))
    jpeg("arithmetic_progressive.jpg", encode_jpeg(
        small, [(2, 2), (1, 1), (1, 1)], SIMPLE_PROGRESSION, progressive=True,
        arithmetic=True))
    jpeg("lossless_pred7_rst.jpg", write_lossless_jpeg(
        [small[..., c] for c in range(3)], predictor=7, restart_rows=16))
    jpeg("lossless_420_pred5_al2.jpg", write_lossless_jpeg(
        [small[..., 0], small[::2, ::2, 1], small[::2, ::2, 2]], [(2, 2), (1, 1), (1, 1)],
        predictor=5, al=2))
    # masks and depth as cv2.imread(-1) returns them to the JAX getters
    # (imread_unchanged): gray + alpha, RGB with tRNS, an XMem-like palette,
    # 16-bit RGB depth with tRNS, and a PNG named .jpg (read by content)
    obj = (mask[240:368:2, 420:548:2] > 0).astype(np.int64)
    d16 = (depth * 1000).astype(np.int64)[240:368:2, 420:548:2]
    for name, samples, depth_bits, ctype, palette, trns in [
            ("mask_gray_alpha.png", np.stack([obj * 200, 255 - obj * 55], -1), 8, 4, None,
             None),
            ("mask_rgb_trns.png", np.stack([obj * 0, obj * 0, 9 - obj * 9], -1), 8, 2, None,
             bytes([0, 0, 0, 0, 0, 9])),
            ("mask_xmem_palette.png", obj * 2, 8, 3, [[0, 0, 0], [128, 0, 0], [0, 128, 0]],
             None),
            ("depth_rgb16_trns.png", np.stack([d16, d16 // 3, d16 % 251], -1), 16, 2, None,
             np.asarray([d16[0, 0], d16[0, 0] // 3, d16[0, 0] % 251], ">u2").tobytes()),
            ("mask_png_named.jpg", obj * 255, 8, 0, None, None)]:
        path = os.path.join(out_dir, name)
        write_adam7_png(path, samples, depth_bits, ctype, palette, trns, interlace=False)
        files[name] = ("cv2.imread(path, -1)", cv2.imread(path, -1))
    expected = {name: {"call": call, "shape": list(a.shape), "dtype": str(a.dtype),
                       "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest(),
                       "bytes": os.path.getsize(os.path.join(out_dir, name))}
                for name, (call, a) in sorted(files.items())}
    with open(os.path.join(out_dir, "expected.json"), "w") as f:
        f.write("{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(v)}"
                                    for k, v in expected.items()) + "\n}\n")
    return expected


if __name__ == "__main__":
    import sys

    write_codec_fixtures(sys.argv[1])
