"""Small encoders for the image kinds that neither cv2 nor PIL writes the
way a test needs: JPEGs from quantized coefficients under any scan script
(sequential files of several scans, interleaved or not; progressive files,
whole or cut short; YCCK), and Adam7-interlaced PNGs of every colour type
and bit depth.  The decoders of cv2 and PIL judge what they write, so an
encoder fault cannot hide a fault of the port's decoders
(``tests/test_torch_jpeg.py``, ``tests/test_torch_readers.py``).
``chip_smoke.py`` writes its HO3D frames with ``encode_jpeg``, baseline and
progressive."""
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


def _scan_events(coefs, comps, H, W, spec, progressive, restart):
    """Record one scan.  ``coefs``: per component (by, bx, 64) zigzag ints
    on the MCU-padded grid; ``comps``: (id, h, v, tq); ``spec``: (component
    indices, Ss, Se, Ah, Al)."""
    idx, ss, se, ah, al = spec
    hmax = max(x[1] for x in comps)
    vmax = max(x[2] for x in comps)
    scan = _Scan()
    if len(idx) == 1:           # non-interleaved: the component's own grid
        c = idx[0]
        _, h, v, _ = comps[c]
        wb = -(-(-(-W * h // hmax)) // 8)
        hb = -(-(-(-H * v // vmax)) // 8)
        units = [[(c, y, x)] for y in range(hb) for x in range(wb)]
    else:
        mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
        units = [[(c, my * comps[c][2] + dy, mx * comps[c][1] + dx)
                  for c in idx for dy in range(comps[c][2]) for dx in range(comps[c][1])]
                 for my in range(mcuy) for mx in range(mcux)]
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
                sof: int | None = None) -> bytes:
    """Encode (H, W) or (H, W, C) uint8 samples.  ``sampling``: per
    component (h, v); ``color``: 'gray', 'ycc' (JFIF YCbCr), 'rgb' (ids
    'R', 'G', 'B', no JFIF), 'cmyk' (Adobe transform 0, samples inverted as
    PIL writes them) or 'ycck' (Adobe transform 2: the inverted CMY as
    YCbCr, K inverted); ``script``: as write_jpeg's, by default one
    interleaved sequential scan."""
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
    return write_jpeg(coefs, comps, {t: qts[t] for t in {c[3] for c in comps}}, H, W,
                      script, progressive, restart, app, sof)


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
                    palette=None, trns: bytes | None = None) -> None:
    """An Adam7-interlaced PNG.  ``samples``: (H, W) or (H, W, C) sample
    values (palette indices for colour type 3); each pass's rows cycle
    through the five filter types, each pass starting from a zero row."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    H, W, C = s.shape
    bpp = max(1, C * depth // 8)
    raw = bytearray()
    row_no = 0
    for x0, y0, dx, dy in ADAM7:
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
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0, 1))]
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
    the JAX readers' call returns for it (``imageio.imread`` for a JPEG,
    ``cv2.imread(path, -1)`` in RGB order for a PNG).  Run on a machine with
    cv2 and PIL:  python tests/port_codecs.py tests/data/codecs"""
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
