"""SIFT detect-and-describe in torch, on the images' device: the counterpart
of ``cv2.SIFT_create(nfeatures=2000).detectAndCompute(img, None)``, which
the JAX package's ``SiftMatcher`` runs on the host
(``bundlesdf_tpu/models/matcher.py:182-189``).  The card's machine has no
OpenCV, so each stage of OpenCV's SIFT is written out here and pinned by
experiment against ``cv2`` 5.0 (``tests/test_torch_sift.py``):

  * base: the uint8 image as f32 in [0, 255], upsampled 2x bilinearly
    (``cv2.resize`` INTER_LINEAR: weights 1/4, 3/4, exact in f32), then
    blurred to sigma ``sqrtf(1.6f^2 - 1)``, computed in f32 as OpenCV does;
  * ``round(log2(min side of the base) - 2) + 1`` octaves of 3 + 3 layers,
    each layer the previous one blurred by the increment that brings it to
    1.6 * 2^(i/3); the next octave's base is layer 3 at every other pixel.
    Gaussian kernels have ``round(8 sigma + 1) | 1`` taps, normalized in
    f64 and rounded to f32, with reflect-101 borders (any image size).
    The blur reproduces OpenCV's summation order and fused multiply-adds
    (``gaussian_blur``), so the scale space equals cv2's bit for bit;
  * DoG extrema over the 3 x 3 x 3 neighbourhood (ties count), |v| > 1,
    5 px from the border; up to 5 Newton steps with OpenCV's Cramer solve;
    contrast ``|D^| * 3 >= 0.04`` and the edge test ``tr^2 * 10 < 11^2 det``;
  * orientation: a 36-bin histogram of radius ``round(4.5 s)``, Gaussian
    weights of sigma ``1.5 s``, smoothed by [1, 4, 6, 4, 1] / 16; every
    peak at >= 0.8 of the maximum gives a keypoint, its bin interpolated
    by a parabola, ``angle = 360 - 10 bin``.  Angles use OpenCV's
    vectorised ``fastAtan2`` polynomial, whose fused multiply-adds are
    taken in f64 (bit equal to ``cv2.phase``);
  * duplicates (equal x, y, size, angle) are removed from the keypoints
    sorted by (x, y, -size, angle, -response, -octave), then
    ``retainBest(nfeatures)`` keeps every keypoint whose response reaches
    the nfeatures-th largest.  All coordinates are halved (the base is the
    2x image), and the octave field is OpenCV's packed int;
  * descriptor: 4 x 4 x 8 bins over a window of radius
    ``round(3 s * sqrt(2) * 5 / 2)``, trilinear binning, Gaussian window,
    clipped at 0.2 of the norm, scaled by 512 / norm and rounded to
    integers in [0, 255] (float32 values).

What stays apart from OpenCV: its exp and magnitude differ from torch's by
an ulp, and its histograms sum in another order, so a descriptor element
within ~1e-4 of a rounding edge can flip by 1.  When retainBest trims,
OpenCV leaves its keypoints in ``nth_element`` order; here they keep the
sorted order.

All images of a call share one scale space, and every octave's layers sit
in one flat buffer (``_Pyramid``), so refinement, orientation and
descriptors each run once over the points of all octaves.  Orientation and
descriptor windows are padded to the largest radius of a chunk of points
and masked; ``CHUNK_SAMPLES`` bounds the window samples held at once.
Plain torch, no kernel: the JAX package runs this on the host, so it has
no Pallas source.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

N_LAYERS = 3
SIGMA = 1.6
CONTRAST = 0.04
EDGE = 10.0
INIT_SIGMA = 0.5
IMG_BORDER = 5
MAX_INTERP_STEPS = 5
ORI_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS = 3 * ORI_SIG_FCTR
ORI_PEAK_RATIO = 0.8
DESCR_WIDTH = 4
DESCR_BINS = 8
DESCR_SCL_FCTR = 3.0
DESCR_MAG_THR = 0.2
INT_DESCR_FCTR = 512.0
FLT_EPSILON = float(np.finfo(np.float32).eps)
# Window samples (keypoints x window pixels) held at once by the
# orientation and descriptor passes.
CHUNK_SAMPLES = 1 << 22

_f32 = np.float32
_DEG = _f32(180 / np.pi)
_ATAN_P = [float(_f32(_f32(c) * _DEG)) for c in
           (0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
            -0.04432655554792128)]
_DBL_EPS_F32 = float(_f32(np.finfo(np.float64).eps))


def _f(x) -> float:
    """A Python float rounded to f32, as a C++ float constant."""
    return float(_f32(x))


# ------------------------------------------------------------ scale space
def _reflect101(n: int, r: int) -> list[int]:
    """OpenCV's ``borderInterpolate(p, n, BORDER_REFLECT_101)`` for p in
    [-r, n + r), also where r >= n."""
    out = []
    for p in range(-r, n + r):
        if n == 1:
            out.append(0)
            continue
        while p < 0 or p >= n:
            p = -p if p < 0 else 2 * n - 2 - p
        out.append(p)
    return out


def gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(round(8 sigma + 1) | 1, sigma)`` for f32
    images: computed in f64, normalized, rounded to f32."""
    n = int(round(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _reflect_index(n: int, r: int, device: str) -> torch.Tensor:
    return torch.tensor(_reflect101(n, r), device=device)


def _reflect_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """``x`` reflect-101 padded by r along ``dim``."""
    return x.index_select(dim, _reflect_index(x.shape[dim], r, str(x.device)))


def _row_pass(xp: torch.Tensor, k: list, n: int, fused: bool) -> torch.Tensor:
    """Taps summed left to right along the last dim of the padded f64
    ``xp``: ``s = fma(x_t, k_t, s)``, or ``s = s + round(k_t x_t)`` where
    ``fused`` is False.  ``s`` is f32: an add with an f64 operand computes
    in f64 and rounds into it, one kernel a tap."""
    s = (xp.narrow(-1, 0, n) * k[0]).float()
    for t in range(1, len(k)):
        x = xp.narrow(-1, t, n)
        if fused:
            torch.add(s, x, alpha=k[t], out=s)
        else:
            s += (x * k[t]).float()
    return s


def _col_pass(xp: torch.Tensor, k: list, n: int, fused: bool) -> torch.Tensor:
    """Taps paired about the centre along dim -2 of the padded f32 ``xp``:
    ``s = k_0 x_0``, then ``s = fma(x_i + x_-i, k_i, s)`` (or unfused).
    The pair is summed in f32 and stored in f64, so that the multiply-add
    with it computes in f64."""
    r = len(k) // 2
    s = xp.narrow(-2, r, n) * k[r]
    pair = torch.empty(s.shape, dtype=torch.float64 if fused else s.dtype, device=s.device)
    for i in range(1, r + 1):
        torch.add(xp.narrow(-2, r + i, n), xp.narrow(-2, r - i, n), out=pair)
        if fused:
            torch.add(s, pair, alpha=k[r + i], out=s)
        else:
            s += pair * k[r + i]
    return s


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` of f32 images (..., H, W), bit
    for bit as cv2 5.0 computes it (AVX2 build): the row pass sums the taps
    left to right with fused multiply-adds, the column pass pairs them about
    the centre, ``s = k_0 x_0``, then ``s = fma(x_i + x_-i, k_i, s)``.  The
    vector code runs over 8 columns at a time (the row pass also over a
    final 4); the columns left over take scalar code without fusion.  A
    fused multiply-add of f32 values is an f64 one rounded to f32 (the
    product is exact in f64), the same on every device."""
    k = [float(v) for v in gaussian_kernel(sigma)]
    r = len(k) // 2
    W = x.shape[-1]
    v8 = W - W % 8
    v4 = v8 + 4 if W - v8 >= 4 else v8
    xp = _reflect_pad(x, r, x.ndim - 1).double()
    y = _row_pass(xp.narrow(-1, 0, v4 + 2 * r), k, v4, True) if v4 else None
    if v4 < W:
        tail = _row_pass(xp.narrow(-1, v4, W - v4 + 2 * r), k, W - v4, False)
        y = tail if y is None else torch.cat([y, tail], dim=-1)
    yp = _reflect_pad(y, r, y.ndim - 2)
    H = x.shape[-2]
    out = _col_pass(yp.narrow(-1, 0, v8), k, H, True) if v8 else None
    if v8 < W:
        tail = _col_pass(yp.narrow(-1, v8, W - v8), k, H, False)
        out = tail if out is None else torch.cat([out, tail], dim=-1)
    return out


def _layer_sigmas() -> list[float]:
    """Blur increments of layers 1..5 (OpenCV buildGaussianPyramid)."""
    k = 2.0 ** (1.0 / N_LAYERS)
    sig = [SIGMA]
    for i in range(1, N_LAYERS + 3):
        prev = k ** (i - 1) * SIGMA
        tot = prev * k
        sig.append(math.sqrt(tot * tot - prev * prev))
    return sig


def n_octaves(H: int, W: int) -> int:
    """Octaves of OpenCV's pyramid for an H x W input (2x base)."""
    return int(round(math.log(min(2 * H, 2 * W)) / math.log(2.0) - 2)) + 1


def base_image(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) images in [0, 255] -> the (B, 2H, 2W) blurred 2x base."""
    x = imgs.to(torch.float32)[:, None]
    up = torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear",
                                         align_corners=False)[:, 0]
    s = _f32(SIGMA)
    sig_diff = np.sqrt(np.maximum(s * s - _f32(INIT_SIGMA * INIT_SIGMA * 4), _f32(0.01)))
    return gaussian_blur(up, float(sig_diff))


# ------------------------------------------------------------- fast atan2
def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV's vectorised ``fastAtan2`` in degrees [0, 360) of f32 inputs:
    a 7th-order polynomial of min/max, the multiply-adds fused."""
    p1, p3, p5, p7 = _ATAN_P
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + _DBL_EPS_F32)
    c2 = c * c
    c2d = c2.double()
    a = (c2d * p7 + p5).float()
    a = (c2d * a.double() + p3).float()
    a = (c2d * a.double() + p1).float()
    a = a * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


# ---------------------------------------------------------------- layout
class _Pyramid:
    """Every octave's layers in one flat buffer (``gauss``: 6 Gaussian
    layers an octave; ``dog``: 5 DoG layers), so that the per-point passes
    (refinement, orientation, descriptors) run once over the points of all
    octaves.  Point tensors carry their octave ``o``; ``H``, ``W``,
    ``goff`` and ``doff`` (tensors indexed by octave) give its layer size
    and the octave's start in each buffer."""

    def __init__(self, imgs: torch.Tensor):
        B, H0, W0 = imgs.shape
        dev = imgs.device
        sizes = [(2 * H0, 2 * W0)]
        for _ in range(1, n_octaves(H0, W0)):
            h, w = sizes[-1]
            if h // 2 < 1 or w // 2 < 1:
                break
            sizes.append((h // 2, w // 2))
        L = N_LAYERS + 3
        g_n = [B * L * h * w for h, w in sizes]
        d_n = [B * (L - 1) * h * w for h, w in sizes]
        self.gauss = torch.empty(sum(g_n), device=dev)
        self.dog = torch.empty(sum(d_n), device=dev)
        goff = np.cumsum([0] + g_n[:-1]).tolist()
        doff = np.cumsum([0] + d_n[:-1]).tolist()
        self.sizes = sizes
        self.octaves = []  # (gauss view (B, 6, h, w), dog view (B, 5, h, w))
        base = base_image(imgs)
        for o, (h, w) in enumerate(sizes):
            g = self.gauss.narrow(0, goff[o], g_n[o]).view(B, L, h, w)
            d = self.dog.narrow(0, doff[o], d_n[o]).view(B, L - 1, h, w)
            if o > 0:
                base = self.octaves[-1][0][:, N_LAYERS, :2 * h:2, :2 * w:2]
            g[:, 0] = base
            for i, sig in enumerate(_layer_sigmas()[1:], 1):
                g[:, i] = gaussian_blur(g[:, i - 1], sig)
            torch.sub(g[:, 1:], g[:, :-1], out=d)
            self.octaves.append((g, d))
        self.H, self.W, self.goff, self.doff = (
            torch.tensor(v, dtype=torch.int64, device=dev)
            for v in ([h for h, _ in sizes], [w for _, w in sizes], goff, doff))


def _candidates(dog: torch.Tensor) -> torch.Tensor:
    """(M, 4) [b, layer, r, c] DoG extrema of layers 1..3 of one octave:
    |v| > threshold and >= (<=) all 26 neighbours, at least IMG_BORDER from
    the edge."""
    B, L, H, W = dog.shape
    thr = math.floor(0.5 * CONTRAST / N_LAYERS * 255)
    d5 = dog[:, None]
    mx = torch.nn.functional.max_pool3d(d5, 3, stride=1)[:, 0]
    mn = -torch.nn.functional.max_pool3d(-d5, 3, stride=1)[:, 0]
    v = dog[:, 1:L - 1, 1:H - 1, 1:W - 1]
    ok = (v.abs() > thr) & (((v > 0) & (v >= mx)) | ((v <= 0) & (v <= mn)))
    e = IMG_BORDER - 1
    ok[..., :e, :] = False
    ok[..., H - 2 - e:, :] = False
    ok[..., :, :e] = False
    ok[..., :, W - 2 - e:] = False
    idx = torch.nonzero(ok)
    idx[:, 1:] += 1
    return idx


def _det3(a):
    return (a[0][0] * (a[1][1] * a[2][2] - a[2][1] * a[1][2])
            - a[0][1] * (a[1][0] * a[2][2] - a[2][0] * a[1][2])
            + a[0][2] * (a[1][0] * a[2][1] - a[2][0] * a[1][1]))


def _solve3(a, b):
    """OpenCV's ``Matx33f::solve(DECOMP_LU)``: Cramer's rule, zeros when the
    determinant is 0."""
    d = _det3(a)
    sing = d == 0
    d = 1.0 / torch.where(sing, torch.ones_like(d), d)
    x0 = d * (b[0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
              - a[0][1] * (b[1] * a[2][2] - a[1][2] * b[2])
              + a[0][2] * (b[1] * a[2][1] - a[1][1] * b[2]))
    x1 = d * (a[0][0] * (b[1] * a[2][2] - a[1][2] * b[2])
              - b[0] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
              + a[0][2] * (a[1][0] * b[2] - b[1] * a[2][0]))
    x2 = d * (a[0][0] * (a[1][1] * b[2] - b[1] * a[2][1])
              - a[0][1] * (a[1][0] * b[2] - b[1] * a[2][0])
              + b[0] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))
    z = torch.zeros_like(x0)
    return [torch.where(sing, z, x) for x in (x0, x1, x2)]


_N27 = torch.tensor([(dl, dr, dc) for dl in (-1, 0, 1) for dr in (-1, 0, 1)
                     for dc in (-1, 0, 1)])


def _derivs(pyr: _Pyramid, o, b, l, r, c):
    """Value, gradient and Hessian of the DoG at integer points (OpenCV
    adjustLocalExtrema's finite differences, scaled to [0, 1] images): the
    3 x 3 x 3 neighbourhood in one gather."""
    H, W = pyr.H[o], pyr.W[o]
    n27 = _N27.to(b.device)
    at0 = pyr.doff[o] + ((b * (N_LAYERS + 2) + l) * H + r) * W + c
    offs = (n27[:, 0] * (H * W)[:, None] + n27[:, 1] * W[:, None] + n27[:, 2])
    P = pyr.dog[at0[:, None] + offs]

    def at(dl, dr, dc):
        return P[:, (dl + 1) * 9 + (dr + 1) * 3 + dc + 1]

    img_scale = _f(1.0 / 255)
    ds = _f(img_scale * 0.5)
    cs = _f(img_scale * 0.25)
    v = at(0, 0, 0)
    dD = [(at(0, 0, 1) - at(0, 0, -1)) * ds,
          (at(0, 1, 0) - at(0, -1, 0)) * ds,
          (at(1, 0, 0) - at(-1, 0, 0)) * ds]
    v2 = v * 2
    dxx = (at(0, 0, 1) + at(0, 0, -1) - v2) * img_scale
    dyy = (at(0, 1, 0) + at(0, -1, 0) - v2) * img_scale
    dss = (at(1, 0, 0) + at(-1, 0, 0) - v2) * img_scale
    dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * cs
    dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) * cs
    dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) * cs
    Hm = [[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]]
    return v, dD, Hm


def _refine(pyr: _Pyramid, cand: torch.Tensor):
    """OpenCV adjustLocalExtrema over the candidates of every octave at
    once; ``cand`` is (M, 5) [o, b, layer, r, c].  Returns the survivors'
    (o, b, layer, r, c) and (xc, xr, xi, contrast)."""
    o, b, l, r, c = cand.unbind(1)
    n = b.shape[0]
    dev = b.device
    H, W = pyr.H[o], pyr.W[o]
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    xs = [torch.zeros(n, device=dev) for _ in range(3)]  # xc, xr, xi
    big = _f((2 ** 31 - 1) // 3)
    for _ in range(MAX_INTERP_STEPS):
        act = alive & ~done
        _, dD, Hm = _derivs(pyr, o, b, l, r, c)
        X = _solve3(Hm, dD)
        xi, xr, xc = -X[2], -X[1], -X[0]
        conv = (xi.abs() < 0.5) & (xr.abs() < 0.5) & (xc.abs() < 0.5)
        fin = act & conv
        xs = [torch.where(fin, new, old) for new, old in zip((xc, xr, xi), xs)]
        done = done | fin
        mv = act & ~conv
        huge = (xi.abs() > big) | (xr.abs() > big) | (xc.abs() > big)
        alive = alive & ~(mv & huge)
        mv = mv & ~huge

        def step(t):
            return torch.round(torch.where(mv, t, torch.zeros_like(t))).long()

        c = c + step(xc)
        r = r + step(xr)
        l = l + step(xi)
        out = ((l < 1) | (l > N_LAYERS) | (c < IMG_BORDER) | (c >= W - IMG_BORDER)
               | (r < IMG_BORDER) | (r >= H - IMG_BORDER))
        alive = alive & ~(mv & out)
        # keep the indices of the rejected in range for the next gather
        l = l.clamp(1, N_LAYERS)
        r = torch.minimum(r.clamp(min=1), H - 2)
        c = torch.minimum(c.clamp(min=1), W - 2)
    keep = alive & done
    o, b, l, r, c = o[keep], b[keep], l[keep], r[keep], c[keep]
    xc, xr, xi = (x[keep] for x in xs)
    v, dD, Hm = _derivs(pyr, o, b, l, r, c)
    img_scale = _f(1.0 / 255)
    t = dD[0] * xc
    t = t + dD[1] * xr
    t = t + dD[2] * xi
    contr = v * img_scale + t * 0.5
    ok = (contr.abs() * N_LAYERS) >= _f(CONTRAST)
    dxx, dyy, dxy = Hm[0][0], Hm[1][1], Hm[0][1]
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    ok = ok & (det > 0) & ~(tr * tr * _f(EDGE) >= _f((EDGE + 1) * (EDGE + 1)) * det)
    return (o[ok], b[ok], l[ok], r[ok], c[ok]), (xc[ok], xr[ok], xi[ok], contr[ok])


# ------------------------------------------------------------ orientation
def _window(radius: int, device):
    ar = torch.arange(-radius, radius + 1, device=device)
    i, j = torch.meshgrid(ar, ar, indexing="ij")
    return i.reshape(-1), j.reshape(-1)


def _chunks(radius: torch.Tensor):
    """Point order by falling radius, cut into chunks of at most
    CHUNK_SAMPLES window samples: (indices, the chunk's radius) pairs."""
    order = torch.argsort(radius, descending=True, stable=True)
    rad = radius[order].tolist()
    s, M = 0, len(rad)
    while s < M:
        R = rad[s]
        per = max(1, CHUNK_SAMPLES // (2 * R + 1) ** 2)
        yield order[s:s + per], R
        s += per


def _gradients(pyr: _Pyramid, o, b, l, y, x):
    """(dx, dy) of Gaussian layer l at integer pixels (y, x) of points' own
    octaves (OpenCV: dx = I(y, x+1) - I(y, x-1), dy = I(y-1, x) - I(y+1, x))."""
    H, W = pyr.H[o][:, None], pyr.W[o][:, None]
    at = pyr.goff[o][:, None] + ((b * (N_LAYERS + 3) + l)[:, None] * H + y) * W + x
    g = pyr.gauss
    return g[at + 1] - g[at - 1], g[at - W] - g[at + W]


def _orientation_hist(pyr: _Pyramid, o, b, l, r, c, scl: torch.Tensor):
    """(M, 36) smoothed orientation histograms (OpenCV calcOrientationHist)
    at integer points, scale ``scl`` in octave units."""
    dev = b.device
    n = ORI_BINS
    rad = torch.round(_f(ORI_RADIUS) * scl).long()
    sig = _f(ORI_SIG_FCTR) * scl
    expf_scale = -1.0 / (2.0 * sig * sig)
    t = torch.zeros((b.shape[0], n), device=dev)
    H, W = pyr.H[o], pyr.W[o]
    for idx, R in _chunks(rad):
        wi, wj = _window(R, dev)
        y = r[idx, None] + wi
        x = c[idx, None] + wj
        Hk, Wk, rk = H[idx, None], W[idx, None], rad[idx, None]
        m = ((wi.abs() <= rk) & (wj.abs() <= rk)
             & (y > 0) & (y < Hk - 1) & (x > 0) & (x < Wk - 1))
        y = torch.minimum(y.clamp(min=1), Hk - 2)
        x = torch.minimum(x.clamp(min=1), Wk - 2)
        dx, dy = _gradients(pyr, o[idx], b[idx], l[idx], y, x)
        w = torch.exp((wi * wi + wj * wj).float() * expf_scale[idx, None])
        ori = fast_atan2(dy, dx)
        mag = torch.sqrt(dx * dx + dy * dy)
        bins = torch.round(_f(n / 360.0) * ori).long()
        bins = torch.where(bins >= n, bins - n, bins)
        bins = torch.where(bins < 0, bins + n, bins)
        val = torch.where(m, w * mag, torch.zeros_like(mag))
        k = idx.shape[0]
        rows = torch.arange(k, device=dev)[:, None] * n
        h = torch.zeros(k * n, device=dev).index_add_(0, (rows + bins).reshape(-1),
                                                      val.reshape(-1))
        t[idx] = h.reshape(k, n)
    tm1, tp1 = t.roll(1, 1), t.roll(-1, 1)
    tm2, tp2 = t.roll(2, 1), t.roll(-2, 1)
    return (tm2 + tp2) * _f(1 / 16) + (tm1 + tp1) * _f(4 / 16) + t * _f(6 / 16)


def _peaks(hist: torch.Tensor):
    """(keypoint row, angle) of every orientation peak (OpenCV's loop over
    the histogram after calcOrientationHist)."""
    n = hist.shape[1]
    omax = hist.amax(dim=1, keepdim=True)
    thr = omax * _f(ORI_PEAK_RATIO)
    hl, hr = hist.roll(1, 1), hist.roll(-1, 1)
    pk = (hist > hl) & (hist > hr) & (hist >= thr)
    row, j = torch.nonzero(pk, as_tuple=True)
    hj, hlj, hrj = hist[row, j], hl[row, j], hr[row, j]
    bn = j.float() + 0.5 * (hlj - hrj) / (hlj - 2 * hj + hrj)
    bn = torch.where(bn < 0, n + bn, torch.where(bn >= n, bn - n, bn))
    ang = 360.0 - _f(360.0 / n) * bn
    ang = torch.where((ang - 360.0).abs() < FLT_EPSILON, torch.zeros_like(ang), ang)
    return row, ang


# ------------------------------------------------------------- descriptor
def _descriptors(pyr: _Pyramid, o, b, l, ptf: torch.Tensor, angle: torch.Tensor,
                 scl: torch.Tensor) -> torch.Tensor:
    """(M, 128) descriptors (OpenCV calcSIFTDescriptor) at sub-pixel points
    ``ptf`` (octave units)."""
    dev = b.device
    d, n = DESCR_WIDTH, DESCR_BINS
    M = b.shape[0]
    ori = 360.0 - angle
    ori = torch.where((ori - 360.0).abs() < FLT_EPSILON, torch.zeros_like(ori), ori)
    px = torch.round(ptf[:, 0]).long()
    py = torch.round(ptf[:, 1]).long()
    rad_f = _f(np.pi / 180)
    cos_t = torch.cos(ori * rad_f)
    sin_t = torch.sin(ori * rad_f)
    hist_width = _f(DESCR_SCL_FCTR) * scl
    H, W = pyr.H[o], pyr.W[o]
    radius = torch.round(hist_width * _f(1.4142135623730951) * float(d + 1) * 0.5).long()
    diag = torch.sqrt((W * W + H * H).double()).long()
    radius = torch.minimum(radius, diag)
    cos_t = cos_t / hist_width
    sin_t = sin_t / hist_width
    hl = (d + 2) * (d + 2) * (n + 2)
    out = torch.zeros((M, d * d * n), device=dev)
    offs = (0, 1, n + 2, n + 3, (d + 2) * (n + 2), (d + 2) * (n + 2) + 1,
            (d + 3) * (n + 2), (d + 3) * (n + 2) + 1)
    for idx, R in _chunks(radius):
        wi, wj = _window(R, dev)
        wif, wjf = wi.float(), wj.float()
        ct, st = cos_t[idx, None], sin_t[idx, None]
        c_rot = wjf * ct - wif * st
        r_rot = wjf * st + wif * ct
        rbin = r_rot + float(d // 2) - 0.5
        cbin = c_rot + float(d // 2) - 0.5
        y = py[idx, None] + wi
        x = px[idx, None] + wj
        Hk, Wk, rr = H[idx, None], W[idx, None], radius[idx, None]
        m = ((wi.abs() <= rr) & (wj.abs() <= rr) & (rbin > -1) & (rbin < d)
             & (cbin > -1) & (cbin < d) & (y > 0) & (y < Hk - 1) & (x > 0) & (x < Wk - 1))
        y = torch.minimum(y.clamp(min=1), Hk - 2)
        x = torch.minimum(x.clamp(min=1), Wk - 2)
        dx, dy = _gradients(pyr, o[idx], b[idx], l[idx], y, x)
        ang = fast_atan2(dy, dx)
        mag = torch.sqrt(dx * dx + dy * dy)
        w = torch.exp((c_rot * c_rot + r_rot * r_rot) * _f(-1.0 / (d * d * 0.5)))
        obin = (ang - ori[idx, None]) * _f(n / 360.0)
        mag = torch.where(m, mag * w, torch.zeros_like(mag))
        r0, c0, o0 = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
        rbin, cbin, obin = rbin - r0, cbin - c0, obin - o0
        r0 = r0.long().clamp(-1, d - 1)
        c0 = c0.long().clamp(-1, d - 1)
        o0 = o0.long()
        o0 = torch.where(o0 < 0, o0 + n, o0)
        o0 = torch.where(o0 >= n, o0 - n, o0)
        v_r1 = mag * rbin
        v_r0 = mag - v_r1
        v_rc11 = v_r1 * cbin
        v_rc10 = v_r1 - v_rc11
        v_rc01 = v_r0 * cbin
        v_rc00 = v_r0 - v_rc01
        v111 = v_rc11 * obin
        v110 = v_rc11 - v111
        v101 = v_rc10 * obin
        v100 = v_rc10 - v101
        v011 = v_rc01 * obin
        v010 = v_rc01 - v011
        v001 = v_rc00 * obin
        v000 = v_rc00 - v001
        k = idx.shape[0]
        hidx = (torch.arange(k, device=dev)[:, None] * hl
                + ((r0 + 1) * (d + 2) + c0 + 1) * (n + 2) + o0)
        hist = torch.zeros(k * hl, device=dev)
        for off, v in zip(offs, (v000, v001, v010, v011, v100, v101, v110, v111)):
            hist.index_add_(0, (hidx + off).reshape(-1), v.reshape(-1))
        hist = hist.reshape(k, d + 2, d + 2, n + 2)[:, 1:d + 1, 1:d + 1]
        raw = hist[..., :n].clone()
        raw[..., 0] += hist[..., n]
        raw[..., 1] += hist[..., n + 1]
        out[idx] = raw.reshape(k, d * d * n)
    nrm2 = (out * out).sum(dim=1, keepdim=True)
    thr = torch.sqrt(nrm2) * _f(DESCR_MAG_THR)
    out = torch.minimum(out, thr)
    nrm2 = (out * out).sum(dim=1, keepdim=True)
    scale = _f(INT_DESCR_FCTR) / torch.clamp(torch.sqrt(nrm2), min=FLT_EPSILON)
    return torch.round(out * scale).clamp(0, 255)


# ------------------------------------------------------------- the filter
def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting by ``keys[0]`` first, then ``keys[1]``, ..."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        o = torch.sort(k[perm], stable=True).indices
        perm = perm[o]
    return perm


def detect_and_compute(imgs: torch.Tensor, nfeatures: int = 2000) -> dict:
    """SIFT keypoints and descriptors of (B, H, W) images in [0, 255] (uint8
    or integer-valued floats), on the images' device.

    Returns a dict of tensors padded to N, the most keypoints of an image:
    ``pt`` (B, N, 2) [x, y] pixels, ``size``, ``angle``, ``response``
    (B, N) f32, ``octave`` (B, N) int32 packed as OpenCV's, ``desc``
    (B, N, 128) integer-valued f32, ``valid`` (B, N) and ``count`` (B,)."""
    B = imgs.shape[0]
    dev = imgs.device
    pyr = _Pyramid(imgs)
    cand = []
    for o, (h, w) in enumerate(pyr.sizes):
        if h > 2 * IMG_BORDER and w > 2 * IMG_BORDER:
            c = _candidates(pyr.octaves[o][1])
            cand.append(torch.cat([torch.full_like(c[:, :1], o), c], dim=1))
    cand = torch.cat(cand) if cand else torch.zeros((0, 5), dtype=torch.int64, device=dev)
    (o, b, l, r, c), (xc, xr, xi, contr) = _refine(pyr, cand)
    del pyr.dog, pyr.octaves  # the DoG is not read again
    if b.numel() == 0:
        return _empty(B, dev)
    pow2 = torch.pow(2.0, o.float())
    size = (_f(SIGMA) * torch.pow(2.0, (l.float() + xi) / N_LAYERS)) * pow2 * 2.0
    scl = size * 0.5 / pow2
    row, ang = _peaks(_orientation_hist(pyr, o, b, l, r, c, scl))
    ptf_x, ptf_y = c.float() + xc, r.float() + xr
    octv = o + (l << 8) + (torch.round((xi.double() + 0.5) * 255).long() << 16)
    kp = dict(o=o[row], b=b[row], l=l[row], x=(ptf_x * pow2)[row], y=(ptf_y * pow2)[row],
              size=size[row], angle=ang, response=contr[row].abs(), octave=octv[row],
              ptf_x=ptf_x[row], ptf_y=ptf_y[row], scl=scl[row])
    # removeDuplicatedSorted, per image
    perm = _lexsort([kp["b"], kp["x"], kp["y"], -kp["size"], kp["angle"],
                     -kp["response"], -kp["octave"]])
    kp = {k: v[perm] for k, v in kp.items()}
    same = torch.ones_like(kp["b"], dtype=torch.bool)
    for k in ("b", "x", "y", "size", "angle"):
        same[1:] &= kp[k][1:] == kp[k][:-1]
    same[0] = False
    kp = {k: v[~same] for k, v in kp.items()}
    # retainBest(nfeatures): the nfeatures-th largest response of an image
    # is its bar, and every keypoint at or above it stays
    counts = torch.bincount(kp["b"], minlength=B)
    if nfeatures > 0 and int(counts.max()) > nfeatures:
        resp_sorted = kp["response"][_lexsort([kp["b"], -kp["response"]])]
        starts = torch.cumsum(counts, 0) - counts
        bar_idx = (starts + nfeatures - 1).clamp(max=resp_sorted.numel() - 1)
        bar = torch.where(counts > nfeatures, resp_sorted[bar_idx], -1.0)
        keep = kp["response"] >= bar[kp["b"]]
        kp = {k: v[keep] for k, v in kp.items()}
    desc = _descriptors(pyr, kp["o"], kp["b"], kp["l"],
                        torch.stack([kp["ptf_x"], kp["ptf_y"]], dim=1), kp["angle"], kp["scl"])
    # the 2x base: every coordinate and size halves; octave o -> o - 1
    octave = ((kp["octave"] & ~255) | ((kp["o"] - 1) & 255)).to(torch.int32)
    return _pad(B, kp["b"], dict(
        pt=torch.stack([kp["x"] * 0.5, kp["y"] * 0.5], dim=1),
        size=kp["size"] * 0.5, angle=kp["angle"], response=kp["response"],
        octave=octave, desc=desc))


def _empty(B: int, dev) -> dict:
    z = torch.zeros((B, 0), device=dev)
    return dict(pt=torch.zeros((B, 0, 2), device=dev), size=z, angle=z, response=z,
                octave=torch.zeros((B, 0), dtype=torch.int32, device=dev),
                desc=torch.zeros((B, 0, 128), device=dev),
                valid=torch.zeros((B, 0), dtype=torch.bool, device=dev),
                count=torch.zeros(B, dtype=torch.int64, device=dev))


def _pad(B: int, b: torch.Tensor, vals: dict) -> dict:
    """Scatter per-keypoint rows (grouped by image ``b``, in order) into
    (B, N, ...) tensors with a validity mask."""
    dev = b.device
    counts = torch.bincount(b, minlength=B)
    N = int(counts.max()) if b.numel() else 0
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(b.shape[0], device=dev) - starts[b]
    out = {}
    for k, v in vals.items():
        t = torch.zeros((B, N) + v.shape[1:], dtype=v.dtype, device=dev)
        t[b, slot] = v
        out[k] = t
    valid = torch.zeros((B, N), dtype=torch.bool, device=dev)
    valid[b, slot] = True
    out["valid"] = valid
    out["count"] = counts
    return out
