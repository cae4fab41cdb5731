"""2D pose and box overlays (port of ``bundlesdf_tpu/viz/draw.py``; the
reference's Utils.py draw_xyz_axis / draw_posed_3d_box, used by
``run_custom --mode draw_pose`` and the dashboard).

The JAX functions draw with ``cv2.line(img, p0, p1, color, thickness)``
under the default 8-connected line type.  ``draw_line`` rasterizes the
same stroke in numpy, after OpenCV's drawing code (drawing.cpp):

  * thickness 1: the integer 8-connected Bresenham walk of
    ``LineIterator`` (left to right);
  * thickness > 1 (``ThickLine``): the segment's rectangle, its half-width
    vector rounded in 16.16 fixed point, filled as a convex polygon
    (``FillConvexPoly``: the outline walked by ``Line2``, then scanlines
    between the two edges stepped in fixed point), and a filled circle of
    radius ``(thickness + 1) // 2`` at each end (``Circle``, midpoint
    walk).

Segments that leave the image are not clipped first as OpenCV clips
them; their pixels inside the image may differ (tests/test_torch_viz.py
states the agreement).  The colours keep the JAX channel order: the JAX
code draws BGR-style tuples into an RGB image (``draw.py:26``), so its x
axis ``(0, 0, 255)`` lands in channel 2; this port does the same.
"""
from __future__ import annotations

import math

import numpy as np

_SHIFT = 16
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


def project_points(pts: np.ndarray, ob_in_cam: np.ndarray, K: np.ndarray):
    pc = pts @ ob_in_cam[:3, :3].T + ob_in_cam[:3, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    u = K[0, 0] * pc[:, 0] / z + K[0, 2]
    v = K[1, 1] * pc[:, 1] / z + K[1, 2]
    return np.stack([u, v], -1), pc[:, 2]


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


class _Canvas:
    """Pixels set by a stroke, collected before one colour write."""

    def __init__(self, H: int, W: int):
        self.H, self.W = H, W
        self.ys: list = []
        self.xs: list = []

    def put(self, x: int, y: int):
        if 0 <= x < self.W and 0 <= y < self.H:
            self.ys.append(y)
            self.xs.append(x)

    def hline(self, y: int, x1: int, x2: int):
        if 0 <= y < self.H:
            x1, x2 = max(x1, 0), min(x2, self.W - 1)
            if x1 <= x2:
                self.ys.extend([y] * (x2 - x1 + 1))
                self.xs.extend(range(x1, x2 + 1))


def _line_int(cv: _Canvas, p0, p1):
    """LineIterator(connectivity 8, left to right) over integer points."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        cv.put(x, y)
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        if vert:
            y += sy
            if step:
                x += sx
        else:
            x += sx
            if step:
                y += sy


def _line_fixed(cv: _Canvas, p1, p2):
    """Line2: an 8-connected walk between 16.16 fixed-point points."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        ystep = _cdiv(dy << _SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _SHIFT
        cv.put((x2 + _HALF) >> _SHIFT, (y2 + _HALF) >> _SHIFT)
        x, y = (x1 + _HALF) >> _SHIFT, y1 + _HALF
        for _ in range(count + 1):
            cv.put(x, y >> _SHIFT)
            x += 1
            y += ystep
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        xstep = _cdiv(dx << _SHIFT, abs(dy) | 1)
        count = (y2 - y1) >> _SHIFT
        cv.put((x2 + _HALF) >> _SHIFT, (y2 + _HALF) >> _SHIFT)
        x, y = x1 + _HALF, (y1 + _HALF) >> _SHIFT
        for _ in range(count + 1):
            cv.put(x >> _SHIFT, y)
            x += xstep
            y += 1


def _fill_convex(cv: _Canvas, v: list):
    """FillConvexPoly of 16.16 fixed-point vertices, 8-connected."""
    n = len(v)
    p0 = v[-1]
    for p in v:
        _line_fixed(cv, p0, p)
        p0 = p
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    ymin = (min(ys) + _HALF) >> _SHIFT
    ymax = (max(ys) + _HALF) >> _SHIFT
    xmin = (min(p[0] for p in v) + _HALF) >> _SHIFT
    xmax = (max(p[0] for p in v) + _HALF) >> _SHIFT
    if xmax < 0 or ymin >= cv.H or xmin >= cv.W:
        return
    ymax = min(ymax, cv.H - 1)
    edge = [{"idx": imin, "di": 1, "x": -_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": n - 1, "x": -_ONE, "dx": 0, "ye": ymin}]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + _HALF) >> _SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            cv.hline(y, (edge[left]["x"] + _HALF) >> _SHIFT,
                     (edge[right]["x"] + _HALF) >> _SHIFT)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _circle_filled(cv: _Canvas, cx: int, cy: int, r: int):
    """Circle(fill=1): horizontal spans of the midpoint walk."""
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        for yy, (xa, xb) in ((cy - dy, (cx - dx, cx + dx)), (cy + dy, (cx - dx, cx + dx)),
                             (cy - dx, (cx - dy, cx + dy)), (cy + dx, (cx - dy, cx + dy))):
            cv.hline(yy, xa, xb)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line_pixels(H: int, W: int, p0, p1, thickness: int = 1):
    """(ys, xs) of the pixels ``cv2.line(img, p0, p1, color, thickness)``
    sets in an H x W image (integer end points, 8-connected)."""
    cv = _Canvas(H, W)
    p0 = (int(p0[0]), int(p0[1]))
    p1 = (int(p1[0]), int(p1[1]))
    if thickness <= 1:
        _line_int(cv, p0, p1)
    else:
        f0 = (p0[0] << _SHIFT, p0[1] << _SHIFT)
        f1 = (p1[0] << _SHIFT, p1[1] << _SHIFT)
        dx = (f0[0] - f1[0]) / _ONE
        dy = (f1[1] - f0[1]) / _ONE
        r = dx * dx + dy * dy
        odd = thickness & 1
        t = thickness << (_SHIFT - 1)
        if abs(r) > np.finfo(np.float64).eps:
            r = (t + odd * _ONE * 0.5) / math.sqrt(r)
            ex, ey = int(np.rint(dy * r)), int(np.rint(dx * r))
            _fill_convex(cv, [(f0[0] + ex, f0[1] + ey), (f0[0] - ex, f0[1] - ey),
                              (f1[0] - ex, f1[1] - ey), (f1[0] + ex, f1[1] + ey)])
        radius = (t + _HALF) >> _SHIFT
        for p in (p0, p1):
            _circle_filled(cv, p[0], p[1], radius)
    return np.asarray(cv.ys, np.int64), np.asarray(cv.xs, np.int64)


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line`` in place on an (H, W, C) image; returns it."""
    ys, xs = line_pixels(img.shape[0], img.shape[1], p0, p1, thickness)
    img[ys, xs] = np.asarray(color, img.dtype)[:img.shape[2]]
    return img


def draw_xyz_axis(color: np.ndarray, ob_in_cam: np.ndarray, K: np.ndarray,
                  scale: float = 0.1, thickness: int = 3) -> np.ndarray:
    """Draw the object coordinate axes (colours as in the JAX package)."""
    pts = np.array([[0, 0, 0], [scale, 0, 0], [0, scale, 0], [0, 0, scale]], float)
    uv, z = project_points(pts, ob_in_cam, K)
    img = np.ascontiguousarray(color.copy())
    if (z <= 0).any():
        return img
    o = tuple(np.round(uv[0]).astype(int))
    for k, c in [(1, (0, 0, 255)), (2, (0, 255, 0)), (3, (255, 0, 0))]:
        p = tuple(np.round(uv[k]).astype(int))
        draw_line(img, o, p, c, thickness)
    return img


def draw_posed_3d_box(color: np.ndarray, ob_in_cam: np.ndarray, K: np.ndarray,
                      bbox: np.ndarray, line_color=(0, 255, 0),
                      thickness: int = 2) -> np.ndarray:
    """bbox: (2, 3) [min_xyz, max_xyz] in object frame."""
    mn, mx = bbox
    corners = np.array([[x, y, z] for x in (mn[0], mx[0])
                        for y in (mn[1], mx[1]) for z in (mn[2], mx[2])])
    uv, z = project_points(corners, ob_in_cam, K)
    img = np.ascontiguousarray(color.copy())
    if (z <= 0).any():
        return img
    uv = np.round(uv).astype(int)
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for a, b in edges:
        draw_line(img, tuple(uv[a]), tuple(uv[b]), line_color, thickness)
    return img
