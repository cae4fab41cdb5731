"""Perspective z-buffer mesh rasterizer on the device: the port's
counterpart of the JAX package's native one (``bundlesdf_tpu/native``'s
``rasterize``, ``native/src/host_runtime.cpp:191-250``), which the texture
bake uses for occlusion.

The rules are the native rasterizer's: pixel centres at integer
coordinates; a face is dropped when any vertex lies nearer than ``znear``,
when all lie beyond ``zfar``, when its pixel bounding box is empty or its
projected area is below 1e-12; a pixel is covered when all three edge
weights are >= 0; depth interpolates 1/z; barycentrics are perspective-
correct; and the nearer face wins a pixel by a strict ``<``, so that on
equal depth the lowest face id wins.  Each f32 expression is evaluated in
the native code's order.

Faces are bucketed by the power-of-two size of their pixel bounding box;
each bucket tests its (faces, B, B) candidate pixels at once.  The z-test
is one ``scatter_reduce(amin)`` over an int64 key that packs the depth's
f32 bits (positive floats order as their bit patterns) above the face id,
which reproduces the tie rule.  No Pallas kernel stands behind the native
rasterizer, so this module is plain torch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

# candidate pixels tested at once, per bucket chunk
_CANDIDATES = 1 << 22
_EMPTY = torch.iinfo(torch.int64).max


def _edge_weights(px, py, ax, ay, bx, by, cx, cy, inv_d):
    """The native rasterizer's edge weights (w1, w2, w3) of pixel (px, py)."""
    w1 = ((bx - px) * (cy - py) - (cx - px) * (by - py)) * inv_d
    w2 = ((cx - px) * (ay - py) - (ax - px) * (cy - py)) * inv_d
    return w1, w2, (1.0 - w1) - w2


def rasterize(verts, faces, K, ob_in_cam, H: int, W: int, znear: float = 0.001,
              zfar: float = 100.0, device=None):
    """Z-buffer rasterize a mesh.  ``verts`` (V, 3) in the object frame and
    ``faces`` (F, 3): tensors (their device is used) or arrays (put on
    ``device``, None = CUDA); ``K`` (3, 3) and ``ob_in_cam`` (4, 4, CV
    convention).  Returns tensors (depth (H, W) f32, 0 where empty; face id
    (H, W) int32, -1 where empty; barycentrics (H, W, 3) f32)."""
    dev = verts.device if torch.is_tensor(verts) else resolve_device(device)
    v = torch.as_tensor(verts, device=dev).to(torch.float32)
    f = torch.as_tensor(faces, device=dev).to(torch.int64).reshape(-1, 3)
    Kf = np.asarray(K, dtype=np.float32)
    T = torch.as_tensor(np.asarray(ob_in_cam, dtype=np.float32), device=dev)
    fx, cx, fy, cy = (float(Kf[0, 0]), float(Kf[0, 2]), float(Kf[1, 1]), float(Kf[1, 2]))

    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    x = T[0, 0] * p0 + T[0, 1] * p1 + T[0, 2] * p2 + T[0, 3]
    y = T[1, 0] * p0 + T[1, 1] * p1 + T[1, 2] * p2 + T[1, 3]
    z = T[2, 0] * p0 + T[2, 1] * p1 + T[2, 2] * p2 + T[2, 3]
    iz = torch.where(z > 1e-8, 1.0 / z, torch.zeros_like(z))
    u = fx * x * iz + cx
    w = fy * y * iz + cy

    a, b, c = f[:, 0], f[:, 1], f[:, 2]
    za, zb, zc = z[a], z[b], z[c]
    ax, ay, bx, by, cx2, cy2 = u[a], w[a], u[b], w[b], u[c], w[c]
    # bounding boxes, clamped in float first so far-off faces cannot overflow
    lo_x = torch.minimum(torch.minimum(ax, bx), cx2).clamp(-1.0, W)
    hi_x = torch.maximum(torch.maximum(ax, bx), cx2).clamp(-1.0, W)
    lo_y = torch.minimum(torch.minimum(ay, by), cy2).clamp(-1.0, H)
    hi_y = torch.maximum(torch.maximum(ay, by), cy2).clamp(-1.0, H)
    x0 = torch.floor(lo_x).to(torch.int64).clamp(min=0)
    x1 = torch.ceil(hi_x).to(torch.int64).clamp(max=W - 1)
    y0 = torch.floor(lo_y).to(torch.int64).clamp(min=0)
    y1 = torch.ceil(hi_y).to(torch.int64).clamp(max=H - 1)
    d = (bx - ax) * (cy2 - ay) - (cx2 - ax) * (by - ay)
    keep = ~((za < znear) | (zb < znear) | (zc < znear))
    keep &= ~((za > zfar) & (zb > zfar) & (zc > zfar))
    keep &= (x0 <= x1) & (y0 <= y1) & (d.abs() >= 1e-12)
    inv_d = 1.0 / d
    iza, izb, izc = 1.0 / za, 1.0 / zb, 1.0 / zc

    zbuf = torch.full((H * W,), _EMPTY, dtype=torch.int64, device=dev)
    sel = torch.nonzero(keep).reshape(-1)
    side = torch.maximum(x1 - x0 + 1, y1 - y0 + 1)[sel]
    cls = torch.ceil(torch.log2(side.to(torch.float64))).to(torch.int64)
    for k in torch.unique(cls).tolist():
        fs_all = sel[cls == k]
        B = 1 << k
        step = max(1, _CANDIDATES // (B * B))
        off = torch.arange(B, device=dev)
        for s in range(0, len(fs_all), step):
            fs = fs_all[s:s + step]
            pxi = x0[fs, None, None] + off[None, None, :]
            pyi = y0[fs, None, None] + off[None, :, None]
            inb = (pxi <= x1[fs, None, None]) & (pyi <= y1[fs, None, None])
            px, py = pxi.to(torch.float32), pyi.to(torch.float32)
            e = [t[fs, None, None] for t in (ax, ay, bx, by, cx2, cy2, inv_d)]
            w1, w2, w3 = _edge_weights(px, py, *e)
            hit = inb & (w1 >= 0) & (w2 >= 0) & (w3 >= 0)
            fi, yy, xx = torch.nonzero(hit, as_tuple=True)
            if fi.numel() == 0:
                continue
            fid = fs[fi]
            izp = (w1[fi, yy, xx] * iza[fid] + w2[fi, yy, xx] * izb[fid]
                   + w3[fi, yy, xx] * izc[fid])
            zbits = (1.0 / izp).view(torch.int32).to(torch.int64)
            key = (zbits << 32) | fid
            pix = pyi[fi, yy, 0] * W + pxi[fi, 0, xx]
            zbuf.scatter_reduce_(0, pix, key, reduce="amin")

    covered = zbuf != _EMPTY
    pix = torch.nonzero(covered).reshape(-1)
    fid = zbuf[pix] & 0xFFFFFFFF
    zval = (zbuf[pix] >> 32).to(torch.int32).view(torch.float32)
    px = (pix % W).to(torch.float32)
    py = (pix // W).to(torch.float32)
    w1, w2, w3 = _edge_weights(px, py, ax[fid], ay[fid], bx[fid], by[fid], cx2[fid],
                               cy2[fid], inv_d[fid])
    izp = w1 * iza[fid] + w2 * izb[fid] + w3 * izc[fid]
    pw1 = w1 * iza[fid] / izp
    pw2 = w2 * izb[fid] / izp
    depth = torch.zeros(H * W, dtype=torch.float32, device=dev)
    face = torch.full((H * W,), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    depth[pix] = zval
    face[pix] = fid.to(torch.int32)
    bary[pix] = torch.stack([pw1, pw2, (1.0 - pw1) - pw2], dim=-1)
    return depth.reshape(H, W), face.reshape(H, W), bary.reshape(H, W, 3)
