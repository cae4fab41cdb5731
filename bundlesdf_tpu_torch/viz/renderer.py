"""Mesh previews (port of ``bundlesdf_tpu/viz/renderer.py``), in torch on
the caller's device: the point splat ``render_mesh_splat`` and the exact
triangle rasterizer ``rasterize_mesh``, which keeps the JAX signature over
``ops/raster.py::rasterize`` (the counterpart of the native rasterizer that
the JAX function calls when it is built).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.mesh import Mesh


def render_mesh_splat(mesh: Mesh, ob_in_cam: np.ndarray, K: np.ndarray,
                      H: int, W: int, n_points: int = 200000, device=None):
    """Z-buffered splat of the mesh's surface samples (``sample_surface(n,
    seed=0)`` on the host, as in JAX), or of its vertices when it has vertex
    colours.  Returns (color (H, W, 3) uint8, depth (H, W) float64; 0 where
    nothing lands).  ``device``: None = CUDA.

    The JAX code writes ``color[lin[vis]] = cols[vis]``; where several
    visible points hit one pixel numpy keeps the last of them.  A device
    scatter keeps an arbitrary one, so each pixel takes the largest index
    of its visible points (``scatter_reduce`` amax), then gathers."""
    dev = resolve_device(device)
    pts = mesh.sample_surface(n_points)
    if mesh.vertex_colors is not None:
        pts = mesh.vertices
        cols = torch.as_tensor(np.asarray(mesh.vertex_colors, np.uint8), device=dev)
    else:
        cols = torch.full((len(pts), 3), 180, dtype=torch.uint8, device=dev)
    T = torch.as_tensor(np.asarray(ob_in_cam, np.float64), device=dev)
    fx, fy, cx, cy = (float(K[0][0]), float(K[1][1]), float(K[0][2]), float(K[1][2]))
    pc = torch.as_tensor(np.asarray(pts, np.float64), device=dev) @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    zc = torch.clamp(z, min=1e-6)
    u = torch.round(fx * pc[:, 0] / zc + cx).long()
    v = torch.round(fy * pc[:, 1] / zc + cy).long()
    ok = (z > 1e-6) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    idx = torch.nonzero(ok).squeeze(1)
    lin = v[idx] * W + u[idx]
    zk = z[idx]
    depth = torch.full((H * W,), float("inf"), dtype=torch.float64, device=dev)
    depth.scatter_reduce_(0, lin, zk, reduce="amin")
    vis = depth[lin] >= zk - 1e-6
    last = torch.full((H * W,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, lin[vis], idx[vis], reduce="amax")
    hit = last >= 0
    color = torch.zeros((H * W, 3), dtype=torch.uint8, device=dev)
    color[hit] = cols[last[hit]]
    depth[torch.isinf(depth)] = 0.0
    return (color.reshape(H, W, 3).cpu().numpy(),
            depth.reshape(H, W).cpu().numpy())


def rasterize_mesh(mesh: Mesh, ob_in_cam: np.ndarray, K: np.ndarray, H: int, W: int,
                   device=None):
    """Exact triangle rasterization (z-buffer) of ``mesh`` on ``device``
    (None = CUDA).  Returns host arrays (depth (H, W) float64, 0 where
    empty; face_id (H, W) int64, -1 where empty), as the JAX function."""
    from ..ops import raster

    depth, face_id, _ = raster.rasterize(mesh.vertices, mesh.faces, K, ob_in_cam, H, W,
                                         device=device)
    return (depth.cpu().numpy().astype(np.float64),
            face_id.cpu().numpy().astype(np.int64))
