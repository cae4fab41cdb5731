"""Headless tracking dashboard (port of ``bundlesdf_tpu/viz/gui.py:17-47``,
the JAX package's replacement for the reference's dearpygui GUI).

Each update writes one PNG, ``{out_dir}/dashboard/{id_str}.png``: three
panels side by side (the frame with the object's axes, the masked frame,
a point-splat render of the current mesh) and a caption with the frame's
id and the keyframe count.  The JAX code writes ``canvas[..., ::-1]`` with
``cv2.imwrite``, so the file holds the canvas's channels in order; the
port writes the canvas with ``io/png.py::write_png``.
"""
from __future__ import annotations

import os

import numpy as np

from ..io.png import write_png
from .draw import draw_xyz_axis
from .glyphs import draw_text
from .renderer import render_mesh_splat


class Dashboard:
    def __init__(self, out_dir: str, device=None):
        """``device``: where the mesh panel renders (None = CUDA).  The JAX
        class's ``every`` (write every n-th frame), which no caller sets,
        is left out: every update writes."""
        self.out_dir = out_dir
        self.device = device
        os.makedirs(f"{out_dir}/dashboard", exist_ok=True)

    def update(self, color, mask, ob_in_cam, K, id_str, mesh=None,
               n_keyframes: int = 0):
        color = np.asarray(color)
        if color.dtype != np.uint8:
            color = np.clip(
                color * (255.0 if color.max() <= 1.5 else 1.0), 0, 255
            ).astype(np.uint8)
        H, W = color.shape[:2]
        row1 = draw_xyz_axis(color, ob_in_cam, K, scale=0.05)
        masked = color.copy()
        if mask is not None:
            masked[mask == 0] = 0
        row2 = masked
        if mesh is not None and len(mesh.vertices):
            row3, _ = render_mesh_splat(mesh, ob_in_cam, K, H, W, device=self.device)
        else:
            row3 = np.zeros_like(color)
        canvas = np.concatenate([row1, row2, row3], axis=1)
        draw_text(canvas, f"{id_str}  kf={n_keyframes}", (8, 20))
        write_png(f"{self.out_dir}/dashboard/{id_str}.png", canvas)
