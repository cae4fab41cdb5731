"""Write the synthetic RGBD verify fixture (port of
``scripts/make_synth_video.py``, without OpenCV): a rotating dots-textured
cube in the YCBInEOAT layout (``rgb/ depth/ masks/`` PNGs, mm-uint16 depth,
``cam_K.txt``) with its ground-truth poses (``gt_ob_in_cam.npy``).

    python3 -m bundlesdf_tpu_torch.scripts.make_synth_video [OUT_DIR [N_FRAMES [DEG_STEP]]]

The arguments are the JAX script's, positional: 12 frames 6 degrees apart
by default, written to ``synth_dots`` under the temporary directory (the
JAX script writes ``/tmp/synth_dots``).  The frames are rendered by
``render_cube_rgbd``, a copy of ``tests/synthetic_cube.py``'s, and written
by ``io/png.py``: they decode equal to the JAX script's cv2-written files
(``tests/test_torch_synth_video.py``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
from scipy.spatial.transform import Rotation

from ..io.png import write_png


def render_cube_rgbd(ob_in_cam: np.ndarray, K: np.ndarray, H: int, W: int,
                     half: float = 0.15, checker: int = 6, texture: str = "dots"):
    """Ray-trace an axis-aligned textured cube of half-size ``half``
    (object frame) seen from a CV camera with object pose ``ob_in_cam``
    (``tests/synthetic_cube.py::render_cube_rgbd``, bit-equal).

    texture='checker' is periodic and aliases for feature matching;
    'dots' (default) overlays unique random dots.

    Returns (rgb [0,255] float, depth (z, meters), mask)."""
    T_oc = np.linalg.inv(ob_in_cam)  # cam -> object
    j, i = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d_cam = np.stack(
        [(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1], np.ones_like(i, np.float64)],
        axis=-1,
    )
    d_obj = d_cam @ T_oc[:3, :3].T
    o_obj = T_oc[:3, 3]

    inv_d = 1.0 / np.where(np.abs(d_obj) < 1e-12, 1e-12, d_obj)
    t0 = (-half - o_obj) * inv_d
    t1 = (half - o_obj) * inv_d
    tn = np.minimum(t0, t1).max(axis=-1)
    tf = np.maximum(t0, t1).min(axis=-1)
    hit = (tn < tf) & (tn > 0.01)
    t = np.where(hit, tn, 0.0)  # param t == z-depth since d_cam.z == 1
    p = o_obj + d_obj * t[..., None]

    ax = np.argmax(np.abs(p) / half, axis=-1)
    base = np.array([[255, 80, 80], [80, 255, 80], [80, 80, 255]], dtype=np.float64)
    rgb = base[ax]
    loc1 = np.take_along_axis(p, ((ax + 1) % 3)[..., None], axis=-1)[..., 0]
    loc2 = np.take_along_axis(p, ((ax + 2) % 3)[..., None], axis=-1)[..., 0]
    cell = 2 * half / checker
    par = (np.floor(loc1 / cell) + np.floor(loc2 / cell)).astype(np.int64) % 2
    rgb = np.where(par[..., None] == 0, rgb, rgb * 0.35)
    if texture == "dots":
        # hash face-local lattice coords at a fine pitch into brightness dots
        pitch = cell / 4.0
        i1 = np.floor(loc1 / pitch).astype(np.int64)
        i2 = np.floor(loc2 / pitch).astype(np.int64)
        hsh = (i1 * 73856093) ^ (i2 * 19349663) ^ ((ax + 1) * 83492791)
        rnd = ((hsh % 1000003).astype(np.float64) / 1000003.0)
        rgb = rgb * (0.45 + 0.9 * rnd[..., None])
        rgb = np.clip(rgb, 0, 255)
    sign_mask = np.take_along_axis(p, ax[..., None], axis=-1)[..., 0] > 0
    rgb = np.where(sign_mask[..., None], rgb, rgb * 0.8)
    rgb = np.where(hit[..., None], rgb, 0.0)
    depth = np.where(hit, t, 0.0)
    return rgb.astype(np.float32), depth.astype(np.float32), hit.astype(np.uint8) * 255


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="write the synthetic dots-cube RGBD video")
    ap.add_argument("out", nargs="?", default=os.path.join(tempfile.gettempdir(), "synth_dots"))
    ap.add_argument("n_frames", nargs="?", type=int, default=12)
    ap.add_argument("deg_step", nargs="?", type=float, default=6.0)
    args = ap.parse_args(argv)
    out = args.out
    H = W = 480
    K = np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]], np.float32)
    axis = np.array([0, 1, 0.2])
    axis = axis / np.linalg.norm(axis)
    base = Rotation.from_euler("xyz", [20, 30, 10], degrees=True).as_matrix()
    for d in ("rgb", "depth", "masks"):
        os.makedirs(f"{out}/{d}", exist_ok=True)
    np.savetxt(f"{out}/cam_K.txt", K)
    gts = []
    for k in range(args.n_frames):
        R = Rotation.from_rotvec(axis * np.deg2rad(args.deg_step * k)).as_matrix() @ base
        ob_in_cam = np.eye(4)
        ob_in_cam[:3, :3] = R
        # small translation wobble so translation tracking is exercised too
        ob_in_cam[:3, 3] = [0.02 * np.sin(k * 0.4), 0.015 * np.cos(k * 0.3),
                            0.55 + 0.01 * np.sin(k * 0.2)]
        rgb, depth, mask = render_cube_rgbd(ob_in_cam, K, H, W, texture="dots")
        name = f"{k:05d}"
        write_png(f"{out}/rgb/{name}.png", rgb.astype(np.uint8))
        write_png(f"{out}/depth/{name}.png", (depth * 1000).astype(np.uint16))
        write_png(f"{out}/masks/{name}.png", mask)
        gts.append(ob_in_cam)
    np.save(f"{out}/gt_ob_in_cam.npy", np.asarray(gts))
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
