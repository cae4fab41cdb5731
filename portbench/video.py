"""The benchmark's synthetic RGBD video: a dots-textured cube turning in
front of a static camera, rendered on the host from the seed.

Frozen copies, so that a change to the program cannot move the traffic:
``synth_poses`` is ``chip_smoke.py::synth_poses`` (the poses of
``scripts/make_synth_video.py``: a tilted base rotation, ``deg_step`` a
frame about (0, 1, 0.2), a translation wobble at ~0.55 m), and
``render_cube_rgbd``, ``cube_model_points`` are
``tests/synthetic_cube.py``'s.  The one change: ``salt`` enters the hash
that places the bright dots, so each seed shows other image content with
the same poses, sizes, speed and texture statistics.  ``salt`` 0 renders
the source's frames exactly.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def synth_poses(n_frames: int, deg_step: float, wobble: float) -> list:
    """Object-in-camera poses, the translation wobble scaled by ``wobble``."""
    axis = np.array([0, 1, 0.2]) / np.linalg.norm([0, 1, 0.2])
    base = Rotation.from_euler("xyz", [20, 30, 10], degrees=True).as_matrix()
    poses = []
    for k in range(n_frames):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(axis * np.deg2rad(deg_step * k)).as_matrix() @ base
        T[:3, 3] = [wobble * 0.02 * np.sin(k * 0.4), wobble * 0.015 * np.cos(k * 0.3),
                    0.55 + wobble * 0.01 * np.sin(k * 0.2)]
        poses.append(T)
    return poses


def synth_poses_in(dtype, n_frames: int, deg_step: float, wobble: float):
    """``synth_poses`` computed in ``dtype`` (torch): the rotation by
    Rodrigues' formula, the product with the base rotation and the wobble
    all in that precision; returned as float64 numpy (n, 4, 4).  In float64
    it gives ``synth_poses`` to 1e-7; in bfloat16 it is the pose checks'
    control (the truth computed one precision below float32)."""
    import math

    import torch

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(dtype)

    axis = t([0, 1, 0.2])
    axis = axis / torch.linalg.norm(axis.float()).to(dtype)
    base = t(Rotation.from_euler("xyz", [20, 30, 10], degrees=True).as_matrix())
    hat = torch.zeros((3, 3), dtype=dtype)
    hat[0, 1], hat[0, 2], hat[1, 0] = -axis[2], axis[1], axis[2]
    hat[1, 2], hat[2, 0], hat[2, 1] = -axis[0], -axis[1], axis[0]
    out = []
    for k in range(n_frames):
        th = t(deg_step) * k * t(math.pi / 180)
        R = torch.eye(3, dtype=dtype) + torch.sin(th) * hat + (1 - torch.cos(th)) * (hat @ hat)
        T = torch.eye(4, dtype=dtype)
        T[:3, :3] = R @ base
        kk = t(k)
        T[:3, 3] = torch.stack([t(wobble) * t(0.02) * torch.sin(kk * t(0.4)),
                                t(wobble) * t(0.015) * torch.cos(kk * t(0.3)),
                                t(0.55) + t(wobble) * t(0.01) * torch.sin(kk * t(0.2))])
        out.append(T.to(torch.float64).cpu().numpy())
    return np.stack(out)


def render_cube_rgbd(ob_in_cam: np.ndarray, K: np.ndarray, H: int, W: int,
                     half: float = 0.15, checker: int = 6, texture: str = "dots",
                     salt: int = 0):
    """Ray-trace an axis-aligned textured cube of half-size ``half``
    (object frame) seen from a CV camera with object pose ``ob_in_cam``.
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
        pitch = cell / 4.0
        i1 = np.floor(loc1 / pitch).astype(np.int64)
        i2 = np.floor(loc2 / pitch).astype(np.int64)
        hsh = (i1 * 73856093) ^ (i2 * 19349663) ^ ((ax + 1) * 83492791) ^ np.int64(salt)
        rnd = ((hsh % 1000003).astype(np.float64) / 1000003.0)
        rgb = rgb * (0.45 + 0.9 * rnd[..., None])
        rgb = np.clip(rgb, 0, 255)
    sign_mask = np.take_along_axis(p, ax[..., None], axis=-1)[..., 0] > 0
    rgb = np.where(sign_mask[..., None], rgb, rgb * 0.8)
    rgb = np.where(hit[..., None], rgb, 0.0)
    depth = np.where(hit, t, 0.0)
    return rgb.astype(np.float32), depth.astype(np.float32), hit.astype(np.uint8) * 255


def cube_model_points(half=0.15, n=500, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-half, half, (n, 3))
    ax = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    pts[np.arange(n), ax] = half * sign
    return pts


def dot_salt(seed: int) -> int:
    """The seed's salt for the dots hash: 30 bits of a splitmix64 of the
    seed (0 is left to the source's own frames)."""
    z = (int(seed) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return ((z ^ (z >> 31)) & 0x3FFFFFFF) | 1


def make_video(traffic: dict, seed: int) -> dict:
    """The traffic's video: ``frames`` frames of ``height`` x ``width`` at
    fx = fy = ``focal``, ``deg_step`` degrees a frame, ``wobble`` of the
    translation wobble; color as u8 and depth in mm steps, as the dataset
    readers give them.  The seed salts the dots alone."""
    H, W, f = int(traffic["height"]), int(traffic["width"]), float(traffic["focal"])
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    salt = dot_salt(seed)
    out = {"colors": [], "depths": [], "masks": [], "gt": [], "K": K,
           "model_pts": cube_model_points(float(traffic["half"]))}
    for T in synth_poses(int(traffic["frames"]), float(traffic["deg_step"]),
                         float(traffic["wobble"])):
        rgb, depth, mask = render_cube_rgbd(T, K, H, W, half=float(traffic["half"]),
                                            salt=salt)
        out["colors"].append(rgb.astype(np.uint8))
        out["depths"].append((np.round(depth * 1000.0) / 1000.0).astype(np.float32))
        out["masks"].append(mask)
        out["gt"].append(T)
    return out
