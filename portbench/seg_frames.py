"""The segmentation traffic's frames: ``video.py``'s dots cube at the
traffic's poses and sizes, color alone, ray-traced on the run's device in
float64 (``video.render_cube_rgbd``'s arithmetic in torch: ~140 ms a
480 x 640 frame on one host core there, a fraction of a ms on the card),
then handed to the host as uint8, as the readers give frames; and the
first frame's true mask.  Frames stay distinct: repeated frames would put
exactly tied keys into the segmenter's memory."""
from __future__ import annotations

import numpy as np
import torch

from . import video


def render_color(ob_in_cam: np.ndarray, K: np.ndarray, H: int, W: int, half: float,
                 salt: int, device) -> tuple:
    """``video.render_cube_rgbd``'s color (truncated to uint8) and mask,
    (H, W, 3) and (H, W), computed on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    T_oc = torch.as_tensor(np.linalg.inv(ob_in_cam), **f64)
    j, i = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64), indexing="ij")
    d_cam = torch.stack([(i - float(K[0, 2])) / float(K[0, 0]),
                         (j - float(K[1, 2])) / float(K[1, 1]), torch.ones_like(i)], -1)
    d_obj = d_cam @ T_oc[:3, :3].T
    o_obj = T_oc[:3, 3]
    inv_d = 1.0 / torch.where(d_obj.abs() < 1e-12, torch.full_like(d_obj, 1e-12), d_obj)
    t0 = (-half - o_obj) * inv_d
    t1 = (half - o_obj) * inv_d
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    hit = (tn < tf) & (tn > 0.01)
    t = torch.where(hit, tn, torch.zeros_like(tn))
    p = o_obj + d_obj * t[..., None]
    ax = torch.argmax(p.abs() / half, -1)
    base = torch.tensor([[255, 80, 80], [80, 255, 80], [80, 80, 255]], **f64)
    rgb = base[ax]
    loc1 = torch.gather(p, -1, ((ax + 1) % 3)[..., None])[..., 0]
    loc2 = torch.gather(p, -1, ((ax + 2) % 3)[..., None])[..., 0]
    cell = 2 * half / 6
    par = (torch.floor(loc1 / cell) + torch.floor(loc2 / cell)).to(torch.int64) % 2
    rgb = torch.where(par[..., None] == 0, rgb, rgb * 0.35)
    pitch = cell / 4.0
    i1 = torch.floor(loc1 / pitch).to(torch.int64)
    i2 = torch.floor(loc2 / pitch).to(torch.int64)
    hsh = (i1 * 73856093) ^ (i2 * 19349663) ^ ((ax + 1) * 83492791) ^ int(salt)
    rnd = (hsh % 1000003).to(torch.float64) / 1000003.0
    rgb = (rgb * (0.45 + 0.9 * rnd[..., None])).clamp(0, 255)
    sign = torch.gather(p, -1, ax[..., None])[..., 0] > 0
    rgb = torch.where(sign[..., None], rgb, rgb * 0.8)
    rgb = torch.where(hit[..., None], rgb, torch.zeros_like(rgb))
    return rgb.to(torch.float32).to(torch.uint8), hit.to(torch.uint8) * 255


def make_frames(traffic: dict, seed: int, device) -> dict:
    """``frames`` RGB frames (host uint8, H x W x 3) of the traffic's
    video, the seed salting the dots, and ``mask0``, frame 0's true mask
    (0/255)."""
    H, W, f = int(traffic["height"]), int(traffic["width"]), float(traffic["focal"])
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    salt = video.dot_salt(seed)
    colors, mask0 = [], None
    for T in video.synth_poses(int(traffic["frames"]), float(traffic["deg_step"]),
                               float(traffic["wobble"])):
        rgb, mask = render_color(T, K, H, W, float(traffic["half"]), salt, device)
        colors.append(rgb.cpu().numpy())
        if mask0 is None:
            mask0 = mask.cpu().numpy()
    return {"colors": colors, "mask0": mask0}
