"""Per-frame container and preprocessing (port of
``bundlesdf_tpu/tracking/frame.py``).

The reference Frame (BundleTrack/src/Frame.{h,cpp}).  The depth pipeline
(erode + 2x bilateral + xyz + normals + edge filter, Frame.cpp:80-138/
225-334) and the mask invalidation run on the tracker's device: on a CUDA
device one kernel launch (``ops/depth_cuda.py``), elsewhere the host twin
``ops/image.process_depth_frame_np``, as in the JAX package; at the shipped
config both give the same maps bit for bit (``csrc/depth_frame.cu`` says
where they can differ).  Recentering and denoising are host numpy: a Frame
holds numpy arrays only, and ``version`` counts the changes to its maps
after they were made.  ``compute_covisibility`` is the host twin of
``ops/covisibility_cuda.py``, which the Bundler calls on a CUDA tracker.
The fused device programs read its maps from the device frame pool
(``tracking/device_pool.py``).
"""
from __future__ import annotations

import numpy as np

from ..config import Cfg
from ..ops import depth_cuda

# Frame status (reference Frame.h Status enum).
OTHER = 0
FAIL = 1
NO_BA = 2


class Frame:
    def __init__(
        self,
        color: np.ndarray,
        depth: np.ndarray,
        K: np.ndarray,
        id: int,
        id_str: str,
        cfg: Cfg,
        pose_in_model: np.ndarray | None = None,
        fg_mask: np.ndarray | None = None,
        occ_mask: np.ndarray | None = None,
        device="cpu",
    ):
        self.id = id
        self.id_str = id_str
        self.cfg = cfg
        self.K = np.asarray(K, dtype=np.float32)
        self.color = np.asarray(color)
        self.H, self.W = depth.shape[:2]
        self.pose_in_model = (
            np.eye(4, dtype=np.float32) if pose_in_model is None
            else np.asarray(pose_in_model, dtype=np.float32)
        )
        self.ref_frame_id = -1
        self.status = OTHER
        self.nerfed = False  # pose frozen by NOF feedback (Bundler.cpp:914)

        self.fg_mask = (
            np.ones((self.H, self.W), dtype=bool) if fg_mask is None
            else np.asarray(fg_mask) > 0
        )
        self.occ_mask = None if occ_mask is None else np.asarray(occ_mask) > 0

        # the maps with the masks' pixels invalidated, on ``device`` (the
        # tracker's): one kernel launch on a CUDA device, the host twin else
        self.depth, self.xyz, self.normals, self.valid = depth_cuda.process_depth_frame(
            depth, self.K, device, self.fg_mask, self.occ_mask,
            **depth_cuda.config_params(cfg["depth_processing"]))
        c = np.asarray(self.color, dtype=np.float32)
        self.gray = 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]
        self._roi = None
        # bumped by every change to the maps, so that a device copy of them
        # (ops/covisibility_cuda.py) is made again, never read stale
        self.version = 0

    # ------------------------------------------------------------------
    def invalidate_pixels_by_mask(self, keep_mask: np.ndarray):
        """Zero out depth/cloud outside the mask (reference
        Frame.cpp:432-451 invalidatePixelsByMask)."""
        self.depth, self.xyz, self.normals, self.valid = depth_cuda.invalidate(
            (self.depth, self.xyz, self.normals, self.valid), keep_mask)
        self._roi = None
        self.version += 1

    @property
    def roi(self):
        """Foreground bounding box [umin, umax, vmin, vmax] (reference
        Frame::updateRoi)."""
        if self._roi is None:
            ys, xs = np.where(self.fg_mask & self.valid)
            if len(xs) == 0:
                ys, xs = np.where(self.fg_mask)
            if len(xs) == 0:
                self._roi = np.array([0, self.W - 1, 0, self.H - 1])
            else:
                self._roi = np.array([xs.min(), xs.max(), ys.min(), ys.max()])
        return self._roi

    def count_valid_points(self) -> int:
        """Reference Frame.cpp:453-464 countValidPoints."""
        return int((self.valid & self.fg_mask).sum())

    def set_new_init_coordinate(self):
        """First-frame recentering: move the model origin to the centroid of
        the masked cloud (reference Frame.cpp:147-170)."""
        pts = self.xyz[self.valid & self.fg_mask]
        if len(pts) == 0:
            return
        center = pts.mean(axis=0)
        # pose_in_model maps cam -> model; model origin at object center.
        self.pose_in_model = np.eye(4, dtype=np.float32)
        self.pose_in_model[:3, 3] = -center

    def point_cloud_denoise(self):
        """Statistical outlier removal on the masked cloud (reference
        Frame.cpp:337-384 pointCloudDenoise, simplified: distance-to-median
        gating instead of PCL's kNN statistics; invalidates outlier
        pixels)."""
        sel = self.valid & self.fg_mask
        pts = self.xyz[sel]
        if len(pts) < 10:
            return
        med = np.median(pts, axis=0)
        d = np.linalg.norm(pts - med, axis=-1)
        thres = d.mean() + 3.0 * d.std()
        bad = np.zeros(sel.sum(), dtype=bool)
        bad[d > thres] = True
        ys, xs = np.where(sel)
        self.depth[ys[bad], xs[bad]] = 0.0
        self.valid[ys[bad], xs[bad]] = False
        self.version += 1


def relative_transform(fa: Frame, fb: Frame) -> tuple:
    """(rel_R, rel_t): frame A's camera coordinates into frame B's, from the
    two poses, in their dtype (f32)."""
    R_b = fb.pose_in_model[:3, :3]
    rel_R = R_b.T @ fa.pose_in_model[:3, :3]
    rel_t = R_b.T @ (fa.pose_in_model[:3, 3] - fb.pose_in_model[:3, 3])
    return rel_R, rel_t


def compute_covisibility(fa: Frame, fb: Frame, visible_angle_deg: float = 70.0) -> float:
    """Covisibility between two frames (reference Frame.h:122-190).

    Host numpy, stride 2 like the reference CPU path: the twin of the
    batched kernel ``ops/covisibility_cuda.py``, and the CPU tracker's
    route."""
    pts = fa.xyz[::2, ::2].reshape(-1, 3)
    nrm = fa.normals[::2, ::2].reshape(-1, 3)
    msk = (fa.valid & fa.fg_mask)[::2, ::2].reshape(-1)
    rel_R, rel_t = relative_transform(fa, fb)
    p_b = pts @ rel_R.T + rel_t
    n_b = nrm @ rel_R.T
    to_eye = -p_b / (np.linalg.norm(p_b, axis=-1, keepdims=True) + 1e-10)
    n_b = n_b / (np.linalg.norm(n_b, axis=-1, keepdims=True) + 1e-10)
    dots = (to_eye * n_b).sum(-1)
    thres = np.cos(np.deg2rad(visible_angle_deg))
    total = msk.sum()
    return float(((dots > thres) & msk).sum() / (total + 1e-7))
