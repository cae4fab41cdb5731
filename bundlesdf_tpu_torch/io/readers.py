"""Dataset readers: the YCBInEOAT / custom RGBD layout and HO3D_v3 (port of
``bundlesdf_tpu/io/readers.py``).

  * ``YcbineoatReader`` (JAX :27-141): ``rgb/ depth/ masks/ cam_K.txt``,
    mm-uint16 depth, optional ``masks_hand*`` occluder masks, downscale or
    shorter-side resize.  The JAX package's native prefetch loader
    (``bundlesdf_tpu/native/__init__.py:90-138``, OpenCV inside) becomes
    one background thread that reads ``PREFETCH`` frames ahead with the
    same getters (``read_png``'s zlib releases the interpreter lock), so a
    prefetched frame equals an unprefetched one.  The JAX loader returns
    the mask as 0/1; its unprefetched getter, which both of the port's
    paths follow, returns the file's values (0/255 for a gray mask).
  * ``Ho3dReader`` (JAX :144-216): JPEG colour (``io/jpeg.py``), packed
    two-channel depth times ``DEPTH_SCALE``, the XMem mask folders, the
    pickled meta with the ground-truth poses (GL-flipped) and the model
    lookup by video name.

OpenCV's calls become numpy (``io/png.py``, ``io/jpeg.py``,
``io/imread.py``, ``io/imgproc.py``).  The colour getters read as the JAX
ones do through imageio (RGB, ``read_png`` and ``read_jpeg``); masks, hand
masks and depth as ``cv2.imread(path, -1)`` reads them (``imread_unchanged``:
the decoder chosen by the file's first bytes, BGR or BGRA channels, None
for a missing file).
"""
from __future__ import annotations

import concurrent.futures
import glob
import logging
import os
import pickle

import numpy as np
from scipy.spatial.transform import Rotation

from ..utils.geometry import GLCAM_IN_CVCAM
from ..utils.mesh import load_obj
from .imgproc import resize_nearest
from .imread import imread_unchanged
from .jpeg import read_jpeg
from .png import read_png

# How many frames the prefetch thread reads ahead of the last one asked for.
PREFETCH = 8


class YcbineoatReader:
    """Custom / YCBInEOAT video directory reader."""

    videoname_to_object = {
        "bleach0": "021_bleach_cleanser",
        "bleach_hard_00_03_chaitanya": "021_bleach_cleanser",
        "cracker_box_reorient": "003_cracker_box",
        "cracker_box_yalehand0": "003_cracker_box",
        "mustard0": "006_mustard_bottle",
        "mustard_easy_00_02": "006_mustard_bottle",
        "sugar_box1": "004_sugar_box",
        "sugar_box_yalehand0": "004_sugar_box",
        "tomato_soup_can_yalehand0": "005_tomato_soup_can",
    }

    def __init__(self, video_dir: str, downscale: float = 1, shorter_side=None,
                 prefetch: bool = True):
        self.video_dir = video_dir
        self.downscale = downscale
        self.color_files = sorted(glob.glob(f"{video_dir}/rgb/*.png"))
        if not self.color_files:
            raise FileNotFoundError(f"no rgb/*.png under {video_dir}")
        self.K = np.loadtxt(f"{video_dir}/cam_K.txt").reshape(3, 3)
        self.id_strs = [
            os.path.basename(f).replace(".png", "") for f in self.color_files
        ]
        self.H, self.W = read_png(self.color_files[0]).shape[:2]
        if shorter_side is not None:
            self.downscale = shorter_side / min(self.H, self.W)
        self.H = int(self.H * self.downscale)
        self.W = int(self.W * self.downscale)
        self.K = self.K.copy()
        self.K[:2] *= self.downscale
        self.gt_pose_files = sorted(glob.glob(f"{video_dir}/annotated_poses/*"))
        # prefetch: index -> future of (color, depth, mask); the getters
        # serve from a one-frame cache (JAX readers.py:79-82)
        self._pool = (concurrent.futures.ThreadPoolExecutor(1, "frame_prefetch")
                      if prefetch else None)
        self._futures: dict[int, concurrent.futures.Future] = {}
        self._cached = (-1, None)

    def _read_frame(self, i):
        return self._read_color(i), self._read_depth(i), self._read_mask(i)

    def _get_frame(self, i):
        if self._cached[0] != i:
            for j in range(i, min(i + PREFETCH + 1, len(self))):
                if j not in self._futures:
                    self._futures[j] = self._pool.submit(self._read_frame, j)
            for j in [j for j in self._futures if j < i]:
                self._futures.pop(j).cancel()
            self._cached = (i, self._futures.pop(i).result())
        return self._cached[1]

    def close(self):
        """Stop the prefetch thread (also at garbage collection)."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            for fut in self._futures.values():
                fut.cancel()
            self._futures.clear()
            pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):
        self.close()

    def get_video_name(self):
        return self.video_dir.rstrip("/").split("/")[-1]

    def __len__(self):
        return len(self.color_files)

    def _read_color(self, i):
        color = read_png(self.color_files[i])
        if color.dtype == np.uint16 and color.ndim == 3:
            # imageio (PIL) keeps the high byte of 16-bit colour and reads
            # 16-bit gray + alpha as RGBA; 16-bit gray stays 16-bit
            color = (color >> 8).astype(np.uint8)
            if color.shape[2] == 2:
                color = color[..., [0, 0, 0, 1]]
        return resize_nearest(color[..., :3], self.W, self.H)

    def _read_mask(self, i):
        mask = imread_unchanged(self.color_files[i].replace("rgb", "masks"))
        if mask is None:
            return np.zeros((self.H, self.W), np.uint8)
        if mask.ndim == 3:
            mask = (mask.sum(axis=-1) > 0).astype(np.uint8)
        return resize_nearest(mask, self.W, self.H)

    def _read_depth(self, i):
        depth = imread_unchanged(self.color_files[i].replace("rgb", "depth")) / 1e3
        return resize_nearest(depth, self.W, self.H).astype(np.float32)

    def get_color(self, i):
        return self._get_frame(i)[0] if self._pool else self._read_color(i)

    def get_mask(self, i):
        return self._get_frame(i)[2] if self._pool else self._read_mask(i)

    def get_depth(self, i):
        return self._get_frame(i)[1] if self._pool else self._read_depth(i)

    def get_occ_mask(self, i):
        occ = np.zeros((self.H, self.W), dtype=bool)
        for sub in ("masks_hand", "masks_hand_right"):
            m = imread_unchanged(self.color_files[i].replace("rgb", sub))
            if m is not None:
                if m.ndim == 3:
                    m = m.sum(axis=-1)
                occ |= resize_nearest(m.astype(np.uint8), self.W, self.H) > 0
        return occ.astype(np.uint8)

    def get_gt_pose(self, i):
        try:
            return np.loadtxt(self.gt_pose_files[i]).reshape(4, 4)
        except (IndexError, OSError, ValueError):
            logging.info("GT pose not found, return None")
            return None

    def get_gt_mesh(self, models_root: str):
        ob = self.videoname_to_object[self.get_video_name()]
        return load_obj(f"{models_root}/{ob}/textured_simple.obj")


class Ho3dReader:
    """HO3D_v3 evaluation sequence reader."""

    DEPTH_SCALE = 0.00012498664727900177  # reference data_reader.py:166

    video2name = {
        "AP": "019_pitcher_base",
        "MPM": "010_potted_meat_can",
        "SB": "021_bleach_cleanser",
        "SM": "006_mustard_bottle",
    }

    def __init__(self, video_dir: str, ho3d_root: str | None = None):
        self.video_dir = video_dir
        self.ho3d_root = ho3d_root or os.path.dirname(os.path.dirname(video_dir.rstrip("/")))
        self.color_files = sorted(glob.glob(f"{video_dir}/rgb/*.jpg"))
        if not self.color_files:
            raise FileNotFoundError(f"no rgb/*.jpg under {video_dir}")
        meta_file = self.color_files[0].replace(".jpg", ".pkl").replace("rgb", "meta")
        with open(meta_file, "rb") as f:
            self.K = pickle.load(f)["camMat"]
        self.id_strs = [
            os.path.basename(f).split(".")[0] for f in self.color_files
        ]
        self.H, self.W = read_jpeg(self.color_files[0]).shape[:2]

    def __len__(self):
        return len(self.color_files)

    def get_video_name(self):
        return os.path.dirname(os.path.abspath(self.color_files[0])).split("/")[-2]

    def get_color(self, i):
        return read_jpeg(self.color_files[i])[..., :3]

    def _index(self, i) -> int:
        return int(os.path.basename(self.color_files[i]).split(".")[0])

    def get_mask(self, i):
        """The XMem mask in ``cv2.imread(path, -1)``'s layout, None when
        there is none."""
        video = self.get_video_name()
        return imread_unchanged(
            f"{self.ho3d_root}/masks_XMem/{video}/{self._index(i):05d}.png")

    def get_occ_mask(self, i):
        video = self.get_video_name()
        return imread_unchanged(
            f"{self.ho3d_root}/masks_XMem/{video}_hand/{self._index(i):04d}.png")

    def get_depth(self, i):
        """Packed depth: red + 256 x green in DEPTH_SCALE units, channels 2
        and 1 of ``cv2.imread(path, -1)``'s BGR, as the JAX reader takes
        them (:195-196)."""
        depth = imread_unchanged(
            self.color_files[i].replace(".jpg", ".png").replace("rgb", "depth"))
        d = depth.astype(np.int32)
        return ((d[..., 2] + d[..., 1] * 256) * self.DEPTH_SCALE).astype(np.float32)

    def get_gt_pose(self, i):
        meta_file = self.color_files[i].replace(".jpg", ".pkl").replace("rgb", "meta")
        with open(meta_file, "rb") as f:
            meta = pickle.load(f)
        if meta["objTrans"] is None:
            return None
        ob_in_cam = np.eye(4)
        ob_in_cam[:3, 3] = meta["objTrans"]
        # cv2.Rodrigues in double precision
        ob_in_cam[:3, :3] = Rotation.from_rotvec(
            np.asarray(meta["objRot"], np.float64).reshape(3)).as_matrix()
        return GLCAM_IN_CVCAM @ ob_in_cam

    def get_gt_mesh(self):
        video = self.get_video_name()
        for k, ob in self.video2name.items():
            if video.startswith(k):
                return load_obj(f"{self.ho3d_root}/models/{ob}/textured_simple.obj")
        raise KeyError(video)
