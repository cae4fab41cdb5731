"""Output artifact trail (port of ``bundlesdf_tpu/pipeline/artifacts.py``):
the reference's "output directory is the checkpoint" contract — per-frame
pose files, segmented color / filtered depth / mask dumps and the keyframe
list, from which the offline global refinement restarts (reference
Bundler::saveNewframeResult Bundler.cpp:959-1111 and
BundleSdf.run_global_nerf bundlesdf.py:640-700).

The files are those the JAX package writes, readable by either package:
``ob_in_cam/<id>.txt`` (``np.savetxt``), 8-bit RGB ``color_segmented``,
16-bit millimetre ``depth_filtered`` and 8-bit ``mask`` PNGs
(``io/png.py`` in place of OpenCV), and ``keyframes.yml`` (PyYAML).
"""
from __future__ import annotations

import os

import numpy as np
import yaml

from ..io.png import read_png, write_png


def save_newframe_result(tracker, frame, out_dir: str, spdlog_level: int = 1):
    """Write ob_in_cam/<id>.txt always; the image dumps from SPDLOG level 2
    on (the reference's SPDLOG-gated artifact levels); keyframes.yml with
    every keyframe's pose and ``nerfed`` flag."""
    os.makedirs(f"{out_dir}/ob_in_cam", exist_ok=True)
    ob_in_cam = np.linalg.inv(frame.pose_in_model)
    np.savetxt(f"{out_dir}/ob_in_cam/{frame.id_str}.txt", ob_in_cam)

    if spdlog_level >= 2:
        for sub in ("color_segmented", "depth_filtered", "mask"):
            os.makedirs(f"{out_dir}/{sub}", exist_ok=True)
        color = frame.color.copy()
        if color.max() <= 1.5:
            color = (color * 255).astype(np.uint8)
        color_seg = color.copy()
        color_seg[~frame.fg_mask] = 0
        write_png(f"{out_dir}/color_segmented/{frame.id_str}.png",
                  color_seg.astype(np.uint8))
        depth_mm = (frame.depth * 1000).astype(np.uint16)
        write_png(f"{out_dir}/depth_filtered/{frame.id_str}.png", depth_mm)
        write_png(f"{out_dir}/mask/{frame.id_str}.png",
                  frame.fg_mask.astype(np.uint8) * 255)

    kf_data = {}
    for kf in tracker.bundler.keyframes:
        kf_data[kf.id_str] = {
            "cam_in_ob": np.asarray(kf.pose_in_model).reshape(-1).tolist(),
            "nerfed": bool(kf.nerfed),
        }
    with open(f"{out_dir}/keyframes.yml", "w") as f:
        yaml.safe_dump(kf_data, f)


def load_keyframes_yml(out_dir: str) -> dict:
    with open(f"{out_dir}/keyframes.yml") as f:
        data = yaml.safe_load(f)
    out = {}
    for id_str, rec in data.items():
        out[id_str] = {
            "cam_in_ob": np.asarray(rec["cam_in_ob"], dtype=np.float32).reshape(4, 4),
            "nerfed": bool(rec.get("nerfed", False)),
        }
    return out


def load_tracked_frames(out_dir: str, id_strs=None):
    """Reload the per-frame artifact trail (color_segmented / depth_filtered
    / mask + keyframes.yml) as the frame dicts ``run_global_nerf``
    consumes; ids without a color dump are skipped."""
    kfs = load_keyframes_yml(out_dir)
    ids = sorted(kfs.keys()) if id_strs is None else id_strs
    frames = []
    for id_str in ids:
        if not os.path.exists(f"{out_dir}/color_segmented/{id_str}.png"):
            continue
        color = read_png(f"{out_dir}/color_segmented/{id_str}.png")
        depth = read_png(f"{out_dir}/depth_filtered/{id_str}.png") / 1e3
        mask = read_png(f"{out_dir}/mask/{id_str}.png")
        frames.append({
            "id_str": id_str,
            "color": color,
            "depth": depth.astype(np.float32),
            "mask": (mask > 0).astype(np.float32),
            "cam_in_ob": kfs[id_str]["cam_in_ob"],
        })
    return frames
