"""Run the port on a custom RGBD video folder (``rgb/ depth/ masks/
cam_K.txt``; port of ``scripts/run_custom.py``, :32-140):

    python3 -m bundlesdf_tpu_torch.scripts.run_custom --mode run_video \\
        --video_dir VIDEO --out_folder VIDEO/out [--use_gui] [--debug_level 2]
    python3 -m bundlesdf_tpu_torch.scripts.run_custom --mode global_refine \\
        --out_folder VIDEO/out [--refine_steps N]
    python3 -m bundlesdf_tpu_torch.scripts.run_custom --mode draw_pose \\
        --video_dir VIDEO --out_folder VIDEO/out

``run_video`` tracks the video and trains the Neural Object Field, leaving
the poses (``ob_in_cam/``), the artifact trail, ``config_track.yml``,
``config_nerf.yml`` and ``mesh_online.obj`` in ``out_folder`` (and the
dashboard PNGs with ``--use_gui``).  ``global_refine`` retrains at the
offline budget from that trail (``entry.run_global_refine``; ``cam_K.txt``
is read from the folder above ``out_folder``, as in the JAX script) and
writes ``textured_mesh.obj`` and ``poses_after_global_refine.txt``.
``draw_pose`` writes the axis overlays to ``pose_vis/``.

The flags are the JAX script's, less ``--log_compiles`` (it logs XLA
compiles, which have no counterpart here: the parser rejects it), plus
``--device`` (default: the CUDA card; without one the run raises) and
``--first_mask_only`` with ``--xmem_weights FILE`` (``run_video`` reads the
first frame's mask alone and XMem, ``entry.build_segmenter`` with those
weights, masks every later frame from it).

Data-parallel refinement: start one process per rank with
``BSDF_COORDINATOR=host:port BSDF_NUM_PROCESSES=N BSDF_PROCESS_ID=i`` (and
``BSDF_LOCAL_WORLD_SIZE`` ranks a host).  ``main`` first calls
``parallel.distributed.init_multihost()``, which returns False without
those variables (a single process is unchanged); with them, the NOF
trains over all N ranks (``dp_devices`` N).  ``run_video`` reads the video
and tracks on rank 0, the tracker of record, which writes every output;
the other ranks train the NOF rounds it starts (``BundleSdf.follow``;
with ``--no_nerf`` they return at once).  ``global_refine`` writes its
files from rank 0, and ``draw_pose`` runs on rank 0.
"""
from __future__ import annotations

import argparse
import logging
import math
import os

import numpy as np
import torch

from ..config import (behave_track_config, default_nof_config, default_track_config,
                      ycbineoat_track_config)
from ..entry import build_segmenter, run_global_refine
from ..io.imgproc import erode_square
from ..io.png import write_png
from ..io.readers import YcbineoatReader
from ..parallel.distributed import init_multihost
from ..pipeline.bundlesdf import BundleSdf
from ..utils.profiler import report
from ..viz.draw import draw_xyz_axis

TRACK_CONFIGS = {
    "custom": default_track_config,
    "ho3d": default_track_config,
    "ycbineoat": ycbineoat_track_config,
    "behave": behave_track_config,
}


def ray_pool_reserve_log2(n_frames: int) -> int:
    """The ray pool reserved for a whole video, ~120K masked rays a frame
    at 480p, as a power of two in [2^20, 2^23] (JAX run_custom.py:43-52)."""
    est = max(1, min(n_frames, 300)) * 120_000
    return min(23, max(20, math.ceil(math.log2(est))))


def run_one_video(video_dir, out_folder, use_nof=True, stride=1, debug_level=1,
                  shorter_side=480, use_gui=False, dataset="custom", device=None,
                  dp_devices=0, first_mask_only=False, xmem_weights=None):
    """Track (and reconstruct) one video; returns the pipeline.
    ``dp_devices > 1``: every rank of the process group calls this; rank 0
    tracks and writes the outputs, the others train the NOF with it and
    return their pipeline once rank 0 finishes.  ``first_mask_only``: read
    the first frame's mask alone; XMem (``entry.build_segmenter``) masks the
    others on the tracker's device with the weights in the file
    ``xmem_weights`` (a state dict under the port's names, ``xmem.
    load_weights``), which it needs: seeded weights do not segment."""
    if first_mask_only and xmem_weights is None:
        raise ValueError("first_mask_only needs xmem_weights: a file of XMem weights under "
                         "the port's names (models/xmem.py load_weights); seeded weights "
                         "do not segment")
    cfg_track = TRACK_CONFIGS[dataset]()
    cfg_track["SPDLOG"] = debug_level
    if dataset == "custom":
        cfg_track["depth_processing"]["zfar"] = 1.0
    cfg_track["debug_dir"] = out_folder
    cfg_nof = default_nof_config()
    cfg_nof["save_dir"] = out_folder
    n_video_frames = len(os.listdir(os.path.join(video_dir, "rgb"))) if video_dir else 12
    cfg_nof["ray_pool_reserve_log2"] = ray_pool_reserve_log2(n_video_frames)
    if dp_devices > 1:
        cfg_nof["dp_devices"] = dp_devices
    tracker = BundleSdf(cfg_track=cfg_track, cfg_nof=cfg_nof, out_dir=out_folder,
                        use_nof=use_nof, save_artifacts=True, use_gui=use_gui,
                        device=device)
    if not tracker.lead:
        tracker.follow()
        return tracker
    if first_mask_only:
        sd = torch.load(xmem_weights, map_location="cpu", weights_only=True)
        tracker.segmenter = build_segmenter(device=tracker.device, state_dict=sd)
    cfg_track.save(f"{out_folder}/config_track.yml")
    cfg_nof.save(f"{out_folder}/config_nerf.yml")

    reader = YcbineoatReader(video_dir=video_dir, shorter_side=shorter_side)
    try:
        for i in range(0, len(reader.color_files), stride):
            color = reader.get_color(i)
            depth = reader.get_depth(i)
            mask = reader.get_mask(i) if i == 0 or not first_mask_only else None
            if i == 0:
                mask = erode_square(mask.astype(np.uint8), 5)
            occ = reader.get_occ_mask(i)
            occ = occ if occ.any() else None
            tracker.run(color, depth, reader.K, reader.id_strs[i], mask=mask,
                        occ_mask=occ)
    finally:
        reader.close()
    mesh = tracker.on_finish()
    if mesh is not None:
        mesh.export(f"{out_folder}/mesh_online.obj")
    if debug_level >= 1:
        print(report(min_total=0.01))
    print(f"done: {len(tracker.poses_log)} frames -> {out_folder}/ob_in_cam")
    return tracker


def draw_pose(video_dir, out_folder):
    """Axis overlays of the tracked poses, ``pose_vis/{id}.png``."""
    reader = YcbineoatReader(video_dir=video_dir, shorter_side=480, prefetch=False)
    os.makedirs(f"{out_folder}/pose_vis", exist_ok=True)
    for i, id_str in enumerate(reader.id_strs):
        pose_file = f"{out_folder}/ob_in_cam/{id_str}.txt"
        if not os.path.exists(pose_file):
            continue
        ob_in_cam = np.loadtxt(pose_file).reshape(4, 4)
        vis = draw_xyz_axis(reader.get_color(i), ob_in_cam, reader.K, scale=0.05)
        write_png(f"{out_folder}/pose_vis/{id_str}.png", vis)
    print(f"pose visualizations -> {out_folder}/pose_vis")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="run_video",
                   choices=["run_video", "global_refine", "draw_pose"])
    p.add_argument("--video_dir", default="")
    p.add_argument("--out_folder", required=True)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--no_nerf", action="store_true")
    p.add_argument("--debug_level", type=int, default=1)
    p.add_argument("--shorter_side", type=int, default=480)
    p.add_argument("--use_gui", action="store_true")
    p.add_argument("--dataset", default="custom", choices=sorted(TRACK_CONFIGS))
    p.add_argument("--refine_steps", type=int, default=0,
                   help="override offline n_step (reference 2000); use a "
                        "few hundred for quick verification runs")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--first_mask_only", action="store_true",
                   help="run_video: read only the first frame's mask; XMem masks the "
                        "rest (needs --xmem_weights)")
    p.add_argument("--xmem_weights", default=None,
                   help="XMem weights for --first_mask_only: a torch.save'd state dict "
                        "under the port's names")
    args = p.parse_args(argv)
    if args.first_mask_only and args.xmem_weights is None:
        p.error("--first_mask_only needs --xmem_weights (no XMem weights ship with the "
                "port, and seeded weights do not segment)")
    return args


def main(argv=None):
    """Run one mode; returns its result (the pipeline for run_video, None
    there on a rank but 0 with --no_nerf; (pipeline, mesh, poses) for
    global_refine; None for draw_pose)."""
    args = parse_args(argv)
    dp, lead = 0, True
    if init_multihost():
        import torch.distributed as dist

        dp, lead = dist.get_world_size(), dist.get_rank() == 0
    if args.mode == "run_video":
        if args.no_nerf and not lead:
            return None     # tracking only: rank 0 alone has work
        return run_one_video(args.video_dir, args.out_folder, use_nof=not args.no_nerf,
                             stride=args.stride, debug_level=args.debug_level,
                             shorter_side=args.shorter_side, use_gui=args.use_gui,
                             dataset=args.dataset, device=args.device, dp_devices=dp,
                             first_mask_only=args.first_mask_only,
                             xmem_weights=args.xmem_weights)
    if args.mode == "global_refine":
        out = run_global_refine(args.out_folder, refine_steps=args.refine_steps or None,
                                device=args.device, dp_devices=dp)
        if lead:
            print(f"global refine done -> {args.out_folder}/textured_mesh.obj")
        return out
    if lead:
        draw_pose(args.video_dir, args.out_folder)
    return None


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
