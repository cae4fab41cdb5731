"""Run the port over HO3D_v3 evaluation sequences (port of
``scripts/run_ho3d.py:19-76``):

    python3 -m bundlesdf_tpu_torch.scripts.run_ho3d --ho3d_dir HO3D_v3 \\
        --out_dir OUT [--video_names SM1 ...] [--shard i/n] [--no_nerf]

For each video ``{ho3d_dir}/evaluation/{name}`` it writes the poses, the
artifact trail, the two config YAMLs and ``mesh_online.obj`` under
``{out_dir}/{name}``.  A video whose last frame's pose exists is skipped;
``--shard i/n`` takes every n-th video from the i-th.  ``--device``: the
torch device (default: the CUDA card; without one the run raises).
"""
from __future__ import annotations

import argparse
import logging
import os

from ..config import default_nof_config, default_track_config
from ..io.readers import Ho3dReader
from ..pipeline.bundlesdf import BundleSdf
from .run_custom import ray_pool_reserve_log2

HO3D_VIDEOS = ["AP10", "AP11", "AP12", "AP13", "AP14", "MPM10", "MPM11",
               "MPM12", "MPM13", "MPM14", "SB11", "SB13", "SM1"]


def run_one_video(video_dir, out_folder, use_nof=True, device=None):
    """Track (and reconstruct) one HO3D video; returns the pipeline, or None
    when the video is already complete."""
    reader = Ho3dReader(video_dir)
    done_marker = f"{out_folder}/ob_in_cam/{reader.id_strs[-1]}.txt"
    if os.path.exists(done_marker):
        print(f"skip {video_dir} (complete)")
        return None
    os.makedirs(out_folder, exist_ok=True)
    cfg_track = default_track_config()
    cfg_track["debug_dir"] = out_folder
    cfg_nof = default_nof_config()
    cfg_nof["save_dir"] = out_folder
    cfg_nof["ray_pool_reserve_log2"] = ray_pool_reserve_log2(len(reader))
    cfg_track.save(f"{out_folder}/config_track.yml")
    cfg_nof.save(f"{out_folder}/config_nerf.yml")
    tracker = BundleSdf(cfg_track=cfg_track, cfg_nof=cfg_nof, out_dir=out_folder,
                        use_nof=use_nof, save_artifacts=True, device=device)
    for i in range(len(reader)):
        tracker.run(reader.get_color(i), reader.get_depth(i), reader.K, reader.id_strs[i],
                    mask=reader.get_mask(i), occ_mask=reader.get_occ_mask(i))
    mesh = tracker.on_finish()
    if mesh is not None:
        mesh.export(f"{out_folder}/mesh_online.obj")
    return tracker


def main(argv=None):
    """Run the selected videos; returns {name: pipeline or None (skipped)}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ho3d_dir", required=True, help="HO3D_v3 root")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--video_names", nargs="*", default=None)
    p.add_argument("--no_nerf", action="store_true")
    p.add_argument("--shard", default="0/1",
                   help="i/n: process every n-th video starting at i")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    names = args.video_names or HO3D_VIDEOS
    si, sn = (int(x) for x in args.shard.split("/"))
    out = {}
    for name in names[si::sn]:
        video_dir = f"{args.ho3d_dir}/evaluation/{name}"
        if not os.path.isdir(video_dir):
            print(f"missing {video_dir}, skip")
            continue
        out[name] = run_one_video(video_dir, f"{args.out_dir}/{name}",
                                  use_nof=not args.no_nerf, device=args.device)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
