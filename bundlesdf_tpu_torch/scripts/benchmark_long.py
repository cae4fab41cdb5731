"""A long run of the online loop (port of ``scripts/benchmark_long.py``):
the hard fixture at 200 frames and 2.5 degrees a frame (past 360 degrees,
so views are revisited), the moving occluder and the depth noise, tracked
end to end.  It reports pose AUC, fps, peak RSS, and how the keyframe pool,
the feature tracks and the ray pool grow, under the JAX script's keys less
``n_train_program_shapes``, which counts XLA compilations (torch compiles
no program; ``ray_pool_caps`` still lists the pool's sizes).

    python3 -m bundlesdf_tpu_torch.scripts.benchmark_long [--frames 200] \\
        [--deg 2.5] [--matcher corner] [--sync_delay 3] [--extend N] \\
        [--workdir DIR] [--out FILE.json] [--device cpu]

``--workdir`` defaults to ``synth_long`` under the temporary directory and
``--out`` to ``EVAL_long.json`` in the workdir.  A run that raises fails:
there is no retry.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import resource
import tempfile
import time

import numpy as np

from ..config import default_nof_config, ycbineoat_track_config
from ..io.imgproc import erode_square
from ..io.readers import YcbineoatReader
from ..pipeline.bundlesdf import BundleSdf
from ..utils import metrics
from .synth_hard import make_hard_video


def _host_breakdown(tracker) -> dict:
    """The host memory (GB) of the runner's frames and ray pool, the
    tracker's frames and the match tables; the rest of the RSS is torch's
    (allocator caches, the CUDA context, staging)."""
    gb = 1 / 1e9
    out = {}
    nof = tracker.nof
    if nof is not None:
        # the pool lives on the device: only a copy that something read back
        host = nof._rays_host
        out["nof_rays_np"] = (0 if host is None else host.nbytes) * gb
        out["nof_images"] = (nof.images.nbytes + nof.depths.nbytes + nof.masks.nbytes) * gb
    fr_bytes, seen = 0, set()
    for f in list(tracker.bundler.frames.values()) + tracker.bundler.keyframes:
        if id(f) in seen:
            continue
        seen.add(id(f))
        for a in ("color", "depth", "xyz", "normals", "gray", "valid", "fg_mask"):
            v = getattr(f, a, None)
            if isinstance(v, np.ndarray):
                fr_bytes += v.nbytes
    out["frames"] = fr_bytes * gb
    store = tracker.bundler.store
    st_bytes = sum(v.nbytes for v in store.raw.values())
    for m in store.matches.values():
        if m is not None:
            st_bytes += sum(v.nbytes for v in m.values() if isinstance(v, np.ndarray))
    out["match_tables"] = st_bytes * gb
    return {k: round(v, 3) for k, v in out.items()}


def long_configs(video_dir, out_folder, matcher, sync_delay, n_step_extend=None):
    """The run's configs (JAX benchmark_long.py:36-51): the YCBInEOAT
    tracker config with ``matcher``, the shipped NOF config with
    ``sync_max_delay`` and the ray pool reserved for the whole video."""
    cfg_track = ycbineoat_track_config()
    cfg_track["feature_corres"]["matcher"] = matcher
    cfg_track["depth_processing"]["zfar"] = 1.0
    cfg_track["debug_dir"] = out_folder
    cfg_nof = default_nof_config()
    cfg_nof["save_dir"] = out_folder
    cfg_nof["sync_max_delay"] = int(sync_delay)
    if n_step_extend is not None:
        cfg_nof["n_step_extend"] = int(n_step_extend)
    n_video = len(os.listdir(os.path.join(video_dir, "rgb")))
    cfg_nof["ray_pool_reserve_log2"] = min(
        23, max(20, math.ceil(math.log2(max(1, n_video) * 120_000))))
    return cfg_track, cfg_nof


def run_long(video_dir, out_folder, matcher, sync_delay, n_step_extend=None,
             device=None) -> dict:
    """Track the long fixture; the run's statistics."""
    cfg_track, cfg_nof = long_configs(video_dir, out_folder, matcher, sync_delay,
                                      n_step_extend)
    os.makedirs(out_folder, exist_ok=True)
    reader = YcbineoatReader(video_dir=video_dir, shorter_side=480)
    tracker = BundleSdf(cfg_track=cfg_track, cfg_nof=cfg_nof, out_dir=out_folder,
                        use_nof=True, save_artifacts=True, device=device)
    t0 = time.perf_counter()
    n_fail, kf_sizes, pool_caps, tracks_parent_sizes, rss_curve = 0, [], set(), [], []
    n = len(reader.color_files)
    try:
        for i in range(n):
            mask = reader.get_mask(i)
            if i == 0:
                mask = erode_square(mask.astype(np.uint8), 5)
            occ = reader.get_occ_mask(i)
            occ = occ if occ is not None and occ.any() else None
            frame = tracker.run(reader.get_color(i), reader.get_depth(i), reader.K,
                                reader.id_strs[i], mask=mask, occ_mask=occ)
            if frame is not None and int(getattr(frame, "status", 0)) != 0:
                n_fail += 1
            kf_sizes.append(len(tracker.bundler.keyframes))
            tracks_parent_sizes.append(len(tracker.bundler.store.tracks._parent))
            if tracker.nof is not None:
                pool_caps.add(int(tracker.nof.rays_dev.shape[0]))
            if i % 10 == 0 or i == n - 1:
                rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
                bd = _host_breakdown(tracker)
                bd.update(frame=i, rss_gb=round(rss_gb, 2), unattributed=round(
                    rss_gb - sum(v for k, v in bd.items() if k != "frame"), 2))
                rss_curve.append(bd)
    finally:
        reader.close()
    mesh = tracker.on_finish()
    wall = time.perf_counter() - t0
    if mesh is not None:
        mesh.export(f"{out_folder}/mesh_online.obj")
    return dict(
        wall_s=round(wall, 1),
        fps=round(n / wall, 4),
        n_tracking_fail=n_fail,
        peak_rss_gb=round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
        ray_pool_caps=sorted(pool_caps),
        kf_pool_over_time=kf_sizes[:: max(1, len(kf_sizes) // 50)],
        kf_pool_final=kf_sizes[-1],
        tracks_parent_final=tracks_parent_sizes[-1],
        tracks_parent_max=max(tracks_parent_sizes),
        rss_curve=rss_curve[:: max(1, len(rss_curve) // 12)] + rss_curve[-1:],
    )


def evaluate(video_dir, out_folder) -> dict:
    """Pose AUCs and mean errors against the fixture (JAX
    benchmark_long.py:156-170)."""
    gts = np.load(f"{video_dir}/gt_ob_in_cam.npy")
    model_pts = np.load(f"{video_dir}/gt_model_points.npy")
    pred_files = sorted(glob.glob(f"{out_folder}/ob_in_cam/*.txt"))
    preds = np.stack([np.loadtxt(f).reshape(4, 4) for f in pred_files])
    gts = gts[: len(preds)]
    res = metrics.trajectory_add_auc(preds, gts, model_pts, max_val=0.1)
    return {
        "n_frames": len(preds),
        "ADD_AUC": round(res["add_auc"] * 100, 2),
        "ADDS_AUC": round(res["adds_auc"] * 100, 2),
        "mean_ADD_cm": round(res["mean_add"] * 100, 3),
        "mean_ADDS_cm": round(res["mean_adds"] * 100, 3),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="a long run on the hard fixture")
    ap.add_argument("--out", default="", help="default: EVAL_long.json in the workdir")
    ap.add_argument("--matcher", default="corner")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--deg", type=float, default=2.5)
    ap.add_argument("--sync_delay", type=int, default=3)
    ap.add_argument("--extend", type=int, default=None, help="override cfg_nof n_step_extend")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "synth_long"))
    ap.add_argument("--skip_gen", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the long benchmark; returns the report."""
    args = parse_args(argv)
    out_path = args.out or os.path.join(args.workdir, "EVAL_long.json")
    video_dir = os.path.join(args.workdir, "video")
    if not args.skip_gen or not os.path.isdir(video_dir):
        make_hard_video(video_dir, n_frames=args.frames, deg_step=args.deg)
        print("fixture:", video_dir, flush=True)
    out_folder = os.path.join(args.workdir, f"out_{args.matcher}")
    stats = run_long(video_dir, out_folder, args.matcher, args.sync_delay,
                     n_step_extend=args.extend, device=args.device)
    report = {
        "fixture": {
            "frames": args.frames,
            "deg_per_frame": args.deg,
            "total_rotation_deg": args.deg * (args.frames - 1),
            "occluder": True,
            "sync_max_delay": args.sync_delay,
            "n_step_extend": args.extend,
        },
        args.matcher: {**evaluate(video_dir, out_folder), **stats},
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report[args.matcher], indent=1))
    print("wrote", out_path)
    return report


if __name__ == "__main__":
    main()
