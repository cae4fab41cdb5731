"""The online loop's quality on the hard synthetic fixture, once per matcher
engine (port of ``scripts/benchmark_synth.py``).

It writes the fixture (``scripts/synth_hard.py``: non-convex textured blob,
90 degrees and more of rotation, a moving finger occluder, correlated depth
noise), runs the online tracking + NOF loop on it for each engine, and
reports ADD and ADD-S AUC and mean errors (first frame aligned, 0.1 m AUC
threshold, as ``benchmark_ho3d``), the online mesh's mean distance to the
analytic surface, wall time, fps and a span profile.  ``--global_refine``
then runs the offline refinement on the first engine's trail
(``entry.run_global_refine``) and reports its textured mesh's distance.
The report's keys are the JAX script's.

    python3 -m bundlesdf_tpu_torch.scripts.benchmark_synth \\
        [--matchers corner,sift] [--frames 14] [--deg 7] [--workdir DIR] \\
        [--out FILE.json] [--global_refine [--refine_steps N]] [--device cpu]

``--workdir`` defaults to ``synth_hard`` under the temporary directory and
``--out`` to ``EVAL_synth.json`` in the workdir.  A run that raises fails:
there is no retry.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil
import tempfile
import time

import numpy as np

from ..config import default_nof_config, ycbineoat_track_config
from ..io.imgproc import erode_square
from ..io.readers import YcbineoatReader
from ..pipeline.bundlesdf import BundleSdf
from ..utils import metrics, profiler
from ..utils.mesh import load_obj
from .synth_hard import blob_surface_distance, make_hard_video


def engine_configs(video_dir, out_folder, matcher, loftr_ckpt="", sync_max_delay=None,
                   n_step_extend=None):
    """The tracker and NOF configs of one engine's run (JAX
    benchmark_synth.py:31-77): the YCBInEOAT tracker config (its 3 cm
    neighbour gate fits the fixture's ~2.2 cm camera step), the artifact
    trail at SPDLOG 2, the ray pool reserved for the whole video.  An
    engine ``name:split`` turns the fused match + BA program off."""
    cfg_track = ycbineoat_track_config()
    variant = ""
    if ":" in matcher:
        matcher, variant = matcher.split(":", 1)
    if variant == "split":
        cfg_track["bundle"]["fused_ba"] = False
    cfg_track["feature_corres"]["matcher"] = matcher
    if loftr_ckpt:
        cfg_track["feature_corres"]["loftr_ckpt"] = loftr_ckpt
    cfg_track["depth_processing"]["zfar"] = 1.0
    cfg_track["debug_dir"] = out_folder
    cfg_track["SPDLOG"] = max(2, int(cfg_track.get("SPDLOG", 1)))
    cfg_nof = default_nof_config()
    cfg_nof["save_dir"] = out_folder
    if sync_max_delay is not None:
        cfg_nof["sync_max_delay"] = int(sync_max_delay)
    if n_step_extend is not None:
        cfg_nof["n_step_extend"] = int(n_step_extend)
    n_video = len(os.listdir(os.path.join(video_dir, "rgb")))
    cfg_nof["ray_pool_reserve_log2"] = min(
        23, max(20, math.ceil(math.log2(max(1, n_video) * 120_000))))
    return cfg_track, cfg_nof


def run_engine(video_dir, out_folder, matcher, loftr_ckpt="", sync_max_delay=None,
               n_step_extend=None, device=None):
    """Track the fixture with one engine; returns (wall_s, warm_fps, n_fail,
    failed_frames, profile)."""
    profiler.reset()
    cfg_track, cfg_nof = engine_configs(video_dir, out_folder, matcher, loftr_ckpt,
                                        sync_max_delay, n_step_extend)
    os.makedirs(out_folder, exist_ok=True)
    cfg_track.save(f"{out_folder}/config_track.yml")
    cfg_nof.save(f"{out_folder}/config_nerf.yml")

    reader = YcbineoatReader(video_dir=video_dir, shorter_side=480)
    tracker = BundleSdf(cfg_track=cfg_track, cfg_nof=cfg_nof, out_dir=out_folder,
                        use_nof=True, save_artifacts=True, device=device)
    t0 = time.perf_counter()
    n_fail, failed_frames, t_marks = 0, [], []
    half_snapshot, half_steps = None, 0
    n_total = len(reader.color_files)
    try:
        for i in range(n_total):
            mask = reader.get_mask(i)
            if i == 0:
                mask = erode_square(mask.astype(np.uint8), 5)
            occ = reader.get_occ_mask(i)
            occ = occ if occ is not None and occ.any() else None
            frame = tracker.run(reader.get_color(i), reader.get_depth(i), reader.K,
                                reader.id_strs[i], mask=mask, occ_mask=occ)
            t_marks.append(time.perf_counter())
            if i == n_total // 2:
                # the second half's window (warm_fps's): the overlap metrics
                # over it leave out the first half's one-time costs
                half_snapshot = {k: dict(v) for k, v in profiler.stats().items()}
                half_steps = tracker.nof.total_step if tracker.nof is not None else 0
            if frame is not None and int(getattr(frame, "status", 0)) != 0:
                n_fail += 1
                failed_frames.append(i)
    finally:
        reader.close()
    # the warm window ends with the loop: on_finish's drains fall outside it
    loop_snapshot = {k: dict(v) for k, v in profiler.stats().items()}
    loop_steps = tracker.nof.total_step if tracker.nof is not None else 0
    mesh = tracker.on_finish()
    wall = time.perf_counter() - t0
    half = len(t_marks) // 2
    warm_fps = ((len(t_marks) - 1 - half) / (t_marks[-1] - t_marks[half])
                if len(t_marks) - 1 > half else 0.0)
    if mesh is not None:
        mesh.export(f"{out_folder}/mesh_online.obj")
    st = profiler.stats()
    prof = {
        k: {"count": v["count"], "total_s": round(v["total_s"], 2)}
        for k, v in sorted(st.items(), key=lambda kv: -kv[1]["total_s"])
        if v["total_s"] >= 0.5 or k.startswith(("launch/", "readback/"))
    }
    n_frames = len(t_marks)

    def window(stats_now, stats_base, steps_now, steps_base, wall_w, n_fr):
        """How much NOF time hid under tracking, and the launches and
        blocking readbacks a frame, over one window (JAX
        benchmark_synth.py:150-184)."""
        d = {}
        for k, v in stats_now.items():
            base = (stats_base or {}).get(k, {"count": 0, "total_s": 0.0})
            d[k] = {"count": v["count"] - base["count"],
                    "total_s": v["total_s"] - base["total_s"]}
        out = {}
        if tracker.nof is not None and getattr(tracker.nof, "_step_ms", 0.0):
            step_ms = float(tracker.nof._step_ms)
            nof_device_s = (steps_now - steps_base) * step_ms / 1e3
            blocked_s = sum(d.get(k, {"total_s": 0.0})["total_s"]
                            for k in ("nof/sync_wait", "nof/train_drain"))
            out.update({
                "nof_steps": int(steps_now - steps_base),
                "nof_step_ms": round(step_ms, 2),
                "nof_device_s": round(nof_device_s, 2),
                "blocked_wait_s": round(blocked_s, 2),
                "overlap_frac": round(max(0.0, 1.0 - blocked_s / max(nof_device_s, 1e-9)), 3),
                "wall_minus_nof_device_s": round(wall_w - nof_device_s, 2),
            })
        launches = sum(v["count"] for k, v in d.items() if k.startswith("launch/"))
        readbacks = sum(v["count"] for k, v in d.items() if k.startswith("readback/"))
        out["launches_per_frame"] = round(launches / max(n_fr, 1), 2)
        out["readbacks_per_frame"] = round(readbacks / max(n_fr, 1), 2)
        return out

    steps_total = tracker.nof.total_step if tracker.nof is not None else 0
    prof["overlap"] = window(st, None, steps_total, 0, wall, n_frames)
    if half_snapshot is not None:
        prof["overlap_warm"] = window(loop_snapshot, half_snapshot, loop_steps, half_steps,
                                      t_marks[-1] - t_marks[half], n_frames - 1 - half)
    prof["launches_per_frame"] = prof["overlap"].pop("launches_per_frame")
    prof["readbacks_per_frame"] = prof["overlap"].pop("readbacks_per_frame")
    return wall, warm_fps, n_fail, failed_frames, prof


def run_global_refine(video_dir, out_folder, refine_steps=None, device=None):
    """The offline refinement on the online trail (``entry.
    run_global_refine``, which reads cam_K.txt beside ``out_folder``); the
    wall time.  The textured mesh lands at out_folder/textured_mesh.obj."""
    from ..entry import run_global_refine as refine

    k_src = os.path.join(video_dir, "cam_K.txt")
    k_dst = os.path.join(os.path.dirname(out_folder), "cam_K.txt")
    if os.path.exists(k_src) and not os.path.exists(k_dst):
        shutil.copy(k_src, k_dst)
    t0 = time.perf_counter()
    refine(out_folder, refine_steps=refine_steps, get_texture=True, device=device)
    return time.perf_counter() - t0


def evaluate(video_dir, out_folder, mesh_name="mesh_online.obj"):
    """Pose AUCs and mean errors of ``out_folder/ob_in_cam`` against the
    fixture, and the mesh's mean distance to the blob (cm), as the JAX
    script's ``evaluate``."""
    gts = np.load(f"{video_dir}/gt_ob_in_cam.npy")
    model_pts = np.load(f"{video_dir}/gt_model_points.npy")
    pred_files = sorted(glob.glob(f"{out_folder}/ob_in_cam/*.txt"))
    preds = np.stack([np.loadtxt(f).reshape(4, 4) for f in pred_files])
    gts = gts[: len(preds)]
    res = metrics.trajectory_add_auc(preds, gts, model_pts, max_val=0.1)
    out = {
        "n_frames": len(preds),
        "ADD_AUC": round(res["add_auc"] * 100, 2),
        "ADDS_AUC": round(res["adds_auc"] * 100, 2),
        "mean_ADD_cm": round(res["mean_add"] * 100, 3),
        "mean_ADDS_cm": round(res["mean_adds"] * 100, 3),
    }
    mesh_file = f"{out_folder}/{mesh_name}"
    if os.path.exists(mesh_file):
        # the mesh is in the object frame of the first prediction: move it
        # into the ground truth's, crop floaters outside the object's extent
        v = load_obj(mesh_file).vertices
        if len(v):
            T = np.linalg.inv(gts[0]) @ preds[0]
            v = v @ T[:3, :3].T + T[:3, 3]
            v = v[np.linalg.norm(v, axis=-1) < 0.3]
            if len(v):
                out["mesh_mean_dist_cm"] = round(
                    float(np.mean(blob_surface_distance(v))) * 100, 3)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="online-loop quality on the hard fixture")
    ap.add_argument("--out", default="", help="default: EVAL_synth.json in the workdir")
    ap.add_argument("--matchers", default="corner,sift")
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--deg", type=float, default=7.0)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "synth_hard"))
    ap.add_argument("--skip_gen", action="store_true")
    ap.add_argument("--skip_online", action="store_true",
                    help="reuse existing out_<matcher> run directories")
    ap.add_argument("--loftr_ckpt", default="", help="weights for the loftr engine")
    ap.add_argument("--sync_delay", type=int, default=None,
                    help="override cfg_nof sync_max_delay")
    ap.add_argument("--extend", type=int, default=None,
                    help="override cfg_nof n_step_extend (steps per continual NOF "
                         "extension round)")
    ap.add_argument("--global_refine", action="store_true",
                    help="after the first matcher's online run, run the offline global "
                         "refinement and report its mesh")
    ap.add_argument("--refine_steps", type=int, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark; returns the report."""
    args = parse_args(argv)
    out_path = args.out or os.path.join(args.workdir, "EVAL_synth.json")
    video_dir = os.path.join(args.workdir, "video")
    if not args.skip_gen or not os.path.isdir(video_dir):
        make_hard_video(video_dir, n_frames=args.frames, deg_step=args.deg)
        print("fixture:", video_dir, flush=True)

    report = {}
    if os.path.isfile(out_path):
        # merge: a one-engine rerun keeps the other engines' sections
        with open(out_path) as f:
            report = json.load(f)
    fixture = {
        "frames": args.frames,
        "total_rotation_deg": args.deg * (args.frames - 1),
        "occluder": True,
        "depth_noise_m": 0.0015,
        "noise_model": "spatially-correlated (10 px) + 2% dropout + mm quantization",
    }
    if args.sync_delay is not None:
        fixture["sync_max_delay"] = args.sync_delay
    if args.extend is not None:
        fixture["n_step_extend"] = args.extend
    # sections measured on another fixture are dropped
    fix_key = json.dumps(fixture, sort_keys=True)
    for k in [k for k, v in report.items()
              if isinstance(v, dict) and k != "fixture"
              and json.dumps(v.get("fixture", None), sort_keys=True) != fix_key]:
        print(f"dropping stale section {k!r} (fixture mismatch)", flush=True)
        del report[k]
    report["fixture"] = fixture
    matchers = [m.strip() for m in args.matchers.split(",") if m.strip()]
    for m in matchers:
        out_folder = os.path.join(args.workdir, f"out_{m.replace(':', '_')}")
        prof = None
        if not args.skip_online:
            wall, warm_fps, n_fail, failed, prof = run_engine(
                video_dir, out_folder, m, loftr_ckpt=args.loftr_ckpt,
                sync_max_delay=args.sync_delay, n_step_extend=args.extend,
                device=args.device)
        else:
            wall, warm_fps, n_fail, failed = 0.0, 0.0, -1, []
        r = evaluate(video_dir, out_folder)
        if wall:
            r["wall_s"] = round(wall, 1)
            r["fps"] = round(args.frames / wall, 4)
            r["warm_fps"] = round(warm_fps, 4)
            r["n_tracking_fail"] = n_fail
            r["failed_frames"] = failed
        if prof:
            r["profile"] = prof
        r["fixture"] = fixture
        report[m] = r
        print(m, json.dumps(r), flush=True)

    if args.global_refine and matchers:
        out_folder = os.path.join(args.workdir, f"out_{matchers[0].replace(':', '_')}")
        wall = run_global_refine(video_dir, out_folder, refine_steps=args.refine_steps,
                                 device=args.device)
        r = evaluate(video_dir, out_folder, mesh_name="textured_mesh.obj")
        report["global_refine"] = {
            "matcher": matchers[0], "refine_steps": args.refine_steps or 2000,
            "mesh_mean_dist_cm": r.get("mesh_mean_dist_cm"), "textured": True,
            "wall_s": round(wall, 1), "fixture": fixture}
        print("global_refine", json.dumps(report["global_refine"]), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", out_path)
    return report


if __name__ == "__main__":
    main()
