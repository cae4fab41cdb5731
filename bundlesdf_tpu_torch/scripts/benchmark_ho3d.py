"""HO3D evaluation of tracked runs (port of ``scripts/benchmark_ho3d.py:
22-139``): ADD / ADD-S AUC to 10 cm, first-frame aligned, and the mesh's
chamfer distance to the visible ground-truth shell after ICP.

    python3 -m bundlesdf_tpu_torch.scripts.benchmark_ho3d --ho3d_dir HO3D_v3 \\
        --out_dir OUT [--video_names SM1 ...]

prints one JSON line a video and the aggregate, and writes both to
``{out_dir}/benchmark.json``.  Nearest neighbours are scipy ``cKDTree`` on
the host, as in JAX; the ICP's Kabsch step runs through ``utils/se3.kabsch``
in float32 on ``--device`` (default: the CUDA card; without one it raises).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..io.readers import Ho3dReader
from ..io.scene_bounds import voxel_downsample
from ..utils import metrics, se3
from ..utils.device import resolve_device
from ..utils.mesh import Mesh, largest_component, load_obj, load_ply


def icp_align(src_pts, dst_pts, iters=20, thres=0.02, device=None):
    """Point-to-point ICP (the JAX script's replacement for open3d
    registration_icp, benchmark_ho3d.py:124): returns (T, aligned src)."""
    dev = resolve_device(device)
    T = np.eye(4)
    cur = src_pts.copy()
    tree = cKDTree(dst_pts)
    for _ in range(iters):
        d, idx = tree.query(cur, k=1, workers=-1)
        keep = d < thres
        if keep.sum() < 10:
            break
        delta = se3.kabsch(
            torch.as_tensor(cur[keep], dtype=torch.float32, device=dev),
            torch.as_tensor(dst_pts[idx[keep]], dtype=torch.float32, device=dev),
        ).cpu().numpy()
        cur = cur @ delta[:3, :3].T + delta[:3, 3]
        T = delta @ T
    return T, cur


def mesh_chamfer_vs_visible(pred_mesh: Mesh, gt_pts: np.ndarray, pred_pose0: np.ndarray,
                            gt_pose0: np.ndarray, device=None) -> float:
    """ICP-aligned mutual chamfer (m) of a predicted mesh against the visible
    ground-truth shell (JAX :43-66): the mesh moved into the ground-truth
    object frame by ``inv(gt_pose0) @ pred_pose0``, cropped to the shell's
    box + 0.3 m, its largest component near the origin, 20000 surface
    samples on a 5 mm voxel grid, ICP (2 cm), chamfer."""
    T = np.linalg.inv(gt_pose0) @ pred_pose0
    verts = pred_mesh.vertices @ T[:3, :3].T + T[:3, 3]
    lo = gt_pts.min(axis=0) - 0.3
    hi = gt_pts.max(axis=0) + 0.3
    keep = ((verts >= lo) & (verts <= hi)).all(axis=-1)
    remap = -np.ones(len(verts), dtype=np.int64)
    remap[keep] = np.arange(keep.sum())
    fkeep = keep[pred_mesh.faces].all(axis=1)
    cropped = Mesh(verts[keep], remap[pred_mesh.faces[fkeep]])
    cropped = largest_component(cropped, near_origin=0.1)
    pred_pts = cropped.sample_surface(20000)
    pred_pts, _ = voxel_downsample(pred_pts, None, 0.005)
    _, aligned = icp_align(pred_pts, gt_pts, device=device)
    return metrics.chamfer_distance(aligned, gt_pts)


def benchmark_one_video(video_dir, out_folder, device=None) -> dict:
    """Pose AUCs of ``out_folder/ob_in_cam`` against the video's ground
    truth, and the chamfer of its textured (else online) mesh."""
    reader = Ho3dReader(video_dir)
    pred_files = sorted(glob.glob(f"{out_folder}/ob_in_cam/*.txt"))
    preds, gts = [], []
    for f in pred_files:
        id_str = os.path.basename(f).replace(".txt", "")
        gt = reader.get_gt_pose(reader.id_strs.index(id_str))
        if gt is None:
            continue
        preds.append(np.loadtxt(f).reshape(4, 4))
        gts.append(gt)
    preds = np.stack(preds)
    gts = np.stack(gts)

    gt_mesh = reader.get_gt_mesh()
    res = metrics.trajectory_add_auc(preds, gts, gt_mesh.vertices, max_val=0.1)
    out = {
        "video": reader.get_video_name(),
        "n_frames": len(preds),
        "ADD_AUC": res["add_auc"] * 100,
        "ADDS_AUC": res["adds_auc"] * 100,
        "mean_ADD_cm": res["mean_add"] * 100,
        "mean_ADDS_cm": res["mean_adds"] * 100,
    }
    # chamfer against the visible shell (visible_mesh.ply), the reference's
    # target: the full model would charge the surface no frame observed
    mesh_file = f"{out_folder}/textured_mesh.obj"
    if not os.path.exists(mesh_file):
        mesh_file = f"{out_folder}/mesh_online.obj"
    if os.path.exists(mesh_file):
        vis_ply = f"{video_dir}/visible_mesh.ply"
        if os.path.exists(vis_ply):
            gt_pts, _ = voxel_downsample(load_ply(vis_ply).vertices, None, 0.005)
        else:
            gt_pts = gt_mesh.sample_surface(20000)
            out["chamfer_vs_full_model"] = True  # explicit: weaker target
        out["chamfer_cm"] = mesh_chamfer_vs_visible(
            load_obj(mesh_file), gt_pts, preds[0], gts[0], device=device) * 100
    return out


def main(argv=None):
    """Benchmark every run folder; returns {"videos": rows, "aggregate": agg}
    (None when no video was found)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ho3d_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--video_names", nargs="*", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the ICP's Kabsch step (default: the CUDA card)")
    args = p.parse_args(argv)
    names = args.video_names or sorted(os.listdir(args.out_dir))
    rows = []
    for name in names:
        video_dir = f"{args.ho3d_dir}/evaluation/{name}"
        out_folder = f"{args.out_dir}/{name}"
        if not os.path.isdir(out_folder) or not os.path.isdir(video_dir):
            continue
        r = benchmark_one_video(video_dir, out_folder, device=args.device)
        rows.append(r)
        print(json.dumps(r))
    if not rows:
        return None
    agg = {
        "mean_ADD_AUC": float(np.mean([r["ADD_AUC"] for r in rows])),
        "mean_ADDS_AUC": float(np.mean([r["ADDS_AUC"] for r in rows])),
    }
    print(json.dumps({"aggregate": agg}))
    result = {"videos": rows, "aggregate": agg}
    with open(f"{args.out_dir}/benchmark.json", "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
