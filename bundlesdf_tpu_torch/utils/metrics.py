"""Pose and mesh evaluation metrics: ADD, ADD-S, their AUC over a
trajectory, and the chamfer distance (the port's own copy of
``bundlesdf_tpu/utils/metrics.py``).

Behavioral parity with the reference (Utils.py:82-103 add_err/adi_err,
Utils.py:175-198 compute_auc, benchmark_ho3d.py:62 first-frame alignment,
benchmark_ho3d.py:119-128 chamfer).  Host-side numpy/scipy: evaluation is
off the hot path.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def to_homo(pts: np.ndarray) -> np.ndarray:
    return np.concatenate([pts, np.ones((len(pts), 1), dtype=pts.dtype)], axis=-1)


def add_err(pred: np.ndarray, gt: np.ndarray, model_pts: np.ndarray) -> float:
    """Average Distance of Model Points (reference Utils.py:82-90)."""
    pred_pts = (pred @ to_homo(model_pts).T).T[:, :3]
    gt_pts = (gt @ to_homo(model_pts).T).T[:, :3]
    return float(np.linalg.norm(pred_pts - gt_pts, axis=1).mean())


def adi_err(pred: np.ndarray, gt: np.ndarray, model_pts: np.ndarray) -> float:
    """ADD-S: nearest-neighbour variant (reference Utils.py:92-103)."""
    pred_pts = (pred @ to_homo(model_pts).T).T[:, :3]
    gt_pts = (gt @ to_homo(model_pts).T).T[:, :3]
    nn_dists, _ = cKDTree(pred_pts).query(gt_pts, k=1, workers=-1)
    return float(nn_dists.mean())


def compute_auc(rec, max_val: float = 0.1) -> float:
    """VOC-style AUC of the error-recall curve up to ``max_val``
    (reference Utils.py:175-198)."""
    if len(rec) == 0:
        return 0.0
    rec = np.sort(np.array(rec, dtype=np.float64))
    n = len(rec)
    prec = np.arange(1, n + 1) / float(n)
    index = np.where(rec < max_val)[0]
    rec = rec[index]
    prec = prec[index]
    if len(prec) == 0:
        return 0.0
    mrec = np.array([0.0, *rec.tolist(), max_val])
    mpre = np.array([0.0, *prec.tolist(), prec[-1]])
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    i = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[i] - mrec[i - 1]) * mpre[i]) / max_val)


def chamfer_distance(pts_a: np.ndarray, pts_b: np.ndarray) -> float:
    """Mutual (symmetric) chamfer distance: the mean of both one-way
    nearest-neighbour means (JAX utils/metrics.py:63-73)."""
    d_ab, _ = cKDTree(pts_b).query(pts_a, k=1, workers=-1)
    d_ba, _ = cKDTree(pts_a).query(pts_b, k=1, workers=-1)
    return float((d_ab.mean() + d_ba.mean()) / 2.0)


def align_to_first_frame(preds: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """``aligned_i = pred_i @ inv(pred_0) @ gt_0`` (reference
    benchmark_ho3d.py:62): only relative tracking error is measured."""
    offset = np.linalg.inv(preds[0]) @ gts[0]
    return np.einsum("nij,jk->nik", preds, offset)


def trajectory_add_auc(preds: np.ndarray, gts: np.ndarray, model_pts: np.ndarray,
                       max_val: float = 0.1, align_first: bool = True) -> dict:
    """ADD / ADD-S errors + AUCs over a trajectory (the HO3D headline metric)."""
    if align_first:
        preds = align_to_first_frame(preds, gts)
    adds, adis = [], []
    for p, g in zip(preds, gts):
        adds.append(add_err(p, g, model_pts))
        adis.append(adi_err(p, g, model_pts))
    return {
        "add_errs": np.array(adds),
        "adi_errs": np.array(adis),
        "add_auc": compute_auc(adds, max_val),
        "adds_auc": compute_auc(adis, max_val),
        "mean_add": float(np.mean(adds)),
        "mean_adds": float(np.mean(adis)),
    }
