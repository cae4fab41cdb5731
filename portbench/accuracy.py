"""Pose error against the video's ground truth: the ADD arithmetic of
``bundlesdf_tpu_torch/utils/metrics.py`` (reference Utils.py:82-90 and
benchmark_ho3d.py:62's first-frame alignment), frozen here, and the
frame-to-frame motion error built on it.  Host numpy in float64.
"""
from __future__ import annotations

import numpy as np


def to_homo(pts: np.ndarray) -> np.ndarray:
    return np.concatenate([pts, np.ones((len(pts), 1), dtype=pts.dtype)], axis=-1)


def add_err(pred: np.ndarray, gt: np.ndarray, model_pts: np.ndarray) -> float:
    """Average distance of the model points under the two poses."""
    pred_pts = (pred @ to_homo(model_pts).T).T[:, :3]
    gt_pts = (gt @ to_homo(model_pts).T).T[:, :3]
    return float(np.linalg.norm(pred_pts - gt_pts, axis=1).mean())


def align_to_first_frame(preds: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """``aligned_i = pred_i @ inv(pred_0) @ gt_0``: only relative tracking
    error is measured."""
    offset = np.linalg.inv(preds[0]) @ gts[0]
    return np.einsum("nij,jk->nik", preds, offset)


def session_errors(preds: np.ndarray, gts: np.ndarray, model_pts: np.ndarray) -> dict:
    """One session's per-frame ADD (m, first frame aligned) and the ADD of
    each frame-to-frame motion (m): frame k's pose when frame k-1 is
    aligned to the truth, ``T_k inv(T_{k-1}) G_{k-1}`` against ``G_k`` (the
    motion in the camera, so the tracker's choice of model origin drops
    out).  ``preds``, ``gts``: (n, 4, 4) object-in-camera poses."""
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    aligned = align_to_first_frame(preds, gts)
    add = [add_err(p, g, model_pts) for p, g in zip(aligned, gts)]
    motion = [add_err(preds[k] @ np.linalg.inv(preds[k - 1]) @ gts[k - 1], gts[k], model_pts)
              for k in range(1, len(preds))]
    return {"add": add, "motion": motion}
