"""Truncated-SDF training losses (port of ``bundlesdf_tpu/nof/losses.py``;
reference nerf_helpers.py:367-399 get_masks/get_sdf_loss, assembled in
nerf_runner.py:677-760 train_loop).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class LossWeights(NamedTuple):
    """Static loss weights (reference config.yml:60-87)."""

    rgb_weight: float = 10.0
    fs_weight: float = 100.0
    empty_weight: float = 0.01
    trunc_weight: float = 6000.0
    fs_sdf: float = 0.001
    neg_trunc_ratio: float = 1.0
    first_frame_weight: float = 10.0
    feature_reg_weight: float = 0.1
    pose_reg_weight: float = 0.0
    near: float = 0.1
    far: float = 2.0
    sc_factor: float = 1.0
    depth_weight: float = 0.0
    fs_rgb_weight: float = 0.0
    eikonal_weight: float = 0.0


def sdf_masks(z_vals, target_d, truncation, w: LossWeights):
    """front/sdf sample masks (reference get_masks nerf_helpers.py:367-381)."""
    valid_depth = (target_d >= w.near * w.sc_factor) & (target_d <= w.far * w.sc_factor)
    front = z_vals < target_d - truncation
    back = z_vals > target_d + truncation * w.neg_trunc_ratio
    sdf_mask = (~front) & (~back) & valid_depth
    return front, sdf_mask


def sdf_losses(z_vals, target_d, sdf, truncation, sample_weights, w: LossWeights):
    """Free-space + empty + truncated-SDF losses (reference get_sdf_loss
    nerf_helpers.py:384-399).  Args are (N, S) tensors; target_d is
    (N, 1)-broadcastable.  Returns (fs_loss, sdf_loss) before the cfg
    fs_weight / trunc_weight multipliers."""
    front, sdf_mask = sdf_masks(z_vals, target_d, truncation, w)
    fs_weight_i, sdf_weight_i = 0.5, 0.5

    m_fs = (target_d > w.far * w.sc_factor) & (sdf < w.fs_sdf)
    fs_loss = torch.mean(((sdf - w.fs_sdf) * m_fs) ** 2 * sample_weights) * fs_weight_i

    m_e = front & (target_d <= w.far * w.sc_factor) & (sdf < 1.0)
    empty_loss = torch.mean(torch.abs(sdf - 1.0) * m_e * sample_weights) * w.empty_weight
    fs_loss = fs_loss + empty_loss

    m_s = sdf_mask.to(sdf.dtype)
    sdf_loss = (
        torch.mean(((z_vals + sdf * truncation) * m_s - target_d * m_s) ** 2
                   * sample_weights) * sdf_weight_i
    )
    return fs_loss, sdf_loss


def depth_loss(z_vals, sdf, target_d, ray_w, w: LossWeights):
    """First-zero-crossing rendered depth vs measured depth (reference
    nerf_runner.py:709-719)."""
    signs = sdf[:, 1:] * sdf[:, :-1]
    crossing = signs < 0
    inds = torch.argmax(crossing.to(torch.float32), dim=1)
    z_min = torch.gather(z_vals, 1, inds[:, None])[:, 0]
    wt = (
        ray_w
        * (target_d <= w.far * w.sc_factor).to(z_vals.dtype)
        * crossing.any(dim=-1).to(z_vals.dtype)
    )
    return torch.mean((z_min * wt - target_d * wt) ** 2)


def fs_rgb_loss(rgb_logits, front_mask, sample_weights):
    """Push free-space color to white (reference nerf_runner.py:728-731)."""
    err = (torch.sigmoid(rgb_logits) - 1.0) * front_mask[..., None]
    return torch.mean(err ** 2 * sample_weights[..., None])


def eikonal_loss(normals, sdf):
    """(|grad sdf| - 1)^2 over near-surface samples (reference
    nerf_runner.py:733-736: masked mean over sdf < 1)."""
    mask = (sdf < 1.0).to(normals.dtype)
    err = (torch.linalg.norm(normals, dim=-1) - 1.0) ** 2 * mask
    return torch.sum(err) / torch.clamp(torch.sum(mask), min=1.0)


def truncation_value(step, n_step, trunc, trunc_start, sc_factor,
                     decay_type: str = ""):
    """Truncation annealing (reference nerf_runner.py:661-674), in
    normalized units (x sc_factor).  ``step`` is a Python number."""
    if decay_type == "linear":
        t = trunc_start - (trunc_start - trunc) * (step / n_step)
    elif decay_type == "exp":
        lamb = math.log(trunc / trunc_start) / (n_step / 4)
        t = max(trunc_start * math.exp(step * lamb), trunc)
    else:
        t = trunc
    return t * sc_factor
