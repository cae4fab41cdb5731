"""Truncated-SDF training losses (port of ``bundlesdf_tpu/nof/losses.py``;
reference nerf_helpers.py:367-399 get_masks/get_sdf_loss, assembled in
nerf_runner.py:677-760 train_loop).
"""
from __future__ import annotations

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


def eikonal_mask(sdf):
    """The eikonal term's near-surface samples (sdf < 1), as a float mask."""
    return (sdf < 1.0).to(sdf.dtype)


def eikonal_loss(normals, sdf, count=None):
    """(|grad sdf| - 1)^2 over near-surface samples (reference
    nerf_runner.py:733-736: masked mean over sdf < 1).  ``count``: the
    mean's denominator when the batch is split over ranks (the
    all-reduced ``eikonal_mask(sdf).sum()``); this batch's count when
    absent."""
    mask = eikonal_mask(sdf).to(normals.dtype)
    err = (torch.linalg.norm(normals, dim=-1) - 1.0) ** 2 * mask
    count = torch.sum(mask) if count is None else count
    return torch.sum(err) / torch.clamp(count, min=1.0)


def truncation_value(step, n_step, trunc, trunc_start, sc_factor,
                     decay_type: str = ""):
    """Truncation annealing (reference nerf_runner.py:661-674), in
    normalized units (x sc_factor).  ``step``: an int or an int tensor (the
    train step's device counter); the ``linear`` and ``exp`` decays are
    computed in f32 on its device, as the JAX step computes them on a
    traced step."""
    if decay_type not in ("linear", "exp"):
        return trunc * sc_factor
    s = torch.as_tensor(step).to(torch.float32)
    if decay_type == "linear":
        t = trunc_start - (trunc_start - trunc) * (s / n_step)
    else:
        lamb = torch.log(torch.full((), trunc / trunc_start, device=s.device)) / (n_step / 4)
        t = torch.clamp(trunc_start * torch.exp(s * lamb), min=trunc)
    return t * sc_factor
