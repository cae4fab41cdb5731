"""Neural Object Field networks: hash-grid SDF + color MLP, per-frame pose
correction, per-frame latent features (port of
``bundlesdf_tpu/models/nof.py``; reference nerf_helpers.py:243-321
NeRFSmall, :127-154 PoseArray, :108-124 FeatureArray).

Parameters are a plain dict of tensors with the JAX pytree's structure and
layouts: the flat ``(total_entries * C,)`` hash table, ``sigma`` and
``color`` MLP weights stored ``(in, out)`` and applied as ``x @ w + b``, and
the ``(num_frames, 6)`` pose array.  ``params_from_jax`` therefore converts
the JAX params without any transpose.

Architecture (parity with create_nerf):
  sigma net : Linear(in -> 64) . ReLU . Linear(64 -> 1 + 15); last bias
              init +0.1;
  color net : Linear(sh + frame_feat + 15 -> 64) . ReLU . Linear(64 -> 64)
              . ReLU . Linear(64 -> 3).
The matmuls are plain ``torch.matmul``, as the JAX package leaves them to
XLA.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import hashgrid, sh
from ..utils import se3
from ..utils.device import resolve_device


class NofSpec(NamedTuple):
    """Static NOF architecture spec (same fields as the JAX spec)."""

    grid: hashgrid.HashGridSpec
    sh_degree: int = 3
    frame_features: int = 0
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_frames: int = 128
    max_trans: float = 0.02  # already in normalized units (x sc_factor)
    max_rot_deg: float = 20.0
    optimize_poses: bool = True

    @property
    def input_ch(self) -> int:
        return self.grid.out_dim

    @property
    def input_ch_views(self) -> int:
        return sh.sh_out_dim(self.sh_degree) + self.frame_features


def _linear_init(fan_in: int, fan_out: int, generator):
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    weight stored (fan_in, fan_out)."""
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.rand((fan_in, fan_out), generator=generator)
    b = torch.rand((fan_out,), generator=generator)
    return w * (2 * bound) - bound, b * (2 * bound) - bound


def init_nof_params(spec: NofSpec, seed: int = 0, device=None) -> dict:
    """Seeded initialisation with the JAX init's distributions (the values
    differ: ``jax.random`` streams cannot be reproduced in torch).  The
    values are drawn on the CPU and moved to ``device``, so a seed gives the
    same weights on every device.  Every leaf is an f32 leaf tensor with
    ``requires_grad``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    h, g = spec.hidden_dim, spec.geo_feat_dim
    s_w0, s_b0 = _linear_init(spec.input_ch, h, gen)
    s_w1, s_b1 = _linear_init(h, 1 + g, gen)
    s_b1 = torch.full_like(s_b1, 0.1)  # positive-SDF bias (reference NeRFSmall init)
    c_in = spec.input_ch_views + g
    c_w0, c_b0 = _linear_init(c_in, h, gen)
    c_w1, c_b1 = _linear_init(h, h, gen)
    c_w2, c_b2 = _linear_init(h, 3, gen)
    params = {
        "table": hashgrid.init_table(spec.grid, generator=gen),
        "sigma": {"w0": s_w0, "b0": s_b0, "w1": s_w1, "b1": s_b1},
        "color": {"w0": c_w0, "b0": c_b0, "w1": c_w1, "b1": c_b1, "w2": c_w2,
                  "b2": c_b2},
        "pose_array": torch.zeros((spec.num_frames, 6)),
    }
    if spec.frame_features > 0:
        params["feature_array"] = torch.randn(
            (spec.num_frames, spec.frame_features), generator=gen)
    return _as_leaves(params, dev)


def _as_leaves(tree, device):
    if isinstance(tree, dict):
        return {k: _as_leaves(v, device) for k, v in tree.items()}
    return tree.detach().to(device, torch.float32).contiguous().requires_grad_(True)


def params_from_jax(params_np: dict, device=None) -> dict:
    """JAX NOF param pytree (arrays convertible with ``np.asarray``) ->
    the port's parameter dict.  Layouts are shared, so no leaf is
    transposed: the flat table, the ``(in, out)`` MLP weights and the pose
    array keep their shapes."""
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree, dtype=np.float32))

    return _as_leaves(conv(dict(params_np)), dev)


def params_to_numpy(params: dict) -> dict:
    """The inverse of ``params_from_jax``: a nested dict of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def pose_array_matrices(pose_data: torch.Tensor, spec: NofSpec,
                        ids: torch.Tensor) -> torch.Tensor:
    """Per-frame tanh-bounded 6-DoF correction -> (len(ids), 4, 4); frame 0
    pinned to identity (reference PoseArray.get_matrices,
    nerf_helpers.py:142-154)."""
    theta = torch.tanh(pose_data)
    trans = theta[:, :3] * spec.max_trans
    rot = theta[:, 3:6] * (spec.max_rot_deg / 180.0 * np.pi)
    Ts = se3.se3_exp(torch.cat([trans, rot], dim=-1))
    eye = torch.eye(4, dtype=Ts.dtype, device=Ts.device)
    first = (torch.arange(pose_data.shape[0], device=Ts.device) == 0)[:, None, None]
    Ts = torch.where(first, eye, Ts)
    return Ts[ids]


def _mlp_sigma(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w0"] + params["b0"])
    return h @ params["w1"] + params["b1"]  # (..., 1 + geo_feat)


def _mlp_color(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w0"] + params["b0"])
    h = torch.relu(h @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]  # (..., 3)


def nof_forward(params: dict, spec: NofSpec, pts: torch.Tensor,
                viewdirs: torch.Tensor, frame_ids: torch.Tensor):
    """Full field query.

    Args:
      pts: (N, S, 3) points in the normalized object frame ([-1,1]^3).
      viewdirs: (N, 3) unit view directions in the object frame.
      frame_ids: (N,) int frame indices (for per-frame features).
    Returns:
      raw: (N, S, 4) = [rgb_logits(3), sdf(1)]; valid: (N, S) inside-cube.
    """
    N, S = pts.shape[:2]
    flat = pts.reshape(-1, 3)
    valid = torch.all(torch.abs(flat) <= 1.0, dim=-1).reshape(N, S)
    emb = hashgrid.encode(flat, params["table"], spec.grid, n_rays=N)
    emb = torch.where(valid.reshape(-1, 1), emb, 0.0)  # reference zeroes invalid
    h = _mlp_sigma(params["sigma"], emb)  # (N*S, 1+g)
    sdf = h[:, :1]
    geo = h[:, 1:]
    dirs_emb = sh.sh_encode(viewdirs, spec.sh_degree)  # (N, sh)
    if spec.frame_features > 0:
        feats = params["feature_array"][frame_ids]  # (N, F)
        dirs_emb = torch.cat([dirs_emb, feats], dim=-1)
    dirs_flat = dirs_emb[:, None, :].expand(N, S, dirs_emb.shape[-1])
    c_in = torch.cat([dirs_flat.reshape(N * S, -1), geo], dim=-1)
    rgb = _mlp_color(params["color"], c_in)
    raw = torch.cat([rgb, sdf], dim=-1).reshape(N, S, 4)
    return raw, valid


def nof_sdf(params: dict, spec: NofSpec, pts: torch.Tensor) -> torch.Tensor:
    """SDF-only query (reference forward_sdf).  pts: (N, 3) -> (N,)."""
    emb = hashgrid.encode(pts, params["table"], spec.grid)
    h = _mlp_sigma(params["sigma"], emb)
    return h[:, 0]
