"""Neural Object Field training step (port of ``bundlesdf_tpu/nof/runner.py``
:45-284).

One step draws ``n_rand`` rays from the ray pool, renders them, sums the
losses, runs the backward (through the hash-grid encode's custom backward
and its CUDA kernels) and applies the global inf-norm clip and Adam.

Parity anchors (reference nerf_runner.py): optimizer :490-502 (Adam eps
1e-15, separate pose lr), lr decay every 10 steps :577-581, inf-norm clip
:648-658, losses :677-851.

PyTorch idiom: parameters are a dict of leaf tensors updated in place by
``torch.optim.Adam`` (the JAX step returns new arrays); the batch indices
and the sampling jitter are optional tensor arguments, drawn from a
``torch.Generator`` when absent.

Not ported yet: ``NofRunner`` (:300-1184) and CUDA-graph capture of the
step loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Cfg
from ..models import nof as nof_model
from . import losses as nof_losses
from . import render as nof_render


def param_leaves(tree) -> list:
    """The tensors of a (nested) parameter dict, in insertion order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in param_leaves(tree[k])]
    return [tree]


@torch.no_grad()
def clip_by_global_inf_norm(grads: list, max_norm: float) -> None:
    """Scale all grads in place by max_norm / max|g| when the global
    inf-norm exceeds max_norm (parity with torch clip_grad_norm_(norm_type=
    inf), nerf_runner.py:648-658, but with the JAX runner's eps of 1e-12;
    ``clip_grad_norm_`` adds 1e-6).  No host synchronisation."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return
    gmax = torch.stack([g.abs().max() for g in grads]).max()
    scale = torch.clamp(max_norm / (gmax + 1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)


class NofOptimizer:
    """The JAX runner's optax chain: global inf-norm clip -> Adam (b1 0.9,
    b2 0.999, eps 1e-15) -> lr * ``decay ** (floor(count/10)*10/n_step)``,
    with ``count`` the number of updates applied so far.  When
    ``lrate_pose != lrate`` the pose array has a chain of its own, as
    ``optax.multi_transform`` gives it, and the clip's inf-norm is then taken
    per chain."""

    def __init__(self, cfg: Cfg, params: dict):
        self.n_step = cfg["n_step"]
        self.decay = cfg["decay_rate"]
        self.max_norm = cfg["gradient_max_norm"]
        if cfg["lrate_pose"] == cfg["lrate"]:
            groups = [{"params": param_leaves(params), "base_lr": cfg["lrate"]}]
        else:
            basic = {k: v for k, v in params.items() if k != "pose_array"}
            groups = [{"params": param_leaves(basic), "base_lr": cfg["lrate"]},
                      {"params": [params["pose_array"]],
                       "base_lr": cfg["lrate_pose"]}]
        for g in groups:
            g["lr"] = g["base_lr"]
        self.adam = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-15)
        self.count = 0

    def schedule(self, count: int) -> float:
        s = (count // 10) * 10  # lr update every 10 steps
        return self.decay ** (s / self.n_step)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=False)

    def step(self) -> None:
        scale = self.schedule(self.count)
        for g in self.adam.param_groups:
            clip_by_global_inf_norm([p.grad for p in g["params"]], self.max_norm)
            g["lr"] = g["base_lr"] * scale
        self.adam.step()
        self.count += 1


def make_optimizer(cfg: Cfg, params: dict) -> NofOptimizer:
    """The NOF optimizer over ``params`` (updated in place)."""
    return NofOptimizer(cfg, params)


class TrainStatics(NamedTuple):
    """All statics the train step closes over."""

    spec: nof_model.NofSpec
    rcfg: nof_render.RenderCfg
    weights: nof_losses.LossWeights
    n_rand: int
    n_step: int
    trunc: float
    trunc_start: float
    trunc_decay_type: str
    sc_factor: float
    # Gradient-accumulation chunk (rays). 0 = single fused batch.  Losses
    # are plain means over fixed shapes, so equal-chunk accumulation is
    # exact.
    microbatch: int = 0


def _pick_microbatch(n_rand: int, samples_per_ray: int, num_levels: int,
                     override: int = 0) -> int:
    """Choose the grad-accumulation chunk so the hash-encode working set
    (rays x samples x levels) stays within a ~2M-element budget.  0 = no
    chunking needed.  Chunks are exact divisors of n_rand so chunked means
    equal the fused mean."""
    if override:
        return override
    budget = 2 * 1024 * 1024  # ray-sample-level elements before x8 corners
    load = n_rand * samples_per_ray * num_levels
    if load <= budget:
        return 0
    n_chunks = (load + budget - 1) // budget
    mb = n_rand
    for div in range(n_chunks, n_rand + 1):
        if n_rand % div == 0:
            mb = n_rand // div
            break
    return max(mb, 1)


def make_loss_fn(st: TrainStatics):
    """The NOF loss function (render + all loss terms).  Returns
    ``loss_fn(params, batch, grid, c2w, step, draws=None, generator=None)
    -> (loss, metrics)``."""
    if st.weights.eikonal_weight > 0:
        raise NotImplementedError(
            "eikonal_weight > 0 needs a double backward through the hash-grid "
            "encode, which is not ported yet")

    def loss_fn(params, batch, grid, c2w, step: int, draws=None, generator=None):
        truncation = nof_losses.truncation_value(
            step, st.n_step, st.trunc, st.trunc_start, st.sc_factor,
            st.trunc_decay_type)
        out = nof_render.render_rays(params, st.spec, st.rcfg, grid, batch, c2w,
                                     truncation, draws, generator)
        target_rgb = batch[:, nof_render.RAY_RGB]
        target_d = batch[:, nof_render.RAY_DEPTH]
        frame_ids = batch[:, nof_render.RAY_FRAME_ID].to(torch.int64)
        ray_type = batch[:, nof_render.RAY_TYPE]
        valid_samples = out["valid_samples"].to(torch.float32)
        sdf = out["raw"][..., 3]
        z_vals = out["z_vals"]

        valid_rays = out["valid_samples"].any(dim=-1) & (ray_type == 0)
        ray_w = torch.where(frame_ids == 0, st.weights.first_frame_weight, 1.0)
        ray_w = ray_w * valid_rays.to(torch.float32)
        sample_w = ray_w[:, None] * valid_samples

        img_loss = torch.mean((out["rgb_map"] - target_rgb) ** 2 * ray_w[:, None])
        rgb_loss = st.weights.rgb_weight * img_loss
        loss = rgb_loss

        fs_raw, sdf_raw_l = nof_losses.sdf_losses(
            z_vals, target_d[:, None], sdf, truncation, sample_w, st.weights)
        fs_loss = fs_raw * st.weights.fs_weight
        sdf_loss = sdf_raw_l * st.weights.trunc_weight
        loss = loss + fs_loss + sdf_loss

        metrics = {"rgb_loss": rgb_loss, "fs_loss": fs_loss, "sdf_loss": sdf_loss}
        if st.weights.depth_weight > 0:
            dl = st.weights.depth_weight * nof_losses.depth_loss(
                z_vals, sdf, target_d, ray_w, st.weights)
            loss = loss + dl
            metrics["depth_loss"] = dl
        if st.weights.fs_rgb_weight > 0:
            front, _ = nof_losses.sdf_masks(z_vals, target_d[:, None], truncation,
                                            st.weights)
            fr = st.weights.fs_rgb_weight * nof_losses.fs_rgb_loss(
                out["raw"][..., :3], front.to(torch.float32), sample_w)
            loss = loss + fr
            metrics["fs_rgb_loss"] = fr
        if st.spec.frame_features > 0:
            reg = st.weights.feature_reg_weight * torch.mean(
                params["feature_array"] ** 2)
            loss = loss + reg
            metrics["feature_reg"] = reg
        if st.weights.pose_reg_weight > 0:
            reg = st.weights.pose_reg_weight * torch.linalg.norm(
                params["pose_array"][1:])
            loss = loss + reg
        metrics["loss"] = loss
        metrics["valid_rays"] = torch.sum(valid_rays)
        return loss, metrics

    return loss_fn


def make_train_step(st: TrainStatics, optimizer: NofOptimizer):
    """Build the training step.  Returns ``train_step(params, step, rays,
    n_rays, grid, c2w, batch_idx=None, draws=None, generator=None) ->
    metrics``, which updates ``params`` in place.

    ``batch_idx`` (n_rand,) int: the rows of ``rays`` to train on, drawn
    uniformly from ``[0, n_rays)`` when absent.  ``draws``: the
    ``SampleDraws`` of the whole batch (padded to whole microbatch chunks
    when chunking pads)."""
    loss_fn = make_loss_fn(st)
    params_of = optimizer.adam.param_groups

    def train_step(params, step: int, rays, n_rays: int, grid, c2w,
                   batch_idx=None, draws=None, generator=None):
        if batch_idx is None:
            batch_idx = torch.randint(0, max(int(n_rays), 1), (st.n_rand,),
                                      generator=generator, device=rays.device)
        batch = rays[batch_idx]
        optimizer.zero_grad()
        mb = st.microbatch
        if mb and mb < st.n_rand:
            n_chunks = (st.n_rand + mb - 1) // mb
            pad = n_chunks * mb - st.n_rand
            if pad:
                batch = torch.cat([batch, batch[:pad]], dim=0)
            metrics = None
            for c in range(n_chunks):
                sl = slice(c * mb, (c + 1) * mb)
                loss, m = loss_fn(params, batch[sl], grid, c2w, step,
                                  None if draws is None else draws.rows(sl),
                                  generator)
                loss.backward()
                m = {k: v.detach() for k, v in m.items()}
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            inv = 1.0 / n_chunks
            with torch.no_grad():
                for g in params_of:
                    for p in g["params"]:
                        if p.grad is not None:
                            p.grad.mul_(inv)
            metrics = {k: (v if k == "valid_rays" else v * inv)
                       for k, v in metrics.items()}
        else:
            loss, metrics = loss_fn(params, batch, grid, c2w, step, draws,
                                    generator)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
        optimizer.step()
        return metrics

    return train_step


def make_train_loop(st: TrainStatics, optimizer: NofOptimizer):
    """Multi-step training as a Python loop over ``train_step``.  Returns
    ``train_many(params, step0, rays, n_rays, grid, c2w, n_inner,
    generator=None) -> metrics of the last step``."""
    train_step = make_train_step(st, optimizer)

    def train_many(params, step0: int, rays, n_rays: int, grid, c2w,
                   n_inner: int, generator=None):
        metrics = None
        for i in range(n_inner):
            metrics = train_step(params, step0 + i, rays, n_rays, grid, c2w,
                                 generator=generator)
        return metrics

    return train_many
