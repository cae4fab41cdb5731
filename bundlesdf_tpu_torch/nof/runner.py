"""Neural Object Field training runner (port of ``bundlesdf_tpu/nof/
runner.py``).

One training step draws ``n_rand`` rays from the ray pool, renders them,
sums the losses, runs the backward (through the hash-grid encode's custom
backward and its CUDA kernels) and applies the global inf-norm clip and
Adam.  ``NofRunner`` owns a session: the occupancy grid, the ray pool,
training in chunks that the scheduler dispatches, continual extension,
pose export and meshing.

Parity anchors (reference nerf_runner.py): ray building :244-314,
optimizer :490-502 (Adam eps 1e-15, separate pose lr), lr decay every 10
steps :577-581, inf-norm clip :648-658, losses :677-851, add_new_frames
:350-431, extract_mesh :1349-1408; pose export Utils.py:479-505.

PyTorch idiom: parameters are a dict of leaf tensors updated in place by
``torch.optim.Adam`` (the JAX step returns new arrays); the batch indices
and the sampling jitter are optional tensor arguments, drawn from a
``torch.Generator`` when absent.  The JAX runner's async dispatch becomes
eager enqueue plus a CUDA event a chunk.

Checkpoints (``save_weights``, ``load_weights``, ``from_checkpoint``) are
pickles of numpy arrays under the JAX file's top-level keys, so they load
without a card; ``full=True`` adds the training inputs and the state of the
runner's ``torch.Generator`` (in place of the JAX PRNG key), and a resume
continues bitwise.

Not ported yet: CUDA-graph capture of the step loop.
"""
from __future__ import annotations

import logging
import math
import os
import pickle
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from scipy.ndimage import maximum_filter1d
from scipy.spatial import cKDTree

from ..config import Cfg
from ..models import nof as nof_model
from ..ops import hashgrid, occupancy as occ_ops
from ..utils import geometry, mesh as mesh_utils
from ..utils.device import resolve_device
from ..utils.profiler import count as profiler_count, span
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

    def reset(self) -> None:
        """Zero Adam's moments and the update count, as ``optimizer.init``
        does in the JAX runner; the parameter tensors stay bound."""
        self.adam.state.clear()
        self.count = 0

    def state_numpy(self) -> dict:
        """The update count and Adam's per-parameter state as numpy arrays,
        in ``param_groups`` order (a parameter not yet updated has {})."""
        return {"count": self.count, "adam": [
            [{k: v.detach().cpu().numpy() for k, v in self.adam.state.get(p, {}).items()}
             for p in g["params"]] for g in self.adam.param_groups]}

    def load_state_numpy(self, state: dict) -> None:
        """Restore ``state_numpy``'s output onto the bound parameters: the
        moments on each parameter's device, Adam's step count on the CPU
        (where the non-capturable Adam keeps it)."""
        self.reset()
        self.count = int(state["count"])
        for g, saved in zip(self.adam.param_groups, state["adam"], strict=True):
            for p, st in zip(g["params"], saved, strict=True):
                if st:
                    self.adam.state[p] = {
                        k: torch.from_numpy(np.array(v)).to("cpu" if k == "step" else p.device)
                        for k, v in st.items()}


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
    -> (loss, metrics)``.

    A positive ``eikonal_weight`` adds the eikonal term on the normals
    ``d nof_sdf / d pts`` at the render's sample points (JAX
    ``runner.py:193-200``): a backward with ``create_graph`` through the
    hash-grid encode, whose table and pose gradients the step's backward
    then takes.  ``pts`` stays in the graph, so the pose array gets the
    term's gradient as in JAX."""

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
        if st.weights.eikonal_weight > 0:
            pts_flat = out["pts"].reshape(-1, 3)
            if not pts_flat.requires_grad:  # no pose optimisation: a leaf
                pts_flat = pts_flat.detach().requires_grad_(True)
            normals, = torch.autograd.grad(
                nof_model.nof_sdf(params, st.spec, pts_flat).sum(), pts_flat,
                create_graph=True)
            ek = st.weights.eikonal_weight * nof_losses.eikonal_loss(
                normals.reshape(sdf.shape + (3,)), sdf)
            loss = loss + ek
            metrics["eikonal_loss"] = ek
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


TrainDraws = Callable[[int, int], tuple]


def make_train_loop(st: TrainStatics, optimizer: NofOptimizer):
    """Multi-step training as a Python loop over ``train_step``.  Returns
    ``train_many(params, step0, rays, n_rays, grid, c2w, n_inner,
    generator=None, draws=None) -> metrics of the last step``.

    ``draws``: optional draw source ``(step, n_rays) -> (batch_idx,
    SampleDraws)`` giving each step's batch indices and jitter (moved to the
    rays' device); without one they come from ``generator``."""
    train_step = make_train_step(st, optimizer)

    def train_many(params, step0: int, rays, n_rays: int, grid, c2w,
                   n_inner: int, generator=None, draws: TrainDraws | None = None):
        metrics = None
        for i in range(n_inner):
            idx = sd = None
            if draws is not None:
                idx, sd = draws(step0 + i, n_rays)
                idx = idx.to(rays.device)
                sd = sd.to(rays.device)
            metrics = train_step(params, step0 + i, rays, n_rays, grid, c2w,
                                 batch_idx=idx, draws=sd, generator=generator)
        return metrics

    return train_many


# --------------------------------------------------------------- NofRunner ---

BAD_DEPTH = 99.0
BAD_COLOR = 128

# Roots of the JAX-side classes a JAX checkpoint pickles (optax optimizer
# states); the port reads such a file without them (weights only).
_JAX_MODULES = ("optax", "jax", "jaxlib", "flax", "chex")


class _Opaque(tuple):
    """Stands in for a pickled JAX-side class (an optax state namedtuple)."""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _JAX_MODULES:
            return _Opaque
        return super().find_class(module, name)


def load_checkpoint(path: str) -> dict:
    """A checkpoint file of either package as a dict of numpy arrays; the
    optimizer state of a JAX file comes back as opaque tuples."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


# Rows of one occupancy-cull pass over the ray pool, and points of one SDF
# query of the mesh extraction.
CULL_CHUNK = 1 << 17
MESH_CHUNK = 1 << 18


def dilate_mask_square(mask: np.ndarray, k: int) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((k, k)))`` without OpenCV: a separable
    max over a k-wide window at offsets ``[-(k // 2), k - 1 - k // 2]``
    along each axis, which is cv2's default anchor (k // 2).  For an even k
    the window is asymmetric: one lit pixel spreads to offsets
    ``[-(k - 1 - k // 2), k // 2]``, e.g. [-49, +50] for k = 100.  The
    border adds nothing."""
    out = maximum_filter1d(mask, k, axis=0, mode="constant", cval=0)
    return maximum_filter1d(out, k, axis=1, mode="constant", cval=0)


class NofRunner:
    """One NOF training session over the current keyframe set (port of the
    JAX ``NofRunner``, nof/runner.py:300-1049).

    Data enters already normalized (preprocess_data semantics,
    nerf_helpers.py:218-240): rgb in [0,1] with BAD_COLOR outside mask,
    depth scaled by sc_factor with BAD_DEPTH where invalid, poses
    translated+scaled into [-1,1]^3, OpenGL convention.

    Host numpy holds the frames and builds the ray pool; the device holds
    the parameters, the occupancy grid, the ray pool and the poses.
    ``device``: None = CUDA (raises without one).  ``params``: optional
    initial parameters on ``device`` (``models.nof.params_from_jax``); the
    seeded ``init_nof_params`` otherwise.  ``train_draws``: optional draw
    source ``(step, n_rays) -> (batch_idx, SampleDraws)``; without one the
    steps draw from a generator on the device seeded with 42 (the JAX
    runner's ``PRNGKey(42)``).  ``rays_np``: a ray pool to use instead of
    building one from the frames (the resume path of ``from_checkpoint``).
    """

    def __init__(self, cfg: Cfg, images: np.ndarray, depths: np.ndarray,
                 masks: np.ndarray, poses: np.ndarray, K: np.ndarray,
                 build_octree_pts: np.ndarray, occ_masks: np.ndarray | None = None,
                 device=None, params: dict | None = None,
                 train_draws: TrainDraws | None = None,
                 rays_np: np.ndarray | None = None):
        if int(cfg.get("dp_devices", 0) or 0) > 1:
            raise NotImplementedError(
                "dp_devices > 1 (data-parallel NOF training) is not ported yet "
                "(ROADMAP queue 1, item 7: parallel/)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.K = np.asarray(K, dtype=np.float32)
        self.H, self.W = images.shape[1:3]
        self.max_frames = int(cfg.get("max_kf_pool", 128))
        self.n_frames = len(images)
        if self.n_frames > self.max_frames:
            raise ValueError(f"{self.n_frames} frames exceed max_kf_pool={self.max_frames}")

        self.images = images.astype(np.float32)
        self.depths = depths.astype(np.float32)
        self.masks = masks.astype(np.float32)
        self.occ_masks = occ_masks
        self.c2w_np = np.broadcast_to(np.eye(4, dtype=np.float32),
                                      (self.max_frames, 4, 4)).copy()
        self.c2w_np[: self.n_frames] = poses.astype(np.float32)

        sc = float(cfg["sc_factor"])
        grid_spec = hashgrid.HashGridSpec(
            num_levels=int(cfg["num_levels"]),
            level_dim=int(cfg["feature_grid_dim"]),
            base_res=int(cfg["base_res"]),
            finest_res=int(cfg["finest_res"]),
            log2_hashmap_size=int(cfg["log2_hashmap_size"]),
            layout=str(cfg.get("hash_layout", "cell")),
            scatter=hashgrid.resolve_scatter(str(cfg.get("hash_scatter", "auto"))),
            big_dtype=str(cfg.get("hash_big_dtype", "float32")),
            reduce=hashgrid.resolve_reduce(str(cfg.get("hash_reduce", "auto")),
                                           self.device),
        )
        self.spec = nof_model.NofSpec(
            grid=grid_spec,
            sh_degree=int(cfg["multires_views"]),
            frame_features=int(cfg["frame_features"]),
            num_frames=self.max_frames,
            max_trans=float(cfg["max_trans"]) * sc,
            max_rot_deg=float(cfg["max_rot"]),
            optimize_poses=bool(cfg["optimize_poses"]),
        )
        # Occupancy grid resolution from the octree voxel size (reference
        # build_octree: level = ceil(log2(2 / (vox * sc)))).
        vox = float(cfg["octree_smallest_voxel_size"]) * sc
        level = max(3, int(math.ceil(math.log2(2.0 / vox))))
        self.occ_resolution = min(256, 2 ** level)
        self.occ_dilate = max(1, int(math.ceil(
            float(cfg["octree_dilate_size"]) / float(cfg["octree_smallest_voxel_size"]))))

        self.rcfg = nof_render.RenderCfg(
            n_samples=int(cfg["N_samples"]),
            n_samples_around_depth=int(cfg["N_samples_around_depth"]),
            n_importance=int(cfg.get("N_importance", 0)),
            n_march=max(128, self.occ_resolution * 2),
            sdf_lambda=float(cfg["sdf_lambda"]),
            neg_trunc_ratio=float(cfg["neg_trunc_ratio"]),
            near=float(cfg["near"]),
            far=float(cfg["far"]),
            sc_factor=sc,
            perturb=bool(cfg["perturb"]),
        )
        self.weights = nof_losses.LossWeights(
            rgb_weight=float(cfg["rgb_weight"]),
            fs_weight=float(cfg["fs_weight"]),
            empty_weight=float(cfg["empty_weight"]),
            trunc_weight=float(cfg["trunc_weight"]),
            fs_sdf=float(cfg["fs_sdf"]),
            neg_trunc_ratio=float(cfg["neg_trunc_ratio"]),
            first_frame_weight=float(cfg["first_frame_weight"]),
            feature_reg_weight=float(cfg["feature_reg_weight"]),
            pose_reg_weight=float(cfg["pose_reg_weight"]),
            near=float(cfg["near"]),
            far=float(cfg["far"]),
            sc_factor=sc,
            depth_weight=float(cfg.get("depth_weight", 0.0)),
            fs_rgb_weight=float(cfg.get("fs_rgb_weight", 0.0)),
            eikonal_weight=float(cfg.get("eikonal_weight", 0.0)),
        )

        self.build_occupancy(build_octree_pts)

        self.params = (nof_model.init_nof_params(self.spec, seed=0, device=self.device)
                       if params is None else params)
        self.optimizer = make_optimizer(cfg, self.params)
        self.global_step = 0
        # cumulative step count for the checkpoint cadence: never reset by
        # add_new_frames (which restarts global_step each extension round)
        self.total_step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(42)
        self.train_draws = train_draws

        n_rand = int(cfg["N_rand"])
        self.statics = TrainStatics(
            spec=self.spec,
            rcfg=self.rcfg,
            weights=self.weights,
            n_rand=n_rand,
            n_step=int(cfg["n_step"]),
            trunc=float(cfg["trunc"]),
            trunc_start=float(cfg["trunc_start"]),
            trunc_decay_type=str(cfg["trunc_decay_type"]),
            sc_factor=sc,
            microbatch=_pick_microbatch(
                n_rand,
                self.rcfg.n_samples + self.rcfg.n_samples_around_depth,
                self.spec.grid.num_levels,
                int(cfg.get("micro_batch", 0)),
            ),
        )
        self._train_many = make_train_loop(self.statics, self.optimizer)
        # steps per train_advance chunk: the scheduler's overlap quantum
        self.loop_chunk = int(cfg.get("loop_chunk", 50))
        self._inflight: list = []        # CUDA events of dispatched chunks
        self._metrics_async = None
        self._step_ms = 0.0
        self._calibrate_steps = 0

        self._ckpt_done = 0              # i_weights checkpoints written by train_drain
        self.rays_dev = None
        # a resumed pool may hold rays of several add_new_frames rounds whose
        # build-time poses the current state no longer has: reuse it
        self.rays_np = (np.asarray(rays_np, dtype=np.float32) if rays_np is not None
                        else self._build_all_rays(range(self.n_frames)))
        self._upload_rays()

    # ------------------------------------------------------------------
    def build_occupancy(self, pts: np.ndarray):
        with span("nof/build_occupancy"):
            pts = np.asarray(pts, dtype=np.float32).reshape(-1, 3)
            if len(pts) == 0:
                pts = np.zeros((1, 3), dtype=np.float32)
            self._build_pts = pts  # fused cloud, also used by the ray denoise
            # power-of-2 bucket, as the JAX runner pads (bounds the shapes
            # the allocator sees as the fused cloud grows)
            n = len(pts)
            cap = 1 << max(10, (n - 1).bit_length())
            valid = np.zeros(cap, dtype=bool)
            valid[:n] = True
            pts_pad = np.zeros((cap, 3), dtype=np.float32)
            pts_pad[:n] = pts
            grid = occ_ops.build_occupancy_grid(
                torch.from_numpy(pts_pad).to(self.device),
                torch.from_numpy(valid).to(self.device), self.occ_resolution)
            self.occ_grid = occ_ops.dilate_grid(grid, self.occ_dilate)

    # ------------------------------------------------------------------
    def _build_frame_rays(self, fid: int) -> np.ndarray:
        """Parity with make_frame_rays (nerf_runner.py:244-314), host numpy;
        the occupancy cull is batched in _build_all_rays."""
        cfg = self.cfg
        H, W = self.H, self.W
        sc = float(cfg["sc_factor"])
        if not hasattr(self, "_dirs_cache"):
            self._dirs_cache = geometry.camera_rays_gl_np(H, W, self.K)
        dirs = self._dirs_cache
        rgb = self.images[fid]
        depth = self.depths[fid]
        mask = (self.masks[fid] > 0).astype(np.uint8)

        invalid_depth = ((depth < cfg["near"] * sc) | (depth > cfg["far"] * sc)) & (mask > 0)
        ray_type = invalid_depth.astype(np.float32)

        # Mask dilation: frame 0 = 100 px (assumed-perfect first mask),
        # later frames 60 px (reference :273-284).
        dil = 100 if fid == 0 else 60 // int(cfg["down_scale_ratio"])
        sel = dilate_mask_square(mask, dil)
        if self.occ_masks is not None:
            sel[self.occ_masks[fid] > 0] = 0
        if cfg["rays_valid_depth_only"]:
            sel[invalid_depth] = 0

        vs, us = np.where(sel > 0)
        n = len(vs)
        if n == 0:
            return np.zeros((0, nof_render.RAY_DIM), dtype=np.float32)
        rays = np.zeros((n, nof_render.RAY_DIM), dtype=np.float32)
        rays[:, nof_render.RAY_DIR] = dirs[vs, us]
        rays[:, nof_render.RAY_RGB] = rgb[vs, us]
        rays[:, nof_render.RAY_DEPTH] = depth[vs, us]
        rays[:, nof_render.RAY_MASK] = mask[vs, us]
        rays[:, nof_render.RAY_FRAME_ID] = fid
        rays[:, nof_render.RAY_TYPE] = ray_type[vs, us]

        # drop type-1 rays like the reference (:292)
        rays = rays[rays[:, nof_render.RAY_TYPE] == 0]
        if len(rays) == 0:
            return rays

        # near/far from ray/AABB in world; rays that miss the box go here,
        # rays that miss occupied space in the batched cull
        pose = self.c2w_np[fid]
        d_cam = rays[:, nof_render.RAY_DIR]
        d_unit = d_cam / np.linalg.norm(d_cam, axis=-1, keepdims=True)
        d_w = d_unit @ pose[:3, :3].T
        o_w = np.broadcast_to(pose[:3, 3], d_w.shape)
        tmin, tmax = geometry.ray_box_intersection_np(
            o_w, d_w, np.array([-1.0, -1.0, -1.0]), np.array([1.0, 1.0, 1.0]),
        )
        keep = tmin >= 0
        rays = rays[keep]
        rays[:, nof_render.RAY_NEAR] = tmin[keep]
        rays[:, nof_render.RAY_FAR] = tmax[keep]
        return rays

    def _cull_rays_by_occupancy(self, rays: np.ndarray) -> np.ndarray:
        """Drop rays whose [-1,1]^3 span never touches occupied space
        (reference octree ray culling at build, nerf_runner.py:300-313):
        one device pass per CULL_CHUNK rows, only a bool a ray comes back."""
        if len(rays) == 0:
            return rays
        out = np.zeros(len(rays), dtype=bool)
        for s in range(0, len(rays), CULL_CHUNK):
            chunk = rays[s: s + CULL_CHUNK]
            d_cam = chunk[:, nof_render.RAY_DIR]
            fids = chunk[:, nof_render.RAY_FRAME_ID].astype(np.int32)
            pose = self.c2w_np[fids]
            d_unit = d_cam / np.linalg.norm(d_cam, axis=-1, keepdims=True)
            d_w = np.einsum("nab,nb->na", pose[:, :3, :3], d_unit)
            o_w = pose[:, :3, 3]
            hit = occ_ops.sample_rays_in_occupied_space(
                self.occ_grid,
                torch.from_numpy(np.ascontiguousarray(o_w, np.float32)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(d_w, np.float32)).to(self.device),
                n_march=self.rcfg.n_march, n_samples=1, perturb=False)[1]
            out[s: s + CULL_CHUNK] = hit.cpu().numpy()
        return rays[out]

    def _build_all_rays(self, frame_ids) -> np.ndarray:
        with span("nof/build_rays"):
            chunks = [self._build_frame_rays(f) for f in frame_ids]
            chunks = [c for c in chunks if len(c)]
            if not chunks:
                return np.zeros((0, nof_render.RAY_DIM), dtype=np.float32)
            rays = self._cull_rays_by_occupancy(np.concatenate(chunks, axis=0))
            if bool(self.cfg.get("denoise_depth_use_octree_cloud", False)):
                rays = self._denoise_rays_by_cloud(rays)
            return rays

    def _denoise_rays_by_cloud(self, rays: np.ndarray) -> np.ndarray:
        """Drop rays whose measured 3D point is > 2 cm from the fused build
        cloud (reference denoise via cKDTree over build_octree_pts,
        nerf_runner.py:177-194).  Host-side, once per keyframe batch."""
        pts_cloud = getattr(self, "_build_pts", None)
        if pts_cloud is None or len(pts_cloud) == 0 or len(rays) == 0:
            return rays
        sc = float(self.cfg["sc_factor"])
        mask = (rays[:, nof_render.RAY_MASK] > 0) & (
            rays[:, nof_render.RAY_DEPTH] <= float(self.cfg["far"]) * sc)
        if not mask.any():
            return rays
        d = rays[mask]
        pts3d = d[:, nof_render.RAY_DIR] * d[:, nof_render.RAY_DEPTH][:, None]
        fids = d[:, nof_render.RAY_FRAME_ID].astype(np.int32)
        pose = self.c2w_np[fids]
        pts_w = np.einsum("nab,nb->na", pose[:, :3, :3], pts3d) + pose[:, :3, 3]
        dists, _ = cKDTree(pts_cloud).query(pts_w, k=1, workers=-1)
        bad = dists > 0.02 * sc
        keep = np.ones(len(rays), bool)
        keep[np.flatnonzero(mask)[bad]] = False
        return rays[keep]

    def _upload_rays(self, append_from: int | None = None):
        """Put ``rays_np`` in the device pool.  Beyond ``ray_pool_max_log2``
        rows the pool is a uniform subsample (the JAX runner's
        ``default_rng(len)`` draw, so the same rows stay).  The pool is a
        preallocated power-of-2 buffer (at least ``ray_pool_reserve_log2``);
        ``append_from`` writes only the rows from there on, in place, when
        the pool still fits."""
        with span("nof/upload_rays"):
            max_cap = 1 << int(self.cfg.get("ray_pool_max_log2", 23))
            if len(self.rays_np) > max_cap:
                rng = np.random.default_rng(len(self.rays_np))
                keep = rng.choice(len(self.rays_np), max_cap, replace=False)
                self.rays_np = self.rays_np[np.sort(keep)]
                append_from = None          # pool reordered: full upload
            n = len(self.rays_np)
            reserve = 1 << int(self.cfg.get("ray_pool_reserve_log2", 0))
            cap = max(1 << 14, min(reserve, max_cap),
                      1 << int(math.ceil(math.log2(max(n, 1)))))
            dev = self.rays_dev
            if (append_from is not None and dev is not None
                    and dev.shape[0] == cap and 0 <= append_from <= n):
                if n > append_from:
                    dev[append_from:n] = torch.from_numpy(
                        self.rays_np[append_from:]).to(self.device)
            else:
                self.rays_dev = None            # release the old pool first
                pool = torch.zeros((cap, nof_render.RAY_DIM), dtype=torch.float32,
                                   device=self.device)
                pool[:n] = torch.from_numpy(self.rays_np).to(self.device)
                self.rays_dev = pool
            self.n_rays = n                     # a host int: the step's randint bound
            self.update_c2w()

    def update_c2w(self):
        """Re-upload only the (tiny) camera poses — rays store camera-frame
        directions, so a pose update does not touch the ray pool."""
        self.c2w_dev = torch.from_numpy(self.c2w_np).to(self.device)

    # ------------------------------------------------------------------
    def _save_latest(self):
        """The i_weights checkpoint (reference config.yml:37): model_latest.pth
        in ``save_dir``, resumable when ``ckpt_full``."""
        os.makedirs(self.cfg["save_dir"], exist_ok=True)
        self.save_weights(f"{self.cfg['save_dir']}/model_latest.pth",
                          full=bool(self.cfg.get("ckpt_full", False)))

    def _run_chunk(self, n: int):
        metrics = self._train_many(
            self.params, self.global_step, self.rays_dev, self.n_rays,
            self.occ_grid, self.c2w_dev, n, generator=self.generator,
            draws=self.train_draws)
        self.global_step += n
        self.total_step += n
        return metrics

    def train(self, n_steps: int | None = None) -> dict:
        """Train ``n_steps`` (default n_step) synchronously; the last step's
        metrics as floats."""
        n_steps = n_steps or int(self.cfg["n_step"])
        with span("nof/train"):
            # the i_weights cadence, checked at loop-chunk granularity
            i_weights = int(self.cfg.get("i_weights", 999999))
            next_ckpt = (self.total_step // i_weights + 1) * i_weights
            metrics, done = {}, 0
            while done < n_steps:
                n = min(self.loop_chunk, n_steps - done)
                metrics = self._run_chunk(n)
                done += n
                if self.total_step >= next_ckpt:
                    self._save_latest()
                    next_ckpt += i_weights
            return {k: float(v) for k, v in metrics.items()}

    def train_advance(self, n_steps: int) -> None:
        """Dispatch ``n_steps`` of training in loop_chunk chunks without
        reading results back.  Eager torch enqueues each step's kernels
        from the host, so this returns once the host has enqueued them (on
        the CPU, once they ran).  A CUDA event recorded after each chunk
        lets :meth:`pending_chunks` observe the queue;
        :meth:`train_drain` synchronizes (and writes a due i_weights
        checkpoint)."""
        with span("nof/train_advance"):
            done = 0
            while done < n_steps:
                n = min(self.loop_chunk, n_steps - done)
                self._metrics_async = self._run_chunk(n)
                profiler_count("launch/nof_chunk")
                if self.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                    self._inflight.append(ev)
                done += n

    def pending_chunks(self) -> int:
        """Dispatched chunks the device has not finished, without blocking.
        The stream is FIFO: once chunk k is done, so are all before it."""
        q = self._inflight
        while q and q[0].query():
            q.pop(0)
        return len(q)

    def train_queue_ready(self) -> bool:
        """True if all dispatched training work has completed, without
        blocking."""
        return self.pending_chunks() == 0

    def train_drain(self) -> dict:
        """Block until all dispatched training work is done; the last
        step's metrics (an empty dict if nothing was in flight)."""
        m = self._metrics_async
        if m is None:
            return {}
        with span("nof/train_drain"):
            profiler_count("readback/nof_drain")
            out = {k: float(v) for k, v in m.items()}
        self._metrics_async = None
        self._inflight = []
        # the i_weights cadence, checked at round granularity on this path
        i_weights = int(self.cfg.get("i_weights", 999999))
        if self.total_step // i_weights > self._ckpt_done:
            self._ckpt_done = self.total_step // i_weights
            self._save_latest()
        return out

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def calibrate_step_ms(self) -> float:
        """Measured time (ms) of one step at this budget: drain, then time
        ``3 x loop_chunk`` real steps dispatched from idle, between two
        synchronizations.  The steps train for real; the scheduler deducts
        them from later rounds' budgets.  Cached for the session."""
        if self._step_ms:
            return self._step_ms
        n = 3 * self.loop_chunk
        self.train_drain()
        self._synchronize()
        t0 = time.perf_counter()
        self.train_advance(n)
        self._synchronize()
        self._step_ms = (time.perf_counter() - t0) * 1e3 / n
        self.train_drain()
        self._calibrate_steps = n
        return self._step_ms

    # ------------------------------------------------------------------
    def train_ba(self, matches_table, n_steps: int = 200,
                 inlier_thresh: float = 0.02, lr: float | None = None) -> list:
        """NeRF-side bundle adjustment over feature matches (reference
        make_key_ray_ids + train_BA, nerf_runner.py:865-975): optimize only
        the per-frame pose array so that matched keypoints back-project to
        the same world point.

        As in the JAX runner, keypoint pixels index the depth maps on the
        host.  The optimisation is a loop on the device (``torch.optim.Adam``,
        eps 1e-15, lr ``lrate_pose``) whose loss history stays there until
        the end: no host synchronisation a step.  ``matches_table``:
        {(idA, idB): (N, 4) [uA, vA, uB, vB]} in image pixels.  Returns the
        loss history; the pose array is updated in place."""
        sc = float(self.cfg["sc_factor"])
        near, far = float(self.cfg["near"]) * sc, float(self.cfg["far"]) * sc
        if not hasattr(self, "_dirs_cache"):
            self._dirs_cache = geometry.camera_rays_gl_np(self.H, self.W, self.K)
        dirs = self._dirs_cache

        pts_a, pts_b, fid_a, fid_b = [], [], [], []
        for (ia, ib), m in matches_table.items():
            m = np.asarray(m, dtype=np.float32)
            if m.size == 0:
                continue
            ua = np.clip(np.round(m[:, 0]).astype(int), 0, self.W - 1)
            va = np.clip(np.round(m[:, 1]).astype(int), 0, self.H - 1)
            ub = np.clip(np.round(m[:, 2]).astype(int), 0, self.W - 1)
            vb = np.clip(np.round(m[:, 3]).astype(int), 0, self.H - 1)
            da, db = self.depths[ia, va, ua], self.depths[ib, vb, ub]
            ok = (da > near) & (da <= far) & (db > near) & (db <= far)
            pts_a.append(dirs[va[ok], ua[ok]] * da[ok, None])
            pts_b.append(dirs[vb[ok], ub[ok]] * db[ok, None])
            fid_a.append(np.full(ok.sum(), ia))
            fid_b.append(np.full(ok.sum(), ib))
        if not pts_a or sum(len(p) for p in pts_a) == 0:
            return []
        dev = self.device

        def to_dev(a, dtype=torch.float32):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        pa, pb = to_dev(np.concatenate(pts_a)), to_dev(np.concatenate(pts_b))
        fa = to_dev(np.concatenate(fid_a), torch.int64)
        fb = to_dev(np.concatenate(fid_b), torch.int64)
        c2w = to_dev(self.c2w_np)
        thresh = inlier_thresh * sc
        pose = self.params["pose_array"].detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([pose], lr=lr if lr is not None else float(self.cfg["lrate_pose"]),
                               betas=(0.9, 0.999), eps=1e-15)
        hist = torch.zeros(n_steps, dtype=torch.float32, device=dev)

        def to_world(pts, fids):
            T = nof_model.pose_array_matrices(pose, self.spec, fids) @ c2w[fids]
            return torch.einsum("nij,nj->ni", T[:, :3, :3], pts) + T[:, :3, 3]

        with span("nof/train_ba"):
            for i in range(n_steps):
                opt.zero_grad(set_to_none=False)
                d = torch.linalg.norm(to_world(pa, fa) - to_world(pb, fb), dim=-1)
                w = (d < thresh).to(d.dtype)
                loss = (d * w).sum() / (w.sum() + 1e-8)
                loss.backward()
                opt.step()
                hist[i] = loss.detach()
            with torch.no_grad():
                self.params["pose_array"].copy_(pose)
            return hist.cpu().tolist()

    # ------------------------------------------------------------------
    def add_new_frames(self, images, depths, masks, poses, build_octree_pts,
                       occ_masks=None):
        """Continual extension (reference add_new_frames
        nerf_runner.py:350-431): append new keyframes, reset all poses to
        the tracker's, rebuild the occupancy grid, restart the pose
        corrections and the optimizer, append rays for the new frames
        only."""
        n_new = len(images)
        room = self.max_frames - self.n_frames
        if n_new > room:
            # Keyframe pool saturated (max_kf_pool): keep the frames that
            # fit; the others keep tracker poses without NOF feedback.
            logging.warning(
                "NOF keyframe pool full (%d): dropping %d new frame(s)",
                self.max_frames, n_new - room)
            images, depths, masks = images[:room], depths[:room], masks[:room]
            if occ_masks is not None:
                occ_masks = occ_masks[:room]
            poses = poses[: self.n_frames + room]
            n_new = room
            if n_new == 0:
                self.c2w_np[: self.n_frames] = poses[: self.n_frames].astype(np.float32)
                self.build_occupancy(build_octree_pts)
                return
        start = self.n_frames
        self.images = np.concatenate([self.images, images.astype(np.float32)])
        self.depths = np.concatenate([self.depths, depths.astype(np.float32)])
        self.masks = np.concatenate([self.masks, masks.astype(np.float32)])
        if occ_masks is not None and self.occ_masks is not None:
            self.occ_masks = np.concatenate([self.occ_masks, occ_masks])
        self.n_frames += n_new
        self.c2w_np[: self.n_frames] = poses.astype(np.float32)
        self.build_occupancy(build_octree_pts)
        # fresh pose corrections (the reference recreates PoseArray) and a
        # fresh optimizer state, on the tensors the optimizer holds
        with torch.no_grad():
            self.params["pose_array"].zero_()
        self.optimizer.reset()
        self.global_step = 0
        new_rays = self._build_all_rays(range(start, self.n_frames))
        n_before = len(self.rays_np)
        if len(new_rays):
            self.rays_np = np.concatenate([self.rays_np, new_rays])
        self._upload_rays(append_from=n_before)

    # ------------------------------------------------------------------
    def extract_mesh(self, voxel_size: float | None = None, iso: float = 0.0,
                     use_occupancy_cull: bool = True) -> mesh_utils.Mesh:
        """Marching-tetrahedra surface of the learned SDF over [-1,1]^3
        (reference extract_mesh nerf_runner.py:1349-1408): the lattice's
        occupied points are queried on the device in MESH_CHUNK chunks,
        the SDF comes back in one readback."""
        with span("nof/extract_mesh"):
            voxel_size = voxel_size or float(self.cfg["mesh_resolution"])
            voxel_size *= float(self.cfg["sc_factor"])
            R = min(int(2.0 / voxel_size) + 1, 512)
            lin = np.linspace(-1, 1, R, dtype=np.float32)
            pts = torch.from_numpy(np.stack(np.meshgrid(lin, lin, lin, indexing="ij"),
                                            axis=-1).reshape(-1, 3)).to(self.device)
            if use_occupancy_cull:
                query_idx = torch.nonzero(
                    occ_ops.query_occupancy(self.occ_grid, pts)).reshape(-1)
            else:
                query_idx = torch.arange(R ** 3, device=self.device)
            sdf = torch.ones((R ** 3,), dtype=torch.float32, device=self.device)
            with torch.no_grad():
                for i in range(0, len(query_idx), MESH_CHUNK):
                    sel = query_idx[i: i + MESH_CHUNK]
                    sdf[sel] = nof_model.nof_sdf(self.params, self.spec, pts[sel])
            return mesh_utils.marching_tetrahedra(
                sdf.reshape(R, R, R).cpu().numpy(), iso=iso)

    # ------------------------------------------------------------------
    def get_optimized_poses_in_real_world(self):
        """Reference parity Utils.py:479-505: apply pose corrections,
        denormalize (unscale + untranslate), anchor to frame 0, return CV
        convention cam-in-object poses + the frame-0 offset."""
        cfg = self.cfg
        sc = float(cfg["sc_factor"])
        translation = np.asarray(cfg["translation"], dtype=np.float32)
        poses_n = self.c2w_np[: self.n_frames].copy()

        original = poses_n.copy()
        original[:, :3, 3] /= sc
        original[:, :3, 3] -= translation

        with torch.no_grad():
            ids = torch.arange(self.spec.num_frames, device=self.device)
            tf = nof_model.pose_array_matrices(
                self.params["pose_array"], self.spec, ids).cpu().numpy()[: self.n_frames]
        optimized = tf @ poses_n
        optimized[:, :3, 3] /= sc
        optimized[:, :3, 3] -= translation

        offset = np.linalg.inv(optimized[0]) @ original[0]
        out = np.einsum("nij,jk->nik", optimized, offset)
        out = np.einsum("nij,jk->nik", out, geometry.GLCAM_IN_CVCAM)
        # Re-orthonormalize before feeding back into the tracker: these
        # poses become keyframe poses and seed further compose chains.
        U, _, Vt = np.linalg.svd(out[:, :3, :3])
        det = np.linalg.det(U @ Vt)
        D = np.stack([np.ones_like(det), np.ones_like(det), det], axis=-1)
        out[:, :3, :3] = np.einsum("nij,nj,njk->nik", U, D, Vt)
        return out.astype(np.float32), offset.astype(np.float32)

    # ------------------------------------------------------------------
    def save_weights(self, path: str, full: bool = False):
        """Checkpoint parameters, optimizer state, steps, occupancy and poses
        (reference save_weights nerf_runner.py:526-548) as a pickle of numpy
        arrays under the JAX file's top-level keys.  ``full=True`` adds the
        training inputs (images, depths, masks, ray pool, fused build cloud)
        and the state of the step generator under ``key`` (the JAX file's
        PRNG key), so that :meth:`from_checkpoint` resumes bitwise."""
        ckpt = {
            "params": nof_model.params_to_numpy(self.params),
            "opt_state": self.optimizer.state_numpy(),
            "global_step": self.global_step,
            "total_step": self.total_step,
            "occ_grid": self.occ_grid.cpu().numpy(),
            "c2w": self.c2w_np,
            "n_frames": self.n_frames,
            "sc_factor": float(self.cfg["sc_factor"]),
            "translation": list(self.cfg["translation"]),
        }
        if full:
            ckpt.update(
                images=self.images, depths=self.depths, masks=self.masks,
                occ_masks=self.occ_masks, K=self.K, rays=self.rays_np,
                build_pts=self._build_pts,
                key=self.generator.get_state().numpy())
        with open(path, "wb") as f:
            pickle.dump(ckpt, f)

    @classmethod
    def from_checkpoint(cls, cfg: Cfg, path: str, device=None,
                        train_draws: TrainDraws | None = None) -> "NofRunner":
        """A runner rebuilt from a ``save_weights(full=True)`` file that
        continues training bitwise (mid-session resume; the reference's
        load_weights, nerf_runner.py:551-574, restores weights only and needs
        the caller to re-feed the frames).  The resume config must agree with
        the file on ``max_kf_pool``, ``sc_factor`` and ``translation``."""
        ckpt = load_checkpoint(path)
        if "rays" not in ckpt:
            raise ValueError(
                f"{path} is a weights-only checkpoint; resume needs "
                "save_weights(full=True)")
        # a drifted max_kf_pool gives an opaque shape error, a drifted
        # sc_factor / translation a silent geometry mismatch
        max_kf = int(cfg.get("max_kf_pool", 128))
        ckpt_kf = ckpt["c2w"].shape[0]
        if ckpt_kf != max_kf:
            raise ValueError(
                f"resume cfg max_kf_pool={max_kf} != checkpoint pool size "
                f"{ckpt_kf} ({path})")
        if abs(float(cfg["sc_factor"]) - float(ckpt["sc_factor"])) > 1e-6:
            raise ValueError(
                f"resume cfg sc_factor={cfg['sc_factor']} != checkpoint "
                f"sc_factor={ckpt['sc_factor']} ({path})")
        tr_cfg = np.asarray(cfg["translation"], dtype=np.float64)
        tr_ck = np.asarray(ckpt["translation"], dtype=np.float64)
        if not np.allclose(tr_cfg, tr_ck, atol=1e-6):
            raise ValueError(
                f"resume cfg translation={list(tr_cfg)} != checkpoint "
                f"translation={list(tr_ck)} ({path})")
        n = int(ckpt["n_frames"])
        runner = cls(cfg, ckpt["images"], ckpt["depths"], ckpt["masks"],
                     ckpt["c2w"][:n], ckpt["K"], ckpt["build_pts"],
                     occ_masks=ckpt["occ_masks"], device=device,
                     train_draws=train_draws, rays_np=ckpt["rays"])
        runner.load_weights(path)
        key = np.asarray(ckpt["key"])
        if key.dtype == np.uint8:
            runner.generator.set_state(torch.from_numpy(key.copy()))
        else:
            logging.warning("%s holds a JAX PRNG key; the resumed steps draw from "
                            "the runner's own generator", path)
        return runner

    def load_weights(self, path: str):
        """Restore a checkpoint of either package (reference load_weights
        nerf_runner.py:551-574) into the bound parameter tensors.  A JAX
        file gives its weights (``models.nof.params_from_jax``) but not its
        optimizer state: Adam then restarts."""
        ckpt = load_checkpoint(path)
        new = nof_model.params_from_jax(ckpt["params"], device=self.device)

        def copy_into(dst: dict, src: dict):  # by key: a JAX file's keys are sorted
            if set(dst) != set(src):
                raise ValueError(f"{path}: parameters {sorted(src)} != {sorted(dst)}")
            for k, v in dst.items():
                if isinstance(v, dict):
                    copy_into(v, src[k])
                else:
                    v.copy_(src[k])

        with torch.no_grad():
            copy_into(self.params, new)
        if isinstance(ckpt["opt_state"], dict):  # the port's; a JAX file's is a tuple
            self.optimizer.load_state_numpy(ckpt["opt_state"])
        else:
            logging.info("%s: a JAX checkpoint; its optimizer state is not "
                         "carried over", path)
            self.optimizer.reset()
        self.global_step = int(ckpt["global_step"])
        self.total_step = int(ckpt.get("total_step", ckpt["global_step"]))
        self.occ_grid = torch.from_numpy(np.asarray(ckpt["occ_grid"])).to(self.device)
        self.n_frames = int(ckpt["n_frames"])
        self.c2w_np[:] = ckpt["c2w"]
        self.update_c2w()

    # ------------------------------------------------------------------
    def render_frame(self, fid: int, stride: int = 4,
                     draws: nof_render.SampleDraws | None = None) -> np.ndarray:
        """Render frame ``fid`` at every ``stride``-th pixel for inspection
        (the replacement for the reference's render_images canvases,
        nerf_runner.py:767-790) -> (H/stride, W/stride, 3) numpy RGB.
        ``draws``: the sampling jitter of all the frame's rays (the JAX
        runner draws it from ``PRNGKey(0)``); without it, from the runner's
        generator."""
        H, W = self.H, self.W
        dirs = geometry.camera_rays_gl_np(H, W, self.K)
        vs, us = np.meshgrid(np.arange(0, H, stride), np.arange(0, W, stride),
                             indexing="ij")
        vs, us = vs.reshape(-1), us.reshape(-1)
        rays = np.zeros((len(vs), nof_render.RAY_DIM), dtype=np.float32)
        rays[:, nof_render.RAY_DIR] = dirs[vs, us]
        rays[:, nof_render.RAY_DEPTH] = self.depths[fid][vs, us]
        rays[:, nof_render.RAY_FRAME_ID] = fid
        truncation = float(self.cfg["trunc"]) * float(self.cfg["sc_factor"])
        if draws is not None:
            draws = draws.to(self.device)
        with torch.no_grad():
            out = nof_render.render_rays(
                self.params, self.spec, self.rcfg, self.occ_grid,
                torch.from_numpy(rays).to(self.device), self.c2w_dev, truncation,
                draws, self.generator)
        return out["rgb_map"].cpu().numpy().reshape(len(np.arange(0, H, stride)), -1, 3)


def mesh_to_real_world(mesh: mesh_utils.Mesh, pose_offset, translation, sc_factor):
    """Reference parity Utils.py:508-514."""
    mesh.vertices = mesh.vertices / sc_factor - np.asarray(translation).reshape(1, 3)
    mesh.apply_transform(pose_offset)
    return mesh
