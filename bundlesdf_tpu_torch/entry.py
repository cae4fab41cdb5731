"""Entry points of the port: the Neural Object Field at the online budget,
the tracking-only tracker, the joint tracking + reconstruction loop, the
offline global refinement, and the XMem segmenter that gives those loops
each frame's mask from the first frame's.

``build_nof`` builds the same shapes and synthetic inputs as the JAX
package's ``__graft_entry__._build_nof``: the ray batch, camera poses and
occupancy grid come from the same numpy generator and seed, so both packages
see identical inputs; only the random parameter init differs (torch and
``jax.random`` streams differ; ``models.nof.params_from_jax`` converts JAX
params when a comparison needs equal weights).  The hash-grid spec is built
from the port's own ``default_nof_config``.

``make_entry_fn`` is the render + loss function of
``__graft_entry__.entry``.

``build_tracker`` is the tracking-only ``BundleSdf`` (``use_nof=False``)
under a tracker config (the shipped ``default_track_config`` when none is
given): feed it frames with ``tracker.run(color, depth, K, id_str, mask)``.
``build_pipeline`` is the joint ``BundleSdf`` (``use_nof=True``, the JAX
default): it also trains the NOF in rounds, feeds the optimized keyframe
poses back, and ``on_finish()`` returns the mesh; with
``save_artifacts=True`` and an ``out_dir`` it leaves the artifact trail.
``build_segmenter`` is XMem on the card (``io/segmentation.py::
XmemSegmenter``): passed as ``segmenter`` to either, it masks every frame
that ``run`` is given without one.
``run_global_refine`` is the port's ``scripts/run_custom.py --mode
global_refine``: it restarts from that trail, retrains the NOF at the
offline budget and writes the textured mesh and the refined poses.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .config import Cfg, default_nof_config, default_track_config
from .io.segmentation import XmemSegmenter
from .models import nof as nof_model
from .models import xmem
from .nof import losses as nof_losses
from .nof import render as nof_render
from .nof.texture import export_textured_obj
from .ops import hashgrid, occupancy as occ_ops
from .pipeline.artifacts import load_tracked_frames
from .pipeline.bundlesdf import BundleSdf
from .utils.device import resolve_device


def build_nof(n_rand=2048, n_samples=128, n_around=64, num_levels=4,
              finest_res=128, log2_hashmap=22, n_march=256, num_frames=16,
              occ_res=64, big_dtype="bfloat16", hash_scatter=None, seed=0,
              device=None):
    """-> (spec, rcfg, weights, params, rays, c2w, grid) on ``device``
    (``None`` = CUDA; raises when there is none).

    ``hash_scatter`` overrides the config's ``hash_scatter`` ("pallas"
    routes the small dense levels through the fused CUDA scatter, "seg"
    takes the segment-dedup scatters and run gathers)."""
    dev = resolve_device(device)
    cfg = default_nof_config()
    spec = nof_model.NofSpec(
        grid=hashgrid.HashGridSpec(
            num_levels, cfg["feature_grid_dim"], cfg["base_res"], finest_res,
            log2_hashmap, layout=cfg["hash_layout"],
            scatter=hashgrid.resolve_scatter(hash_scatter or cfg["hash_scatter"]),
            big_dtype=big_dtype,
            reduce=hashgrid.resolve_reduce(cfg["hash_reduce"], dev)),
        sh_degree=3,
        frame_features=0,
        num_frames=num_frames,
        max_trans=0.02,
        max_rot_deg=20.0,
        optimize_poses=True,
    )
    rcfg = nof_render.RenderCfg(
        n_samples=n_samples, n_samples_around_depth=n_around, n_march=n_march,
        sc_factor=1.0,
    )
    weights = nof_losses.LossWeights(sc_factor=1.0)
    params = nof_model.init_nof_params(spec, seed=seed, device=dev)

    rng = np.random.default_rng(0)
    rays = np.zeros((n_rand, nof_render.RAY_DIM), dtype=np.float32)
    rays[:, 0:2] = rng.uniform(-0.3, 0.3, (n_rand, 2))
    rays[:, 2] = -1.0
    rays[:, 3:6] = rng.uniform(0, 1, (n_rand, 3))
    rays[:, 6] = rng.uniform(0.8, 1.2, n_rand)  # depth
    rays[:, 7] = 1.0
    rays[:, 8] = rng.integers(0, num_frames, n_rand)
    rays[:, 10] = 0.3
    rays[:, 11] = 1.8

    c2w = np.broadcast_to(np.eye(4, dtype=np.float32), (num_frames, 4, 4)).copy()
    c2w[:, 2, 3] = 1.0  # cameras at z=+1 looking down -z (GL)

    pts = rng.normal(size=(2000, 3)).astype(np.float32)
    pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True) * 0.3
    pts_t = torch.from_numpy(pts).to(dev)
    grid = occ_ops.build_occupancy_grid(
        pts_t, torch.ones(len(pts), dtype=torch.bool, device=dev), occ_res)
    grid = occ_ops.dilate_grid(grid, 1)
    return (spec, rcfg, weights, params, torch.from_numpy(rays).to(dev),
            torch.from_numpy(c2w).to(dev), grid)


def make_entry_fn(spec, rcfg, weights):
    """The render + loss function of ``__graft_entry__.entry`` (truncation
    0.01): ``fn(params, rays, c2w, grid, draws=None, generator=None)``."""

    def fn(params, rays, c2w, grid, draws=None, generator=None):
        truncation = 0.01
        out = nof_render.render_rays(params, spec, rcfg, grid, rays, c2w,
                                     truncation, draws, generator)
        target_rgb = rays[:, nof_render.RAY_RGB]
        target_d = rays[:, nof_render.RAY_DEPTH]
        sdf = out["raw"][..., 3]
        sample_w = out["valid_samples"].to(torch.float32)
        loss = weights.rgb_weight * torch.mean((out["rgb_map"] - target_rgb) ** 2)
        fs, sd = nof_losses.sdf_losses(
            out["z_vals"], target_d[:, None], sdf, truncation, sample_w, weights)
        return loss + fs * weights.fs_weight + sd * weights.trunc_weight

    return fn


def build_segmenter(cfg=None, device=None, state_dict=None, seed=0) -> XmemSegmenter:
    """XMem (``models/xmem.py``) as a segmenter on ``device`` (None = CUDA;
    raises when there is none), under ``cfg`` (an ``XmemCfg``; None = the
    published settings).  ``state_dict``: weights under the port's names
    (``xmem.load_weights``); without one, seeded random weights
    (``xmem.init_weights``).  Hand it to ``build_tracker`` or
    ``build_pipeline`` as ``segmenter``."""
    dev = resolve_device(device)
    cfg = cfg or xmem.XmemCfg()
    net = xmem.init_weights(xmem.XmemNet(cfg), seed)
    if state_dict is not None:
        xmem.load_weights(net, state_dict)
    return XmemSegmenter(net.to(dev).eval(), cfg, dev)


def build_tracker(cfg_track=None, device=None, ransac_draws=None,
                  segmenter=None) -> BundleSdf:
    """The tracking-only BundleSdf on ``device`` (None = CUDA; raises when
    there is none).  ``ransac_draws``: optional RANSAC draw source
    ``(frame_id, shape) -> uniforms`` (``ops/ransac.draw_uniforms``).
    ``segmenter``: where each frame's mask comes from (``build_segmenter``;
    ``BundleSdf.run``)."""
    return BundleSdf(cfg_track=cfg_track, use_nof=False, device=device,
                     ransac_draws=ransac_draws, segmenter=segmenter)


def build_pipeline(cfg_track=None, cfg_nof=None, start_nerf_keyframes=5,
                   device=None, ransac_draws=None, nof_draws=None,
                   save_artifacts=False, out_dir=None, segmenter=None) -> BundleSdf:
    """The joint tracker + NOF BundleSdf on ``device`` (None = CUDA; raises
    when there is none), under the shipped configs where none is given.
    Feed it frames with ``pipeline.run(color, depth, K, id_str, mask)``;
    ``pipeline.on_finish()`` returns the mesh.  ``nof_draws``: optional NOF
    draw source ``(step, n_rays) -> (batch_idx, SampleDraws)``.
    ``save_artifacts``: write the artifact trail under ``out_dir`` (the
    tracker's ``SPDLOG`` >= 2 adds the image dumps the global refinement
    needs).  ``segmenter``: where each frame's mask comes from
    (``build_segmenter``; ``BundleSdf.run``).

    ``cfg_nof["dp_devices"] > 1``: every rank of a process group of that
    many ranks (``parallel.distributed.init_multihost``) calls this; rank 0
    (``pipeline.lead``) is fed the frames and ``on_finish()``, the other
    ranks call ``pipeline.follow()`` and train the NOF with it."""
    return BundleSdf(cfg_track=cfg_track, cfg_nof=cfg_nof,
                     start_nerf_keyframes=start_nerf_keyframes, use_nof=True,
                     device=device, ransac_draws=ransac_draws, nof_draws=nof_draws,
                     save_artifacts=save_artifacts, out_dir=out_dir, segmenter=segmenter)


def run_global_refine(out_folder: str, refine_steps: int | None = None,
                      get_texture: bool = True, device=None, dp_devices: int = 0):
    """The offline global refinement of a tracked run (the port of
    ``scripts/run_custom.py::run_one_video_global_nerf``, :82-124): load the
    artifact trail under ``out_folder``, reuse the online normalization
    saved in ``config_nerf.yml``, take the intrinsics from ``cam_K.txt``
    beside ``out_folder`` (where the JAX script looks for it), else a
    default; retrain the NOF at the offline budget (``refine_steps``
    replaces its 2000 steps), then write ``textured_mesh.obj`` (with its
    ``.mtl`` and ``.png`` when textured) and
    ``poses_after_global_refine.txt``.  ``device``: None = CUDA.

    ``dp_devices > 1``: train data-parallel over that many ranks of the
    initialised process group (``parallel.distributed.init_multihost``),
    each on its own device (``device`` None = the rank's CUDA card); every
    rank runs this function, and rank 0 alone writes the files (the other
    ranks skip the texture bake).  Returns (pipeline, mesh, poses)."""
    lead = True
    if dp_devices > 1:
        from .parallel.mesh import make_mesh

        mesh = make_mesh(dp_devices, device=device)
        device, lead = mesh.device, mesh.rank == 0
    frames = load_tracked_frames(out_folder)
    if not frames:
        raise RuntimeError(f"no tracked frames under {out_folder} (run a tracked "
                           "video with save_artifacts first)")
    pipe = BundleSdf(cfg_track=default_track_config(), use_nof=False, device=device)
    cfg_path = f"{out_folder}/config_nerf.yml"
    if os.path.exists(cfg_path):
        saved = Cfg.load(cfg_path)
        if float(saved.get("sc_factor", 1.0)) != 1.0:
            pipe.cfg_nof = pipe.cfg_nof.merged(
                {"sc_factor": saved["sc_factor"], "translation": saved["translation"]})
            pipe.sc_factor = float(saved["sc_factor"])
            pipe.translation = np.asarray(saved["translation"])
    K_file = f"{os.path.dirname(out_folder)}/cam_K.txt"
    if os.path.exists(K_file):
        pipe.K = np.loadtxt(K_file).reshape(3, 3).astype(np.float32)
    else:
        h, w = frames[0]["depth"].shape
        pipe.K = np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float32)
        logging.warning("no cam_K.txt beside %s: default intrinsics %s", out_folder,
                        pipe.K.tolist())
    cfg_refine = pipe.cfg_nof.merged({
        "n_step": int(refine_steps or 2000), "N_samples": 64,
        "N_samples_around_depth": 256, "num_levels": 16,
        "finest_res": 256, "frame_features": 2, "rgb_weight": 100.0,
        "loop_chunk": 10, "dp_devices": dp_devices,
    })
    mesh, poses = pipe.run_global_nerf(frames, cfg_refine=cfg_refine,
                                       get_texture=get_texture and lead)
    if not lead:
        return pipe, mesh, poses
    if getattr(mesh, "face_uv", None) is not None:
        export_textured_obj(mesh, pipe.texture, f"{out_folder}/textured_mesh.obj")
    else:
        mesh.export(f"{out_folder}/textured_mesh.obj")
    np.savetxt(f"{out_folder}/poses_after_global_refine.txt", poses.reshape(-1, 4))
    return pipe, mesh, poses
