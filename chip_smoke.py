#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``bundlesdf_tpu_torch``) on one GPU.

    python3 chip_smoke.py                  # one card, a few minutes
    python3 chip_smoke.py --profile DIR    # also profiles the train steps, 2
                                           # tracked frames and one offline
                                           # step, and writes kernel tables
                                           # to DIR

Phases, one JSON line each (any failure raises; the exit code is then not 0):

  build         compile every CUDA source of the port with nvcc for sm_90a
  kernels       each hand-written kernel against its plain PyTorch version at
                the online-budget shapes (the scatter on uniform and on
                ray-major cells): max abs error, kernel / plain / library
                device times (``cuda_ms``: CUDA events, L2 cold, queued
                behind a device spin), the wrapper's host time per call
                (``host_us``), the memory-or-compute bound, its share, and
                the bytes and operations it is computed from
  depth_frame   the tracker's depth kernel (ops/depth_cuda.py) against the
                host twin process_depth_frame_np with the Frame's mask
                invalidation: bitwise depth, xyz and normals, equal valid, on
                the 60 frames portbench/video.py renders for track60 and on
                hard frames (tests/port_depth_kernel.py), at the shipped radii
                and at DEPTH_WIDE; a Frame on the card equals one on the CPU;
                the kernel's device ms against its byte bound, upload,
                readback and wrapper ms, the twin's host ms and the plain
                torch process_depth_frame on the card
  covisibility  the tracker's covisibility kernel (ops/covisibility_cuda.py)
                against the host twin compute_covisibility, one launch a
                batch: on hard frames (tests/port_covisibility_kernel.py) and
                on track60's 60 Frames at their true poses, each against up
                to COV_POSES predecessors, every count the twin's or off by at
                most the points whose float64 dot lies within 1e-5 of the
                threshold; at 480 x 640 with COV_POSES keyframe poses the
                kernel's device ms against its byte bound, one frame's upload,
                the twin's host ms and one whole Bundler.covisibilities call
  small_parity  the train step on the card against the same step on the CPU
                (plain versions of the kernels) at a small budget, same
                parameters (the card's, taken by the CPU before each of 3
                steps), batch and jitter: the loss, and the gradient of every
                parameter and of each table level; under hash_scatter pallas
                and under seg
  nof_train_graph_parity  the train step replayed from its CUDA graph
                (nof/runner.py::TrainLoop) against the eager step on the
                card, from one snapshot and one set of draws, at the online
                budget, under hash_scatter pallas, with the options
                (N_importance 64, eikonal 0.1), at the offline budget's 8
                microbatches, and under hash_scatter seg at both budgets:
                the loss and every gradient within small_parity's bounds
                under deterministic algorithms (under the default ones
                reported beside two eager steps' spread); seg against xla
                from the same snapshot and draws (the loss bitwise, f32
                gradients within 1e-4 relative L2, bf16 levels within
                2.5/256 of their largest entry); the offline cases' steady
                replays timed, and the offline seg step's R = 148 two-stage
                run gather against the direct gather;
                the launches a replay adds equal to the eager step's; the
                eager step and a replay at one generator state draw one
                batch, consecutive replays different ones; a runner captures
                again after its ray pool doubles, not after load_weights,
                and a full checkpoint saved after replays resumes the same
                draws
  nof_train_step                  the NOF training loop at the online budget
                (2048 rays x (128 + 64) samples, 4 hash levels 16 -> 128, bf16
                big levels) under the shipped config, one replay a step (one
                capture); replayed and eager step_ms, graph memory, peak
                memory; the reduce kernel must launch exactly twice per step
                run (the replays and the capture's warm-up step) and the loss
                must fall
  nof_train_step_pallas_scatter   the same loop under hash_scatter: pallas;
                the fused scatter kernel must launch once per step run
  nof_train_step_seg   the same loop under hash_scatter: seg (the JAX
                package's default: segment-dedup scatters, the run-cap
                choice made on the device inside the captured step), beside
                nof_train_step's step_ms, graph pool and peak memory; the
                reduce twice per step run, the loss falls; from one more
                eager step, each dense level's runs a ray against its cap
                and whether every ray fit, and the device time of its
                scatter (both branches) against the seg branch alone and
                the per-sample scatter alone
  nof_options_small_parity  the NOF options on the card against the CPU:
                run_global_nerf's runner on the sphere of
                global_refine_small_parity (3 levels 16 -> 64, R = 64 bf16,
                N_importance 16, eikonal_weight 0.1) under the exact and the
                cell hash layouts, equal weights and draws: the loss and every
                gradient over 3 rounds, within small_parity's bounds; no kernel
                on the exact path, the reduce on the cell path
  nof_train_step_exact    the online-budget loop under hash_layout exact:
                the loss falls, no kernel launches; step_ms, peak memory
  nof_train_step_options  the online-budget loop (cell) with N_importance 64
                and eikonal_weight 0.1: the loss falls and the reduce launches
                OPTIONS_ENCODE_BACKWARDS times a step run per bf16 level
  tracking_small_parity  the tracking-only tracker on the 96 x 96 cube
                sequence (6 frames, 3 deg apart) under the small test config,
                once on the card and once on the CPU with the same RANSAC
                draws: poses within 1 mm and 0.2 deg, same keyframes and FAIL
                statuses
  tracking      the tracking-only tracker at full width: the shipped tracker
                config on 16 frames of 480 x 640 RGBD of a dots-textured cube
                turning 6 deg a frame (make_synth_video's poses, its
                translation wobble halved); per-frame wall time
                (track_ms_per_frame), per-span means, fused match + BA
                launches, keyframes, FAIL frames (must be 0), ADD / ADD-S
                against ground truth (mean ADD must be under 1 cm) and peak
                device memory
  loftr_parity  LoFTR at full width (400 x 400 crops of frames 1 and 0 of the
                tracking video, seeded random weights, thr 0) on the card
                against the CPU: crops, coarse conf matrix, selected ids,
                mkpts1; the card's forward ms at batch 1 and 16, operations
                and peak memory, and the same forward on cuDNN's convolutions
  tracking_legacy  the tracking video under the shipped tracker config with
                feature_corres.fused False: the corner matcher through the
                host-warp path and the split BA; 0 FAIL, mean ADD under 1 cm,
                one BA a frame, no fused program; the corres/* span means
  tracking_loftr   the same video with feature_corres.matcher loftr (seeded
                random weights, no quality limit) through entry.build_tracker
                on the card: every frame runs, LoFTR at each fresh match
  sift_parity   the port's SIFT (ops/sift.py) and SiftMatcher on the card
                against the same code on the CPU, on 2 pairs of the tracking
                video warped to 400 x 400 (the same uint8 crops on both):
                keypoint recall and precision, equal descriptors and match-row
                overlap, each held to its bound; SiftMatcher.predict ms a pair
                at batch 1 and 16 by CUDA events, detection alone, peak memory
  tracking_sift the tracking video with feature_corres.matcher sift through
                the host-warp path: 0 FAIL, mean ADD under 1 cm, SIFT at each
                fresh match; frame ms and the corres/* span means
  joint_small_parity  the joint tracking + NOF loop (BundleSdf(use_nof=True))
                on the 96 x 96 cube sequence under the small test configs,
                once on the CPU and once on the card with the same RANSAC
                draws, NOF batches and initial weights: the same keyframes,
                round starts and budgets and nerfed keyframes, poses within
                1 mm and 0.2 deg, both meshes on the cube's surface
  joint         the joint loop at full width through entry.build_pipeline:
                the shipped tracker and NOF configs (the NOF cut in depth to
                100 + 25-step rounds) on the tracking video's first 12
                frames, leaving the artifact trail (save_artifacts, SPDLOG
                2) in a temporary folder; per-frame wall time, rounds and
                their steps, the step calibration, nof/* span means, the
                trail's write time (artifacts/save), 0 FAIL and mean ADD
                under 1 cm, a mesh on the cube's surface, peak memory, and
                the reduce kernel launched twice per NOF step trained
  joint_rematch the joint phase's cut with rematch_after_nerf and keyframe 1
                moved 6 mm in the first round's poses: invalidated keyframes,
                pairs re-gated from raw tables with no matcher launch, 0 FAIL,
                mean ADD under 1 cm, the reduce twice a NOF step
  joint_remote  the joint phase's cut with feature_corres.matcher remote: the
                port's MatchServer serves the port's SiftMatcher on the same
                card from a child process on a free port (remote_port); the
                requests served equal the corres/match launches, the reduce
                twice a NOF step, 0 FAIL, mean ADD under 1 cm, the mesh within
                3 cm of the cube
  global_refine_small_parity  BundleSdf.run_global_nerf on the card against
                the CPU: the sphere and cfg_refine of tests/test_pipeline.py
                (steps cut), the same initial weights and step draws, the
                texture bake on: poses, mesh vertices and distance; then the
                rasterizer and the texel bake of one mesh on both devices
  global_refine the offline global refinement at full width through
                entry.run_global_refine on the joint phase's trail: the
                shipped offline budget (2048 rays x (64 + 256) samples, 16
                levels 16 -> 256, log2 table 22, bf16 big levels,
                frame_features 2) cut in depth only (GLOBAL_STEPS steps,
                replayed); step time over the phase, then GLOBAL_EAGER_STEPS
                steady replays and as many eager steps, microbatch, the
                reduce launched 5 x microbatches per step run, one eager
                step's inputs: each of its 5 shapes held bitwise against the
                plain reduce on one step's inputs with its times and bound,
                the mesh against the cube (median under 3 cm), the refined
                keyframe poses against ground truth (0 FAIL, mean ADD under
                1 cm), the atlas and texel coverage, the textured OBJ read
                back, peak memory and span means
  cli           the user's script, bundlesdf_tpu_torch.scripts.run_custom, at
                full width on the tracking video's first 6 frames written as a
                YCBInEOAT folder: run_video (shipped configs, debug level 2,
                the dashboard on), global_refine (10 offline steps) and
                draw_pose in-process, then draw_pose through python3 -m;
                poses (0 FAIL, mean ADD under 1 cm), the reduce launched twice
                a NOF step and 40 times an offline step, mesh_online.obj on
                the cube, the config YAMLs, 6 dashboard PNGs of 480 x 1920 with
                the mesh panel drawn, the textured mesh and refined poses, 6
                pose overlays; frame, reader and dashboard times
  ho3d          run_ho3d and benchmark_ho3d on the same 6 frames written as a
                synthetic HO3D folder (JPEG colour from a small baseline
                encoder, packed depth, pickled meta, XMem masks, the cube as
                the model and its visible shell): the colour decoded within
                JPEG loss, 0 FAIL, ADD AUC and chamfer in benchmark.json
                within their limits, a second run skipping the finished video;
                JPEG decode time
  codecs        the readers' image formats (host numpy, no kernel): the
                committed fixtures of tests/data/codecs against the digests
                of the JAX readers' calls (imageio for JPEGs, cv2.imread(-1)
                for masks, through imread_unchanged); the ho3d frames
                written again as progressive, arithmetic sequential and
                progressive (the same coefficients) and lossless (the
                baseline decode) files, each bit-equal to the baseline
                frame through decode_jpeg and Ho3dReader.get_color; decode
                ms a frame of each kind
  loftr_train   the LoFTR trainer at TrainCfg() and full width: one step card
                against CPU (loss and every gradient), LOFTR_TRAIN_STEPS steps
                of train_loftr from a seeded init under deterministic
                algorithms (the loss must fall; ms a step, then split into
                batch, forward, backward and optimizer; peak memory), the
                saved file through load_checkpoint, the tracking video on
                those weights (tracking_loftr_trained, no quality
                limit), and the CLI with --steps 5 --out
  synth_eval    the quality evaluations as a user runs them: benchmark_synth
                (the shipped configs, the corner engine) on SYNTH_FRAMES
                frames of the hard fixture at 480 x 480, then eval_matcher on
                its pairs at gaps SYNTH_GAPS with the corner and SIFT engines;
                ADD AUC, mean ADD, the mesh's distance to the blob and the
                inlier rates held to the JAX scripts' CPU run on the same cut
                (SYNTH_JAX_CPU, MATCH_JAX_CPU) within stated margins, 0 FAIL,
                the reduce twice a NOF step

Last, the data-parallel phases, in one group of DP_RANKS copies of this
script (``--dp-worker``) on the same card, joined by gloo through the
BSDF_* variables (parallel.distributed.init_multihost); each prints the
launches of every rank, and a rank that fails or hangs fails the script:

  dp_small_parity  the 2-rank NOF step against the single-rank step on the
                same card and the same global batch and draws, on
                nof_options_small_parity's sphere: under hash_scatter pallas
                (both kernels on both ranks) and with eikonal_weight 0.1
                (the all-reduced count); the loss and every gradient, the
                table level by level, within small_parity's bounds
  nof_train_step_dp  the online-budget step over 2 ranks with the table
                sharded, DP_TRAIN_STEPS steps: the reduce twice a step on
                every rank, the loss falls; ms a step a rank, the
                collectives' ms a step, beside nof_train_step's step_ms
  global_refine_dp  run_custom --mode global_refine --refine_steps
                DP_REFINE_STEPS on a copy of the joint trail, on both ranks
                (the 16-level offline budget, no microbatching under dp):
                rank 0 writes the textured mesh and the poses; the reduce 5 a
                step on every rank
  ba_shard      the sharded BA on 2 ranks against the single BA, bench.py's
                inputs (10 frames, 7 GN iterations), within DP_BA_TOL
  loftr_train_dp  DP_LOFTR_STEPS data-parallel LoFTR steps at TrainCfg() (4
                pairs a rank) against a single-rank step on the same global
                batch, in f64: loss and gradients within loftr_train's
                bounds; then as many f32 steps, ms a step
  joint_dp_small_parity  the online joint loop over the 2 ranks (rank 0 the
                tracker of record, rank 1 following its NOF calls) against
                rank 0's 1-rank loop on the 96 x 96 cube (small configs, the
                finest level dense and bf16-staged): equal keyframes, round
                starts, nerfed set and steps, poses within 1 mm and 0.2 deg,
                the reduce on both ranks as often as in the 1-rank run, no
                tracker span on rank 1
  joint_dp      the joint phase's cut (shipped configs, JOINT_DEPTH, the
                first JOINT_FRAMES frames at 480 x 640, the trail from rank
                0) over the 2 ranks: frame ms on rank 0, the reduce twice a
                step on every rank, 0 FAIL, mean ADD under 1 cm, the mesh
                within 3 cm of the cube

Every NOF training phase (the train phases, the joint, script and
evaluation phases, global_refine) checks that its steps went through
replays (check_graph_counts): replays equal the steps trained, no eager
step, at most one capture a ray pool allocated or checkpoint loaded, and
each kernel's launches per step run (replays and warm-ups).

Before the last line it prints the card's name and power limit (first line)
and the kernels summary ``{"kernels": [...]}``, whose kernel times are taken on
the inputs the train steps handed each kernel (``launches_joint``,
``launches_global``, ``launches_cli``, ``launches_ho3d``,
``launches_tracking_legacy``, ``launches_loftr``, ``launches_rematch``,
``launches_options_small_parity``, ``launches_train_seg``, ``launches_train_exact``,
``launches_train_options``, ``launches_loftr_train``,
``launches_sift_parity``, ``launches_tracking_sift``,
``launches_joint_remote``, ``launches_synth_eval``, ``launches_codecs``
and the dp phases' ``launches_*_by_rank``: the
launches of those phases; ``global``: the
reduce's sums over the offline step's 5 shapes; ``options``: over one
nof_train_step_options step's launches), LoFTR's forward times and
SiftMatcher's ms a pair.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits 1
and prints no result.

The script imports nothing of JAX or of the JAX package ``bundlesdf_tpu``;
the tracking phases render their frames with ``tests/synthetic_cube.py``
(numpy and scipy).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s
# outside the tensor cores, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Spin cycles per second of host enqueue time to cover: above the H100's
# top SM clock (1.98 GHz), so the spin lasts at least as long as asked.
SPIN_HZ = 2.0e9
# Bytes read between timed calls to evict their inputs from the 50 MB L2.
L2_FLUSH_BYTES = 128 << 20

# Online budget (the JAX package's bench.py:50-53).
ONLINE = dict(n_rand=2048, n_samples=128, n_around=64, num_levels=4,
              finest_res=128, log2_hashmap=22, n_march=200, num_frames=16,
              occ_res=64)
TRAIN_STEPS = 20
SCATTER_STEPS = 8
# The NOF options at the online budget: the exact hash layout (no kernel on
# its path), and the cell layout with importance resampling and the eikonal
# loss (the reduce on a longer path).
OPTIONS_EXACT = {"hash_layout": "exact"}
OPTIONS_RESAMPLE_EIKONAL = {"N_importance": 64, "eikonal_weight": 0.1}
OPTION_STEPS = 10
# Encode backwards per step with OPTIONS_RESAMPLE_EIKONAL, read off the
# autograd graph (and counted on the CPU by tests/test_torch_eikonal.py):
# the render's two field queries (the first pass and the importance
# samples) each run one; the eikonal normals run the third query's backward
# once inside autograd.grad(create_graph=True), and the step's backward runs
# it once more, on a zero cotangent that reaches the query's output through
# ReLU's zero second derivative.  Each backward launches the reduce once per
# bf16 level (R = 64 and 128 at the online budget).
OPTIONS_ENCODE_BACKWARDS = 4

# Tracking at full width: frames, size and rotation step of the synthetic
# video (scripts/make_synth_video.py's poses at 480 x 640), and the frames
# that the per-frame times are read over (the first two warm up).
TRACK_FRAMES = 16
TRACK_HW = (480, 640)
TRACK_DEG = 6.0
TRACK_TIMED = slice(2, TRACK_FRAMES)
TRACK_PROFILED = 2
# The script's translation wobble at half amplitude.  At full amplitude the
# model origin (the first frame's visible-surface centroid, ~10 cm off the
# cube's centre) truly moves up to 2.16 cm between neighbouring frames
# (max of model_origin_steps(tracker, 1.0)), past the shipped config's
# neighbour gate (ransac.max_trans_neighbor, 2 cm): a correct pose fails
# the gate there, so the tracker FAILs those frames.  At half amplitude the
# largest true step is 1.86 cm, and the phase asserts that it stays under
# the gate (the poses' error is well under the 1.4 mm left, PERF.md §5).
TRACK_WOBBLE = 0.5

# The depth kernel's phase: the video's seed (it salts the dots), the
# hard frames and the wider (erode, bilateral) radii within the tile's halo.
DEPTH_SEED = 2147500404
DEPTH_HARD_FRAMES = 8
DEPTH_WIDE = (2, 4)

# The covisibility kernel's phase: the video's and the hard frames' seed,
# and the keyframe poses a new frame is scored against.
COV_SEED = 2147500505
COV_POSES = 30

# The joint loop at full width: the first JOINT_FRAMES frames of the
# tracking video, NOF rounds from the JOINT_START-th keyframe, and the
# shipped NOF config cut in depth only (500 -> 100 steps in the first round;
# extension rounds 25 steps where the shipped 0 means n_step again).
JOINT_FRAMES = 12
JOINT_START = 5
JOINT_DEPTH = {"n_step": 100, "n_step_extend": 25}

# The offline global refinement at full width, cut in depth only: 2000 ->
# GLOBAL_STEPS steps of the shipped offline budget (60: down from 300 to
# make room for the script phases, from 200 for the dp phases, from 120 for
# synth_eval and the joint loop under dp, within half the time limit).
GLOBAL_STEPS = 60
# offline steps replayed, then run eagerly, each timed after the counted run
GLOBAL_EAGER_STEPS = 3
# Its small card-against-CPU parity: tests/test_pipeline.py:181-186's
# cfg_refine with n_step 150 -> 30.
REFINE_SMALL = {"n_step": 30, "N_rand": 256, "N_samples": 8, "N_samples_around_depth": 8,
                "num_levels": 2, "finest_res": 32, "log2_hashmap_size": 14,
                "frame_features": 2, "octree_smallest_voxel_size": 0.05,
                "octree_dilate_size": 0.05, "mesh_resolution": 0.04, "loop_chunk": 5}

# LoFTR at full width, card against CPU on one pair (loftr_parity): the conf
# matrix's abs error (f32 through the backbone and 10 layers, amplified by
# the 0.1 temperature: up to 1.04e-5 between the JAX package and the port on
# the CPU at the tests' narrow width), the share of valid slots whose (i, j)
# ids agree, and mkpts1's error on those slots.
LOFTR_CONF_TOL = 1e-4
LOFTR_SAME_SHARE = 0.99
LOFTR_MKPTS_TOL = 0.05
# The pair warp (io/imgproc.py::warp_perspective), card against CPU, in grey
# levels of [0, 255]: the tests hold it to cv2 within 1e-3.
WARP_TOL_GREY = 1e-3
# joint_rematch: how far keyframe 1 is moved in the first round's poses, past
# the 5 mm rematch gate.
JOLT_M = 0.006

# Tolerances of each kernel against its plain version on the same inputs.
# reduce: both sum the same <= 8 bf16 terms in f32 in the same corner order,
# so they agree bitwise; the stated bound leaves room for nothing but that.
REDUCE_RTOL = 1e-6
# scatter: f32 atomics add in a nondeterministic order; up to ~800 terms per
# address at these shapes, so a reorder moves a sum by well under 1e-5 of
# the largest sum.
SCATTER_RTOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@functools.lru_cache(maxsize=1)
def _l2_flush_buffer():
    import torch

    return torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``, with the L2 cold.

    Three CUDA events time ``iters`` calls, each after a read of a buffer
    2.5x the size of the 50 MB L2 that pushes the call's inputs out of it
    (so its bytes come from device memory, as the bound assumes), and then
    the same reads alone; the difference over ``iters`` is the call's time.
    All of it queues behind a device-side spin that outlasts the host's
    enqueue, so the reading is device time even where a call's host cost
    exceeds its kernel's.  Raises if the first event had already passed
    when the host finished enqueueing (spin too short) after doubling the
    spin three times."""
    import torch

    flush = _l2_flush_buffer()

    def calls():
        for _ in range(iters):
            flush.sum()
            fn()

    def flushes():
        for _ in range(iters):
            flush.sum()

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls()
    flushes()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for attempt in range(4):
        torch.cuda._sleep(int(SPIN_HZ * enqueue_s * 2 ** (attempt + 1)) + 100_000)
        ev[0].record()
        calls()
        ev[1].record()
        flushes()
        ev[2].record()
        covered = not ev[0].query()
        torch.cuda.synchronize()
        if covered:
            return (ev[0].elapsed_time(ev[1]) - ev[1].elapsed_time(ev[2])) / iters
    raise AssertionError("the device spin did not cover the host's enqueue")


def graphed(fn):
    """``fn`` captured as a CUDA graph after one warm-up call: its replay,
    one launch however many kernels ``fn`` enqueues (timing ``fn`` itself
    with cuda_ms would fill the launch queue behind the spin).  The
    replayed train step runs such code the same way."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def host_us(fn, calls: int = 100) -> float:
    """Mean host time of one call of ``fn`` (its enqueue: no
    synchronisation inside the timed loop), in microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- kernels ---

def reduce_cost(R: int, C: int, size: int) -> tuple[float, float]:
    """Bytes (bf16 input read once, f32 output written once) and adds."""
    return R ** 3 * 8 * C * 2 + size * C * 4, R ** 3 * 8 * C


def scatter_cost(n: int, width: int, rows: list) -> tuple[float, float]:
    """Bytes (indices and updates read once per level, accumulators written
    once) and adds."""
    k = len(rows)
    return k * n * (4 + 4 * width) + sum(rows) * width * 4, k * n * width


def conv3d_reduce(R: int, C: int, device):
    """The library yardstick of the reduce: one one-hot 2x2x2 ``conv3d`` on
    the f32 cache in channels-last layout (never called by the port)."""
    import torch
    import torch.nn.functional as F

    from bundlesdf_tpu_torch.ops.hashgrid import _CORNERS

    w = torch.zeros((C, 8 * C, 2, 2, 2), device=device)
    for ci, c in enumerate(_CORNERS):
        for ch in range(C):
            w[ch, ci * C + ch, 1 - int(c[0]), 1 - int(c[1]), 1 - int(c[2])] = 1.0

    def run(x_f32_cl):
        return F.conv3d(x_f32_cl, w, padding=1)

    def prep(d_cache):
        return d_cache.float().view(1, R, R, R, 8 * C).permute(0, 4, 1, 2, 3)

    def flat(out):
        return out.permute(0, 2, 3, 4, 1).reshape(-1)

    return prep, run, flat


def check_reduce(d_cache, R: int, C: int, size: int) -> dict:
    from bundlesdf_tpu_torch.ops import reduce_cuda

    out = reduce_cuda.reduce_cell_cache_grad(d_cache, R, C, size)
    ref = reduce_cuda.reduce_cell_cache_grad_plain(d_cache, R, C, size)
    err = max_err(out, ref)
    tol = REDUCE_RTOL * max(1.0, float(ref.abs().max()))
    if not err <= tol:
        raise AssertionError(f"reduce R={R}: max abs err {err} > {tol}")
    prep, run, flat = conv3d_reduce(R, C, d_cache.device)
    x_cl = prep(d_cache)
    S3C = (R + 1) ** 3 * C
    lib_err = max_err(flat(run(x_cl)), ref[:S3C])
    if not lib_err <= tol:
        raise AssertionError(f"conv3d yardstick R={R} disagrees: {lib_err}")
    n_bytes, n_ops = reduce_cost(R, C, size)
    b_ms, b_by = bound(n_bytes, n_ops)

    def kernel():
        return reduce_cuda.reduce_cell_cache_grad(d_cache, R, C, size)

    k_ms = cuda_ms(kernel)
    return {
        "R": R, "C": C, "max_abs_err": err, "tol": tol,
        "kernel_ms": k_ms, "host_us": host_us(kernel),
        "plain_ms": cuda_ms(lambda: reduce_cuda.reduce_cell_cache_grad_plain(
            d_cache, R, C, size)),
        "library_ms": cuda_ms(lambda: run(x_cl)),
        "library": "F.conv3d one-hot 2x2x2, f32 input, channels-last",
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms,
        "bytes": n_bytes, "ops": n_ops,
    }


def check_scatter(cells: list, d_rows: list, rows: list) -> dict:
    import torch

    from bundlesdf_tpu_torch.ops import hashgrid_cuda

    outs = hashgrid_cuda.fused_cache_scatter(cells, d_rows, rows)
    refs = hashgrid_cuda.fused_cache_scatter_plain(cells, d_rows, rows)
    errs = [max_err(o, r) for o, r in zip(outs, refs)]
    tols = [SCATTER_RTOL * max(1.0, float(r.abs().max())) for r in refs]
    for e, t, r in zip(errs, tols, rows):
        if not e <= t:
            raise AssertionError(f"scatter rows={r}: max abs err {e} > {t}")
    n, width = d_rows[0].shape
    lib_ms = None
    if len(rows) == 1:  # one index_add_ computes the whole function
        acc = torch.zeros((rows[0], width), device=d_rows[0].device)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, cells[0], d_rows[0]))
    n_bytes, n_ops = scatter_cost(n, width, rows)
    b_ms, b_by = bound(n_bytes, n_ops)

    def kernel():
        return hashgrid_cuda.fused_cache_scatter(cells, d_rows, rows)

    k_ms = cuda_ms(kernel)
    return {
        "rows": rows, "N": n, "width": width, "max_abs_err": max(errs),
        "tol": min(tols), "kernel_ms": k_ms, "host_us": host_us(kernel),
        "plain_ms": cuda_ms(lambda: hashgrid_cuda.fused_cache_scatter_plain(
            cells, d_rows, rows)),
        "library_ms": lib_ms,
        "library": "Tensor.index_add_" if lib_ms is not None else None,
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms,
        "bytes": n_bytes, "ops": n_ops,
        "adds_per_address": n * len(rows) / sum(rows),
        "mean_run": [mean_run(c) for c in cells],
    }


def mean_run(cells) -> float:
    """Mean length of the runs of equal consecutive indices."""
    return cells.numel() / (1 + int((cells[1:] != cells[:-1]).sum()))


def ray_major_cells(n_rays: int, n_occ: int, n_band: int, R: int, gen, device):
    """Seeded ray model of the train step's level-R cells, ray-major as the
    step makes them (models/nof.py flattens (rays, samples)): each ray is a
    segment between two uniform points of [-1, 1]^3 with ``n_occ`` sorted
    uniform samples along it, followed by ``n_band`` sorted samples within
    +-0.02 of a surface point in its middle; cells as the encode computes
    them (pos = x01 * (R - 1) + 0.5)."""
    import torch

    a = torch.rand((n_rays, 1, 3), generator=gen, device=device) * 2 - 1
    b = torch.rand((n_rays, 1, 3), generator=gen, device=device) * 2 - 1
    t_occ = torch.rand((n_rays, n_occ), generator=gen, device=device).sort(1)[0]
    t_srf = 0.3 + 0.4 * torch.rand((n_rays, 1), generator=gen, device=device)
    t_band = t_srf + 0.02 * (2 * torch.rand((n_rays, n_band), generator=gen,
                                            device=device) - 1)
    t = torch.cat([t_occ, t_band.sort(1)[0]], 1).unsqueeze(-1)
    x01 = ((a + t * (b - a)) + 1) * 0.5
    g = torch.floor(x01 * (R - 1) + 0.5).to(torch.int32).clamp_(0, R - 1)
    return ((g[..., 0] * R + g[..., 1]) * R + g[..., 2]).reshape(-1).contiguous()


def online_levels() -> tuple[list, tuple]:
    """Resolutions of the online budget's bf16-staged levels (one reduce
    launch each per step) and of the levels the fused scatter takes."""
    import torch

    from bundlesdf_tpu_torch.ops import hashgrid

    spec = hashgrid.HashGridSpec(ONLINE["num_levels"], 2, 16, ONLINE["finest_res"],
                                 ONLINE["log2_hashmap"], layout="cell",
                                 big_dtype="bfloat16")
    lp = spec.level_params()
    bf16 = [p["res"] for p in lp
            if hashgrid._lvl_dtype(spec, p) == torch.bfloat16]
    fused = tuple(p["res"] for p in lp
                  if p["dense"] and p["res"] ** 3 <= hashgrid._PALLAS_FUSE_ROWS)
    return bf16, fused


def phase_kernels(device) -> dict:
    import torch

    bf16_res, fused_res = online_levels()
    gen = torch.Generator(device=device).manual_seed(0)
    reduce_rows = []
    for R in (8, 64, 128):
        d_cache = torch.randn((R ** 3, 16), generator=gen,
                              device=device).to(torch.bfloat16)
        size = -(-(R + 1) ** 3 // 8) * 8  # the level's 8-aligned table size
        row = check_reduce(d_cache, R, 2, size)
        row["launches_per_step"] = bf16_res.count(R)
        reduce_rows.append(row)
    scatter_rows = []
    n = ONLINE["n_rand"] * (ONLINE["n_samples"] + ONLINE["n_around"])
    for Rs in ((16,), (8, 16)):
        cells = [torch.randint(0, R ** 3, (n,), generator=gen, device=device,
                               dtype=torch.int32) for R in Rs]
        d_rows = [torch.randn((n, 16), generator=gen, device=device) for _ in Rs]
        row = check_scatter(cells, d_rows, [R ** 3 for R in Rs])
        row["launches_per_step"] = int(Rs == fused_res)  # under hash_scatter: pallas
        row["cells"] = "uniform"
        scatter_rows.append(row)
    cells = ray_major_cells(ONLINE["n_rand"], ONLINE["n_samples"], ONLINE["n_around"],
                            16, gen, device)
    row = check_scatter([cells], [torch.randn((n, 16), generator=gen, device=device)],
                        [16 ** 3])
    row["launches_per_step"] = int(fused_res == (16,))
    row["cells"] = "ray-major"
    scatter_rows.append(row)
    return {"phase": "kernels",
            # cuda_ms of a call that launches nothing: the timer's own reading
            "timer_floor_ms": cuda_ms(lambda: None),
            "inputs": "seeded random: reduce caches and scatter rows normal; "
                      "scatter cells uniform, or ray-major from a seeded ray "
                      "model (ray_major_cells: 2048 rays x (128 + 64) "
                      "samples, R = 16)",
            "launches_per_step": "on the online budget's train step, which "
                                 "the train phases count",
            "reduce_cell_cache_grad": reduce_rows,
            "fused_cache_scatter": scatter_rows}


@contextlib.contextmanager
def record_calls(module, name: str, log: list):
    """Record the arguments of every call of ``module.name`` (which still
    runs) while the block runs."""
    orig = getattr(module, name)

    def rec(*args):
        log.append(args)
        return orig(*args)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


def in_situ(reduce_calls: list, scatter_calls: list) -> dict:
    """Kernel vs plain vs library on the inputs one train step handed each
    kernel; per-step sums over that step's launches."""
    red = [check_reduce(d.contiguous(), R, C, size)
           for d, R, C, size in reduce_calls]
    sca = [check_scatter(list(c), list(u), [int(r) for r in rows])
           for c, u, rows in scatter_calls]
    return {"reduce_cell_cache_grad": red, "fused_cache_scatter": sca}


# ------------------------------------------------------------- train step ---

def reset_counts() -> None:
    """Set the kernels' launch counts and the NOF step loops' graph counts
    (nof/runner.py::graph_counts) to 0."""
    from bundlesdf_tpu_torch.nof import runner
    from bundlesdf_tpu_torch.ops import hashgrid_cuda, reduce_cuda

    reduce_cuda.launches = 0
    hashgrid_cuda.launches = 0
    for k in runner.graph_counts:
        runner.graph_counts[k] = 0


def read_counts() -> dict:
    from bundlesdf_tpu_torch.ops import hashgrid_cuda, reduce_cuda

    return {"reduce_cell_cache_grad": reduce_cuda.launches,
            "fused_cache_scatter": hashgrid_cuda.launches}


def read_graph_counts() -> dict:
    """Since the last reset_counts: CUDA graphs captured, steps replayed,
    warm-up steps (eager, from a restored snapshot), steps run eagerly,
    device ray pools allocated and checkpoints loaded by NofRunners."""
    from bundlesdf_tpu_torch.nof import runner

    return dict(runner.graph_counts)


def check_graph_counts(name: str, graph: dict, counts: dict, n_steps: int,
                       per_step: dict, max_captures: int | None = None) -> None:
    """A phase's NOF steps went through replays: the replays equal the steps
    trained, no step ran eagerly, the captures are at most ``max_captures``
    (by default the ray pools allocated plus the checkpoints loaded by
    NofRunners: each capture follows a new pool or a load, the first the
    first pool), and each kernel launched ``per_step[k]`` times a step run,
    replays and warm-ups (one a capture) alike."""
    bad = []
    if graph["replays"] != n_steps or graph["eager_steps"]:
        bad.append(f"{graph['replays']} replays, {graph['eager_steps']} eager steps "
                   f"for {n_steps} steps")
    if max_captures is None:
        max_captures = graph["ray_pool_allocations"] + graph["loads"]
    if not 0 < graph["captures"] <= max_captures:
        bad.append(f"{graph['captures']} captures (at most {max_captures})")
    if graph["warmup_steps"] != graph["captures"]:
        bad.append(f"{graph['warmup_steps']} warm-ups for {graph['captures']} captures")
    run = n_steps + graph["warmup_steps"]
    for k, n in per_step.items():
        if counts[k] != n * run:
            bad.append(f"{k} launched {counts[k]} != {n} x {run} steps run")
    if bad:
        raise AssertionError(f"{name}: {'; '.join(bad)} ({graph}, {counts})")


def make_step(budget: dict, hash_scatter, device, seed: int = 0, options=None,
              microbatch: int = 0):
    """The online step's pieces from entry.build_nof: (spec, params, step,
    rays, c2w, grid, loop), ``step`` the eager train step and ``loop`` the
    replayed one (nof/runner.py::TrainLoop) over the same parameters and
    optimizer; ``options`` (an ``OPTIONS_*`` dict) sets the hash layout,
    N_importance and eikonal_weight."""
    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_nof_config
    from bundlesdf_tpu_torch.nof import runner

    spec, rcfg, weights, params, rays, c2w, grid = entry.build_nof(
        **budget, hash_scatter=hash_scatter, seed=seed, device=device)
    opt = options or {}
    spec = spec._replace(grid=spec.grid._replace(layout=opt.get("hash_layout",
                                                                spec.grid.layout)))
    rcfg = rcfg._replace(n_importance=opt.get("N_importance", rcfg.n_importance))
    weights = weights._replace(eikonal_weight=opt.get("eikonal_weight",
                                                      weights.eikonal_weight))
    st = runner.TrainStatics(
        spec=spec, rcfg=rcfg, weights=weights, n_rand=budget["n_rand"],
        n_step=500, trunc=0.01, trunc_start=0.01, trunc_decay_type="",
        sc_factor=1.0, microbatch=microbatch)
    opt = runner.make_optimizer(default_nof_config(), params)
    step = runner.make_train_step(st, opt)
    return spec, params, step, rays, c2w, grid, runner.make_train_loop(st, opt)


# Eager steps timed after each train phase's replays, beside them.
EAGER_STEPS = 5


def timed_steps(run, n: int) -> tuple[list, list]:
    """Call ``run(i)`` (one step each) ``n`` times between CUDA events:
    each step's ms and its metrics."""
    import torch

    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    out = []
    events[0].record()
    for i in range(n):
        out.append(run(i))
        events[i + 1].record()
    torch.cuda.synchronize()
    return [events[i].elapsed_time(events[i + 1]) for i in range(n)], out


def run_train(name: str, hash_scatter, n_steps: int, device, options=None):
    """Drive the train loop ``n_steps`` steps, one replay of the captured
    step each (the first call captures it), with the launch and graph counts
    set to 0 just before and read just after; then time EAGER_STEPS eager
    steps on the same inputs, and record one more eager step's kernel
    inputs (outside the counted run) for the in-situ kernel timings.
    Returns the phase's result and what ``profile_phase`` needs to run
    more steps of it."""
    import torch

    from bundlesdf_tpu_torch.ops import hashgrid_cuda, reduce_cuda

    spec, params, step, rays, c2w, grid, loop = make_step(ONLINE, hash_scatter, device,
                                                          options=options)
    gen = torch.Generator(device=device).manual_seed(1)
    n_rays = rays.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    step_ms, ms = timed_steps(
        lambda i: loop(params, i, rays, n_rays, grid, c2w, 1, generator=gen)["loss"],
        n_steps)
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    graph = read_graph_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in torch.stack(ms).cpu()]
    warm = min(3, n_steps - 1)
    steady = step_ms[warm:]
    torch.cuda.reset_peak_memory_stats()
    eager_ms, _ = timed_steps(
        lambda i: loop.eager(params, n_steps + i, rays, n_rays, grid, c2w, 1,
                             generator=gen), EAGER_STEPS)
    eager = eager_ms[1:]
    peak_eager = torch.cuda.max_memory_allocated() / 1e9

    red_calls, sca_calls = [], []
    with record_calls(reduce_cuda, "reduce_cell_cache_grad", red_calls), \
            record_calls(hashgrid_cuda, "fused_cache_scatter", sca_calls):
        loop.eager(params, n_steps + EAGER_STEPS, rays, n_rays, grid, c2w, 1,
                   generator=gen)
    torch.cuda.synchronize()

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    level_R = [p["res"] for p in spec.grid.level_params()]
    out = {
        "phase": name, "hash_layout": spec.grid.layout, "hash_scatter": spec.grid.scatter,
        "hash_reduce": spec.grid.reduce, "big_dtype": spec.grid.big_dtype,
        "options": options or {},
        "level_res": level_R, "steps": n_steps,
        "points_per_step": ONLINE["n_rand"] * (ONLINE["n_samples"] + ONLINE["n_around"]
                                               + (options or {}).get("N_importance", 0)),
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
        "step_ms": sum(steady) / len(steady), "step_ms_min": min(steady),
        "step_ms_max": max(steady), "step_ms_first": step_ms[0],
        "steady_steps": len(steady), "wall_s": wall_s,
        "step_ms_eager": sum(eager) / len(eager), "step_ms_eager_min": min(eager),
        "step_ms_eager_max": max(eager), "eager_steps_timed": len(eager),
        "graph": graph, "graph_pool_gb": loop.graph_pool_bytes / 1e9,
        "steps_run": graph["replays"] + graph["warmup_steps"],
        "peak_mem_gb": peak, "peak_mem_gb_eager_steps": peak_eager,
        "launches": counts,
        "in_situ": in_situ(
            [(a[0], a[1], a[2], a[3]) for a in red_calls],
            [(a[0], a[1], a[2]) for a in sca_calls]),
    }
    # the launches a step: main() and check_options_steps hold them
    check_graph_counts(name, graph, counts, n_steps, {}, max_captures=1)
    return out, (loop, params, rays, n_rays, grid, c2w, gen,
                 n_steps + EAGER_STEPS + 1)


def seg_levels(ctx) -> list:
    """One more eager step of a hash_scatter seg train phase (outside the
    counted run) with its segment-dedup scatters recorded: for each dense
    level, the runs a ray of that step's samples make against the level's
    cap (mean, largest, and whether every ray fit, so that the seg branch
    was the one taken), and the device time (cuda_ms, L2 cold) of the
    scatter as the step runs it (both of JAX's cond branches, one picked by
    torch.where) against its seg branch alone (compaction and the scatter
    of the run sums) and the per-sample scatter alone (the xla path's
    index_add_), each replayed from a CUDA graph as in the step."""
    import torch

    from bundlesdf_tpu_torch.ops import hashgrid

    loop, params, rays, n_rays, grid, c2w, gen, step0 = ctx
    calls = []
    with record_calls(hashgrid, "_seg_cell_scatter", calls):
        loop.eager(params, step0, rays, n_rays, grid, c2w, 1, generator=gen)
    torch.cuda.synchronize()
    out = []
    for cell2d, d_rows2d, n_dest, cap in calls:
        n, S = cell2d.shape
        F = d_rows2d.shape[-1]
        runs = hashgrid._runs(cell2d)[1]

        def seg_branch():
            rows, flat_pos, _, _ = hashgrid._seg_compact(cell2d, d_rows2d, cap)
            cells = cell2d.reshape(-1).index_select(0, flat_pos)
            return hashgrid._cell_cache_scatter(cells, rows, n_dest)

        out.append({
            "R": round(n_dest ** (1 / 3)), "dtype": str(d_rows2d.dtype).split(".")[-1],
            "n_rays": n, "S": S, "cap": cap, "both_branches": cap < S,
            "runs_per_ray_mean": float(runs.double().mean()),
            "runs_per_ray_max": int(runs.max()), "fits": int(runs.max()) <= cap,
            "scatter_ms": cuda_ms(graphed(lambda: hashgrid._seg_cell_scatter(
                cell2d, d_rows2d, n_dest, cap))),
            "seg_branch_ms": cuda_ms(graphed(seg_branch)),
            "direct_ms": cuda_ms(graphed(lambda: hashgrid._cell_cache_scatter(
                cell2d.reshape(-1), d_rows2d.reshape(-1, F), n_dest)))})
    return out


def device_rows(prof, n: int, name: str, out_dir: str, per: str):
    """Device time by kernel over ``n`` profiled steps or frames: rows of
    {name, device_ms_per_<per>, calls_per_<per>}, largest first, and their
    sum.  The full table goes to <out_dir>/profile_<name>.txt."""
    ka = prof.key_averages()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    rows = []
    for e in ka:
        # device-side events only (kernels, memcpy, memset): an aten op's
        # row, and a user annotation's, repeat the time of the kernels
        # they launched
        if "CUDA" not in str(e.device_type) or e.is_user_annotation:
            continue
        self_us = getattr(e, "self_device_time_total", None)
        if self_us is None:
            self_us = e.self_cuda_time_total
        rows.append({"name": e.key[:80], f"device_ms_per_{per}": self_us / (n * 1e3),
                     f"calls_per_{per}": e.count / n})
    rows.sort(key=lambda r: -r[f"device_ms_per_{per}"])
    return rows, sum(r[f"device_ms_per_{per}"] for r in rows)


def profile_phase(name: str, ctx, step_ms: float, out_dir: str) -> dict:
    """torch.profiler over 3 more replayed steps of a train phase: device time by
    kernel name (the table goes to <out_dir>/profile_<name>.txt) and the
    device's idle share of the phase's timed ``step_ms``.  Runs after every
    timed phase: a profiler session leaves the host slower afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    loop, params, rays, n_rays, grid, c2w, gen, step0 = ctx
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3):
            loop(params, step0 + i, rays, n_rays, grid, c2w, 1, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    rows, total = device_rows(prof, 3, name, out_dir, "step")
    # each launch of the port's kernels, in launch order, to hold the
    # in-situ CUDA-event times against
    ours = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if "CUDA" not in str(e.device_type):
            continue
        for k in ("reduce_cell_cache_grad_kernel", "fused_cache_scatter_kernel"):
            if k in e.name:
                ours.setdefault(k, []).append(e.time_range.elapsed_us())
    return {"phase": f"profile_{name}", "device_ms_per_step": total,
            "kernel_launch_us": ours,
            "device_kernels_per_step": sum(r["calls_per_step"] for r in rows),
            "timed_step_ms": step_ms,
            "device_idle_share": 1.0 - total / step_ms,
            "profiled_wall_ms_per_step": wall_ms,
            "top": rows[:25]}


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in f64 (0 when both are 0)."""
    a, b = a.double(), b.double()
    d = float((a - b).norm())
    return d / float(b.norm()) if d else 0.0


# small_parity's gradient bounds (relative L2, card against CPU, per step):
# f32 sums in another order (matmuls, atomics, index_add_) ...
GRAD_RTOL_F32 = 1e-4
# ... and the bf16-staged levels, whose cache gradient is summed in bf16
# (unit roundoff 2^-8 = 3.9e-3) in atomic order on the card, in row order on
# the CPU
GRAD_RTOL_BF16 = 1e-2
# nof_options_small_parity's bound for the f32 leaves.  The eikonal term
# differentiates the normals, and the encode's coordinate derivative jumps
# across every hash-grid cell face (a piecewise-trilinear field), as the
# MLP's does at each ReLU kink: a sample whose position lands within f32
# rounding of a face on one device and not on the other (the card's
# einsums round the render's points differently) moves the gradients by a
# finite amount.  Measured on the H100 by this phase (PERF.md §6): 3.5e-4
# relative L2 on a table level and 2.8e-4 on the pose array in one of 3
# rounds, 1.3e-5 at most in the others.
GRAD_RTOL_EIKONAL = 1e-3


# small_parity's cases: hash_scatter and each kernel's launches in its 3
# steps (budget: 4 levels 16 -> 128, R = 64 and 128 bf16-staged, R = 16 in
# the fused scatter)
SMALL_PARITY_CASES = (("pallas", {"reduce_cell_cache_grad": 6, "fused_cache_scatter": 3}),
                      ("seg", {"reduce_cell_cache_grad": 6, "fused_cache_scatter": 0}))


def phase_small_parity(device) -> dict:
    """The train step on the card (kernels) against the same step on the CPU
    (plain versions) at a small budget with bf16 levels: both kernels on the
    path (hash_scatter: pallas), then the segment-dedup scatter
    (hash_scatter: seg, the reduce on its path).  The card trains 3 steps;
    before each, the CPU takes the card's parameters, then both run the
    step on the same batch and jitter, and the loss and the gradient of
    every leaf (the table level by level) are held against each other.

    The parameters are not compared after free-running steps: Adam (eps
    1e-15) scales each update by the root of its second moment, so a weight
    whose gradients were near rounding noise moves by up to the learning
    rate on rounding alone, and the MLP weights of two free-running
    trajectories drift apart by an amount that varies from run to run."""
    res, failures = None, []
    for hash_scatter, launches in SMALL_PARITY_CASES:
        row, bad = small_parity_case(device, hash_scatter, launches)
        failures += [f"{hash_scatter}: {f}" for f in bad]
        if res is None:
            res = row
        else:
            res[hash_scatter] = row
    if failures:
        raise AssertionError(f"small_parity: {failures}; {json.dumps(res)}")
    return res


def small_parity_case(device, hash_scatter: str, launches: dict):
    """One case of phase_small_parity: (its result, its failures)."""
    import torch

    from bundlesdf_tpu_torch.nof import render as nof_render
    from bundlesdf_tpu_torch.nof.runner import param_leaves
    from bundlesdf_tpu_torch.ops import hashgrid

    budget = dict(n_rand=256, n_samples=32, n_around=16, num_levels=4,
                  finest_res=128, log2_hashmap=22, n_march=64, num_frames=4,
                  occ_res=32)
    spec_g, params_g, step_g, rays_g, c2w_g, grid_g, _ = make_step(
        budget, hash_scatter, device)
    spec_c, params_c, step_c, rays_c, c2w_c, grid_c, _ = make_step(
        budget, hash_scatter, "cpu")
    grid_spec = spec_g.grid
    C = grid_spec.level_dim
    levels = [(f"table/L{li}_R{p['res']}_"
               + ("hashed" if not p["dense"]
                  else str(hashgrid._lvl_dtype(grid_spec, p)).split(".")[-1]),
               slice(p["offset"] * C, (p["offset"] + p["size"]) * C),
               p["dense"] and hashgrid._lvl_dtype(grid_spec, p) == torch.bfloat16)
              for li, p in enumerate(grid_spec.level_params())]

    def leaves(params):
        """Every parameter but the table (compared level by level), by name."""
        out = {}
        for k, v in params.items():
            if k == "table":
                continue
            for j, t in (v.items() if isinstance(v, dict) else [(None, v)]):
                out[k if j is None else k + "/" + j] = t
        return out

    gen = torch.Generator().manual_seed(2)
    n = budget["n_rand"]
    reset_counts()
    losses, grad_err, failures = [], [], []
    for i in range(3):
        with torch.no_grad():  # the CPU starts the step from the card's weights
            for pg, pc in zip(param_leaves(params_g), param_leaves(params_c)):
                pc.copy_(pg.cpu())
        idx = torch.randint(0, n, (n,), generator=gen)
        draws = nof_render.SampleDraws(
            torch.rand((n, budget["n_samples"]), generator=gen),
            torch.rand((n, budget["n_around"]), generator=gen),
            torch.rand((n, budget["n_around"]), generator=gen))
        mg = step_g(params_g, i, rays_g, n, grid_g, c2w_g,
                    batch_idx=idx.to(device),
                    draws=draws.to(device))
        mc = step_c(params_c, i, rays_c, n, grid_c, c2w_c, batch_idx=idx,
                    draws=draws)
        lg, lc = float(mg["loss"]), float(mc["loss"])
        losses.append((lg, lc))
        # equal weights: f32 reduction order only
        if not abs(lg - lc) <= 1e-4 * abs(lc):
            failures.append(f"step {i} loss: gpu {lg} cpu {lc}")
        errs = {}
        tg, tc = params_g["table"].grad.cpu(), params_c["table"].grad
        for name, sl, bf16 in levels:
            errs[name] = rel_l2(tg[sl], tc[sl])
            if not errs[name] <= (GRAD_RTOL_BF16 if bf16 else GRAD_RTOL_F32):
                failures.append(f"step {i} {name} gradient: rel L2 {errs[name]}")
        on_cpu = leaves(params_c)
        for name, p in leaves(params_g).items():
            errs[name] = rel_l2(p.grad.cpu(), on_cpu[name].grad)
            if not errs[name] <= GRAD_RTOL_F32:
                failures.append(f"step {i} {name} gradient: rel L2 {errs[name]}")
        grad_err.append(errs)
    counts = read_counts()
    if counts != launches:
        failures.append(f"kernels not on the path: {counts} != {launches}")
    res = {"phase": "small_parity", "hash_scatter": grid_spec.scatter, "budget": budget,
           "losses_gpu_cpu": losses,
           "grad_rel_l2_bounds": {"f32": GRAD_RTOL_F32, "bf16": GRAD_RTOL_BF16},
           "grad_rel_l2_max": {k: max(e[k] for e in grad_err) for k in grad_err[0]},
           "launches": counts}
    return res, failures


def sphere_runners(device, over: dict):
    """run_global_nerf's NofRunner on the sphere of
    global_refine_small_parity under REFINE_SMALL merged with ``over``, on
    the CPU and on the card, built by one training step each (the same
    shared draws); the card's runner then takes the CPU's weights."""
    import torch

    from bundlesdf_tpu_torch.config import default_nof_config, default_track_config
    from bundlesdf_tpu_torch.nof.runner import param_leaves
    from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

    data, frames = sphere_frames()
    cfg = default_nof_config().merged({**REFINE_SMALL, "n_step": 1, **over})
    out = []
    for dev in ("cpu", device):
        pipe = BundleSdf(cfg_track=default_track_config(), use_nof=False, device=dev,
                         nof_draws=shared_nof_draws(cfg["N_rand"], cfg["N_samples"],
                                                    cfg["N_samples_around_depth"]))
        pipe.K = data["K"]
        pipe.run_global_nerf(frames, cfg_refine=cfg)
        out.append(pipe.global_nof)
    cpu, gpu = out
    with torch.no_grad():
        for pg, pc in zip(param_leaves(gpu.params), param_leaves(cpu.params)):
            pg.copy_(pc.to(pg.device))
    return cpu, gpu


# nof_options_small_parity: the most rays a round may lose to samples that
# lie in another hash-grid cell on the card than on the CPU.
FACE_DROP_MAX = 0.01


def sample_cells(nof, batch, draws, step: int):
    """(rays, samples, levels + 1) int: for every sample of the render of
    ``batch`` (the loss function's, without the graph) the cell each level's
    encode puts it in, and whether it lies inside the unit cube."""
    import torch

    from bundlesdf_tpu_torch.nof import losses as nof_losses
    from bundlesdf_tpu_torch.nof import render as nof_render
    from bundlesdf_tpu_torch.ops import hashgrid

    st = nof.statics
    trunc = nof_losses.truncation_value(step, st.n_step, st.trunc, st.trunc_start,
                                        st.sc_factor, st.trunc_decay_type)
    with torch.no_grad():
        pts = nof_render.render_rays(nof.params, st.spec, st.rcfg, nof.occ_grid, batch,
                                     nof.c2w_dev, trunc, draws)["pts"]
    flat = pts.reshape(-1, 3)
    axes = hashgrid._axes01(flat)
    keys = [torch.all(torch.abs(flat) <= 1.0, dim=-1).to(torch.int64)]
    for p in st.spec.grid.level_params():
        pgs = hashgrid._level_fracs(axes, p)[0]
        keys.append(hashgrid._cell_of([g.to(torch.int64) for g in pgs], p["res"] + 1))
    return torch.stack(keys, -1).reshape(pts.shape[0], pts.shape[1], -1).cpu()


def phase_nof_options_small_parity(device) -> dict:
    """The NOF options on the card against the CPU: the sphere and
    REFINE_SMALL of global_refine_small_parity with three levels 16 -> 64
    (R = 64 bf16-staged, the reduce kernel's; R = 16 on the fused scatter),
    N_importance 16 and eikonal_weight 0.1, (a) under the exact hash layout
    and (b) under the cell layout.  For each, 3 rounds: the CPU takes the
    card's weights, both compute the loss function's loss and gradients on
    the same batch and draws (the importance uniforms included), the card's
    optimizer steps.  The loss within 1e-4 relative, every gradient within
    small_parity's bounds (table level by level) but for the f32 leaves'
    GRAD_RTOL_EIKONAL.  Weights after Adam are not compared
    (phase_small_parity).

    The eikonal term's gradient jumps at every hash-grid cell face: a sample
    that the card's render puts on the other side of a face than the CPU's
    moves the gradients by a finite amount.  So each round first renders the
    batch on both devices and finds, for every sample and level, the cell
    of its position (``sample_cells``); the rays with any sample in a
    different cell (or on a different side of the cube's boundary) are
    dropped from both computations, and the rest are held to the bounds.
    The rays dropped are reported; more than FACE_DROP_MAX of a round's
    fails the phase."""
    import torch

    from bundlesdf_tpu_torch.nof import render as nof_render
    from bundlesdf_tpu_torch.nof import runner
    from bundlesdf_tpu_torch.ops import hashgrid

    over = {"num_levels": 3, "finest_res": 64, "log2_hashmap_size": 19,
            "hash_big_dtype": "bfloat16", "hash_scatter": "pallas",
            "N_importance": 16, "eikonal_weight": 0.1}
    res = {"phase": "nof_options_small_parity",
           "config": "REFINE_SMALL on the 4-view 32 x 32 sphere with " + json.dumps(over),
           "grad_rel_l2_bounds": {"f32": GRAD_RTOL_EIKONAL, "bf16": GRAD_RTOL_BF16},
           "face_drop_max": FACE_DROP_MAX}
    failures = []
    for layout in ("exact", "cell"):
        reset_counts()
        cpu, gpu = sphere_runners(device, {**over, "hash_layout": layout})
        st = gpu.statics
        if st.spec.grid.layout != layout or st.microbatch:
            raise AssertionError(f"nof_options_small_parity: statics {st}")
        loss_fn = runner.make_loss_fn(st)
        grid_spec = st.spec.grid
        C = grid_spec.level_dim
        gen = torch.Generator().manual_seed(3)
        n, rc = st.n_rand, st.rcfg
        losses, errs_max, dropped = [], {}, []
        for i in range(3):
            with torch.no_grad():
                for pg, pc in zip(runner.param_leaves(gpu.params),
                                  runner.param_leaves(cpu.params)):
                    pc.copy_(pg.cpu())
            idx = torch.randint(0, cpu.n_rays, (n,), generator=gen)
            draws = nof_render.SampleDraws(*(torch.rand((n, k), generator=gen) for k in (
                rc.n_samples, rc.n_samples_around_depth, rc.n_samples_around_depth,
                rc.n_importance)))
            same = torch.all((sample_cells(gpu, gpu.rays_dev[idx.to(device)], draws.to(device), i)
                              == sample_cells(cpu, cpu.rays_dev[idx], draws, i)).reshape(n, -1),
                             dim=1)
            dropped.append(int(n - same.sum()))
            if dropped[-1] > FACE_DROP_MAX * n:
                failures.append(f"{layout} step {i}: {dropped[-1]} of {n} rays have samples "
                                "in other cells on the card")
            idx, draws = idx[same], draws.rows(same)
            ms = []
            for nof, dev in ((gpu, device), (cpu, "cpu")):
                nof.optimizer.zero_grad()
                loss, m = loss_fn(nof.params, nof.rays_dev[idx.to(dev)], nof.occ_grid,
                                  nof.c2w_dev, i,
                                  draws.to(dev))
                loss.backward()
                ms.append({k: float(v.detach()) for k, v in m.items()})
            lg, lc = ms[0]["loss"], ms[1]["loss"]
            losses.append({"gpu": ms[0], "cpu": ms[1]})
            if not abs(lg - lc) <= 1e-4 * abs(lc) or not ms[1]["eikonal_loss"] > 0:
                failures.append(f"{layout} step {i} loss: gpu {ms[0]} cpu {ms[1]}")
            tg, tc = gpu.params["table"].grad.cpu(), cpu.params["table"].grad
            for li, p in enumerate(grid_spec.level_params()):
                bf16 = p["dense"] and hashgrid._lvl_dtype(grid_spec, p) == torch.bfloat16
                sl = slice(p["offset"] * C, (p["offset"] + p["size"]) * C)
                name = f"table/L{li}_R{p['res']}" + ("_bf16" if bf16 else "")
                e = rel_l2(tg[sl], tc[sl])
                errs_max[name] = max(errs_max.get(name, 0.0), e)
                if not e <= (GRAD_RTOL_BF16 if bf16 and layout == "cell" else GRAD_RTOL_EIKONAL):
                    failures.append(f"{layout} step {i} {name} gradient: rel L2 {e}")
            for (name, pg), pc in zip(_named_leaves(gpu.params), runner.param_leaves(cpu.params)):
                if name == "table":
                    continue
                e = rel_l2(pg.grad.cpu(), pc.grad)
                errs_max[name] = max(errs_max.get(name, 0.0), e)
                if not e <= GRAD_RTOL_EIKONAL:
                    failures.append(f"{layout} step {i} {name} gradient: rel L2 {e}")
            gpu.optimizer.step()
        res[layout] = {"losses": losses, "grad_rel_l2_max": errs_max,
                       "rays_dropped": dropped, "rays_per_round": n,
                       "launches": read_counts()}
    if res["cell"]["launches"]["reduce_cell_cache_grad"] == 0:
        failures.append(f"the reduce kernel not on the cell path: {res['cell']['launches']}")
    if any(res["exact"]["launches"].values()):
        failures.append(f"kernels on the exact path: {res['exact']['launches']}")
    emit(res)
    if failures:
        raise AssertionError(f"nof_options_small_parity: {failures}")
    return res


def _named_leaves(tree, prefix=""):
    """(name, tensor) of a nested parameter dict in ``param_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def check_options_steps(exact: dict, opts: dict) -> None:
    """The options' train phases: losses fall; no kernel on the exact path;
    the reduce launched OPTIONS_ENCODE_BACKWARDS times per step per bf16
    level on the options path."""
    for r in (exact, opts):
        if not r["loss_last"] < r["loss_first"]:
            raise AssertionError(f"{r['phase']}: loss did not fall: "
                                 f"{r['loss_first']} -> {r['loss_last']}")
    if any(exact["launches"].values()):
        raise AssertionError(f"nof_train_step_exact launched kernels: {exact['launches']}")
    n_bf16 = sum(1 for R in opts["level_res"] if R ** 3 >= 1 << 18)
    want = OPTIONS_ENCODE_BACKWARDS * n_bf16 * opts["steps_run"]
    opts["reduce_launches_predicted"] = want
    if opts["launches"]["reduce_cell_cache_grad"] != want:
        raise AssertionError(f"nof_train_step_options: reduce launches "
                             f"{opts['launches']} != {want}")


# ------------------------------------------------------ replayed step ---

# The offline budget of run_global_nerf (2048 rays x (64 + 256) samples, 16
# levels 16 -> 256, log2 table 22) for entry.build_nof, microbatched as the
# runner picks it (runner._pick_microbatch: 8 chunks of 256 rays).
OFFLINE = dict(n_rand=2048, n_samples=64, n_around=256, num_levels=16, finest_res=256,
               log2_hashmap=22, n_march=256, num_frames=16, occ_res=64)
# nof_train_graph_parity's steps: (name, budget, hash_scatter, options,
# microbatch)
GRAPH_PARITY_CASES = (("online", ONLINE, None, None, 0),
                      ("pallas_scatter", ONLINE, "pallas", None, 0),
                      ("options", ONLINE, None, OPTIONS_RESAMPLE_EIKONAL, 0),
                      ("offline_microbatched", OFFLINE, None, None, 256),
                      ("seg", ONLINE, "seg", None, 0),
                      ("offline_seg", OFFLINE, "seg", None, 256))
GRAPH_REFINE_STEPS = 4
# steady replays timed after the offline cases' parity (CUDA events)
GRAPH_TIMED_REPLAYS = 3
# seg against xla from one snapshot and one set of draws: the bf16-staged
# levels' table gradient within this share of its largest entry (the JAX
# tests' bound for bf16 staging, tests/test_hashgrid.py:450)
SEG_BF16_MAX_REL = 2.5 / 256


def table_levels(grid_spec) -> list:
    """(name, slice of the flat table, bf16-staged) of every level."""
    import torch

    from bundlesdf_tpu_torch.ops import hashgrid

    C = grid_spec.level_dim
    return [(f"table/L{li}_R{p['res']}", slice(p["offset"] * C, (p["offset"] + p["size"]) * C),
             p["dense"] and hashgrid._lvl_dtype(grid_spec, p) == torch.bfloat16)
            for li, p in enumerate(grid_spec.level_params())]


def graph_step_parity(name, budget, hash_scatter, options, microbatch, device) -> dict:
    """One step from one snapshot (parameters, Adam's moments and count) on
    one set of draws, eager and then replayed (a fresh loop's first call
    captures the step).  Under torch's deterministic algorithms (the
    bf16-staged levels' ``index_add_`` then sums in a fixed order, so only
    the capture could tell the two apart): the loss within 1e-4 relative
    and every gradient within small_parity's bounds (the table level by
    level).  Under the default algorithms, the main path's: the replay's
    gradients against the eager step's, reported beside two eager steps
    against each other (the atomics' own spread, which in the bf16 levels
    exceeds small_parity's bf16 bound), and the launches a replay adds
    equal to the eager step's (the replay's call also runs the capture's
    warm-up step)."""
    import torch

    from bundlesdf_tpu_torch.nof import runner
    from bundlesdf_tpu_torch.nof.render import SampleDraws

    spec, params, _, rays, c2w, grid, loop = make_step(
        budget, hash_scatter, device, options=options, microbatch=microbatch)
    st = loop.st
    n, rc = st.n_rand, st.rcfg
    gen = torch.Generator().manual_seed(4)
    idx = torch.randint(0, rays.shape[0], (n,), generator=gen)
    draws = SampleDraws(*(torch.rand((n, k), generator=gen) for k in (
        rc.n_samples, rc.n_samples_around_depth, rc.n_samples_around_depth,
        rc.n_importance) if k))

    snap = [t.detach().clone() for t in loop._state()]

    def one(run):
        with torch.no_grad():
            torch._foreach_copy_(loop._state(), snap)
        reset_counts()
        m = run(params, 0, rays, rays.shape[0], grid, c2w, 1,
                draws=lambda s, nr: (idx, draws))
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in m.items()},
                {k: p.grad.detach().clone() for k, p in _named_leaves(params)},
                read_counts(), read_graph_counts())

    def grad_errs(a, b):
        errs = {lname: rel_l2(a["table"][sl], b["table"][sl])
                for lname, sl, _ in table_levels(spec.grid)}
        errs.update({k: rel_l2(a[k], b[k]) for k in a if k != "table"})
        return errs

    seg = None
    with deterministic_algorithms():
        det = runner.TrainLoop(st, loop.optimizer)
        (me, ge, _, _), (mr, gr, _, _) = one(det.eager), one(det)
        if spec.grid.scatter == "seg":
            xla = runner.TrainLoop(st._replace(spec=st.spec._replace(
                grid=st.spec.grid._replace(scatter="xla"))), loop.optimizer)
            mx, gx, _, _ = one(xla.eager)
            seg = seg_against_xla(spec.grid, (me, ge), (mx, gx))
    del det
    failures = [] if seg is None else list(seg.pop("failures"))
    if not abs(mr["loss"] - me["loss"]) <= 1e-4 * abs(me["loss"]):
        failures.append(f"loss: replay {mr['loss']} eager {me['loss']}")
    if mr["valid_rays"] != me["valid_rays"]:
        failures.append(f"valid rays: replay {mr['valid_rays']} eager {me['valid_rays']}")
    errs = grad_errs(gr, ge)
    bf16 = {lname for lname, _, b in table_levels(spec.grid) if b}
    for k, e in errs.items():
        if not e <= (GRAD_RTOL_BF16 if k in bf16 else GRAD_RTOL_F32):
            failures.append(f"{k} gradient: rel L2 {e}")

    (m1, g1, ce, _), (_, g2, _, _), (m3, g3, cr, graph) = (
        one(loop.eager), one(loop.eager), one(loop))
    run = graph["replays"] + graph["warmup_steps"]
    if (any(cr[k] != ce[k] * run for k in ce) or graph["captures"] != 1
            or graph["replays"] != 1):
        failures.append(f"launches: replay call {cr} eager step {ce}; {graph}")
    row = {"case": name, "budget": budget, "hash_scatter": spec.grid.scatter,
           "options": options or {}, "microbatch": microbatch,
           "deterministic": {"loss_eager_replay": [me["loss"], mr["loss"]],
                             "grad_rel_l2": errs},
           "default": {"loss_eager_replay": [m1["loss"], m3["loss"]],
                       "grad_rel_l2_replay_eager": grad_errs(g3, g1),
                       "grad_rel_l2_eager_eager": grad_errs(g2, g1)},
           "launches_eager": ce, "launches_replay_call": cr,
           "graph": graph, "graph_pool_gb": loop.graph_pool_bytes / 1e9,
           "failures": failures}
    if seg is not None:
        row["seg_against_xla"] = seg
    if microbatch:
        # steady replays of the captured offline step, then one eager step
        # under seg with its two-stage gathers recorded
        torch.cuda.reset_peak_memory_stats()
        ms, _ = timed_steps(lambda i: loop(params, 1 + i, rays, rays.shape[0], grid, c2w, 1,
                                           draws=lambda s, nr: (idx, draws)),
                            GRAPH_TIMED_REPLAYS)
        row["replayed_step_ms"] = ms
        row["peak_mem_gb_replays"] = torch.cuda.max_memory_allocated() / 1e9
        if spec.grid.scatter == "seg":
            row["two_stage_gather"] = two_stage_gather_times(loop, params, rays, grid, c2w,
                                                             idx, draws)
    return row, (params, rays, grid, c2w, loop)


def seg_against_xla(grid_spec, seg_step, xla_step) -> dict:
    """One step under hash_scatter seg against the same step under xla from
    one snapshot and one set of draws (both eager, deterministic
    algorithms): the loss bitwise (the forward's rows are bitwise equal),
    the f32 leaves and levels within GRAD_RTOL_F32 relative L2, the
    bf16-staged levels within SEG_BF16_MAX_REL of their largest entry."""
    (ms, gs), (mx, gx) = seg_step, xla_step
    out = {"loss_seg_xla": [ms["loss"], mx["loss"]], "grad_rel_l2": {},
           "bf16_max_rel": {}, "failures": []}
    if ms["loss"] != mx["loss"]:
        out["failures"].append(f"seg loss {ms['loss']} != xla loss {mx['loss']}")
    for lname, sl, bf16 in table_levels(grid_spec):
        a, b = gs["table"][sl], gx["table"][sl]
        out["grad_rel_l2"][lname] = e = rel_l2(a, b)
        if bf16:
            out["bf16_max_rel"][lname] = m = max_err(a, b) / max(float(b.abs().max()), 1e-30)
            if not m <= SEG_BF16_MAX_REL:
                out["failures"].append(f"seg {lname} gradient: {m} of its largest")
        elif not e <= GRAD_RTOL_F32:
            out["failures"].append(f"seg {lname} gradient: rel L2 {e}")
    for k in gs:
        if k != "table":
            out["grad_rel_l2"][k] = e = rel_l2(gs[k], gx[k])
            if not e <= GRAD_RTOL_F32:
                out["failures"].append(f"seg {k} gradient: rel L2 {e}")
    return out


def two_stage_gather_times(loop, params, rays, grid, c2w, idx, draws) -> dict:
    """The offline seg step's two-stage run gathers (R = 148): one eager
    step's first call of hashgrid._cell_rows_seg recorded, then its device
    time (cuda_ms, L2 cold, replayed from a CUDA graph as in the step)
    against the direct gather of the same cache rows (hashgrid._cell_rows),
    the rows held bitwise equal."""
    import torch

    from bundlesdf_tpu_torch.ops import hashgrid

    calls = []
    with record_calls(hashgrid, "_cell_rows_seg", calls):
        loop.eager(params, 0, rays, rays.shape[0], grid, c2w, 1,
                   draws=lambda s, nr: (idx, draws))
    torch.cuda.synchronize()
    n_calls = len(calls)
    axes, cache, p, C, n_rays, n_pts = calls[0]
    calls.clear()
    two = hashgrid._cell_rows_seg(axes, cache, p, C, n_rays, n_pts)[0]
    if not torch.equal(two, hashgrid._cell_rows(axes, cache, p, C)[0]):
        raise AssertionError(f"two-stage gather R={p['res']}: rows differ from the direct gather")
    S = n_pts // n_rays
    _, n_runs, _ = hashgrid._runs(hashgrid._cell_of(hashgrid._level_fracs(axes, p)[0],
                                                    p["res"]).view(n_rays, S))
    return {"R": p["res"], "calls_per_step": n_calls, "n_rays": n_rays, "S": S,
            "cap": hashgrid._seg_cap(p["res"], S),
            "runs_per_ray_mean": float(n_runs.double().mean()),
            "runs_per_ray_max": int(n_runs.max()),
            "two_stage_ms": cuda_ms(graphed(lambda: hashgrid._cell_rows_seg(
                axes, cache, p, C, n_rays, n_pts))),
            "direct_ms": cuda_ms(graphed(lambda: hashgrid._cell_rows(axes, cache, p, C)))}


def graph_batches(device, ctx) -> dict:
    """On the online case's loop, drawing from a generator on the card: the
    eager step and the first replay from one generator state draw the same
    batch, and two consecutive replays draw different ones."""
    import torch

    params, rays, grid, c2w, loop = ctx
    gen = torch.Generator(device=device).manual_seed(9)
    state = gen.get_state()
    loop.eager(params, 1, rays, rays.shape[0], grid, c2w, 1, generator=gen)
    eager = loop.batch_idx.clone()
    gen.set_state(state)
    batches = []
    for i in range(2):
        loop(params, 1 + i, rays, rays.shape[0], grid, c2w, 1, generator=gen)
        batches.append(loop.batch_idx.clone())
    after = gen.get_state()
    return {"eager_equals_first_replay": bool(torch.equal(eager, batches[0])),
            "replays_differ": not torch.equal(batches[0], batches[1]),
            "rows_shared_by_replays": int(torch.isin(batches[0], batches[1]).sum()),
            "generator_advanced": not torch.equal(state, after),
            "captures": loop.captures, "replays": loop.replays}


def graph_recaptures(device, tmp: str) -> dict:
    """run_global_nerf's runner on the sphere (REFINE_SMALL) on the card:
    train, double its ray pool past its capacity (a new pool: one more
    capture) and train on, save a full checkpoint after those replays and
    resume it (the resumed runner's next batch equals the runner's: the
    generator's state kept its replays), then load_weights (in place: no
    capture) and train on.  Every loss finite, replays equal the steps."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch.config import default_nof_config, default_track_config
    from bundlesdf_tpu_torch.nof.runner import NofRunner
    from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

    data, frames = sphere_frames()
    cfg = default_nof_config().merged({**REFINE_SMALL, "n_step": 2})
    pipe = BundleSdf(cfg_track=default_track_config(), use_nof=False, device=device)
    pipe.K = data["K"]
    pipe.run_global_nerf(frames, cfg_refine=cfg)
    nof = pipe.global_nof
    out, losses = {"start": nof.graph_stats()}, []
    losses.append(nof.train(GRAPH_REFINE_STEPS)["loss"])
    cap = nof.rays_dev.shape[0]
    while len(nof.rays_np) <= cap:
        nof.rays_np = np.concatenate([nof.rays_np, nof.rays_np])
    nof._upload_rays()
    out["pool_rows"] = [cap, int(nof.rays_dev.shape[0])]
    losses.append(nof.train(GRAPH_REFINE_STEPS)["loss"])
    out["doubled"] = nof.graph_stats()
    ckpt = os.path.join(tmp, "graph_full.pth")
    nof.save_weights(ckpt, full=True)
    resumed = NofRunner.from_checkpoint(nof.cfg, ckpt, device=device)
    nof.train(1)
    resumed.train(1)
    out["resumed_same_batch"] = bool(torch.equal(nof._train_many.batch_idx,
                                                 resumed._train_many.batch_idx))
    nof.load_weights(ckpt)
    losses.append(nof.train(GRAPH_REFINE_STEPS)["loss"])
    out["loaded"] = nof.graph_stats()
    out["losses"] = losses
    return out


def phase_nof_train_graph_parity(device) -> dict:
    """The replayed train step (nof/runner.py::TrainLoop, one CUDA graph
    replay a step) against the eager step on the card: GRAPH_PARITY_CASES
    (the online budget, the fused scatter under hash_scatter pallas, the
    options N_importance 64 and eikonal 0.1, the offline budget's 8
    microbatches, and hash_scatter seg at both budgets, held to xla too)
    each from one snapshot and one set of draws, held to small_parity's
    bounds under deterministic algorithms (graph_step_parity); the
    generator's draws under replay
    (graph_batches); a capture again after a ray-pool doubling and none
    after load_weights, training on (graph_recaptures)."""
    res = {"phase": "nof_train_graph_parity",
           "grad_rel_l2_bounds": {"f32": GRAD_RTOL_F32, "bf16": GRAD_RTOL_BF16},
           "cases": []}
    failures, ctx = [], None
    for case in GRAPH_PARITY_CASES:
        row, c = graph_step_parity(*case, device)
        res["cases"].append(row)
        failures += [f"{row['case']}: {f}" for f in row["failures"]]
        if ctx is None:
            ctx = c
    res["batches"] = b = graph_batches(device, ctx)
    if not (b["eager_equals_first_replay"] and b["replays_differ"]
            and b["generator_advanced"]):
        failures.append(f"batches: {b}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        res["recaptures"] = r = graph_recaptures(device, tmp)
    s0, s1, s2 = r["start"], r["doubled"], r["loaded"]
    if not (s1["captures"] == s0["captures"] + 1 == s2["captures"]
            and s1["ray_pool_allocations"] == s0["ray_pool_allocations"] + 1
            and s2["loads"] == s0["loads"] + 1 and s2["eager_steps"] == 0
            and s2["replays"] == s0["replays"] + 3 * GRAPH_REFINE_STEPS + 1
            and all(math.isfinite(v) for v in r["losses"]) and r["resumed_same_batch"]):
        failures.append(f"recaptures: {r}")
    emit(res)
    if failures:
        raise AssertionError(f"nof_train_graph_parity: {failures}")
    return res


# --------------------------------------------------------------- tracking ---

def _tests_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def small_track_cfg():
    """tests/test_pipeline.py::small_track_cfg, built on the port's config."""
    from bundlesdf_tpu_torch.config import default_track_config

    cfg = default_track_config()
    cfg["feature_corres"]["resize"] = 160
    cfg["feature_corres"]["max_matches_per_pair"] = 256
    cfg["ransac"]["max_iter"] = 512
    cfg["bundle"]["max_BA_frames"] = 5
    cfg["bundle"]["image_downscale"] = 4
    cfg["depth_processing"]["percentile"] = 100
    return cfg


def cpu_draws(seed: int, shape: tuple):
    """RANSAC draws that do not depend on the device: a CPU generator seeded
    with the frame id (the tracker moves them to its device)."""
    import torch

    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def synth_poses(n_frames: int, deg_step: float, wobble: float) -> list:
    """Object-in-camera poses of scripts/make_synth_video.py:13-24, the
    translation wobble scaled by ``wobble``."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    axis = np.array([0, 1, 0.2]) / np.linalg.norm([0, 1, 0.2])
    base = Rotation.from_euler("xyz", [20, 30, 10], degrees=True).as_matrix()
    poses = []
    for k in range(n_frames):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(axis * np.deg2rad(deg_step * k)).as_matrix() @ base
        T[:3, 3] = [wobble * 0.02 * np.sin(k * 0.4), wobble * 0.015 * np.cos(k * 0.3),
                    0.55 + wobble * 0.01 * np.sin(k * 0.2)]
        poses.append(T)
    return poses


def model_origin_steps(tracker, wobble: float) -> list:
    """Ground-truth distance (m) the tracker's model origin (the first
    frame's visible-surface centroid) moves in the camera between
    neighbouring frames, at a given wobble: what the post-BA neighbour gate
    (ransac.max_trans_neighbor) holds the estimate to, so a step past the
    gate FAILs a frame whose pose is right."""
    import numpy as np

    # frame 0's pose is the recentering alone: the origin is at -t in cam 0
    centre_cam0 = -tracker.bundler.firstframe.pose_in_model[:3, 3]
    c_obj = np.linalg.inv(synth_poses(1, TRACK_DEG, TRACK_WOBBLE)[0]) @ np.r_[centre_cam0, 1]
    pos = np.stack([(T @ c_obj)[:3] for T in synth_poses(TRACK_FRAMES, TRACK_DEG, wobble)])
    return np.linalg.norm(np.diff(pos, axis=0), axis=1).tolist()


def synth_video(n_frames: int, H: int, W: int, deg_step: float, f: float = 600.0,
                wobble: float = TRACK_WOBBLE) -> dict:
    """The repo's synthetic verify video (scripts/make_synth_video.py:13-24
    poses: a tilted base rotation, ``deg_step`` a frame about (0, 1, 0.2),
    a translation wobble at ~0.55 m scaled by ``wobble``) rendered at
    H x W with fx = fy = f and the principal point at the centre, dots
    texture; color as u8 and depth in mm steps, as the dataset readers give
    them."""
    import numpy as np

    sys.path.insert(0, _tests_dir())
    from synthetic_cube import cube_model_points, render_cube_rgbd

    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    out = {"colors": [], "depths": [], "masks": [], "gt": [], "K": K,
           "model_pts": cube_model_points(0.15)}
    for T in synth_poses(n_frames, deg_step, wobble):
        rgb, depth, mask = render_cube_rgbd(T, K, H, W, texture="dots")
        out["colors"].append(rgb.astype(np.uint8))
        out["depths"].append((np.round(depth * 1000.0) / 1000.0).astype(np.float32))
        out["masks"].append(mask)
        out["gt"].append(T)
    return out


def run_tracker(tracker, video: dict, frames) -> tuple[list, list]:
    """Feed ``frames`` of ``video`` to the tracker; returns each run's wall
    ms (the run ends with the pose readback; the synchronise adds nothing)
    and each frame's final status."""
    import torch

    ms, status = [], []
    for k in frames:
        t0 = time.perf_counter()
        f = tracker.run(video["colors"][k], video["depths"][k], video["K"], f"{k:05d}",
                        mask=video["masks"][k])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        status.append(f.status)
    return ms, status


def track_result(tracker, video: dict, status: list) -> dict:
    """Keyframes, FAIL frames and ADD / ADD-S (first-frame aligned, AUC up
    to 10 cm) of the frames tracked so far."""
    import numpy as np

    from bundlesdf_tpu_torch.tracking.frame import FAIL
    from bundlesdf_tpu_torch.utils import metrics

    n = len(status)
    preds = np.stack([tracker.poses_log[f"{k:05d}"] for k in range(n)])
    res = metrics.trajectory_add_auc(preds, np.stack(video["gt"][:n]), video["model_pts"])
    return {"keyframes": [f.id for f in tracker.bundler.keyframes],
            "fail_frames": [k for k in range(n) if status[k] == FAIL],
            "mean_add_m": res["mean_add"], "mean_adds_m": res["mean_adds"],
            "add_auc": res["add_auc"], "adds_auc": res["adds_auc"],
            "max_add_m": float(res["add_errs"].max())}


def pose_diff(a, b) -> tuple[float, float]:
    """Translation (m) and rotation (deg) between two 4x4 poses; the angle
    from the chord, 2 asin(|Ra - Rb|_F / 2^1.5), which unlike the arccos of
    the trace does not read f32 rounding as ~0.04 deg."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / 2 ** 1.5
    return (float(np.linalg.norm(a[:3, 3] - b[:3, 3])),
            float(np.degrees(2 * np.arcsin(min(1.0, chord)))))


def phase_tracking_small_parity(device) -> dict:
    """The tracking-only tracker on the card against the same tracker on the
    CPU: the 96 x 96 cube sequence (tests/synthetic_cube.py::
    make_cube_sequence, 6 frames, 3 deg apart) under small_track_cfg, both
    with the same RANSAC draws.  Poses within 1 mm and 0.2 deg; keyframes
    and FAIL statuses equal."""
    import numpy as np

    from bundlesdf_tpu_torch import entry

    sys.path.insert(0, _tests_dir())
    from synthetic_cube import cube_model_points, make_cube_sequence

    data = make_cube_sequence(n_frames=6, deg_per_frame=3.0)
    video = {"colors": data["colors"], "depths": data["depths"], "masks": data["masks"],
             "K": data["K"], "gt": list(data["gt_ob_in_cam"]),
             "model_pts": cube_model_points(data["half"])}
    out = {}
    for name, dev in (("gpu", device), ("cpu", "cpu")):
        tracker = entry.build_tracker(small_track_cfg(), device=dev, ransac_draws=cpu_draws)
        _, status = run_tracker(tracker, video, range(6))
        out[name] = (tracker, status, track_result(tracker, video, status))
    (tg, sg, rg), (tc, sc, rc) = out["gpu"], out["cpu"]
    diffs = [pose_diff(tg.poses_log[f"{k:05d}"], tc.poses_log[f"{k:05d}"]) for k in range(6)]
    max_t = max(d[0] for d in diffs)
    max_r = max(d[1] for d in diffs)
    if rg["keyframes"] != rc["keyframes"] or sg != sc:
        raise AssertionError(f"tracking_small_parity: gpu {rg} {sg}, cpu {rc} {sc}")
    if not (max_t < 1e-3 and max_r < 0.2):
        raise AssertionError(f"tracking_small_parity: poses differ by {max_t} m, {max_r} deg")
    return {"phase": "tracking_small_parity", "frames": 6, "hw": [96, 96],
            "max_pose_diff_m": max_t, "max_pose_diff_deg": max_r,
            "pose_diff_m_deg": diffs, "keyframes": rg["keyframes"], "statuses": sg,
            "gpu": rg, "cpu": rc}


def phase_tracking(device, profile: bool):
    """The tracking-only tracker at full width under the shipped tracker
    config; per-frame wall time over frames 2..15 with the profiler's span
    table reset at frame 0 and the kernel launch counts set to 0 just
    before and read just after (the NOF kernels stay 0; the depth kernel
    launches once a frame).  Returns the phase's result and what
    ``profile_tracking`` needs to track more frames."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.ops import depth_cuda
    from bundlesdf_tpu_torch.utils import profiler

    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls must run in full precision for the pose math")
    H, W = TRACK_HW
    t0 = time.perf_counter()
    video = synth_video(TRACK_FRAMES + (TRACK_PROFILED if profile else 0), H, W, TRACK_DEG)
    render_s = time.perf_counter() - t0
    cfg = default_track_config()
    tracker = entry.build_tracker(cfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.reset()
    reset_counts()
    depth_launched = depth_cuda.launches
    ms, status = run_tracker(tracker, video, range(TRACK_FRAMES))
    counts = read_counts()
    depth_launched = depth_cuda.launches - depth_launched
    spans = profiler.stats()
    res = track_result(tracker, video, status)
    gate = float(cfg["ransac"]["max_trans_neighbor"])
    step_max = max(model_origin_steps(tracker, TRACK_WOBBLE))
    timed = ms[TRACK_TIMED]
    n_fused = spans.get("launch/fused_match_ba", {"count": 0})["count"]
    out = {
        "phase": "tracking", "frames": TRACK_FRAMES, "hw": [H, W], "deg_per_frame": TRACK_DEG,
        "wobble": TRACK_WOBBLE,
        "config": "default_track_config (unchanged)",
        "resize": cfg["feature_corres"]["resize"],
        "max_matches_per_pair": cfg["feature_corres"]["max_matches_per_pair"],
        "ransac_trials": cfg["ransac"]["max_iter"],
        "max_BA_frames": cfg["bundle"]["max_BA_frames"],
        "fused_ba_pairs": cfg["bundle"]["fused_ba_pairs"],
        "track_ms_per_frame_median": float(np.median(timed)),
        "track_ms_per_frame_max": float(np.max(timed)),
        "track_ms_per_frame_min": float(np.min(timed)),
        "track_ms_timed_frames": [TRACK_TIMED.start, TRACK_FRAMES - 1],
        "track_ms_per_frame": ms,
        "span_mean_ms": {k: v["mean_s"] * 1e3 for k, v in spans.items() if v["total_s"] > 0},
        "span_count": {k: v["count"] for k, v in spans.items()},
        "launch_fused_match_ba": n_fused,
        "launch_ba": spans.get("launch/ba", {"count": 0})["count"],
        "n_keyframes": len(res["keyframes"]), "n_fail": len(res["fail_frames"]),
        **res,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "kernel_launches": counts, "depth_frame_launches": depth_launched,
        "render_s": render_s,
        "neighbor_gate_m": gate, "model_origin_step_max_m": step_max,
    }
    emit(out)
    if depth_launched != TRACK_FRAMES:
        raise AssertionError(f"tracking: {depth_launched} depth kernel launches for "
                             f"{TRACK_FRAMES} frames")
    if not step_max < gate:
        raise AssertionError(f"tracking: the input's true model-origin step {step_max} m "
                             f"is not under the neighbour gate {gate} m")
    if res["fail_frames"]:
        raise AssertionError(f"tracking: FAIL frames {res['fail_frames']}")
    if not res["mean_add_m"] < 0.01:
        raise AssertionError(f"tracking: mean ADD {res['mean_add_m']} m >= 1 cm")
    if n_fused < 10:
        raise AssertionError(f"tracking: {n_fused} fused match + BA launches < 10")
    return out, (tracker, video, out["track_ms_per_frame_median"])


def depth_mismatches(got, want) -> dict:
    """Elements of depth, xyz and normals whose bits differ, and pixels
    whose valid differs, between two (depth, xyz, normals, valid)."""
    import numpy as np

    out = {name: int((a.view(np.uint32) != b.view(np.uint32)).sum())
           for name, a, b in zip(("depth", "xyz", "normals"), got[:3], want[:3])}
    out["valid"] = int((got[3] != want[3]).sum())
    return out


def phase_depth_frame(device) -> dict:
    """The tracker's depth kernel (ops/depth_cuda.py) on the card against
    the host twin with the Frame's mask invalidation, at the shipped radii
    and at DEPTH_WIDE: the 60 frames portbench/video.py renders for track60
    (their masks) and DEPTH_HARD_FRAMES hard frames
    (tests/port_depth_kernel.py), bitwise on depth, xyz and normals, valid
    equal, one launch a call; a Frame built on the card equals one built on
    the CPU and records one ``track/depth/device`` span.  Then, at 480 x
    640 on track60's frame 0: the kernel's device ms (L2 cold) against its
    byte bound, the upload and readback ms, the wrapper's host ms a call
    and its copy-out, the twin's host ms, and the plain torch
    process_depth_frame on the card."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.ops import depth_cuda, image as image_ops
    from bundlesdf_tpu_torch.tracking.frame import Frame
    from bundlesdf_tpu_torch.utils import profiler
    from portbench import video as video_mod

    sys.path.insert(0, _tests_dir())
    from port_depth_kernel import hard_depth_frames, hard_k

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "portbench", "traffic", "track60.json")) as f:
        vid = video_mod.make_video(json.load(f), DEPTH_SEED)
    H, W = vid["depths"][0].shape
    cfg = default_track_config()
    shipped = depth_cuda.config_params(cfg["depth_processing"])
    wide = dict(shipped, erode_radius=DEPTH_WIDE[0], bilateral_radius=DEPTH_WIDE[1])
    hard = hard_depth_frames(DEPTH_HARD_FRAMES, H, W, DEPTH_SEED)
    cases = {"track60": [(d, vid["K"], m, None) for d, m in zip(vid["depths"], vid["masks"])],
             "hard": [(d, hard_k(H, W), fg, occ) for d, fg, occ in hard]}
    bad, n_valid, calls = {}, {}, 0
    launched = depth_cuda.launches
    for cname, frames in cases.items():
        for pname, p in (("shipped", shipped), ("wide", wide)):
            key = f"{cname}.{pname}"
            bad[key] = dict.fromkeys(("depth", "xyz", "normals", "valid"), 0)
            n_valid[key] = 0
            for d, K, fg, occ in frames:
                got = depth_cuda.process_depth_frame(d, K, device, fg, occ, **p)
                want = depth_cuda.process_depth_frame(d, K, "cpu", fg, occ, **p)
                calls += 1
                for k, v in depth_mismatches(got, want).items():
                    bad[key][k] += v
                n_valid[key] += int(want[3].sum())
    launched = depth_cuda.launches - launched

    profiler.reset()
    kw = dict(fg_mask=vid["masks"][3])
    f_card = Frame(vid["colors"][3], vid["depths"][3], vid["K"], 3, "3", cfg, device=device, **kw)
    f_host = Frame(vid["colors"][3], vid["depths"][3], vid["K"], 3, "3", cfg, **kw)
    frame_bad = depth_mismatches((f_card.depth, f_card.xyz, f_card.normals, f_card.valid),
                                 (f_host.depth, f_host.xyz, f_host.normals, f_host.valid))
    frame_spans = profiler.stats().get("track/depth/device", {"count": 0})["count"]

    # times at 480 x 640, track60's frame 0 and its mask, the shipped radii
    d0, K0, m0 = vid["depths"][0], vid["K"], vid["masks"][0]
    hw = H * W
    st = depth_cuda._stage(device.index)
    depth_cuda.process_depth_frame(d0, K0, device, m0, **shipped)
    kernel_ms = cuda_ms(lambda: depth_cuda._launch(st, H, W, K0, shipped, False))
    upload_ms = cuda_ms(lambda: st.dev_in[:6 * hw].copy_(st.host_in[:6 * hw], non_blocking=True))
    readback_ms = cuda_ms(
        lambda: st.host_out[:29 * hw].copy_(st.dev_out[:29 * hw], non_blocking=True))
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        depth_cuda.process_depth_frame(d0, K0, device, m0, **shipped)
    wrapper_ms = (time.perf_counter() - t0) / n * 1e3
    out_np = st.host_out.numpy()
    t0 = time.perf_counter()
    for _ in range(n):
        for a, b in ((0, 4), (4, 16), (16, 28), (28, 29)):
            out_np[a * hw:b * hw].copy()
    copy_out_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for _ in range(3):
        depth_cuda.process_depth_frame(d0, K0, "cpu", m0, **shipped)
    twin_ms = (time.perf_counter() - t0) / 3 * 1e3
    td, tK = torch.from_numpy(d0).to(device), torch.from_numpy(K0).to(device)
    plain_ms, plain_host_ms = event_ms(lambda: image_ops.process_depth_frame(td, tK, **shipped))
    n_bytes = hw * (4 + 1 + 29)
    bound_ms = bound(n_bytes, 0)[0]
    res = {
        "phase": "depth_frame", "hw": [H, W], "seed": DEPTH_SEED,
        "radii": {"shipped": [shipped["erode_radius"], shipped["bilateral_radius"]],
                  "wide": list(DEPTH_WIDE)},
        "frames": {k: len(v) for k, v in cases.items()},
        "mismatches": bad, "valid_pixels": n_valid,
        "launches": launched, "calls": calls,
        "frame_mismatches": frame_bad, "frame_depth_device_spans": frame_spans,
        "kernel_ms": kernel_ms, "bound_ms": bound_ms, "bound": "bytes", "bytes": n_bytes,
        "roofline_share": bound_ms / kernel_ms,
        "upload_ms": upload_ms, "readback_ms": readback_ms,
        "wrapper_host_ms": wrapper_ms, "copy_out_host_ms": copy_out_ms,
        "twin_host_ms": twin_ms, "plain_torch_ms": plain_ms,
        "plain_torch_host_enqueue_ms": plain_host_ms,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(res)
    wrong = {k: v for k, v in bad.items() if any(v.values())}
    if wrong:
        raise AssertionError(f"depth_frame: the kernel differs from the twin: {wrong}")
    if any(frame_bad.values()) or frame_spans != 1:
        raise AssertionError(f"depth_frame: the card's Frame differs from the CPU's "
                             f"({frame_bad}) or spans {frame_spans} != 1")
    if launched != calls:
        raise AssertionError(f"depth_frame: {launched} launches for {calls} calls")
    return res


def covisibility_mismatches(got, pairs, angle: float) -> dict:
    """The pairs whose count differs from the twin's, the largest
    difference, and the differences beyond the points near the threshold
    (tests/port_covisibility_kernel.py::near_threshold), between the
    kernel's ratios ``got`` and the twin's on the same pairs."""
    from bundlesdf_tpu_torch.tracking.frame import compute_covisibility
    from port_covisibility_kernel import near_threshold

    differ, largest, beyond, near_points = 0, 0, 0, 0
    for v, (fa, fb) in zip(got, pairs):
        total = int((fa.valid & fa.fg_mask)[::2, ::2].sum()) + 1e-7
        d = abs(round(v * total) - round(compute_covisibility(fa, fb, angle) * total))
        near = near_threshold(fa, fb, angle)
        differ += d > 0
        largest = max(largest, d)
        beyond += d > near
        near_points += near
    return {"pairs": len(pairs), "differ": differ, "max_diff": largest,
            "beyond_near": beyond, "near_points": near_points}


def phase_covisibility(device) -> dict:
    """The tracker's covisibility kernel (ops/covisibility_cuda.py) on the
    card against the host twin compute_covisibility, one launch a batch: on
    the hard frames (tests/port_covisibility_kernel.py) at 480 x 640 with
    COV_POSES queries a frame (identity, opposite, random), and on the 60
    Frames of track60 (portbench/video.py) at their true poses, each against
    up to COV_POSES predecessors; every count the twin's or off by at most
    the points whose float64 dot lies within 1e-5 of the threshold.  Then,
    frame 30 against frames 0-29: the kernel's device ms (L2 cold) against
    its byte bound, one frame's upload ms, the twin's host ms for the 30
    pairs, and one whole ``Bundler.covisibilities`` call (host ms) with the
    new frame's upload and with its maps resident."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.ops import covisibility_cuda as cov
    from bundlesdf_tpu_torch.tracking.frame import Frame, compute_covisibility
    from bundlesdf_tpu_torch.tracking.pool import Bundler
    from portbench import video as video_mod

    sys.path.insert(0, _tests_dir())
    from port_covisibility_kernel import hard_frames, hard_queries

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "portbench", "traffic", "track60.json")) as f:
        vid = video_mod.make_video(json.load(f), COV_SEED)
    H, W = vid["depths"][0].shape
    cfg = default_track_config()
    angle = float(cfg["visible_angle"])
    frames = [Frame(vid["colors"][k], vid["depths"][k], vid["K"], k, str(k), cfg,
                    pose_in_model=np.linalg.inv(vid["gt"][k]).astype(np.float32),
                    fg_mask=vid["masks"][k], device=device) for k in range(len(vid["gt"]))]
    cases = {"hard": hard_queries(hard_frames(H, W, COV_SEED, angle), COV_POSES - 2, COV_SEED),
             "track60": [(frames[k], frames[j]) for k in range(1, len(frames))
                         for j in range(max(0, k - COV_POSES), k)]}
    launched = cov.launches
    checked = {name: covisibility_mismatches(cov.covisibilities(pairs, angle, device, {}),
                                             pairs, angle)
               for name, pairs in cases.items()}
    launched = cov.launches - launched

    # frame 30 against its 30 predecessors, as the shipped selection scores it
    nf = frames[COV_POSES]
    pairs = [(nf, kf) for kf in frames[:COV_POSES]]
    P = cov.n_points(nf)
    resident = {}
    cov.covisibilities(pairs, angle, device, resident)
    st = cov._stage_of(device)
    kernel_ms = cuda_ms(lambda: cov._launch(st, 1, len(pairs), P, cov.threshold(angle)))
    staged = st.maps_host[:cov.POINT_BYTES * P]
    upload_ms = cuda_ms(lambda: resident[nf.id][2].copy_(staged, non_blocking=True))
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        [compute_covisibility(nf, kf, angle) for _, kf in pairs]
    twin_ms = (time.perf_counter() - t0) / n * 1e3
    b = Bundler(cfg, device)
    ms = {}
    for name, fresh in (("with_upload", True), ("resident", False)):
        b.covisibilities(pairs)
        t0 = time.perf_counter()
        for _ in range(20):
            b._cov_cache = {}
            if fresh:
                b._cov_maps = {}
            b.covisibilities(pairs)
        ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    n_bytes = cov.POINT_BYTES * P + 48 * len(pairs) + 4 * (len(pairs) + 1)
    bound_ms = bound(n_bytes, 0)[0]
    res = {
        "phase": "covisibility", "hw": [H, W], "seed": COV_SEED, "poses": COV_POSES,
        "checked": checked, "launches": launched, "calls": len(cases),
        "kernel_ms": kernel_ms, "bound_ms": bound_ms, "bound": "bytes", "bytes": n_bytes,
        "roofline_share": bound_ms / kernel_ms, "upload_ms": upload_ms,
        "twin_host_ms": twin_ms, "bundler_call_host_ms": ms,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(res)
    wrong = {k: v for k, v in checked.items() if v["beyond_near"]}
    if wrong:
        raise AssertionError(f"covisibility: counts beyond the threshold's rounding: {wrong}")
    if launched != len(cases):
        raise AssertionError(f"covisibility: {launched} launches for {len(cases)} calls")
    return res


def profile_tracking(ctx, out_dir: str) -> dict:
    """torch.profiler over TRACK_PROFILED more tracked frames: device time
    by kernel and the device's idle share of the frames' wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tracker, video, median_ms = ctx
    n = TRACK_PROFILED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ms, _ = run_tracker(tracker, video, range(TRACK_FRAMES, TRACK_FRAMES + n))
    rows, total = device_rows(prof, n, "tracking", out_dir, "frame")
    wall = sum(ms) / n
    return {"phase": "profile_tracking", "frames": n, "device_ms_per_frame": total,
            "profiled_wall_ms_per_frame": wall, "timed_median_ms": median_ms,
            "device_idle_share": 1.0 - total / wall,
            "device_kernels_per_frame": sum(r["calls_per_frame"] for r in rows),
            "top": rows[:25]}


# ------------------------------------------------------------ joint loop ---

def small_nof_cfg():
    """tests/test_pipeline.py::small_nof_cfg, built on the port's config."""
    from bundlesdf_tpu_torch.config import default_nof_config

    cfg = default_nof_config()
    cfg.update(n_step=30, N_rand=256, N_samples=24, N_samples_around_depth=12,
               num_levels=4, finest_res=64, log2_hashmap_size=16,
               octree_smallest_voxel_size=0.05, octree_dilate_size=0.05,
               max_kf_pool=32, mesh_resolution=0.04)
    return cfg


def ray_keys(rows) -> list:
    """A pool ray's identity: its frame and its pixel's direction (bitwise)."""
    import numpy as np

    return [tuple(r) for r in np.ascontiguousarray(rows[:, [0, 1, 8]]).view(np.int32)]


class SharedNofDraws:
    """NOF draws that make two runs of the joint loop train on the same rays.
    The first run draws each step's batch indices and jitter from a CPU
    generator seeded with the step's place in the run, and records the pool
    they index.  The second run replays them: each ray the first run drew is
    found in its own pool by frame and pixel (a pool that differs by a few
    rows would otherwise shift every index), with the same jitter."""

    def __init__(self):
        self.log, self.pipe, self.replay, self.k, self.misses = [], None, False, 0, 0
        self._rows = None

    def start(self, pipe, replay: bool) -> None:
        self.pipe, self.replay, self.k = pipe, replay, 0

    def __call__(self, step: int, n_rays: int):
        import torch

        from bundlesdf_tpu_torch.nof.render import SampleDraws

        nof = self.pipe.nof
        k, self.k = self.k, self.k + 1
        if not self.replay:
            st = nof.statics
            g = torch.Generator().manual_seed(k)
            idx = torch.randint(0, n_rays, (st.n_rand,), generator=g)
            draws = SampleDraws(*(torch.rand((st.n_rand, s), generator=g) for s in (
                st.rcfg.n_samples, st.rcfg.n_samples_around_depth,
                st.rcfg.n_samples_around_depth)))
            self.log.append((step, nof.rays_np, idx, draws))
            return idx, draws
        step0, pool0, idx0, draws = self.log[k]
        if step0 != step:
            raise AssertionError(f"replayed NOF step {step} != recorded {step0}")
        if self._rows is None or self._rows[0] is not nof.rays_np:
            self._rows = (nof.rays_np, {r: i for i, r in enumerate(ray_keys(nof.rays_np))})
        rows = self._rows[1]
        keys = ray_keys(pool0[idx0.numpy()])
        self.misses += sum(r not in rows for r in keys)
        return torch.tensor([rows.get(r, min(int(i), n_rays - 1))
                             for r, i in zip(keys, idx0)]), draws


def count_rounds(pipe) -> list:
    """(frame, step budget) of each NOF round start of ``pipe``."""
    log = []
    orig = pipe._nof_round_start

    def counting():
        orig()
        log.append((pipe.cnt, pipe._nof_steps_left))

    pipe._nof_round_start = counting
    return log


def cube_surface_dist(mesh, pipe, gt0, half: float) -> float:
    """Median distance (m) of the mesh's vertices to the true cube surface,
    in the cube's frame (the JAX smoke test's measure,
    tests/test_pipeline.py:114-130)."""
    import numpy as np

    inv_T = np.linalg.inv(pipe.bundler.firstframe.pose_in_model @ gt0)
    v = mesh.vertices @ inv_T[:3, :3].T + inv_T[:3, 3]
    q = np.abs(v) - half
    return float(np.median(np.abs(np.linalg.norm(np.maximum(q, 0), axis=-1)
                                  + np.minimum(q.max(axis=-1), 0))))


def joint_loop(pipe, frames: dict, n: int) -> dict:
    """Feed ``n`` frames of a cube sequence to rank 0's ``pipe`` and finish
    it: statuses, round starts with their budgets, keyframes, the nerfed
    set, steps, poses and the mesh's distance to the cube."""
    rounds = count_rounds(pipe)
    status = [pipe.run(frames["colors"][k], frames["depths"][k], frames["K"], f"{k:05d}",
                       mask=frames["masks"][k]).status for k in range(n)]
    nerfed = [f.id for f in pipe.bundler.keyframes if f.nerfed]
    mesh = pipe.on_finish()
    return {"status": status, "rounds": rounds, "nerfed": nerfed,
            "keyframes": [f.id for f in pipe.bundler.keyframes],
            "steps": pipe.nof.total_step if pipe.nof else 0,
            "poses": [pipe.poses_log[f"{k:05d}"] for k in range(n)],
            "mesh_vertices": len(mesh.vertices) if mesh is not None else 0,
            "surface_dist_m": (cube_surface_dist(mesh, pipe, frames["gt_ob_in_cam"][0],
                                                 frames["half"])
                               if mesh is not None and len(mesh.vertices) else None)}


def phase_joint_small_parity(device) -> dict:
    """The joint loop (BundleSdf(use_nof=True)) on the card against the CPU:
    the 96 x 96 cube sequence (6 frames, 3 deg apart) under small_track_cfg
    and small_nof_cfg, start_nerf_keyframes 3, the same RANSAC and NOF
    draws and the same initial weights (drawn on the CPU).  The same
    keyframes, round starts and budgets and nerfed set; poses within 1 mm
    and 0.2 deg; both meshes non-empty and on the cube's surface (median
    under 3 cm)."""
    import numpy as np

    from bundlesdf_tpu_torch import entry

    sys.path.insert(0, _tests_dir())
    from synthetic_cube import make_cube_sequence

    data = make_cube_sequence(n_frames=6, deg_per_frame=3.0)
    draws = SharedNofDraws()
    out = {}
    for name, dev in (("cpu", "cpu"), ("gpu", device)):
        pipe = entry.build_pipeline(small_track_cfg(), small_nof_cfg(),
                                    start_nerf_keyframes=3, device=dev,
                                    ransac_draws=cpu_draws, nof_draws=draws)
        draws.start(pipe, replay=name == "gpu")
        if name == "gpu":
            reset_counts()
        out[name] = joint_loop(pipe, data, 6)
        out[name]["pool_rows"] = len(pipe.nof.rays_np) if pipe.nof else 0
    counts = read_counts()
    g, c = out["gpu"], out["cpu"]
    diffs = [pose_diff(a, b) for a, b in zip(g["poses"], c["poses"])]
    max_t, max_r = max(d[0] for d in diffs), max(d[1] for d in diffs)
    res = {"phase": "joint_small_parity", "frames": 6, "hw": [96, 96],
           "keyframes": g["keyframes"], "rounds": g["rounds"], "nerfed": g["nerfed"],
           "statuses": g["status"], "steps": g["steps"],
           "max_pose_diff_m": max_t, "max_pose_diff_deg": max_r, "pose_diff_m_deg": diffs,
           "mesh_vertices_gpu_cpu": [g["mesh_vertices"], c["mesh_vertices"]],
           "surface_dist_m_gpu_cpu": [g["surface_dist_m"], c["surface_dist_m"]],
           "draw_misses": draws.misses, "kernel_launches_gpu": counts,
           "cpu_pool_rows": c["pool_rows"], "gpu_pool_rows": g["pool_rows"]}
    emit(res)
    for key in ("keyframes", "rounds", "nerfed", "status", "steps"):
        if g[key] != c[key]:
            raise AssertionError(f"joint_small_parity: {key} gpu {g[key]} cpu {c[key]}")
    if not g["rounds"] or not g["nerfed"]:
        raise AssertionError("joint_small_parity: no NOF round completed")
    if not (max_t < 1e-3 and max_r < 0.2):
        raise AssertionError(f"joint_small_parity: poses differ by {max_t} m, {max_r} deg")
    for name in ("gpu", "cpu"):
        d = out[name]["surface_dist_m"]
        if d is None or out[name]["mesh_vertices"] <= 50 or not d < 0.03:
            raise AssertionError(f"joint_small_parity: {name} mesh off the cube: {d}")
    return res


@contextlib.contextmanager
def count_train_steps(log: list):
    """Record the step count of every NofRunner.train_advance call (the
    scheduler's rounds and the calibration chunk) while the block runs."""
    from bundlesdf_tpu_torch.nof import runner

    orig = runner.NofRunner.train_advance

    def rec(self, n_steps):
        log.append(n_steps)
        return orig(self, n_steps)

    runner.NofRunner.train_advance = rec
    try:
        yield
    finally:
        runner.NofRunner.train_advance = orig


def phase_joint(device, video: dict, out_dir: str):
    """The joint loop at full width: the shipped tracker and NOF configs
    (2048 rays x (128 + 64) samples, 4 dense levels 16 -> 128, bf16 big
    levels, hash_reduce auto, strict sync, step calibration, loop_chunk 16),
    depth cut to n_step 100 and n_step_extend 25, on the first JOINT_FRAMES
    frames of the tracking phase's 480 x 640 video, start_nerf_keyframes 5,
    writing the artifact trail (SPDLOG 2) into ``out_dir`` and the camera
    intrinsics beside it (cam_K.txt, as the dataset layout has them).  The
    launch counts are set to 0 just before the first frame and read after
    on_finish; the reduce kernel must launch twice per NOF step trained (the
    sum of train_advance's step counts, calibration included).  Returns the
    phase's result and the pipeline."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_nof_config, default_track_config
    from bundlesdf_tpu_torch.utils import profiler

    cfg_nof = default_nof_config()
    cfg_nof.update(JOINT_DEPTH)
    cfg_track = default_track_config()
    cfg_track["SPDLOG"] = 2
    pipe = entry.build_pipeline(cfg_track, cfg_nof, start_nerf_keyframes=JOINT_START,
                                device=device, save_artifacts=True, out_dir=out_dir)
    np.savetxt(os.path.join(os.path.dirname(out_dir), "cam_K.txt"), video["K"])
    rounds = count_rounds(pipe)
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.reset()
    reset_counts()
    with count_train_steps(steps):
        ms, status = run_tracker(pipe, video, range(JOINT_FRAMES))
        t0 = time.perf_counter()
        mesh = pipe.on_finish()
        torch.cuda.synchronize()
        finish_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    graph = read_graph_counts()
    spans = profiler.stats()
    res = track_result(pipe, video, status)
    n_steps = sum(steps)
    nerfed = [f.id for f in pipe.bundler.keyframes if f.nerfed]
    surf = (cube_surface_dist(mesh, pipe, video["gt"][0], 0.15)
            if mesh is not None and len(mesh.vertices) else None)
    span_names = ("scene_bounds", "create_runner", "build_rays", "build_occupancy",
                  "upload_rays", "fuse_cluster", "add_new_frames", "advance",
                  "train_advance", "train_drain", "sync_wait", "round_start",
                  "calibrate", "pose_export", "feedback", "extract_mesh_final", "capture")
    out = {
        "phase": "joint", "frames": JOINT_FRAMES, "hw": list(TRACK_HW),
        "deg_per_frame": TRACK_DEG, "wobble": TRACK_WOBBLE,
        "config": "default_track_config with SPDLOG 2 (the trail's image dumps), "
                  "default_nof_config with " + json.dumps(JOINT_DEPTH) + " (depth cut)",
        "start_nerf_keyframes": JOINT_START,
        "frame_ms_median": float(np.median(ms)), "frame_ms_max": float(np.max(ms)),
        "frame_ms": ms, "on_finish_ms": finish_ms,
        "rounds": rounds, "n_rounds": len(rounds),
        "round_steps": [b for _, b in rounds], "steps_trained": n_steps,
        "train_advance_calls": steps,
        "calibrate_step_ms": pipe.nof._step_ms if pipe.nof else None,
        "nof_span_mean_ms": {k: spans[f"nof/{k}"]["mean_s"] * 1e3 if f"nof/{k}" in spans
                             else None for k in span_names},
        "nof_span_count": {k: spans[f"nof/{k}"]["count"] if f"nof/{k}" in spans else 0
                           for k in span_names},
        "track_span_mean_ms": {k: v["mean_s"] * 1e3 for k, v in spans.items()
                               if k.startswith("track/") and v["total_s"] > 0},
        "launch_nof_chunk": spans.get("launch/nof_chunk", {"count": 0})["count"],
        "artifacts_save_ms_mean": spans["artifacts/save"]["mean_s"] * 1e3,
        "artifacts_save_count": spans["artifacts/save"]["count"],
        "frame_ms_median_less_artifacts": float(np.median(ms))
        - spans["artifacts/save"]["mean_s"] * 1e3,
        "trail_frames": len(os.listdir(os.path.join(out_dir, "color_segmented"))),
        "trail_config_nerf": os.path.exists(os.path.join(out_dir, "config_nerf.yml")),
        "nerfed": nerfed, "n_keyframes": len(res["keyframes"]), "n_fail": len(res["fail_frames"]),
        **res,
        "ray_pool_rows": len(pipe.nof.rays_np) if pipe.nof else 0,
        "occ_resolution": pipe.nof.occ_resolution if pipe.nof else None,
        "mesh_vertices": len(mesh.vertices) if mesh is not None else 0,
        "mesh_surface_dist_median_m": surf,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "kernel_launches": counts, "graph": graph,
        "graph_pool_gb": pipe.nof.graph_stats()["graph_pool_bytes"] / 1e9 if pipe.nof else None,
    }
    emit(out)
    if res["fail_frames"]:
        raise AssertionError(f"joint: FAIL frames {res['fail_frames']}")
    if not res["mean_add_m"] < 0.01:
        raise AssertionError(f"joint: mean ADD {res['mean_add_m']} m >= 1 cm")
    if not rounds or not nerfed:
        raise AssertionError(f"joint: no completed NOF round ({rounds}, nerfed {nerfed})")
    if mesh is None or len(mesh.vertices) <= 50 or surf is None or not surf < 0.03:
        raise AssertionError(f"joint: mesh {out['mesh_vertices']} vertices, "
                             f"median surface distance {surf}")
    if n_steps == 0:
        raise AssertionError("joint: no NOF step trained")
    check_graph_counts("joint", graph, counts, n_steps, {"reduce_cell_cache_grad": 2})
    if out["trail_frames"] != JOINT_FRAMES or not out["trail_config_nerf"]:
        raise AssertionError(f"joint: trail of {out['trail_frames']} frames, "
                             f"config_nerf.yml {out['trail_config_nerf']}")
    return out, pipe


# ------------------------------------------- host-warp path, LoFTR, rematch ---

def video_frames(video: dict, ids) -> list:
    """Frames of the tracking video under the shipped tracker config at their
    true poses (camera in the object's frame)."""
    import numpy as np

    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.tracking.frame import Frame

    cfg = default_track_config()
    out = []
    for k in ids:
        f = Frame(video["colors"][k], video["depths"][k], video["K"], k, f"{k:05d}", cfg,
                  fg_mask=video["masks"][k])
        f.pose_in_model = np.linalg.inv(video["gt"][k]).astype(np.float32)
        out.append(f)
    return out


def event_ms(fn, iters: int = 5, warmup: int = 2) -> tuple[float, float]:
    """Steady-state wall time of one call of ``fn`` on the device, by CUDA
    events around ``iters`` warm calls (idle gaps included where the host's
    enqueue is slower than the device), and the host's enqueue time a call
    (both ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters, host


@contextlib.contextmanager
def without_port_conv(loftr_mod):
    """LoFTR's backbone on cuDNN's convolutions (the port routes it to
    PyTorch's im2col convolutions, ``models/loftr.py::_without_cudnn``)."""
    orig = loftr_mod._without_cudnn
    loftr_mod._without_cudnn = contextlib.nullcontext
    try:
        yield
    finally:
        loftr_mod._without_cudnn = orig


def loftr_flops(module, a, b) -> float:
    """Multiply-add operations x 2 of one forward (convolutions, linear
    layers, matmuls and einsums), counted by torch's FlopCounterMode."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        module(a, b)
    return float(counter.get_total_flops())


def phase_loftr_parity(device, video: dict) -> dict:
    """LoFTR at full width (LoftrCfg() defaults, thr 0 so that the fine
    branch runs on every selected window) on one real pair, frames 1 and 0
    of the tracking video through process_image_pair (400 x 400 crops), on
    the card and on the CPU with the same seeded random weights (one state
    dict): the crops, the coarse conf matrix, the selected (i, j) ids and
    mkpts1.  Then the card's forward at batch 1 and 16 (the host-warp
    path's buckets), warm, by CUDA events (``event_ms``), its operations and
    peak memory, and the same forward on cuDNN's convolutions, which the
    port does not use.  TF32 is off (main)."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch.models import loftr
    from bundlesdf_tpu_torch.tracking import corres

    t_phase = time.perf_counter()
    S = 400
    f1, f0 = video_frames(video, (1, 0))
    cfg = loftr.LoftrCfg(thr=0.0)
    cpu = loftr.LoftrMatcher(cfg, seed=0, device="cpu")
    gpu = loftr.LoftrMatcher(cfg, state_dict=cpu.module.state_dict(), device=device)
    crops = {}
    for name, dev in (("gpu", device), ("cpu", "cpu")):
        a, b, _, _ = corres.process_image_pair(f1, f0, S, dev)
        crops[name] = (a / 255.0)[None, None], (b / 255.0)[None, None]
    warp_err = max(max_err(crops["gpu"][i].cpu(), crops["cpu"][i]) for i in (0, 1))
    outs = {}
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        with torch.inference_mode():
            o = m.module(*crops[name])
        outs[name] = {k: v.cpu() for k, v in o.items()}
        outs[name]["wall_ms"] = (time.perf_counter() - t0) * 1e3
    g, c = outs["gpu"], outs["cpu"]
    conf_err = max_err(g["conf_matrix"], c["conf_matrix"])
    ids_equal = bool(torch.equal(g["i_ids"], c["i_ids"]) and torch.equal(g["j_ids"], c["j_ids"]))
    same = ((g["i_ids"] == c["i_ids"]) & (g["j_ids"] == c["j_ids"]) & g["valid"] & c["valid"])[0]
    valid_equal = bool(torch.equal(g["valid"], c["valid"]))
    mk_err = max_err(g["mkpts1"][0][same], c["mkpts1"][0][same]) if same.any() else None

    a, b = crops["gpu"]
    flops1 = loftr_flops(gpu.module, a, b)
    times, host, peak, cudnn, cudnn_peak = {}, {}, {}, {}, {}
    for B in (1, 16):
        aB, bB = a.expand(B, -1, -1, -1).contiguous(), b.expand(B, -1, -1, -1).contiguous()

        def fwd():
            with torch.inference_mode():
                return gpu.module(aB, bB)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[B], host[B] = event_ms(fwd)
        peak[B] = torch.cuda.max_memory_allocated() / 1e9
        # the yardstick the port turns away from: the same forward on
        # cuDNN's convolutions (f32, TF32 off, its own algorithm choice)
        with without_port_conv(loftr):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cudnn[B] = event_ms(fwd, iters=3, warmup=1)[0]
            cudnn_peak[B] = torch.cuda.max_memory_allocated() / 1e9
    n_valid = int(g["valid"].sum())
    res = {
        "phase": "loftr_parity", "config": "LoftrCfg() with thr 0.0, seeded random weights "
        "(no LoFTR weights in the repo)", "pair": [1, 0], "crop": [S, S],
        "warp_max_abs_err_grey": warp_err * 255.0,
        "conf_max_abs_err": conf_err, "ids_equal": ids_equal, "valid_equal": valid_equal,
        "slots_same_valid_ids": int(same.sum()), "valid_gpu": n_valid,
        "valid_cpu": int(c["valid"].sum()), "mkpts1_max_abs_err_px": mk_err,
        "forward_ms": {"batch1": times[1], "batch16": times[16]},
        "forward_host_enqueue_ms": {"batch1": host[1], "batch16": host[16]},
        "cudnn_forward_ms": {"batch1": cudnn[1], "batch16": cudnn[16]},
        "cudnn_peak_mem_gb": {"batch1": cudnn_peak[1], "batch16": cudnn_peak[16]},
        "gflop_per_pair": flops1 / 1e9,
        "achieved_tflops": {"batch1": flops1 / times[1] / 1e9,
                            "batch16": 16 * flops1 / times[16] / 1e9},
        "f32_bound_ms": {"batch1": flops1 / PEAK_F32_FLOPS * 1e3,
                         "batch16": 16 * flops1 / PEAK_F32_FLOPS * 1e3},
        "cpu_forward_ms": c["wall_ms"],
        "peak_mem_gb": {"batch1": peak[1], "batch16": peak[16]},
        "phase_s": time.perf_counter() - t_phase,
        "limits": {"conf_max_abs_err": LOFTR_CONF_TOL, "mkpts1_px": LOFTR_MKPTS_TOL,
                   "same_valid_share": LOFTR_SAME_SHARE, "warp_grey": WARP_TOL_GREY},
    }
    emit(res)
    if not warp_err * 255.0 <= WARP_TOL_GREY:
        raise AssertionError(f"loftr_parity: the card's crops differ from the CPU's by "
                             f"{warp_err * 255.0} grey levels")
    if not conf_err <= LOFTR_CONF_TOL:
        raise AssertionError(f"loftr_parity: conf matrix differs by {conf_err}")
    if n_valid == 0 or not int(same.sum()) >= LOFTR_SAME_SHARE * n_valid:
        raise AssertionError(f"loftr_parity: {int(same.sum())} of {n_valid} valid slots agree")
    if not mk_err <= LOFTR_MKPTS_TOL:
        raise AssertionError(f"loftr_parity: mkpts1 differ by {mk_err} px")
    return res


def phase_tracking_legacy(device, video: dict) -> dict:
    """The tracking phase's 16 frames under the shipped tracker config with
    feature_corres.fused False: the corner matcher through the host-warp
    path (warp on the card, one matcher batch, host gate, one multi-pair
    RANSAC) and the split BA.  0 FAIL and mean ADD under 1 cm; one BA a
    frame after the first and no fused program; kernel launch counts set
    to 0 just before and read just after (no hand-written kernel here)."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.utils import profiler

    t_phase = time.perf_counter()
    cfg = default_track_config()
    cfg["feature_corres"]["fused"] = False
    tracker = entry.build_tracker(cfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.reset()
    reset_counts()
    ms, status = run_tracker(tracker, video, range(TRACK_FRAMES))
    counts = read_counts()
    spans = profiler.stats()
    res = track_result(tracker, video, status)
    timed = ms[TRACK_TIMED]
    n = {k: spans.get(f"launch/{k}", {"count": 0})["count"]
         for k in ("ba", "fused_match_ba", "corres", "ransac")}
    out = {
        "phase": "tracking_legacy", "frames": TRACK_FRAMES, "hw": list(TRACK_HW),
        "config": "default_track_config with feature_corres.fused False",
        "track_ms_per_frame_median": float(np.median(timed)),
        "track_ms_per_frame_max": float(np.max(timed)),
        "track_ms_per_frame": ms,
        "corres_span_mean_ms": {k: spans[f"corres/{k}"]["mean_s"] * 1e3
                                for k in ("warp", "match", "ransac") if f"corres/{k}" in spans},
        "span_mean_ms": {k: v["mean_s"] * 1e3 for k, v in spans.items() if v["total_s"] > 0},
        "launches": n, "n_fail": len(res["fail_frames"]), **res,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "kernel_launches": counts,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    if res["fail_frames"] or not res["mean_add_m"] < 0.01:
        raise AssertionError(f"tracking_legacy: FAIL {res['fail_frames']}, "
                             f"mean ADD {res['mean_add_m']} m")
    if n["ba"] != TRACK_FRAMES - 1 or n["fused_match_ba"] or not n["ransac"] >= n["corres"] > 0:
        raise AssertionError(f"tracking_legacy: launches {n}")
    return out


def phase_tracking_loftr(video: dict, ckpt: str = "", name: str = "tracking_loftr") -> dict:
    """The same video with feature_corres.matcher loftr through
    entry.build_tracker with device=None (the card), LoFTR at full width
    with seeded random weights (or the weights file ``ckpt``): every frame
    runs and LoFTR runs at each fresh match (its predict count equals
    launch/corres).  There is no quality limit: random weights match at
    random, and the repo has no trained ones."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.models import loftr
    from bundlesdf_tpu_torch.utils import profiler

    t_phase = time.perf_counter()
    cfg = default_track_config()
    cfg["feature_corres"]["matcher"] = "loftr"
    cfg["feature_corres"]["loftr_ckpt"] = ckpt
    tracker = entry.build_tracker(cfg, device=None)
    engine = tracker.bundler.store.matcher
    if not isinstance(engine, loftr.LoftrMatcher) or engine.device.type != "cuda":
        raise AssertionError(f"tracking_loftr: engine {engine}")
    valid_rows, batches = [], []
    predict = engine.predict

    def spy(a, b):
        corres, valid = predict(a, b)
        valid_rows.extend(valid.sum(1).tolist())
        batches.append(len(a))
        return corres, valid

    engine.predict = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.reset()
    reset_counts()
    loftr.launches = 0
    ms, status = run_tracker(tracker, video, range(TRACK_FRAMES))
    counts = read_counts()
    spans = profiler.stats()
    res = track_result(tracker, video, status)
    n_corres = spans.get("launch/corres", {"count": 0})["count"]
    out = {
        "phase": name, "frames": TRACK_FRAMES, "hw": list(TRACK_HW),
        "config": "default_track_config with feature_corres.matcher loftr, "
                  + (f"loftr_ckpt {os.path.basename(ckpt)}" if ckpt
                     else "seeded random LoFTR weights") + ": no quality limit",
        "track_ms_per_frame_median": float(np.median(ms[TRACK_TIMED])),
        "track_ms_per_frame_max": float(np.max(ms[TRACK_TIMED])),
        "track_ms_per_frame": ms, "loftr_launches": loftr.launches,
        "launch_corres": n_corres, "matcher_batches": batches,
        "valid_matches_per_row_mean": float(np.mean(valid_rows)) if valid_rows else 0.0,
        "corres_span_mean_ms": {k: spans[f"corres/{k}"]["mean_s"] * 1e3
                                for k in ("warp", "match", "ransac") if f"corres/{k}" in spans},
        "n_fail": len(res["fail_frames"]), **res,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "kernel_launches": counts,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    if len(status) != TRACK_FRAMES or loftr.launches != n_corres or n_corres < TRACK_FRAMES - 1:
        raise AssertionError(f"{name}: {len(status)} frames, {loftr.launches} LoFTR "
                             f"launches, {n_corres} matches")
    return out


# ------------------------------------------------ SIFT and remote engines ---

# sift_parity: the port's SIFT on the card against the same code on the CPU
# on the same uint8 crops.  The scale space and the extrema are IEEE adds,
# multiplies and compares, equal on both devices; exp, pow, cos and sin
# differ by an ulp or two between CUDA's and the CPU's vectorised libraries,
# and the histograms' float sums run in another order (atomics on the
# card).  So a keypoint moves only where a decision (an orientation peak at
# the 0.8 bar, a contrast or edge test, the 2000th response) sits within
# ~1e-6 of its bar, and a descriptor element only where it sits within ~1e-4
# of a rounding edge.  The bounds: keypoint recall and precision 0.98 at the
# tests' tolerances (0.01 px, 1e-3 relative size, 0.1 deg, the same octave);
# equal descriptors on 0.90 of the matched keypoints, as against OpenCV
# (tests/test_torch_sift.py); match rows within 0.01 px both ways on 0.95.
SIFT_RESIZE = 400
SIFT_PARITY_PAIRS = 2
SIFT_TIMED_PAIRS = 16
SIFT_KP_MIN = 0.98
SIFT_DESC_EQUAL_MIN = 0.90
SIFT_ROWS_MIN = 0.95
SIFT_PT_TOL, SIFT_SIZE_RTOL, SIFT_ANGLE_TOL = 0.01, 1e-3, 0.1
# the port's MatchServer in a child process, serving the port's SiftMatcher
# on argv[2] until its standard input closes; it prints its port first and
# the count of requests it served last
MATCH_SERVER = r"""
import json, sys
from bundlesdf_tpu_torch.io.remote_matcher import MatchServer
from bundlesdf_tpu_torch.models.matcher import SiftMatcher
server = MatchServer(SiftMatcher(max_matches=int(sys.argv[1]), device=sys.argv[2]),
                     port=0).start()
print(json.dumps({"port": server.port}), flush=True)
sys.stdin.read()
server.stop()
print(json.dumps({"served": server.served}), flush=True)
"""


def sift_crops(video: dict, n: int, device):
    """uint8 crops of ``n`` pairs of the tracking video, (k, k - 1) for
    k = 1.. and then (last, 0), warped to SIFT_RESIZE by process_image_pair
    on ``device`` and truncated to uint8, as SiftMatcher converts them."""
    import torch

    from bundlesdf_tpu_torch.tracking import corres

    frames = video_frames(video, range(TRACK_FRAMES))
    pairs = [(frames[k], frames[k - 1]) for k in range(1, TRACK_FRAMES)]
    pairs.append((frames[-1], frames[0]))
    A, B = [], []
    for fa, fb in pairs[:n]:
        a, b, _, _ = corres.process_image_pair(fa, fb, SIFT_RESIZE, device)
        A.append(a)
        B.append(b)
    return torch.stack(A).to(torch.uint8), torch.stack(B).to(torch.uint8)


def keypoint_sets(ref: dict, got: dict) -> tuple[float, float, float]:
    """Greedy one-to-one keypoint matching under the SIFT_* tolerances:
    (recall, precision, share of matched keypoints with equal
    descriptors)."""
    import numpy as np

    used = np.zeros(len(got["pt"]), bool)
    eq = []
    for i in range(len(ref["pt"])):
        ok = ((np.abs(got["pt"] - ref["pt"][i]).max(axis=1) <= SIFT_PT_TOL)
              & (np.abs(got["size"] - ref["size"][i]) <= SIFT_SIZE_RTOL * ref["size"][i])
              & (np.abs((got["angle"] - ref["angle"][i] + 180) % 360 - 180) <= SIFT_ANGLE_TOL)
              & ((got["octave"] & 255) == (ref["octave"][i] & 255)) & ~used)
        hit = np.nonzero(ok)[0]
        if len(hit):
            used[hit[0]] = True
            eq.append(bool(np.array_equal(ref["desc"][i], got["desc"][hit[0]])))
    n_ref, n_got = len(ref["pt"]), len(got["pt"])
    return (len(eq) / n_ref if n_ref else 1.0, len(eq) / n_got if n_got else 1.0,
            float(np.mean(eq)) if eq else 1.0)


def rows_overlap(ref, got) -> float:
    """Share of the valid ``ref`` match rows with a ``got`` row within
    SIFT_PT_TOL on all four pixel columns (one-to-one)."""
    import numpy as np

    used = np.zeros(len(got), bool)
    hit = 0
    for r in ref:
        i = np.nonzero((np.abs(got[:, :4] - r[:4]).max(axis=1) <= SIFT_PT_TOL) & ~used)[0]
        if len(i):
            used[i[0]] = True
            hit += 1
    return hit / max(len(ref), 1)


def phase_sift_parity(device, video: dict) -> dict:
    """The port's SIFT (ops/sift.py) and SiftMatcher on the card against the
    same code on the CPU, on SIFT_PARITY_PAIRS pairs of the tracking video
    warped to 400 x 400 on the card (the same uint8 crops on both devices):
    keypoint-set recall and precision, the share of equal descriptors and
    the match rows' overlap, each held to its bound.  Then the card's
    SiftMatcher.predict (detection, matching, readback) at batch 1 and 16
    by CUDA events (``event_ms``), ms a pair, detection alone at batch 16,
    and the peak memory of the batch-16 call above what was allocated
    before it."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch.models.matcher import SiftMatcher
    from bundlesdf_tpu_torch.ops import sift

    t_phase = time.perf_counter()
    A, B = sift_crops(video, SIFT_TIMED_PAIRS, device)
    n = SIFT_PARITY_PAIRS
    imgs = torch.cat([A[:n], B[:n]])
    reset_counts()
    feats = {"gpu": sift.detect_and_compute(imgs), "cpu": sift.detect_and_compute(imgs.cpu())}
    counts = read_counts()
    keys = ("pt", "size", "angle", "octave", "desc")
    per_image = []
    for i in range(2 * n):
        side = {}
        for dev, f in feats.items():
            k = int(f["count"][i])
            side[dev] = {key: f[key][i, :k].cpu().numpy() for key in keys}
        rec, prec, deq = keypoint_sets(side["cpu"], side["gpu"])
        per_image.append({"keypoints_cpu": len(side["cpu"]["pt"]),
                          "keypoints_gpu": len(side["gpu"]["pt"]),
                          "recall": rec, "precision": prec, "desc_equal_share": deq})
    gpu_m = SiftMatcher(device=device)
    cpu_m = SiftMatcher(device="cpu")
    cg, vg = gpu_m.predict(A[:n], B[:n])
    t0 = time.perf_counter()
    cc, vc = cpu_m.predict(A[:n].cpu(), B[:n].cpu())
    cpu_predict_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = [{"valid_gpu": int(vg[i].sum()), "valid_cpu": int(vc[i].sum()),
             "cpu_rows_on_gpu": rows_overlap(cc[i][vc[i]], cg[i][vg[i]]),
             "gpu_rows_on_cpu": rows_overlap(cg[i][vg[i]], cc[i][vc[i]])} for i in range(n)]
    times, host, peak = {}, {}, {}
    for nb in (1, SIFT_TIMED_PAIRS):
        a, b = A[:nb], B[:nb]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times[nb], host[nb] = event_ms(lambda: gpu_m.predict(a, b), iters=3, warmup=1)
        peak[nb] = (torch.cuda.max_memory_allocated() - base) / 1e9
    both = torch.cat([A, B])
    detect16 = event_ms(lambda: sift.detect_and_compute(both), iters=3, warmup=1)[0]
    res = {
        "phase": "sift_parity", "resize": SIFT_RESIZE, "parity_pairs": n,
        "config": "cv2.SIFT_create(nfeatures=2000) defaults; SiftMatcher(max_matches=512)",
        "per_image": per_image, "match_rows": rows,
        "min_recall": min(r["recall"] for r in per_image),
        "min_precision": min(r["precision"] for r in per_image),
        "min_desc_equal_share": min(r["desc_equal_share"] for r in per_image),
        "min_rows_overlap": min(min(r["cpu_rows_on_gpu"], r["gpu_rows_on_cpu"]) for r in rows),
        "predict_ms_per_pair": {"batch1": times[1],
                                "batch16": times[SIFT_TIMED_PAIRS] / SIFT_TIMED_PAIRS},
        "predict_ms": {"batch1": times[1], "batch16": times[SIFT_TIMED_PAIRS]},
        "predict_host_ms": {"batch1": host[1], "batch16": host[SIFT_TIMED_PAIRS]},
        "detect_ms_per_image_batch32": detect16 / (2 * SIFT_TIMED_PAIRS),
        "peak_mem_gb_above_base": {"batch1": peak[1], "batch16": peak[SIFT_TIMED_PAIRS]},
        "cpu_predict_ms_per_pair": cpu_predict_ms, "kernel_launches": counts,
        "phase_s": time.perf_counter() - t_phase,
        "limits": {"keypoint_recall_precision": SIFT_KP_MIN,
                   "desc_equal_share": SIFT_DESC_EQUAL_MIN, "rows_overlap": SIFT_ROWS_MIN},
    }
    emit(res)
    if not min(r["keypoints_gpu"] for r in per_image) >= 100:
        raise AssertionError(f"sift_parity: too few keypoints {per_image}")
    if not (res["min_recall"] >= SIFT_KP_MIN and res["min_precision"] >= SIFT_KP_MIN):
        raise AssertionError(f"sift_parity: keypoint sets {per_image}")
    if not res["min_desc_equal_share"] >= SIFT_DESC_EQUAL_MIN:
        raise AssertionError(f"sift_parity: descriptors {per_image}")
    if not (res["min_rows_overlap"] >= SIFT_ROWS_MIN and min(r["valid_gpu"] for r in rows) >= 10):
        raise AssertionError(f"sift_parity: match rows {rows}")
    return res


def phase_tracking_sift(device, video: dict) -> dict:
    """The tracking phase's 16 frames under the shipped tracker config with
    feature_corres.matcher sift (the port's SiftMatcher on the card through
    the host-warp path): 0 FAIL, mean ADD under 1 cm, SIFT at each fresh
    match; per-frame wall time, the corres/* span means, the kernel launch
    counts set to 0 just before and read just after."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.models.matcher import SiftMatcher
    from bundlesdf_tpu_torch.utils import profiler

    t_phase = time.perf_counter()
    cfg = default_track_config()
    cfg["feature_corres"]["matcher"] = "sift"
    tracker = entry.build_tracker(cfg, device=device)
    engine = tracker.bundler.store.matcher
    if not isinstance(engine, SiftMatcher) or engine.device.type != "cuda":
        raise AssertionError(f"tracking_sift: engine {engine}")
    valid_rows, batches = [], []
    predict = engine.predict

    def spy(a, b):
        corres, valid = predict(a, b)
        valid_rows.extend(valid.sum(1).tolist())
        batches.append(len(a))
        return corres, valid

    engine.predict = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.reset()
    reset_counts()
    ms, status = run_tracker(tracker, video, range(TRACK_FRAMES))
    counts = read_counts()
    spans = profiler.stats()
    res = track_result(tracker, video, status)
    n_corres = spans.get("launch/corres", {"count": 0})["count"]
    out = {
        "phase": "tracking_sift", "frames": TRACK_FRAMES, "hw": list(TRACK_HW),
        "config": "default_track_config with feature_corres.matcher sift",
        "track_ms_per_frame_median": float(np.median(ms[TRACK_TIMED])),
        "track_ms_per_frame_max": float(np.max(ms[TRACK_TIMED])),
        "track_ms_per_frame": ms, "launch_corres": n_corres, "matcher_batches": batches,
        "valid_matches_per_row_mean": float(np.mean(valid_rows)) if valid_rows else 0.0,
        "corres_span_mean_ms": {k: spans[f"corres/{k}"]["mean_s"] * 1e3
                                for k in ("warp", "match", "ransac") if f"corres/{k}" in spans},
        "corres_match_total_ms": spans["corres/match"]["total_s"] * 1e3
        if "corres/match" in spans else None,
        "n_fail": len(res["fail_frames"]), **res,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "kernel_launches": counts,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    if res["fail_frames"] or not res["mean_add_m"] < 0.01:
        raise AssertionError(f"tracking_sift: FAIL {res['fail_frames']}, "
                             f"mean ADD {res['mean_add_m']} m")
    if len(batches) != n_corres or n_corres < TRACK_FRAMES - 1:
        raise AssertionError(f"tracking_sift: {len(batches)} SIFT calls, {n_corres} matches")
    return out


def start_match_server(max_matches: int, device: str):
    """Start MATCH_SERVER in a child process; returns it and its port."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", MATCH_SERVER, str(max_matches), device],
                            cwd=root, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line:
        proc.kill()
        proc.wait()
        raise AssertionError(f"match server exited with {proc.returncode} before its port")
    return proc, int(json.loads(line)["port"])


def stop_match_server(proc) -> int:
    """Close the child's standard input, wait for it, return its served
    count."""
    out, _ = proc.communicate(timeout=60)
    if proc.returncode != 0:
        raise AssertionError(f"match server exited with {proc.returncode}")
    return int(json.loads(out.strip().splitlines()[-1])["served"])


def phase_joint_remote(device, video: dict) -> dict:
    """The joint phase's cut (JOINT_FRAMES frames, shipped configs, 100 +
    25-step rounds) with feature_corres.matcher remote: the port's
    MatchServer serves the port's SiftMatcher on the same card from a child
    process, on a free port written into remote_port.  The launch counts
    are set to 0 just before the first frame and read after on_finish: the
    reduce launches twice per NOF step trained; the requests served equal
    the corres/match launches; 0 FAIL, mean ADD under 1 cm, the mesh within
    3 cm of the cube."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_nof_config, default_track_config
    from bundlesdf_tpu_torch.io.remote_matcher import RemoteMatcher
    from bundlesdf_tpu_torch.utils import profiler

    t_phase = time.perf_counter()
    cfg_track = default_track_config()
    proc, port = start_match_server(int(cfg_track["feature_corres"]["max_matches_per_pair"]),
                                    "cuda" if torch.device(device).type == "cuda" else "cpu")
    server_up_s = time.perf_counter() - t_phase
    try:
        cfg_track["feature_corres"]["matcher"] = "remote"
        cfg_track["feature_corres"]["remote_port"] = port
        cfg_nof = default_nof_config()
        cfg_nof.update(JOINT_DEPTH)
        pipe = entry.build_pipeline(cfg_track, cfg_nof, start_nerf_keyframes=JOINT_START,
                                    device=device)
        engine = pipe.bundler.store.matcher
        if not isinstance(engine, RemoteMatcher):
            raise AssertionError(f"joint_remote: engine {engine}")
        rounds = count_rounds(pipe)
        steps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiler.reset()
        reset_counts()
        with count_train_steps(steps):
            ms, status = run_tracker(pipe, video, range(JOINT_FRAMES))
            mesh = pipe.on_finish()
            torch.cuda.synchronize()
        counts = read_counts()
        graph = read_graph_counts()
        spans = profiler.stats()
        engine.close()
        served = stop_match_server(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    res = track_result(pipe, video, status)
    n_steps = sum(steps)
    n_corres = spans.get("launch/corres", {"count": 0})["count"]
    nerfed = [f.id for f in pipe.bundler.keyframes if f.nerfed]
    surf = (cube_surface_dist(mesh, pipe, video["gt"][0], 0.15)
            if mesh is not None and len(mesh.vertices) else None)
    out = {
        "phase": "joint_remote", "frames": JOINT_FRAMES, "hw": list(TRACK_HW),
        "config": "default_track_config with feature_corres.matcher remote (the port's "
                  "MatchServer serving SiftMatcher on the same card, another process), "
                  "default_nof_config with " + json.dumps(JOINT_DEPTH) + " (depth cut)",
        "start_nerf_keyframes": JOINT_START, "server_up_s": server_up_s,
        "frame_ms_median": float(np.median(ms)), "frame_ms_max": float(np.max(ms)),
        "frame_ms": ms, "rounds": rounds, "steps_trained": n_steps,
        "requests_served": served, "launch_corres": n_corres,
        "corres_span_mean_ms": {k: spans[f"corres/{k}"]["mean_s"] * 1e3
                                for k in ("warp", "match", "ransac") if f"corres/{k}" in spans},
        "nerfed": nerfed, "n_keyframes": len(res["keyframes"]),
        "n_fail": len(res["fail_frames"]), **res,
        "mesh_vertices": len(mesh.vertices) if mesh is not None else 0,
        "mesh_surface_dist_median_m": surf,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "kernel_launches": counts, "graph": graph, "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    if res["fail_frames"] or not res["mean_add_m"] < 0.01:
        raise AssertionError(f"joint_remote: FAIL {res['fail_frames']}, "
                             f"mean ADD {res['mean_add_m']} m")
    if served != n_corres or n_corres < JOINT_FRAMES - 1:
        raise AssertionError(f"joint_remote: {served} requests served, {n_corres} matches")
    if not rounds or not nerfed:
        raise AssertionError(f"joint_remote: no completed NOF round ({rounds}, {nerfed})")
    if mesh is None or len(mesh.vertices) <= 50 or surf is None or not surf < 0.03:
        raise AssertionError(f"joint_remote: mesh {out['mesh_vertices']} vertices, "
                             f"median surface distance {surf}")
    if n_steps == 0:
        raise AssertionError("joint_remote: no NOF step trained")
    check_graph_counts("joint_remote", graph, counts, n_steps, {"reduce_cell_cache_grad": 2})
    return out


# LoFTR trainer, card against CPU (loftr_train): one step's loss (relative)
# and each leaf's gradient (relative L2) from one state dict on one batch,
# f32 with TF32 off.  The gradient bound sits above the step's own f32
# floor: on the CPU its f32 gradients differ from its f64 ones by up to
# 1.28e-3 relative L2 (the transformers' q/k/v and merge weights;
# tests/port_loftr_f32_floor.py).  At the random init the GT cells'
# dual-softmax confidences sit near the focal loss's 1e-6 clip (median
# 3.4e-5, 79 of 1,418 under it), where the positive term's gradient goes as
# 1/conf.
LOFTR_TRAIN_LOSS_RTOL = 1e-4
LOFTR_TRAIN_GRAD_RTOL = 5e-3
LOFTR_TRAIN_STEPS = 100    # 200 until synth_eval and the joint dp phases came
# cuBLAS's setting that torch.use_deterministic_algorithms asks for
CUBLAS_DETERMINISTIC = ":4096:8"


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms with cuBLAS's setting for it, for
    the block."""
    import torch

    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
# how many of the first and last steps' losses are averaged to show the fall
LOFTR_TRAIN_LOSS_WINDOW = 20


def _loftr_grads(module) -> dict:
    return {n: p.grad.detach().cpu() for n, p in module.named_parameters()} | {
        n: b.grad.detach().cpu() for n, b in module.named_buffers() if b.grad is not None}


def phase_loftr_train(device, video: dict, root: str) -> dict:
    """The LoFTR trainer (models/loftr_train.py) at TrainCfg() (160 x 160
    pairs, batch 8, max_gt 256) and full LoftrCfg() width, TF32 off (main):

    * one step on the card against the CPU: one seeded state dict, one
      homography batch, the loss and every leaf's gradient (the BatchNorm
      running statistics included: the trainer differentiates them);
    * train_loftr from the seeded init for LOFTR_TRAIN_STEPS steps on the
      card under torch.use_deterministic_algorithms: the loss over the first
      and last LOFTR_TRAIN_LOSS_WINDOW steps (it must fall), ms a step, peak
      memory, then 20 more steps in the default algorithms timed piece by
      piece with CUDA events (batch generation, forward, backward,
      optimizer).  Deterministic, because the default algorithms'
      unordered reductions make every run another draw of a recipe (the JAX trainer's: lr 1e-3
      after a 50-step warmup) that collapses in some: every GT cell's
      confidence pinned at the focal loss's 1e-6 clip, where its gradient
      is 0 (tests/port_loftr_train_probe.py, PERF.md section 7).  One seed then
      gives one curve on every card of a kind;
    * the saved file through load_checkpoint (equal to the trained weights),
      and the tracking video with matcher loftr on those weights (tracking_loftr_trained: valid matches
      a pair and FAILs, no quality limit: LOFTR_TRAIN_STEPS steps are not
      expected to track);
    * the CLI, python3 -m bundlesdf_tpu_torch.models.loftr_train --steps 5
      --out, in a subprocess."""
    import io

    import numpy as np
    import torch

    from bundlesdf_tpu_torch.models import loftr
    from bundlesdf_tpu_torch.models import loftr_train as lt

    t_phase = time.perf_counter()
    tcfg = lt.TrainCfg()
    os.makedirs(root, exist_ok=True)
    # (1) one step, card against CPU
    cpu = loftr.init_weights(loftr.LoftrModule(), seed=0).train()
    gpu = loftr.load_weights(loftr.LoftrModule(), cpu.state_dict()).to(device).train()
    batch = lt.make_batch(tcfg.batch, tcfg.H, tcfg.W, tcfg.max_gt,
                          generator=torch.Generator().manual_seed(1), device="cpu")
    losses = {}
    for name, m, dev in (("gpu", gpu, device), ("cpu", cpu, "cpu")):
        lt.trainable(m)
        loss, aux = lt.make_loss_fn(m, tcfg)(lt.HomographyBatch(*(t.to(dev) for t in batch)))
        with loftr._without_cudnn():
            loss.backward()
        losses[name] = {"loss": float(loss.detach()),
                        **{k: float(v.detach()) for k, v in aux.items()}}
    gg, gc = _loftr_grads(gpu), _loftr_grads(cpu)
    grad_err = {k: rel_l2(gg[k], gc[k]) for k in gc}
    loss_rel = abs(losses["gpu"]["loss"] - losses["cpu"]["loss"]) / abs(losses["cpu"]["loss"])
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
    del cpu, gpu

    # (2) train_loftr on the card
    path = os.path.join(root, "loftr_trained.pth")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with deterministic_algorithms(), contextlib.redirect_stdout(io.StringIO()):
        module, hist = lt.train_loftr(tcfg=tcfg, n_steps=LOFTR_TRAIN_STEPS, seed=0,
                                      log_every=1, save_path=path, device=None)
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    curve = [h["loss"] for h in hist]
    w = LOFTR_TRAIN_LOSS_WINDOW
    first, last = float(np.mean(curve[:w])), float(np.mean(curve[-w:]))
    m = loftr.load_checkpoint(path, device=device)
    same = all(torch.equal(m.module.state_dict()[k].cpu(), v.cpu())
               for k, v in module.state_dict().items())
    del m
    # 20 more steps, piece by piece (timing only; the file is saved)
    opt = lt.LoftrOptimizer(lt.trainable(module), tcfg, 20)
    loss_fn = lt.make_loss_fn(module, tcfg)
    gen = torch.Generator(device=device).manual_seed(7)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(20)]
    for e in ev:
        e[0].record()
        b = lt.make_batch(tcfg.batch, tcfg.H, tcfg.W, tcfg.max_gt, generator=gen,
                          device=device)
        e[1].record()
        opt.zero_grad()
        loss, _ = loss_fn(b)
        e[2].record()
        with loftr._without_cudnn():
            loss.backward()
        e[3].record()
        opt.step()
        e[4].record()
    torch.cuda.synchronize()
    split = {k: float(np.median([e[j].elapsed_time(e[j + 1]) for e in ev[3:]]))
             for j, k in enumerate(("batch_ms", "forward_ms", "backward_ms", "optimizer_ms"))}

    # (3) track with the saved file
    del module
    track = phase_tracking_loftr(video, ckpt=path, name="tracking_loftr_trained")

    # (4) the CLI
    cli_out = os.path.join(root, "loftr_cli.pth")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "bundlesdf_tpu_torch.models.loftr_train",
                           "--steps", "5", "--out", cli_out, "--log_every", "1"],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    cli_ok = proc.returncode == 0 and os.path.exists(cli_out)
    if cli_ok:
        loftr.load_checkpoint(cli_out, device=device)

    res = {"phase": "loftr_train", "train_cfg": tcfg._asdict(),
           "config": "LoftrCfg() (full width), seeded init, homography batches",
           "step_loss_gpu_cpu": losses, "step_loss_rel_err": loss_rel,
           "step_grad_rel_l2_max": max(grad_err.values()), "step_grad_rel_l2_worst": worst,
           "leaves": len(grad_err),
           "limits": {"loss_rel": LOFTR_TRAIN_LOSS_RTOL, "grad_rel_l2": LOFTR_TRAIN_GRAD_RTOL},
           "steps": LOFTR_TRAIN_STEPS, "deterministic": True,
           "loss_first_mean": first, "loss_last_mean": last,
           "loss_window": w, "loss_curve_every_20": curve[::20] + [curve[-1]],
           "train_s": train_s, "ms_per_step": train_s * 1e3 / LOFTR_TRAIN_STEPS,
           "piece_ms_median": split, "peak_mem_gb": peak,
           "saved_equals_loaded": same, "tracking_valid_matches_per_row_mean":
               track["valid_matches_per_row_mean"], "tracking_n_fail": track["n_fail"],
           "cli_returncode": proc.returncode, "cli_s": cli_s,
           "cli_tail": (proc.stdout + proc.stderr)[-600:],
           "kernel_launches": track["kernel_launches"],
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    if not loss_rel <= LOFTR_TRAIN_LOSS_RTOL or not max(grad_err.values()) <= LOFTR_TRAIN_GRAD_RTOL:
        raise AssertionError(f"loftr_train: card against CPU: loss {loss_rel}, grads {worst}")
    if not last < first:
        raise AssertionError(f"loftr_train: loss did not fall: {first} -> {last}")
    if not same or not cli_ok:
        raise AssertionError(f"loftr_train: saved == loaded {same}, CLI {proc.returncode}")
    return res


@contextlib.contextmanager
def jolt_first_round(log: list):
    """Move keyframe 1 by JOLT_M in the first NOF round's exported poses,
    and record each round's pose updates (before the jolt) against the
    keyframes' tracked poses.  On the cube the NOF's own corrections stay
    under the 5 mm / 5 deg rematch gate (tests/test_torch_pipeline.py), so
    the jolt is what makes a keyframe cross it."""
    import numpy as np

    from bundlesdf_tpu_torch.nof import runner

    orig = runner.NofRunner.get_optimized_poses_in_real_world

    def jolted(self):
        poses, offset = orig(self)
        log.append(poses)
        if len(log) == 1 and len(poses) > 1:
            poses = poses.copy()
            poses[1, :3, 3] += np.float32(JOLT_M)
        return poses, offset

    runner.NofRunner.get_optimized_poses_in_real_world = jolted
    try:
        yield
    finally:
        runner.NofRunner.get_optimized_poses_in_real_world = orig


def phase_joint_rematch(device, video: dict) -> dict:
    """The joint phase's cut (JOINT_FRAMES frames, 100 + 25-step rounds,
    shipped configs) with feature_corres.rematch_after_nerf True and
    keyframe 1 jolted by JOLT_M in the first round's poses: the keyframes
    the feedback invalidated, the pairs re-gated from their raw tables
    (each host-path call takes raw-table pairs only, with RANSAC launches
    and no matcher launch), 0 FAIL, mean ADD under 1 cm and the reduce
    launched twice per NOF step trained."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_nof_config, default_track_config
    from bundlesdf_tpu_torch.tracking import corres
    from bundlesdf_tpu_torch.utils import profiler, se3

    t_phase = time.perf_counter()
    cfg_nof = default_nof_config()
    cfg_nof.update(JOINT_DEPTH)
    cfg_track = default_track_config()
    cfg_track["feature_corres"]["rematch_after_nerf"] = True
    pipe = entry.build_pipeline(cfg_track, cfg_nof, start_nerf_keyframes=JOINT_START,
                                device=device)
    invalidated, regates, exported, steps = [], [], [], []
    store = pipe.bundler.store
    invalidate = store.invalidate_matches

    def spy_invalidate(fid):
        invalidated.append([pipe.cnt, fid])
        return invalidate(fid)

    store.invalidate_matches = spy_invalidate
    legacy = corres._find_corres_legacy

    def spy_legacy(st, pairs, *args, **kw):
        n_raw = sum((fa.id, fb.id) in st.raw for fa, fb in pairs)
        before = profiler.stats().get("launch/corres", {"count": 0})["count"]
        out = legacy(st, pairs, *args, **kw)
        after = profiler.stats().get("launch/corres", {"count": 0})["count"]
        regates.append({"frame": pipe.cnt, "pairs": [[fa.id, fb.id] for fa, fb in pairs],
                        "raw": n_raw, "matcher_launches": after - before})
        return out

    corres._find_corres_legacy = spy_legacy
    rounds = []
    feedback = pipe._apply_nof_feedback

    def spy_feedback():
        # this round's exported poses before the jolt, against the tracked ones
        t, r = [], []
        for kf, p in zip(pipe.bundler.keyframes, exported[-1]):
            t.append(float(np.linalg.norm(p[:3, 3] - kf.pose_in_model[:3, 3])))
            r.append(float(np.degrees(se3.rotation_geodesic_distance_np(
                p[:3, :3].astype(np.float64), kf.pose_in_model[:3, :3].astype(np.float64)))))
        rounds.append({"frame": pipe.cnt, "max_t_update_m": max(t), "max_r_update_deg": max(r),
                       "over_gate": [kf.id for kf, a, b in zip(pipe.bundler.keyframes, t, r)
                                     if a >= 0.005 or b >= 5.0]})
        return feedback()

    pipe._apply_nof_feedback = spy_feedback
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.reset()
    reset_counts()
    try:
        with count_train_steps(steps), jolt_first_round(exported):
            ms, status = run_tracker(pipe, video, range(JOINT_FRAMES))
            pipe.on_finish()
    finally:
        corres._find_corres_legacy = legacy
    counts = read_counts()
    graph = read_graph_counts()
    spans = profiler.stats()
    res = track_result(pipe, video, status)
    n_steps = sum(steps)
    n_ransac = spans.get("launch/ransac", {"count": 0})["count"]
    out = {
        "phase": "joint_rematch", "frames": JOINT_FRAMES, "hw": list(TRACK_HW),
        "config": "default_track_config with rematch_after_nerf True, default_nof_config "
                  "with " + json.dumps(JOINT_DEPTH) + f" (depth cut); keyframe 1 moved "
                  f"{JOLT_M} m in the first round's exported poses",
        "frame_ms_median": float(np.median(ms)), "frame_ms_max": float(np.max(ms)),
        "invalidated_frame_kf": invalidated, "regate_calls": regates,
        "pairs_regated": sum(r["raw"] for r in regates),
        "launch_ransac": n_ransac,
        "launch_corres": spans.get("launch/corres", {"count": 0})["count"],
        "launch_fused_match_ba": spans.get("launch/fused_match_ba", {"count": 0})["count"],
        "launch_ba": spans.get("launch/ba", {"count": 0})["count"],
        "nof_rounds": len(exported), "steps_trained": n_steps,
        "round_pose_updates_before_jolt": rounds,
        "n_fail": len(res["fail_frames"]), **res,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "kernel_launches": counts, "graph": graph,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    if res["fail_frames"] or not res["mean_add_m"] < 0.01:
        raise AssertionError(f"joint_rematch: FAIL {res['fail_frames']}, "
                             f"mean ADD {res['mean_add_m']} m")
    if not invalidated or not regates or n_ransac <= 0:
        raise AssertionError(f"joint_rematch: invalidated {invalidated}, re-gates {regates}")
    if any(r["raw"] != len(r["pairs"]) or r["matcher_launches"] for r in regates):
        raise AssertionError(f"joint_rematch: a host-path call ran the matcher: {regates}")
    if n_steps == 0:
        raise AssertionError("joint_rematch: no NOF step trained")
    check_graph_counts("joint_rematch", graph, counts, n_steps, {"reduce_cell_cache_grad": 2})
    return out


# --------------------------------------------------------- global refine ---

def shared_nof_draws(n_rand: int, n_samples: int, n_around: int):
    """NOF step draws that do not depend on the device: a CPU generator
    seeded with the step (the runner moves them to its device)."""
    import torch

    from bundlesdf_tpu_torch.nof.render import SampleDraws

    def draws(step: int, n_rays: int):
        g = torch.Generator().manual_seed(1000 + step)
        idx = torch.randint(0, n_rays, (n_rand,), generator=g)
        return idx, SampleDraws(*(torch.rand((n_rand, k), generator=g)
                                  for k in (n_samples, n_around, n_around)))

    return draws


def sphere_frames():
    """tests/test_pipeline.py:157-177: 4 views of 32 x 32 of the analytic
    sphere as saved-frame dicts."""
    import numpy as np

    sys.path.insert(0, _tests_dir())
    from synthetic import make_sphere_dataset

    from bundlesdf_tpu_torch.utils.geometry import GLCAM_IN_CVCAM

    data = make_sphere_dataset(n_views=4, H=32, W=32)
    frames = [{"color": (data["images"][i] * 255).astype(np.uint8),
               "depth": data["depths"][i],
               "mask": (data["masks"][i] > 0).astype(np.uint8) * 255,
               "cam_in_ob": data["poses"][i] @ np.linalg.inv(GLCAM_IN_CVCAM)}
              for i in range(4)]
    return data, frames


def mesh_dist(a, b) -> float:
    """Symmetric largest nearest-vertex distance between two meshes."""
    from scipy.spatial import cKDTree

    return float(max(cKDTree(a.vertices).query(b.vertices)[0].max(),
                     cKDTree(b.vertices).query(a.vertices)[0].max()))


def phase_global_refine_small_parity(device) -> dict:
    """run_global_nerf on the card against the CPU: the sphere and
    cfg_refine of tests/test_pipeline.py:157-193 with n_step 150 -> 30, the
    same initial weights (init_nof_params draws on the CPU) and step draws,
    the texture bake on.  Refined poses within 1e-4, mesh vertex counts
    within 1% and within a tenth of a marching voxel of each other.  Then
    one mesh (the CPU's) on both devices: the rasterizer (coverage, face
    ids, depth) and the texel bake (same UVs, texels within 1 on all but
    0.1%)."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch.config import default_nof_config, default_track_config
    from bundlesdf_tpu_torch.nof import texture
    from bundlesdf_tpu_torch.ops import raster
    from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

    data, frames = sphere_frames()
    out = {}
    for name, dev in (("cpu", "cpu"), ("gpu", device)):
        pipe = BundleSdf(cfg_track=default_track_config(), use_nof=False, device=dev,
                         nof_draws=shared_nof_draws(REFINE_SMALL["N_rand"],
                                                    REFINE_SMALL["N_samples"],
                                                    REFINE_SMALL["N_samples_around_depth"]))
        pipe.K = data["K"]
        mesh, poses = pipe.run_global_nerf(
            frames, cfg_refine=default_nof_config().merged(REFINE_SMALL), get_texture=True)
        out[name] = (pipe, mesh, poses)
    (pc, mc, qc), (pg, mg, qg) = out["cpu"], out["gpu"]
    # one mesh, both devices
    ob_in_cam = np.linalg.inv(frames[1]["cam_in_ob"])
    rc = [t.cpu().numpy() for t in raster.rasterize(mc.vertices, mc.faces, data["K"],
                                                     ob_in_cam, 32, 32, device="cpu")]
    rg = [t.cpu().numpy() for t in raster.rasterize(mc.vertices, mc.faces, data["K"],
                                                     ob_in_cam, 32, 32, device=device)]
    both = (rc[1] >= 0) & (rg[1] >= 0)
    rgbs = np.stack([f["color"] for f in frames]).astype(np.float32) / 255.0
    depths = np.stack([f["depth"] for f in frames]).astype(np.float32)
    masks = np.stack([f["mask"] for f in frames]).astype(np.float32)
    cams = np.stack([f["cam_in_ob"] for f in frames])
    bc, tc = texture.bake_texture_from_train_images(mc, rgbs, depths, masks, cams,
                                                    data["K"], device="cpu")
    bg, tg = texture.bake_texture_from_train_images(mc, rgbs, depths, masks, cams,
                                                    data["K"], device=device)
    tex_off = float((np.abs(tg.astype(int) - tc).max(-1) > 1).mean())
    res = {"phase": "global_refine_small_parity", "views": 4, "hw": [32, 32],
           "config": "tests/test_pipeline.py cfg_refine, n_step 150 -> 30",
           "max_pose_diff": float(np.abs(qg - qc).max()),
           "mesh_vertices_gpu_cpu": [len(mg.vertices), len(mc.vertices)],
           "mesh_dist_m": mesh_dist(mg, mc), "voxel_m": REFINE_SMALL["mesh_resolution"],
           "atlas_gpu_cpu": [mg.atlas, mc.atlas],
           "pool_rows_equal": bool(np.array_equal(pg.global_nof.rays_np, pc.global_nof.rays_np)),
           "raster_coverage_mismatch": int(((rc[1] >= 0) != (rg[1] >= 0)).sum()),
           "raster_face_mismatch": int((rc[1] != rg[1])[both].sum()),
           "raster_covered": int(both.sum()),
           "raster_depth_max_rel": float((np.abs(rg[0] - rc[0])[both] / rc[0][both]).max()),
           "bake_uv_equal": bool(np.array_equal(bg.face_uv, bc.face_uv, equal_nan=True)),
           "bake_texel_share_off_by_more_than_1": tex_off,
           "bake_baked_texels": int((tc != 128).any(-1).sum())}
    emit(res)
    if not res["pool_rows_equal"] or not res["max_pose_diff"] <= 1e-4:
        raise AssertionError(f"global_refine_small_parity: poses differ by "
                             f"{res['max_pose_diff']}, pools equal {res['pool_rows_equal']}")
    nv = res["mesh_vertices_gpu_cpu"]
    if not (nv[1] > 100 and abs(nv[0] - nv[1]) <= 0.01 * nv[1]
            and res["mesh_dist_m"] <= 0.1 * REFINE_SMALL["mesh_resolution"]):
        raise AssertionError(f"global_refine_small_parity: meshes {nv}, {res['mesh_dist_m']} m")
    if (res["raster_coverage_mismatch"] + res["raster_face_mismatch"]
            > 0.005 * res["raster_covered"] or res["raster_depth_max_rel"] > 1e-5):
        raise AssertionError(f"global_refine_small_parity: rasterizer {res}")
    if not res["bake_uv_equal"] or tex_off > 1e-3 or res["bake_baked_texels"] == 0:
        raise AssertionError(f"global_refine_small_parity: bake {res}")
    return res


def offline_levels() -> list:
    """Resolutions of the offline budget's bf16-staged levels (one reduce
    launch each per microbatch)."""
    import torch

    from bundlesdf_tpu_torch.config import default_nof_config
    from bundlesdf_tpu_torch.ops import hashgrid

    cfg = default_nof_config()
    spec = hashgrid.HashGridSpec(16, cfg["feature_grid_dim"], cfg["base_res"], 256,
                                 cfg["log2_hashmap_size"], layout="cell",
                                 big_dtype=cfg["hash_big_dtype"])
    return [p["res"] for p in spec.level_params()
            if hashgrid._lvl_dtype(spec, p) == torch.bfloat16]


def phase_global_refine(device, joint_pipe, video: dict, out_dir: str):
    """The offline global refinement at full width: entry.run_global_refine
    on the joint phase's trail (its 12 keyframes, the online normalization
    from config_nerf.yml, K from cam_K.txt) under the shipped offline merge
    of run_global_nerf (2048 rays x (64 + 256) samples, 16 levels 16 -> 256,
    log2 table 22, bf16 big levels, frame_features 2, rgb_weight 100,
    loop_chunk 10, hash_reduce auto), n_step 2000 -> GLOBAL_STEPS, texture
    bake on.  The launch counts are set to 0 just before and read just
    after; the reduce must launch 5 x microbatches x steps.  Then one more
    step (outside the counted run) records the reduce's inputs: each of the
    5 shapes is held against the plain reduce and timed.  A refined
    keyframe FAILs when its pose is not finite or its ADD exceeds the AUC's
    10 cm."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.nof.texture import load_textured_obj
    from bundlesdf_tpu_torch.ops import reduce_cuda
    from bundlesdf_tpu_torch.pipeline.artifacts import load_keyframes_yml
    from bundlesdf_tpu_torch.utils import metrics, profiler

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.reset()
    reset_counts()
    t0 = time.perf_counter()
    pipe, mesh, poses = entry.run_global_refine(out_dir, refine_steps=GLOBAL_STEPS,
                                                get_texture=True, device=device)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    graph = read_graph_counts()
    spans = profiler.stats()
    peak = torch.cuda.max_memory_allocated() / 1e9
    nof = pipe.global_nof
    mb = nof.statics.microbatch
    n_chunks = nof.statics.n_rand // mb if mb else 1
    bf16 = offline_levels()

    # steady replays (step_ms averages the capture in) and eager steps on
    # the same runner, timed one after the other
    timed = {}
    for mode in ("replay", "eager"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        nof._run_chunk(GLOBAL_EAGER_STEPS, eager=mode == "eager")
        torch.cuda.synchronize()
        timed[mode] = (time.perf_counter() - t1) * 1e3 / GLOBAL_EAGER_STEPS
    red_calls = []
    with record_calls(reduce_cuda, "reduce_cell_cache_grad", red_calls):
        nof._run_chunk(1, eager=True)
    torch.cuda.synchronize()
    rows = [check_reduce(d.contiguous(), R, C, size) for d, R, C, size in red_calls[:len(bf16)]]

    kf = [int(k) for k in sorted(load_keyframes_yml(out_dir))]
    gts = np.stack([video["gt"][k] for k in kf])
    preds = np.linalg.inv(poses.astype(np.float64))
    res = metrics.trajectory_add_auc(preds, gts, video["model_pts"])
    fail = [k for k, e, p in zip(kf, res["add_errs"], poses)
            if not (np.isfinite(p).all() and e <= 0.1)]
    back, tex = load_textured_obj(os.path.join(out_dir, "textured_mesh.obj"))
    surf = cube_surface_dist(mesh, joint_pipe, video["gt"][0], 0.15)

    def span_ms(name):
        st = spans.get(name)
        return None if st is None else {"mean_ms": st["mean_s"] * 1e3, "count": st["count"]}

    out = {
        "phase": "global_refine", "keyframes": kf, "hw": list(TRACK_HW),
        "config": "default_nof_config with the online normalization of "
                  "config_nerf.yml and run_global_nerf's offline merge (n_step 2000 -> "
                  f"{GLOBAL_STEPS}, depth cut)",
        "n_rand": nof.statics.n_rand,
        "samples_per_ray": nof.rcfg.n_samples + nof.rcfg.n_samples_around_depth,
        "level_res": [p["res"] for p in nof.spec.grid.level_params()],
        "level_dense": [p["dense"] for p in nof.spec.grid.level_params()],
        "bf16_levels": bf16, "hash_reduce": nof.spec.grid.reduce,
        "hash_scatter": nof.spec.grid.scatter, "frame_features": nof.spec.frame_features,
        "microbatch": mb, "microbatches_per_step": n_chunks,
        "steps": nof.total_step - 1 - 2 * GLOBAL_EAGER_STEPS, "sc_factor": nof.cfg["sc_factor"],
        "ray_pool_rows": len(nof.rays_np), "occ_resolution": nof.occ_resolution,
        "step_ms": spans["nof/train"]["total_s"] * 1e3 / GLOBAL_STEPS,
        "step_ms_replayed_steady": timed["replay"], "step_ms_eager": timed["eager"],
        "steps_timed_each": GLOBAL_EAGER_STEPS,
        "capture_ms": span_ms("nof/capture"),
        "graph": graph, "graph_stats": nof.graph_stats(),
        "wall_s": wall_s,
        "spans": {k: span_ms(k) for k in ("nof/scene_bounds", "nof/create_runner", "nof/capture",
                                          "nof/build_rays", "nof/build_occupancy",
                                          "nof/upload_rays", "nof/train",
                                          "nof/extract_mesh", "texture/bake")},
        "kernel_launches": counts,
        "reduce_per_step_expected": len(bf16) * n_chunks,
        "reduce_in_situ": rows,
        "mesh_vertices": len(mesh.vertices), "mesh_faces": len(mesh.faces),
        "mesh_surface_dist_median_m": surf,
        "n_fail": len(fail), "fail_keyframes": fail,
        "mean_add_m": res["mean_add"], "mean_adds_m": res["mean_adds"],
        "max_add_m": float(res["add_errs"].max()), "add_auc": res["add_auc"],
        "atlas": mesh.atlas, "tex_size": int(tex.shape[0]),
        "texels_baked_share": float((tex != 128).any(-1).mean()),
        "obj_read_back": {"faces": len(back.faces), "vertices": len(back.vertices),
                          "texture_equal": bool(np.array_equal(tex, pipe.texture)),
                          "uv_equal": bool(np.allclose(back.face_uv, mesh.face_uv,
                                                       atol=1e-9, equal_nan=True))},
        "files": sorted(f for f in os.listdir(out_dir) if "." in f),
        "peak_mem_gb": peak,
    }
    emit(out)
    if bf16 != [71, 85, 102, 123, 148]:
        raise AssertionError(f"global_refine: bf16 levels {bf16}")
    check_graph_counts("global_refine", graph, counts, GLOBAL_STEPS,
                       {"reduce_cell_cache_grad": len(bf16) * n_chunks})
    if len(red_calls) != len(bf16) * n_chunks or [r["R"] for r in rows] != bf16:
        raise AssertionError(f"global_refine: one step launched {len(red_calls)} reduces")
    if any(r["max_abs_err"] != 0.0 for r in rows):
        raise AssertionError(f"global_refine: the reduce is not bitwise equal to the plain "
                             f"one: {[r['max_abs_err'] for r in rows]}")
    if fail or not res["mean_add"] < 0.01:
        raise AssertionError(f"global_refine: FAIL {fail}, mean ADD {res['mean_add']} m")
    if not (len(mesh.vertices) > 50 and surf < 0.03):
        raise AssertionError(f"global_refine: mesh {len(mesh.vertices)} vertices, "
                             f"median surface distance {surf}")
    if not (out["obj_read_back"]["texture_equal"] and out["obj_read_back"]["uv_equal"]
            and len(back.faces) == len(mesh.faces) and out["texels_baked_share"] > 0):
        raise AssertionError(f"global_refine: textured OBJ {out['obj_read_back']}")
    return out, nof


def profile_global(nof, step_ms: float, out_dir: str) -> dict:
    """torch.profiler over one more offline step of the global refinement's
    runner: device time by kernel and the device's idle share of the
    phase's ``step_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nof.train(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, total = device_rows(prof, 1, "global_step", out_dir, "step")
    return {"phase": "profile_global_step", "device_ms_per_step": total,
            "device_kernels_per_step": sum(r["calls_per_step"] for r in rows),
            "timed_step_ms": step_ms, "device_idle_share": 1.0 - total / step_ms,
            "profiled_wall_ms_per_step": wall_ms, "top": rows[:25]}



# ------------------------------------------------------------ user scripts ---

# The scripts' phases at full width: the first CLI_FRAMES frames of the
# tracking video (at the shipped start_nerf_keyframes 5 they give 2 NOF
# rounds of the shipped 500 steps), and the offline refinement cut to
# CLI_REFINE_STEPS steps.
CLI_FRAMES = 6
CLI_REFINE_STEPS = 10
# The HO3D phase's JPEG quality (4:2:0, Annex K tables scaled as libjpeg's
# quality setting does).
HO3D_JPEG_QUALITY = 90
HO3D_DEPTH_SCALE = 0.00012498664727900177  # Ho3dReader.DEPTH_SCALE
# Limits of the HO3D phase.  PSNR: quality 90 at 4:2:0 keeps a rendered
# frame well above 30 dB.  ADD AUC (percent, to 10 cm): 90 is a mean ADD
# near 1 cm, the limit of every other phase.  Chamfer (cm) to the visible
# shell after ICP: the online mesh lies ~3.5 mm from the cube (joint), and
# the chamfer also charges the shell's rim that the mesh's crop and
# marching grid (1 cm voxels in the field's units) leave out; 2 cm.
HO3D_PSNR_DB = 30.0
# The visible shell's faces: those some frame views at under 80 degrees from
# the view ray.  On the tracking video's first 6 frames one more face of the
# cube is front-facing, at 88-89 degrees in every frame; the depth pipeline
# keeps none of it, and counting it would charge a perfect reconstruction of
# the two faces seen 1.86 cm of chamfer (0.24 cm without it).
SHELL_MAX_INCIDENCE_DEG = 80.0
HO3D_ADD_AUC = 90.0
HO3D_CHAMFER_CM = 2.0


def jpeg_encode(rgb, quality: int = HO3D_JPEG_QUALITY, progressive: bool = False,
                arithmetic: bool = False) -> bytes:
    """The HO3D phase's JPEG encoder, a fixture as tests/synthetic_cube.py is
    one (tests/port_codecs.py::encode_jpeg): JFIF YCbCr, chroma 4:2:0 by
    2 x 2 means, a float DCT, the Annex K quantization tables scaled to
    ``quality`` as libjpeg scales them, optimal Huffman tables; one
    interleaved baseline scan, or with ``progressive`` the same quantized
    coefficients as libjpeg's simple progression (spectral selection and
    successive approximation, 10 scans).  ``arithmetic`` codes the same
    coefficients with the QM coder (SOF9 with a DAC segment and a restart
    every MCU row, or SOF10).  (H, W, 3) uint8 RGB -> bytes."""
    sys.path.insert(0, _tests_dir())
    from port_codecs import SIMPLE_PROGRESSION, encode_jpeg

    sequential_arith = arithmetic and not progressive
    return encode_jpeg(rgb, [(2, 2), (1, 1), (1, 1)],
                       SIMPLE_PROGRESSION if progressive else None, progressive, quality,
                       restart=-(-rgb.shape[1] // 16) if sequential_arith else 0,
                       arithmetic=arithmetic,
                       dac=ARITH_DAC if sequential_arith else None)


# The arithmetic-coded HO3D frames' conditioning: DC tables (L, U), AC Kx.
ARITH_DAC = {(0, 0): (1, 3), (0, 1): (0, 2), (1, 0): 8, (1, 1): 3}
# The lossless HO3D frames' predictors, frame by frame: one of each way the
# decoder undifferences (a prefix sum, a numpy step a row, a sample loop).
LOSSLESS_PREDICTORS = (1, 5, 7)


def ho3d_jpeg(rgb, k: int, kind: str) -> bytes:
    """Frame ``k`` of an HO3D folder as a JPEG of ``kind`` (baseline or one
    of CODEC_FRAMES): jpeg_encode's baseline, progressive or arithmetic
    files of the same coefficients, or a lossless file (tests/port_codecs.py
    ::write_lossless_jpeg, 3 components, no marker: RGB as stored) of the
    baseline file's decode, predictor LOSSLESS_PREDICTORS by frame, a
    restart every 60 rows."""
    if kind != "lossless":
        return jpeg_encode(rgb, progressive=kind.endswith("progressive"),
                           arithmetic=kind.startswith("arithmetic"))
    sys.path.insert(0, _tests_dir())
    from port_codecs import write_lossless_jpeg

    from bundlesdf_tpu_torch.io.jpeg import decode_jpeg

    base = decode_jpeg(jpeg_encode(rgb))
    return write_lossless_jpeg([base[..., c] for c in range(3)],
                               predictor=LOSSLESS_PREDICTORS[k % len(LOSSLESS_PREDICTORS)],
                               restart_rows=60)


def cube_shell(half: float, n: int, poses=None):
    """The cube's surface as a triangle mesh of an n x n vertex grid a face;
    with ``poses`` (object in camera), only the faces that some pose views
    at under SHELL_MAX_INCIDENCE_DEG from the view ray (the visible shell of
    a convex body: a face seen at grazing incidence leaves no depth)."""
    import numpy as np

    from bundlesdf_tpu_torch.utils.mesh import Mesh

    t = np.linspace(-half, half, n)
    a, b = np.meshgrid(t, t, indexing="ij")
    quads = np.stack([np.arange(n * n).reshape(n, n)[:-1, :-1].ravel(),
                      np.arange(n * n).reshape(n, n)[1:, :-1].ravel(),
                      np.arange(n * n).reshape(n, n)[1:, 1:].ravel(),
                      np.arange(n * n).reshape(n, n)[:-1, 1:].ravel()], -1)
    verts, faces = [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            normal = np.zeros(3)
            normal[axis] = sign
            if poses is not None:
                cos = [-float((T[:3, :3] @ normal) @ c) / np.linalg.norm(c)
                       for T in poses for c in [T[:3, :3] @ (normal * half) + T[:3, 3]]]
                if max(cos) < math.cos(math.radians(SHELL_MAX_INCIDENCE_DEG)):
                    continue
            p = np.zeros((n * n, 3))
            others = [i for i in range(3) if i != axis]
            p[:, others[0]], p[:, others[1]] = a.ravel(), b.ravel()
            p[:, axis] = sign * half
            base = sum(len(v) for v in verts)
            verts.append(p)
            faces.append(np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]]) + base)
    # one vertex where faces meet, so that the shell is one component
    verts, inv = np.unique(np.round(np.concatenate(verts), 12), axis=0, return_inverse=True)
    return Mesh(verts, inv.reshape(-1)[np.concatenate(faces)])


@contextlib.contextmanager
def time_runs(log: list):
    """Record (wall ms, status) of every BundleSdf.run call while the block
    runs; each call is closed by a device synchronisation."""
    import torch

    from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

    orig = BundleSdf.run

    def timed(self, *args, **kw):
        t0 = time.perf_counter()
        frame = orig(self, *args, **kw)
        torch.cuda.synchronize()
        log.append(((time.perf_counter() - t0) * 1e3, frame.status))
        return frame

    BundleSdf.run = timed
    try:
        yield
    finally:
        BundleSdf.run = orig


def write_video_folder(video: dict, frames, folder: str) -> None:
    """The YCBInEOAT layout with the port's PNG writer: RGB8 rgb/, mm-uint16
    depth/, 0/255 masks/, cam_K.txt."""
    import numpy as np

    from bundlesdf_tpu_torch.io.png import write_png

    for sub in ("rgb", "depth", "masks"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for k in frames:
        name = f"{k:05d}.png"
        write_png(os.path.join(folder, "rgb", name), video["colors"][k])
        write_png(os.path.join(folder, "depth", name),
                  np.round(video["depths"][k] * 1000.0).astype(np.uint16))
        write_png(os.path.join(folder, "masks", name),
                  (np.asarray(video["masks"][k]) > 0).astype(np.uint8) * 255)
    np.savetxt(os.path.join(folder, "cam_K.txt"), video["K"])


def pose_errors(out_dir: str, video: dict, frames) -> dict:
    """ADD / ADD-S of ``out_dir/ob_in_cam`` against the ground truth (first
    frame aligned)."""
    import numpy as np

    from bundlesdf_tpu_torch.utils import metrics

    preds = np.stack([np.loadtxt(os.path.join(out_dir, "ob_in_cam", f"{k:05d}.txt"))
                      for k in frames])
    res = metrics.trajectory_add_auc(preds, np.stack([video["gt"][k] for k in frames]),
                                     video["model_pts"])
    return {"mean_add_m": res["mean_add"], "max_add_m": float(res["add_errs"].max()),
            "add_auc": res["add_auc"]}


def phase_cli(video: dict, root: str) -> dict:
    """The run_custom script in-process, three times, on the first
    CLI_FRAMES frames of the tracking video written to ``root/video`` in the
    YCBInEOAT layout: ``--mode run_video --debug_level 2 --use_gui``
    (shipped configs, out_folder inside the video folder), ``--mode
    global_refine --refine_steps CLI_REFINE_STEPS`` and ``--mode
    draw_pose``; then draw_pose once more through ``python3 -m``.  Launch
    counts are set to 0 just before each in-process call and read just
    after: the reduce must launch twice a NOF step in run_video and 40
    times a step in global_refine."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch.config import Cfg
    from bundlesdf_tpu_torch.io.png import read_png
    from bundlesdf_tpu_torch.io.readers import YcbineoatReader
    from bundlesdf_tpu_torch.scripts import run_custom
    from bundlesdf_tpu_torch.tracking.frame import FAIL
    from bundlesdf_tpu_torch.utils import profiler
    from bundlesdf_tpu_torch.utils.mesh import load_obj

    vdir = os.path.join(root, "video")
    out = os.path.join(vdir, "out")
    frames = range(CLI_FRAMES)
    write_video_folder(video, frames, vdir)
    reader = YcbineoatReader(vdir, shorter_side=480, prefetch=False)
    t0 = time.perf_counter()
    for k in frames:
        reader.get_color(k), reader.get_depth(k), reader.get_mask(k), reader.get_occ_mask(k)
    reader_ms = (time.perf_counter() - t0) * 1e3 / CLI_FRAMES

    runs, steps = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.reset()
    reset_counts()
    t0 = time.perf_counter()
    with time_runs(runs), count_train_steps(steps):
        pipe = run_custom.main(["--mode", "run_video", "--video_dir", vdir,
                                "--out_folder", out, "--debug_level", "2", "--use_gui"])
    torch.cuda.synchronize()
    video_s = time.perf_counter() - t0
    counts_video = read_counts()
    graph_video = read_graph_counts()
    spans = profiler.stats()
    peak_video = torch.cuda.max_memory_allocated() / 1e9
    n_steps = sum(steps)
    poses = pose_errors(out, video, frames)
    mesh = load_obj(os.path.join(out, "mesh_online.obj"))
    surf = cube_surface_dist(mesh, pipe, video["gt"][0], 0.15)
    dash = [read_png(os.path.join(out, "dashboard", f"{k:05d}.png")) for k in frames]
    mesh_panel = [int((d[:, 2 * TRACK_HW[1]:] > 0).any(-1).sum()) for d in dash]
    cfgs = [Cfg.load(os.path.join(out, f"config_{n}.yml")) for n in ("track", "nerf")]

    torch.cuda.reset_peak_memory_stats()
    profiler.reset()
    reset_counts()
    t0 = time.perf_counter()
    run_custom.main(["--mode", "global_refine", "--out_folder", out,
                     "--refine_steps", str(CLI_REFINE_STEPS)])
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    counts_refine = read_counts()
    graph_refine = read_graph_counts()
    refine_spans = profiler.stats()
    peak_refine = torch.cuda.max_memory_allocated() / 1e9

    t0 = time.perf_counter()
    run_custom.main(["--mode", "draw_pose", "--video_dir", vdir, "--out_folder", out])
    draw_s = time.perf_counter() - t0
    pose_vis = sorted(os.listdir(os.path.join(out, "pose_vis")))
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", "bundlesdf_tpu_torch.scripts.run_custom",
                           "--mode", "draw_pose", "--video_dir", vdir, "--out_folder", out],
                          cwd=repo, capture_output=True, text=True, timeout=300)
    ms = [m for m, _ in runs]
    res = {
        "phase": "cli", "frames": CLI_FRAMES, "hw": list(TRACK_HW),
        "config": "run_custom's own: the shipped tracker (SPDLOG 2, zfar 1.0 for "
                  "'custom') and NOF configs, cut in length only (first "
                  f"{CLI_FRAMES} frames; global_refine --refine_steps {CLI_REFINE_STEPS})",
        "run_video_s": video_s, "frame_ms_median": float(np.median(ms)),
        "frame_ms_max": float(np.max(ms)), "frame_ms": ms,
        "reader_ms_per_frame": reader_ms,
        "gui_update_ms_mean": spans["gui/update"]["mean_s"] * 1e3,
        "gui_update_count": spans["gui/update"]["count"],
        "extract_mesh_ms_mean": spans["nof/extract_mesh"]["mean_s"] * 1e3
        if "nof/extract_mesh" in spans else None,
        "span_mean_ms": {k: v["mean_s"] * 1e3 for k, v in spans.items() if v["total_s"] > 0},
        "steps_trained": n_steps, "train_advance_calls": steps,
        "n_fail": sum(s == FAIL for _, s in runs), "n_poses": len(os.listdir(
            os.path.join(out, "ob_in_cam"))),
        **poses, "nerfed": [f.id for f in pipe.bundler.keyframes if f.nerfed],
        "mesh_vertices": len(mesh.vertices), "mesh_surface_dist_median_m": surf,
        "config_track_keys": len(cfgs[0]), "config_nerf_sc_factor": cfgs[1].get("sc_factor"),
        "dashboard_shapes": [list(d.shape) for d in dash],
        "dashboard_mesh_panel_pixels": mesh_panel,
        "kernel_launches_run_video": counts_video, "peak_mem_gb_run_video": peak_video,
        "global_refine_s": refine_s, "kernel_launches_global_refine": counts_refine,
        "graph_run_video": graph_video, "graph_global_refine": graph_refine,
        "global_refine_steps": CLI_REFINE_STEPS,
        "global_refine_spans_ms": {k: v["total_s"] * 1e3 for k, v in refine_spans.items()
                                   if k.startswith(("nof/", "texture/"))},
        "peak_mem_gb_global_refine": peak_refine,
        "refine_files": sorted(f for f in os.listdir(out) if "." in f),
        "draw_pose_s": draw_s, "pose_vis": len(pose_vis),
        "module_entry_rc": proc.returncode,
    }
    emit(res)
    if res["n_poses"] != CLI_FRAMES or res["n_fail"]:
        raise AssertionError(f"cli: {res['n_poses']} poses, {res['n_fail']} FAIL")
    if not poses["mean_add_m"] < 0.01:
        raise AssertionError(f"cli: mean ADD {poses['mean_add_m']} m >= 1 cm")
    check_graph_counts("cli run_video", graph_video, counts_video, n_steps,
                       {"reduce_cell_cache_grad": 2})
    check_graph_counts("cli global_refine", graph_refine, counts_refine, CLI_REFINE_STEPS,
                       {"reduce_cell_cache_grad": 40})
    if not res["nerfed"] or n_steps == 0:
        raise AssertionError(f"cli: no NOF round or reduce launches {counts_video} "
                             f"!= 2 x {n_steps} steps")
    if not (len(mesh.vertices) > 50 and surf < 0.03):
        raise AssertionError(f"cli: mesh_online {len(mesh.vertices)} vertices, {surf} m")
    if any(d.shape != (TRACK_HW[0], 3 * TRACK_HW[1], 3) for d in dash) or \
            not mesh_panel[-1] or res["gui_update_count"] != CLI_FRAMES:
        raise AssertionError(f"cli: dashboard {res['dashboard_shapes']}, mesh panel "
                             f"{mesh_panel}")
    if not all(os.path.exists(os.path.join(out, f)) for f in
               ("textured_mesh.obj", "poses_after_global_refine.txt")):
        raise AssertionError(f"cli: global_refine files {res['refine_files']}")
    if len(pose_vis) != CLI_FRAMES or proc.returncode:
        raise AssertionError(f"cli: pose_vis {pose_vis}, python3 -m exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return res


def write_ho3d_folder(video: dict, frames, root: str, name: str = "SM1",
                      kind: str = "baseline") -> str:
    """A synthetic HO3D_v3 folder of video ``name``: JPEG colour (ho3d_jpeg,
    baseline or another ``kind``), packed depth (red + 256 x green in
    DEPTH_SCALE units), pickled meta with
    camMat and the GL-flipped object pose, XMem object and hand masks, the
    cube as the mustard bottle's model, and its visible shell as
    visible_mesh.ply.  Returns the video folder."""
    import pickle

    import numpy as np
    from scipy.spatial.transform import Rotation

    from bundlesdf_tpu_torch.io.png import write_png
    from bundlesdf_tpu_torch.utils.mesh import export_obj, export_ply

    vdir = os.path.join(root, "evaluation", name)
    dirs = {s: os.path.join(vdir, s) for s in ("rgb", "depth", "meta")}
    dirs["mask"] = os.path.join(root, "masks_XMem", name)
    dirs["hand"] = os.path.join(root, "masks_XMem", f"{name}_hand")
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    flip = np.diag([1.0, -1.0, -1.0])
    for k in frames:
        with open(os.path.join(dirs["rgb"], f"{k:04d}.jpg"), "wb") as f:
            f.write(ho3d_jpeg(video["colors"][k], k, kind))
        units = np.round(video["depths"][k] / HO3D_DEPTH_SCALE).astype(np.int64)
        packed = np.stack([units % 256, units // 256, np.zeros_like(units)], -1)
        write_png(os.path.join(dirs["depth"], f"{k:04d}.png"), packed.astype(np.uint8))
        T = np.asarray(video["gt"][k])
        meta = {"camMat": np.asarray(video["K"], np.float64),
                "objTrans": flip @ T[:3, 3],
                "objRot": Rotation.from_matrix(flip @ T[:3, :3]).as_rotvec().reshape(3, 1)}
        with open(os.path.join(dirs["meta"], f"{k:04d}.pkl"), "wb") as f:
            pickle.dump(meta, f)
        write_png(os.path.join(dirs["mask"], f"{k:05d}.png"),
                  (np.asarray(video["masks"][k]) > 0).astype(np.uint8) * 255)
        write_png(os.path.join(dirs["hand"], f"{k:04d}.png"),
                  np.zeros(np.shape(video["masks"][k]), np.uint8))
    model = os.path.join(root, "models", "006_mustard_bottle")
    os.makedirs(model, exist_ok=True)
    export_obj(cube_shell(0.15, 16), os.path.join(model, "textured_simple.obj"))
    export_ply(cube_shell(0.15, 61, [video["gt"][k] for k in frames]),
               os.path.join(vdir, "visible_mesh.ply"))
    return vdir


def phase_ho3d(video: dict, root: str) -> dict:
    """run_ho3d then benchmark_ho3d on a synthetic HO3D folder of the first
    CLI_FRAMES frames of the tracking video (write_ho3d_folder), the
    shipped configs.  The colour must decode within JPEG loss of the frames
    that were encoded (PSNR over HO3D_PSNR_DB), 0 FAIL, ADD AUC over
    HO3D_ADD_AUC and chamfer under HO3D_CHAMFER_CM in benchmark.json, and a
    second run_ho3d call must skip the finished video.  Launch counts are
    set to 0 just before run_ho3d and read just after."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch.io.jpeg import read_jpeg
    from bundlesdf_tpu_torch.scripts import benchmark_ho3d, run_ho3d
    from bundlesdf_tpu_torch.tracking.frame import FAIL
    from bundlesdf_tpu_torch.utils import profiler

    frames = range(CLI_FRAMES)
    t0 = time.perf_counter()
    vdir = write_ho3d_folder(video, frames, root)
    write_s = time.perf_counter() - t0
    out_dir = os.path.join(root, "out")
    jpgs = sorted(os.listdir(os.path.join(vdir, "rgb")))
    t0 = time.perf_counter()
    decoded = [read_jpeg(os.path.join(vdir, "rgb", f)) for f in jpgs]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(jpgs)
    mse = [float(np.mean((d.astype(np.float64) - video["colors"][k]) ** 2))
           for k, d in zip(frames, decoded)]
    psnr = [10 * math.log10(255.0 ** 2 / m) for m in mse]

    runs, steps = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.reset()
    reset_counts()
    t0 = time.perf_counter()
    with time_runs(runs), count_train_steps(steps):
        done = run_ho3d.main(["--ho3d_dir", root, "--out_dir", out_dir,
                              "--video_names", "SM1"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    graph = read_graph_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    pipe = done["SM1"]
    surf = cube_surface_dist(pipe.mesh, pipe, video["gt"][0], 0.15)
    again = run_ho3d.main(["--ho3d_dir", root, "--out_dir", out_dir, "--video_names", "SM1"])
    t0 = time.perf_counter()
    bench = benchmark_ho3d.main(["--ho3d_dir", root, "--out_dir", out_dir])
    bench_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "benchmark.json")) as f:
        written = json.load(f)
    row = written["videos"][0]
    ms = [m for m, _ in runs]
    res = {
        "phase": "ho3d", "frames": CLI_FRAMES, "hw": list(TRACK_HW),
        "config": "run_ho3d's own: the shipped tracker and NOF configs, cut in length "
                  f"only (first {CLI_FRAMES} frames)",
        "jpeg": {"quality": HO3D_JPEG_QUALITY, "sampling": "4:2:0",
                 "bytes_per_frame": os.path.getsize(os.path.join(vdir, "rgb", jpgs[0]))},
        "write_folder_s": write_s, "jpeg_decode_ms_per_frame": decode_ms,
        "jpeg_psnr_db": psnr, "run_ho3d_s": run_s,
        "frame_ms_median": float(np.median(ms)), "frame_ms_max": float(np.max(ms)),
        "frame_ms": ms, "steps_trained": sum(steps), "kernel_launches": counts,
        "graph": graph,
        "n_fail": sum(s == FAIL for _, s in runs), "nerfed": [
            f.id for f in pipe.bundler.keyframes if f.nerfed],
        "mesh_surface_dist_median_m": surf, "peak_mem_gb": peak,
        "second_call_skipped": again == {"SM1": None},
        "benchmark_s": bench_s, "benchmark": row,
        "benchmark_returned_equal": bench == written,
        "limits": {"psnr_db": HO3D_PSNR_DB, "add_auc": HO3D_ADD_AUC,
                   "chamfer_cm": HO3D_CHAMFER_CM},
    }
    emit(res)
    if min(psnr) < HO3D_PSNR_DB:
        raise AssertionError(f"ho3d: JPEG PSNR {psnr} under {HO3D_PSNR_DB} dB")
    if res["n_fail"] or len(runs) != CLI_FRAMES:
        raise AssertionError(f"ho3d: {res['n_fail']} FAIL in {len(runs)} frames")
    if not res["nerfed"]:
        raise AssertionError("ho3d: no NOF round completed")
    check_graph_counts("ho3d", res["graph"], counts, res["steps_trained"],
                       {"reduce_cell_cache_grad": 2})
    if not (row["ADD_AUC"] > HO3D_ADD_AUC and row["chamfer_cm"] < HO3D_CHAMFER_CM):
        raise AssertionError(f"ho3d: benchmark {row}")
    if not res["second_call_skipped"] or not res["benchmark_returned_equal"]:
        raise AssertionError(f"ho3d: second call {again}, benchmark {bench}")
    return res


# The codecs phase's committed fixtures (tests/port_codecs.py::
# write_codec_fixtures wrote them and their expected.json with cv2 and PIL).
CODECS_DIR = os.path.join("tests", "data", "codecs")


# The port's counterpart of each call that expected.json names.
CODEC_CALLS = {"imageio.imread": "read_jpeg",
               "cv2.imread(path, -1), channels in RGB order": "read_png",
               "cv2.imread(path, -1)": "imread_unchanged"}


def check_codec_fixtures(folder: str) -> list:
    """Decode every file of ``folder``'s expected.json with the port's
    counterpart of its call (CODEC_CALLS: read_jpeg for imageio's,
    read_png for cv2.imread(-1)'s in RGB order, imread_unchanged for
    cv2.imread(-1)'s own layout) and hold its shape, dtype and sha256 to
    those of the call on the machine that wrote it; raises at the first
    that differs.  One row a file, with its decode ms."""
    import hashlib

    import numpy as np

    from bundlesdf_tpu_torch.io.imread import imread_unchanged
    from bundlesdf_tpu_torch.io.jpeg import read_jpeg
    from bundlesdf_tpu_torch.io.png import read_png

    readers = {"read_jpeg": read_jpeg, "read_png": read_png,
               "imread_unchanged": imread_unchanged}
    with open(os.path.join(folder, "expected.json")) as f:
        expected = json.load(f)
    rows = []
    for name, want in expected.items():
        read = readers[CODEC_CALLS[want["call"]]]
        t0 = time.perf_counter()
        out = read(os.path.join(folder, name))
        ms = (time.perf_counter() - t0) * 1e3
        got = {"shape": list(out.shape), "dtype": str(out.dtype),
               "sha256": hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest()}
        if any(got[k] != want[k] for k in got):
            raise AssertionError(f"codecs: {name} decodes to {got}, expected {want}")
        rows.append({"file": name, "read": CODEC_CALLS[want["call"]], **got, "decode_ms": ms})
    return rows


# The frames the codecs phase writes again, by kind: the progressive ones on
# all CLI_FRAMES, the arithmetic and lossless ones on fewer (their Python
# entropy coders are slower; the frames keep their full size).
CODEC_FRAMES = {"progressive": CLI_FRAMES, "arithmetic": 3, "arithmetic_progressive": 3,
                "lossless": 3}


def phase_codecs(video: dict, base_vdir: str, root: str, card: str) -> dict:
    """The readers' image formats on the card's machine (host numpy, no
    kernel): the committed fixtures against their digests
    (check_codec_fixtures); the HO3D folder of phase_ho3d written again as
    each kind of CODEC_FRAMES (write_ho3d_folder: progressive and
    arithmetic files of the baseline coefficients, lossless files of the
    baseline decode), whose decode must be bit-equal to the baseline
    file's, frame by frame, through decode_jpeg and through
    Ho3dReader.get_color; decode ms a frame of every kind.  Launch counts
    are set to 0 just before and read just after: no kernel runs."""
    import numpy as np

    from bundlesdf_tpu_torch.io.jpeg import decode_jpeg
    from bundlesdf_tpu_torch.io.readers import Ho3dReader

    start = time.perf_counter()
    reset_counts()
    fixtures = check_codec_fixtures(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), CODECS_DIR))
    names = sorted(os.listdir(os.path.join(base_vdir, "rgb")))
    base_bytes, base_ms, base = [], [], []
    for f in names:
        with open(os.path.join(base_vdir, "rgb", f), "rb") as fh:
            base_bytes.append(fh.read())
        t0 = time.perf_counter()
        base.append(decode_jpeg(base_bytes[-1]))
        base_ms.append((time.perf_counter() - t0) * 1e3)
    base_reader = Ho3dReader(base_vdir)
    kinds = {}
    for kind, n in CODEC_FRAMES.items():
        t0 = time.perf_counter()
        vdir = write_ho3d_folder(video, range(n), os.path.join(root, kind), kind=kind)
        write_s = time.perf_counter() - t0
        ms, equal, sizes = [], [], []
        for k in range(n):
            with open(os.path.join(vdir, "rgb", names[k]), "rb") as fh:
                data = fh.read()
            t0 = time.perf_counter()
            out = decode_jpeg(data)
            ms.append((time.perf_counter() - t0) * 1e3)
            equal.append(bool(out.shape == np.shape(video["colors"][k])
                              and np.array_equal(out, base[k])))
            sizes.append(len(data))
        reader = Ho3dReader(vdir)
        kinds[kind] = {"frames": n, "bit_equal": equal, "bytes": sizes,
                       "ho3d_reader_equal": [
                           bool(np.array_equal(reader.get_color(i), base_reader.get_color(i)))
                           for i in range(n)],
                       "write_folder_s": write_s, "decode_ms": ms,
                       "decode_ms_median": float(np.median(ms))}
    counts = read_counts()
    res = {"phase": "codecs", "card": card, "fixtures": fixtures,
           "hw": list(np.shape(video["colors"][0])[:2]),
           "baseline": {"frames": len(names), "bytes": [len(d) for d in base_bytes],
                        "decode_ms": base_ms, "decode_ms_median": float(np.median(base_ms))},
           "kinds": kinds, "progressive_scans": "libjpeg's simple progression (10)",
           "lossless_predictors": list(LOSSLESS_PREDICTORS), "kernel_launches": counts,
           "phase_s": time.perf_counter() - start}
    emit(res)
    for kind, r in kinds.items():
        if len(r["bit_equal"]) != r["frames"] or not all(r["bit_equal"]):
            raise AssertionError(f"codecs: {kind} decode against baseline {r['bit_equal']}")
        if not all(r["ho3d_reader_equal"]):
            raise AssertionError(f"codecs: Ho3dReader on {kind} frames "
                                 f"{r['ho3d_reader_equal']}")
    if any(counts.values()):
        raise AssertionError(f"codecs: kernel launches {counts}")
    return res


# ------------------------------------------------------------ data parallel ---

# The data-parallel phases: one group of DP_RANKS processes of this script
# (--dp-worker), all on cuda:0 and joined by gloo (NCCL refuses two ranks on
# one device), through parallel.distributed.init_multihost's BSDF_*
# variables.  Every dp phase runs in that group, so start-up is paid once.
# synth_eval: the quality evaluations' cut (the hard fixture of
# scripts/synth_hard.py at its full 480 x 480, cut in length) and the JAX
# scripts' numbers on the same cut, from their run on the CPU:
#   python scripts/benchmark_synth.py --matchers corner --frames 6
#   python scripts/eval_matcher.py --video VIDEO --matchers corner,sift --gaps 1,2
SYNTH_FRAMES = 6
SYNTH_GAPS = "1,2"
SYNTH_JAX_CPU = {"ADD_AUC": 99.72, "mean_ADD_cm": 0.039, "mesh_mean_dist_cm": 0.638,
                 "n_tracking_fail": 0}
MATCH_JAX_CPU = {"corner": {"matches_per_pair": 171.0, "inlier_rate_3px": 0.9662},
                 "sift": {"matches_per_pair": 170.9, "inlier_rate_3px": 0.9854}}
# margins on the JAX numbers: AUC points, ADD and mesh distance (cm, each
# also allowed 1.5x), inlier rate, matches a pair (share)
SYNTH_AUC_MARGIN = 2.0
SYNTH_CM_MARGIN = 0.3
MATCH_RATE_MARGIN = 0.02
MATCH_COUNT_SHARE = 0.9


def phase_synth_eval(root: str) -> dict:
    """The quality evaluations as a user runs them (``python3 -m
    bundlesdf_tpu_torch.scripts.benchmark_synth`` and ``eval_matcher``, in
    this process, on the card): benchmark_synth on SYNTH_FRAMES frames of
    the hard fixture at 480 x 480 with the corner engine (the shipped
    configs; the fixture written by the port's synth_hard), then
    eval_matcher on its pairs at gaps SYNTH_GAPS with the corner and SIFT
    engines.  Each number is held to the JAX scripts' CPU run on the same
    cut within the margins above; the launch counts are set to 0 just
    before benchmark_synth and read after: the reduce twice a NOF step."""
    import torch

    from bundlesdf_tpu_torch.scripts import benchmark_synth, eval_matcher

    work = os.path.join(root, "synth_hard")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rep = benchmark_synth.main(["--matchers", "corner", "--frames", str(SYNTH_FRAMES),
                                    "--workdir", work])
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    counts = read_counts()
    graph = read_graph_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        mrep = eval_matcher.main(["--video", os.path.join(work, "video"), "--matchers",
                                  "corner,sift", "--gaps", SYNTH_GAPS])
    match_s = time.perf_counter() - t0
    r = rep["corner"]
    steps = r["profile"]["overlap"].get("nof_steps", 0)
    res = {"phase": "synth_eval", "frames": SYNTH_FRAMES, "hw": [480, 480],
           "benchmark_synth": {k: v for k, v in r.items() if k != "profile"},
           "overlap": r["profile"]["overlap"], "nof_steps": steps,
           "benchmark_synth_s": bench_s, "peak_mem_gb": peak,
           "eval_matcher": {k: mrep[k] for k in ("n_pairs", "gaps", "corner", "sift")},
           "eval_matcher_s": match_s, "jax_cpu": {"benchmark_synth": SYNTH_JAX_CPU,
                                                   "eval_matcher": MATCH_JAX_CPU},
           "kernel_launches": counts, "graph": graph}
    emit(res)
    bad = []
    j = SYNTH_JAX_CPU
    if r["n_tracking_fail"] > j["n_tracking_fail"]:
        bad.append(f"n_tracking_fail {r['n_tracking_fail']} > {j['n_tracking_fail']}")
    if not r["ADD_AUC"] >= j["ADD_AUC"] - SYNTH_AUC_MARGIN:
        bad.append(f"ADD_AUC {r['ADD_AUC']} < {j['ADD_AUC']} - {SYNTH_AUC_MARGIN}")
    for k in ("mean_ADD_cm", "mesh_mean_dist_cm"):
        if not r.get(k, math.inf) <= max(1.5 * j[k], j[k] + SYNTH_CM_MARGIN):
            bad.append(f"{k} {r.get(k)} against {j[k]}")
    for eng, ref in MATCH_JAX_CPU.items():
        got = mrep[eng]
        if not got["inlier_rate_3px"] >= ref["inlier_rate_3px"] - MATCH_RATE_MARGIN:
            bad.append(f"{eng} inlier_rate_3px {got['inlier_rate_3px']} against "
                       f"{ref['inlier_rate_3px']}")
        if not got["matches_per_pair"] >= MATCH_COUNT_SHARE * ref["matches_per_pair"]:
            bad.append(f"{eng} matches_per_pair {got['matches_per_pair']} against "
                       f"{ref['matches_per_pair']}")
    if steps == 0:
        bad.append("no NOF step trained")
    if bad:
        raise AssertionError("synth_eval: " + "; ".join(bad))
    check_graph_counts("synth_eval", graph, counts, steps, {"reduce_cell_cache_grad": 2})
    return res


DP_RANKS = 2
DP_TIMEOUT_S = 600
DP_TRAIN_STEPS = 20
# extra steps of nof_train_step_dp with each collective timed alone
DP_COLLECTIVE_STEPS = 5
DP_REFINE_STEPS = 10
DP_LOFTR_STEPS = 3
# the sharded BA against the single BA (tests/test_parallel.py:86)
DP_BA_TOL = 1e-5
# dp_small_parity: the base of nof_options_small_parity's sphere config and
# the two variants run on it
DP_SMALL = {"num_levels": 3, "finest_res": 64, "log2_hashmap_size": 19,
            "hash_big_dtype": "bfloat16"}
DP_SMALL_VARIANTS = {"pallas_scatter": {"hash_scatter": "pallas"},
                     "eikonal": {"eikonal_weight": 0.1}}
# joint_dp_small_parity: small_nof_cfg with a table large enough that its
# finest level (R = 64) is dense and bf16-staged, so that the reduce runs
JOINT_DP_SMALL = {"log2_hashmap_size": 19}


def dp_counts(mesh, counts: dict | None = None) -> dict:
    """Each kernel's launch count (``read_counts()``, or ``counts``) on
    every rank, in rank order."""
    import torch

    c = counts or read_counts()
    names = sorted(c)
    t = torch.tensor([c[k] for k in names], dtype=torch.int64, device=mesh.device)
    every = mesh.all_gather(t).reshape(mesh.size, -1).cpu().tolist()
    return {k: [row[i] for row in every] for i, k in enumerate(names)}


def dp_every(mesh, x: float) -> list:
    """``x`` of every rank, in rank order."""
    import torch

    t = torch.tensor([float(x)], dtype=torch.float64, device=mesh.device)
    return mesh.all_gather(t).cpu().tolist()


def dp_sphere_runners(mesh, over: dict):
    """run_global_nerf's runner on the sphere under REFINE_SMALL merged with
    ``over``, once single-rank and once over ``mesh`` (dp_devices), both on
    this rank's device and each built by one step of the shared draws."""
    from bundlesdf_tpu_torch.config import default_nof_config, default_track_config
    from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

    data, frames = sphere_frames()
    cfg = default_nof_config().merged({**REFINE_SMALL, "n_step": 1, **over})
    out = []
    for dp in (0, mesh.size):
        pipe = BundleSdf(cfg_track=default_track_config(), use_nof=False,
                         device=mesh.device,
                         nof_draws=shared_nof_draws(cfg["N_rand"], cfg["N_samples"],
                                                    cfg["N_samples_around_depth"]))
        pipe.K = data["K"]
        pipe.run_global_nerf(frames, cfg_refine=cfg.merged({"dp_devices": dp}))
        out.append(pipe.global_nof)
    return out


def capture_reduced_grads(opt) -> dict:
    """Wrap ``opt._reduce_grads`` (a NofOptimizer over a mesh) so that each
    call leaves the summed gradients, the table whole, in the returned dict
    (before the clip)."""
    got = {}
    orig = opt._reduce_grads

    def wrapped():
        orig()
        got.clear()
        for g in opt.groups:
            for p in g["params"]:
                got[id(p)] = (opt._gather(p.grad) if p is opt.shard else p.grad).clone()

    opt._reduce_grads = wrapped
    return got


def dp_phase_small_parity(mesh) -> dict:
    """The 2-rank NOF step against a single-rank step on the same card: the
    sphere and REFINE_SMALL of nof_options_small_parity (3 levels 16 -> 64,
    R = 64 bf16-staged), under hash_scatter pallas (both kernels on both
    ranks) and with eikonal_weight 0.1 (the global count).  3 rounds each:
    the single runner takes the dp runner's weights, both take one global
    batch and its draws, the dp step sums its ranks' gradients (captured
    before the clip) and steps; the single runner computes the loss
    function's loss and gradients on the whole batch.  The loss within
    1e-4 relative, every gradient within GRAD_RTOL_F32 (the table's bf16
    levels GRAD_RTOL_BF16), level by level; the ranks' losses equal."""
    import torch

    from bundlesdf_tpu_torch.nof import render as nof_render
    from bundlesdf_tpu_torch.nof import runner
    from bundlesdf_tpu_torch.ops import hashgrid
    from bundlesdf_tpu_torch.parallel import nof_shard

    dev = mesh.device
    res = {"phase": "dp_small_parity", "ranks": mesh.size,
           "config": "REFINE_SMALL on the 4-view 32 x 32 sphere with " + json.dumps(DP_SMALL),
           "grad_rel_l2_bounds": {"f32": GRAD_RTOL_F32, "bf16": GRAD_RTOL_BF16}}
    failures = []
    for name, over in DP_SMALL_VARIANTS.items():
        one, dp = dp_sphere_runners(mesh, {**DP_SMALL, **over})
        st = dp.statics
        step, _ = nof_shard.make_dp_train_step(st, dp.optimizer, mesh)
        grads = capture_reduced_grads(dp.optimizer)
        dp_leaf = {id(dp.optimizer.table): dp.optimizer.shard}
        loss_fn = runner.make_loss_fn(st)
        grid_spec = st.spec.grid
        C = grid_spec.level_dim
        gen = torch.Generator().manual_seed(4)
        n = st.n_rand
        launched = dict.fromkeys(read_counts(), 0)
        losses, errs_max = [], {}
        for i in range(3):
            with torch.no_grad():
                for pd, po in zip(runner.param_leaves(dp.params),
                                  runner.param_leaves(one.params)):
                    po.copy_(pd)
            idx = torch.randint(0, dp.n_rays, (n,), generator=gen)
            draws = nof_render.draw_samples(st.rcfg, n, gen, "cpu")
            reset_counts()   # the dp step's launches only, not the single's
            m = step(dp.params, i, dp.rays_dev, dp.n_rays, dp.occ_grid, dp.c2w_dev,
                     batch_idx=idx.to(dev), draws=draws.to(dev))
            launched = {k: v + read_counts()[k] for k, v in launched.items()}
            one.optimizer.zero_grad()
            loss, mo = loss_fn(one.params, one.rays_dev[idx.to(dev)], one.occ_grid,
                               one.c2w_dev, i, draws.to(dev))
            loss.backward()
            ld, lo = float(m["loss"]), float(loss.detach())
            every = dp_every(mesh, ld)
            losses.append({"dp": ld, "single": lo, "dp_by_rank": every})
            if not abs(ld - lo) <= 1e-4 * abs(lo) or len(set(every)) != 1:
                failures.append(f"{name} step {i} loss: dp {every} single {lo}")
            if "eikonal_loss" in mo and not float(mo["eikonal_loss"]) > 0:
                failures.append(f"{name} step {i}: no eikonal term")
            for (lname, pd), po in zip(_named_leaves(dp.params),
                                       runner.param_leaves(one.params)):
                g = grads[id(dp_leaf.get(id(pd), pd))]
                if lname != "table":
                    e = rel_l2(g.cpu(), po.grad.cpu())
                    errs_max[lname] = max(errs_max.get(lname, 0.0), e)
                    if not e <= GRAD_RTOL_F32:
                        failures.append(f"{name} step {i} {lname} gradient: rel L2 {e}")
                    continue
                for li, p in enumerate(grid_spec.level_params()):
                    bf16 = p["dense"] and hashgrid._lvl_dtype(grid_spec, p) == torch.bfloat16
                    sl = slice(p["offset"] * C, (p["offset"] + p["size"]) * C)
                    key = f"table/L{li}_R{p['res']}" + ("_bf16" if bf16 else "")
                    e = rel_l2(g[sl].cpu(), po.grad[sl].cpu())
                    errs_max[key] = max(errs_max.get(key, 0.0), e)
                    if not e <= (GRAD_RTOL_BF16 if bf16 else GRAD_RTOL_F32):
                        failures.append(f"{name} step {i} {key} gradient: rel L2 {e}")
        counts = dp_counts(mesh, launched)
        res[name] = {"losses": losses, "grad_rel_l2_max": errs_max,
                     "launches_by_rank": counts}
        want = ["reduce_cell_cache_grad"] + (["fused_cache_scatter"]
                                             if name == "pallas_scatter" else [])
        if any(c == 0 for k in want for c in counts[k]):
            failures.append(f"{name}: a kernel not launched on every rank: {counts}")
    if failures:
        raise AssertionError(f"dp_small_parity: {failures}; {json.dumps(res)}")
    return res


@contextlib.contextmanager
def timed_collectives(log: list):
    """Time every collective of parallel.mesh.Mesh alone (device
    synchronised before and after) while the block runs: appends
    (name, ms)."""
    import torch

    from bundlesdf_tpu_torch.parallel import mesh as mesh_mod

    names = ("all_reduce", "all_gather", "reduce_scatter")
    orig = {k: getattr(mesh_mod.Mesh, k) for k in names}

    def timed(k):
        def call(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[k](self, *a, **kw)
            torch.cuda.synchronize()
            log.append((k, (time.perf_counter() - t0) * 1e3))
            return out
        return call

    for k in names:
        setattr(mesh_mod.Mesh, k, timed(k))
    try:
        yield
    finally:
        for k in names:
            setattr(mesh_mod.Mesh, k, orig[k])


def dp_phase_train(mesh) -> dict:
    """The online-budget NOF step (ONLINE: 2048 rays x (128 + 64) samples,
    4 levels 16 -> 128, log2 table 22) data-parallel over the mesh with the
    table sharded, DP_TRAIN_STEPS steps: the launch counts set to 0 just
    before and read just after (the reduce twice a step on every rank), the
    loss falls, ms a step on every rank by CUDA events; then
    DP_COLLECTIVE_STEPS more steps with each collective timed alone."""
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_nof_config
    from bundlesdf_tpu_torch.nof import runner
    from bundlesdf_tpu_torch.parallel import nof_shard

    dev = mesh.device
    spec, rcfg, weights, params, rays, c2w, grid = entry.build_nof(**ONLINE, device=dev)
    st = runner.TrainStatics(spec, rcfg, weights, ONLINE["n_rand"], 500, 0.01, 0.01, "",
                             1.0)
    opt = runner.make_optimizer(default_nof_config(), params)
    step, place = nof_shard.make_dp_train_step(st, opt, mesh, shard_table=True)
    params, rays, grid, c2w = place(params, rays, grid, c2w)
    gen = torch.Generator(device=dev).manual_seed(1)
    n_rays = rays.shape[0]
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(DP_TRAIN_STEPS + 1)]
    losses = []
    reset_counts()
    ev[0].record()
    for i in range(DP_TRAIN_STEPS):
        losses.append(step(params, i, rays, n_rays, grid, c2w, generator=gen)["loss"])
        ev[i + 1].record()
    torch.cuda.synchronize()
    counts = dp_counts(mesh)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(DP_TRAIN_STEPS)][3:]
    coll = []
    with timed_collectives(coll):
        for i in range(DP_COLLECTIVE_STEPS):
            step(params, DP_TRAIN_STEPS + i, rays, n_rays, grid, c2w, generator=gen)
    by_kind = {k: sum(ms for n, ms in coll if n == k) / DP_COLLECTIVE_STEPS
               for k in sorted({n for n, _ in coll})}
    res = {"phase": "nof_train_step_dp", "ranks": mesh.size, "budget": ONLINE,
           "shard_table": True, "table_floats": opt.table.numel(),
           "shard_floats_by_rank": dp_every(mesh, opt.shard.numel()),
           "steps": DP_TRAIN_STEPS, "loss_first": losses[0], "loss_last": losses[-1],
           "step_ms_by_rank": dp_every(mesh, sum(step_ms) / len(step_ms)),
           "collective_ms_per_step_by_rank": dp_every(mesh, sum(by_kind.values())),
           "collective_ms_per_step": by_kind,
           "collective_calls_per_step": len(coll) / DP_COLLECTIVE_STEPS,
           "launches_by_rank": counts}
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"nof_train_step_dp: loss {losses}")
    if counts["reduce_cell_cache_grad"] != [2 * DP_TRAIN_STEPS] * mesh.size:
        raise AssertionError(f"nof_train_step_dp: reduce launches {counts} != 2 a step "
                             "on every rank")
    return res


def dp_phase_global_refine(mesh, trail: str) -> dict:
    """The user's script under dp: run_custom --mode global_refine
    --refine_steps DP_REFINE_STEPS on a copy of the joint phase's trail, on
    every rank of the group (run_custom's init_multihost finds it joined, so
    dp_devices is the world size), the shipped 16-level offline budget.
    Rank 0 writes the textured mesh and the poses; the reduce launches
    5 x steps on every rank (no microbatching under dp)."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch.nof.texture import load_textured_obj
    from bundlesdf_tpu_torch.ops import hashgrid
    from bundlesdf_tpu_torch.scripts import run_custom
    from bundlesdf_tpu_torch.utils import profiler

    t0 = time.perf_counter()
    profiler.reset()
    reset_counts()
    with contextlib.redirect_stdout(sys.stderr):
        pipe, mesh_out, poses = run_custom.main(
            ["--mode", "global_refine", "--out_folder", trail,
             "--refine_steps", str(DP_REFINE_STEPS)])
    torch.cuda.synchronize()
    counts = dp_counts(mesh)
    spans = profiler.stats()
    nof = pipe.global_nof
    n_bf16 = sum(1 for p in nof.spec.grid.level_params()
                 if p["dense"] and hashgrid._lvl_dtype(nof.spec.grid, p) == torch.bfloat16)
    res = {"phase": "global_refine_dp", "ranks": mesh.size, "steps": nof.global_step,
           "dp_devices": nof.mesh.size, "microbatch_ignored": nof.statics.microbatch,
           "n_rand": nof.statics.n_rand, "num_levels": nof.spec.grid.num_levels,
           "bf16_levels": n_bf16, "launches_by_rank": counts,
           "reduce_per_step_by_rank": [c / DP_REFINE_STEPS
                                       for c in counts["reduce_cell_cache_grad"]],
           "phase_s_by_rank": dp_every(mesh, time.perf_counter() - t0),
           "step_ms_by_rank": dp_every(mesh, spans["nof/train"]["total_s"] * 1e3
                                       / DP_REFINE_STEPS),
           "span_s_by_rank": {k: dp_every(mesh, spans[k]["total_s"] if k in spans else 0.0)
                              for k in ("nof/create_runner", "nof/extract_mesh",
                                        "texture/bake")},
           "peak_mem_gb_by_rank": dp_every(mesh, torch.cuda.max_memory_allocated() / 1e9)}
    if counts["reduce_cell_cache_grad"] != [n_bf16 * DP_REFINE_STEPS] * mesh.size:
        raise AssertionError(f"global_refine_dp: reduce launches {counts} != "
                             f"{n_bf16} x {DP_REFINE_STEPS} on every rank")
    if mesh.rank == 0:
        obj = os.path.join(trail, "textured_mesh.obj")
        back, _ = load_textured_obj(obj)
        got = np.loadtxt(os.path.join(trail, "poses_after_global_refine.txt"))
        res.update(mesh_vertices=len(back.vertices), poses_rows=got.shape[0])
        if len(back.vertices) <= 50 or got.shape[0] != 4 * len(poses):
            raise AssertionError(f"global_refine_dp: rank 0 wrote {res}")
    return res


def dp_ba_inputs(device):
    """The BA inputs of bench.py:325-345: 10 frames, 512 sparse edges a
    frame, the dense term on 120 x 160 maps, the reference's 7 GN
    iterations."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    N, E, h, w = 10, 10 * 512, 120, 160
    K = np.array([[600.0, 0, 240], [0, 600.0, 240], [0, 0, 1]], np.float32)
    fixed = np.zeros(N, bool)
    fixed[0] = True
    ii = rng.integers(0, N, E)
    jj = rng.integers(0, N, E)
    pts = rng.uniform(-0.1, 0.1, (E, 3)).astype(np.float32)
    pj = pts + rng.normal(0, 0.002, (E, 3)).astype(np.float32)
    xyz = rng.uniform(-0.2, 0.2, (N, h, w, 3)).astype(np.float32)
    nrm = np.broadcast_to(np.array([0, 0, 1], np.float32), (N, h, w, 3)).copy()
    arrays = (np.tile(np.eye(4, dtype=np.float32), (N, 1, 1)), fixed, ii, jj, pts, pj,
              np.ones(E, bool), np.arange(N - 1), np.arange(1, N), np.ones(N - 1, bool),
              xyz, nrm, np.ones((N, h, w), bool), K / 4.0)
    return N, [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def dp_phase_ba(mesh) -> dict:
    """The sharded BA (parallel/ba_shard.py) on the mesh against the single
    BA on the same card, bench.py's inputs: poses within DP_BA_TOL, equal on
    every rank; ms of each by CUDA events."""
    import torch

    from bundlesdf_tpu_torch.parallel import ba_shard
    from bundlesdf_tpu_torch.tracking import ba as ba_mod

    N, args = dp_ba_inputs(mesh.device)
    params = ba_mod.BAParams()
    sharded = ba_shard.make_sharded_bundle_adjust(mesh, params, N)
    single = functools.partial(ba_mod.bundle_adjust, params=params, n_frames=N)
    out = {}
    for name, fn in (("single", single), ("sharded", sharded)):
        poses, info = fn(*args)
        ms, _ = event_ms(lambda: fn(*args), iters=3, warmup=1)
        out[name] = (poses, info, ms)
    err = float((out["sharded"][0] - out["single"][0]).abs().max())
    res = {"phase": "ba_shard", "ranks": mesh.size, "frames": N,
           "gn_iters": params.num_iter_outer, "edges": int(args[2].shape[0]),
           "pairs": int(args[7].shape[0]), "max_abs_err": err, "tol": DP_BA_TOL,
           "max_abs_err_by_rank": dp_every(mesh, err),
           "chi2_feature_last": float(out["sharded"][1]["chi2_feature"][-1]),
           "ms_single_by_rank": dp_every(mesh, out["single"][2]),
           "ms_sharded_by_rank": dp_every(mesh, out["sharded"][2])}
    every = mesh.all_gather(out["sharded"][0].reshape(1, -1).contiguous())
    if not err <= DP_BA_TOL or not bool(torch.all(every == every[0])):
        raise AssertionError(f"ba_shard: {res}")
    return res


def dp_phase_loftr(mesh) -> dict:
    """The LoFTR trainer data-parallel (make_train_step(mesh=...)) at
    TrainCfg() (160 x 160, batch 8: 4 a rank) and full width:

    * DP_LOFTR_STEPS steps in f64 on global batches drawn alike on every
      rank: before each, a single-rank copy takes the dp weights and
      computes the loss function's loss and gradients (clipped as the step
      clips them) on the whole batch; the dp step's loss within
      LOFTR_TRAIN_LOSS_RTOL, each leaf's gradient within
      LOFTR_TRAIN_GRAD_RTOL (relative L2).  In f32 the two differ by the
      rounding of GEMMs of other shapes, which the GT cells' confidences at
      the focal loss's clip amplify to within a few 1e-3 of that bound; f64
      leaves only a wrong sum or count to find;
    * DP_LOFTR_STEPS steps in f32 from the same init, ms a step by CUDA
      events (the first warms up)."""
    import torch

    from bundlesdf_tpu_torch.models import loftr
    from bundlesdf_tpu_torch.models import loftr_train as lt

    dev = mesh.device
    tcfg = lt.TrainCfg()
    init = loftr.init_weights(loftr.LoftrModule(), seed=0).state_dict()

    def dp_trainer(dtype):
        module = loftr.load_weights(loftr.LoftrModule(), init).to(dev, dtype).train()
        opt = lt.LoftrOptimizer(lt.trainable(module), tcfg, DP_LOFTR_STEPS)
        return opt, lt.make_train_step(module, tcfg, opt, mesh)

    def batches(dtype):
        gen = torch.Generator(device=dev).manual_seed(3)
        for _ in range(DP_LOFTR_STEPS):
            b = lt.make_batch(tcfg.batch, tcfg.H, tcfg.W, tcfg.max_gt, generator=gen,
                              device=dev)
            yield lt.HomographyBatch(*(x.to(dtype) if x.is_floating_point() else x
                                       for x in b))

    opt, step = dp_trainer(torch.float64)
    one = loftr.load_weights(loftr.LoftrModule(), init).to(dev, torch.float64).train()
    one_leaves = lt.trainable(one)
    loss_fn = lt.make_loss_fn(one, tcfg)
    losses, worst, failures = [], [], []
    for i, batch in enumerate(batches(torch.float64)):
        with torch.no_grad():
            for a, b in zip(opt.leaves, one_leaves):
                b.copy_(a)
                b.grad = None
        loss, _ = loss_fn(batch)
        with loftr._without_cudnn():
            loss.backward()
        lt.clip_by_global_norm([p.grad for p in one_leaves], 1.0)
        m = step(batch)
        ld, lo = float(m["loss"]), float(loss.detach())
        losses.append({"dp": ld, "single": lo, "dp_by_rank": dp_every(mesh, ld)})
        if not abs(ld - lo) <= LOFTR_TRAIN_LOSS_RTOL * abs(lo):
            failures.append(f"step {i} loss: dp {ld} single {lo}")
        worst.append(0.0)
        for a, b in zip(opt.leaves, one_leaves):
            e = rel_l2(a.grad.cpu(), b.grad.cpu())
            worst[-1] = max(worst[-1], e)
            if not e <= LOFTR_TRAIN_GRAD_RTOL:
                failures.append(f"step {i} gradient {tuple(a.shape)}: rel L2 {e}")
    del opt, step, one, one_leaves, loss_fn
    torch.cuda.empty_cache()
    _, step = dp_trainer(torch.float32)
    ms, f32_losses = [], []
    for batch in batches(torch.float32):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        f32_losses.append(float(step(batch)["loss"]))
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    res = {"phase": "loftr_train_dp", "ranks": mesh.size, "batch": tcfg.batch,
           "per_rank": tcfg.batch // mesh.size, "size": [tcfg.H, tcfg.W],
           "parity_dtype": "float64", "losses": losses, "grad_rel_l2_max_by_step": worst,
           "bounds": {"loss": LOFTR_TRAIN_LOSS_RTOL, "grad": LOFTR_TRAIN_GRAD_RTOL},
           "f32_losses": f32_losses, "f32_ms_per_step": ms,
           "f32_ms_per_step_by_rank": dp_every(mesh, sum(ms[1:]) / len(ms[1:]))}
    if failures or not all(math.isfinite(v) for v in f32_losses):
        raise AssertionError(f"loftr_train_dp: {failures[:10]}; {json.dumps(res)}")
    return res


def tracked_spans() -> int:
    """Calls of this process's tracker spans (track/*, corres/*)."""
    from bundlesdf_tpu_torch.utils import profiler

    return sum(v["count"] for k, v in profiler.stats().items()
               if k.startswith(("track/", "corres/")))


def dp_phase_joint_small_parity(mesh) -> dict:
    """The online joint loop over the mesh's ranks (BundleSdf with
    dp_devices, rank 0 the tracker of record, the others following its NOF
    calls) against rank 0's 1-rank loop on the same card: the 96 x 96 cube
    (6 frames, 3 deg apart) under small_track_cfg and small_nof_cfg with
    JOINT_DP_SMALL, start_nerf_keyframes 3, the same draws (every rank's generators are
    seeded as the 1-rank run's).  The same keyframes, round starts with
    their budgets, nerfed set and steps; poses within 1 mm and 0.2 deg; the
    reduce launched on every rank, as often as in the 1-rank run; every
    rank trained every step; no tracker span on a rank but 0."""
    import torch.distributed as dist

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.utils import profiler

    sys.path.insert(0, _tests_dir())
    from synthetic_cube import make_cube_sequence

    data = make_cube_sequence(n_frames=6, deg_per_frame=3.0)
    one = None
    if mesh.rank == 0:
        reset_counts()
        one = joint_loop(entry.build_pipeline(small_track_cfg(),
                                              small_nof_cfg().merged(JOINT_DP_SMALL),
                                              start_nerf_keyframes=3, device=mesh.device),
                         data, 6)
        one["launches"] = read_counts()
        one["graph"] = read_graph_counts()
    dist.barrier()
    profiler.reset()
    reset_counts()
    t0 = time.perf_counter()
    pipe = entry.build_pipeline(small_track_cfg(),
                                small_nof_cfg().merged({**JOINT_DP_SMALL,
                                                        "dp_devices": mesh.size}),
                                start_nerf_keyframes=3, device=mesh.device)
    if pipe.lead:
        two = joint_loop(pipe, data, 6)
    else:
        pipe.follow()
    counts = dp_counts(mesh)
    res = {"phase": "joint_dp_small_parity", "ranks": mesh.size, "frames": 6,
           "hw": [96, 96], "launches_by_rank": counts,
           "steps_by_rank": dp_every(mesh, pipe.nof.total_step if pipe.nof else 0),
           "tracker_spans_by_rank": dp_every(mesh, tracked_spans()),
           "has_tracker_by_rank": dp_every(mesh, pipe.bundler is not None),
           "phase_s_by_rank": dp_every(mesh, time.perf_counter() - t0)}
    if mesh.rank:
        return res
    diffs = [pose_diff(a, b) for a, b in zip(two["poses"], one["poses"])]
    max_t, max_r = max(d[0] for d in diffs), max(d[1] for d in diffs)
    res.update({k: two[k] for k in ("keyframes", "rounds", "nerfed", "status", "steps",
                                    "mesh_vertices", "surface_dist_m")},
               one_rank={k: one[k] for k in ("keyframes", "rounds", "nerfed", "steps",
                                             "launches", "graph", "surface_dist_m")},
               max_pose_diff_m=max_t, max_pose_diff_deg=max_r)
    for key in ("keyframes", "rounds", "nerfed", "status", "steps"):
        if two[key] != one[key]:
            raise AssertionError(f"joint_dp_small_parity: {key} 2 ranks {two[key]}, "
                                 f"1 rank {one[key]}")
    if not two["rounds"] or not two["nerfed"]:
        raise AssertionError("joint_dp_small_parity: no NOF round completed")
    if not (max_t < 1e-3 and max_r < 0.2):
        raise AssertionError(f"joint_dp_small_parity: poses differ by {max_t} m, {max_r} deg")
    # the 1-rank loop replays its captured step (and ran a warm-up step a
    # capture); the ranks step eagerly: the reduce of the steps trained
    g1 = one["graph"]
    red = one["launches"]["reduce_cell_cache_grad"]
    red = red * g1["replays"] // max(g1["replays"] + g1["warmup_steps"], 1)
    if red == 0 or counts["reduce_cell_cache_grad"] != [red] * mesh.size:
        raise AssertionError(f"joint_dp_small_parity: reduce launches {counts} by rank, "
                             f"1 rank {red} in {g1['replays']} steps")
    if res["steps_by_rank"] != [two["steps"]] * mesh.size:
        raise AssertionError(f"joint_dp_small_parity: steps by rank {res['steps_by_rank']}")
    if res["tracker_spans_by_rank"][1:] != [0] * (mesh.size - 1) or \
            res["has_tracker_by_rank"][1:] != [0] * (mesh.size - 1):
        raise AssertionError(f"joint_dp_small_parity: a rank but 0 tracked: {res}")
    d = two["surface_dist_m"]
    if d is None or two["mesh_vertices"] <= 50 or not d < 0.03:
        raise AssertionError(f"joint_dp_small_parity: mesh off the cube: {d}")
    return res


def dp_phase_joint(mesh, out_dir: str) -> dict:
    """The joint phase's cut over the mesh's ranks: entry.build_pipeline with
    the shipped configs, dp_devices the group's size and JOINT_DEPTH, on
    the tracking video's first JOINT_FRAMES frames (480 x 640), writing the
    artifact trail (SPDLOG 2) into ``out_dir`` from rank 0.  Rank 0 tracks;
    the others follow.  The launch counts set to 0 just before the first
    frame and read after on_finish: the reduce twice a NOF step on every
    rank, every rank trains every step; 0 FAIL, mean ADD under 1 cm, the
    mesh within 3 cm of the cube; frame ms on rank 0."""
    import numpy as np
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_nof_config, default_track_config
    from bundlesdf_tpu_torch.utils import profiler

    cfg_nof = default_nof_config()
    cfg_nof.update(JOINT_DEPTH, dp_devices=mesh.size)
    cfg_track = default_track_config()
    cfg_track["SPDLOG"] = 2
    video = synth_video(JOINT_FRAMES, *TRACK_HW, TRACK_DEG) if mesh.rank == 0 else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = entry.build_pipeline(cfg_track, cfg_nof, start_nerf_keyframes=JOINT_START,
                                device=mesh.device, save_artifacts=True, out_dir=out_dir)
    rounds = count_rounds(pipe) if pipe.lead else []
    profiler.reset()
    reset_counts()
    t0 = time.perf_counter()
    if pipe.lead:
        ms, status = run_tracker(pipe, video, range(JOINT_FRAMES))
        t1 = time.perf_counter()
        mesh_out = pipe.on_finish()
        torch.cuda.synchronize()
        finish_ms = (time.perf_counter() - t1) * 1e3
    else:
        pipe.follow()
        torch.cuda.synchronize()
    counts = dp_counts(mesh)
    steps = dp_every(mesh, pipe.nof.total_step if pipe.nof else 0)
    spans = profiler.stats()
    res = {"phase": "joint_dp", "ranks": mesh.size, "frames": JOINT_FRAMES,
           "hw": list(TRACK_HW), "config": "default configs, dp_devices "
           f"{mesh.size}, " + json.dumps(JOINT_DEPTH) + " (depth cut), SPDLOG 2",
           "launches_by_rank": counts, "steps_by_rank": steps,
           "tracker_spans_by_rank": dp_every(mesh, tracked_spans()),
           "train_advance_s_by_rank": dp_every(
               mesh, spans.get("nof/train_advance", {"total_s": 0.0})["total_s"]),
           "phase_s_by_rank": dp_every(mesh, time.perf_counter() - t0),
           "peak_mem_gb_by_rank": dp_every(mesh, torch.cuda.max_memory_allocated() / 1e9)}
    if mesh.rank:
        return res
    tr = track_result(pipe, video, status)
    surf = (cube_surface_dist(mesh_out, pipe, video["gt"][0], 0.15)
            if mesh_out is not None and len(mesh_out.vertices) else None)
    res.update({"frame_ms_median": float(np.median(ms)), "frame_ms_max": float(np.max(ms)),
                "frame_ms": ms, "on_finish_ms": finish_ms, "rounds": rounds,
                "nerfed": [f.id for f in pipe.bundler.keyframes if f.nerfed],
                "calibrate_step_ms": pipe.nof._step_ms if pipe.nof else None,
                "nof_span_mean_ms": {k: v["mean_s"] * 1e3 for k, v in spans.items()
                                     if k.startswith("nof/")},
                "trail_frames": len(os.listdir(os.path.join(out_dir, "color_segmented"))),
                "mesh_vertices": len(mesh_out.vertices) if mesh_out is not None else 0,
                "mesh_surface_dist_median_m": surf, "n_fail": len(tr["fail_frames"]),
                **tr})
    if tr["fail_frames"] or not tr["mean_add_m"] < 0.01:
        raise AssertionError(f"joint_dp: FAIL {tr['fail_frames']}, mean ADD "
                             f"{tr['mean_add_m']} m")
    if not rounds or not res["nerfed"] or steps != [steps[0]] * mesh.size or not steps[0]:
        raise AssertionError(f"joint_dp: rounds {rounds}, steps by rank {steps}")
    if counts["reduce_cell_cache_grad"] != [2 * int(steps[0])] * mesh.size:
        raise AssertionError(f"joint_dp: reduce launches {counts} != 2 x {steps} on "
                             "every rank")
    if res["tracker_spans_by_rank"][1:] != [0] * (mesh.size - 1):
        raise AssertionError(f"joint_dp: a rank but 0 tracked: {res['tracker_spans_by_rank']}")
    if surf is None or res["mesh_vertices"] <= 50 or not surf < 0.03:
        raise AssertionError(f"joint_dp: mesh {res['mesh_vertices']} vertices, median "
                             f"surface distance {surf}")
    if res["trail_frames"] != JOINT_FRAMES:
        raise AssertionError(f"joint_dp: rank 0's trail holds {res['trail_frames']} frames")
    return res


def dp_worker(out_dir: str) -> int:
    """One rank of the dp group (``--dp-worker DIR``): joins through the
    BSDF_* variables, runs every dp phase, and rank 0 appends each phase's
    result to DIR/dp_phases.jsonl."""
    import torch
    import torch.distributed as dist

    from bundlesdf_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not distributed.init_multihost(backend="gloo"):
        raise RuntimeError("--dp-worker needs BSDF_COORDINATOR, BSDF_NUM_PROCESSES "
                           "and BSDF_PROCESS_ID")
    mesh = distributed.global_mesh()
    phases = (dp_phase_small_parity, dp_phase_train,
              lambda m: dp_phase_global_refine(m, os.path.join(out_dir, "run")),
              dp_phase_ba, dp_phase_loftr, dp_phase_joint_small_parity,
              lambda m: dp_phase_joint(m, os.path.join(out_dir, "joint_dp")))
    for phase in phases:
        res = phase(mesh)
        if mesh.rank == 0:
            with open(os.path.join(out_dir, "dp_phases.jsonl"), "a") as f:
                f.write(json.dumps(res) + "\n")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dp(trail: str, root: str) -> dict:
    """Run the dp phases in one group of DP_RANKS worker processes of this
    script (``sys.executable``: this process holds a CUDA context, so no
    fork), on a copy of the joint phase's trail with its cam_K.txt.  The
    kernel library is built already (main).  A worker that fails or runs
    past DP_TIMEOUT_S stops every worker and fails the script.  Returns the
    phases' results by name."""
    import gc
    import shutil

    import torch

    dp_dir = os.path.join(root, "dp")
    shutil.copytree(trail, os.path.join(dp_dir, "run"))
    shutil.copy(os.path.join(os.path.dirname(trail), "cam_K.txt"), dp_dir)
    for name in ("textured_mesh.obj", "textured_mesh.mtl", "textured_mesh.png",
                 "poses_after_global_refine.txt"):
        path = os.path.join(dp_dir, "run", name)
        if os.path.exists(path):
            os.remove(path)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    env = dict(os.environ, BSDF_COORDINATOR=f"localhost:{_free_port()}",
               BSDF_NUM_PROCESSES=str(DP_RANKS))
    logs = [open(os.path.join(dp_dir, f"rank{r}.log"), "w") for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                               dp_dir], env=dict(env, BSDF_PROCESS_ID=str(r)),
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
             for r in range(DP_RANKS)]
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if bad or time.perf_counter() - t0 > DP_TIMEOUT_S:
                raise AssertionError(f"dp workers: exit codes {[p.poll() for p in procs]} "
                                     f"after {time.perf_counter() - t0:.0f} s")
            time.sleep(0.5)
        if any(p.returncode for p in procs):
            raise AssertionError(f"dp workers: exit codes {[p.returncode for p in procs]}")
    except AssertionError:
        for f in logs:
            f.flush()
        for r in range(DP_RANKS):
            with open(os.path.join(dp_dir, f"rank{r}.log")) as f:
                print(f"--- dp rank {r}\n" + f.read()[-6000:], file=sys.stderr)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    with open(os.path.join(dp_dir, "dp_phases.jsonl")) as f:
        out = {r["phase"]: r for r in map(json.loads, f)}
    out["group_s"] = time.perf_counter() - t0
    return out


def summary(train: dict, scatter_train: dict, joint: dict, glob: dict, cli: dict,
            ho3d: dict, legacy: dict, loftr_track: dict, rematch: dict,
            loftr_par: dict, more_launches: dict, opts: dict, sift_par: dict) -> dict:
    """The contract line: one entry per kernel, times summed over one online
    train step's launches on that step's inputs; ``launches_joint``,
    ``launches_global``, ``launches_cli`` (run_video and global_refine of
    the run_custom script, summed), ``launches_ho3d``,
    ``launches_tracking_legacy``, ``launches_loftr`` and
    ``launches_rematch`` are the counts from those phases' runs, and the
    reduce's ``global`` holds its sums over the 5 shapes of one offline
    microbatch.  ``loftr_forward_ms``: LoFTR's forward on the card at the
    host-warp path's batches 1 and 16 (loftr_parity; no hand-written
    kernel).  ``more_launches``: further ``launches_<phase>`` counts (the
    NOF options', the LoFTR trainer's and the SIFT and remote engines'
    phases); the reduce's ``options`` holds its sums over the launches of
    one nof_train_step_options step.  ``sift_predict_ms_per_pair``: the
    card's SiftMatcher.predict at batch 1 and 16 (sift_parity; no
    hand-written kernel)."""
    red = train["in_situ"]["reduce_cell_cache_grad"]
    sca = scatter_train["in_situ"]["fused_cache_scatter"]

    def total(rows, key):
        return sum(r[key] for r in rows)

    def lib(rows):
        vals = [r["library_ms"] for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    def times(rows):
        b_ms, b_by = bound(total(rows, "bytes"), total(rows, "ops"))
        return {"max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": total(rows, "kernel_ms"), "plain_ms": total(rows, "plain_ms"),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib(rows)}

    def entry(name, source, replaces, rows, launches):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_joint": joint["kernel_launches"][name],
                "launches_global": glob["kernel_launches"][name],
                "launches_cli": cli["kernel_launches_run_video"][name]
                + cli["kernel_launches_global_refine"][name],
                "launches_ho3d": ho3d["kernel_launches"][name],
                "launches_tracking_legacy": legacy["kernel_launches"][name],
                "launches_loftr": loftr_track["kernel_launches"][name],
                "launches_rematch": rematch["kernel_launches"][name],
                **{k: v[name] for k, v in more_launches.items()}, **times(rows)}

    reduce_entry = entry("reduce_cell_cache_grad",
                         "bundlesdf_tpu_torch/csrc/reduce_cell_cache_grad.cu",
                         "bundlesdf_tpu/ops/reduce_pallas.py:102", red,
                         train["launches"]["reduce_cell_cache_grad"])
    reduce_entry["global"] = {"R": [r["R"] for r in glob["reduce_in_situ"]],
                              **times(glob["reduce_in_situ"])}
    opt_rows = opts["in_situ"]["reduce_cell_cache_grad"]
    reduce_entry["options"] = {"R": [r["R"] for r in opt_rows], **times(opt_rows)}
    return {"kernels": [
        reduce_entry,
        entry("fused_cache_scatter",
              "bundlesdf_tpu_torch/csrc/fused_cache_scatter.cu",
              "bundlesdf_tpu/ops/hashgrid_pallas.py:95", sca,
              scatter_train["launches"]["fused_cache_scatter"]),
    ], "loftr_forward_ms": loftr_par["forward_ms"],
        "sift_predict_ms_per_pair": sift_par["predict_ms_per_pair"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile each train phase, 2 more tracked frames and "
                         "one more offline step after the timed runs and write "
                         "their kernel tables to DIR")
    ap.add_argument("--dp-worker", metavar="DIR",
                    help="(internal) run as one rank of the dp phases' group")
    args = ap.parse_args()

    import torch

    if args.dp_worker:
        return dp_worker(args.dp_worker)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one GPU",
              file=sys.stderr)
        return 1
    from bundlesdf_tpu_torch.ops import _cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    emit({"phase": "setup", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "allow_tf32_matmul": False, "allow_tf32_cudnn": False})

    t0 = time.perf_counter()
    info = _cuda_lib.build(force=True)
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or ln.startswith("==")]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(_cuda_lib.SOURCES), "arch": "sm_90a",
          "library": os.path.relpath(info["path"]), "ptxas": ptxas})

    emit(phase_kernels(device))
    phase_depth_frame(device)
    phase_covisibility(device)
    emit(phase_small_parity(device))
    phase_nof_train_graph_parity(device)

    train, train_ctx = run_train("nof_train_step", None, TRAIN_STEPS, device)
    if train["launches"]["reduce_cell_cache_grad"] != 2 * train["steps_run"]:
        raise AssertionError(f"reduce launches {train['launches']} != 2/step "
                             f"({train['steps_run']} steps run)")
    if not train["loss_last"] < train["loss_first"]:
        raise AssertionError(
            f"loss did not fall: {train['loss_first']} -> {train['loss_last']}")
    emit(train)

    sc, sc_ctx = run_train("nof_train_step_pallas_scatter", "pallas",
                           SCATTER_STEPS, device)
    if sc["launches"]["fused_cache_scatter"] != sc["steps_run"]:
        raise AssertionError(f"scatter launches {sc['launches']} != 1/step "
                             f"({sc['steps_run']} steps run)")
    emit(sc)

    seg, seg_ctx = run_train("nof_train_step_seg", "seg", TRAIN_STEPS, device)
    if seg["launches"] != {"reduce_cell_cache_grad": 2 * seg["steps_run"],
                           "fused_cache_scatter": 0}:
        raise AssertionError(f"seg launches {seg['launches']} != reduce 2/step "
                             f"({seg['steps_run']} steps run)")
    if not seg["loss_last"] < seg["loss_first"]:
        raise AssertionError(
            f"seg loss did not fall: {seg['loss_first']} -> {seg['loss_last']}")
    seg["levels"] = seg_levels(seg_ctx)
    seg["nof_train_step"] = {k: train[k] for k in (
        "step_ms", "step_ms_eager", "graph_pool_gb", "peak_mem_gb")}
    emit(seg)
    opt_par = phase_nof_options_small_parity(device)
    exact, _ = run_train("nof_train_step_exact", None, OPTION_STEPS, device, OPTIONS_EXACT)
    opts, _ = run_train("nof_train_step_options", None, OPTION_STEPS, device,
                        OPTIONS_RESAMPLE_EIKONAL)
    check_options_steps(exact, opts)
    emit(exact)
    emit(opts)
    emit(phase_tracking_small_parity(device))
    track, track_ctx = phase_tracking(device, bool(args.profile))
    loftr_par = phase_loftr_parity(device, track_ctx[1])
    legacy = phase_tracking_legacy(device, track_ctx[1])
    loftr_track = phase_tracking_loftr(track_ctx[1])
    sift_par = phase_sift_parity(device, track_ctx[1])
    sift_track = phase_tracking_sift(device, track_ctx[1])
    phase_joint_small_parity(device)
    phase_global_refine_small_parity(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        trail = os.path.join(tmp, "run")
        joint, joint_pipe = phase_joint(device, track_ctx[1], trail)
        rematch = phase_joint_rematch(device, track_ctx[1])
        remote = phase_joint_remote(device, track_ctx[1])
        glob, glob_nof = phase_global_refine(device, joint_pipe, track_ctx[1], trail)
        cli = phase_cli(track_ctx[1], os.path.join(tmp, "cli"))
        ho3d = phase_ho3d(track_ctx[1], os.path.join(tmp, "HO3D_v3"))
        codecs = phase_codecs(track_ctx[1], os.path.join(tmp, "HO3D_v3", "evaluation", "SM1"),
                              os.path.join(tmp, "HO3D_codecs"), smi[0])
        loftr_tr = phase_loftr_train(device, track_ctx[1], os.path.join(tmp, "loftr"))
        synth = phase_synth_eval(tmp)
        dp = phase_dp(trail, tmp)
    dp["nof_train_step_dp"]["nof_train_step_step_ms"] = train["step_ms"]
    dp["joint_dp"]["joint_frame_ms_median"] = joint["frame_ms_median"]
    for name in ("dp_small_parity", "nof_train_step_dp", "global_refine_dp", "ba_shard",
                 "loftr_train_dp", "joint_dp_small_parity", "joint_dp"):
        emit(dp[name])
    emit({"phase": "dp_group", "ranks": DP_RANKS, "backend": "gloo",
          "group_s": dp["group_s"]})
    if args.profile:
        emit(profile_phase(train["phase"], train_ctx, train["step_ms"],
                           args.profile))
        emit(profile_phase(sc["phase"], sc_ctx, sc["step_ms"], args.profile))
        emit(profile_phase(seg["phase"], seg_ctx, seg["step_ms"], args.profile))
        emit(profile_tracking(track_ctx, args.profile))
        emit(profile_global(glob_nof, glob["step_ms"], args.profile))

    emit(summary(train, sc, joint, glob, cli, ho3d, legacy, loftr_track, rematch, loftr_par,
                 {"launches_options_small_parity": {
                     k: opt_par["exact"]["launches"][k] + opt_par["cell"]["launches"][k]
                     for k in opt_par["cell"]["launches"]},
                  "launches_train_seg": seg["launches"],
                  "launches_train_exact": exact["launches"],
                  "launches_train_options": opts["launches"],
                  "launches_loftr_train": loftr_tr["kernel_launches"],
                  "launches_sift_parity": sift_par["kernel_launches"],
                  "launches_tracking_sift": sift_track["kernel_launches"],
                  "launches_joint_remote": remote["kernel_launches"],
                  "launches_dp_small_parity_by_rank": {
                      k: [sum(c) for c in zip(*(dp["dp_small_parity"][v]["launches_by_rank"][k]
                                                 for v in DP_SMALL_VARIANTS))]
                      for k in opts["launches"]},
                  "launches_train_dp_by_rank": dp["nof_train_step_dp"]["launches_by_rank"],
                  "launches_global_refine_dp_by_rank":
                      dp["global_refine_dp"]["launches_by_rank"],
                  "launches_joint_dp_small_parity_by_rank":
                      dp["joint_dp_small_parity"]["launches_by_rank"],
                  "launches_joint_dp_by_rank": dp["joint_dp"]["launches_by_rank"],
                  "launches_synth_eval": synth["kernel_launches"],
                  "launches_codecs": codecs["kernel_launches"]},
                 opts, sift_par))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
