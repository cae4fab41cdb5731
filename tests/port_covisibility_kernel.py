"""Frames that exercise every rule of the tracker's covisibility, and
``csrc/covisibility.cu``'s kernel compiled for the host (not collected).

``hard_frames`` and ``hard_queries`` are read by
``tests/test_torch_covisibility_cuda.py`` and by ``chip_smoke.py``'s
``covisibility`` phase: a tilted plane whose normals sit at exactly the
visible angle to the eye, a sphere seen from inside and outside, holes and
zero depth, gaps in ``fg_mask``, and the identity, opposite and random
poses between the frames.

``host_kernel`` builds the kernel's source with g++ as plain C++, with
``tests/port_depth_kernel.py``'s prelude (each ``_rn`` intrinsic one
rounded host operation, nothing fused) and the warp intrinsics of a warp of
one thread: the grid runs block after block with one thread a block, so
each block's loops cover its whole chunk and ``__syncthreads`` has nothing
to wait for.  ``__fmaf_rn`` is ``std::fma``, correctly rounded as the
card's is.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import types

import numpy as np

from port_depth_kernel import _PRELUDE, REPO

SOURCE = os.path.join(REPO, "bundlesdf_tpu_torch", "csrc", "covisibility.cu")

_WARP = r"""
#include <algorithm>
using std::min;
static inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
static inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline int __syncthreads_or(int p) { return p != 0; }
static inline unsigned atomicAdd(unsigned* a, unsigned v) { unsigned o = *a; *a = o + v; return o; }
"""

_LAUNCHER = r"""
extern "C" int host_covisibility(const uint64_t* maps, const int* n_points, const int* q_begin,
    const float* rel, int n_groups, int max_points, float thres, unsigned* counts,
    unsigned* totals) {
  blockDim.x = 1; threadIdx.x = 0;
  for (int g = 0; g < n_groups; ++g)
    for (int bx = 0; bx < max_points; ++bx) {
      blockIdx.x = bx; blockIdx.y = g;
      covisibility_kernel(maps, n_points, q_begin, rel, thres, counts, totals);
    }
  return 0;
}
"""


def host_kernel(out_dir: str):
    """Build the kernel for the host into ``out_dir``; returns ``run(maps,
    sizes, q_begin, rel, thres)`` -> (counts, totals) as
    ``ops/covisibility_cuda.py::_count`` returns them, with ``maps`` host
    uint8 arrays (or CPU tensors) packed by ``pack_maps``."""
    body = open(SOURCE).read().split('extern "C"')[0].replace("#include <cuda_runtime.h>", "")
    cpp = os.path.join(out_dir, "covisibility_host.cpp")
    lib = os.path.join(out_dir, "libcovisibility_host.so")
    with open(cpp, "w") as f:
        f.write(_PRELUDE + _WARP + body + _LAUNCHER)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o", lib, cpp],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).host_covisibility
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, P, P, I, I, F, P, P]

    def run(maps, sizes, q_begin, rel, thres):
        maps = [np.ascontiguousarray(np.asarray(m), np.uint8) for m in maps]
        ptrs = np.array([m.ctypes.data for m in maps], np.uint64)
        sizes = np.ascontiguousarray(sizes, np.int32)
        q_begin = np.ascontiguousarray(q_begin, np.int32)
        rel = np.ascontiguousarray(rel, np.float32)
        counts = np.zeros(len(rel), np.uint32)
        totals = np.zeros(len(maps), np.uint32)
        fn(ptrs.ctypes.data, sizes.ctypes.data, q_begin.ctypes.data, rel.ctypes.data,
           len(maps), int(sizes.max()), thres, counts.ctypes.data, totals.ctypes.data)
        return counts, totals

    return run


def pose(R, t) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def rot(axis, deg) -> np.ndarray:
    """Rotation by ``deg`` about ``axis`` (Rodrigues), f64."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = np.deg2rad(deg)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def make_frame(id, xyz, normals, valid, fg_mask=None, pose_in_model=None):
    """A stand-in for ``tracking.frame.Frame`` with the attributes the twin
    and the kernel's wrapper read."""
    H, W = valid.shape
    return types.SimpleNamespace(
        id=id, version=0, xyz=np.asarray(xyz, np.float32),
        normals=np.asarray(normals, np.float32), valid=np.asarray(valid, bool),
        fg_mask=np.ones((H, W), bool) if fg_mask is None else np.asarray(fg_mask, bool),
        pose_in_model=np.eye(4, dtype=np.float32) if pose_in_model is None
        else np.asarray(pose_in_model, np.float32))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def hard_frames(H: int, W: int, seed: int, visible_angle_deg: float = 70.0) -> list:
    """Frames of (H, W) pixels from ``seed``: a tilted plane whose every
    normal makes exactly ``visible_angle_deg`` with its eye ray (in f64,
    before the f32 rounding), with holes (zero depth, valid off) and gaps
    in ``fg_mask``; a sphere of radius 0.2 m at 0.6 m with outward normals;
    the same sphere's inside; noisy normals on a step.  Each frame has a
    random pose."""
    rng = np.random.default_rng(seed)
    poses = [pose(rot(rng.normal(size=3), rng.uniform(0, 180)), rng.uniform(-0.3, 0.3, 3))
             for _ in range(4)]
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    f = 500.0 * W / 640.0
    rays = np.stack([(u - W / 2) / f, (v - H / 2) / f, np.ones_like(u)], -1)
    out = []
    # the tilted plane, its normals on the cone of the visible angle
    n0 = _unit(np.array([0.3, -0.2, -1.0]))
    d = 0.5 / np.einsum("hwk,k->hw", rays, -n0)
    xyz = rays * d[..., None]
    eye = _unit(-xyz)
    side = _unit(np.cross(eye, rng.normal(size=3)))
    th = np.deg2rad(visible_angle_deg)
    nrm = np.cos(th) * eye + np.sin(th) * side
    valid = rng.uniform(size=(H, W)) > 0.05
    xyz[~valid] = 0.0
    nrm[~valid] = 0.0
    fg = np.ones((H, W), bool)
    fg[H // 4:H // 2, W // 3:W // 2] = False
    fg[rng.uniform(size=(H, W)) < 0.03] = False
    out.append(make_frame(0, xyz, nrm, valid, fg, poses[0]))
    # a sphere, outside and inside
    c = np.array([0.02, -0.01, 0.6])
    b = np.einsum("hwk,k->hw", rays, c)
    rr = np.einsum("hwk,hwk->hw", rays, rays)
    disc = b * b - rr * (c @ c - 0.2 ** 2)
    hit = disc > 0
    t_near = np.where(hit, (b - np.sqrt(np.maximum(disc, 0))) / rr, 0.0)
    t_far = np.where(hit, (b + np.sqrt(np.maximum(disc, 0))) / rr, 0.0)
    for k, (t, sign) in enumerate(((t_near, 1.0), (t_far, -1.0))):
        xyz = rays * t[..., None]
        nrm = sign * _unit(xyz - c + 1e-30)
        hole = hit & (rng.uniform(size=(H, W)) < 0.02)
        valid = hit & ~hole
        xyz[~valid] = 0.0
        nrm[~valid] = 0.0
        out.append(make_frame(1 + k, xyz, nrm, valid, rng.uniform(size=(H, W)) > 0.1,
                              poses[1 + k]))
    # a step with noisy normals
    d = np.where(u < W / 2, 0.45, 0.55) + rng.normal(0, 1e-3, (H, W))
    xyz = rays * d[..., None]
    nrm = _unit(np.array([0.0, 0.0, -1.0]) + rng.normal(0, 0.6, (H, W, 3)))
    valid = rng.uniform(size=(H, W)) > 0.1
    xyz[~valid] = 0.0
    nrm[~valid] = 0.0
    out.append(make_frame(3, xyz, nrm, valid, pose_in_model=poses[3]))
    return out


def hard_queries(frames: list, n_random: int, seed: int) -> list:
    """(fa, fb) pairs over ``frames``: for each frame as A, a B at A's own
    pose (identity), at A's pose turned 180 degrees about the y axis through
    the scene (opposite), and ``n_random`` Bs at random poses around A's
    (turns up to 60 degrees, shifts up to 0.2 m)."""
    rng = np.random.default_rng(seed)
    centre = np.array([0.0, 0.0, 0.55])
    pairs = []
    for fa in frames:
        # B's camera in A's: B's pose is A's pose after it
        opp = pose(rot([0, 1, 0], 180.0), centre - rot([0, 1, 0], 180.0) @ centre)
        bs = [fa.pose_in_model.copy(), fa.pose_in_model @ opp]
        for _ in range(n_random):
            R = rot(rng.normal(size=3), rng.uniform(0, 60))
            t = centre - R @ centre + rng.uniform(-0.2, 0.2, 3)
            bs.append(fa.pose_in_model @ pose(R, t))
        for k, P in enumerate(bs):
            pairs.append((fa, make_frame(100 + 1000 * fa.id + k, fa.xyz[:1, :1],
                                         fa.normals[:1, :1], fa.valid[:1, :1],
                                         pose_in_model=P)))
    return pairs


def f64_dots(fa, fb) -> tuple:
    """(dots, keep) of A's stride-2 points in float64, from the f32 maps and
    the f32 relative transform, as the twin forms them."""
    from bundlesdf_tpu_torch.tracking.frame import relative_transform

    rel_R, rel_t = relative_transform(fa, fb)
    R, t = np.asarray(rel_R, np.float64), np.asarray(rel_t, np.float64)
    pts = fa.xyz[::2, ::2].reshape(-1, 3).astype(np.float64)
    nrm = fa.normals[::2, ::2].reshape(-1, 3).astype(np.float64)
    p = pts @ R.T + t
    n = nrm @ R.T
    dots = np.einsum("ik,ik->i", -p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-10),
                     n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-10))
    return dots, (fa.valid & fa.fg_mask)[::2, ::2].reshape(-1)


def f64_count(fa, fb, visible_angle_deg: float) -> int:
    """The count in float64 from the same f32 inputs."""
    dots, keep = f64_dots(fa, fb)
    return int((keep & (dots > np.cos(np.deg2rad(visible_angle_deg)))).sum())


def near_threshold(fa, fb, visible_angle_deg: float, tol: float = 1e-5) -> int:
    """A's kept stride-2 points whose float64 dot lies within ``tol`` of the
    threshold: the points where f32 rounding in another order can flip the
    test."""
    dots, keep = f64_dots(fa, fb)
    return int((keep & (np.abs(dots - np.cos(np.deg2rad(visible_angle_deg))) < tol)).sum())
