"""Depth frames that exercise every rule of the tracker's depth pipeline,
and ``csrc/depth_frame.cu``'s kernel compiled for the host (not collected).

``hard_depth_frames`` is read by ``tests/test_torch_depth_cuda.py`` and by
``chip_smoke.py``'s ``depth_frame`` phase: a plane tilted up to grazing,
a step, noise, holes, a patch beyond zfar, pixels at exactly 0.1 m, just
above it and at zfar, with fg and occ masks on some frames.

``host_kernel`` builds the kernel's source with g++ as plain C++: the CUDA
keywords and ``threadIdx`` / ``blockIdx`` become host definitions, each
``_rn`` intrinsic one rounded host operation (``-ffp-contract=off``, and
``volatile`` so that nothing is fused), and the grid runs block after block
with one thread a block, so that each stage's loop covers its whole window
and ``__syncthreads`` has nothing to wait for.  ``expf`` is the host
libm's, as the card's is CUDA's: neither is numpy's, and at the shipped
sigma_R every range weight is 1.0 in all three.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "bundlesdf_tpu_torch", "csrc", "depth_frame.cu")


def hard_k(H: int, W: int) -> np.ndarray:
    """K of the hard frames: fx != fy, the principal point off the centre
    by a fraction of a pixel (500, 505, 317.3, 241.7 at 480 x 640)."""
    s = W / 640.0
    return np.array([[500.0 * s, 0, W / 2 - 2.7], [0, 505.0 * s, H / 2 + 1.7], [0, 0, 1]],
                    np.float32)


def hard_depth_frames(n: int, H: int, W: int, seed: int) -> list:
    """``n`` (depth f32, fg mask or None, occ mask or None) from ``seed``."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    out = []
    for k in range(n):
        ang = np.deg2rad(rng.uniform(0, 89))
        d = 0.5 + np.tan(ang) * (u - W / 2) / 640 * 0.2 + 0.05 * (v - H / 2) / 480
        d = d + rng.normal(0, [0, 1e-5, 1e-4, 3e-4][k % 4], (H, W))
        d[:, W // 3: W // 3 + W // 5] += rng.uniform(0.002, 0.08)
        d[H // 2:, :] -= rng.uniform(0.0, 0.1)
        d[rng.uniform(size=(H, W)) < rng.uniform(0.0, 0.03)] = 0.0
        y0, x0 = rng.integers(0, max(H - H // 8, 1)), rng.integers(0, max(W - W // 8, 1))
        d[y0:y0 + H // 8, x0:x0 + W // 8] = 1.5
        t = rng.uniform(size=(H, W))
        d[t < 0.003] = np.float32(0.1)
        d[(t > 0.5) & (t < 0.503)] = 1.0
        d[(t > 0.6) & (t < 0.603)] = np.nextafter(np.float32(0.1), np.float32(1))
        d = np.clip(d, 0, 3).astype(np.float32)
        fg = rng.uniform(size=(H, W)) > 0.02 if k % 2 else None
        occ = rng.uniform(size=(H, W)) < 0.02 if k % 3 == 0 else None
        out.append((d, fg, occ))
    return out


_PRELUDE = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __grid_constant__
#define __launch_bounds__(x)
#define __shared__
struct uint3 { unsigned x, y, z; };
struct float3 { float x, y, z; };
static inline float3 make_float3(float a, float b, float c) { return {a, b, c}; }
static uint3 threadIdx, blockIdx, blockDim;
static inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
static inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
static inline float __fsqrt_rn(float a) { return std::sqrt(a); }
static inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
static inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
static inline float __double2float_rn(double a) { return (float)a; }
static inline void __syncthreads() {}
namespace { float smem[1 << 16]; }
"""

_LAUNCHER = r"""
extern "C" int host_depth_frame(const float* din, const uint8_t* fg, const uint8_t* occ,
    float* dout, float* xyz, float* nrm, uint8_t* valid, int H, int W, float fx, float fy,
    float cx, float cy, float zfar, int er, float ediff, float eratio, int br,
    const double* ws, float inv_2sr2, double min_cos) {
  Params p;
  p.H = H; p.W = W; p.erode_r = er; p.bil_r = br; p.halo = er + 2 * br + 1;
  if (p.halo > kMaxHalo) return 1;
  p.fx = fx; p.fy = fy; p.cx = cx; p.cy = cy; p.zfar = zfar;
  p.erode_diff = ediff; p.erode_ratio = eratio; p.inv_2sr2 = inv_2sr2; p.min_cos = min_cos;
  const int nw = (2 * br + 1) * (2 * br + 1);
  for (int k = 0; k < kMaxWeights; ++k) p.ws[k] = k < nw ? ws[k] : 0.0;
  blockDim.x = 1; threadIdx.x = 0;
  for (int by = 0; by < (H + kTileY - 1) / kTileY; ++by)
    for (int bx = 0; bx < (W + kTileX - 1) / kTileX; ++bx) {
      blockIdx.x = bx; blockIdx.y = by;
      std::memset(smem, 0x7f, sizeof(smem));  // a read of an unwritten cell shows
      depth_frame_kernel(din, fg, occ, dout, xyz, nrm, valid, p);
    }
  return 0;
}
"""


def host_kernel(out_dir: str):
    """Build the kernel for the host into ``out_dir``; returns ``run(depth,
    K, fg, occ, **params)`` -> (depth, xyz, normals, valid) as the wrapper
    returns them."""
    from bundlesdf_tpu_torch.ops import depth_cuda

    body = open(SOURCE).read().split('extern "C"')[0].replace("#include <cuda_runtime.h>", "")
    cpp = os.path.join(out_dir, "depth_frame_host.cpp")
    lib = os.path.join(out_dir, "libdepth_frame_host.so")
    with open(cpp, "w") as f:
        f.write(_PRELUDE + body + _LAUNCHER)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o", lib, cpp],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).host_depth_frame
    P, I, F, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    fn.argtypes = [P] * 7 + [I, I, F, F, F, F, F, I, F, F, I, P, F, D]
    f32 = depth_cuda._f32

    def run(depth, K, fg=None, occ=None, *, zfar, erode_radius, erode_diff, erode_ratio,
            bilateral_radius, sigma_d, sigma_r, edge_normal_thres_deg):
        H, W = depth.shape
        depth = np.ascontiguousarray(depth, np.float32)
        fg8 = np.ones((H, W), np.uint8) if fg is None else (np.asarray(fg) > 0).astype(np.uint8)
        occ8 = None if occ is None else (np.asarray(occ) > 0).astype(np.uint8)
        d = np.empty((H, W), np.float32)
        xyz = np.empty((H, W, 3), np.float32)
        nrm = np.empty((H, W, 3), np.float32)
        valid = np.empty((H, W), np.uint8)
        ws, inv_2sr2, min_cos = depth_cuda.kernel_constants(
            bilateral_radius, sigma_d, sigma_r, edge_normal_thres_deg)
        rc = fn(depth.ctypes.data, fg8.ctypes.data, None if occ8 is None else occ8.ctypes.data,
                d.ctypes.data, xyz.ctypes.data, nrm.ctypes.data, valid.ctypes.data, H, W,
                f32(K[0, 0]), f32(K[1, 1]), f32(K[0, 2]), f32(K[1, 2]), f32(zfar),
                erode_radius, f32(erode_diff), f32(erode_ratio), bilateral_radius,
                ws.ctypes.data, inv_2sr2, min_cos)
        if rc:
            raise ValueError("the kernel does not take these radii")
        return d, xyz, nrm, valid.view(np.bool_)

    return run
