"""Frames that exercise every rule of a keyframe's cloud fusion, and
``csrc/fuse_cloud.cu``'s kernels compiled for the host (not collected).

``cube_frames`` and ``hard_frames`` are read by
``tests/test_torch_fuse_cloud_cuda.py`` and by ``chip_smoke.py``'s
``fuse_cloud`` phase: the joint60 traffic's cube frames
(``portbench/video.py``), and an empty mask, one voxel, points on voxel
faces and at negative coordinates, a lattice of tied neighbour distances,
fewer points than the outlier test's neighbours, and a noisy surface.

``host_launch`` builds the kernels' source with g++ as plain C++, with
``tests/port_depth_kernel.py``'s prelude (each ``_rn`` intrinsic one
rounded host operation, nothing fused): each C entry point of the source
gets a host twin of the same name and arguments that runs the kernel's grid
block after block with one thread a block, so that each block's tile loop
covers its whole tile and ``__syncthreads`` has nothing to wait for.  The
returned ``launch`` stands in for ``ops/_cuda_lib.py::launch``, so the
wrapper's own ``compute`` (the sort and the cumsum in torch on the CPU)
drives the kernels.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as np

from port_depth_kernel import _PRELUDE, REPO

SOURCE = os.path.join(REPO, "bundlesdf_tpu_torch", "csrc", "fuse_cloud.cu")

_HOST = r"""
#include <algorithm>
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
static inline double __ddiv_rn(double a, double b) { volatile double r = a / b; return r; }
static inline double __dsqrt_rn(double a) { return std::sqrt(a); }
static inline int atomicOr(int* a, int v) { int o = *a; *a = o | v; return o; }
"""

_LAUNCHERS = r"""
// one thread a block over a grid of n_x x n_y blocks
#define GRID(n_x, n_y, call)                                         \
  do {                                                               \
    blockDim.x = 1; threadIdx.x = 0;                                 \
    for (unsigned by = 0; by < (unsigned)(n_y); ++by)                \
      for (unsigned bx = 0; bx < (unsigned)(n_x); ++bx) {            \
        blockIdx.x = bx; blockIdx.y = by; call;                      \
      }                                                              \
  } while (0)

extern "C" int fuse_cloud_keys(const void* depth, const void* mask, int n_frames, int H,
                               int W, float fx, float fy, float cx, float cy, float vox,
                               void* keys, void* counts, void*) {
  if (bad_batch(H * W, n_frames) || H < 1 || W < 1) return 1;
  const Camera cam{fx, fy, cx, cy};
  GRID(H * W, n_frames, fuse_keys_kernel((const float*)depth, (const uint8_t*)mask, W,
                                         H * W, cam, vox, (int64_t*)keys, (int*)counts));
  return 0;
}

extern "C" int fuse_cloud_flags(const void* sorted, int n_frames, int hw, void* flags,
                                void*) {
  if (bad_batch(hw, n_frames)) return 1;
  GRID(hw, n_frames, fuse_flags_kernel((const int64_t*)sorted, hw, (int*)flags));
  return 0;
}

extern "C" int fuse_cloud_starts(const void* flags, const void* runs, int n_frames, int hw,
                                 void* starts, void* counts, void*) {
  if (bad_batch(hw, n_frames)) return 1;
  GRID(hw, n_frames, fuse_starts_kernel((const int*)flags, (const int*)runs, hw,
                                        (int*)starts, (int*)counts));
  return 0;
}

extern "C" int fuse_cloud_means(const void* depth, const void* sorted, const void* perm,
                                const void* starts, const void* counts, const void* offsets,
                                int n_frames, int H, int W, float fx, float fy, float cx,
                                float cy, int max_runs, void* pts, void*) {
  if (bad_batch(H * W, n_frames) || H < 1 || W < 1 || max_runs < 1) return 1;
  const Camera cam{fx, fy, cx, cy};
  GRID(max_runs, n_frames,
       fuse_means_kernel((const float*)depth, (const int64_t*)sorted, (const int64_t*)perm,
                         (const int*)starts, (const int*)counts, (const int*)offsets, W,
                         H * W, cam, (double*)pts));
  return 0;
}

extern "C" int fuse_cloud_knn(const void* pts, const void* counts, const void* offsets,
                              int n_frames, int max_runs, int k, void* dist, void*) {
  if (n_frames < 1 || max_runs < 1 || k < 1 || k > kMaxK) return 1;
  GRID(max_runs, n_frames, fuse_knn_kernel((const double*)pts, (const int*)counts,
                                           (const int*)offsets, k, (double*)dist));
  return 0;
}
"""


def host_launch(out_dir: str):
    """Build the kernels for the host into ``out_dir``; returns
    ``launch(dev, name, *args)``, ``_cuda_lib.launch``'s stand-in: the host
    twin of C entry point ``name`` with ``_cuda_lib._SIGNATURES[name]`` as
    its argument types (``dev`` is not read)."""
    from bundlesdf_tpu_torch.ops import _cuda_lib

    body = open(SOURCE).read().split('extern "C"')[0].replace("#include <cuda_runtime.h>", "")
    cpp = os.path.join(out_dir, "fuse_cloud_host.cpp")
    lib_path = os.path.join(out_dir, "libfuse_cloud_host.so")
    with open(cpp, "w") as f:
        f.write(_PRELUDE + _HOST + body + _LAUNCHERS)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o", lib_path,
                    cpp], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _cuda_lib._SIGNATURES.items():
        if name.startswith("fuse_cloud_"):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def launch(dev, name: str, *args) -> None:
        rc = getattr(lib, name)(*args, None)
        if rc != 0:
            raise RuntimeError(f"host {name} refused its arguments")

    return launch


def run_on_host(launch):
    """A stand-in for ``fuse_cloud_cuda._run_kernel``: the batch packed by
    the wrapper's ``pack`` into a CPU tensor and run by its ``compute``
    over the host kernels (``launch`` must stand in for
    ``_cuda_lib.launch``); records each batch's frame count."""
    import torch

    from bundlesdf_tpu_torch.ops import fuse_cloud_cuda as fc

    batches = []

    def run(dev, depths, masks, K, vox, k):
        assert dev.type == "cuda"
        B = len(depths)
        H, W = np.shape(depths[0])
        buf = np.zeros(fc.upload_bytes(B, H * W), np.uint8)
        fc.pack(depths, masks, buf)
        batches.append(B)
        return fc.compute(torch.from_numpy(buf), B, H, W, K, vox, k)

    run.batches = batches
    return run


def cube_frames(n: int, H: int, W: int, seed: int, first: int = 0) -> dict:
    """Frames ``first`` .. ``first + n - 1`` of the joint60 traffic
    (``portbench/traffic/joint60.json``) rendered at (H, W), the focal
    scaled with the width, each as ``portbench/video.py::make_video``
    renders it: depth (f32 m, mm steps), mask (f32), the GL
    camera-in-object poses, and K."""
    from bundlesdf_tpu_torch.utils.geometry import GLCAM_IN_CVCAM
    from portbench import video

    with open(os.path.join(REPO, "portbench", "traffic", "joint60.json")) as f:
        traffic = json.load(f)
    f = float(traffic["focal"]) * W / float(traffic["width"])
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    poses = video.synth_poses(first + n, float(traffic["deg_step"]), float(traffic["wobble"]))
    out = {"depths": [], "masks": [], "glcams": [], "K": K}
    for T in poses[first:]:
        _, depth, mask = video.render_cube_rgbd(T, K, H, W, half=float(traffic["half"]),
                                                salt=video.dot_salt(seed))
        out["depths"].append((np.round(depth * 1000.0) / 1000.0).astype(np.float32))
        out["masks"].append(mask.astype(np.float32))
        out["glcams"].append(np.linalg.inv(T) @ GLCAM_IN_CVCAM)
    return out


def hard_frames(H: int, W: int, seed: int) -> dict:
    """Named (depth, mask) frames of (H, W) from ``seed``, for a K with
    its principal point at the centre (``hard_k``): ``empty`` (no valid
    pixel: a mask of zeros, and depth below 0.1 elsewhere), ``one_voxel``
    (a 3 x 3 patch inside one voxel), ``faces`` (depths on multiples of
    5 mm over the whole image, so that many coordinates land on voxel
    faces, half of them negative), ``lattice`` (a plane at 0.5 m seen
    straight on: voxel means on a grid, neighbour distances tied),
    ``few`` (fewer voxels than the outlier test's 30 neighbours) and
    ``noisy`` (a wavy surface with speckle and holes)."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    out = {}
    depth = rng.uniform(0.0, 0.099, (H, W)).astype(np.float32)
    out["empty"] = (depth, np.zeros((H, W), np.float32))
    depth = np.zeros((H, W), np.float32)
    depth[H // 2:H // 2 + 3, W // 2:W // 2 + 3] = 0.1031
    out["one_voxel"] = (depth, (depth > 0).astype(np.float32))
    faces = (rng.integers(20, 200, (H, W)) * 0.005).astype(np.float32)
    mask = (rng.uniform(size=(H, W)) > 0.2).astype(np.float32)
    out["faces"] = (faces, mask)
    out["lattice"] = (np.full((H, W), 0.5, np.float32), np.ones((H, W), np.float32))
    depth = np.zeros((H, W), np.float32)
    for k in range(12):
        y, x = rng.integers(0, H), rng.integers(0, W)
        depth[y, x] = rng.uniform(0.2, 1.5)
    out["few"] = (depth, np.ones((H, W), np.float32))
    wave = 0.5 + 0.05 * np.sin(u / 7.0) * np.cos(v / 5.0) + rng.normal(0, 2e-3, (H, W))
    wave[rng.uniform(size=(H, W)) < 0.05] = rng.uniform(0.3, 2.0)
    wave[rng.uniform(size=(H, W)) < 0.05] = 0.0
    out["noisy"] = (wave.astype(np.float32), np.ones((H, W), np.float32))
    return out


def hard_k(H: int, W: int) -> np.ndarray:
    """K of the hard frames: fx != fy, the principal point at the centre
    (so that a column of coordinates is exactly 0)."""
    s = W / 640.0
    return np.array([[500.0 * s, 0, W // 2], [0, 505.0 * s, H // 2], [0, 0, 1]], np.float32)
