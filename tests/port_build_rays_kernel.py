"""NOF runner inputs that exercise every rule of a round's ray building, and
``csrc/build_rays.cu``'s kernels compiled for the host (not collected).

``joint60_inputs`` and ``hard_inputs`` are read by
``tests/test_torch_build_rays_cuda.py`` and by ``chip_smoke.py``'s
``build_rays`` phase: the joint60 traffic's cube keyframes preprocessed as
the joint loop hands them to ``NofRunner``, and a sphere seen by cameras
that put the rules on their edges (an empty mask, a mask on the image
border, occlusion masks, invalid depth, rays grazing, missing or starting
on the box, an empty occupancy grid, an empty cloud, world points at
exactly the denoise radius from a cloud point, cloud points on the denoise
grid's cell faces).

``host_launch`` builds the kernels' source with g++ as plain C++, with
``tests/port_depth_kernel.py``'s prelude and the f64 and fused
intrinsics it lacks (each ``_rn`` intrinsic one rounded host operation,
nothing fused but ``__fmaf_rn``, the C library's ``fmaf``): each C entry point gets a host twin of the same name and
arguments that runs each kernel's grid block after block with one thread a
block, so that a block's loops cover its whole tile and ``__syncthreads``
has nothing to wait for.  The returned ``launch`` stands in for
``ops/_cuda_lib.py::launch``, so the wrapper's own ``compute`` drives the
kernels.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as np

from port_depth_kernel import _PRELUDE, REPO

SOURCE = os.path.join(REPO, "bundlesdf_tpu_torch", "csrc", "build_rays.cu")

_HOST = r"""
#include <algorithm>
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static inline float __fmaf_rn(float a, float b, float c) { volatile float r = std::fmaf(a, b, c); return r; }
static inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
static inline double __ddiv_rn(double a, double b) { volatile double r = a / b; return r; }
static inline double __dsqrt_rn(double a) { volatile double r = std::sqrt(a); return r; }
static inline int atomicAdd(int* a, int v) { int o = *a; *a = o + v; return o; }
"""

_LAUNCHERS = r"""
// one thread a block over a grid of n_x x n_y blocks
#define GRID(n_x, n_y, call)                                         \
  do {                                                               \
    blockDim.x = 1; threadIdx.x = 0;                                 \
    for (unsigned by = 0; by < (unsigned)(n_y); ++by)                \
      for (long long bx = 0; bx < (long long)(n_x); ++bx) {          \
        blockIdx.x = (unsigned)bx; blockIdx.y = by; call;            \
      }                                                              \
  } while (0)

extern "C" int build_rays_select(const void* frames, long long stride, const void* params,
                                 int n_frames, int H, int W, float near_sc, float far_sc,
                                 int options, void* rowmax, void* cand, void* counts, void*) {
  if (bad_batch(H, W, n_frames)) return 1;
  GRID(H * W, n_frames, rays_rows_kernel((const uint8_t*)frames, stride, (const float*)params,
                                         H, W, (uint8_t*)rowmax));
  GRID(H * W, n_frames,
       rays_select_kernel((const uint8_t*)frames, stride, (const float*)params, H, W,
                          (const uint8_t*)rowmax, near_sc, far_sc, options, (uint8_t*)cand,
                          (int*)counts));
  return 0;
}

extern "C" int build_rays_flags(const void* frames, long long stride, const void* params,
                                int n_frames, int H, int W, const void* dirs, const void* cand,
                                const void* counts, const void* grid, int R, int n_march,
                                float far_sc, int options, const void* cloud_pts,
                                const void* cloud_starts, int n_cloud, double lo_x, double lo_y,
                                double lo_z, double inv_cell, int nx, int ny, int nz,
                                double thr, void* keep, void* nearfar, void*) {
  if (bad_batch(H, W, n_frames) || R < 1 || n_march < 1 || n_cloud < 0) return 1;
  Cloud cloud;
  cloud.pts = (const float*)cloud_pts;
  cloud.starts = (const int*)cloud_starts;
  cloud.n = n_cloud;
  cloud.lo[0] = lo_x;
  cloud.lo[1] = lo_y;
  cloud.lo[2] = lo_z;
  cloud.inv_cell = inv_cell;
  cloud.dims[0] = nx;
  cloud.dims[1] = ny;
  cloud.dims[2] = nz;
  GRID(H * W, n_frames,
       rays_flags_kernel((const uint8_t*)frames, stride, (const float*)params, H, W,
                         (const float*)dirs, (const uint8_t*)cand, (const int*)counts,
                         (const uint8_t*)grid, R, n_march, far_sc, options, cloud, thr,
                         (int*)keep, (float*)nearfar));
  return 0;
}

extern "C" int build_rays_scan(void* data, long long n, void* sums, void* total, void*) {
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  if (n < 1) return 1;
  GRID(tiles, 1, scan_tiles_kernel((int*)data, n, (int*)sums));
  GRID(1, 1, scan_sums_kernel((int*)sums, (int)tiles, (int*)total));
  GRID(n, 1, scan_add_kernel((int*)data, n, (const int*)sums));
  return 0;
}

extern "C" int build_rays_write(const void* frames, long long stride, const void* params,
                                int n_frames, int H, int W, const void* dirs, const void* pos,
                                const void* nearfar, void* out, void*) {
  if (bad_batch(H, W, n_frames)) return 1;
  GRID(H * W, n_frames,
       rays_write_kernel((const uint8_t*)frames, stride, (const float*)params, H, W,
                         (const float*)dirs, (const int*)pos, (const float*)nearfar,
                         (float*)out));
  return 0;
}

extern "C" int build_rays_cloud_cells(const void* pts, int n, double lo_x, double lo_y,
                                      double lo_z, double inv_cell, int nx, int ny, int nz,
                                      void* cell_of, void* counts, void*) {
  if (n < 1) return 1;
  GRID(n, 1, cloud_cells_kernel((const float*)pts, n, lo_x, lo_y, lo_z, inv_cell, nx, ny, nz,
                                (int*)cell_of, (int*)counts));
  return 0;
}

extern "C" int build_rays_cloud_fill(const void* pts, int n, const void* cell_of,
                                     const void* starts, void* fill, void* sorted, void*) {
  if (n < 1) return 1;
  GRID(n, 1, cloud_fill_kernel((const float*)pts, n, (const int*)cell_of, (const int*)starts,
                               (int*)fill, (float*)sorted));
  return 0;
}
"""


def host_source() -> str:
    """The kernels' source as host C++ with the launchers above."""
    body = open(SOURCE).read().split('extern "C"')[0].replace("#include <cuda_runtime.h>", "")
    return _PRELUDE + _HOST + body + _LAUNCHERS


def host_launch(out_dir: str, source: str | None = None, flags=("-O2", "-ffp-contract=off")):
    """Build ``source`` (default ``host_source()``) for the host into
    ``out_dir``; returns ``launch(dev, name, *args)``, ``_cuda_lib.launch``'s
    stand-in: the host twin of C entry point ``name`` with
    ``_cuda_lib._SIGNATURES[name]`` as its argument types (``dev`` is not
    read)."""
    from bundlesdf_tpu_torch.ops import _cuda_lib

    cpp = os.path.join(out_dir, "build_rays_host.cpp")
    lib_path = os.path.join(out_dir, "libbuild_rays_host.so")
    with open(cpp, "w") as f:
        f.write(host_source() if source is None else source)
    subprocess.run(["g++", *flags, "-shared", "-fPIC", "-o", lib_path, cpp], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _cuda_lib._SIGNATURES.items():
        if name.startswith("build_rays_"):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def launch(dev, name: str, *args) -> None:
        rc = getattr(lib, name)(*args, None)
        if rc != 0:
            raise RuntimeError(f"host {name} refused its arguments")

    return launch


def run_on_host():
    """A stand-in for ``build_rays_cuda._run_kernel``: the batch packed by the
    wrapper's ``pack_params`` and ``pack_frame`` into a CPU tensor and run by
    its ``compute`` (``_cuda_lib.launch`` must be replaced by a host
    launch); records each batch's frame ids."""
    import torch

    from bundlesdf_tpu_torch.ops import build_rays_cuda as br

    batches = []

    def run(dev, frames, fids, poses, dilations, rules, dirs, grid, cloud, cloud_dev):
        images, depths, masks, occ = frames
        B = len(fids)
        H, W = np.shape(depths[fids[0]])
        param_bytes, stride, total = br.layout(B, H, W)
        buf = np.zeros(total, np.uint8)
        br.pack_params(fids, poses, dilations, buf)
        for j, f in enumerate(fids):
            lo = param_bytes + j * stride
            br.pack_frame(images[f], depths[f], masks[f], None if occ is None else occ[f],
                          buf[lo:lo + stride])
        batches.append(list(fids))
        return br.compute(torch.from_numpy(buf), B, H, W, occ is not None, rules, dirs, grid,
                          cloud, cloud_dev)

    run.batches = batches
    return run


def nof_cfg(**over) -> dict:
    """The online cell's NOF config (``portbench/configs/online.json``) with a
    small hash table (ray building reads none of it) and ``over``."""
    with open(os.path.join(REPO, "portbench", "configs", "online.json")) as f:
        cfg = json.load(f)["nof"]
    cfg.update({"log2_hashmap_size": 12, "save_dir": "", "n_step": 10})
    cfg.update(over)
    return cfg


def joint60_inputs(n: int, H: int, W: int, seed: int, first: int = 0,
                   bounds_frames: int | None = None) -> dict:
    """Keyframes ``first`` .. ``first + n - 1`` of the joint60 traffic at
    (H, W) as the joint loop hands them to ``NofRunner``: the scene bounds
    of ``compute_scene_bounds`` over the first ``bounds_frames`` of them
    (default all; sc_factor times the online margin 0.7), then
    ``BundleSdf._preprocess``'s colour, depth and pose normalization;
    returns images, depths, masks, poses, K, the normalized build cloud and
    sc_factor."""
    from bundlesdf_tpu_torch.io import scene_bounds as sb
    from bundlesdf_tpu_torch.nof.runner import BAD_COLOR, BAD_DEPTH
    from bundlesdf_tpu_torch.utils.geometry import GLCAM_IN_CVCAM
    from portbench import video

    with open(os.path.join(REPO, "portbench", "traffic", "joint60.json")) as f:
        traffic = json.load(f)
    fl = float(traffic["focal"]) * W / float(traffic["width"])
    K = np.array([[fl, 0, W / 2], [0, fl, H / 2], [0, 0, 1]], np.float32)
    poses = video.synth_poses(first + n, float(traffic["deg_step"]), float(traffic["wobble"]))
    rgbs, depths, masks, glcams = [], [], [], []
    for T in poses[first:]:
        rgb, depth, mask = video.render_cube_rgbd(T, K, H, W, half=float(traffic["half"]),
                                                  salt=video.dot_salt(seed))
        rgbs.append(rgb / 255.0)
        depths.append(np.round(depth * 1000.0) / 1000.0)
        masks.append(mask)
        glcams.append(np.linalg.inv(T) @ GLCAM_IN_CVCAM)
    rgbs = np.stack(rgbs).astype(np.float32)
    depths = np.stack(depths).astype(np.float32)
    masks = np.stack(masks).astype(np.float32)
    glcams = np.stack(glcams)
    b = n if bounds_frames is None else bounds_frames
    sc, tr, pcd, _ = sb.compute_scene_bounds(rgbs[:b], depths[:b], masks[:b], K, glcams[:b],
                                             device="cpu")
    sc *= 0.7
    depths[depths < 0.1] = BAD_DEPTH
    rgbs[masks == 0] = BAD_COLOR / 255.0
    depths[masks == 0] = BAD_DEPTH
    glcams[:, :3, 3] += tr
    glcams[:, :3, 3] *= sc
    return {"images": rgbs, "depths": (depths * sc).astype(np.float32), "masks": masks,
            "poses": glcams.astype(np.float32), "K": K,
            "pcd": ((pcd + tr) * sc).astype(np.float32), "sc": float(sc)}


# The hard cases' scale: sc 12.5 puts the denoise radius at exactly 0.25
# (0.02 * 12.5 rounds to it in f64) and near, far at 1.25, 25.
HARD_SC = 12.5


def _look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """A GL c2w (camera looking down -z) at ``eye`` towards ``target``."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = eye - target
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-9:
        x = np.cross((1.0, 0.0, 0.0), z)
    x /= np.linalg.norm(x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    T[:3, 3] = eye
    return T.astype(np.float32)


def _sphere_frame(c2w, K, H, W, centre, radius, rng):
    """Colour, scaled depth (BAD_DEPTH * sc off the sphere) and mask of a
    sphere seen from the GL camera ``c2w``."""
    from bundlesdf_tpu_torch.nof.runner import BAD_DEPTH
    from bundlesdf_tpu_torch.utils import geometry

    dirs = geometry.camera_rays_gl_np(H, W, K).astype(np.float64)
    d_w = dirs @ c2w[:3, :3].T.astype(np.float64)
    o = c2w[:3, 3].astype(np.float64) - np.asarray(centre, np.float64)
    a = (d_w * d_w).sum(-1)
    b = 2 * (d_w * o).sum(-1)
    c = (o * o).sum() - radius ** 2
    disc = b * b - 4 * a * c
    t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
    hit = (disc > 0) & (t > 0)
    depth = np.where(hit, t, BAD_DEPTH * HARD_SC).astype(np.float32)
    rgb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return rgb, depth, hit.astype(np.float32)


def hard_inputs(H: int, W: int, seed: int) -> dict:
    """A sphere of radius 0.5 at the origin seen by five cameras at sc
    ``HARD_SC``: frame 0 from 2.5 (its 100-px dilation), frame 1
    from 2.8 with the sphere on the image border, frame 2 with an empty mask, frame 3
    from exactly the box's face z = 1 (rays that start on the box, many of
    them grazing its edges), frame 4 from the box's corner edge; a tenth of
    the masked pixels with depth below near or beyond far.  ``occ``: an
    occlusion mask over a band of each frame.  The build cloud is the
    sphere's surface from a seeded sample, a cloud point 0.25 (the radius)
    in x from each of a few of the frames' world points, 0.6 apart (ties at
    the radius), and points on the denoise grid's cell faces."""
    from bundlesdf_tpu_torch.utils import geometry

    rng = np.random.default_rng(seed)
    s = W / 64.0
    K = np.array([[50.0 * s, 0, W / 2 - 0.3], [0, 52.0 * s, H / 2 + 0.2], [0, 0, 1]],
                 np.float32)
    eyes = [((0.3, 0.4, 2.5), (0, 0, 0)), ((1.6, 0.3, 2.3), (1.1, 0.5, 0)),
            ((0.0, 0.0, 2.5), (3.0, 3.0, 3.0)), ((0.1, -0.2, 1.0), (0.0, 0.0, -1.0)),
            ((1.0, 1.0, 1.7), (0.0, 0.0, 0.0))]
    poses, rgbs, depths, masks = [], [], [], []
    for eye, target in eyes:
        T = _look_at(eye, target)
        T[:3, 3] = np.asarray(eye, np.float32)   # exactly on a face or an edge where given
        rgb, depth, mask = _sphere_frame(T, K, H, W, (0, 0, 0), 0.5, rng)
        bad = (mask > 0) & (rng.uniform(size=(H, W)) < 0.1)
        depth[bad] = np.where(rng.uniform(size=bad.sum()) < 0.5, 0.5, 40.0).astype(np.float32)
        poses.append(T)
        rgbs.append(rgb)
        depths.append(depth)
        masks.append(mask)
    masks[2][:] = 0
    occ = np.zeros((len(eyes), H, W), np.uint8)
    occ[:, H // 3:H // 3 + H // 8, :] = 1
    dirs = geometry.camera_rays_gl_np(H, W, K)
    cloud = rng.normal(size=(4000, 3))
    cloud = 0.5 * cloud / np.linalg.norm(cloud, axis=1, keepdims=True)
    # world points of masked pixels moved 0.7 towards the camera (no sphere
    # point within the radius), each with a cloud point the radius away in x
    # (in f32: at exactly the radius where the sum rounds exactly), every
    # second one an ulp further
    ties = []
    for f in (0, 1):
        v, u = np.nonzero((masks[f] > 0) & (depths[f] < 20.0) & (depths[f] > 1.96))
        d = dirs[v, u] * (depths[f][v, u, None] - np.float32(0.7))
        R, t = poses[f][:3, :3], poses[f][:3, 3]
        q = ((d[:, 0:1] * R[:, 0] + d[:, 1:2] * R[:, 1]) + d[:, 2:3] * R[:, 2]) + t
        # a few pixels whose points lie 0.6 apart, so that no other tie is near
        chosen = []
        for j in rng.permutation(len(v)):
            if all(np.linalg.norm(q[j] - q[k]) > 0.6 for k in chosen):
                chosen.append(j)
        depths[f][v[chosen], u[chosen]] -= np.float32(0.7)
        tie = q[chosen] + np.array([0.02 * HARD_SC, 0, 0], np.float32)
        tie[1::2, 0] = np.nextafter(tie[1::2, 0], np.float32(np.inf))   # an ulp past
        ties.append(tie)
    # points at multiples of the denoise grid's cell width (0.265625, as
    # build_rays_cuda.cloud_grid takes it) from the cloud's low corner, one
    # of them the corner itself: on the grid's cell faces, away from the
    # ties
    base = np.concatenate([cloud, *ties])
    cell = 0.02 * HARD_SC * 1.0625
    m = (np.floor(base.min(0) / cell) - 1) * cell
    faces = m + cell * rng.integers(0, 3, size=(200, 3))
    faces[0] = m
    pcd = np.concatenate([base, faces]).astype(np.float32)
    return {"images": np.stack(rgbs), "depths": np.stack(depths), "masks": np.stack(masks),
            "poses": np.stack(poses), "K": K, "pcd": pcd, "occ": occ, "sc": HARD_SC}
