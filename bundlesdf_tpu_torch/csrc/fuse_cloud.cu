// A new keyframe's object cloud, fused on the card, for Hopper (sm_90a):
// the masked back-projection, the voxel downsample and the distances of the
// statistical outlier test's nearest neighbours.
//
// Replaces no TPU kernel: the JAX package fuses each keyframe's cloud on
// the host (bundlesdf_tpu/io/scene_bounds.py::fuse_frame_cloud), and so
// does the port's on the CPU. There np.unique(axis=0) over ~175k rows a
// 480 x 640 keyframe and a cKDTree query took ~320 ms of host time a frame
// of the joint loop. Here five launches and a stable sort between them
// (ops/fuse_cloud_cuda.py) compute, for a batch of frames, each voxel's
// mean point and its k smallest distances to the voxel points (itself
// included); the host keeps numpy's mean, std and threshold rule and the
// rigid transform. No caller fuses colours, so the card takes none.
//
// Bound: the neighbour search's f64 arithmetic. The work needs each
// pixel's depth and mask byte read once (5 bytes) and
// each voxel point's mean and k distances written once: 2.2 MB for the
// ~2.5k voxel points of a 480 x 640 joint60 frame, 0.66 us at 3.35 TB/s;
// the search is 8 f64 operations a pair of voxel points, 51 MFLOP there,
// 1.5 us at the 34 TFLOP/s of f64 outside the tensor cores. The sort and
// the run bookkeeping add ~40 bytes a pixel of traffic that the bound does
// not count.
//
// Design: fuse_keys_kernel, one thread a pixel, writes each valid pixel's
// packed voxel key (INT64_MAX for the others); the wrapper sorts each
// frame's keys stably (torch.sort), which keeps a voxel's pixels in row-major
// order; fuse_flags_kernel marks where a run of equal keys starts; the
// wrapper's cumsum numbers the runs; fuse_starts_kernel writes each run's
// start and the frame's run count; fuse_means_kernel, one thread a run,
// sums the run's points in f64 in pixel order and divides by
// the count; fuse_knn_kernel, one thread a voxel point, walks the frame's
// points in tiles staged through shared memory and keeps the 32 smallest
// squared distances in a sorted list in registers.
//
// Numerics: the twin's bits. Back-projection is depth_to_xyz_np's f32
// arithmetic, ((u - cx) / fx) * depth, every op an explicit _rn intrinsic,
// which nvcc never contracts. The key is floor(p / vox) in f32, as numpy
// divides an f32 array by a Python float; the three keys, offset by 2^20,
// are packed 21 bits each, so that the packed keys sort as np.unique(axis=
// 0) orders the rows (lexicographic, signed). A key outside [-2^20, 2^20 -
// 2] (a coordinate past ~10 km, or an inf depth) marks the frame, and the
// wrapper raises for it: no sensor reads such a depth. The
// mean is np.add.at's: each voxel's f64 sum from 0 in pixel order, then
// one division by the count. A squared distance is cKDTree's,
// (dx * dx + dy * dy) + dz * dz in f64, and its square root is taken after
// the selection, as cKDTree takes it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRunThreads = 128;
constexpr int kKnnThreads = 32;
// voxel points a neighbour block stages in shared memory at once
constexpr int kKnnTile = 256;
// the neighbours a query keeps (nb_neighbors + 1 <= kMaxK), in registers
constexpr int kMaxK = 32;
constexpr int64_t kNoKey = INT64_MAX;
constexpr float kKeyLo = -1048576.0f;  // -2^20
constexpr float kKeyHi = 1048574.0f;   // 2^20 - 2: the packed key stays below kNoKey
constexpr int64_t kKeyOffset = 1048576;

struct Camera {
  float fx, fy, cx, cy;
};

// depth_to_xyz_np's point of pixel (u, v) at depth d.
__device__ __forceinline__ void backproject(const Camera& c, int u, int v, float d,
                                            float* x, float* y) {
  *x = __fmul_rn(__fdiv_rn(__fsub_rn((float)u, c.cx), c.fx), d);
  *y = __fmul_rn(__fdiv_rn(__fsub_rn((float)v, c.cy), c.fy), d);
}

// The key of one coordinate, offset into [0, 2^21 - 2]; -1 where it falls
// outside the packed range.
__device__ __forceinline__ int64_t coord_key(float p, float vox) {
  const float f = floorf(__fdiv_rn(p, vox));
  if (!(f >= kKeyLo && f <= kKeyHi)) return -1;
  return (int64_t)f + kKeyOffset;
}

// Frame b = blockIdx.y: depth and mask hold hw pixels a frame; keys gets
// each pixel's packed voxel key, kNoKey where depth < 0.1 or mask == 0.
// counts holds 2 ints a frame, zero on entry; a key out of range sets the
// frame's second.
__global__ void __launch_bounds__(kThreads)
fuse_keys_kernel(const float* __restrict__ depth, const uint8_t* __restrict__ mask, int W,
                 int hw, Camera cam, float vox, int64_t* __restrict__ keys,
                 int* __restrict__ counts) {
  const int b = blockIdx.y;
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= hw) return;
  const size_t at = (size_t)b * hw + i;
  const float d = depth[at];
  int64_t key = kNoKey;
  if (d >= 0.1f && mask[at] != 0) {
    float x, y;
    backproject(cam, i % W, i / W, d, &x, &y);
    const int64_t kx = coord_key(x, vox), ky = coord_key(y, vox), kz = coord_key(d, vox);
    if (kx < 0 || ky < 0 || kz < 0) {
      atomicOr(&counts[2 * b + 1], 1);
    } else {
      key = (kx << 42) | (ky << 21) | kz;
    }
  }
  keys[at] = key;
}

// flags[j] = 1 where sorted key j starts a run of one voxel's pixels.
__global__ void __launch_bounds__(kThreads)
fuse_flags_kernel(const int64_t* __restrict__ sorted, int hw, int* __restrict__ flags) {
  const int b = blockIdx.y;
  const int j = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (j >= hw) return;
  const size_t at = (size_t)b * hw + j;
  const int64_t k = sorted[at];
  flags[at] = k != kNoKey && (j == 0 || sorted[at - 1] != k);
}

// runs holds the inclusive cumsum of flags: starts[b, r] gets the position
// of run r, and counts[2 * b] the frame's number of runs.
__global__ void __launch_bounds__(kThreads)
fuse_starts_kernel(const int* __restrict__ flags, const int* __restrict__ runs, int hw,
                   int* __restrict__ starts, int* __restrict__ counts) {
  const int b = blockIdx.y;
  const int j = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (j >= hw) return;
  const size_t at = (size_t)b * hw + j;
  if (flags[at]) starts[(size_t)b * hw + runs[at] - 1] = j;
  if (j == hw - 1) counts[2 * b] = runs[at];
}

// One thread a run r of frame b: the mean of its points, in pixel order,
// into row offsets[b] + r of pts.
__global__ void __launch_bounds__(kRunThreads)
fuse_means_kernel(const float* __restrict__ depth, const int64_t* __restrict__ sorted,
                  const int64_t* __restrict__ perm, const int* __restrict__ starts,
                  const int* __restrict__ counts, const int* __restrict__ offsets, int W,
                  int hw, Camera cam, double* __restrict__ pts) {
  const int b = blockIdx.y;
  const int r = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (r >= counts[2 * b]) return;
  const size_t base = (size_t)b * hw;
  const int s = starts[base + r];
  const int64_t key = sorted[base + s];
  double sx = 0.0, sy = 0.0, sz = 0.0;
  int n = 0;
  for (int j = s; j < hw && sorted[base + j] == key; ++j, ++n) {
    const int i = (int)perm[base + j];
    const float d = depth[base + i];
    float x, y;
    backproject(cam, i % W, i / W, d, &x, &y);
    sx = __dadd_rn(sx, (double)x);
    sy = __dadd_rn(sy, (double)y);
    sz = __dadd_rn(sz, (double)d);
  }
  const double cnt = (double)n;
  const size_t o = 3 * ((size_t)offsets[b] + r);
  pts[o] = __ddiv_rn(sx, cnt);
  pts[o + 1] = __ddiv_rn(sy, cnt);
  pts[o + 2] = __ddiv_rn(sz, cnt);
}

// One thread a voxel point i of frame b: its k smallest distances to the
// frame's points (itself included), ascending, into row offsets[b] + i of
// dist (k doubles a row; +inf past the frame's point count). The kMaxK
// smallest squared distances stay in registers, sorted: a candidate below
// the largest walks down the list, swapping, as one insertion.
__global__ void __launch_bounds__(kKnnThreads)
fuse_knn_kernel(const double* __restrict__ pts, const int* __restrict__ counts,
                const int* __restrict__ offsets, int k, double* __restrict__ dist) {
  __shared__ double tile[3 * kKnnTile];
  const int b = blockIdx.y;
  const int n = counts[2 * b];
  const int first = (int)(blockIdx.x * blockDim.x);
  if (first >= n) return;  // the whole block lies past this frame's points
  const int i = first + (int)threadIdx.x;
  const bool live = i < n;
  const double* P = pts + 3 * (size_t)offsets[b];
  double qx = 0.0, qy = 0.0, qz = 0.0;
  if (live) qx = P[3 * i], qy = P[3 * i + 1], qz = P[3 * i + 2];
  double best[kMaxK];
#pragma unroll
  for (int t = 0; t < kMaxK; ++t) best[t] = INFINITY;
  for (int j0 = 0; j0 < n; j0 += kKnnTile) {
    const int m = min(kKnnTile, n - j0);
    __syncthreads();  // the last tile is read
    for (int t = threadIdx.x; t < 3 * m; t += blockDim.x) tile[t] = P[3 * (size_t)j0 + t];
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < m; ++t) {
      const double dx = __dsub_rn(qx, tile[3 * t]);
      const double dy = __dsub_rn(qy, tile[3 * t + 1]);
      const double dz = __dsub_rn(qz, tile[3 * t + 2]);
      double s =
          __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
      if (s < best[kMaxK - 1]) {
#pragma unroll
        for (int u = 0; u < kMaxK; ++u) {
          const double lo = s < best[u] ? s : best[u];
          s = s < best[u] ? best[u] : s;
          best[u] = lo;
        }
      }
    }
  }
  if (!live) return;
  double* out = dist + (size_t)k * ((size_t)offsets[b] + i);
#pragma unroll
  for (int t = 0; t < kMaxK; ++t) {
    if (t < k) out[t] = __dsqrt_rn(best[t]);
  }
}

dim3 pixel_grid(int hw, int n_frames) {
  return dim3((unsigned)((hw + kThreads - 1) / kThreads), (unsigned)n_frames);
}

bool bad_batch(int hw, int n_frames) {
  return hw < 1 || n_frames < 1 || n_frames > 65535;
}

}  // namespace

// Every pointer is on the device; n_frames frames of hw = H * W pixels, W
// wide. Each entry enqueues its kernel on `stream` and returns the launch's
// CUDA error (0 on success), or cudaErrorInvalidValue for arguments the
// kernel does not take.

// depth: f32, mask: u8 (nonzero = object); keys: i64; counts: 2 ints a
// frame, zero on entry.
extern "C" int fuse_cloud_keys(const void* depth, const void* mask, int n_frames, int H,
                               int W, float fx, float fy, float cx, float cy, float vox,
                               void* keys, void* counts, void* stream) {
  if (bad_batch(H * W, n_frames) || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Camera cam{fx, fy, cx, cy};
  fuse_keys_kernel<<<pixel_grid(H * W, n_frames), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)depth, (const uint8_t*)mask, W, H * W, cam, vox, (int64_t*)keys,
      (int*)counts);
  return (int)cudaGetLastError();
}

// sorted: each frame's keys, sorted; flags: i32.
extern "C" int fuse_cloud_flags(const void* sorted, int n_frames, int hw, void* flags,
                                void* stream) {
  if (bad_batch(hw, n_frames)) return (int)cudaErrorInvalidValue;
  fuse_flags_kernel<<<pixel_grid(hw, n_frames), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)sorted, hw, (int*)flags);
  return (int)cudaGetLastError();
}

// runs: each frame's inclusive cumsum of flags (i32); starts: i32.
extern "C" int fuse_cloud_starts(const void* flags, const void* runs, int n_frames, int hw,
                                 void* starts, void* counts, void* stream) {
  if (bad_batch(hw, n_frames)) return (int)cudaErrorInvalidValue;
  fuse_starts_kernel<<<pixel_grid(hw, n_frames), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)flags, (const int*)runs, hw, (int*)starts, (int*)counts);
  return (int)cudaGetLastError();
}

// perm: i64, each sorted key's pixel; offsets: a frame's first output row
// (i32); max_runs: the most runs of any frame; pts: f64, 3 a row.
extern "C" int fuse_cloud_means(const void* depth, const void* sorted, const void* perm,
                                const void* starts, const void* counts, const void* offsets,
                                int n_frames, int H, int W, float fx, float fy, float cx,
                                float cy, int max_runs, void* pts, void* stream) {
  if (bad_batch(H * W, n_frames) || H < 1 || W < 1 || max_runs < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Camera cam{fx, fy, cx, cy};
  const dim3 grid((unsigned)((max_runs + kRunThreads - 1) / kRunThreads), (unsigned)n_frames);
  fuse_means_kernel<<<grid, kRunThreads, 0, (cudaStream_t)stream>>>(
      (const float*)depth, (const int64_t*)sorted, (const int64_t*)perm, (const int*)starts,
      (const int*)counts, (const int*)offsets, W, H * W, cam, (double*)pts);
  return (int)cudaGetLastError();
}

// k: neighbours kept a point (1..kMaxK); dist: f64, k a row.
extern "C" int fuse_cloud_knn(const void* pts, const void* counts, const void* offsets,
                              int n_frames, int max_runs, int k, void* dist, void* stream) {
  if (n_frames < 1 || n_frames > 65535 || max_runs < 1 || k < 1 || k > kMaxK) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((max_runs + kKnnThreads - 1) / kKnnThreads), (unsigned)n_frames);
  fuse_knn_kernel<<<grid, kKnnThreads, 0, (cudaStream_t)stream>>>(
      (const double*)pts, (const int*)counts, (const int*)offsets, k, (double*)dist);
  return (int)cudaGetLastError();
}
