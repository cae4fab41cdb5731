// Fused multi-level cache scatter-add, for Hopper (sm_90a).
//
// Replaces the TPU kernel bundlesdf_tpu/ops/hashgrid_pallas.py
// (fused_cache_scatter, builder _fused_scatter_fn): for each of n_levels
// small dense hash-grid levels, add (N, F) f32 update rows at int32 row
// indices into that level's zeroed (rows, F) f32 accumulator, all levels
// in ONE launch.
//
// Bound: memory on paper — the indices and updates are read once and the
// accumulators written once: n_levels*N*(4 + 4F) + sum(rows)*F*4 bytes
// (27 MB at N = 393,216, F = 16, one R=16 level).  The real limit is the
// L2's atomic throughput: N*F adds land on only rows*F addresses (6.3 M
// adds into 65,536 addresses at the online budget), and neighbouring
// update rows of the train step hit the same address, because the rows are
// ray-major and a ray's samples stay in one R=16 cell for long runs.
//
// Design: run-merging with vector atomics.  A group of F/4 lanes owns one
// contiguous span of kSpan update rows and walks it in order; each lane
// loads its 4 columns of a row as one float4, so a group reads one whole
// row per step.  While the destination row stays the same, each lane
// carries a running float4 sum in registers; when it changes, the lane
// issues one vector atomic (atomicAdd(float4*, float4), red.global.add.v4
// .f32 on compute capability 9.x) into the global accumulator, which stays
// L2-resident (256 KB).  That is 4x fewer atomics than one per column on
// uniform cells and up to 4*kSpan x fewer on runs.  The loads of kUnroll rows
// are issued before any is used, so each thread keeps kUnroll loads in
// flight.  Levels go on blockIdx.y; offsets are 32-bit and nothing is
// divided in the loop.  A shared-memory accumulator is not used: level 0's
// 256 KB exceeds a block's 227 KB, and a column split would multiply the
// update reads.  Atomics make the f32 summation order nondeterministic, as
// in the reference's atomicAdd backward (PARITY.md #9).  Out-of-range
// indices are skipped.  Every pointer must be 16-byte aligned and F a
// multiple of 4 (the wrapper checks both).
#include <cuda_runtime.h>
#include <stdint.h>

#define FCS_MAX_LEVELS 8

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 16;   // update rows per lane group
constexpr int kUnroll = 8;  // rows loaded ahead of use

struct ScatterLevels {
  const int32_t* idx[FCS_MAX_LEVELS];
  const float4* upd[FCS_MAX_LEVELS];
  float4* out[FCS_MAX_LEVELS];
  unsigned rows[FCS_MAX_LEVELS];
};

__device__ __forceinline__ void flush(float4* out, int dst, unsigned rows,
                                      int quads, float4 acc) {
  if ((unsigned)dst < rows) atomicAdd(out + (size_t)dst * quads, acc);
}

__global__ void __launch_bounds__(kThreads)
fused_cache_scatter_kernel(ScatterLevels lv, int n, int quads) {
  const int l = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int group = t / quads;
  const int q = t - group * quads;
  int row = group * kSpan;
  if (row >= n) return;
  const int end = min(row + kSpan, n);
  const int32_t* __restrict__ idx = lv.idx[l];
  const float4* __restrict__ upd = lv.upd[l] + q;
  float4* out = lv.out[l] + q;
  const unsigned rows = lv.rows[l];
  int cur = -1;  // no destination yet: skipped by flush
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (; row < end; row += kUnroll) {
    int d[kUnroll];
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row + u < end) {
        d[u] = __ldg(idx + row + u);
        v[u] = __ldg(upd + (size_t)(row + u) * quads);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row + u < end) {
        if (d[u] != cur) {
          flush(out, cur, rows, quads, acc);
          cur = d[u];
          acc = v[u];
        } else {
          acc.x += v[u].x;
          acc.y += v[u].y;
          acc.z += v[u].z;
          acc.w += v[u].w;
        }
      }
    }
  }
  flush(out, cur, rows, quads, acc);
}

}  // namespace

// levels: host array of 3*n_levels int64 — the device pointers of each
// level's (N,) int32 indices, then of its (N, width) f32 updates, then its
// row count.  out: one f32 buffer for the levels' (rows, width)
// accumulators back to back, which this function zeroes first.  All device
// buffers contiguous and 16-byte aligned; width a multiple of 4.  Enqueues
// the memset and the kernel on `stream`; returns the first CUDA error (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int fused_cache_scatter_f32(const int64_t* levels, void* out,
                                       int n_levels, int n, int width,
                                       void* stream) {
  if (n_levels < 1 || n_levels > FCS_MAX_LEVELS || width < 4 || width % 4 ||
      n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int quads = width / 4;
  ScatterLevels lv = {};
  float4* acc = (float4*)out;
  for (int l = 0; l < n_levels; ++l) {
    const int64_t rows = levels[2 * n_levels + l];
    if (rows < 1 || rows > INT32_MAX) return (int)cudaErrorInvalidValue;
    lv.idx[l] = (const int32_t*)(uintptr_t)levels[l];
    lv.upd[l] = (const float4*)(uintptr_t)levels[n_levels + l];
    lv.out[l] = acc;
    lv.rows[l] = (unsigned)rows;
    acc += rows * quads;
  }
  const int64_t threads = ((int64_t)n + kSpan - 1) / kSpan * quads;
  if (threads > INT32_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)(acc - (float4*)out) *
                                        sizeof(float4), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads),
                  (unsigned)n_levels);
  fused_cache_scatter_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      lv, n, quads);
  return (int)cudaGetLastError();
}
