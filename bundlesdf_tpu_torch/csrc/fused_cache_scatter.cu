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
// (27 MB at N = 393,216, F = 16, one R=16 level).  The likely real limit
// is L2 atomic throughput: N*F float atomics land on only rows*F
// addresses (6.3 M adds into 65,536 addresses at the online budget).
//
// Design: one thread per (level, update row, column), grid-stride; each
// does one float atomicAdd into the global accumulator, which at 256 KB
// stays resident in the 50 MB L2.  Update reads are coalesced (row-major,
// column fastest).  The accumulator is larger than a block's 227 KB of
// shared memory, so a shared-memory accumulator would need a channel split
// (later work).  The TPU's chunk padding (CHUNK = 2048) is not needed.
// Atomics make the f32 summation order nondeterministic, as in the
// reference's atomicAdd backward (PARITY.md #9).  Out-of-range indices are
// skipped.
#include <cuda_runtime.h>
#include <stdint.h>

#define FCS_MAX_LEVELS 8

namespace {

struct ScatterLevels {
  const int32_t* idx[FCS_MAX_LEVELS];
  const float* upd[FCS_MAX_LEVELS];
  float* out[FCS_MAX_LEVELS];
  int64_t rows[FCS_MAX_LEVELS];
};

__global__ void fused_cache_scatter_kernel(ScatterLevels lv, int n_levels,
                                           int64_t n, int width) {
  const int64_t per_level = n * width;
  const int64_t total = per_level * n_levels;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int l = (int)(t / per_level);
    const int64_t r = t - (int64_t)l * per_level;
    const int64_t row = r / width;
    const int col = (int)(r - row * width);
    const int32_t dst = lv.idx[l][row];
    if (dst >= 0 && (int64_t)dst < lv.rows[l]) {
      atomicAdd(lv.out[l] + (int64_t)dst * width + col, lv.upd[l][r]);
    }
  }
}

}  // namespace

// idx/upd/out: host arrays of n_levels device pointers ((N,) int32,
// (N, width) f32, (rows[l], width) f32 zeroed; all contiguous).
// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for more than FCS_MAX_LEVELS levels.
extern "C" int fused_cache_scatter_f32(const void* const* idx,
                                       const void* const* upd,
                                       void* const* out, const int64_t* rows,
                                       int n_levels, int64_t n, int width,
                                       void* stream) {
  if (n_levels < 1 || n_levels > FCS_MAX_LEVELS || width < 1 || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  ScatterLevels lv = {};
  for (int l = 0; l < n_levels; ++l) {
    lv.idx[l] = (const int32_t*)idx[l];
    lv.upd[l] = (const float*)upd[l];
    lv.out[l] = (float*)out[l];
    lv.rows[l] = rows[l];
  }
  const int threads = 256;
  const int64_t total = n * width * n_levels;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 64) blocks = 65535LL * 64;
  fused_cache_scatter_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(lv, n_levels, n, width);
  return (int)cudaGetLastError();
}
