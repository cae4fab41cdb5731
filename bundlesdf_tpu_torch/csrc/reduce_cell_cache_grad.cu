// Cache-gradient reduce of one dense hash-grid level, for Hopper (sm_90a).
//
// Replaces the TPU kernel bundlesdf_tpu/ops/reduce_pallas.py
// (reduce_cell_cache_grad_pallas, kernel body _make_kernel).  It computes
// the transpose of the corner-duplicated cell cache build:
//
//   out[((gx*S + gy)*S + gz)*C + ch] =
//       sum over corners ci = (cx, cy, cz) in _CORNERS order of
//       in[((gx-cx)*R + (gy-cy))*R + (gz-cz)][ci*C + ch]     (in range only)
//
// with in = (R^3, 8C) bf16 and out = (S^3 * C) f32, S = R + 1, C = 2, and
// zeros in the output's aligned tail out[S^3*C : size*C].
//
// Bound: memory.  Each input byte is needed once and each output byte is
// written once: R^3*8C*2 + size*C*4 bytes (84.3 MB at R=128, C=2).
//
// Design: an output tile fed by a shared-memory x-slab.  A block owns a
// TY x TZ tile of output (gy, gz) and marches along gx over one chunk of
// the x range.  Output plane gx needs input planes gx-1 and gx; each input
// plane's (TY+1) x (TZ+1) cells (the tile and its low halo, 32 bytes a
// cell) are staged in shared memory with 16-byte cp.async into a ring of 3
// buffers, so the next plane loads while the current one is summed.  Cells
// outside the level are zero-filled by the copy (src-size 0), and adding
// +0.0 to a sum that starts at +0.0 changes no bit, so every thread sums
// all 8 corners unconditionally.  Each thread makes both channels of one
// output cell: it reads each corner as one bf16x2 word, sums the 8 terms
// in f32 in _CORNERS order and stores one float2.  The order is that of
// the plain shifted-add reduce (ops/hashgrid.py _reduce_cell_cache_grad),
// so the two agree bitwise.
//
// Shared-memory banks: a warp is one tile row (32 consecutive gz), so a
// fixed corner word of 32 neighbouring 32-byte cells would hit 4 banks.
// Two measures make the reads conflict-free: lanes read the corners in a
// per-lane order (step k reads corner k ^ m, m = (lane >> 2) & 3, so the
// four lane quads read four different words of their cells) and keep them
// in registers until they are summed in _CORNERS order; and the two 16-byte
// halves of a cell swap places where bit 4 of the cell's z index is set.
// The kernel also writes the aligned zero tail, so the reduce is one
// launch.  Tile, x-chunk and grid come from the wrapper
// (ops/reduce_cuda.py::launch_geometry), which the CPU tests check.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTY = 8;                      // output tile rows (gy)
constexpr int kTZ = 32;                     // output tile columns (gz): one warp
constexpr int kThreads = kTY * kTZ;
constexpr int kBufs = 3;                    // input planes in the ring
constexpr int kRowWords = (kTZ + 1) * 8;    // one slab row: TZ+1 cells of 8 words
constexpr int kPlaneWords = (kTY + 1) * kRowWords;
constexpr int kChunks = (kTY + 1) * (kTZ + 1) * 2;  // 16-byte copies a plane
constexpr int kSlots = (kChunks + kThreads - 1) / kThreads;
constexpr int kSmemBytes = kBufs * kPlaneWords * 4;

__device__ __forceinline__ int swizzled_half(int zc, int h) {
  return h ^ ((zc >> 4) & 1);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__global__ void __launch_bounds__(kThreads)
reduce_cell_cache_grad_kernel(const int4* __restrict__ in,
                              float2* __restrict__ out, float* __restrict__ tail,
                              int R, int x_chunk, int n_tail) {
  extern __shared__ __align__(16) uint32_t slab[];
  const int S = R + 1;
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTY;
  const int z0 = blockIdx.x * kTZ;
  const int xb = blockIdx.z * x_chunk;
  const int xe = min(xb + x_chunk, S);

  if ((blockIdx.x | blockIdx.y | blockIdx.z) == 0) {
    for (int i = tid; i < n_tail; i += kThreads) tail[i] = 0.0f;
  }

  // This thread's share of each plane's copies: the 16-byte source offset
  // within the plane (-1 outside the level) and the word offset in the slab.
  int src_off[kSlots], dst_off[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = tid + s * kThreads;
    const int cell = c >> 1, h = c & 1;
    const int yc = cell / (kTZ + 1), zc = cell - yc * (kTZ + 1);
    const int y = y0 - 1 + yc, z = z0 - 1 + zc;
    const bool in_level = c < kChunks && (unsigned)y < (unsigned)R &&
                          (unsigned)z < (unsigned)R;
    src_off[s] = in_level ? (y * R + z) * 2 + h : -1;
    dst_off[s] = c < kChunks ? yc * kRowWords + zc * 8 + 4 * swizzled_half(zc, h)
                             : -1;
  }
  const uint32_t slab_addr = (uint32_t)__cvta_generic_to_shared(slab);
  const size_t plane16 = (size_t)R * R * 2;  // 16-byte units in one input plane
  auto load_plane = [&](int px, int buf) {
    const bool px_in = (unsigned)px < (unsigned)R;
    const int4* base = in + (px_in ? (size_t)px * plane16 : 0);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (dst_off[s] < 0) continue;
      const bool ok = px_in && src_off[s] >= 0;
      cp_async16(slab_addr + 4u * (buf * kPlaneWords + dst_off[s]),
                 ok ? base + src_off[s] : in, ok ? 16 : 0);
    }
  };

  // Corner reads: step k reads corner j = k ^ m (cx = k >> 2 for all
  // lanes), from the plane gx - cx at cell (gy - cy, gz - cz).
  const int ly = tid / kTZ, lz = tid % kTZ;
  const int gy = y0 + ly, gz = z0 + lz;
  const bool active = gy < S && gz < S;
  const int m = (lz >> 2) & 3;
  int rd_off[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int j = k ^ m;
    const int yc = ly + 1 - ((j >> 1) & 1), zc = lz + 1 - (j & 1);
    rd_off[k] = yc * kRowWords + zc * 8 + 4 * swizzled_half(zc, k >> 2) + (j & 3);
  }

  load_plane(xb - 1, 0);
  cp_async_commit();
  load_plane(xb, 1);
  cp_async_commit();
  int b_prev = 0, b_cur = 1, b_next = 2;
  for (int gx = xb; gx < xe; ++gx) {
    if (gx + 1 < xe) load_plane(gx + 1, b_next);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    if (active) {
      const uint32_t* cur = slab + b_cur * kPlaneWords;
      const uint32_t* prev = slab + b_prev * kPlaneWords;
      uint32_t v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = (k < 4 ? cur : prev)[rd_off[k]];
      float lo = 0.0f, hi = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // corner j was read at step j ^ m
        const uint32_t w = (m & 2) ? ((m & 1) ? v[j ^ 3] : v[j ^ 2])
                                   : ((m & 1) ? v[j ^ 1] : v[j]);
        lo += __uint_as_float(w << 16);          // channel 0: low half
        hi += __uint_as_float(w & 0xffff0000u);  // channel 1: high half
      }
      out[((size_t)gx * S + gy) * S + gz] = make_float2(lo, hi);
    }
    __syncthreads();
    const int b = b_prev;
    b_prev = b_cur;
    b_cur = b_next;
    b_next = b;
  }
}

}  // namespace

// in: (R^3, 16) bf16 (C = 2), out: (size * 2) f32 with size >= (R+1)^3,
// both contiguous and 16-byte aligned on the device.  The launch geometry
// (x_chunk, grid, smem_bytes) comes from ops/reduce_cuda.py::
// launch_geometry; it must cover the S^3 outputs with the kernel's
// TY x TZ tile.  Launches on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int reduce_cell_cache_grad_bf16(const void* in, void* out, int R,
                                           int C, int64_t size, int x_chunk,
                                           int grid_x, int grid_y, int grid_z,
                                           int smem_bytes, void* stream) {
  const int64_t S = (int64_t)R + 1;
  if (R < 1 || C != 2 || size < S * S * S || x_chunk < 1 ||
      (int64_t)grid_x * kTZ < S || (int64_t)grid_y * kTY < S ||
      (int64_t)grid_z * x_chunk < S || smem_bytes != kSmemBytes ||
      (size - S * S * S) * C > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reduce_cell_cache_grad_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  float* o = (float*)out;
  reduce_cell_cache_grad_kernel<<<dim3(grid_x, grid_y, grid_z), kThreads,
                                  smem_bytes, (cudaStream_t)stream>>>(
      (const int4*)in, (float2*)o, o + S * S * S * C, R, x_chunk,
      (int)((size - S * S * S) * C));
  return (int)cudaGetLastError();
}
