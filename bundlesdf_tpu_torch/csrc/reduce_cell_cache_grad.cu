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
// with in = (R^3, 8C) bf16 and out = (S^3 * C) f32, S = R + 1.
//
// Bound: memory.  Each input byte is needed once and each output byte is
// written once: R^3*8C*2 + S^3*C*4 bytes (84.3 MB at R=128, C=2).
//
// Design: output-stationary, one thread per table entry (gx, gy, gz, ch),
// with ch and gz fastest across threads.  A thread reads at most 8 bf16
// values and sums them in f32 in _CORNERS order, then writes one f32: no
// atomics, deterministic, and bitwise equal to the plain shifted-add
// reduce (ops/hashgrid.py _reduce_cell_cache_grad).  Neighbouring threads
// read neighbouring 32-byte cache rows (consecutive gz), so a warp's loads
// for one corner cover a contiguous span; the other corners of the same
// rows hit L1/L2.  The TPU design (2-hot matmuls on the MXU over x-planes)
// is not carried over.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__global__ void reduce_cell_cache_grad_kernel(const __nv_bfloat16* __restrict__ in,
                                              float* __restrict__ out,
                                              int R, int C, int64_t n_out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int S = R + 1;
  const int ch = (int)(e % C);
  int64_t g = e / C;
  const int gz = (int)(g % S);
  g /= S;
  const int gy = (int)(g % S);
  const int gx = (int)(g / S);
  const int F = 8 * C;
  float acc = 0.0f;
#pragma unroll
  for (int ci = 0; ci < 8; ++ci) {
    const int x = gx - (ci >> 2);
    const int y = gy - ((ci >> 1) & 1);
    const int z = gz - (ci & 1);
    if ((unsigned)x < (unsigned)R && (unsigned)y < (unsigned)R &&
        (unsigned)z < (unsigned)R) {
      const int64_t row = ((int64_t)x * R + y) * R + z;
      acc += __bfloat162float(in[row * F + ci * C + ch]);
    }
  }
  out[e] = acc;
}

}  // namespace

// in: (R^3, 8C) bf16, out: (S^3 * C) f32, both contiguous on the device.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int reduce_cell_cache_grad_bf16(const void* in, void* out, int R,
                                           int C, void* stream) {
  const int64_t S = (int64_t)R + 1;
  const int64_t n_out = S * S * S * C;
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  reduce_cell_cache_grad_kernel<<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)in, (float*)out, R, C, n_out);
  return (int)cudaGetLastError();
}
