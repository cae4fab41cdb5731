// The tracker's covisibility counts for many frame pairs in one launch, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX tracker computes covisibility on the host
// (bundlesdf_tpu/tracking/frame.py::compute_covisibility), one numpy call a
// pair, and so does the port's on the CPU. Here a batch of queries (a frame
// slot A, a relative transform A -> B) is counted in one launch
// (ops/covisibility_cuda.py): for each query, A's stride-2 points that are
// valid, inside fg_mask, and whose normal, moved into B's camera, faces B's
// eye within visible_angle; for each slot, its valid points.
//
// Bound: memory. A slot's maps are read once, 25 bytes a point (xyz and
// normals as six f32 planes, one keep byte): 1.92 MB for the 240 x 320
// points of a 480 x 640 frame, 0.57 us at 3.35 TB/s. A query adds ~40 flops
// a point, so 30 queries stay far below the compute bound.
//
// Design: one thread a point, neighbouring threads on neighbouring
// addresses of each plane. A block (grid y: the slot) loads its points into
// registers once, skips the queries if none of them is kept (most of a frame
// is background), and loops over the slot's queries, whose transforms it
// stages in shared memory kQueryChunk at a time. Each warp counts a query
// with __ballot_sync / __popc into a shared counter; each block then adds
// its counters to the query's count with one integer atomicAdd. Integer
// counts make the result the same from run to run, whatever the order of
// the atomics.
//
// Numerics: the twin's f32 ops in its order, each an explicit _rn
// intrinsic, which nvcc never contracts: p_b = pts @ rel_R.T + rel_t and
// n_b = nrm @ rel_R.T as x * R[j][0], then fused multiply-adds of y and z
// (the order OpenBLAS's sgemm takes for a depth of 3), then the translation;
// norms as sqrt((x*x + y*y) + z*z) + 1e-10 and the dot as ((a + b) + c), as
// numpy reduces a last axis of 3. The threshold is the f32 value that
// numpy's own comparison of the f32 dots against np.cos(np.deg2rad(angle))
// amounts to (computed by the host). Where the twin's BLAS sums in another
// order than this, only a point whose dot lies within rounding of the
// threshold can flip.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// queries a block stages in shared memory at once (12 floats each)
constexpr int kQueryChunk = 64;

// f32 row j of (x, y, z) @ R.T, with R row-major in T.
__device__ __forceinline__ float row(const float* T, int j, float x, float y, float z) {
  return __fmaf_rn(z, T[3 * j + 2], __fmaf_rn(y, T[3 * j + 1], __fmul_rn(x, T[3 * j])));
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fadd_rn(__fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                        __fmul_rn(z, z))),
                   1e-10f);
}

// Whether the point (x, y, z) with normal (a, b, c) of frame A faces B's eye
// within the threshold, under T = (rel_R row-major, rel_t).
__device__ __forceinline__ bool faces_eye(const float* T, float thres, float x, float y,
                                          float z, float a, float b, float c) {
  const float px = __fadd_rn(row(T, 0, x, y, z), T[9]);
  const float py = __fadd_rn(row(T, 1, x, y, z), T[10]);
  const float pz = __fadd_rn(row(T, 2, x, y, z), T[11]);
  const float nx = row(T, 0, a, b, c), ny = row(T, 1, a, b, c), nz = row(T, 2, a, b, c);
  const float pn = norm3(px, py, pz), nn = norm3(nx, ny, nz);
  const float dot = __fadd_rn(
      __fadd_rn(__fmul_rn(__fdiv_rn(-px, pn), __fdiv_rn(nx, nn)),
                __fmul_rn(__fdiv_rn(-py, pn), __fdiv_rn(ny, nn))),
      __fmul_rn(__fdiv_rn(-pz, pn), __fdiv_rn(nz, nn)));
  return dot > thres;
}

// Slot g = blockIdx.y: maps[g] points at n_points[g] x-, y-, z-, nx-, ny-,
// nz-plane floats, then n_points[g] keep bytes; its queries are
// [q_begin[g], q_begin[g + 1]), each 12 floats of rel. counts and totals
// hold zeros at the launch.
__global__ void __launch_bounds__(kThreads)
covisibility_kernel(const uint64_t* __restrict__ maps, const int* __restrict__ n_points,
                    const int* __restrict__ q_begin, const float* __restrict__ rel,
                    float thres, unsigned* __restrict__ counts,
                    unsigned* __restrict__ totals) {
  __shared__ float sq[kQueryChunk * 12];
  __shared__ unsigned sc[kQueryChunk];
  const int g = blockIdx.y;
  const int P = n_points[g];
  const int first = (int)(blockIdx.x * blockDim.x);
  if (first >= P) return;  // the whole block lies past this slot's points
  const int i = first + (int)threadIdx.x;
  const float* m = reinterpret_cast<const float*>(maps[g]);
  const uint8_t* keep = reinterpret_cast<const uint8_t*>(m + 6 * (size_t)P);
  const bool ok = i < P && keep[i] != 0;
  float x = 0.f, y = 0.f, z = 0.f, a = 0.f, b = 0.f, c = 0.f;
  if (ok) {
    x = m[i], y = m[P + i], z = m[2 * P + i];
    a = m[3 * P + i], b = m[4 * P + i], c = m[5 * P + i];
  }
  const bool lead = (threadIdx.x & 31) == 0;
  const unsigned kept = __ballot_sync(0xffffffffu, ok);
  if (lead && kept) atomicAdd(&totals[g], (unsigned)__popc(kept));
  if (!__syncthreads_or(ok)) return;  // no kept point in this block

  const int q_end = q_begin[g + 1];
  for (int q0 = q_begin[g]; q0 < q_end; q0 += kQueryChunk) {
    const int n = min(kQueryChunk, q_end - q0);
    for (int k = threadIdx.x; k < n * 12; k += blockDim.x) sq[k] = rel[(size_t)q0 * 12 + k];
    for (int k = threadIdx.x; k < n; k += blockDim.x) sc[k] = 0u;
    __syncthreads();
    for (int q = 0; q < n; ++q) {
      const unsigned v =
          __ballot_sync(0xffffffffu, ok && faces_eye(sq + 12 * q, thres, x, y, z, a, b, c));
      if (lead && v) atomicAdd(&sc[q], (unsigned)__popc(v));
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      if (sc[k]) atomicAdd(&counts[q0 + k], sc[k]);
    }
    __syncthreads();  // before the next chunk overwrites sq and sc
  }
}

}  // namespace

// maps: n_groups device pointers (u64) to each slot's planes and keep bytes;
// n_points: n_groups ints; q_begin: n_groups + 1 ints; rel: 12 floats a
// query (rel_R row-major, rel_t); thres: the f32 threshold on the dot;
// counts (a query) and totals (a slot): unsigned ints, zero on entry.
// Every array is on the device. Enqueues the kernel on `stream`; returns
// the launch's CUDA error (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int covisibility_count_f32(const void* maps, const void* n_points,
                                      const void* q_begin, const void* rel, int n_groups,
                                      int max_points, float thres, void* counts,
                                      void* totals, void* stream) {
  if (n_groups < 1 || n_groups > 65535 || max_points < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((max_points + kThreads - 1) / kThreads), (unsigned)n_groups);
  covisibility_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)maps, (const int*)n_points, (const int*)q_begin, (const float*)rel,
      thres, (unsigned*)counts, (unsigned*)totals);
  return (int)cudaGetLastError();
}
