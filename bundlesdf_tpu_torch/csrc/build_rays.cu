// A round's new NOF rays built on the card, for Hopper (sm_90a): the
// pixel selection, the ray/box clip, the occupancy cull, the 2-cm cloud
// denoise and an order-preserving compaction of the kept rows into the
// ray pool.
//
// Replaces no TPU kernel: the JAX package builds a round's rays on the host
// (bundlesdf_tpu/nof/runner.py), and so does the port's on the CPU, its
// twin nof/runner.py::NofRunner._build_frame_rays, _cull_rays_by_occupancy
// and _denoise_rays_by_cloud. There a 480 x 640 keyframe's square
// dilation, gathers, clip, a torch march of (N, n_march) cells and a
// cKDTree over the fused cloud took ~150-270 ms of host time a round of the
// joint loop. Here the host uploads the round's frames and reads back one
// count; the rows go from the card into the pool.
//
// Bound: the bytes the work needs are each pixel's 30 read once (f32
// colour, depth and camera direction, mask and occlusion bytes) and each
// kept row's 48 written once: 11.0 MB for a 480 x 640 joint60 keyframe
// with ~38k kept rows, 3.3 us at 3.35 TB/s. The march's grid reads are not
// counted there: up to n_march probes of a (R, R, R) byte grid a candidate
// ray, a dependent chain; a ray stops at its first occupied midpoint, so
// a ray that misses makes all n_march.
//
// Design: rays_rows_kernel, one thread a pixel, writes the row pass of the
// square dilation (a byte: any mask pixel in the window); rays_select_kernel
// takes the column pass and the frame's occlusion, depth and type-1 rules
// into one candidate byte a pixel and counts each frame's candidates;
// rays_flags_kernel, one thread a pixel, runs the clip, the march and the
// denoise of each candidate and writes 1 where the row stays, with its
// near and far; scan_tiles_kernel, scan_sums_kernel and scan_add_kernel turn
// those flags into each kept row's position in frame order, then row-major
// pixel order (np.where's order and the frames' concatenation); and
// rays_write_kernel writes each kept row there. The denoise searches a
// uniform grid of the build cloud (cloud_cells_kernel counts the points a
// cell, the scan gives each cell's first slot, cloud_fill_kernel places the
// points) over the 27 cells around a ray's point. A cell is at least
// 1/16 wider than the 2-cm radius, so a cloud point within the radius lies
// in one of those cells, and the nearest distance within the radius is the
// cKDTree's.
//
// Numerics: the twin's bits, every op an explicit _rn intrinsic, which nvcc
// never contracts. The twin's numpy and torch CPU arithmetic is followed as
// it rounds: np.linalg.norm of an f32 row sums (x0^2 + x1^2) + x2^2; the
// build's d_unit @ R^T is OpenBLAS sgemm's FMA chain over k = 0, 1, 2, and,
// for a frame of one row, its sgemv's fma(d2, r2, fma(d0, r0, d1 * r1));
// ray_box_intersection_np works in f64 beside its f32 direction, with
// numpy's maximum and minimum (the second operand on a tie); the cull's and
// the denoise's einsum sum (p0 + p1) + p2; torch's CPU norm is an FMA chain
// from x0^2; torch's cumsum of the occupied step lengths sums in f64, so a
// ray hits where f32(count * dt) > f32(1e-8). A comparison of an f32 with a
// Python float is made in f32, as numpy and torch make it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the scan: ints a tile, and threads a block (each takes a contiguous run)
constexpr int kScanThreads = 256;
constexpr int kScanTile = 2048;
// words a frame's parameters take: R row-major (9 f32), t (3 f32), the
// frame id and the dilation size (2 i32)
constexpr int kParamWords = 16;
// options
constexpr int kHasOcc = 1;
constexpr int kValidDepthOnly = 2;
constexpr int kDenoise = 4;
// f32(1e-10) and f32(1e-8), as numpy and torch round the Python floats
constexpr float kEps32 = 1e-10f;
constexpr float kHitEps32 = 1e-8f;

// Frame b of the uploaded batch: f32 colour (3 a pixel), f32 depth, the
// mask byte and the occlusion byte, each frame `stride` bytes from the last.
struct Frame {
  const float* rgb;
  const float* depth;
  const uint8_t* mask;
  const uint8_t* occ;
};

__device__ __forceinline__ Frame frame_at(const uint8_t* frames, long long stride, int hw,
                                          int b) {
  const uint8_t* p = frames + (long long)b * stride;
  Frame f;
  f.rgb = (const float*)p;
  f.depth = (const float*)(p + 12LL * hw);
  f.mask = p + 16LL * hw;
  f.occ = p + 17LL * hw;
  return f;
}

__device__ __forceinline__ int param_int(const float* params, int b, int w) {
  return ((const int*)params)[b * kParamWords + w];
}

// numpy's maximum and minimum: the second operand on a tie (and so the sign
// of a zero); no NaN reaches them.
__device__ __forceinline__ double np_max(double a, double b) { return a > b ? a : b; }
__device__ __forceinline__ double np_min(double a, double b) { return a < b ? a : b; }

// np.linalg.norm of an f32 3-vector.
__device__ __forceinline__ float np_norm3(float a, float b, float c) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c)));
}

// torch.linalg.norm over the last axis of an f32 (N, 3) on the CPU.
__device__ __forceinline__ float torch_norm3(float a, float b, float c) {
  return __fsqrt_rn(__fmaf_rn(c, c, __fmaf_rn(b, b, __fmul_rn(a, a))));
}

// One row r of R times d as np.einsum("nab,nb->na") gives it.
__device__ __forceinline__ float einsum_row(const float* r, const float* d) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], d[0]), __fmul_rn(r[1], d[1])), __fmul_rn(r[2], d[2]));
}

// ray_box_intersection_np(o, w, -1, 1): true where the ray meets the box,
// with its entry and exit (f64).
__device__ bool np_box_clip(const float* o, const float* w, double* tmin, double* tmax) {
  const float den = __fadd_rn(np_norm3(w[0], w[1], w[2]), kEps32);
  double lo = 0.0, hi = 0.0;
  for (int k = 0; k < 3; ++k) {
    const float d = __fdiv_rn(w[k], den);
    const double s = fabsf(d) < kEps32 ? (d < 0.0f ? -1e-10 : 1e-10) : (double)d;
    const double inv = __ddiv_rn(1.0, s);
    const double t0 = __dmul_rn(__dsub_rn(-1.0, (double)o[k]), inv);
    const double t1 = __dmul_rn(__dsub_rn(1.0, (double)o[k]), inv);
    const double tn = np_max(np_min(t0, t1), 0.0);
    const double tf = np_max(t0, t1);
    lo = k ? np_max(lo, tn) : tn;
    hi = k ? np_min(hi, tf) : tf;
  }
  *tmin = lo;
  *tmax = hi;
  return lo <= hi;
}

// sample_rays_in_occupied_space(grid, o, e, n_march, n_samples=1,
// perturb=False)[1] on the CPU: torch's ray_box_intersection in f32, then
// the midpoints of n_march equal steps along the chord, each tested against
// the (R, R, R) grid; stops once the hit is decided.
__device__ bool torch_occupied(const uint8_t* __restrict__ grid, int R, int n_march,
                               const float* o, const float* e) {
  const float den = __fadd_rn(torch_norm3(e[0], e[1], e[2]), kEps32);
  float lo = 0.0f, hi = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float d = __fdiv_rn(e[k], den);
    const float s = fabsf(d) < kEps32 ? (d < 0.0f ? -kEps32 : kEps32) : d;
    const float inv = __fdiv_rn(1.0f, s);
    const float t0 = __fmul_rn(__fsub_rn(-1.0f, o[k]), inv);
    const float t1 = __fmul_rn(__fsub_rn(1.0f, o[k]), inv);
    const float tn = fmaxf(fminf(t0, t1), 0.0f);
    const float tf = fmaxf(t0, t1);
    lo = k ? fmaxf(lo, tn) : tn;
    hi = k ? fminf(hi, tf) : tf;
  }
  if (!(lo <= hi)) return false;
  const float dt = __fdiv_rn(__fsub_rn(hi, lo), (float)n_march);
  const float Rf = (float)R;
  int count = 0;
  for (int m = 0; m < n_march; ++m) {
    const float tm = __fadd_rn(lo, __fmul_rn((float)m + 0.5f, dt));
    bool inside = true;
    int idx = 0;
    for (int k = 0; k < 3; ++k) {
      const float p = __fadd_rn(o[k], __fmul_rn(e[k], tm));
      const float g = floorf(__fmul_rn(__fmul_rn(__fadd_rn(p, 1.0f), 0.5f), Rf));
      inside = inside && g >= 0.0f && g < Rf;
      const int gi = g < 0.0f ? 0 : (g > Rf - 1.0f ? R - 1 : (int)g);
      idx = idx * R + gi;
    }
    if (inside && grid[idx]) {
      ++count;
      // the cumsum's f64 total of count steps of dt, cast to f32
      if (dt > kHitEps32 || __double2float_rn((double)count * (double)dt) > kHitEps32) {
        return true;
      }
    }
  }
  return false;
}

// The build cloud's uniform grid.
struct Cloud {
  const float* pts;    // the points sorted by cell, 3 a point
  const int* starts;   // each cell's first point; starts[cells] = the count
  int n;
  double lo[3];
  double inv_cell;
  int dims[3];
};

// True unless the cloud's nearest point to q lies farther than thr (the
// twin's cKDTree distance > thr drops the row).
__device__ bool cloud_near(const Cloud& c, const double* q, double thr) {
  int lo[3], hi[3];
  for (int k = 0; k < 3; ++k) {
    const double f = floor(__dmul_rn(__dsub_rn(q[k], c.lo[k]), c.inv_cell));
    if (!(f >= -1.0 && f <= (double)c.dims[k])) return false;  // no cell within reach
    lo[k] = max((int)f - 1, 0);
    hi[k] = min((int)f + 1, c.dims[k] - 1);
  }
  double best = INFINITY;
  for (int x = lo[0]; x <= hi[0]; ++x) {
    for (int y = lo[1]; y <= hi[1]; ++y) {
      for (int z = lo[2]; z <= hi[2]; ++z) {
        const int cell = (x * c.dims[1] + y) * c.dims[2] + z;
        for (int j = c.starts[cell]; j < c.starts[cell + 1]; ++j) {
          const double dx = __dsub_rn(q[0], (double)c.pts[3 * j]);
          const double dy = __dsub_rn(q[1], (double)c.pts[3 * j + 1]);
          const double dz = __dsub_rn(q[2], (double)c.pts[3 * j + 2]);
          const double s =
              __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
          best = s < best ? s : best;
        }
      }
    }
  }
  return best != INFINITY && !(__dsqrt_rn(best) > thr);
}

// The row pass of the square dilation: rowmax[b, v, u] = 1 where a mask
// pixel of row v lies at offsets [-(k / 2), k - 1 - k / 2] from u (k the
// frame's dilation size; cv2's anchor k / 2, the border adds nothing).
__global__ void __launch_bounds__(kThreads)
rays_rows_kernel(const uint8_t* __restrict__ frames, long long stride,
                 const float* __restrict__ params, int H, int W, uint8_t* __restrict__ rowmax) {
  const int b = blockIdx.y;
  const int hw = H * W;
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= hw) return;
  const Frame f = frame_at(frames, stride, hw, b);
  const int k = param_int(params, b, 13);
  const int v = i / W, u = i % W;
  const int lo = max(u - k / 2, 0), hi = min(u + (k - 1 - k / 2), W - 1);
  const uint8_t* row = f.mask + (size_t)v * W;
  uint8_t any = 0;
  for (int x = lo; x <= hi && !any; ++x) any = row[x] != 0;
  rowmax[(size_t)b * hw + i] = any;
}

// The column pass, then _build_frame_rays' rules: the occlusion mask and,
// under rays_valid_depth_only, invalid depth clear the selection; the
// type-1 rows (mask with depth outside [near, far] * sc) go. cand gets 1
// a pixel whose row survives to the clip; counts[b] the frame's count
// (zero on entry).
__global__ void __launch_bounds__(kThreads)
rays_select_kernel(const uint8_t* __restrict__ frames, long long stride,
                   const float* __restrict__ params, int H, int W,
                   const uint8_t* __restrict__ rowmax, float near_sc, float far_sc, int options,
                   uint8_t* __restrict__ cand, int* __restrict__ counts) {
  __shared__ int n_block;
  const int b = blockIdx.y;
  const int hw = H * W;
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (threadIdx.x == 0) n_block = 0;
  __syncthreads();
  if (i < hw) {
    const Frame f = frame_at(frames, stride, hw, b);
    const int k = param_int(params, b, 13);
    const int v = i / W, u = i % W;
    const int lo = max(v - k / 2, 0), hi = min(v + (k - 1 - k / 2), H - 1);
    const uint8_t* col = rowmax + (size_t)b * hw + u;
    bool sel = false;
    for (int y = lo; y <= hi && !sel; ++y) sel = col[(size_t)y * W] != 0;
    const float d = f.depth[i];
    const bool invalid = (d < near_sc || d > far_sc) && f.mask[i] != 0;
    if ((options & kHasOcc) && f.occ[i] != 0) sel = false;
    if ((options & kValidDepthOnly) && invalid) sel = false;
    const bool c = sel && !invalid;
    cand[(size_t)b * hw + i] = c;
    if (c) atomicAdd(&n_block, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_block) atomicAdd(&counts[b], n_block);
}

// One thread a pixel: for a candidate, the clip of _build_frame_rays, the
// occupancy cull and the cloud denoise; keep[b * hw + i] gets 1 where its
// row stays (0 elsewhere), nearfar that row's near and far.
__global__ void __launch_bounds__(kThreads)
rays_flags_kernel(const uint8_t* __restrict__ frames, long long stride,
                  const float* __restrict__ params, int H, int W,
                  const float* __restrict__ dirs, const uint8_t* __restrict__ cand,
                  const int* __restrict__ counts, const uint8_t* __restrict__ grid, int R,
                  int n_march, float far_sc, int options, Cloud cloud, double thr,
                  int* __restrict__ keep, float* __restrict__ nearfar) {
  const int b = blockIdx.y;
  const int hw = H * W;
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= hw) return;
  const size_t at = (size_t)b * hw + i;
  int kept = 0;
  if (cand[at]) {
    const float* P = params + b * kParamWords;
    const float x[3] = {dirs[3 * (size_t)i], dirs[3 * (size_t)i + 1], dirs[3 * (size_t)i + 2]};
    const float n = np_norm3(x[0], x[1], x[2]);
    const float d[3] = {__fdiv_rn(x[0], n), __fdiv_rn(x[1], n), __fdiv_rn(x[2], n)};
    float w[3];
    for (int r = 0; r < 3; ++r) {
      const float* row = P + 3 * r;
      w[r] = counts[b] == 1
                 ? __fmaf_rn(d[2], row[2], __fmaf_rn(d[0], row[0], __fmul_rn(d[1], row[1])))
                 : __fmaf_rn(d[2], row[2], __fmaf_rn(d[1], row[1], __fmul_rn(d[0], row[0])));
    }
    double tmin, tmax;
    if (np_box_clip(P + 9, w, &tmin, &tmax)) {
      const float e[3] = {einsum_row(P, d), einsum_row(P + 3, d), einsum_row(P + 6, d)};
      if (torch_occupied(grid, R, n_march, P + 9, e)) {
        kept = 1;
        const Frame f = frame_at(frames, stride, hw, b);
        const float depth = f.depth[i];
        if ((options & kDenoise) && cloud.n > 0 && f.mask[i] != 0 && depth <= far_sc) {
          const float p[3] = {__fmul_rn(x[0], depth), __fmul_rn(x[1], depth),
                              __fmul_rn(x[2], depth)};
          const double q[3] = {(double)__fadd_rn(einsum_row(P, p), P[9]),
                               (double)__fadd_rn(einsum_row(P + 3, p), P[10]),
                               (double)__fadd_rn(einsum_row(P + 6, p), P[11])};
          kept = cloud_near(cloud, q, thr);
        }
        nearfar[2 * at] = __double2float_rn(tmin);
        nearfar[2 * at + 1] = __double2float_rn(tmax);
      }
    }
  }
  keep[at] = kept;
}

// Inclusive Hillis-Steele scan of part[0 .. blockDim.x) in shared memory.
__device__ void block_scan(int* part) {
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    const int v = (int)threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
}

// Each tile of kScanTile ints of data scanned in place (exclusive), its
// total into sums[tile]; a thread takes a contiguous run of the tile.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(int* __restrict__ data, long long n, int* __restrict__ sums) {
  __shared__ int part[kScanThreads];
  const long long t0 = (long long)blockIdx.x * kScanTile;
  const long long end = min(t0 + (long long)kScanTile, n);
  const int per = (kScanTile + (int)blockDim.x - 1) / (int)blockDim.x;
  const long long lo = t0 + (long long)threadIdx.x * per;
  const long long hi = min(lo + per, end);
  int s = 0;
  for (long long j = lo; j < hi; ++j) s += data[j];
  part[threadIdx.x] = s;
  __syncthreads();
  block_scan(part);
  int run = threadIdx.x ? part[threadIdx.x - 1] : 0;
  for (long long j = lo; j < hi; ++j) {
    const int v = data[j];
    data[j] = run;
    run += v;
  }
  if (threadIdx.x == blockDim.x - 1) sums[blockIdx.x] = part[threadIdx.x];
}

// One block: the n tile totals scanned in place (exclusive), the whole
// total into *total.
__global__ void __launch_bounds__(kScanThreads)
scan_sums_kernel(int* __restrict__ sums, int n, int* __restrict__ total) {
  __shared__ int part[kScanThreads];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += (int)blockDim.x) {
    const int j = base + (int)threadIdx.x;
    const int v = j < n ? sums[j] : 0;
    part[threadIdx.x] = v;
    __syncthreads();
    block_scan(part);
    if (j < n) sums[j] = carry + part[threadIdx.x] - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry += part[threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kThreads)
scan_add_kernel(int* __restrict__ data, long long n, const int* __restrict__ sums) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) data[i] += sums[i / kScanTile];
}

// pos holds the exclusive scan of the keep flags (B * hw + 1 entries): a
// kept pixel's row goes to out row pos[at], as _build_frame_rays lays it out
// (camera direction, colour, depth, mask, frame id, type 0, near, far).
__global__ void __launch_bounds__(kThreads)
rays_write_kernel(const uint8_t* __restrict__ frames, long long stride,
                  const float* __restrict__ params, int H, int W,
                  const float* __restrict__ dirs, const int* __restrict__ pos,
                  const float* __restrict__ nearfar, float* __restrict__ out) {
  const int b = blockIdx.y;
  const int hw = H * W;
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= hw) return;
  const size_t at = (size_t)b * hw + i;
  const int j = pos[at];
  if (pos[at + 1] == j) return;
  const Frame f = frame_at(frames, stride, hw, b);
  float* row = out + 12 * (size_t)j;
  row[0] = dirs[3 * (size_t)i];
  row[1] = dirs[3 * (size_t)i + 1];
  row[2] = dirs[3 * (size_t)i + 2];
  row[3] = f.rgb[3 * (size_t)i];
  row[4] = f.rgb[3 * (size_t)i + 1];
  row[5] = f.rgb[3 * (size_t)i + 2];
  row[6] = f.depth[i];
  row[7] = f.mask[i] != 0 ? 1.0f : 0.0f;
  row[8] = (float)param_int(params, b, 12);
  row[9] = 0.0f;
  row[10] = nearfar[2 * at];
  row[11] = nearfar[2 * at + 1];
}

__device__ __forceinline__ int cloud_cell(const float* p, const double* lo, double inv,
                                          const int* dims) {
  int cell = 0;
  for (int k = 0; k < 3; ++k) {
    const double f = floor(__dmul_rn(__dsub_rn((double)p[k], lo[k]), inv));
    const int c = f < 0.0 ? 0 : (f > (double)(dims[k] - 1) ? dims[k] - 1 : (int)f);
    cell = cell * dims[k] + c;
  }
  return cell;
}

// Each cloud point's cell into cell_of, and counts[cell] += 1 (zero on entry).
__global__ void __launch_bounds__(kThreads)
cloud_cells_kernel(const float* __restrict__ pts, int n, double lo_x, double lo_y, double lo_z,
                   double inv, int nx, int ny, int nz, int* __restrict__ cell_of,
                   int* __restrict__ counts) {
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const double lo[3] = {lo_x, lo_y, lo_z};
  const int dims[3] = {nx, ny, nz};
  const int cell = cloud_cell(pts + 3 * (size_t)i, lo, inv, dims);
  cell_of[i] = cell;
  atomicAdd(&counts[cell], 1);
}

// Each point into its cell's slots (the order within a cell is free: the
// search takes the smallest distance); fill is zero on entry.
__global__ void __launch_bounds__(kThreads)
cloud_fill_kernel(const float* __restrict__ pts, int n, const int* __restrict__ cell_of,
                  const int* __restrict__ starts, int* __restrict__ fill,
                  float* __restrict__ sorted) {
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const int cell = cell_of[i];
  const int j = starts[cell] + atomicAdd(&fill[cell], 1);
  sorted[3 * (size_t)j] = pts[3 * (size_t)i];
  sorted[3 * (size_t)j + 1] = pts[3 * (size_t)i + 1];
  sorted[3 * (size_t)j + 2] = pts[3 * (size_t)i + 2];
}

dim3 pixel_grid(int hw, int n_frames) {
  return dim3((unsigned)((hw + kThreads - 1) / kThreads), (unsigned)n_frames);
}

bool bad_batch(int H, int W, int n_frames) {
  return H < 1 || W < 1 || n_frames < 1 || n_frames > 65535 || (long long)H * W > (1LL << 30);
}

}  // namespace

// Every pointer is on the device; frames holds n_frames frames of H x W,
// each `stride` bytes from the last (frame_at's layout), params 16 words a
// frame. Each entry enqueues its kernels on `stream` and returns the
// launch's CUDA error (0 on success), or cudaErrorInvalidValue for
// arguments the kernels do not take.

// rowmax, cand: a byte a pixel; counts: an int a frame, zero on entry.
extern "C" int build_rays_select(const void* frames, long long stride, const void* params,
                                 int n_frames, int H, int W, float near_sc, float far_sc,
                                 int options, void* rowmax, void* cand, void* counts,
                                 void* stream) {
  if (bad_batch(H, W, n_frames)) return (int)cudaErrorInvalidValue;
  const dim3 grid = pixel_grid(H * W, n_frames);
  rays_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, stride, (const float*)params, H, W, (uint8_t*)rowmax);
  rays_select_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, stride, (const float*)params, H, W, (const uint8_t*)rowmax,
      near_sc, far_sc, options, (uint8_t*)cand, (int*)counts);
  return (int)cudaGetLastError();
}

// dirs: (H, W, 3) f32; grid: (R, R, R) bytes; the cloud: n_cloud points
// sorted by cell (f32, 3 a point), starts (cells + 1 ints), the grid's
// corner, inverse cell width and dims; keep: an int a pixel; nearfar: 2
// f32 a pixel.
extern "C" int build_rays_flags(const void* frames, long long stride, const void* params,
                                int n_frames, int H, int W, const void* dirs, const void* cand,
                                const void* counts, const void* grid, int R, int n_march,
                                float far_sc, int options, const void* cloud_pts,
                                const void* cloud_starts, int n_cloud, double lo_x, double lo_y,
                                double lo_z, double inv_cell, int nx, int ny, int nz,
                                double thr, void* keep, void* nearfar, void* stream) {
  if (bad_batch(H, W, n_frames) || R < 1 || R > 1024 || n_march < 1 || n_cloud < 0 ||
      (n_cloud > 0 && (nx < 1 || ny < 1 || nz < 1))) {
    return (int)cudaErrorInvalidValue;
  }
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
  rays_flags_kernel<<<pixel_grid(H * W, n_frames), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, stride, (const float*)params, H, W, (const float*)dirs,
      (const uint8_t*)cand, (const int*)counts, (const uint8_t*)grid, R, n_march, far_sc,
      options, cloud, thr, (int*)keep, (float*)nearfar);
  return (int)cudaGetLastError();
}

// data: n ints scanned in place (exclusive); sums: one int a tile of
// kScanTile; total: one int.
extern "C" int build_rays_scan(void* data, long long n, void* sums, void* total, void* stream) {
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  if (n < 1 || tiles > (1LL << 30)) return (int)cudaErrorInvalidValue;
  scan_tiles_kernel<<<(unsigned)tiles, kScanThreads, 0, (cudaStream_t)stream>>>(
      (int*)data, n, (int*)sums);
  scan_sums_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>((int*)sums, (int)tiles,
                                                                 (int*)total);
  scan_add_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>((int*)data, n, (const int*)sums);
  return (int)cudaGetLastError();
}

// pos: the scanned keep flags (B * hw + 1 ints); out: 12 f32 a kept row.
extern "C" int build_rays_write(const void* frames, long long stride, const void* params,
                                int n_frames, int H, int W, const void* dirs, const void* pos,
                                const void* nearfar, void* out, void* stream) {
  if (bad_batch(H, W, n_frames)) return (int)cudaErrorInvalidValue;
  rays_write_kernel<<<pixel_grid(H * W, n_frames), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, stride, (const float*)params, H, W, (const float*)dirs,
      (const int*)pos, (const float*)nearfar, (float*)out);
  return (int)cudaGetLastError();
}

// pts: n f32 points (3 a point); cell_of: an int a point; counts: an int a
// cell, zero on entry.
extern "C" int build_rays_cloud_cells(const void* pts, int n, double lo_x, double lo_y,
                                      double lo_z, double inv_cell, int nx, int ny, int nz,
                                      void* cell_of, void* counts, void* stream) {
  if (n < 1 || nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  cloud_cells_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>((const float*)pts, n, lo_x, lo_y, lo_z, inv_cell,
                                               nx, ny, nz, (int*)cell_of, (int*)counts);
  return (int)cudaGetLastError();
}

// starts: the scanned counts; fill: an int a cell, zero on entry; sorted:
// n f32 points.
extern "C" int build_rays_cloud_fill(const void* pts, int n, const void* cell_of,
                                     const void* starts, void* fill, void* sorted,
                                     void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cloud_fill_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>((const float*)pts, n, (const int*)cell_of,
                                              (const int*)starts, (int*)fill, (float*)sorted);
  return (int)cudaGetLastError();
}
