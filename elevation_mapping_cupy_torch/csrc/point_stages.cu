// point_stages: the update's per-point chain as two kernels, for B maps in
// one launch each. D4 points_associate feeds K1's first launch (error
// counting), D5 points_fuse its second (the Kalman fusion).
//
// Replaces no TPU kernel: the JAX package's per-point chain
// (elevation_mapping_cupy_tpu/ops/geometry.py::associate_points,
// ops/pointcloud.py::error_counting and point_fusion) is XLA ops, which XLA
// fuses. Eager PyTorch cannot fuse them: the port's plain versions
// (ops/point_stages.py::_associate and _fuse) issue ~120 launches a batched
// update more than these two kernels, most of them elementwise passes over
// strided views (points[..., 0], world[..., 2]) or broadcast per-map
// scalars, each of which reads and writes whole (B, N) tensors: several GB
// a step of 64 maps of 100000 points, for 13 bytes of input a point.
//
// What D4 computes, per point of a (B, N, 3 + C) cloud (xyz first, rows
// row_stride floats apart): the world point R p + t, its z noise, its cell
// (true division by the resolution, truncated and clamped) and flat index,
// the validity ramp, the inside-border test and the mask; the cell's height,
// variance, validity and traversability; the drift compensation's inlier
// test; K1's two error-counting streams [inlier, mask]; and per map the sum
// of z - h over the inliers and their count. D5 then takes the drift
// correction h_delta of each map and the per-cell point counts of K1's first
// launch and computes, per point, the outlier, edge-skip and fuse predicates
// and the Kalman proposals: K1's four fusion streams [fuse new_h, fuse new_v,
// fuse, outlier] and their active mask fuse | outlier. The error sums have to
// be complete before the drift compensation and so before D5: that is why
// the chain is two kernels and not one.
//
// Rounding. Every output but error_sum must equal the plain version's on the
// card bit for bit. So every operation rounds as the PyTorch op it stands
// for: multiplies, adds and divisions are __fmul_rn, __fadd_rn, __fsub_rn and
// __fdiv_rn (nvcc would otherwise contract them into FMAs), the cell index's
// division by the resolution is a true division (geometry.true_div), sqrt is
// the correctly rounded one, clamps let a NaN through as PyTorch's do and a
// float-to-int cast truncates (a NaN point lands on cell 0, as on the card).
// Sums keep PyTorch's order: R p + t as ((R0 x + R1 y) + R2 z) + t, and the
// squared distance to the sensor as (dx^2 + dz^2) + dy^2, which is how
// torch.sum adds a contiguous axis of three on CUDA (two lanes, the first
// adding elements 0 and 2). Every Python scalar arrives as the float32
// PyTorch casts it to (`consts`). error_sum adds in float64 and rounds once:
// each block's inliers in a fixed tree, then the blocks' partial sums in a
// fixed order, with no atomics. Two runs give the same bits, and the result
// is the float64 sum of the terms rounded to float32, closer to the true sum
// than the plain version's float32 torch.sum.
//
// Bound: bytes. D4 reads each point's xyz, pad flag and its cell's four
// layer values and writes 39 bytes (world, noise, index, three flags, two
// streams, the cell's height and variance for D5); D5 reads z, noise, index,
// mask, height and variance (and the cell's point count with edge
// sharpening) and writes 17 bytes. About 110 bytes a point: 0.21 ms for
// 64 maps of 100000 points at 3.35 TB/s.
//
// Design. One thread a point, neighbouring threads on neighbouring points of
// one map (the grid's second axis is the map), so the per-point streams are
// coalesced; the cell reads are gathers, and only points under the mask read
// more than the two values D5 needs. D4's error sums: a warp shuffle and
// then shared memory sum each block's inliers, one partial a block, and a
// second kernel of one block a map adds the partials; both kernels are one
// call of the entry point.
//
// Built by elevation_mapping_cupy_torch/kernels.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpoint_stages.so point_stages.cu
// and called through ctypes: each C entry point returns the first CUDA error.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kChannels = 7;

// the float32 values of the plain version's Python scalars, in the order of
// ops/point_stages.py::_kernel_constants
enum Const : int {
  kRes,          // resolution
  kHalfN,        // 0.5 * cell_n
  kTop,          // cell_n - 1
  kNoiseFactor,  // sensor_noise_factor
  kRampB,        // ramped_height_range_b
  kMinDist2,     // min_valid_distance ** 2
  kRampA,        // ramped_height_range_a
  kRampC,        // ramped_height_range_c
  kMaxHeight,    // max_height_range
  kHalf,         // 0.5 (a cell is valid above it)
  kMahal,        // mahalanobis_thresh
  kDriftVar,     // drift_compensation_variance_inlier / 2.0
  kTravInlier,   // traversability_inlier
  kWall,         // wall_num_thresh
  kMinCount,     // 1e-12
  kConsts
};

struct AssocArgs {
  const float* points;    // (B, N, 3 + C), xyz contiguous, rows row_stride apart
  const bool* pad;        // (B, N) contiguous
  const float* R;         // (B, 3, 3) contiguous
  const float* t;         // (B, 3) contiguous
  const float* layers;    // (B, 7, n, n) contiguous
  float* world;           // (B, N, 3)
  float* noise;           // (B, N)
  int32_t* flat;          // (B, N)
  bool* valid;            // (B, N)
  bool* inside;           // (B, N)
  bool* mask;             // (B, N)
  float* counted;         // (B, 2, N): [inlier, mask]
  float2* rows;           // (B, N): the cell's height and variance
  double* part_sum;       // (B, blocks a map)
  int32_t* part_cnt;      // (B, blocks a map)
  int64_t map_stride;     // floats between maps of `points`
  int64_t row_stride;     // floats between points of `points`
  int32_t n;              // points a map
  int32_t cell_n;         // the map is cell_n x cell_n
  float c[kConsts];
};

struct FuseArgs {
  const float* world;      // (B, N, 3)
  const float* noise;      // (B, N)
  const int32_t* flat;     // (B, N)
  const bool* mask;        // (B, N)
  const float2* rows;      // (B, N)
  const float* h_delta;    // (B,)
  const float* point_cnt;  // (B, n, n), cells contiguous, maps pc_stride apart
  float* streams;          // (B, 4, N): [fuse new_h, fuse new_v, fuse, outlier]
  bool* active;            // (B, N): fuse | outlier
  int64_t pc_stride;
  int32_t n;
  int32_t edge_sharpen;
  float c[kConsts];
};

// torch.clamp(x, lo, hi) on float32: a NaN passes
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// geometry._axis_index: trunc(clamp(true_div(x, res) + 0.5 n, 0, n - 1))
__device__ __forceinline__ int32_t axis_index(float x, const float* c) {
  const float f = __fadd_rn(__fdiv_rn(x, c[kRes]), c[kHalfN]);
  return static_cast<int32_t>(truncf(clamp_nan(f, 0.0f, c[kTop])));
}

// the block's sum of `v` in a fixed order (warps by shuffle, then warp 0
// over the warps); the result is thread 0's
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* shared) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kAll, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // `shared` may still be read from a previous call
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = shared[0];
    for (int k = 1; k < kWarps; ++k) v += shared[k];
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) points_associate_kernel(const AssocArgs a) {
  __shared__ double sum_shared[kWarps];
  __shared__ int32_t cnt_shared[kWarps];
  const int32_t b = blockIdx.y;
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  const float* c = a.c;
  double err = 0.0;
  int32_t cnt = 0;
  if (i < a.n) {
    const int64_t p = static_cast<int64_t>(b) * a.n + i;
    const float* pt = a.points + b * a.map_stride + i * a.row_stride;
    const float px = pt[0], py = pt[1], pz = pt[2];
    const float* R = a.R + 9 * b;
    const float* t = a.t + 3 * b;
    float w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w[k] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(R[3 * k], px), __fmul_rn(R[3 * k + 1], py)), __fmul_rn(R[3 * k + 2], pz)),
          t[k]);
    }
    const int32_t ix = axis_index(w[0], c), iy = axis_index(w[1], c);
    const int32_t top = a.cell_n - 1;
    const bool in = ix > 0 && ix < top && iy > 0 && iy < top;
    // the validity ramp (geometry.point_validity)
    const float dx = __fsub_rn(w[0], t[0]), dy = __fsub_rn(w[1], t[1]), dz = __fsub_rn(w[2], t[2]);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)), __fmul_rn(dy, dy));
    const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(w[0], w[0]), __fmul_rn(w[1], w[1])));
    const float dxy = clamp_nan(__fsub_rn(r, c[kRampB]), 0.0f, INFINITY);
    const bool too_close = d2 < c[kMinDist2];
    const bool above_ramp = dz > __fadd_rn(__fmul_rn(dxy, c[kRampA]), c[kRampC]);
    const bool above_max = dz > c[kMaxHeight];
    const bool pad = a.pad[p];
    const bool val = !(too_close || above_ramp || above_max) && pad;
    const bool m = val && in;
    const int32_t j = a.cell_n * ix + iy;
    // the cell's rows (pointcloud.gather_cell_rows): height and variance for
    // D5, validity and traversability for the inlier test
    const int64_t cells = static_cast<int64_t>(a.cell_n) * a.cell_n;
    const float* cell = a.layers + b * kChannels * cells + j;
    const float mh = cell[0], mv = cell[cells];
    bool inlier = false;
    if (m) {
      inlier = cell[2 * cells] > c[kHalf] && fabsf(__fsub_rn(mh, w[2])) < __fmul_rn(mv, c[kMahal]) &&
               mv < c[kDriftVar] && cell[3 * cells] > c[kTravInlier];
    }
    if (inlier) {
      err = __fsub_rn(w[2], mh);
      cnt = 1;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) a.world[3 * p + k] = w[k];
    a.noise[p] = __fmul_rn(__fmul_rn(c[kNoiseFactor], pz), pz);
    a.flat[p] = j;
    a.valid[p] = val;
    a.inside[p] = in;
    a.mask[p] = m;
    a.counted[(2 * static_cast<int64_t>(b)) * a.n + i] = inlier ? 1.0f : 0.0f;
    a.counted[(2 * static_cast<int64_t>(b) + 1) * a.n + i] = m ? 1.0f : 0.0f;
    a.rows[p] = make_float2(mh, mv);
  }
  err = block_sum(err, sum_shared);
  cnt = block_sum(cnt, cnt_shared);
  if (threadIdx.x == 0) {
    const int64_t slot = static_cast<int64_t>(b) * gridDim.x + blockIdx.x;
    a.part_sum[slot] = err;
    a.part_cnt[slot] = cnt;
  }
}

// one block a map: the map's partial sums in order of their blocks
__global__ void __launch_bounds__(kThreads) error_sum_kernel(const double* part_sum, const int32_t* part_cnt,
                                                              int32_t parts, float* error_sum, int64_t* error_cnt) {
  __shared__ double sum_shared[kWarps];
  __shared__ int32_t cnt_shared[kWarps];
  const int32_t b = blockIdx.x;
  double s = 0.0;
  int32_t n = 0;
  for (int32_t k = threadIdx.x; k < parts; k += kThreads) {
    s += part_sum[static_cast<int64_t>(b) * parts + k];
    n += part_cnt[static_cast<int64_t>(b) * parts + k];
  }
  s = block_sum(s, sum_shared);
  n = block_sum(n, cnt_shared);
  if (threadIdx.x == 0) {
    error_sum[b] = static_cast<float>(s);
    error_cnt[b] = n;
  }
}

__global__ void __launch_bounds__(kThreads) points_fuse_kernel(const FuseArgs a) {
  const int32_t b = blockIdx.y;
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const float* c = a.c;
  const int64_t p = static_cast<int64_t>(b) * a.n + i;
  float new_h = 0.0f, new_v = 0.0f;
  bool fuse = false, outlier = false;
  if (a.mask[p]) {
    const float2 row = a.rows[p];
    const float z = a.world[3 * p + 2];
    const float v = a.noise[p];
    const float mh = __fadd_rn(row.x, a.h_delta[b]);
    const float mv = row.y;
    const float band = __fmul_rn(mv, c[kMahal]);
    outlier = fabsf(__fsub_rn(mh, z)) > band;
    bool edge_skip = false;
    if (a.edge_sharpen) {
      const float pc = a.point_cnt[b * a.pc_stride + a.flat[p]];
      edge_skip = pc > c[kWall] && z < __fsub_rn(mh, __fdiv_rn(band, clamp_nan(pc, c[kMinCount], INFINITY)));
    }
    fuse = !outlier && !edge_skip;
    if (fuse) {
      const float den = __fadd_rn(mv, v);
      new_h = __fdiv_rn(__fadd_rn(__fmul_rn(mh, v), __fmul_rn(z, mv)), den);
      new_v = __fdiv_rn(__fmul_rn(mv, v), den);
    }
  }
  float* s = a.streams + 4 * static_cast<int64_t>(b) * a.n + i;
  s[0] = new_h;
  s[a.n] = new_v;
  s[2 * static_cast<int64_t>(a.n)] = fuse ? 1.0f : 0.0f;
  s[3 * static_cast<int64_t>(a.n)] = outlier ? 1.0f : 0.0f;
  a.active[p] = fuse || outlier;
}

bool dims_ok(int32_t b, int32_t n) { return b >= 0 && b <= 65535 && n >= 0; }

}  // namespace

// points (b, n, 3 + C) float32 with xyz contiguous, map_stride and row_stride
// floats between maps and points; pad (b, n) bool; R (b, 3, 3), t (b, 3) and
// layers (b, 7, cell_n, cell_n) float32; the outputs as AssocArgs says, all
// contiguous; part_sum (float64) and part_cnt (int32) scratch of
// b * ceil(max(n, 1) / 256) elements; error_sum (b,) float32 and error_cnt (b,) int64. consts: n_consts
// float32 values in the order of `Const`. Works on `stream` and does not
// synchronise.
extern "C" int points_associate(const void* points, const void* pad, const void* R, const void* t,
                                const void* layers, void* world, void* noise, void* flat, void* valid, void* inside,
                                void* mask, void* counted, void* rows, void* part_sum, void* part_cnt,
                                void* error_sum, void* error_cnt, int64_t map_stride, int64_t row_stride, int32_t b,
                                int32_t n, int32_t cell_n, const float* consts, int32_t n_consts, void* stream) {
  if (!dims_ok(b, n) || cell_n < 1 || static_cast<int64_t>(cell_n) * cell_n > INT32_MAX || n_consts != kConsts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return static_cast<int>(cudaSuccess);
  AssocArgs a{};
  a.points = static_cast<const float*>(points);
  a.pad = static_cast<const bool*>(pad);
  a.R = static_cast<const float*>(R);
  a.t = static_cast<const float*>(t);
  a.layers = static_cast<const float*>(layers);
  a.world = static_cast<float*>(world);
  a.noise = static_cast<float*>(noise);
  a.flat = static_cast<int32_t*>(flat);
  a.valid = static_cast<bool*>(valid);
  a.inside = static_cast<bool*>(inside);
  a.mask = static_cast<bool*>(mask);
  a.counted = static_cast<float*>(counted);
  a.rows = static_cast<float2*>(rows);
  a.part_sum = static_cast<double*>(part_sum);
  a.part_cnt = static_cast<int32_t*>(part_cnt);
  a.map_stride = map_stride;
  a.row_stride = row_stride;
  a.n = n;
  a.cell_n = cell_n;
  for (int k = 0; k < kConsts; ++k) a.c[k] = consts[k];
  // a map of no points still writes its (zero) sums
  const int32_t parts = n == 0 ? 1 : (n + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  points_associate_kernel<<<dim3(static_cast<unsigned>(parts), static_cast<unsigned>(b)), kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  error_sum_kernel<<<static_cast<unsigned>(b), kThreads, 0, st>>>(a.part_sum, a.part_cnt, parts,
                                                                  static_cast<float*>(error_sum),
                                                                  static_cast<int64_t*>(error_cnt));
  return static_cast<int>(cudaGetLastError());
}

// world (b, n, 3), noise (b, n), rows (b, n, 2) and h_delta (b,) float32, flat
// (b, n) int32, mask (b, n) bool, all contiguous; point_cnt (b, cell_n,
// cell_n) float32 with contiguous cells, maps pc_stride elements apart;
// streams (b, 4, n) float32 and active (b, n) bool, written whole.
extern "C" int points_fuse(const void* world, const void* noise, const void* flat, const void* mask,
                           const void* rows, const void* h_delta, const void* point_cnt, void* streams, void* active,
                           int64_t pc_stride, int32_t b, int32_t n, int32_t edge_sharpen, const float* consts,
                           int32_t n_consts, void* stream) {
  if (!dims_ok(b, n) || n_consts != kConsts) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || n == 0) return static_cast<int>(cudaSuccess);
  FuseArgs a{};
  a.world = static_cast<const float*>(world);
  a.noise = static_cast<const float*>(noise);
  a.flat = static_cast<const int32_t*>(flat);
  a.mask = static_cast<const bool*>(mask);
  a.rows = static_cast<const float2*>(rows);
  a.h_delta = static_cast<const float*>(h_delta);
  a.point_cnt = static_cast<const float*>(point_cnt);
  a.streams = static_cast<float*>(streams);
  a.active = static_cast<bool*>(active);
  a.pc_stride = pc_stride;
  a.n = n;
  a.edge_sharpen = edge_sharpen;
  for (int k = 0; k < kConsts; ++k) a.c[k] = consts[k];
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), static_cast<unsigned>(b));
  points_fuse_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
