// polar_evaluate: the per-cell half of the polar visibility cleanup, for B
// maps in one call.
//
// Replaces no TPU kernel: the JAX package's evaluation
// (elevation_mapping_cupy_tpu/ops/raycast.py::visibility_cleanup_polar) is
// XLA ops, which XLA fuses. Eager PyTorch cannot fuse them: the port's plain
// version (ops/raycast.py::_polar_evaluate) writes ~20 (maps x cells x S)
// tensors to device memory and reads each back, 20.9 MB a tensor and a
// default map at S = 128, and issues ~180 launches a chunk of maps. This
// kernel is that function in one launch, with every (cells x S) value in
// registers.
//
// What it computes, per cell of a (B, 7, h, w) stack of layers (the block
// (r0, c0, h, w) of an n x n map, each cell at its global centre): the
// cell's radius r_c and azimuth a_c from the sensor, its azimuth bin ai, its
// radius bin ri and a half-window hw of azimuth bins; from the prefix cube
// the window's ray counts and 1/length sums per elevation bucket (rows hi,
// lo - 1 and the total row of radius ri; 2S floats a row: counts, then
// sums), a penetration test, a normal test and a sampling acceptance per
// bucket, and from those the decrement of validity (channel 2), the added
// variance (channel 1) and the lowest ray height that writes an upper bound
// (channels 5 and 6). With a min-slope pyramid the heights take the
// window's minimum slope (two rows of the pyramid) instead of the bucket's.
// Channels 0, 3 and 4 are copied. ops/raycast.py::_polar_evaluate states
// the same function in PyTorch, operation by operation.
//
// Rounding. The result must be the plain version's on the card: channels 5
// and 6 bit for bit, 1 and 2 up to the order of the sums over S. So every
// operation rounds as the PyTorch op it stands for: multiplies, adds and
// divisions are __fmul_rn, __fadd_rn, __fsub_rn and __fdiv_rn (nvcc would
// otherwise contract them into FMAs), r_c / step is a true division, a
// scalar divided by a tensor is PyTorch's reciprocal-then-multiply, round is
// half to even (rintf), a cast truncates, clamps and minima let a NaN
// through as PyTorch's do, and sqrtf, atan2f, sinf and cosf are the CUDA
// math library's, which PyTorch's kernels call. Every Python scalar arrives
// as the float32 PyTorch casts it to (`consts`), and the per-bucket values
// (tan, cos and sin of the bucket's angle, the xy sample spacing and the
// saturated acceptance width) as the (5, S) table PyTorch computes.
//
// Bound: bytes. Each map's prefix cube is read at most once, (A R 2S) floats
// (37.7 MB at A 512, R 72, S 128), plus the cell's 7 layers, 3 normals and
// inlier count read and its 7 layers written (72 bytes a cell): 0.012 ms a
// default map at 3.35 TB/s. The kernel reads less than that: only the rows
// the cells in range query, so on an H100 it takes 0.0053 ms a default map
// at B = 64 and 0.022 ms for one deployed map (R 355).
//
// Design. A warp owns 32 consecutive cells of one map. Each lane first works
// out its own cell: the geometry, the gates, and whether the cell can change
// at all (in range of the rays, not on the border, and either invalid or
// open to a hit); it writes what the warp needs into shared memory. Then the
// warp takes the cells that can change one at a time: each lane holds S/32
// buckets, reads its part of the cell's three cube rows (and two pyramid
// rows) as coalesced float4 loads, and keeps everything per bucket in
// registers; shuffles reduce the two sums and the minimum. Last, each lane
// writes its own cell's seven channels, so the stores are coalesced too. A
// cell that cannot change reads no row: about 80 % of a default map's cells
// lie beyond its 2 m rays. The cells of one map run together, so the rows
// neighbouring cells share come from L2.
//
// Built by elevation_mapping_cupy_torch/kernels.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpolar_evaluate.so polar_evaluate.cu
// and called through ctypes: the C entry point returns the first CUDA error.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;  // a block is kWarps warps, kWarps * 32 cells
constexpr int kThreads = kLanes * kWarps;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kChannels = 7;

// the float32 values of the plain version's Python scalars, in the order of
// ops/raycast.py::_kernel_constants
enum Const : int {
  kHalfN,         // 0.5 * n
  kRes,           // resolution
  kPi,            // math.pi
  kAzScale,       // A / (2 pi)
  kStep,          // the ray step
  kMaxRay,        // max_ray_length
  kMinR,          // step * 0.5
  kTiny,          // 1e-6
  kTinier,        // 1e-9
  kRes2,          // resolution ** 2
  kHeightMargin,  // 0.01
  kVarScale,      // 0.05
  kCosThresh,     // cleanup_cos_thresh
  kWallThresh,    // wall_num_thresh
  kDecScale,      // cleanup_step * max_ray_length
  kOutlierVar,    // outlier_variance
  kConsts
};

// rows of the (5, S) per-bucket table
enum Bucket : int { kTan, kCos, kSin, kDelta, kWSat };

struct Args {
  const float* layers;   // (B, 7, h, w) contiguous
  const float* normal;   // (B, 3, h, w) contiguous
  const float* inlier;   // (B, h, w), cells contiguous, inlier_stride apart
  const float* t;        // (B, 3) contiguous
  const float* pref;     // (B, A R, 2S) contiguous
  const float* total;    // (B, R, 2S), rows contiguous, total_stride apart
  const float* pyramid;  // (B, (levels + 1) A R, S) contiguous, or null
  const float* table;    // (5, S) contiguous
  float* out;            // (B, 7, h, w) contiguous
  int64_t inlier_stride;
  int64_t total_stride;
  int32_t h, w, r0, c0, n, A, R, S, levels;
  float c[kConsts];
};

enum Flag : uint32_t {
  kGate = 1,      // the cell can be hit
  kCandA = 2,     // an invalid cell in range: any ray can lower its bound
  kIubSmall = 4,  // it has no upper bound yet
  kWrapped = 8,   // its azimuth window wraps past bin A - 1
  kZeroLo = 16,   // its window starts at bin 0: no lower prefix row
};

// what a cell's lane works out once, for the warp to read
struct Cell {
  int32_t hi_row, lo_row, ri, m1_row, m2_row;
  float x_eval;   // max(r_c, 1e-6) - mean chord / 2
  float s_star;   // penetration threshold height over the sensor
  float g, nz;    // the normal along the cell's azimuth, and up
  float band, band_c, cs, sat_thr, ub;
  uint32_t flags;
};

// torch.clamp's halves and torch.minimum / maximum: a NaN goes through
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_hi(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }

// raycast._bin: clamp to [0, hi], then truncate or round half to even
__device__ __forceinline__ int32_t bin_trunc(float x, int32_t hi) {
  return static_cast<int32_t>(clamp_hi(clamp_lo(x, 0.0f), static_cast<float>(hi)));
}
__device__ __forceinline__ int32_t bin_round(float x, int32_t hi) {
  return static_cast<int32_t>(rintf(clamp_hi(clamp_lo(x, 0.0f), static_cast<float>(hi))));
}

// Python's x % m for m > 0
__device__ __forceinline__ int32_t pymod(int32_t x, int32_t m) {
  const int32_t r = x % m;
  return r < 0 ? r + m : r;
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

// One lane's cell: its geometry and gates. Returns whether the cell can
// change; only then is `c` filled.
__device__ __forceinline__ bool setup_cell(const Args& a, int64_t b, int32_t i, const float (&ch)[kChannels],
                                           float tx, float ty, float tz, Cell& c) {
  const int32_t n_cells = a.h * a.w;
  const int32_t row = a.r0 + i / a.w;
  const int32_t col = a.c0 + i % a.w;
  const float cx = __fsub_rn(__fmul_rn(__fsub_rn(__fadd_rn(static_cast<float>(row), 0.5f), a.c[kHalfN]),
                                       a.c[kRes]), tx);
  const float cy = __fsub_rn(__fmul_rn(__fsub_rn(__fadd_rn(static_cast<float>(col), 0.5f), a.c[kHalfN]),
                                       a.c[kRes]), ty);
  const float r_c = __fsqrt_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)));
  const bool in_range = (r_c <= a.c[kMaxRay]) && (r_c >= a.c[kMinR]);
  const bool inside = row > 0 && row < a.n - 1 && col > 0 && col < a.n - 1;
  const bool is_invalid = ch[2] < 0.5f;
  const float ic = a.inlier[b * a.inlier_stride + i];
  const bool wall_skip = (ic > a.c[kWallThresh]) && (ch[4] < 1.0f);
  const bool gate = in_range && inside && !is_invalid && (ch[4] >= 0.5f) && !wall_skip;
  const bool cand_a = in_range && inside && is_invalid;
  if (!(gate || cand_a)) return false;

  const float a_c = atan2f(cy, cx);
  const int32_t ai = bin_trunc(__fmul_rn(__fadd_rn(a_c, a.c[kPi]), a.c[kAzScale]), a.A - 1);
  const int32_t ri = bin_round(__fdiv_rn(r_c, a.c[kStep]), a.R - 1);
  const float cos_a = cosf(a_c);
  const float sin_a = sinf(a_c);
  const float abs_c = fabsf(cos_a);
  const float abs_s = fabsf(sin_a);
  const float band = __fmul_rn(a.c[kRes], __fadd_rn(abs_c, abs_s));
  const float safe_r = clamp_lo(r_c, a.c[kTiny]);
  const float half_ang = atan2f(__fmul_rn(0.5f, band), safe_r);
  const int32_t hw = bin_trunc(__fmul_rn(half_ang, a.c[kAzScale]), a.A / 2 - 1);
  const int32_t lo = ai - hw;
  const int32_t hi = ai + hw;
  const int32_t lo_m = pymod(lo, a.A);
  const int32_t hi_m = pymod(hi, a.A);
  c.hi_row = hi_m * a.R + ri;
  c.lo_row = pymod(lo - 1, a.A) * a.R + ri;
  c.ri = ri;
  if (a.pyramid != nullptr) {
    // the window's level ceil(log2(width)), capped; two windows of 2^level
    // bins from either end cover it
    const int32_t width = 2 * hw + 1;
    const int32_t lvl = min(width <= 1 ? 0 : 32 - __clz(width - 1), a.levels);
    c.m1_row = (lvl * a.A + lo_m) * a.R + ri;
    c.m2_row = (lvl * a.A + pymod(lo + width - (1 << lvl), a.A)) * a.R + ri;
  }
  const float band_c = clamp_lo(band, a.c[kTinier]);
  const float mean_chord = __fmul_rn(__frcp_rn(band_c), a.c[kRes2]);
  c.x_eval = __fsub_rn(safe_r, __fmul_rn(0.5f, mean_chord));
  c.s_star = __fsub_rn(
      __fadd_rn(__fsub_rn(ch[0], a.c[kHeightMargin]), __fmul_rn(clamp_hi(ch[1], 1.0f), a.c[kVarScale])), tz);
  const float* nrm = a.normal + b * 3 * n_cells + i;
  c.g = __fadd_rn(__fmul_rn(cos_a, nrm[0]), __fmul_rn(sin_a, nrm[n_cells]));
  c.nz = nrm[2 * n_cells];
  c.band = band;
  c.band_c = band_c;
  c.cs = __fmul_rn(abs_c, abs_s);
  c.sat_thr = __fmul_rn(__frcp_rn(clamp_lo(max_nan(abs_c, abs_s), a.c[kTinier])), a.c[kRes]);
  c.ub = ch[5];
  c.flags = (gate ? kGate : 0u) | (cand_a ? kCandA : 0u) | (ch[6] < 0.5f ? kIubSmall : 0u) |
            (lo_m > hi_m ? kWrapped : 0u) | (lo_m == 0 ? kZeroLo : 0u);
  return true;
}

// The whole warp on one cell: per bucket the window's counts and sums, the
// tests, and the cell's decrement and variance sums and lowest bound.
template <int VEC>
__device__ __forceinline__ void evaluate(const Args& a, int64_t b, const Cell& c, float tz, int lane,
                                         float& dec, float& var, float& ubmin) {
  const int32_t S = a.S;
  const int64_t row_len = 2 * static_cast<int64_t>(S);
  const float* pref = a.pref + b * a.A * a.R * row_len;
  const float* hi_p = pref + c.hi_row * row_len;
  const float* lo_p = pref + c.lo_row * row_len;
  const float* tot_p = a.total + b * a.total_stride + c.ri * row_len;
  const bool pyr = a.pyramid != nullptr;
  const float* m1_p = nullptr;
  const float* m2_p = nullptr;
  if (pyr) {
    const float* p = a.pyramid + b * (a.levels + 1) * a.A * a.R * static_cast<int64_t>(S);
    m1_p = p + c.m1_row * static_cast<int64_t>(S);
    m2_p = p + c.m2_row * static_cast<int64_t>(S);
  }
  const bool gate = c.flags & kGate;
  const bool cand_a = c.flags & kCandA;
  const bool iub_small = c.flags & kIubSmall;
  const bool wrapped = c.flags & kWrapped;
  const bool zero_lo = c.flags & kZeroLo;
  dec = 0.0f;
  var = 0.0f;
  ubmin = INFINITY;
  for (int32_t k0 = lane * VEC; k0 < S; k0 += kLanes * VEC) {
    float hc[VEC], hv[VEC], lc[VEC], lv[VEC], tc[VEC], tv[VEC];
    float tan_k[VEC], cos_k[VEC], sin_k[VEC], delta[VEC], wsat[VEC], m1[VEC], m2[VEC];
    load<VEC>(hi_p + k0, hc);
    load<VEC>(hi_p + S + k0, hv);
    load<VEC>(tot_p + k0, tc);
    load<VEC>(tot_p + S + k0, tv);
    if (zero_lo) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) lc[v] = lv[v] = 0.0f;
    } else {
      load<VEC>(lo_p + k0, lc);
      load<VEC>(lo_p + S + k0, lv);
    }
    load<VEC>(a.table + kTan * S + k0, tan_k);
    load<VEC>(a.table + kCos * S + k0, cos_k);
    load<VEC>(a.table + kSin * S + k0, sin_k);
    load<VEC>(a.table + kDelta * S + k0, delta);
    load<VEC>(a.table + kWSat * S + k0, wsat);
    if (pyr) {
      load<VEC>(m1_p + k0, m1);
      load<VEC>(m2_p + k0, m2);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float cnt = wrapped ? __fsub_rn(tc[v], __fsub_rn(lc[v], hc[v])) : __fsub_rn(hc[v], lc[v]);
      const float inv = wrapped ? __fsub_rn(tv[v], __fsub_rn(lv[v], hv[v])) : __fsub_rn(hv[v], lv[v]);
      const float r_eval = clamp_lo(__fadd_rn(c.x_eval, __fmul_rn(0.5f, delta[v])), a.c[kTiny]);
      const bool pen = __fmul_rn(tan_k[v], r_eval) < c.s_star;
      const bool cos_ok =
          fabsf(__fadd_rn(__fmul_rn(c.g, cos_k[v]), __fmul_rn(c.nz, sin_k[v]))) >= a.c[kCosThresh];
      const float w_eff = delta[v] >= c.sat_thr ? wsat[v] : __fsub_rn(c.band, __fmul_rn(delta[v], c.cs));
      const float accept = clamp_hi(clamp_lo(__fdiv_rn(w_eff, c.band_c), 0.0f), 1.0f);
      const bool has_rays = cnt > 0.5f;
      const bool hit = has_rays && pen && cos_ok && gate;
      if (hit) {
        dec = __fadd_rn(dec, __fmul_rn(inv, accept));
        var = __fadd_rn(var, __fmul_rn(cnt, accept));
      }
      const float slope = pyr ? min_nan(m1[v], m2[v]) : tan_k[v];
      const float nz_k = __fadd_rn(tz, __fmul_rn(r_eval, slope));
      const bool ub_cond = iub_small || nz_k < c.ub;
      if (ub_cond && (hit || (cand_a && has_rays))) ubmin = min_nan(ubmin, nz_k);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    dec = __fadd_rn(dec, __shfl_xor_sync(kAll, dec, off));
    var = __fadd_rn(var, __shfl_xor_sync(kAll, var, off));
    ubmin = min_nan(ubmin, __shfl_xor_sync(kAll, ubmin, off));
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) polar_evaluate_kernel(const Args a) {
  __shared__ Cell cells[kWarps][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int64_t b = blockIdx.y;
  const int32_t n_cells = a.h * a.w;
  const int32_t i = (static_cast<int32_t>(blockIdx.x) * kWarps + warp) * kLanes + lane;
  const bool mine = i < n_cells;
  const float tx = a.t[b * 3];
  const float ty = a.t[b * 3 + 1];
  const float tz = a.t[b * 3 + 2];
  const float* lay = a.layers + b * kChannels * n_cells;
  float ch[kChannels];
  bool changes = false;
  if (mine) {
#pragma unroll
    for (int k = 0; k < kChannels; ++k) ch[k] = lay[k * n_cells + i];
    changes = setup_cell(a, b, i, ch, tx, ty, tz, cells[warp][lane]);
  }
  __syncwarp();
  uint32_t todo = __ballot_sync(kAll, changes);
  float dec = 0.0f;
  float var = 0.0f;
  float ubmin = INFINITY;
  while (todo != 0) {
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    float d, v, u;
    evaluate<VEC>(a, b, cells[warp][j], tz, lane, d, v, u);
    if (lane == j) {
      dec = d;
      var = v;
      ubmin = u;
    }
  }
  if (!mine) return;
  ch[1] = __fadd_rn(ch[1], __fmul_rn(a.c[kOutlierVar], var));
  ch[2] = __fsub_rn(ch[2], __fmul_rn(a.c[kDecScale], dec));
  if (isfinite(ubmin)) {
    ch[5] = ubmin;
    ch[6] = 1.0f;
  }
  float* out = a.out + b * kChannels * n_cells;
#pragma unroll
  for (int k = 0; k < kChannels; ++k) out[k * n_cells + i] = ch[k];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// layers (B, 7, h, w), normal (B, 3, h, w), t (B, 3), pref (B, A R, 2S),
// table (5, S) and out (B, 7, h, w): float32, contiguous; inlier (B, h, w)
// with contiguous cells, maps inlier_stride elements apart; total (B, R, 2S)
// with contiguous rows, maps total_stride apart; pyramid (B, (levels + 1)
// A R, S) contiguous, or null (levels is then ignored). The layers are the
// block (r0, c0, h, w) of an n x n map. consts: n_consts float32 values in
// the order of `Const`. Works on `stream` and does not synchronise.
extern "C" int polar_evaluate(const void* layers, const void* normal, const void* inlier, const void* t,
                              const void* pref, const void* total, const void* pyramid, const void* table,
                              void* out, int64_t inlier_stride, int64_t total_stride, int32_t b, int32_t h,
                              int32_t w, int32_t r0, int32_t c0, int32_t n, int32_t A, int32_t R, int32_t S,
                              int32_t levels, const float* consts, int32_t n_consts, void* stream) {
  if (b == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  if (b < 0 || b > 65535 || h < 0 || w < 0 || r0 < 0 || c0 < 0 || r0 + h > n || c0 + w > n ||
      static_cast<int64_t>(n) * n > INT32_MAX || A < 1 || R < 1 || S < 1 ||
      static_cast<int64_t>(A) * R * (pyramid != nullptr ? levels + 1 : 1) > INT32_MAX / 2 ||
      (pyramid != nullptr && (levels < 0 || levels > 30)) || n_consts != kConsts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.layers = static_cast<const float*>(layers);
  a.normal = static_cast<const float*>(normal);
  a.inlier = static_cast<const float*>(inlier);
  a.t = static_cast<const float*>(t);
  a.pref = static_cast<const float*>(pref);
  a.total = static_cast<const float*>(total);
  a.pyramid = static_cast<const float*>(pyramid);
  a.table = static_cast<const float*>(table);
  a.out = static_cast<float*>(out);
  a.inlier_stride = inlier_stride;
  a.total_stride = total_stride;
  a.h = h;
  a.w = w;
  a.r0 = r0;
  a.c0 = c0;
  a.n = n;
  a.A = A;
  a.R = R;
  a.S = S;
  a.levels = levels;
  for (int k = 0; k < kConsts; ++k) a.c[k] = consts[k];
  // float4 loads where every row starts on 16 bytes
  const bool vec4 = S % 4 == 0 && total_stride % 4 == 0 && aligned16(pref) && aligned16(total) &&
                    aligned16(table) && (pyramid == nullptr || aligned16(pyramid));
  const int32_t cells = h * w;
  const dim3 grid(static_cast<unsigned>((cells + kThreads - 1) / kThreads), static_cast<unsigned>(b));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4) {
    polar_evaluate_kernel<4><<<grid, kThreads, 0, st>>>(a);
  } else {
    polar_evaluate_kernel<1><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
