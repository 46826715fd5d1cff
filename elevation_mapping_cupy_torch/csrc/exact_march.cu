// K2 exact_march: the exact visibility-cleanup ray march, fused into one
// kernel. One thread per ray walks its k live steps and adds its hits and
// upper-bound candidates into cell space with atomics.
//
// Replaces the in-kernel primitives that scripts/probe_pallas_gather.py
// (try_kernel, :38) tried on Mosaic and could not lower: the per-sample
// cell gathers k_take, k_take2, k_take2d, k_taa and k_taa2 (here one load of
// the packed cell row), the scatter-add k_scat (atomicAdd of the decrement
// and the hit count), the scatter-min k_smin (an atomic min on f32) and the
// sort k_sort (elevation_mapping_cupy_tpu/ops/raycast.py:569-575 and
// :891-897 sort to take a per-cell min; the atomic min gives the same
// order-free min without one). It also replaces the B1 scatters
// (ops/pallas_scatter.py::_kernel) that the TPU march launches once per step
// or chunk (raycast.py:291, 548, 880): nothing leaves the kernel but the
// three per-cell results.
//
// Per ray, the thread first builds what _exact_flat's table holds
// (raycast.py:382-400): direction, decrement and the live-step count k,
// the number of steps s_m = (m+1)*step with s_m < ray_length and
// s_m <= norm - sqrt(0.1) + step (past which the endpoint test rejects
// every sample), found by binary search over the same rounded s_m as
// searchsorted over the JAX package's steps vector. A ray that is not valid
// gets k = 0.
//
// Per-sample rules: those of raycast.py::_exact_scan (:257-309), with the
// previous step's cell recomputed from s_{m-1} as _exact_gated does
// (:863-867) instead of carried, so a culled segment needs no bookkeeping.
// With a gate table, each segment of `seg` steps is tested once against the
// dilated block max of the per-cell write threshold (raycast.py:801-810) and
// skipped when no sample in it can write; live and surviving segments are
// counted with two 64-bit atomics.
//
// Rounding: the JAX reference (XLA on the CPU) contracts the march's
// multiply-adds into FMAs: the ray norm's reduction
// fma(vz, vz, fma(vy, vy, vx * vx)) under a correctly rounded root, the
// sample position t + rdir * s, the squared distance's reduction
// fma(ez, ez, fma(ey, ey, ex * ex)) and the cosine
// fma(dz, nz, fma(dx, nx, dy * ny)). The kernel writes exactly those with
// __fmaf_rn and __fsqrt_rn and every other operation with __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc never contracts; the
// divisions by the resolution and the ray length are true divisions. The
// plain version rounds alike (ops/geometry.py::fma32, sqrt32), so a sample
// lands in the same cell on the card, on the CPU and in the JAX package.
// Every float->int cast clamps first.
//
// Bound: operations, once a march has millions of samples. A live sample
// needs 9 float32 operations for its position and cell and 11 more when it
// is a fresh sample in the map; one that passes the endpoint test reads a
// 32-byte cell row, which stays in L2 (the deployed 202x202 pack is
// 1.3 MB). The bytes that must come from device memory are only the
// points, the pack and the three outputs (a few MB), so 1e7-1e8 samples
// per update put the floor at the float32 rate. The design keeps every
// intermediate in registers: a thread reads its point once, never writes a
// per-sample value, and touches memory per sample only for the cell row
// and, for the few samples that write, the atomics.
// Not yet addressed (later work): load imbalance between short and long
// rays within a warp, and atomic contention on cells that many rays hit.
//
// Built by elevation_mapping_cupy_torch/kernels.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libexact_march.so exact_march.cu
// and called through ctypes: the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Grid {
  int n;          // cells per side
  float res;      // cell size (m)
  float half_n;   // 0.5 * n
  float step;     // ray step (m)
  int n_steps;    // steps of the longest ray
};

// (x / res + n/2), clamped to [0, n-1], truncated: geometry.cell_indices
// with a zero center.
__device__ __forceinline__ int axis_cell(float x, const Grid& g) {
  float f = __fadd_rn(__fdiv_rn(x, g.res), g.half_n);
  f = fminf(fmaxf(f, 0.0f), static_cast<float>(g.n - 1));
  return static_cast<int>(f);
}

// Min of float32 through integer atomics: a value with the sign bit clear
// orders like its bits as a signed int, one with the sign bit set orders
// inversely to its bits as an unsigned int. The buffer starts at +inf.
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (!signbit(v)) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

struct Ray {
  float dx, dy, dz;   // unit direction
  float px, py, pz;   // end point
  float dec_amount;   // cleanup_step / (ray_length / max_ray_length)
};

// Steps m in [0, n_steps) with s_m < x (s_m <= x when `inclusive`): the
// searchsorted of the JAX package over its steps vector, side "left"
// ("right"). s_m grows with m, so the count is found by halving.
__device__ __forceinline__ int steps_below(float x, bool inclusive,
                                           const Grid& g) {
  int lo = 0, hi = g.n_steps;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float s = __fmul_rn(static_cast<float>(mid + 1), g.step);
    if (inclusive ? s <= x : s < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The ray from t to its end point p and its live-step count.
__device__ __forceinline__ int make_ray(float px, float py, float pz,
                                        float tx, float ty, float tz,
                                        const Grid& g, float max_ray_length,
                                        float cleanup_step, Ray* r) {
  const float vx = __fsub_rn(px, tx);
  const float vy = __fsub_rn(py, ty);
  const float vz = __fsub_rn(pz, tz);
  const float norm =
      __fsqrt_rn(__fmaf_rn(vz, vz, __fmaf_rn(vy, vy, __fmul_rn(vx, vx))));
  const float safe = fmaxf(norm, 1e-30f);
  const bool pos = norm > 0.0f;
  r->dx = pos ? __fdiv_rn(vx, safe) : 0.0f;
  r->dy = pos ? __fdiv_rn(vy, safe) : 0.0f;
  r->dz = pos ? __fdiv_rn(vz, safe) : 0.0f;
  r->px = px;
  r->py = py;
  r->pz = pz;
  const float ray_length = fminf(norm, max_ray_length);
  r->dec_amount = __fdiv_rn(cleanup_step, __fdiv_rn(ray_length, max_ray_length));
  const float end = __fadd_rn(__fsub_rn(norm, __fsqrt_rn(0.1f)), g.step);
  return min(steps_below(ray_length, false, g), steps_below(end, true, g));
}

__device__ __forceinline__ void march_sample(int m, const Ray& r, float tx,
                                             float ty, float tz,
                                             const float4* __restrict__ pack,
                                             const Grid& g, float cos_thresh,
                                             float* __restrict__ dec,
                                             float* __restrict__ hits,
                                             float* __restrict__ ubmin) {
  const float s = __fmul_rn(static_cast<float>(m + 1), g.step);
  const float sx = __fmaf_rn(r.dx, s, tx);
  const float sy = __fmaf_rn(r.dy, s, ty);
  const float nz = __fmaf_rn(r.dz, s, tz);
  const int ix = axis_cell(sx, g);
  const int iy = axis_cell(sy, g);
  if (ix <= 0 || ix >= g.n - 1 || iy <= 0 || iy >= g.n - 1) return;
  const int cell = g.n * ix + iy;
  if (m > 0) {  // same cell as the previous step: not a fresh sample
    const float sp = __fmul_rn(static_cast<float>(m), g.step);
    const int px = axis_cell(__fmaf_rn(r.dx, sp, tx), g);
    const int py = axis_cell(__fmaf_rn(r.dy, sp, ty), g);
    if (g.n * px + py == cell) return;
  }
  const float ex = __fsub_rn(r.px, sx);
  const float ey = __fsub_rn(r.py, sy);
  const float ez = __fsub_rn(r.pz, nz);
  const float d = __fmaf_rn(ez, ez, __fmaf_rn(ey, ey, __fmul_rn(ex, ex)));
  if (!(d >= 0.1f)) return;

  // the cell row: height, penetration slack, upper-bound threshold, code;
  // normal x, y, z, padding
  const float4 a = __ldg(pack + 2 * cell);
  const bool ub_cond = nz < a.z;
  bool write_ub = false;
  if (a.w == 1.0f) {  // invalid cell: upper-bound candidate only
    write_ub = ub_cond;
  } else if (a.w == 2.0f) {  // cell eligible to be cleaned up
    const bool penet = a.x > __fsub_rn(__fadd_rn(nz, 0.01f), a.y);
    if (penet) {
      const float4 b = __ldg(pack + 2 * cell + 1);
      const float prod =
          __fmaf_rn(r.dz, b.z, __fmaf_rn(r.dx, b.x, __fmul_rn(r.dy, b.y)));
      if (fabsf(prod) >= cos_thresh) {
        atomicAdd(dec + cell, r.dec_amount);
        atomicAdd(hits + cell, 1.0f);
        write_ub = ub_cond;
      }
    }
  }
  if (write_ub) atomic_min_f32(ubmin + cell, nz);
}

__global__ void __launch_bounds__(kThreads)
exact_march_kernel(const float4* __restrict__ pack,
                   const float* __restrict__ points,
                   const bool* __restrict__ valid,
                   const float* __restrict__ t,
                   const float* __restrict__ gate,
                   float* __restrict__ dec, float* __restrict__ hits,
                   float* __restrict__ ubmin,
                   unsigned long long* __restrict__ counts, int64_t n_rays,
                   Grid g, float max_ray_length, float cleanup_step,
                   float cos_thresh, int seg, int block, int nb,
                   float gate_eps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long survived = 0, segments = 0;
  if (i < n_rays && valid[i]) {
    const float tx = __ldg(t), ty = __ldg(t + 1), tz = __ldg(t + 2);
    Ray r;
    const int kr = make_ray(points[3 * i], points[3 * i + 1],
                            points[3 * i + 2], tx, ty, tz, g, max_ray_length,
                            cleanup_step, &r);
    if (gate == nullptr) {
      for (int m = 0; m < kr; ++m) {
        march_sample(m, r, tx, ty, tz, pack, g, cos_thresh, dec, hits, ubmin);
      }
    } else {
      for (int m0 = 0; m0 < kr; m0 += seg) {
        const int m1 = min(m0 + seg, kr);  // exclusive
        ++segments;
        // nz is linear in s, so the segment's lowest sample is an end
        const float s_lo = __fmul_rn(static_cast<float>(m0 + 1), g.step);
        const float s_hi = __fmul_rn(static_cast<float>(m1), g.step);
        const float x0 = __fmaf_rn(r.dx, s_lo, tx);
        const float y0 = __fmaf_rn(r.dy, s_lo, ty);
        const float nz_min = fminf(__fmaf_rn(r.dz, s_lo, tz),
                                   __fmaf_rn(r.dz, s_hi, tz));
        const int bx = axis_cell(x0, g) / block;
        const int by = axis_cell(y0, g) / block;
        if (!(nz_min < __fadd_rn(__ldg(gate + bx * nb + by), gate_eps))) continue;
        ++survived;
        for (int m = m0; m < m1; ++m) {
          march_sample(m, r, tx, ty, tz, pack, g, cos_thresh, dec, hits, ubmin);
        }
      }
    }
  }
  if (counts == nullptr) return;
  // every thread of the warp reaches here: sum the warp's counts first
  for (int off = 16; off > 0; off >>= 1) {
    survived += __shfl_down_sync(0xffffffffu, survived, off);
    segments += __shfl_down_sync(0xffffffffu, segments, off);
  }
  if ((threadIdx.x & 31) == 0 && segments > 0) {
    atomicAdd(counts, survived);
    atomicAdd(counts + 1, segments);
  }
}

}  // namespace

// pack (n*n, 8) float32 cell rows; points (n_rays, 3) float32 ray end
// points and valid (n_rays,) bool, both in the map-center frame; t (3,)
// float32 sensor position; gate (nb*nb,) float32 or null; dec, hits, ubmin
// (n*n,) float32, zeroed (ubmin: +inf) by the caller; counts (2,) int64
// zeroed by the caller, or null without a gate. Launches on `stream` and
// does not synchronise.
extern "C" int exact_march(const void* pack, const void* points,
                           const void* valid, const void* t, const void* gate,
                           void* dec, void* hits, void* ubmin, void* counts,
                           int64_t n_rays, int32_t n, float res, float step,
                           int32_t n_steps, float max_ray_length,
                           float cleanup_step, float cos_thresh, int32_t seg,
                           int32_t block, int32_t nb, float gate_eps,
                           void* stream) {
  if (n_rays == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || n <= 2 || n_steps < 0 ||
      (gate != nullptr && (seg <= 0 || block <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid g{n, res, 0.5f * static_cast<float>(n), step, n_steps};
  exact_march_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pack), static_cast<const float*>(points),
      static_cast<const bool*>(valid), static_cast<const float*>(t),
      static_cast<const float*>(gate), static_cast<float*>(dec),
      static_cast<float*>(hits), static_cast<float*>(ubmin),
      static_cast<unsigned long long*>(counts), n_rays, g, max_ray_length,
      cleanup_step, cos_thresh, seg, block, nb, gate_eps);
  return static_cast<int>(cudaGetLastError());
}
