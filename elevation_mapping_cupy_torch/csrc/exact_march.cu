// K2 exact_march: the exact visibility-cleanup ray march, fused into one
// kernel. A group of G lanes of a warp marches one ray, lane l taking steps
// l, l + G, l + 2G, ..., and adds the ray's hits and upper-bound candidates
// into cell space with atomics.
//
// Replaces the in-kernel primitives that scripts/probe_pallas_gather.py
// (try_kernel, :38) tried on Mosaic and could not lower: the per-sample
// cell gathers k_take, k_take2, k_take2d, k_taa and k_taa2 (here one load of
// the packed cell row), the scatter-add k_scat (one atomicAdd of the
// decrement and the hit count together), the scatter-min k_smin (an atomic
// min on f32) and the sort k_sort (elevation_mapping_cupy_tpu/ops/raycast.py
// :569-575 and :891-897 sort to take a per-cell min; the atomic min gives
// the same order-free min without one). It also replaces the B1 scatters
// (ops/pallas_scatter.py::_kernel) that the TPU march launches once per step
// or chunk (raycast.py:291, 548, 880): nothing leaves the kernel but the
// three per-cell results.
//
// Per ray, one lane first builds what _exact_flat's table holds
// (raycast.py:382-400): direction, decrement and the live-step count k,
// the number of steps s_m = (m+1)*step with s_m < ray_length and
// s_m <= norm - sqrt(0.1) + step (past which the endpoint test rejects
// every sample). k is the searchsorted of the JAX package over its steps
// vector: a first guess x / step, moved by single steps until it satisfies
// the same compares against the same rounded s_m (s_m grows with m, so the
// count is unique). A ray that is not valid gets k = 0.
//
// Per-sample rules: those of raycast.py::_exact_scan (:257-309). Every
// sample is computed from its own m, so its cell does not depend on which
// lane computes it. "Fresh" compares a sample's cell with the previous
// step's: that comes from the neighbouring lane by shuffle, from the last
// lane of the group's previous pass for lane 0, and for the first sample of
// a gated segment from the lane that tested the segment.
// With a gate table, each segment of `seg` steps is tested once against the
// dilated block max of the per-cell write threshold (raycast.py:801-810) and
// skipped when no sample in it can write: the group tests one segment per
// lane, ballots the survivors and marches their samples packed densely over
// its lanes. Live and surviving segments are counted exactly.
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
// per update put the floor at the float32 rate. What the design does about
// it:
//   - every intermediate stays in registers; a lane touches memory per
//     sample only for the cell row and, for the few samples that write, the
//     atomics;
//   - a warp's time follows the length of its rays over G, not the longest
//     of 32 rays: rays of 10 to 250 live steps share a cloud;
//   - groups take chunks of G rays in a grid-stride loop from a grid sized
//     to the card's resident blocks, each lane building one ray of the
//     chunk, so ray set-up is not repeated per lane and point loads
//     coalesce; with G < 32 the groups of a warp keep in step (every loop
//     runs as often as the longest of them needs), because a divergent warp
//     shuffles one group at a time;
//   - the previous step's cell is shuffled, not recomputed: two true
//     divisions and two FMAs a sample instead of four and four;
//   - the decrement and the hit count share one (n*n, 2) buffer and one
//     float2 atomic; the upper bound's atomic min is skipped when the stored
//     value is already as low (the min only falls, so a stale read can cost
//     a redundant atomic, never lose a write).
// The entry point initialises the outputs itself (one small kernel on the
// stream) before the march.
//
// A batch of maps. One launch marches the rays of B maps, each on its own
// pack and gate table from its own sensor position into its own outputs:
// map b's are b times a map's size from map 0's (64-bit offsets across
// maps, 32-bit cell indices inside one). The grid's second axis is the map,
// so a block marches one map's rays and the map's offsets are the same in
// every thread of it. The card issues blocks in the order of their index,
// so the maps in flight at a time are a few and their packs stay in L2. At
// B = 1 the launch is the single map's.
//
// Block bounds. The pack and the outputs may cover a block of the map, rows
// [r0, r0 + bh) and columns [c0, c0 + bw) of the n x n cells (one process's
// cells of a spatially sharded map). Every sample is computed as on the
// whole map, in the same global cell, and the "fresh" test compares global
// cells; a sample writes only when its cell lies in the block, at the
// block's own index. The gate table may cover a window of the map's gate
// blocks too: a segment whose first sample's gate block lies outside the
// window holds no writer of this block and is skipped, as the host builds
// the window to cover every gate block within one of the block's. With the
// whole map as block and window the launch is the unblocked one.
//
// The cleanup around the march. Given the map's layers (a snapshot), the
// entry point also builds the march's inputs and applies its outputs, so a
// cleanup of B whole maps is one call: one kernel writes the pack (the
// R1 snapshot's cell rows, ops/raycast.py::exact_precompute) and, with a
// gate, each gate block's max write threshold (a thread block per gate
// block); a second dilates those maxima over the 3x3 gate blocks into the
// gate table (ops/raycast.py::exact_gate); after the march a third writes
// the new layers (validity less the decrement, variance plus the hits'
// outlier variance, the upper bound where one was written) and each map's
// segment survivor fraction. Selections, compares and one rounding per
// float operation, each the plain version's own: the results are the
// composed path's bit for bit, but for the decrement's atomic sums.
//
// Built by elevation_mapping_cupy_torch/kernels.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libexact_march.so exact_march.cu
// and called through ctypes: the C entry point returns the first CUDA error.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Grid {
  int n;          // cells per side of the map
  float res;      // cell size (m)
  float half_n;   // 0.5 * n
  float step;     // ray step (m)
  int n_steps;    // steps of the longest ray
  int r0, c0;     // the block's first row and column
  int bh, bw;     // the block's rows and columns
};

struct GateArgs {
  const float* table;  // (rows*cols,) block thresholds, or null: no gate
  int seg;             // steps per segment
  int seg_shift;       // log2(seg) when seg is a power of two, else -1
  int block;           // cells per block side
  int block_shift;     // log2(block) when block is a power of two, else -1
  int r0, c0;          // the table's first gate block row and column
  int rows, cols;      // the table's gate block rows and columns
  float eps;
};

struct Outputs {
  float2* dechits;              // (bh*bw, 2): summed decrement, hit count
  float* ubmin;                 // (bh*bw,): lowest upper-bound candidate
  const float* reach;           // (bh*bw,): see init_outputs_kernel
  unsigned long long* counts;   // (2,): surviving, live segments; or null
};

__device__ __forceinline__ int div_pow2(int x, int d, int shift) {
  return shift >= 0 ? (x >> shift) : (x / d);
}

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

// Steps m in [0, n_steps) with s_m < x (s_m <= x when `inclusive`), where
// s_m = fl((m + 1) * step): the searchsorted of the JAX package over its
// steps vector, side "left" ("right"). s_m grows with m, so the count c is
// the one value with s_{c-1} below x and s_c not; the quotient x / step
// lands within a step of it. ops/cuda_march.py::steps_below mirrors this.
__device__ __forceinline__ int steps_below(float x, bool inclusive,
                                           const Grid& g) {
  const float q = fminf(fmaxf(__fdividef(x, g.step), 0.0f),
                        static_cast<float>(g.n_steps));  // NaN -> 0
  int c = static_cast<int>(q);
  while (c < g.n_steps) {
    const float s = __fmul_rn(static_cast<float>(c + 1), g.step);
    if (!(inclusive ? s <= x : s < x)) break;
    ++c;
  }
  while (c > 0) {
    const float s = __fmul_rn(static_cast<float>(c), g.step);
    if (inclusive ? s <= x : s < x) break;
    --c;
  }
  return c;
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

// x and y of sample m, its cell, clamped to the map, and the cell's index
// in the block (-1 outside it)
struct Sample {
  float s, sx, sy;
  int ix, iy, cell, local;
};

__device__ __forceinline__ Sample sample_cell(int m, const Ray& r, float tx,
                                              float ty, const Grid& g) {
  Sample q;
  q.s = __fmul_rn(static_cast<float>(m + 1), g.step);
  q.sx = __fmaf_rn(r.dx, q.s, tx);
  q.sy = __fmaf_rn(r.dy, q.s, ty);
  q.ix = axis_cell(q.sx, g);
  q.iy = axis_cell(q.sy, g);
  q.cell = g.n * q.ix + q.iy;
  const int lr = q.ix - g.r0, lc = q.iy - g.c0;
  q.local = (lr >= 0 && lr < g.bh && lc >= 0 && lc < g.bw) ? lr * g.bw + lc : -1;
  return q;
}

// The rules of a sample that lies inside the map and the block in a cell
// the previous step was not in.
__device__ __forceinline__ void fresh_sample(const Sample& q, const Ray& r,
                                             float tz,
                                             const float4* __restrict__ pack,
                                             float cos_thresh,
                                             const Outputs& out) {
  const float nz = __fmaf_rn(r.dz, q.s, tz);
  // no sample at or above the cell's reach writes: most samples end here,
  // on 4 bytes that stay in L1, and never load the 32-byte row
  if (!(nz < __ldg(out.reach + q.local))) return;
  // the cell row (height, penetration slack, upper-bound threshold, code;
  // normal x, y, z, padding) and the stored upper bound, all asked for at
  // once: the few samples that come this far would else wait for three
  // loads one after the other
  const float4 a = __ldg(pack + 2 * q.local);
  const float4 b = __ldg(pack + 2 * q.local + 1);
  const float ub_stored = __ldcg(out.ubmin + q.local);
  const float ex = __fsub_rn(r.px, q.sx);
  const float ey = __fsub_rn(r.py, q.sy);
  const float ez = __fsub_rn(r.pz, nz);
  const float d = __fmaf_rn(ez, ez, __fmaf_rn(ey, ey, __fmul_rn(ex, ex)));
  if (!(d >= 0.1f)) return;

  const bool ub_cond = nz < a.z;
  bool write_ub = false;
  if (a.w == 1.0f) {  // invalid cell: upper-bound candidate only
    write_ub = ub_cond;
  } else if (a.w == 2.0f) {  // cell eligible to be cleaned up
    const bool penet = a.x > __fsub_rn(__fadd_rn(nz, 0.01f), a.y);
    if (penet) {
      const float prod =
          __fmaf_rn(r.dz, b.z, __fmaf_rn(r.dx, b.x, __fmul_rn(r.dy, b.y)));
      if (fabsf(prod) >= cos_thresh) {
        atomicAdd(out.dechits + q.local, make_float2(r.dec_amount, 1.0f));
        write_ub = ub_cond;
      }
    }
  }
  // the stored min only falls: a stale read can cost a redundant atomic,
  // never lose a write
  if (write_ub && nz < ub_stored) atomic_min_f32(out.ubmin + q.local, nz);
}

// inside the map's border and in the block
__device__ __forceinline__ bool writable(const Sample& q, const Grid& g) {
  return q.local >= 0 && q.ix > 0 && q.ix < g.n - 1 && q.iy > 0 &&
         q.iy < g.n - 1;
}

// The groups of a warp run every loop the same number of times (the most
// any of them needs, found with group_max) and shuffle with the full mask:
// a warp whose groups ran different trip counts would diverge, and a
// divergent warp shuffles one group at a time.
constexpr unsigned kFull = 0xffffffffu;

// The largest v over the groups of a warp; v is the same in all lanes of a
// group.
template <int G>
__device__ __forceinline__ int group_max(int v) {
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
    v = max(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// The group's G bits of a ballot, in bits 0 .. G - 1.
template <int G>
__device__ __forceinline__ unsigned group_ballot(bool pred, unsigned gshift) {
  const unsigned all = __ballot_sync(kFull, pred);
  return G == 32 ? all : (all >> gshift) & ((1u << (G & 31)) - 1u);
}

// One ray per group without a gate: pass p of the group takes steps
// pG .. pG + G - 1. k is 0 for a group without a ray.
template <int G>
__device__ __forceinline__ void march_flat(const Ray& r, int k, int lane,
                                           float tx, float ty, float tz,
                                           const float4* __restrict__ pack,
                                           const Grid& g, float cos_thresh,
                                           const Outputs& out) {
  const int k_max = group_max<G>(k);
  int carry = -1;  // cell of the step before this pass; step 0 has none
  for (int m0 = 0; m0 < k_max; m0 += G) {
    const int m = m0 + lane;
    const Sample q = sample_cell(m, r, tx, ty, g);
    int prev = __shfl_up_sync(kFull, q.cell, 1, G);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(kFull, q.cell, G - 1, G);
    if (m < k && writable(q, g) && q.cell != prev) {
      fresh_sample(q, r, tz, pack, cos_thresh, out);
    }
  }
}

// One ray per group with a gate. Returns the ray's surviving segments in x
// and its live segments in y (both below 2^31).
template <int G>
__device__ __forceinline__ uint2 march_gated(const Ray& r, int k, int lane,
                                             unsigned gshift, float tx,
                                             float ty, float tz,
                                             const float4* __restrict__ pack,
                                             const Grid& g, const GateArgs& ga,
                                             float cos_thresh,
                                             const Outputs& out) {
  const int n_seg = div_pow2(k + ga.seg - 1, ga.seg, ga.seg_shift);
  const int n_seg_max = group_max<G>(n_seg);
  unsigned survived = 0;
  for (int sb = 0; sb < n_seg_max; sb += G) {
    // test: lane l takes segment sb + l, steps [m_lo, m_hi)
    const int sj = sb + lane;
    const int m_lo = sj * ga.seg;
    bool survives = false;
    int before = -1;  // cell of the step before the segment; step 0 has none
    if (sj < n_seg) {
      const int m_hi = min(m_lo + ga.seg, k);
      // nz is linear in s, so the segment's lowest sample is an end
      const float s_lo = __fmul_rn(static_cast<float>(m_lo + 1), g.step);
      const float s_hi = __fmul_rn(static_cast<float>(m_hi), g.step);
      const float x0 = __fmaf_rn(r.dx, s_lo, tx);
      const float y0 = __fmaf_rn(r.dy, s_lo, ty);
      const float nz_min =
          fminf(__fmaf_rn(r.dz, s_lo, tz), __fmaf_rn(r.dz, s_hi, tz));
      const int bx =
          div_pow2(axis_cell(x0, g), ga.block, ga.block_shift) - ga.r0;
      const int by =
          div_pow2(axis_cell(y0, g), ga.block, ga.block_shift) - ga.c0;
      survives = bx >= 0 && bx < ga.rows && by >= 0 && by < ga.cols &&
                 nz_min < __fadd_rn(__ldg(ga.table + bx * ga.cols + by), ga.eps);
      if (survives && m_lo > 0) before = sample_cell(m_lo - 1, r, tx, ty, g).cell;
    }
    const unsigned smask = group_ballot<G>(survives, gshift);
    const int n_surv = __popc(smask);
    survived += n_surv;

    // march: the surviving segments' steps, packed over the lanes. Flat
    // index f is step f % seg of the (f / seg)-th surviving segment.
    const int total = n_surv * ga.seg;
    const int total_max = group_max<G>(total);
    unsigned rest = smask;  // smask without its `taken` lowest set bits
    int taken = 0;
    int carry = -1;
    for (int f0 = 0; f0 < total_max; f0 += G) {
      const int f = f0 + lane;
      const int which = div_pow2(f, ga.seg, ga.seg_shift);
      const int off = f - which * ga.seg;
      unsigned pick = rest;
      for (int i = taken; i < which; ++i) pick &= pick - 1;
      const int sl = __ffs(pick) - 1;  // lane that tested the segment, or -1
      const int m = (sb + sl) * ga.seg + off;
      const Sample q = sample_cell(m, r, tx, ty, g);
      int prev = __shfl_up_sync(kFull, q.cell, 1, G);
      const int seg_before = __shfl_sync(kFull, before, max(sl, 0), G);
      if (lane == 0) prev = carry;  // a segment that straddles two passes
      if (off == 0) prev = seg_before;
      carry = __shfl_sync(kFull, q.cell, G - 1, G);
      if (sl >= 0 && m < k && writable(q, g) && q.cell != prev) {
        fresh_sample(q, r, tz, pack, cos_thresh, out);
      }
      const int done = div_pow2(f0 + G, ga.seg, ga.seg_shift);
      for (; taken < done; ++taken) rest &= rest - 1;
    }
  }
  return make_uint2(survived, static_cast<unsigned>(n_seg));
}

// dechits <- 0, ubmin <- +inf, counts <- 0, and each cell's reach, in one
// pass over the outputs' one buffer: per map, floats [0, 4) are the two
// counts, [4, 4 + 2 n2) the decrement and hit count, then n2 of upper bound
// and n2 of reach, for the n2 = bh * bw cells of the block.
// A cell's reach is a height that every sample that writes to the cell lies
// below. An invalid cell (code 1) is written where nz < its upper-bound
// threshold: that is its reach. An eligible cell (code 2) is written only
// by a sample that penetrates it, height > fl(fl(nz + 0.01) - slack); the
// three roundings move that compare by less than 4 ulp of the largest
// operand, so nz < height - 0.01 + slack + margin holds for every such
// sample once the margin is 1e-3 + 1e-5 (|height| + |slack|), a hundred
// times those ulps. Any other cell is never written: -inf. The reach only
// spares work: a sample below it still takes the exact tests on the row.
__global__ void __launch_bounds__(kThreads)
init_outputs_kernel(const float4* __restrict__ pack, float* __restrict__ buf,
                    int64_t n2, int64_t n_all) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_all) return;
  const int64_t m = i / (4 + 4 * n2), j = i - m * (4 + 4 * n2);  // map, float
  const int64_t n_zero = 4 + 2 * n2;
  if (j < n_zero) {
    buf[i] = 0.0f;
  } else if (j < n_zero + n2) {
    buf[i] = INFINITY;
  } else {
    const float4 a = __ldg(pack + 2 * (m * n2 + j - n_zero - n2));
    float reach = -INFINITY;
    if (a.w == 1.0f) {
      reach = a.z;
    } else if (a.w == 2.0f) {
      reach = a.x - 0.01f + a.y + (1e-3f + 1e-5f * (fabsf(a.x) + fabsf(a.y)));
    }
    buf[i] = reach;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
exact_march_kernel(const float4* __restrict__ pack,
                   const float* __restrict__ points,
                   const bool* __restrict__ valid,
                   const float* __restrict__ t, GateArgs ga, float* buf,
                   int64_t n2, int64_t n_rays, Grid g, float max_ray_length,
                   float cleanup_step, float cos_thresh) {
  // map blockIdx.y's pack, rays, sensor position, gate table and outputs
  const int64_t map = blockIdx.y;
  pack += 2 * n2 * map;
  points += 3 * n_rays * map;
  valid += n_rays * map;
  t += 3 * map;
  if (ga.table != nullptr) ga.table += map * ga.rows * ga.cols;
  float* const slab = buf + (4 + 4 * n2) * map;
  const Outputs out{
      reinterpret_cast<float2*>(slab + 4), slab + 4 + 2 * n2, slab + 4 + 3 * n2,
      ga.table != nullptr ? reinterpret_cast<unsigned long long*>(slab)
                          : nullptr};
  const int lane = threadIdx.x & (G - 1);
  const unsigned gshift = (threadIdx.x & 31u) & ~static_cast<unsigned>(G - 1);
  // the first group of this warp and the number of groups in the grid
  const int64_t warp_group =
      (static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31u)) / G;
  const int64_t n_groups = static_cast<int64_t>(gridDim.x) * kThreads / G;
  const int64_t n_chunks = (n_rays + G - 1) / G;
  const float tx = __ldg(t), ty = __ldg(t + 1), tz = __ldg(t + 2);
  unsigned long long survived = 0, segments = 0;

  for (int64_t c0 = warp_group; c0 < n_chunks; c0 += n_groups) {
    // each group takes a chunk of G rays and each lane builds one of them
    const int64_t i = (c0 + (gshift / G)) * G + lane;
    Ray mine = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int k_mine = 0;
    if (i < n_rays && valid[i]) {
      k_mine = make_ray(points[3 * i], points[3 * i + 1], points[3 * i + 2],
                        tx, ty, tz, g, max_ray_length, cleanup_step, &mine);
    }
    // a group marches its chunk's live rays one after the other
    unsigned live = group_ballot<G>(k_mine > 0, gshift);
    while (__any_sync(kFull, live != 0)) {
      const int j = live != 0 ? __ffs(live) - 1 : 0;
      Ray r;
      r.dx = __shfl_sync(kFull, mine.dx, j, G);
      r.dy = __shfl_sync(kFull, mine.dy, j, G);
      r.dz = __shfl_sync(kFull, mine.dz, j, G);
      r.px = __shfl_sync(kFull, mine.px, j, G);
      r.py = __shfl_sync(kFull, mine.py, j, G);
      r.pz = __shfl_sync(kFull, mine.pz, j, G);
      r.dec_amount = __shfl_sync(kFull, mine.dec_amount, j, G);
      int k = __shfl_sync(kFull, k_mine, j, G);
      if (live == 0) k = 0;  // this group's chunk is done: it only keeps step
      live &= live - 1;
      if (ga.table == nullptr) {
        march_flat<G>(r, k, lane, tx, ty, tz, pack, g, cos_thresh, out);
      } else {
        const uint2 c = march_gated<G>(r, k, lane, gshift, tx, ty, tz, pack, g,
                                       ga, cos_thresh, out);
        survived += c.x;
        segments += c.y;
      }
    }
  }
  if (out.counts == nullptr) return;
  // every lane of a group holds the group's counts: its lane 0 contributes
  // them, a warp and then the block sum them, and thread 0 adds the block's
  __shared__ unsigned long long block_sums[2][kThreads / 32];
  if (lane != 0) survived = segments = 0;
  for (int off = 16; off > 0; off >>= 1) {
    survived += __shfl_down_sync(0xffffffffu, survived, off);
    segments += __shfl_down_sync(0xffffffffu, segments, off);
  }
  if ((threadIdx.x & 31) == 0) {
    block_sums[0][threadIdx.x >> 5] = survived;
    block_sums[1][threadIdx.x >> 5] = segments;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    survived = segments = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      survived += block_sums[0][w];
      segments += block_sums[1][w];
    }
    if (segments > 0) {
      atomicAdd(out.counts, survived);
      atomicAdd(out.counts + 1, segments);
    }
  }
}

// max that keeps a NaN, as amax and max_pool2d do
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

struct Snapshot {
  const float* layers;      // (7, n*n) per map
  const float* normal;      // (3, n*n) per map
  const float* inlier;      // (n*n,) per map, maps inlier_stride apart
  int64_t inlier_stride;
  float* new_layers;        // (7, n*n) per map
  float* frac;              // (1,) per map, or null: no gate
  float wall_num_thresh;
  float outlier_variance;
};

// One thread per cell of a tile x tile gate block (blockIdx.x, blockIdx.y)
// of map blockIdx.z: the cell's pack row and, when `blkmax` is given, the
// block's max over its cells' write thresholds, into blkmax (nb*nb per map,
// maps `blkmax_stride` apart). A cell on the map's border or past its edge
// writes nothing (-inf).
__global__ void cleanup_pack_kernel(Snapshot s, float4* __restrict__ pack,
                                    float* __restrict__ blkmax,
                                    int64_t blkmax_stride, int n, int tile) {
  extern __shared__ float zs[];
  const int64_t map = blockIdx.z;
  const int64_t n2 = static_cast<int64_t>(n) * n;
  const int r = blockIdx.y * tile + threadIdx.x / tile;
  const int c = blockIdx.x * tile + threadIdx.x % tile;
  float z = -INFINITY;
  if (r < n && c < n) {
    const int64_t cell = static_cast<int64_t>(r) * n + c;
    const float* L = s.layers + 7 * n2 * map + cell;
    const float* N = s.normal + 3 * n2 * map + cell;
    const float h = L[0], var = L[n2], valid = L[2 * n2], age = L[4 * n2];
    const float q = __fmul_rn(var > 1.0f ? 1.0f : var, 0.05f);
    const float ub = L[6 * n2] < 0.5f ? INFINITY : L[5 * n2];
    const bool invalid = valid < 0.5f;
    const float ic = s.inlier[s.inlier_stride * map + cell];
    const bool hit_ok = !invalid && age >= 0.5f &&
                        !(ic > s.wall_num_thresh && age < 1.0f);
    const float code = invalid ? 1.0f : (hit_ok ? 2.0f : 0.0f);
    pack[2 * (n2 * map + cell)] = make_float4(h, q, ub, code);
    pack[2 * (n2 * map + cell) + 1] = make_float4(N[0], N[n2], N[2 * n2], 0.0f);
    if (r >= 1 && r < n - 1 && c >= 1 && c < n - 1) {
      z = code == 1.0f ? ub
                       : (code == 2.0f ? __fadd_rn(__fsub_rn(h, 0.01f), q)
                                       : -INFINITY);
    }
  }
  if (blkmax == nullptr) return;
  zs[threadIdx.x] = z;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = zs[0];
    for (int i = 1; i < tile * tile; ++i) m = max_nan(m, zs[i]);
    blkmax[blkmax_stride * map + static_cast<int64_t>(blockIdx.y) * gridDim.x +
           blockIdx.x] = m;
  }
}

// The gate table: each gate block's max over the 3x3 gate blocks around it
// (max_pool2d with -inf padding).
__global__ void __launch_bounds__(kThreads)
cleanup_gate_kernel(const float* __restrict__ blkmax, int64_t blkmax_stride,
                    float* __restrict__ table, int nb, int64_t n_all) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_all) return;
  const int64_t per = static_cast<int64_t>(nb) * nb;
  const int64_t map = i / per;
  const int gr = static_cast<int>((i - map * per) / nb);
  const int gc = static_cast<int>(i - map * per - static_cast<int64_t>(gr) * nb);
  const float* b = blkmax + blkmax_stride * map;
  float m = -INFINITY;
  for (int dr = -1; dr <= 1; ++dr) {
    for (int dc = -1; dc <= 1; ++dc) {
      const int rr = gr + dr, cc = gc + dc;
      if (rr >= 0 && rr < nb && cc >= 0 && cc < nb) {
        m = max_nan(m, b[static_cast<int64_t>(rr) * nb + cc]);
      }
    }
  }
  table[i] = m;
}

// The new layers from the march's outputs, a thread per cell of every map,
// and (the map's cell 0) the map's segment survivor fraction.
__global__ void __launch_bounds__(kThreads)
cleanup_apply_kernel(Snapshot s, const float* __restrict__ buf, int64_t n2,
                     int64_t n_all) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_all) return;
  const int64_t map = i / n2, cell = i - map * n2;
  const float* L = s.layers + 7 * n2 * map + cell;
  float* O = s.new_layers + 7 * n2 * map + cell;
  const float* slab = buf + (4 + 4 * n2) * map;
  const float dec = slab[4 + 2 * cell], hits = slab[4 + 2 * cell + 1];
  const float ub = slab[4 + 2 * n2 + cell];
  const bool wrote = isfinite(ub);
  O[0] = L[0];
  O[n2] = __fadd_rn(L[n2], __fmul_rn(hits, s.outlier_variance));
  O[2 * n2] = __fsub_rn(L[2 * n2], dec);
  O[3 * n2] = L[3 * n2];
  O[4 * n2] = L[4 * n2];
  O[5 * n2] = wrote ? ub : L[5 * n2];
  O[6 * n2] = wrote ? 1.0f : L[6 * n2];
  if (cell == 0 && s.frac != nullptr) {
    const long long* counts = reinterpret_cast<const long long*>(slab);
    const long long total = counts[1];
    s.frac[map] = total > 0 ? __fdiv_rn(static_cast<float>(counts[0]),
                                        static_cast<float>(total))
                            : 0.0f;
  }
}

int log2_exact(int x) {
  for (int s = 0; s < 31; ++s) {
    if (x == (1 << s)) return s;
  }
  return -1;
}

template <int G>
cudaError_t launch_march(const float4* pack, const float* points,
                         const bool* valid, const float* t, const GateArgs& ga,
                         float* buf, int64_t n2, int n_maps, int64_t n_rays,
                         const Grid& g, float max_ray_length,
                         float cleanup_step, float cos_thresh,
                         cudaStream_t st) {
  // per map, as many blocks as the card holds at once, or fewer when the
  // map's rays need fewer: the groups then stride over its chunks of rays
  static int64_t resident = 0;  // of this instantiation, on the first device seen
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, exact_march_kernel<G>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidValue;
    resident = static_cast<int64_t>(sms) * per_sm;
  }
  const int64_t n_chunks = (n_rays + G - 1) / G;
  const int64_t needed = (n_chunks * G + kThreads - 1) / kThreads;
  const int64_t blocks = needed < resident ? needed : resident;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_maps));
  exact_march_kernel<G><<<grid, kThreads, 0, st>>>(
      pack, points, valid, t, ga, buf, n2, n_rays, g, max_ray_length,
      cleanup_step, cos_thresh);
  return cudaGetLastError();
}

}  // namespace

// A batch of n_maps maps, each with its own of what follows, map b's at b
// times the size given here from map 0's: pack (bh*bw, 8) float32 rows of
// the block's cells (rows [r0, r0 + bh), columns [c0, c0 + bw) of the n x n
// map); points (n_rays, 3) float32 ray end points and valid (n_rays,) bool,
// both in the map-center frame; t (3,) float32 sensor position; gate
// (gate_rows*gate_cols,) float32, the window of gate blocks from
// (gate_r0, gate_c0), or null for every map; outputs (4 + 4*bh*bw,)
// float32, uninitialised, the whole buffer 8-byte aligned: initialised here
// and then holding the two int64 counts (surviving, live segments), the
// (bh*bw, 2) decrement and hit count, the (bh*bw,) upper bound (+inf where
// unwritten) and (bh*bw,) of scratch. `lanes` (16 or 32) is the number of
// lanes that march one ray.
//
// With `layers` (7, n*n) float32, `normal` (3, n*n) float32 and `inlier`
// (n*n,) float32 (maps `inlier_stride` floats apart), the call is the
// whole cleanup of whole maps (the block and the gate window the whole map,
// the window ceil(n / block) gate blocks a side): pack and gate are written
// here from them first, and `new_layers` (7, n*n) float32 and, with a gate,
// `frac` (1,) float32 are written after the march.
// Works on `stream` and does not synchronise.
extern "C" int exact_march(const void* pack, const void* points,
                           const void* valid, const void* t, const void* gate,
                           void* outputs, int32_t n_maps, int64_t n_rays,
                           int32_t n, int32_t r0, int32_t c0, int32_t bh,
                           int32_t bw, float res, float step, int32_t n_steps,
                           float max_ray_length, float cleanup_step,
                           float cos_thresh, int32_t seg, int32_t block,
                           int32_t gate_r0, int32_t gate_c0, int32_t gate_rows,
                           int32_t gate_cols, float gate_eps, int32_t lanes,
                           const void* layers, const void* normal,
                           const void* inlier, int64_t inlier_stride,
                           void* new_layers, void* frac,
                           float wall_num_thresh, float outlier_variance,
                           void* stream) {
  const bool snapshot = layers != nullptr;
  if (n_maps == 0 || (n_rays == 0 && !snapshot)) {
    return static_cast<int>(cudaSuccess);
  }
  if (n_maps < 0 || n_maps > 65535 || n_rays < 0 || n <= 2 || n_steps < 0 ||
      r0 < 0 || c0 < 0 || bh <= 0 || bw <= 0 || r0 + bh > n || c0 + bw > n ||
      (gate != nullptr && (seg <= 0 || block <= 0 || gate_rows <= 0 ||
                           gate_cols <= 0)) ||
      (reinterpret_cast<uintptr_t>(outputs) & 7u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = gate != nullptr ? (n + block - 1) / block : 0;
  if (snapshot &&
      (normal == nullptr || inlier == nullptr || new_layers == nullptr ||
       r0 != 0 || c0 != 0 || bh != n || bw != n ||
       (gate != nullptr && (frac == nullptr || block > 32 || gate_r0 != 0 ||
                            gate_c0 != 0 || gate_rows != nb ||
                            gate_cols != nb)) ||
       (reinterpret_cast<uintptr_t>(pack) & 15u) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n2 = static_cast<int64_t>(bh) * bw;
  float* buf = static_cast<float*>(outputs);
  const int64_t n_all = (4 + 4 * n2) * n_maps;
  const float4* p = static_cast<const float4*>(pack);
  cudaError_t err = cudaSuccess;
  const Snapshot snap{static_cast<const float*>(layers),
                      static_cast<const float*>(normal),
                      static_cast<const float*>(inlier), inlier_stride,
                      static_cast<float*>(new_layers),
                      gate != nullptr ? static_cast<float*>(frac) : nullptr,
                      wall_num_thresh, outlier_variance};
  if (snapshot) {
    // each map's gate block maxima go to its outputs' scratch (nb*nb <=
    // n*n floats), which the initialisation below overwrites after the
    // table is built
    const int tile = gate != nullptr ? block : 8;
    float* blkmax = gate != nullptr ? buf + 4 + 3 * n2 : nullptr;
    const dim3 grid(static_cast<unsigned>((n + tile - 1) / tile),
                    static_cast<unsigned>((n + tile - 1) / tile),
                    static_cast<unsigned>(n_maps));
    cleanup_pack_kernel<<<grid, tile * tile, tile * tile * sizeof(float), st>>>(
        snap, const_cast<float4*>(p), blkmax, 4 + 4 * n2, n, tile);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (gate != nullptr) {
      const int64_t n_table = static_cast<int64_t>(nb) * nb * n_maps;
      float* table = const_cast<float*>(static_cast<const float*>(gate));
      cleanup_gate_kernel<<<static_cast<unsigned>((n_table + kThreads - 1) / kThreads),
                            kThreads, 0, st>>>(blkmax, 4 + 4 * n2, table, nb,
                                               n_table);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  init_outputs_kernel<<<static_cast<unsigned>((n_all + kThreads - 1) / kThreads),
                        kThreads, 0, st>>>(p, buf, n2, n_all);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const Grid g{n, res, 0.5f * static_cast<float>(n), step, n_steps,
               r0, c0, bh, bw};
  const GateArgs ga{static_cast<const float*>(gate), seg, log2_exact(seg),
                    block, log2_exact(block), gate_r0, gate_c0, gate_rows,
                    gate_cols, gate_eps};
  const float* pts = static_cast<const float*>(points);
  const bool* v = static_cast<const bool*>(valid);
  const float* tp = static_cast<const float*>(t);
  if (n_rays > 0) {
    switch (lanes) {
      case 16:
        err = launch_march<16>(p, pts, v, tp, ga, buf, n2, n_maps, n_rays, g,
                               max_ray_length, cleanup_step, cos_thresh, st);
        break;
      case 32:
        err = launch_march<32>(p, pts, v, tp, ga, buf, n2, n_maps, n_rays, g,
                               max_ray_length, cleanup_step, cos_thresh, st);
        break;
      default:
        err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (snapshot) {
    const int64_t n_cells = n2 * n_maps;
    cleanup_apply_kernel<<<static_cast<unsigned>((n_cells + kThreads - 1) / kThreads),
                           kThreads, 0, st>>>(snap, buf, n2, n_cells);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
