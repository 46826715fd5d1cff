// dilation_fill: the update's dilation of the height map, for B maps in one
// call.
//
// Replaces no TPU kernel: the JAX package computes the dilation
// (elevation_mapping_cupy_tpu/ops/stencil.py::dilation_fill, after the
// reference CUDA kernel dilation_filter_kernel, custom_kernels.py:392-449)
// as one shifted copy of the grid per neighbourhood offset, which XLA fuses.
// Eager PyTorch cannot fuse that loop: the port's plain version
// (ops/stencil.py::dilation_fill_reference) issues ~27 small kernels per
// offset, ~1350 an update at size 3, and the host's time to issue them was
// the largest part of a robot frame. This kernel is that loop in one launch.
//
// What it computes, per cell of a (B, h, w) batch: a cell whose mask is
// below 0.5 takes the height of the first usable neighbour in the scan
// order (dy outer, dx inner, both over [-size, size]) whose dx + dy is
// strictly below the best so far, which starts at 100; the signed sum is
// the reference's "distance". A neighbour is usable when its mask is above
// 0.5 and the reference's rule holds: its flat index (r0 + r + dy) * gw +
// (c0 + c + dx) lies in the (gh, gw) map and decomposes to an interior row
// and column. Past a row's end the flat index goes on at the next row's
// start, so at the map's left and right border the neighbour lies on the
// row above or below. A cell that found one gets mask 1; every other cell
// keeps its height and mask. The work only selects values, so the result is
// the plain version's bit for bit.
//
// Where the neighbour is read from, for a block (r0, c0, h, w) of the map:
//   inside the block's columns  the map and mask tensors;
//   left of column 0            mode 1 (a block of whole rows): the row
//                               above's last columns, read from the same
//                               tensors; mode 2: the `left` edge tensor
//                               (B, 2, h, size) that a sharded process
//                               gets from its neighbours; mode 0: nothing;
//   right of column w - 1       likewise, the row below's first columns;
//   rows outside the block      nothing (the process holds no such row).
// These are the cells the plain version reads from its padded copy.
//
// Bound: bytes. Each cell reads its height and mask and writes both: 16
// bytes a cell, 41.8 MB for B = 64 maps of 202 x 202, 12.5 us at 3.35 TB/s.
//
// Design. A block of 32 x 8 threads owns a 32 x 32 tile of one map, each
// thread four adjacent cells of a column, so a warp reads 128 contiguous
// bytes of a row. Whether a neighbour is usable, and its height, depend on
// the neighbour's cell alone, not on the cell that looks at it. So a block
// whose tile holds an invalid cell first works that out once for every
// cell of the tile and its halo of `size` cells: the heights into shared
// memory by asynchronous copies, the masks into registers, all in flight
// at once, then the usable flags as bits, one 32-bit word per warp and halo
// row from a ballot. A thread then walks the 4 + 2 size halo rows its
// cells look at; in each, its column's window of 2 size + 1 flags is one
// funnel shift, and the row's first usable offset is the lowest set bit.
// Only that offset can beat a cell's best (dx + dy grows along the row), so
// each of the four cells whose window holds the row compares it once. A
// block with no invalid cell only copies. Index arithmetic is 32-bit, and
// the neighbour rule needs no division: a neighbour lies at most one row's
// width left or right of the map.
//
// What set the design, on an H100 at B = 64, size 2 (bound 0.0125 ms):
// testing every offset of every invalid cell with 64-bit arithmetic took
// 0.178 ms; a shared tile of usable bytes 0.077; packed flags 0.057-0.066
// in every arrangement of loads tried. There the kernel was bound by its
// instructions, not its bytes (the copy alone takes 0.015), and sharing
// each halo row between a thread's cells is what cut them: 0.046.
//
// The halo holds (32 + 2 size)^2 cells, 1.27 reads a cell at size 2. Up to
// size 15 a window fits in 32 bits and a halo row in two words. Above that
// each invalid cell tests its own neighbours from the caches, one cell a
// thread (the direct kernel).
//
// Built by elevation_mapping_cupy_torch/kernels.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdilation_fill.so dilation_fill.cu
// and called through ctypes: the C entry point returns the first CUDA error.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 32;
constexpr int kThreadRows = 8;  // a block is kTileCols x kThreadRows threads
constexpr int kCells = 4;       // adjacent cells a thread owns, tiled kernel
constexpr int kTileRows = kThreadRows * kCells;
constexpr int kThreads = kTileCols * kThreadRows;
constexpr int kMaxTiledSize = 15;  // a window of 2 size + 1 flags in 32 bits
constexpr int kWords = 2;          // flag words a halo row: 32 + 30 <= 64
// halo rows a thread loads: (32 + 2 kMaxTiledSize) / 8, rounded up
constexpr int kHaloRows =
    (kTileRows + 2 * kMaxTiledSize + kThreadRows - 1) / kThreadRows;

enum EdgeMode : int32_t { kNoEdge = 0, kWrap = 1, kGiven = 2 };

struct Args {
  const float* map;
  const float* mask;
  const float* left;   // (B, 2, h, size) or null
  const float* right;  // (B, 2, h, size) or null
  float* out;          // (B, h, w)
  float* out_mask;     // (B, h, w)
  int64_t map_stride;  // elements between maps; rows are contiguous
  int64_t mask_stride;
  int32_t h, w, size;
  int32_t r0, c0, gh, gw;
  int32_t left_mode, right_mode;
};

// the height and mask of local cell (rr, cc) of map bi; false where the
// block holds no such row, or the column lies more than `size` left or
// right of the block (the last tile's halo reaches further; no cell looks
// there)
__device__ __forceinline__ bool neighbour(int64_t bi, int32_t rr, int32_t cc,
                                          const Args& a, float& v, float& m) {
  if (rr < 0 || rr >= a.h || cc < -a.size || cc >= a.w + a.size) return false;
  const float* mp = a.map + bi * a.map_stride;
  const float* kp = a.mask + bi * a.mask_stride;
  int32_t at;
  if (cc >= 0 && cc < a.w) {
    at = rr * a.w + cc;
  } else {
    const bool is_left = cc < 0;
    const int32_t mode = is_left ? a.left_mode : a.right_mode;
    if (mode == kGiven) {
      const int32_t plane = a.h * a.size;
      const float* e = (is_left ? a.left : a.right) + bi * 2 * plane +
                       rr * a.size + (is_left ? a.size + cc : cc - a.w);
      v = __ldg(e);
      m = __ldg(e + plane);
      return true;
    }
    if (mode != kWrap) return false;
    const int32_t row = is_left ? rr - 1 : rr + 1;
    if (row < 0 || row >= a.h) return false;
    at = row * a.w + (is_left ? a.w + cc : cc - a.w);
  }
  v = __ldg(mp + at);
  m = __ldg(kp + at);
  return true;
}

// _neighbor_ok for local cell (rr, cc): its flat index (r0 + rr) * gw +
// (c0 + cc) lies in the map and decomposes to an interior row and column.
// The column lies within one row's width of the map's (size <= w <= gw),
// so the flat index decomposes to the row above or below without a
// division.
__device__ __forceinline__ bool interior(int32_t rr, int32_t cc,
                                         const Args& a) {
  int32_t row = a.r0 + rr, col = a.c0 + cc;
  if (col < 0) {
    row -= 1;
    col += a.gw;
  } else if (col >= a.gw) {
    row += 1;
    col -= a.gw;
  }
  return row > 0 && row < a.gh - 1 && col > 0 && col < a.gw - 1;
}

// grid (tiles across, tiles down, B); dynamic shared memory: the halo's
// heights ((32 + 2 size)^2 floats) and usable flags (kWords words a row)
__global__ void __launch_bounds__(kThreads)
dilation_fill_tiled_kernel(Args a) {
  extern __shared__ float halo[];
  const int32_t s = a.size;
  const int32_t hc = kTileCols + 2 * s, hr = kTileRows + 2 * s;
  uint32_t* bits = reinterpret_cast<uint32_t*>(halo + hr * hc);
  const int32_t tr = blockIdx.y * kTileRows, tc = blockIdx.x * kTileCols;
  const int32_t tx = threadIdx.x, first = kCells * threadIdx.y;
  const int32_t c = tc + tx;
  const int64_t bi = blockIdx.z;
  const float* mp = a.map + bi * a.map_stride;
  const float* kp = a.mask + bi * a.mask_stride;
  float v[kCells], m[kCells];
  bool any_invalid = false;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int32_t r = tr + first + k;
    v[k] = 0.0f;
    m[k] = 1.0f;  // a cell outside the map counts as valid: nothing to do
    if (r < a.h && c < a.w) {
      v[k] = __ldg(mp + r * a.w + c);
      m[k] = __ldg(kp + r * a.w + c);
    }
    any_invalid |= m[k] < 0.5f;
  }
  if (__syncthreads_or(any_invalid)) {
    // the halo: heights by asynchronous copies, masks into registers; a
    // cell the block does not hold gets mask 0, and the cells beside the
    // block's columns (the row wrap, the edges) are read by the thread
    float hm[kHaloRows][kWords];
#pragma unroll
    for (int j = 0; j < kHaloRows; ++j) {
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        const int32_t y = threadIdx.y + j * kThreadRows, x = tx + q * kTileCols;
        const int32_t rr = tr + y - s, cc = tc + x - s;
        hm[j][q] = 0.0f;
        if (y < hr && x < hc && rr >= 0 && rr < a.h) {
          if (cc >= 0 && cc < a.w) {
            __pipeline_memcpy_async(halo + y * hc + x, mp + rr * a.w + cc, 4);
            hm[j][q] = __ldg(kp + rr * a.w + cc);
          } else {
            float nv = 0.0f;
            neighbour(bi, rr, cc, a, nv, hm[j][q]);
            halo[y * hc + x] = nv;
          }
        }
      }
    }
    __pipeline_commit();
#pragma unroll
    for (int j = 0; j < kHaloRows; ++j) {
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        const int32_t y = threadIdx.y + j * kThreadRows, x = tx + q * kTileCols;
        const bool ok = y < hr && x < hc && hm[j][q] > 0.5f &&
                        interior(tr + y - s, tc + x - s, a);
        const uint32_t word = __ballot_sync(0xffffffffu, ok);
        if (tx == 0 && y < hr) bits[y * kWords + q] = word;
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    // halo row first + t holds offset dy = t - k - s of cell k
    const uint32_t window = (1u << (2 * s + 1)) - 1;
    int32_t best[kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k) best[k] = 100;
    for (int32_t t = 0; t < kCells + 2 * s; ++t) {
      const int32_t y = first + t;
      const uint2 row = *reinterpret_cast<const uint2*>(bits + y * kWords);
      // bit j: halo column tx + j, the offset dx = j - s
      const uint32_t flags = __funnelshift_r(row.x, row.y, tx) & window;
      if (!flags) continue;
      const int32_t dx = __ffs(flags) - 1 - s;
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        const int32_t dy = t - k - s;
        if (m[k] < 0.5f && dy >= -s && dy <= s && dx + dy < best[k]) {
          best[k] = dx + dy;
          v[k] = halo[y * hc + tx + s + dx];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      if (m[k] < 0.5f && best[k] < 100) m[k] = 1.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int32_t r = tr + first + k;
    if (r < a.h && c < a.w) {
      const int64_t at = bi * a.h * a.w + r * a.w + c;
      a.out[at] = v[k];
      a.out_mask[at] = m[k];
    }
  }
}

// sizes above kMaxTiledSize: each invalid cell tests its own neighbours
__global__ void __launch_bounds__(kThreads)
dilation_fill_direct_kernel(Args a) {
  const int32_t c = blockIdx.x * kTileCols + threadIdx.x;
  const int32_t r = blockIdx.y * kThreadRows + threadIdx.y;
  const int64_t bi = blockIdx.z;
  if (r >= a.h || c >= a.w) return;
  float v = __ldg(a.map + bi * a.map_stride + r * a.w + c);
  float m = __ldg(a.mask + bi * a.mask_stride + r * a.w + c);
  if (m < 0.5f) {
    int32_t best = 100;
    for (int32_t dy = -a.size; dy <= a.size; ++dy) {
      // offsets further on in this row have a larger dx + dy
      for (int32_t dx = -a.size; dx <= a.size && dx + dy < best; ++dx) {
        float nv, nm;
        if (neighbour(bi, r + dy, c + dx, a, nv, nm) && nm > 0.5f &&
            interior(r + dy, c + dx, a)) {
          best = dx + dy;
          v = nv;
        }
      }
    }
    if (best < 100) m = 1.0f;
  }
  const int64_t at = bi * a.h * a.w + r * a.w + c;
  a.out[at] = v;
  a.out_mask[at] = m;
}

}  // namespace

// map and mask (B, h, w) float32 with contiguous rows, `map_stride` and
// `mask_stride` elements apart; left and right (B, 2, h, size) float32
// contiguous (height then mask), read only in mode 2; out and out_mask
// (B, h, w) float32 contiguous. The tensors are the block (r0, c0, h, w) of
// a (gh, gw) map of fewer than 2^31 cells. Works on `stream` and does not
// synchronise.
extern "C" int dilation_fill(const void* map, const void* mask,
                             const void* left, const void* right, void* out,
                             void* out_mask, int64_t map_stride,
                             int64_t mask_stride, int32_t b, int32_t h,
                             int32_t w, int32_t size, int64_t r0, int64_t c0,
                             int64_t gh, int64_t gw, int32_t left_mode,
                             int32_t right_mode, void* stream) {
  if (b == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  if (b < 0 || b > 65535 || h < 0 || w < 0 || size < 0 || size > w ||
      r0 < 0 || c0 < 0 || r0 + h > gh || c0 + w > gw ||
      gh * gw > INT32_MAX || (left_mode == kGiven && left == nullptr) ||
      (right_mode == kGiven && right == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(map), static_cast<const float*>(mask),
               static_cast<const float*>(left),
               static_cast<const float*>(right), static_cast<float*>(out),
               static_cast<float*>(out_mask), map_stride, mask_stride, h, w,
               size, static_cast<int32_t>(r0), static_cast<int32_t>(c0),
               static_cast<int32_t>(gh), static_cast<int32_t>(gw), left_mode,
               right_mode};
  const bool tiled = size <= kMaxTiledSize;
  const int32_t rows = tiled ? kTileRows : kThreadRows;  // a block's rows
  const dim3 block(kTileCols, kThreadRows);
  const dim3 grid(static_cast<unsigned>((w + kTileCols - 1) / kTileCols),
                  static_cast<unsigned>((h + rows - 1) / rows),
                  static_cast<unsigned>(b));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiled) {
    const size_t halo = static_cast<size_t>(kTileRows + 2 * size);
    const size_t shared =
        halo * (kTileCols + 2 * size) * sizeof(float) + halo * kWords * 4;
    dilation_fill_tiled_kernel<<<grid, block, shared, st>>>(a);
  } else {
    dilation_fill_direct_kernel<<<grid, block, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
