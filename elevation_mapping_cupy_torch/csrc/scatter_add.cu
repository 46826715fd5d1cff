// K1 scatter_add_streams: scatter-add of K per-point float32 streams into
// flat cells, for B maps in one call.
//
// Replaces elevation_mapping_cupy_tpu/ops/pallas_scatter.py::_kernel (:142),
// launched there by _call_pallas_batched (:277). On the TPU, which has no
// atomics, that kernel does the scatter as one-hot bf16 matmuls on the MXU,
// splitting each value stream into hi/mid/lo bf16 parts to keep f32 sums.
// Hopper has float atomics, so none of that carries over. A masked point is
// skipped, which is the same as the JAX package's convention of adding 0 at
// cell 0. An index outside [0, n_cells) is dropped, as an XLA scatter drops
// it.
//
// Callers on the main path (elevation_mapping_cupy_torch/ops/scatter.py):
//   error counting   K=2 into 202*202 cells (two exact count streams)
//   point fusion     K=4 into 202*202 cells (two value, two count streams)
//   polar cleanup    K=2 into A*R*S = 512*355*128 = 23.3M shadow-cube bins
//
// Bound: bytes. The work is N*(4 + 1) bytes of index and mask, 4*K bytes of
// values per unmasked point, and K*n_cells*4 bytes of output, over
// 3.35 TB/s: about 1 us for the fusion scatter of 131072 points, and about
// 56 us for the deployed cube, where the 186 MB zero fill dominates. What
// kept the dense-map scatters 30-50x above that bound was not bytes but
// same-address atomics: a lidar's density puts thousands of points on each
// cell near the sensor, and global atomics on one address serialise in L2.
//
// Two paths, chosen by shape alone (ops/cuda_scatter.py::launch_plan):
//
//   private  One stream's map fits in a block's shared memory
//            (n_cells * 4 <= 232448 bytes: maps up to 241x241). A block owns
//            one (batch, stream) pair and one slice of the points. It zeroes
//            a full-map float32 tile in shared memory, adds its slice's
//            values there with shared-memory atomics, and then adds the
//            tile's non-zero cells to the output with one global atomic
//            each. A hot cell takes its thousands of adds in shared memory,
//            spread over the slices, and at most one global atomic per
//            slice. (A float add in shared memory is a compare-and-swap
//            loop, ATOMS.CAST.SPIN, some 60-80 cycles a success on one
//            address: the hottest cell's share of a slice, taken one after
//            the other, is what a block's time grows with.) The flush is by global atomics and not by per-slice
//            partial maps and a second pass: a slice of a few thousand
//            points touches at most that many cells, so the flush makes
//            fewer atomics than the slice had points, all but the hot cells'
//            on distinct addresses, whereas partial maps would write and
//            read slices * K * n_cells * 4 bytes (21 MB at K=4) and need a
//            second launch.
//   global   Larger outputs (the polar cube): one thread per (batch, point)
//            adds its K values with global atomics. The cube's bins are
//            hit a few times each and its time is the zero fill's, which is
//            the bound.
//
// The entry point zeroes the output itself (cudaMemsetAsync on the stream),
// so the caller hands it uninitialised memory.
//
// Numerics: streams of integer values (flags, counts below 2^24) sum exactly
// in any order. Value streams vary from run to run in the last bits, because
// the order of the atomics does.
//
// Built by elevation_mapping_cupy_torch/kernels.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libscatter_add.so scatter_add.cu
// and called through ctypes: the C entry point returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGlobalThreads = 256;
constexpr int kPrivateThreads = 1024;
constexpr int kUnroll = 4;  // points a thread has in flight in the private path

__global__ void __launch_bounds__(kGlobalThreads)
scatter_add_global_kernel(const int32_t* __restrict__ idx,
                          const uint8_t* __restrict__ mask,
                          const float* __restrict__ vals,
                          float* __restrict__ out,
                          int64_t n, int32_t k, int64_t n_cells,
                          int64_t total) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kGlobalThreads + threadIdx.x;
  if (t >= total || !mask[t]) return;
  const int32_t c = idx[t];
  if (c < 0 || c >= n_cells) return;
  const int64_t b = t / n;
  const int64_t i = t - b * n;
  // values are (B, K, N): stream s of this point lies at s * n, so
  // neighbouring threads read neighbouring addresses for every stream
  const float* v = vals + b * k * n + i;
  float* o = out + b * k * n_cells + c;
  for (int32_t s = 0; s < k; ++s) {
    atomicAdd(o + s * n_cells, __ldg(v + s * n));
  }
}

// grid (slices, K, B); dynamic shared memory: n_cells floats
__global__ void __launch_bounds__(kPrivateThreads)
scatter_add_private_kernel(const int32_t* __restrict__ idx,
                           const uint8_t* __restrict__ mask,
                           const float* __restrict__ vals,
                           float* __restrict__ out,
                           int64_t n, int32_t n_cells, int64_t per_slice) {
  extern __shared__ float tile[];
  const int64_t b = blockIdx.z;
  const int64_t s = blockIdx.y;
  const int32_t k = gridDim.y;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_slice;
  const int64_t end = min(begin + per_slice, n);

  for (int32_t c = threadIdx.x; c < n_cells; c += kPrivateThreads) {
    tile[c] = 0.0f;
  }
  __syncthreads();

  const int32_t* idx_b = idx + b * n;
  const uint8_t* mask_b = mask + b * n;
  const float* vals_s = vals + (b * k + s) * n;
  for (int64_t i0 = begin + threadIdx.x; i0 < end;
       i0 += static_cast<int64_t>(kPrivateThreads) * kUnroll) {
    // all loads first, so that a thread waits for memory once per kUnroll
    // points
    int32_t c[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + static_cast<int64_t>(u) * kPrivateThreads;
      c[u] = -1;
      v[u] = 0.0f;
      if (i < end) {
        const bool on = __ldg(mask_b + i) != 0;
        c[u] = on ? __ldg(idx_b + i) : -1;
        v[u] = __ldg(vals_s + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c[u] >= 0 && c[u] < n_cells) atomicAdd(tile + c[u], v[u]);
    }
  }
  __syncthreads();

  float* o = out + (b * k + s) * n_cells;
  for (int32_t c = threadIdx.x; c < n_cells; c += kPrivateThreads) {
    const float v = tile[c];
    if (v != 0.0f) atomicAdd(o + c, v);
  }
}

}  // namespace

// idx (B, N) int32, mask (B, N) uint8, vals (B, K, N) float32,
// out (B, K, n_cells) float32, uninitialised: zeroed here. `slices` > 0
// takes the private path with that many point slices per (batch, stream)
// and `shared_bytes` >= n_cells * 4 of dynamic shared memory; `slices` == 0
// takes the global path. Works on `stream` and does not synchronise.
extern "C" int scatter_add_streams(const void* idx, const void* mask,
                                   const void* vals, void* out, int64_t b,
                                   int64_t n, int32_t k, int64_t n_cells,
                                   int32_t slices, int32_t shared_bytes,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t out_bytes = b * k * n_cells * 4;
  if (out_bytes == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = b * n;
  if (total == 0) return static_cast<int>(cudaSuccess);

  if (slices > 0) {
    if (n_cells * 4 > shared_bytes || k > 65535 || b > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (shared_bytes > 48 * 1024) {  // above 48 KB a kernel has to opt in
      err = cudaFuncSetAttribute(scatter_add_private_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 shared_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int64_t per_slice = (n + slices - 1) / slices;
    const dim3 grid(static_cast<unsigned>(slices), static_cast<unsigned>(k),
                    static_cast<unsigned>(b));
    scatter_add_private_kernel<<<grid, kPrivateThreads, shared_bytes, st>>>(
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(vals), static_cast<float*>(out), n,
        static_cast<int32_t>(n_cells), per_slice);
    return static_cast<int>(cudaGetLastError());
  }

  const int64_t blocks = (total + kGlobalThreads - 1) / kGlobalThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  scatter_add_global_kernel<<<static_cast<unsigned>(blocks), kGlobalThreads, 0,
                              st>>>(
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(vals), static_cast<float*>(out), n, k, n_cells,
      total);
  return static_cast<int>(cudaGetLastError());
}
