// K1 scatter_add_streams: scatter-add of K per-point float32 streams into
// flat cells, for B maps in one launch.
//
// Replaces elevation_mapping_cupy_tpu/ops/pallas_scatter.py::_kernel (:142),
// launched there by _call_pallas_batched (:277). On the TPU, which has no
// atomics, that kernel does the scatter as one-hot bf16 matmuls on the MXU,
// splitting each value stream into hi/mid/lo bf16 parts to keep f32 sums.
// Hopper has float atomics, so none of that carries over: one thread per
// (batch, point) reads its cell index and mask once and atomicAdds each of
// its K values into a global (B, K, n_cells) buffer that the caller zeroes.
// A masked point is skipped, which is the same as the JAX package's
// convention of adding 0 at cell 0. An index outside [0, n_cells) is dropped,
// as an XLA scatter drops it.
//
// Callers on the main path (elevation_mapping_cupy_torch/ops/scatter.py):
//   error counting   K=2 into 202*202 cells (two exact count streams)
//   point fusion     K=4 into 202*202 cells (two value, two count streams)
//   polar cleanup    K=2 into A*R*S = 512*355*128 = 23.3M shadow-cube bins
//
// Bound: bytes, not atomics. The work is N*(4 + 1) bytes of index and mask,
// 4*K bytes of values per unmasked point, and K*n_cells*4 bytes of output
// (written once by the zero fill, then updated in L2 by the atomics), over
// 3.35 TB/s: about 1 us for the fusion scatter of 131072 points, and about
// 56 us for the deployed cube, where the 186 MB zero fill dominates. A
// 202x202x4 output is 653 KB, above the 227 KB of shared memory a block can
// have, so the atomics go to global memory (they resolve in L2, which holds
// the whole map); privatised shared-memory tiles are left to a later change.
//
// Numerics: streams of integer values (flags, counts below 2^24) sum exactly
// in any order. Value streams vary from run to run in the last bits, because
// the order of the atomics does.
//
// Built by elevation_mapping_cupy_torch/kernels.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libscatter_add.so scatter_add.cu
// and called through ctypes: the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_add_streams_kernel(const int32_t* __restrict__ idx,
                           const uint8_t* __restrict__ mask,
                           const float* __restrict__ vals,
                           float* __restrict__ out,
                           int64_t n, int32_t k, int64_t n_cells,
                           int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
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

}  // namespace

// idx (B, N) int32, mask (B, N) uint8, vals (B, K, N) float32,
// out (B, K, n_cells) float32 zeroed by the caller. Launches on `stream`
// and does not synchronise.
extern "C" int scatter_add_streams(const void* idx, const void* mask,
                                   const void* vals, void* out, int64_t b,
                                   int64_t n, int32_t k, int64_t n_cells,
                                   void* stream) {
  const int64_t total = b * n;
  if (total == 0 || k == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  scatter_add_streams_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(vals), static_cast<float*>(out), n, k, n_cells,
      total);
  return static_cast<int>(cudaGetLastError());
}
