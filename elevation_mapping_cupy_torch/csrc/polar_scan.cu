// polar_scan: the polar visibility cleanup's two scans over its cube, for B
// maps in one call.
//
// Replaces no TPU kernel: the JAX package scans its cube
// (elevation_mapping_cupy_tpu/ops/raycast.py::visibility_cleanup_polar) with
// XLA ops, which XLA fuses. Eager PyTorch cannot fuse them: the port's plain
// version (ops/raycast.py::_polar_scan) is eight launches, a flip, a cumsum
// along R and a flip again for each of the two streams, a cat of the two and
// a cumsum along A, each of which reads and writes the whole cube or half of
// it: ~415 MB of device traffic a default map (A 512, R 72, S 128), with K1's
// zero fill. This kernel is that function in two passes.
//
// What it computes, for a (B, 2, A, R, S) cube of K1's two streams (ray
// counts, sums of 1/length): the suffix sum along R of each (b, stream, a,
// s), packed as channel stream * S + s of a (B, A, R, 2S) tensor, and then
// the prefix sum of that along A for each (b, r, channel).
//
// Rounding. The result must equal the plain version's on the card bit for
// bit. On CUDA, torch.cumsum along a dimension that is not the innermost is
// ATen's tensor_kernel_scan_outer_dim: one thread walks each column in order
// with a float32 sum that starts at 0, and a flip moves no value. So each
// pass adds in the same order: pass 1 from r = R - 1 down to 0, pass 2 from
// a = 0 up, with a float32 sum from 0, and there is nothing else to round.
// (ATen scans a tensor that is one column, B = A = S = 1 here, with cub in
// another order; no config gives such a cube.)
//
// Bound: bytes. Pass 1 reads the cube and writes the packed tensor, pass 2
// reads it and writes it back in place, so the second cube's memory is never
// allocated: four times A R 2S floats a map, 151 MB a default map, 0.045 ms
// at 3.35 TB/s (0.22 ms for the deployed map, R 355). One read of the cube
// and one write of the result would be half that, but a one-pass scan along
// A carries sums between blocks of A and adds in another order.
//
// Design. Pass 1 is one thread per (b, stream, a, s), neighbouring threads on
// neighbouring s, so a warp reads and writes 128 contiguous bytes a step;
// pass 2 one thread per (b, r, channel), likewise on neighbouring channels.
// The values a thread adds do not depend on its running sum, so it loads
// kChunk of them at once and then adds and stores them: each thread keeps
// kChunk loads in flight. Both passes have enough threads at every shape the
// port runs: 131k and 91k for one deployed map, 8.4M and 1.18M for 64
// default maps. The grid follows (B, A, R, S) alone. Offsets inside a map
// are 32-bit: with 64-bit offsets and 16 loads in flight a thread took 145
// registers and the B = 64 call 3.77 ms on an H100; as written, 39 and 34
// registers and 3.41 ms (bound 2.88). 4 or 16 loads in flight, blocks of
// 128 threads and a forced occupancy were no faster.
//
// Built by elevation_mapping_cupy_torch/kernels.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpolar_scan.so polar_scan.cu
// and called through ctypes: the C entry point returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // loads a thread has in flight

// pass 1: suffix sums along R into the packed layout. Offsets inside one
// map are 32-bit (the entry point checks that a map's A R 2S fits).
__global__ void __launch_bounds__(kThreads) polar_scan_radius_kernel(const float* __restrict__ cubes,
                                                                      float* __restrict__ pref, int64_t n_threads,
                                                                      int32_t A, int32_t R, int32_t S) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_threads) return;
  const int32_t s = static_cast<int32_t>(i % S);
  const int64_t plane = i / S;  // (b * 2 + stream) * A + a
  const int32_t a = static_cast<int32_t>(plane % A);
  const int32_t stream = static_cast<int32_t>((plane / A) % 2);
  const int64_t b = plane / (2 * static_cast<int64_t>(A));
  const float* src = cubes + plane * R * S + s;
  float* dst = pref + b * A * R * 2 * S + (a * R * 2 + stream) * S + s;
  const int32_t dst_step = 2 * S;
  float acc = 0.0f;
  for (int32_t r0 = R - 1; r0 >= 0; r0 -= kChunk) {
    float v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (r0 - k >= 0) v[k] = src[(r0 - k) * S];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (r0 - k >= 0) {
        acc = acc + v[k];
        dst[(r0 - k) * dst_step] = acc;
      }
    }
  }
}

// pass 2: prefix sums along A, in place
__global__ void __launch_bounds__(kThreads) polar_scan_azimuth_kernel(float* pref, int64_t n_threads, int32_t A,
                                                                       int32_t R, int32_t S) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_threads) return;
  const int32_t row = 2 * S * R;  // one azimuth bin of one map
  const int64_t b = i / row;
  float* col = pref + b * A * row + static_cast<int32_t>(i % row);
  float acc = 0.0f;
  for (int32_t a0 = 0; a0 < A; a0 += kChunk) {
    // every load of a chunk before its stores: they are the same column
    float v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (a0 + k < A) v[k] = col[(a0 + k) * row];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (a0 + k < A) {
        acc = acc + v[k];
        col[(a0 + k) * row] = acc;
      }
    }
  }
}

}  // namespace

// cubes (b, 2, A, R, S) and pref (b, A, R, 2S), both contiguous float32;
// pref is written whole, cubes only read.
extern "C" int polar_scan(const void* cubes, void* pref, int32_t b, int32_t A, int32_t R, int32_t S, void* stream) {
  if (b < 0 || A < 0 || R < 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || A == 0 || R == 0 || S == 0) return static_cast<int>(cudaSuccess);
  if (static_cast<int64_t>(A) * R * 2 * S > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n1 = static_cast<int64_t>(b) * 2 * A * S;
  const int64_t n2 = static_cast<int64_t>(b) * R * 2 * S;
  const int64_t blocks1 = (n1 + kThreads - 1) / kThreads;
  const int64_t blocks2 = (n2 + kThreads - 1) / kThreads;
  if (blocks1 > INT32_MAX || blocks2 > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  polar_scan_radius_kernel<<<static_cast<unsigned>(blocks1), kThreads, 0, st>>>(
      static_cast<const float*>(cubes), static_cast<float*>(pref), n1, A, R, S);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  polar_scan_azimuth_kernel<<<static_cast<unsigned>(blocks2), kThreads, 0, st>>>(static_cast<float*>(pref), n2, A, R,
                                                                                  S);
  return static_cast<int>(cudaGetLastError());
}
