// Two-stage block sum of a flat vector (zero-padded to a multiple of
// `block`).
//
// Replaces tpufem/ops/reduction.py::_block_sum_kernel (the kernel of
// pallas_block_reduce).  On the TPU the grid runs in order and each block's
// partial sum accumulates into one SMEM scalar.  On the card blocks run in
// parallel, in no order, so the sum takes two launches and no atomics:
//   1. each `block` of x is cut into slices of kChunk = 4096 values (a
//      slice never straddles two blocks); one CUDA block of 256 threads per
//      slice, each thread adding its 16 values (strided by 256, coalesced)
//      in order, then a warp-shuffle tree and a shared-memory tree, writes
//      partials[block * slices + slice];
//   2. one CUDA block of 1024 threads sums the partials in index order
//      (thread t: partials t, t + 1024, ..., then the same trees).
// The order is fixed, so the result is bit-reproducible; every sum is
// rounded on its own in the input's type, so it equals the plain version
// (ops.reduction.block_reduce_plain) bit for bit.  Bound on the card:
// bytes (x read once).  Positions past the end of x read as zero (the
// reference's padding).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using tpufem::add_rn;

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;
constexpr int kFinish = 1024;

// Sum of v over the block, in the plain version's tree order (result
// valid in thread 0).  blockDim.x == BLOCK.
template <typename T, int BLOCK>
__device__ __forceinline__ T tree_sum(T v) {
  __shared__ T warp_sums[BLOCK / 32];
  for (int o = 16; o > 0; o >>= 1) {
    v = add_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < BLOCK / 32 ? warp_sums[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) {
      v = add_rn(v, __shfl_down_sync(0xffffffffu, v, o));
    }
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
partials_kernel(const T* __restrict__ x, long long n, long long block,
                T* __restrict__ partials) {
  const long long start = blockIdx.x * block +
                          static_cast<long long>(blockIdx.y) * kChunk;
  const long long end = min((blockIdx.x + 1) * block, n);
  T v = T(0);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = start + j * kThreads + threadIdx.x;
    v = add_rn(v, i < end ? x[i] : T(0));
  }
  v = tree_sum<T, kThreads>(v);
  if (threadIdx.x == 0) {
    partials[static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinish)
finish_kernel(const T* __restrict__ partials, long long count,
              T* __restrict__ out) {
  T v = T(0);
  for (long long i = threadIdx.x; i < count; i += kFinish) {
    v = add_rn(v, partials[i]);
  }
  v = tree_sum<T, kFinish>(v);
  if (threadIdx.x == 0) out[0] = v;
}

template <typename T>
int launch(const T* x, long long n, long long block, int nblk, int slices,
           T* partials, T* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  partials_kernel<T><<<dim3(nblk, slices), kThreads, 0, s>>>(x, n, block,
                                                             partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<T><<<1, kFinish, 0, s>>>(
      partials, static_cast<long long>(nblk) * slices, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [n]; nblk = ceil(n / block) (at least 1), slices = ceil(block /
// 4096); partials [nblk * slices] scratch; out [1].
int tpufem_block_reduce_f32(const float* x, long long n, long long block,
                            int nblk, int slices, float* partials,
                            float* out, void* stream) {
  return launch<float>(x, n, block, nblk, slices, partials, out, stream);
}

int tpufem_block_reduce_f64(const double* x, long long n, long long block,
                            int nblk, int slices, double* partials,
                            double* out, void* stream) {
  return launch<double>(x, n, block, nblk, slices, partials, out, stream);
}

}  // extern "C"
