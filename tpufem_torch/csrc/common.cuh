// Shared device helpers of the port's kernels: a deterministic two-pass
// dot product.
//
// The TPU kernels accumulate a dot into one SMEM cell across their
// sequential grid (tpufem/ops/stencil_pallas.py::_kernel_matvec_dot,
// tpufem/ops/mg_transfer_pallas.py::_kern_pas).  On the GPU blocks run in no
// order, so each block writes its partial sum (fp64) to its own slot and a
// second one-block pass sums the slots in a fixed order: the result is
// bit-reproducible from run to run, with no float atomics.
#pragma once

#include <cuda_runtime.h>

namespace tpufem {

constexpr int kBlock = 256;        // threads per block of every 1-D launch
constexpr int kFinishBlock = 1024; // threads of the second dot pass

// Sum of v over the block (result valid in thread 0).  blockDim.x == BLOCK.
template <int BLOCK>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[BLOCK / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  v = (threadIdx.x < BLOCK / 32) ? warp_sums[threadIdx.x] : 0.0;
  if (wid == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Second pass: out[0] = sum of partials[0..n), in a fixed order.
template <typename T>
__global__ void finish_dot_kernel(const double* __restrict__ partials, int n,
                                  T* __restrict__ out) {
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kFinishBlock) v += partials[i];
  v = block_sum<kFinishBlock>(v);
  if (threadIdx.x == 0) out[0] = static_cast<T>(v);
}

inline unsigned int num_blocks(long long n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

}  // namespace tpufem
