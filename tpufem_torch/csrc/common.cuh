// Shared device helpers of the port's kernels: a deterministic two-pass
// dot product, the separately rounded product and sum and the banded
// window base of the sparse kernels, the widening load of stored
// coefficients, the stencil epilogues and the sweep's rounding of
// omega * inv_diag, and the row of the constant-coefficient (uniform-grid)
// operator.
//
// The TPU kernels accumulate a dot into one SMEM cell across their
// sequential grid (tpufem/ops/stencil_pallas.py::_kernel_matvec_dot,
// tpufem/ops/mg_transfer_pallas.py::_kern_pas).  On the GPU blocks run in no
// order, so each block writes its partial sum (fp64) to its own slot and a
// second one-block pass sums the slots in a fixed order: the result is
// bit-reproducible from run to run, with no float atomics.
#pragma once

#include <cuda_bf16.h>
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

// A stored value in its arithmetic type: bf16 coefficient planes widen to
// fp32 on load (exactly), as the reference's products promote in-register.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A product and a sum each rounded on its own (no fused multiply-add): the
// sparse kernels (B9-B12) add in the reference's order with its rounding,
// so they equal their plain PyTorch versions bit for bit.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// First column of the window of row i in a banded plan of block_rows R:
// row i of block j = i / R reads x at (j - 1) R + rel.  block_rows 0 marks
// absolute columns (base 0).
__device__ __forceinline__ long long window_base(long long i,
                                                 long long block_rows) {
  return block_rows > 0 ? (i / block_rows - 1) * block_rows : 0;
}

// The stencil kernels' epilogues (K2/B4, B5 and their blocked twins B3,
// B5b): y = A x, y = b - A x, y = x + omega invd (b - A x).
enum Epilogue : int { kMatvec = 0, kResidual = 1, kSmooth = 2 };

// The sweep's omega * inv_diag, rounded to the coefficient type TD before
// it meets the residual in the vector type TV, as the reference's weakly
// typed scalar product is.
template <typename TD, typename TV>
__device__ __forceinline__ TV omega_inv_diag(double omega, TD inv_diag) {
  return TV(widen(TD(TV(omega) * TV(widen(inv_diag)))));
}

template <>
__device__ __forceinline__ float omega_inv_diag<__nv_bfloat16, float>(
    double omega, __nv_bfloat16 inv_diag) {
  const float w =
      __bfloat162float(__float2bfloat16(static_cast<float>(omega)));
  return __bfloat162float(__float2bfloat16(w * __bfloat162float(inv_diag)));
}

// The uniform-grid operator: K flat store offsets and the weights of an
// interior row, passed to a kernel by value.
template <int K>
struct ConstStencil {
  long long off[K];
  double w[K];
};

// (A_const x)[q]: interior rows (code 1) apply the weights to the
// interior-masked neighbours (a neighbour counts when ITS code is 1),
// Dirichlet rows (code 2) are the identity, padding rows (code 0) are zero.
// Neighbour indices outside [0, ns) read as padding.  The code plane may be
// stored narrower than x (bf16 after cast_hierarchy): its values 0/1/2 are
// exact in any type, so the result does not depend on it.
template <int K, typename TC, typename T>
__device__ __forceinline__ T const_apply(const TC* __restrict__ code,
                                         const T* __restrict__ x,
                                         long long q, long long ns,
                                         const ConstStencil<K>& st) {
  const T c = T(widen(code[q]));
  if (c != T(1)) return c == T(2) ? x[q] : T(0);
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long j = q + st.off[k];
    const bool in = j >= 0 && j < ns;
    const long long jj = in ? j : q;
    const T xj = x[jj];
    acc += T(st.w[k]) * ((in && T(widen(code[jj])) == T(1)) ? xj : T(0));
  }
  return acc;
}

}  // namespace tpufem
