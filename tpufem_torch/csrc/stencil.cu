// Stencil SpMV on the embedded storage layout: y = A x, optionally <x, A x>.
//
// Replaces tpufem/ops/stencil_pallas.py::_kernel and ::_kernel_matvec_dot
// (one body, _apply_stencil).  A is K offset-diagonals data[K, NS]:
//     y[i] = sum_k data[k, i] * x[i + off_k]      (x = 0 outside [0, NS))
// which is exactly the flat zero-padded formulation of
// tpufem/sparse/stencil.py::stencil_matvec, so the same kernel serves the
// embedded CG operator (float) and the refinement's fp64 residual (double;
// Hopper has fp64, Mosaic had none).
//
// Bound on the card: bytes.  Per row it must read K coefficients and write
// one y (K+1 words); the K shifted x reads hit the same few x rows, which
// stay in L1/L2.  Design: one thread per row, consecutive threads on
// consecutive rows, so every data plane, x and y is read or written in
// fully coalesced 128-byte lines; no shared-memory staging (the L1 already
// serves the x reuse).  Rows whose shifted column leaves [0, NS) read 0,
// which replaces the TPU's roll wrap-around (wrapped values there only ever
// met zero coefficients).  The dot is per-block fp64 partials plus a
// fixed-order second pass (common.cuh).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 32;

struct Offsets {
  int k;
  long long off[kMaxOffsets];
};

template <typename T>
__global__ void __launch_bounds__(tpufem::kBlock)
stencil_matvec_kernel(const T* __restrict__ data, const T* __restrict__ x,
                      T* __restrict__ y, double* __restrict__ partials,
                      long long n, Offsets so) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  double part = 0.0;
  if (i < n) {
    T acc = T(0);
    for (int k = 0; k < so.k; ++k) {
      const long long j = i + so.off[k];
      const T xj = (j >= 0 && j < n) ? x[j] : T(0);
      acc += data[k * n + i] * xj;
    }
    y[i] = acc;
    part = static_cast<double>(x[i]) * static_cast<double>(acc);
  }
  if (partials != nullptr) {
    part = tpufem::block_sum<tpufem::kBlock>(part);
    if (threadIdx.x == 0) partials[blockIdx.x] = part;
  }
}

template <typename T>
int launch(const T* data, const T* x, T* y, double* partials, T* dot,
           long long n, const long long* offsets, int k, void* stream) {
  if (k < 1 || k > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  Offsets so;
  so.k = k;
  for (int i = 0; i < k; ++i) so.off[i] = offsets[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int nb = tpufem::num_blocks(n);
  stencil_matvec_kernel<T><<<nb, tpufem::kBlock, 0, s>>>(
      data, x, y, dot != nullptr ? partials : nullptr, n, so);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dot == nullptr) return static_cast<int>(err);
  tpufem::finish_dot_kernel<T><<<1, tpufem::kFinishBlock, 0, s>>>(
      partials, static_cast<int>(nb), dot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// partials: fp64 scratch of num_blocks(n) slots, used when dot != NULL.
int tpufem_stencil_matvec_f32(const float* data, const float* x, float* y,
                              double* partials, float* dot, long long n,
                              const long long* offsets, int k, void* stream) {
  return launch<float>(data, x, y, partials, dot, n, offsets, k, stream);
}

int tpufem_stencil_matvec_f64(const double* data, const double* x, double* y,
                              double* partials, double* dot, long long n,
                              const long long* offsets, int k, void* stream) {
  return launch<double>(data, x, y, partials, dot, n, offsets, k, stream);
}

int tpufem_num_blocks(long long n) {
  return static_cast<int>(tpufem::num_blocks(n));
}

}  // extern "C"
