// Stencil SpMV on the embedded storage layout and its fused epilogues:
// kernel K2 (y = A x, optionally <x, A x>) and kernel B4 (residual, Jacobi
// sweep, sweep + dot) as one body templated on its epilogue.
//
// Replaces tpufem/ops/stencil_pallas.py::_kernel, ::_kernel_matvec_dot
// (K2) and ::_kernel_residual, ::_kernel_smooth, ::_kernel_smooth_dot (B4),
// which share one body, _apply_stencil.  A is K offset-diagonals
// data[K, NS]:
//     (A x)[i] = sum_k data[k, i] * x[i + off_k]   (x = 0 outside [0, NS))
// which is exactly the flat zero-padded formulation of
// tpufem/sparse/stencil.py::stencil_matvec.  The epilogues:
//     matvec     y = A x                           dot <x, y>
//     residual   y = b - A x
//     smooth     y = x + (omega inv_diag) (b - A x) dot <b, y>
// The coefficient type TD is a template parameter apart from the vector
// type TV: fp32 data with fp32 vectors (the CG operator and the general MG
// levels), bf16 data with fp32 vectors (cast_hierarchy: each coefficient
// widens on load and the sum runs in fp32, as the reference's products
// promote in-register), fp64 with fp64 (the refinement's residual; Hopper
// has fp64, Mosaic had none).  In the sweep, omega * inv_diag is rounded to
// TD before it meets the fp32 residual, as the reference's weakly typed
// scalar product is.
//
// Bound on the card: bytes.  Per row it must read K coefficients and the
// epilogue's vectors and write one y; the K shifted x reads hit the same few
// x rows, which stay in L1/L2.  Design: one thread per row, consecutive
// threads on consecutive rows, so every data plane and vector is read or
// written in fully coalesced lines; no shared-memory staging (the L1
// already serves the x reuse).  Rows whose shifted column leaves [0, NS)
// read 0, which replaces the TPU's roll wrap-around (wrapped values there
// only ever met zero coefficients).  The dot is per-block fp64 partials
// plus a fixed-order second pass (common.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 32;

struct Offsets {
  int k;
  long long off[kMaxOffsets];
};

using tpufem::kMatvec;
using tpufem::kResidual;
using tpufem::kSmooth;

template <typename TD, typename TV, int EPI>
__global__ void __launch_bounds__(tpufem::kBlock)
stencil_kernel(const TD* __restrict__ data, const TV* __restrict__ x,
               const TV* __restrict__ b, const TD* __restrict__ inv_diag,
               TV* __restrict__ y, double* __restrict__ partials, long long n,
               Offsets so, double omega) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  double part = 0.0;
  if (i < n) {
    TV acc = TV(0);
    for (int k = 0; k < so.k; ++k) {
      const long long j = i + so.off[k];
      const TV xj = (j >= 0 && j < n) ? x[j] : TV(0);
      acc += TV(tpufem::widen(data[k * n + i])) * xj;
    }
    TV out;
    if (EPI == kMatvec) {
      out = acc;
      part = static_cast<double>(x[i]) * static_cast<double>(out);
    } else if (EPI == kResidual) {
      out = b[i] - acc;
    } else {
      out = x[i] +
            tpufem::omega_inv_diag<TD, TV>(omega, inv_diag[i]) * (b[i] - acc);
      part = static_cast<double>(b[i]) * static_cast<double>(out);
    }
    y[i] = out;
  }
  if (partials != nullptr) {
    part = tpufem::block_sum<tpufem::kBlock>(part);
    if (threadIdx.x == 0) partials[blockIdx.x] = part;
  }
}

template <typename TD, typename TV, int EPI>
int launch(const TD* data, const TV* x, const TV* b, const TD* inv_diag, TV* y,
           double* partials, TV* dot, long long n, const long long* offsets,
           int k, double omega, void* stream) {
  if (k < 1 || k > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  Offsets so;
  so.k = k;
  for (int i = 0; i < k; ++i) so.off[i] = offsets[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int nb = tpufem::num_blocks(n);
  stencil_kernel<TD, TV, EPI><<<nb, tpufem::kBlock, 0, s>>>(
      data, x, b, inv_diag, y, dot != nullptr ? partials : nullptr, n, so,
      omega);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dot == nullptr) return static_cast<int>(err);
  tpufem::finish_dot_kernel<TV><<<1, tpufem::kFinishBlock, 0, s>>>(
      partials, static_cast<int>(nb), dot);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int dispatch(int epilogue, const void* data, const void* x, const void* b,
             const void* inv_diag, void* y, double* partials, void* dot,
             long long n, const long long* offsets, int k, double omega,
             void* stream) {
  const TD* d = static_cast<const TD*>(data);
  const TV* xv = static_cast<const TV*>(x);
  const TV* bv = static_cast<const TV*>(b);
  const TD* inv = static_cast<const TD*>(inv_diag);
  TV* yv = static_cast<TV*>(y);
  TV* dv = static_cast<TV*>(dot);
  switch (epilogue) {
    case kMatvec:
      return launch<TD, TV, kMatvec>(d, xv, bv, inv, yv, partials, dv, n,
                                     offsets, k, omega, stream);
    case kResidual:
      if (dot != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return launch<TD, TV, kResidual>(d, xv, bv, inv, yv, partials, dv, n,
                                       offsets, k, omega, stream);
    case kSmooth:
      return launch<TD, TV, kSmooth>(d, xv, bv, inv, yv, partials, dv, n,
                                     offsets, k, omega, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// epilogue: 0 matvec (dot <x, y>), 1 residual (no dot), 2 smooth (dot
// <b, y>).  b: the residual's b or the sweep's r (NULL for matvec);
// inv_diag: the sweep's (NULL otherwise).  partials: fp64 scratch of
// num_blocks(n) slots, used when dot != NULL.
int tpufem_stencil_f32(int epilogue, const void* data, const void* x,
                       const void* b, const void* inv_diag, void* y,
                       double* partials, void* dot, long long n,
                       const long long* offsets, int k, double omega,
                       void* stream) {
  return dispatch<float, float>(epilogue, data, x, b, inv_diag, y, partials,
                                dot, n, offsets, k, omega, stream);
}

int tpufem_stencil_bf16_f32(int epilogue, const void* data, const void* x,
                            const void* b, const void* inv_diag, void* y,
                            double* partials, void* dot, long long n,
                            const long long* offsets, int k, double omega,
                            void* stream) {
  return dispatch<__nv_bfloat16, float>(epilogue, data, x, b, inv_diag, y,
                                        partials, dot, n, offsets, k, omega,
                                        stream);
}

int tpufem_stencil_f64(int epilogue, const void* data, const void* x,
                       const void* b, const void* inv_diag, void* y,
                       double* partials, void* dot, long long n,
                       const long long* offsets, int k, double omega,
                       void* stream) {
  return dispatch<double, double>(epilogue, data, x, b, inv_diag, y, partials,
                                  dot, n, offsets, k, omega, stream);
}

int tpufem_num_blocks(long long n) {
  return static_cast<int>(tpufem::num_blocks(n));
}

}  // extern "C"
