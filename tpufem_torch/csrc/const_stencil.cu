// Constant-coefficient (uniform-grid) stencil kernels on the embedded
// layout: kernel B5, one body templated on its epilogue.
//
// Replaces tpufem/ops/stencil_pallas.py::_kernel_const_matvec,
// ::_kernel_const_residual, ::_kernel_const_smooth and
// ::_kernel_const_smooth_dot (one body, _apply_const_stencil).  On the
// uniform box every interior row of the Dirichlet-eliminated Poisson
// operator carries the same K weights, so a level is K numbers plus the
// row-type code plane (1 interior, 2 Dirichlet, 0 padding); the row itself
// is tpufem::const_apply (common.cuh), shared with K3/K4.  The epilogues:
//     matvec     y = A x
//     residual   y = b - A x
//     smooth     y = x + omega invd (b - A x),  invd = 1/w0 on interior
//                rows and 1 elsewhere            (optionally <b, y>)
// Output rows: interior -> the weighted sum, Dirichlet -> x (so the sweep
// gives x + omega (b - x)), padding -> 0 (b and x are 0 there).  The code
// plane may be stored in bf16 after cast_hierarchy; its values are exact,
// and invd, omega and the weights are scalars, so the result does not
// depend on the code's type.
//
// Bound on the card: bytes.  Per row it reads code and x (and b) and
// writes y: 16-20 bytes a row in fp32 against the general stencil's 76+.
// The K neighbour loads of x and code per interior row come from L1/L2.
// Design: one thread per row, consecutive threads on consecutive rows
// (coalesced planes), the weights, 1/w0 and omega by value, the offset
// count K a template constant (7 on 2D grids, 15 on 3D ones, dispatched on
// the k the caller passes) so the neighbour loop unrolls and its loads
// issue together.  The dot is per-block fp64 partials plus a fixed-order
// second pass (common.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using tpufem::kMatvec;
using tpufem::kResidual;
using tpufem::kSmooth;

template <int K>
struct ConstParams {
  tpufem::ConstStencil<K> st;
  double inv_w0;  // 1 / w[offset 0]
  double omega;   // Jacobi damping
};

template <int K, int EPI, typename TC, typename T>
__global__ void __launch_bounds__(tpufem::kBlock)
const_stencil_kernel(const TC* __restrict__ code, const T* __restrict__ x,
                     const T* __restrict__ b, T* __restrict__ y,
                     double* __restrict__ partials, long long n,
                     ConstParams<K> p) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  double part = 0.0;
  if (i < n) {
    const T ax = tpufem::const_apply(code, x, i, n, p.st);
    T out;
    if (EPI == kMatvec) {
      out = ax;
    } else if (EPI == kResidual) {
      out = b[i] - ax;
    } else {
      const T invd = T(tpufem::widen(code[i])) == T(1) ? T(p.inv_w0) : T(1);
      out = x[i] + T(p.omega) * invd * (b[i] - ax);
      part = static_cast<double>(b[i]) * static_cast<double>(out);
    }
    y[i] = out;
  }
  if (partials != nullptr) {
    part = tpufem::block_sum<tpufem::kBlock>(part);
    if (threadIdx.x == 0) partials[blockIdx.x] = part;
  }
}

template <int K, int EPI, typename TC, typename T>
int launch(const TC* code, const T* x, const T* b, T* y, double* partials,
           T* dot, long long n, const ConstParams<K>& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int nb = tpufem::num_blocks(n);
  const_stencil_kernel<K, EPI, TC, T><<<nb, tpufem::kBlock, 0, s>>>(
      code, x, b, y, dot != nullptr ? partials : nullptr, n, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dot == nullptr) return static_cast<int>(err);
  tpufem::finish_dot_kernel<T><<<1, tpufem::kFinishBlock, 0, s>>>(
      partials, static_cast<int>(nb), dot);
  return static_cast<int>(cudaGetLastError());
}

template <int K, typename TC, typename T>
int run(int epilogue, const void* code, const void* x, const void* b,
        void* y, double* partials, void* dot, long long n,
        const long long* offsets, const double* weights, double inv_w0,
        double omega, void* stream) {
  ConstParams<K> p;
  for (int i = 0; i < K; ++i) {
    p.st.off[i] = offsets[i];
    p.st.w[i] = weights[i];
  }
  p.inv_w0 = inv_w0;
  p.omega = omega;
  const TC* c = static_cast<const TC*>(code);
  const T* xv = static_cast<const T*>(x);
  const T* bv = static_cast<const T*>(b);
  T* yv = static_cast<T*>(y);
  T* dv = static_cast<T*>(dot);
  switch (epilogue) {
    case kMatvec:
      return launch<K, kMatvec>(c, xv, bv, yv, partials, dv, n, p, stream);
    case kResidual:
      return launch<K, kResidual>(c, xv, bv, yv, partials, dv, n, p, stream);
    case kSmooth:
      return launch<K, kSmooth>(c, xv, bv, yv, partials, dv, n, p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The offset count: 7 (2D anti-diagonal split) or 15 (3D Kuhn split).
template <typename TC, typename T>
int dispatch(int epilogue, const void* code, const void* x, const void* b,
             void* y, double* partials, void* dot, long long n,
             const long long* offsets, const double* weights, int k,
             double inv_w0, double omega, void* stream) {
  if (dot != nullptr && epilogue != kSmooth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (k) {
    case 7:
      return run<7, TC, T>(epilogue, code, x, b, y, partials, dot, n, offsets,
                           weights, inv_w0, omega, stream);
    case 15:
      return run<15, TC, T>(epilogue, code, x, b, y, partials, dot, n,
                            offsets, weights, inv_w0, omega, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// epilogue: 0 matvec, 1 residual, 2 smooth (dot <b, y> when dot != NULL).
// b: the residual's b or the sweep's r (NULL for matvec).  offsets /
// weights: the level's k = 7 or 15 flat offsets and interior weights.
// partials: fp64 scratch of num_blocks(n) slots, used when dot != NULL.
#define TPUFEM_CONST_ENTRY(NAME, TC, T)                                      \
  int NAME(int epilogue, const void* code, const void* x, const void* b,    \
           void* y, double* partials, void* dot, long long n,               \
           const long long* offsets, const double* weights, int k,          \
           double inv_w0, double omega, void* stream) {                     \
    return dispatch<TC, T>(epilogue, code, x, b, y, partials, dot, n,       \
                           offsets, weights, k, inv_w0, omega, stream);     \
  }

TPUFEM_CONST_ENTRY(tpufem_const_stencil_f32, float, float)
TPUFEM_CONST_ENTRY(tpufem_const_stencil_bf16_f32, __nv_bfloat16, float)
TPUFEM_CONST_ENTRY(tpufem_const_stencil_f64, double, double)

#undef TPUFEM_CONST_ENTRY

int tpufem_num_blocks(long long n) {
  return static_cast<int>(tpufem::num_blocks(n));
}

}  // extern "C"
