// One-pass 2D P1 Poisson system build: stiffness + RHS + zero-Dirichlet
// elimination, from the embedded node coordinates.  Kernel B7.
//
// Replaces tpufem/ops/fused_system_pallas.py::_kernel_2d (the 2D path of
// build_poisson_system_pallas, launched from _build_2d).  Input C [2, S0,
// S1] (x, y coordinate planes, node (y, x) at store (y+1, x+1)); outputs
// data [K, S0, S1] (K = 7 stencil planes: the axes and the anti-diagonal
// of the cell split) and rhs [S0, S1].
//
// Bound on the card: bytes (2 coordinate planes in, K+1 planes out); the
// arithmetic per cell (two triangles: Jacobian, inverse, the 3x3 stiffness,
// three quadrature points of f) is a few hundred flops, under the bytes at
// the card's fp32 rate.  Design: K1's owner-computes
// (fused_system.cu).  One thread per output node sums, for every (type t,
// local node a), the one triangle whose local node a it is: six triangles,
// each recomputed from the coordinates (L1/L2 hits: neighbouring threads
// share cells), row a accumulated into K registers.  No atomics, so the
// output is bit-reproducible.  A cell outside [0, m) per axis is skipped:
// that is the Pallas kernel's `valid` mask, and it keeps the synthetic
// coordinates of the padding (x runs to 1152 store columns against 1025
// nodes at n=1024) out of every result.  The plan tables (triangle vertex
// offsets, target stencil slots, quadrature points) and f(x, y) come from a
// generated header (tpufem_fused_tables.h), as trace-time constants of the
// Pallas kernel; boundary masks come from the node indices.
#include <cuda_runtime.h>

#include "common.cuh"
#include "tpufem_fused_tables.h"

// The generated header defines:
//   TPUFEM_K                       number of stencil offsets (7)
//   TPUFEM_FOR_OFFSETS(X)          X(k, dy, dx) for every offset
//   TPUFEM_FOR_QP(X)               X(phi0, phi1, phi2, w) per point
//   TPUFEM_FOR_TA(X)               X(t, a, ya, xa, y0, x0, y1, x1, y2, x2,
//                                    k0, k1, k2) per (type, local node)
//   template <typename T> __device__ T rhs_f(T x, T y)

namespace {

template <int A>
__device__ __forceinline__ constexpr double pick3(double p0, double p1,
                                                  double p2) {
  return A == 0 ? p0 : (A == 1 ? p1 : p2);
}

// Row A of one triangle's stiffness into acc[K0..K2]; its load into racc.
// X[m][d]: coordinate d (x, y) of vertex m.
template <typename T, int A, int K0, int K1, int K2>
__device__ __forceinline__ void tri_row(const T (&X)[3][2],
                                        T (&acc)[TPUFEM_K], T& racc,
                                        int rhs_mode) {
  const T j00 = X[0][0] - X[2][0], j01 = X[1][0] - X[2][0];
  const T j10 = X[0][1] - X[2][1], j11 = X[1][1] - X[2][1];
  const T det = j00 * j11 - j01 * j10;
  const T inv_det = T(1) / det;
  // G[n][d] = d phi_n / d x_d: rows of J^-1, last = -sum
  const T g00 = j11 * inv_det, g01 = -j01 * inv_det;
  const T g10 = -j10 * inv_det, g11 = j00 * inv_det;
  const T G[3][2] = {{g00, g01}, {g10, g11}, {-(g00 + g10), -(g01 + g11)}};
  const T adet = det < T(0) ? -det : det;
  const T area = adet * T(0.5);
  acc[K0] += (G[A][0] * G[0][0] + G[A][1] * G[0][1]) * area;
  acc[K1] += (G[A][0] * G[1][0] + G[A][1] * G[1][1]) * area;
  acc[K2] += (G[A][0] * G[2][0] + G[A][1] * G[2][1]) * area;

  T facc = T(0);
  if (rhs_mode == 0) {
    // quadrature: sum_q w_q phi_A(q) f(x(q))
#define TPUFEM_QP_COORD(p0, p1, p2, d) \
  (T(p0) * X[0][d] + T(p1) * X[1][d] + T(p2) * X[2][d])
#define TPUFEM_QP_TERM(p0, p1, p2, w)                                      \
  facc += rhs_f<T>(TPUFEM_QP_COORD(p0, p1, p2, 0),                         \
                   TPUFEM_QP_COORD(p0, p1, p2, 1)) *                       \
          T((w) * pick3<A>(p0, p1, p2));
    TPUFEM_FOR_QP(TPUFEM_QP_TERM)
#undef TPUFEM_QP_TERM
#undef TPUFEM_QP_COORD
  } else {
    // interp: reference mass matrix (1 + delta_ab) / 24 times f at the
    // vertices
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      facc += T((A == b ? 2.0 : 1.0) / 24.0) * rhs_f<T>(X[b][0], X[b][1]);
    }
  }
  racc += facc * adet;
}

template <typename T>
__global__ void __launch_bounds__(tpufem::kBlock)
fused_system_2d_kernel(const T* __restrict__ C, T* __restrict__ data,
                       T* __restrict__ rhs, int S0, int S1, int m0, int m1,
                       int rhs_mode, int apply_bc) {
  const long long ns = static_cast<long long>(S0) * S1;
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= ns) return;
  const int sx = static_cast<int>(idx % S1);
  const int sy = static_cast<int>(idx / S1);
  // node indices of this row (cells run 0 <= c < m per axis)
  const int ny = sy - 1, nx = sx - 1;

  T acc[TPUFEM_K];
#pragma unroll
  for (int k = 0; k < TPUFEM_K; ++k) acc[k] = T(0);
  T racc = T(0);

#define TPUFEM_VERTEX(m, y, x)                                              \
  {                                                                         \
    const long long v = cell + static_cast<long long>(y) * S1 + (x);        \
    X[m][0] = C[v];                                                         \
    X[m][1] = C[ns + v];                                                    \
  }
#define TPUFEM_TA_TERM(t, a, ya, xa, y0, x0, y1, x1, y2, x2, k0, k1, k2)    \
  {                                                                         \
    const int cy = ny - (ya), cx = nx - (xa);                               \
    if (cy >= 0 && cy < m0 && cx >= 0 && cx < m1) {                         \
      const long long cell =                                                \
          static_cast<long long>(cy + 1) * S1 + (cx + 1);                   \
      T X[3][2];                                                            \
      TPUFEM_VERTEX(0, y0, x0)                                              \
      TPUFEM_VERTEX(1, y1, x1)                                              \
      TPUFEM_VERTEX(2, y2, x2)                                              \
      tri_row<T, a, k0, k1, k2>(X, acc, racc, rhs_mode);                    \
    }                                                                       \
  }
  TPUFEM_FOR_TA(TPUFEM_TA_TERM)
#undef TPUFEM_TA_TERM
#undef TPUFEM_VERTEX

  if (apply_bc) {
    // zero-Dirichlet elimination on the box boundary: Dirichlet rows become
    // identity rows with zero load, couplings into Dirichlet columns vanish
    auto on_bd = [&](int y, int x) {
      const bool inside = y >= 0 && y <= m0 && x >= 0 && x <= m1;
      return inside && (y == 0 || y == m0 || x == 0 || x == m1);
    };
    const bool bc_row = on_bd(ny, nx);
#define TPUFEM_BC_TERM(k, dy, dx)                                           \
  if (bc_row) {                                                             \
    acc[k] = ((dy) == 0 && (dx) == 0) ? T(1) : T(0);                        \
  } else if (on_bd(ny + (dy), nx + (dx))) {                                 \
    acc[k] = T(0);                                                          \
  }
    TPUFEM_FOR_OFFSETS(TPUFEM_BC_TERM)
#undef TPUFEM_BC_TERM
    if (bc_row) racc = T(0);
  }
#pragma unroll
  for (int k = 0; k < TPUFEM_K; ++k) data[k * ns + idx] = acc[k];
  rhs[idx] = racc;
}

template <typename T>
int launch(const T* C, T* data, T* rhs, int S0, int S1, int m0, int m1,
           int rhs_mode, int apply_bc, void* stream) {
  const long long ns = static_cast<long long>(S0) * S1;
  fused_system_2d_kernel<T><<<tpufem::num_blocks(ns), tpufem::kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      C, data, rhs, S0, S1, m0, m1, rhs_mode, apply_bc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// m0, m1: cells per axis (node_grid - 1); rhs_mode 0 = quadrature,
// 1 = interp.
int tpufem_fused_system_2d_f32(const float* C, float* data, float* rhs,
                               int S0, int S1, int m0, int m1, int rhs_mode,
                               int apply_bc, void* stream) {
  return launch<float>(C, data, rhs, S0, S1, m0, m1, rhs_mode, apply_bc,
                       stream);
}

int tpufem_fused_system_2d_f64(const double* C, double* data, double* rhs,
                               int S0, int S1, int m0, int m1, int rhs_mode,
                               int apply_bc, void* stream) {
  return launch<double>(C, data, rhs, S0, S1, m0, m1, rhs_mode, apply_bc,
                        stream);
}

}  // extern "C"
