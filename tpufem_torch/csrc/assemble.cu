// Fused P1 stiffness assembly on a structured Kuhn-tetrahedron grid:
// embedded element coordinates in, the K embedded stencil planes out (no
// RHS, no boundary elimination).
//
// Replaces tpufem/ops/assemble_pallas.py::_type_kernel (the kernel of
// assemble_stencil_pallas).  Input X [T, 4, 3, S0, S1, S2]: coordinate d
// of local node n of the type-t tetrahedron of cell (cz, cy, cx) at
// (cz, cy + 1, cx + 1) (element_coords_bt_embedded; padding cells hold a
// unit simplex, which this kernel never reads).  Output data [K, S0, S1,
// S2], every plane written once, zeros included.
//
// Bound on the card: bytes (the cell-grid part of the 72 coordinate planes
// in, K planes out); about 170 operations per tetrahedron (geometry once,
// 16 entries), far below.
// Design: output-owned, one launch.  The TPU kernel runs one call per
// element type over sequential z blocks, rolls each entry plane into
// place and read-modify-writes the aliased output T times.  Here one
// thread owns store row (z, y, x): for every (type t, local row a) it
// reads the 12 coordinates of the one cell whose local node a is this
// row, (z, y, x) - entry_shift[t, a], computes that tetrahedron's
// geometry in registers and adds row a of its stiffness into K register
// accumulators.  A cell outside the cell grid is skipped by its index (the
// TPU kernel masks its volume to zero).  No atomics, so the output is
// bit-reproducible; every product and sum is rounded on its own (no fused
// multiply-add), in the order t, a, b of the plain version
// (ops.assemble_cuda.assemble_stencil_plain), which it equals bit for
// bit.  Each tetrahedron's geometry is computed four times (once per
// local row), served from L1/L2.  The plan tables (entry_shift, entry_k)
// come from a generated header (tpufem_assemble_tables.h), as they were
// trace-time constants of the Pallas kernel; every slot index is then a
// literal and the accumulators stay in registers.
#include <cuda_runtime.h>

#include "common.cuh"
#include "tpufem_assemble_tables.h"

// The generated header defines:
//   TPUFEM_ASM_K                   number of stencil offsets
//   TPUFEM_ASM_FOR_TA(X)           X(t, a, sz, sy, sx, k0, k1, k2, k3) per
//                                  (type, local row): the row's store shift
//                                  and the slots of its four entries

namespace {

using tpufem::add_rn;
using tpufem::mul_rn;

template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b) {
  return add_rn(a, -b);  // negation is exact
}
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }

// Entry (A, B) of one tetrahedron's stiffness added into acc[KB].
template <typename T, int A, int B, int KB>
__device__ __forceinline__ void add_entry(const T (&G)[4][3], T vol,
                                          T (&acc)[TPUFEM_ASM_K]) {
  const T dot = add_rn(add_rn(mul_rn(G[A][0], G[B][0]),
                              mul_rn(G[A][1], G[B][1])),
                       mul_rn(G[A][2], G[B][2]));
  acc[KB] = add_rn(acc[KB], mul_rn(dot, vol));
}

template <typename T>
__device__ __forceinline__ T cofactor(T a, T b, T c, T e) {
  return sub_rn(mul_rn(a, b), mul_rn(c, e));
}

// Row A of one tetrahedron's P1 stiffness into acc[K0..K3].  V[n][d]:
// coordinate d (x, y, z) of vertex n.  The formulas and their order are
// assemble.planar.p1_gradients / p1_stiffness_views'.
template <typename T, int A, int K0, int K1, int K2, int K3>
__device__ __forceinline__ void tet_row(const T (&V)[4][3],
                                        T (&acc)[TPUFEM_ASM_K]) {
  T J[3][3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int m = 0; m < 3; ++m) J[d][m] = sub_rn(V[m][d], V[3][d]);
  }
  const T c00 = cofactor(J[1][1], J[2][2], J[1][2], J[2][1]);
  const T c01 = cofactor(J[1][2], J[2][0], J[1][0], J[2][2]);
  const T c02 = cofactor(J[1][0], J[2][1], J[1][1], J[2][0]);
  const T det = add_rn(add_rn(mul_rn(J[0][0], c00), mul_rn(J[0][1], c01)),
                       mul_rn(J[0][2], c02));
  const T inv_det = rcp_rn(det);
  const T c10 = cofactor(J[0][2], J[2][1], J[0][1], J[2][2]);
  const T c11 = cofactor(J[0][0], J[2][2], J[0][2], J[2][0]);
  const T c12 = cofactor(J[0][1], J[2][0], J[0][0], J[2][1]);
  const T c20 = cofactor(J[0][1], J[1][2], J[0][2], J[1][1]);
  const T c21 = cofactor(J[0][2], J[1][0], J[0][0], J[1][2]);
  const T c22 = cofactor(J[0][0], J[1][1], J[0][1], J[1][0]);
  // G[n][d] = d phi_n / d x_d: rows of J^-1 (adjugate / det), last = -sum
  T G[4][3] = {
      {mul_rn(c00, inv_det), mul_rn(c10, inv_det), mul_rn(c20, inv_det)},
      {mul_rn(c01, inv_det), mul_rn(c11, inv_det), mul_rn(c21, inv_det)},
      {mul_rn(c02, inv_det), mul_rn(c12, inv_det), mul_rn(c22, inv_det)},
      {T(0), T(0), T(0)}};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    G[3][d] = -add_rn(add_rn(G[0][d], G[1][d]), G[2][d]);
  }
  const T vol = mul_rn(det < T(0) ? -det : det, T(1.0 / 6.0));
  add_entry<T, A, 0, K0>(G, vol, acc);
  add_entry<T, A, 1, K1>(G, vol, acc);
  add_entry<T, A, 2, K2>(G, vol, acc);
  add_entry<T, A, 3, K3>(G, vol, acc);
}

template <typename T>
__global__ void __launch_bounds__(tpufem::kBlock)
assemble_kernel(const T* __restrict__ X, T* __restrict__ data, int S0,
                int S1, int S2, int m0, int m1, int m2) {
  const long long ns = static_cast<long long>(S0) * S1 * S2;
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= ns) return;
  const int sx = static_cast<int>(idx % S2);
  const int sy = static_cast<int>((idx / S2) % S1);
  const int sz = static_cast<int>(idx / (static_cast<long long>(S1) * S2));

  T acc[TPUFEM_ASM_K];
#pragma unroll
  for (int k = 0; k < TPUFEM_ASM_K; ++k) acc[k] = T(0);

#define TPUFEM_ASM_TERM(t, a, dz, dy, dx, k0, k1, k2, k3)                  \
  {                                                                        \
    const int cz = sz - (dz), cy = sy - (dy), cx = sx - (dx);              \
    if (cz >= 0 && cz < m0 && cy >= 0 && cy < m1 && cx >= 0 && cx < m2) {  \
      const T* Xt = X + static_cast<long long>(t) * 12 * ns +              \
                    (static_cast<long long>(cz) * S1 + (cy + 1)) * S2 +    \
                    (cx + 1);                                              \
      T V[4][3];                                                           \
      for (int n = 0; n < 4; ++n) {                                        \
        for (int d = 0; d < 3; ++d) V[n][d] = Xt[(n * 3 + d) * ns];        \
      }                                                                    \
      tet_row<T, a, k0, k1, k2, k3>(V, acc);                               \
    }                                                                      \
  }
  TPUFEM_ASM_FOR_TA(TPUFEM_ASM_TERM)
#undef TPUFEM_ASM_TERM

#pragma unroll
  for (int k = 0; k < TPUFEM_ASM_K; ++k) data[k * ns + idx] = acc[k];
}

template <typename T>
int launch(const T* X, T* data, int S0, int S1, int S2, int m0, int m1,
           int m2, void* stream) {
  const long long ns = static_cast<long long>(S0) * S1 * S2;
  assemble_kernel<T><<<tpufem::num_blocks(ns), tpufem::kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      X, data, S0, S1, S2, m0, m1, m2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// S0, S1, S2: the store grid; m0, m1, m2: cells per axis.
int tpufem_assemble_stencil_f32(const float* X, float* data, int S0, int S1,
                                int S2, int m0, int m1, int m2,
                                void* stream) {
  return launch<float>(X, data, S0, S1, S2, m0, m1, m2, stream);
}

int tpufem_assemble_stencil_f64(const double* X, double* data, int S0,
                                int S1, int S2, int m0, int m1, int m2,
                                void* stream) {
  return launch<double>(X, data, S0, S1, S2, m0, m1, m2, stream);
}

}  // extern "C"
