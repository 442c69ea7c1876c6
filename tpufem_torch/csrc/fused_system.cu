// One-pass 3D P1 Poisson system build: stiffness + RHS + zero-Dirichlet
// elimination, from the embedded node coordinates.
//
// Replaces tpufem/ops/fused_system_pallas.py::_kernel (3D path of
// build_poisson_system_pallas).  Input C [3, S0, S1, S2] (x, y, z
// coordinate planes, node (z, y, x) at store (z+1, y+1, x+1)); outputs
// data [K, S0, S1, S2] (K = 15 stencil planes) and rhs [S0, S1, S2].
//
// Bound on the card: bytes (3 coordinate planes in, K+1 planes out) plus
// about 100 flops per tet-entry (Jacobian, det, inverse, the 4x4 stiffness
// row, the quadrature of f).  Design: owner-computes.  One thread per
// output node gathers, for every (type t, local node a), the one cell whose
// local node a it is, recomputes that tet's geometry from the coordinates
// (L1/L2 hits: neighbouring threads share cells) and accumulates its row a
// into K registers.  No atomics, so the output is bit-reproducible; no
// TPU roll wrap-around either: a cell outside the grid is simply skipped
// (its volume was masked to zero on the TPU).  The plan tables (tet
// vertex offsets, target stencil slots, quadrature points) and the RHS
// function f(x, y, z) are compile-time constants from a generated header
// (tpufem_fused_tables.h), as they were trace-time constants of the Pallas
// kernel; every slot index is then a literal and the K accumulators stay in
// registers.  Boundary masks come from the node indices.
//
// B8, the same build on one z-stripe of a sharded store grid, replaces
// tpufem/dist/assembly.py::kern (the pallas_call of
// build_poisson_system_sharded).  Input the stripe's coordinates extended
// by one store plane on each side, C_ext [3, L + 2, S1, S2] (the halo
// planes come from the ring neighbours; the global ends hold zeros);
// outputs the stripe's data [K, L, S1, S2] and rhs [L, S1, S2].  The
// stripe starts at global store plane zbase, so its row sz is node z =
// zbase + sz - 1, and every mask (cell validity, the box boundary) is
// taken on global indices; a cell below the first or above the last
// plane is never valid, so the zero halo of an end shard is never read.
// One plane of halo is all a row needs (its cells reach one plane either
// way), against the TPU kernel's one z-block.  B8 is K1's kernel
// instantiated with kStripe: the same tet_row and the same order, so P
// stripes, concatenated, equal K1's planes bit for bit.  Bound as K1's:
// bytes, the stripe's 3 extended coordinate planes in and K + 1 planes
// out.
#include <cuda_runtime.h>

#include "common.cuh"
#include "tpufem_fused_tables.h"

// The generated header defines:
//   TPUFEM_K                       number of stencil offsets
//   TPUFEM_FOR_OFFSETS(X)          X(k, dz, dy, dx) for every offset
//   TPUFEM_FOR_QP(X)               X(phi0, phi1, phi2, phi3, w) per point
//   TPUFEM_FOR_TA(X)               X(t, a, za, ya, xa,
//                                    z0, y0, x0, ..., z3, y3, x3,
//                                    k0, k1, k2, k3) per (type, local node)
//   template <typename T> __device__ T rhs_f(T x, T y, T z)

namespace {

template <int A>
__device__ __forceinline__ constexpr double pick4(double p0, double p1,
                                                  double p2, double p3) {
  return A == 0 ? p0 : (A == 1 ? p1 : (A == 2 ? p2 : p3));
}

// Row A of one tet's stiffness into acc[K0..K3]; its load into racc.
// X[m][d]: coordinate d (x, y, z) of vertex m.
template <typename T, int A, int K0, int K1, int K2, int K3>
__device__ __forceinline__ void tet_row(const T (&X)[4][3],
                                        T (&acc)[TPUFEM_K], T& racc,
                                        int rhs_mode) {
  T J[3][3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int m = 0; m < 3; ++m) J[d][m] = X[m][d] - X[3][d];
  }
  const T c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
  const T c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
  const T c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
  const T det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
  const T inv_det = T(1) / det;
  const T c10 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
  const T c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
  const T c12 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
  const T c20 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
  const T c21 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
  const T c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
  // G[n][d] = d phi_n / d x_d: rows of J^-1 (adjugate / det), last = -sum
  T G[4][3] = {{c00 * inv_det, c10 * inv_det, c20 * inv_det},
               {c01 * inv_det, c11 * inv_det, c21 * inv_det},
               {c02 * inv_det, c12 * inv_det, c22 * inv_det},
               {T(0), T(0), T(0)}};
#pragma unroll
  for (int d = 0; d < 3; ++d) G[3][d] = -(G[0][d] + G[1][d] + G[2][d]);
  const T adet = det < T(0) ? -det : det;
  const T vol = adet * T(1.0 / 6.0);
  acc[K0] += (G[A][0] * G[0][0] + G[A][1] * G[0][1] + G[A][2] * G[0][2]) * vol;
  acc[K1] += (G[A][0] * G[1][0] + G[A][1] * G[1][1] + G[A][2] * G[1][2]) * vol;
  acc[K2] += (G[A][0] * G[2][0] + G[A][1] * G[2][1] + G[A][2] * G[2][2]) * vol;
  acc[K3] += (G[A][0] * G[3][0] + G[A][1] * G[3][1] + G[A][2] * G[3][2]) * vol;

  T facc = T(0);
  if (rhs_mode == 0) {
    // quadrature: sum_q w_q phi_A(q) f(x(q))
#define TPUFEM_QP_COORD(p0, p1, p2, p3, d) \
  (T(p0) * X[0][d] + T(p1) * X[1][d] + T(p2) * X[2][d] + T(p3) * X[3][d])
#define TPUFEM_QP_TERM(p0, p1, p2, p3, w)                                  \
  facc += rhs_f<T>(TPUFEM_QP_COORD(p0, p1, p2, p3, 0),                     \
                   TPUFEM_QP_COORD(p0, p1, p2, p3, 1),                     \
                   TPUFEM_QP_COORD(p0, p1, p2, p3, 2)) *                   \
          T((w) * pick4<A>(p0, p1, p2, p3));
    TPUFEM_FOR_QP(TPUFEM_QP_TERM)
#undef TPUFEM_QP_TERM
#undef TPUFEM_QP_COORD
  } else {
    // interp: reference mass matrix times f at the vertices
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      facc += T((A == b ? 2.0 : 1.0) / 120.0) *
              rhs_f<T>(X[b][0], X[b][1], X[b][2]);
    }
  }
  racc += facc * adet;
}

// kStripe = false: K1 over the whole store grid (S0 planes, zbase 0).
// kStripe = true: B8 over one stripe of S0 planes starting at global store
// plane zbase, reading the extended stripe C [3, S0 + 2, S1, S2].
template <typename T, bool kStripe>
__global__ void __launch_bounds__(tpufem::kBlock)
fused_system_kernel(const T* __restrict__ C, T* __restrict__ data,
                    T* __restrict__ rhs, int S0, int S1, int S2, int m0,
                    int m1, int m2, int rhs_mode, int apply_bc, int zbase) {
  const long long ns = static_cast<long long>(S0) * S1 * S2;
  // coordinate plane stride, and the extended index of global store
  // plane 0 (the stripe's first plane sits at extended plane 1)
  const long long nc = kStripe ? ns + 2LL * S1 * S2 : ns;
  const long long c0 = kStripe ? (1LL - zbase) * S1 * S2 : 0;
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= ns) return;
  const int sx = static_cast<int>(idx % S2);
  const int sy = static_cast<int>((idx / S2) % S1);
  const int sz = static_cast<int>(idx / (static_cast<long long>(S1) * S2));
  // global node indices of this row (cells run 0 <= c < m per axis)
  const int nz = (kStripe ? zbase : 0) + sz - 1, ny = sy - 1, nx = sx - 1;

  T acc[TPUFEM_K];
#pragma unroll
  for (int k = 0; k < TPUFEM_K; ++k) acc[k] = T(0);
  T racc = T(0);

#define TPUFEM_VERTEX(m, z, y, x)                                           \
  {                                                                         \
    const long long v = cell + (static_cast<long long>(z) * S1 + (y)) * S2 + \
                        (x);                                                \
    X[m][0] = C[v];                                                         \
    X[m][1] = C[nc + v];                                                    \
    X[m][2] = C[2 * nc + v];                                                \
  }
#define TPUFEM_TA_TERM(t, a, za, ya, xa, z0, y0, x0, z1, y1, x1, z2, y2,    \
                       x2, z3, y3, x3, k0, k1, k2, k3)                      \
  {                                                                         \
    const int cz = nz - (za), cy = ny - (ya), cx = nx - (xa);               \
    if (cz >= 0 && cz < m0 && cy >= 0 && cy < m1 && cx >= 0 && cx < m2) {   \
      const long long cell =                                                \
          c0 +                                                              \
          (static_cast<long long>(cz + 1) * S1 + (cy + 1)) * S2 + (cx + 1); \
      T X[4][3];                                                            \
      TPUFEM_VERTEX(0, z0, y0, x0)                                          \
      TPUFEM_VERTEX(1, z1, y1, x1)                                          \
      TPUFEM_VERTEX(2, z2, y2, x2)                                          \
      TPUFEM_VERTEX(3, z3, y3, x3)                                          \
      tet_row<T, a, k0, k1, k2, k3>(X, acc, racc, rhs_mode);                \
    }                                                                       \
  }
  TPUFEM_FOR_TA(TPUFEM_TA_TERM)
#undef TPUFEM_TA_TERM
#undef TPUFEM_VERTEX

  if (apply_bc) {
    // zero-Dirichlet elimination on the box boundary: Dirichlet rows become
    // identity rows with zero load, couplings into Dirichlet columns vanish
    auto on_bd = [&](int z, int y, int x) {
      const bool inside = z >= 0 && z <= m0 && y >= 0 && y <= m1 && x >= 0 &&
                          x <= m2;
      return inside &&
             (z == 0 || z == m0 || y == 0 || y == m1 || x == 0 || x == m2);
    };
    const bool bc_row = on_bd(nz, ny, nx);
#define TPUFEM_BC_TERM(k, dz, dy, dx)                                       \
  if (bc_row) {                                                             \
    acc[k] = ((dz) == 0 && (dy) == 0 && (dx) == 0) ? T(1) : T(0);           \
  } else if (on_bd(nz + (dz), ny + (dy), nx + (dx))) {                      \
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

template <typename T, bool kStripe>
int launch(const T* C, T* data, T* rhs, int S0, int S1, int S2, int m0,
           int m1, int m2, int rhs_mode, int apply_bc, int zbase,
           void* stream) {
  const long long ns = static_cast<long long>(S0) * S1 * S2;
  fused_system_kernel<T, kStripe><<<tpufem::num_blocks(ns), tpufem::kBlock,
                                    0, static_cast<cudaStream_t>(stream)>>>(
      C, data, rhs, S0, S1, S2, m0, m1, m2, rhs_mode, apply_bc, zbase);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// m0, m1, m2: cells per axis (node_grid - 1); rhs_mode 0 = quadrature,
// 1 = interp.
int tpufem_fused_system_f32(const float* C, float* data, float* rhs, int S0,
                            int S1, int S2, int m0, int m1, int m2,
                            int rhs_mode, int apply_bc, void* stream) {
  return launch<float, false>(C, data, rhs, S0, S1, S2, m0, m1, m2,
                              rhs_mode, apply_bc, 0, stream);
}

int tpufem_fused_system_f64(const double* C, double* data, double* rhs,
                            int S0, int S1, int S2, int m0, int m1, int m2,
                            int rhs_mode, int apply_bc, void* stream) {
  return launch<double, false>(C, data, rhs, S0, S1, S2, m0, m1, m2,
                               rhs_mode, apply_bc, 0, stream);
}

// B8: C_ext [3, L + 2, S1, S2], data [K, L, S1, S2], rhs [L, S1, S2]; the
// stripe's first plane is global store plane zbase; m0, m1, m2 are the
// global cell counts.
int tpufem_fused_system_stripe_f32(const float* C_ext, float* data,
                                   float* rhs, int L, int S1, int S2,
                                   int m0, int m1, int m2, int rhs_mode,
                                   int apply_bc, int zbase, void* stream) {
  return launch<float, true>(C_ext, data, rhs, L, S1, S2, m0, m1, m2,
                             rhs_mode, apply_bc, zbase, stream);
}

int tpufem_fused_system_stripe_f64(const double* C_ext, double* data,
                                   double* rhs, int L, int S1, int S2,
                                   int m0, int m1, int m2, int rhs_mode,
                                   int apply_bc, int zbase, void* stream) {
  return launch<double, true>(C_ext, data, rhs, L, S1, S2, m0, m1, m2,
                              rhs_mode, apply_bc, zbase, stream);
}

}  // extern "C"
