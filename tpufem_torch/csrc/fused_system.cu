// One-pass 3D P1 Poisson system build: stiffness + RHS + zero-Dirichlet
// elimination, from the embedded node coordinates.
//
// Replaces tpufem/ops/fused_system_pallas.py::_kernel (3D path of
// build_poisson_system_pallas).  Input C [3, S0, S1, S2] (x, y, z
// coordinate planes, node (z, y, x) at store (z+1, y+1, x+1)); outputs
// data [K, S0, S1, S2] (K = 15 stencil planes) and rhs [S0, S1, S2].
//
// B8, the same build on one z-stripe of a sharded store grid, replaces
// tpufem/dist/assembly.py::kern (the pallas_call of
// build_poisson_system_sharded).  Input the stripe's coordinates extended
// by one store plane on each side, C_ext [3, L + 2, S1, S2] (the halo
// planes come from the ring neighbours; the global ends hold zeros);
// outputs the stripe's data [K, L, S1, S2] and rhs [L, S1, S2].  The
// stripe starts at global store plane zbase, so its row sz is node z =
// zbase + sz - 1, and every mask (cell validity, the box boundary) is
// taken on global indices; a cell below the first or above the last plane
// is never valid, so the zero halo of an end shard is never read.  B8 is
// K1's kernel instantiated with kStripe, whose march starts one extended
// plane in: the stripe's halo planes are the march's warm-up and last
// coordinate planes.
//
// Bound on the card (chip_smoke.py's): bytes, the 3 coordinate planes in
// and K + 1 planes out, against 288 operations per tetrahedron (geometry,
// the stiffness, the RHS quadrature).  What bounds this design instead
// (scripts/fused_build_ablation.py, PERF.md): the separately rounded
// arithmetic, about 340 instructions a tetrahedron; the shared-memory
// traffic of the tile (14 values a tetrahedron written, 20 read, 12
// coordinates read); the node phase and the stores.
//
// The first design ran one thread per store row, which gathered
// for each of the 24 (type t, local node a) pairs the one cell whose
// local node a it is and recomputed that tetrahedron's geometry and RHS
// quadrature: every tetrahedron was computed four times, 0.2848 ms at
// n=96 fp32 against a 0.0314 ms bound (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py).
//
// This design computes each tetrahedron once per tile.  A block of 256
// threads owns a tile of TX store columns by TY = 256 / TX rows and
// marches over tz store planes (the launcher's tile, fused_tiling in
// ops/fused_system_cuda.py); each thread owns one column of the tile.
//   * The coordinates arrive plane by plane with 16-byte cp.async
//     (tpufem::Stage; element by element where C is not 16-byte aligned),
//     rows y0 - 1 .. y0 + TY and a 16-byte chunk either side of the
//     columns, a plane ahead of their use, into a ring of three planes;
//     outside the store grid they read 0.
//   * A step takes the cell plane between coordinate planes p and p + 1
//     (cells whose base vertex lies on plane p), its 6 types in NR rounds
//     of TPR (1 round in fp32; 3 of 2 in fp64, whose tile then needs less
//     shared memory).  In a round the threads compute the (TY + 1) x
//     (TX + 1) cells' tetrahedra of the round's types (the tile and the
//     one cell before it in y and x, whose nodes reach into the tile),
//     the (type, cell) units spread evenly over the threads: geometry,
//     the 10 distinct entries of the symmetric element stiffness and the
//     4 RHS loads, 14 values a tetrahedron, into shared memory (zeros for
//     a cell outside the grid); a barrier; then each thread adds its
//     node's terms of those cells: a (t, a) term with za = 0 (the cell
//     lies on the node's plane) into the K + 1 accumulators of plane p,
//     one with za = 1 into those of plane p + 1.  One body of the
//     tetrahedron's code serves every type, the vertex offsets read from
//     a table in constant memory: a body per type (offsets as literals),
//     6 bodies the SM's warps ran at once, was slower (PERF.md).
//   * After the last type, plane p is complete: its two partial sums (the
//     za = 1 terms, carried from the step before, and the za = 0 terms)
//     are added, the Dirichlet epilogue runs and its K + 1 outputs are
//     stored, each a warp's 32 consecutive columns; the za = 1 sums of
//     p + 1 move down.  The march's first step (cell plane z0 - 1) only
//     warms plane z0 up.
// So each tetrahedron is computed (TY + 1)(TX + 1) / (TY TX) x (tz + 1) /
// tz times, against 4 times in the first design.
//
// Rounding and order: this source is built with -fmad=false (no fused
// multiply-add, in the kernel's formulas and in the generated RHS
// expression alike), and every formula is the plain version's
// (assemble.planar.p1_gradients, ops.fused_system_cuda._plain_rows) in its
// order, so the output equals the plain version bit for bit.  A row sums
// its za = 1 terms and its za = 0 terms apart, each group in (t, a)
// order from 0, and adds the two sums, which is how the plain version
// adds them.  (One running sum, the za = 0 terms added onto the za = 1
// ones, rounded the uniform n=96 box's fp32 stiffness so that the main
// path's error rose from 1.80e-4 to 4.75e-4; the two sums give the
// single-order build's error.)  A cell outside the grid adds zeros, which
// leave a sum unchanged (an accumulator starts at +0 and never holds -0).
// No atomics: the output is bit-reproducible.
//
// The plan tables (tet vertex offsets, target stencil slots, quadrature
// points) and the RHS function f(x, y, z) are compile-time constants from
// a generated header (tpufem_fused_tables.h), as they were trace-time
// constants of the Pallas kernel: every stencil slot is a literal and the
// accumulators stay in registers.
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"
#include "tpufem_fused_tables.h"

// The generated header defines:
//   TPUFEM_K                       number of stencil offsets
//   TPUFEM_FOR_OFFSETS(X)          X(k, dz, dy, dx) for every offset
//   TPUFEM_FOR_QP(X)               X(phi0, phi1, phi2, phi3, w) per point
//   TPUFEM_FOR_TYPES(X)            X(t, z0, y0, x0, ..., z3, y3, x3) per
//                                  type: its vertex offsets in the cell
//   TPUFEM_FOR_TA(X)               X(t, a, za, ya, xa,
//                                    z0, y0, x0, ..., z3, y3, x3,
//                                    k0, k1, k2, k3) per (type, local node)
//   template <typename T> __device__ T rhs_f(T x, T y, T z)

namespace {

using tpufem::Box;
using tpufem::chunk;

constexpr int kThreads = 256;
// values a cell holds per type: the 10 entries of the upper triangle of
// its 4 x 4 stiffness, then its 4 loads
constexpr int kEntries = 10;
constexpr int kVals = kEntries + 4;
#define TPUFEM_ONE(...) +1
constexpr int kTypes = 0 TPUFEM_FOR_TYPES(TPUFEM_ONE);
#undef TPUFEM_ONE

// Slot of stiffness entry (a, b) among the upper triangle's 10.
__host__ __device__ constexpr int entry_slot(int a, int b) {
  return a <= b ? a * 4 - a * (a - 1) / 2 + (b - a) : entry_slot(b, a);
}

__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

// A tile of TX columns by TY rows whose types are taken in NR rounds of
// TPR.  Shared memory: a ring of 3 planes, each 3 coordinates of RY rows
// by RW columns (16-byte rows), and kVals values for each of a round's
// types of each of the NCELL cells.
template <typename T, int TX, int NR>
struct Tile {
  static constexpr int TY = kThreads / TX;
  static constexpr int H = chunk<T>();
  static constexpr int RW = TX + 2 * H;   // columns x0 - H .. x0 + TX + H - 1
  static constexpr int RY = TY + 2;       // rows y0 - 1 .. y0 + TY
  static constexpr int PS = RY * RW;      // one coordinate of one plane
  static constexpr int CX = TX + 1, CY = TY + 1, NCELL = CX * CY;
  static constexpr int TPR = kTypes / NR;
  static constexpr size_t kSmem =
      (9 * size_t(PS) + size_t(TPR) * kVals * NCELL) * sizeof(T);
  // blocks an SM must hold: 2 (fp32) or 1 (fp64) with all types in one
  // round, one more with several (less shared memory a block)
  static constexpr int kMinBlocks = (sizeof(T) == 4 ? 2 : 1) + (NR > 1);
  static_assert(TX * TY == kThreads, "a column a thread");
  static_assert(kTypes % NR == 0, "whole rounds of types");
};

// The tiles (TX, NR) the launcher instantiates (fused_tiling picks one).
#define TPUFEM_FUSED_TILES(X) X(16, 3) X(32, 1)

// Each type's vertex offsets in its cell, (z, y, x) per vertex: one body
// of the tetrahedron's code serves every type.
#define TPUFEM_TYPE_VERTS(t, z0, y0, x0, z1, y1, x1, z2, y2, x2, z3, y3, x3) \
  {{z0, y0, x0}, {z1, y1, x1}, {z2, y2, x2}, {z3, y3, x3}},
__constant__ signed char kTypeVerts[kTypes][4][3] = {
    TPUFEM_FOR_TYPES(TPUFEM_TYPE_VERTS)};
#undef TPUFEM_TYPE_VERTS

// One type-t tetrahedron's 14 values into out[v * stride], v < kVals.
// lo, hi: the ring planes below and above the cell (3 coordinates, PS
// apart); j: the staged position of the cell's base vertex.
template <typename T, int RW, int PS>
__device__ __forceinline__ void tet_values(const T* lo, const T* hi, int j,
                                           int t, int rhs_mode, T* out,
                                           int stride) {
  T X[4][3];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const signed char* o = kTypeVerts[t][n];
    const T* p = (o[0] ? hi : lo) + j + o[1] * RW + o[2];
#pragma unroll
    for (int d = 0; d < 3; ++d) X[n][d] = p[d * PS];
  }
  // geometry, as assemble.planar.p1_gradients computes it
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
  const T inv_det = rcp_rn(det);
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
  const T adet = abs_of(det);
  const T vol = adet * T(1.0 / 6.0);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a; b < 4; ++b) {
      out[entry_slot(a, b) * stride] =
          (G[a][0] * G[b][0] + G[a][1] * G[b][1] + G[a][2] * G[b][2]) * vol;
    }
  }

  // the loads, each sum from 0 as the plain version's
  T facc[4] = {T(0), T(0), T(0), T(0)};
  if (rhs_mode == 0) {
    // quadrature: sum_q f(x(q)) w_q phi_a(q)
#define TPUFEM_QP_COORD(p0, p1, p2, p3, d)                                 \
  (T(0) + T(p0) * X[0][d] + T(p1) * X[1][d] + T(p2) * X[2][d] +            \
   T(p3) * X[3][d])
#define TPUFEM_QP_TERM(p0, p1, p2, p3, w)                                  \
  {                                                                        \
    const T fq = rhs_f<T>(TPUFEM_QP_COORD(p0, p1, p2, p3, 0),              \
                          TPUFEM_QP_COORD(p0, p1, p2, p3, 1),              \
                          TPUFEM_QP_COORD(p0, p1, p2, p3, 2));             \
    constexpr double phi[4] = {p0, p1, p2, p3};                            \
    _Pragma("unroll") for (int a = 0; a < 4; ++a) facc[a] =                \
        facc[a] + fq * T((w) * phi[a]);                                    \
  }
    TPUFEM_FOR_QP(TPUFEM_QP_TERM)
#undef TPUFEM_QP_TERM
#undef TPUFEM_QP_COORD
  } else {
    // interp: the reference mass matrix times f at the vertices
    T fv[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) fv[b] = rhs_f<T>(X[b][0], X[b][1], X[b][2]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        facc[a] = facc[a] + T((a == b ? 2.0 : 1.0) / 120.0) * fv[b];
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) out[(kEntries + a) * stride] = facc[a] * adet;
}

// The cell phase of round r: the tetrahedra of types r TPR .. r TPR +
// TPR - 1 of each of the tile's NCELL cells of the cell plane between
// ring planes lo and hi, into vals (kVals planes of NCELL per type of the
// round), (type, cell) units spread evenly over the threads.  Cell
// (ly, lx) has its base vertex at store row y0 - 1 + ly, column
// x0 - 1 + lx; zok: the cell plane lies in the grid.
template <typename T, int TX, int NR>
__device__ __forceinline__ void cell_phase(const T* lo, const T* hi,
                                           T* vals, int r, int y0, int x0,
                                           bool zok, int m1, int m2,
                                           int rhs_mode) {
  using Tl = Tile<T, TX, NR>;
  for (int u = threadIdx.x; u < Tl::TPR * Tl::NCELL; u += kThreads) {
    const int tr = u / Tl::NCELL, c = u - tr * Tl::NCELL;
    const int ly = c / Tl::CX, lx = c - ly * Tl::CX;
    const bool ok = zok &&
                    static_cast<unsigned>(y0 + ly - 2) <
                        static_cast<unsigned>(m1) &&
                    static_cast<unsigned>(x0 + lx - 2) <
                        static_cast<unsigned>(m2);
    T* out = vals + tr * kVals * Tl::NCELL + c;
    if (!ok) {
#pragma unroll
      for (int v = 0; v < kVals; ++v) out[v * Tl::NCELL] = T(0);
      continue;
    }
    tet_values<T, Tl::RW, Tl::PS>(lo, hi, ly * Tl::RW + lx + Tl::H - 1,
                                  r * Tl::TPR + tr, rhs_mode, out,
                                  Tl::NCELL);
  }
}

// A (t, a) term of a node: row a of the cell at (ya, xa) before the
// node's own cell position v (type t's kVals planes of NCELL, row length
// CX) into acc[K0..K3] and the load into acc[TPUFEM_K].
template <typename T, int CX, int NCELL, int A, int YA, int XA, int K0,
          int K1, int K2, int K3>
__device__ __forceinline__ void add_term(const T* v, T (&acc)[TPUFEM_K + 1]) {
  const T* c = v - YA * CX - XA;
  acc[K0] = acc[K0] + c[entry_slot(A, 0) * NCELL];
  acc[K1] = acc[K1] + c[entry_slot(A, 1) * NCELL];
  acc[K2] = acc[K2] + c[entry_slot(A, 2) * NCELL];
  acc[K3] = acc[K3] + c[entry_slot(A, 3) * NCELL];
  acc[TPUFEM_K] = acc[TPUFEM_K] + c[(kEntries + A) * NCELL];
}

// The node phase of round r: the node's (t, a) terms of the round's
// types in (t, a) order, za = 0 into the plane of the cells (cur), za = 1
// into the plane above (nxt).  v: the node's own cell position in the
// round's first type's values.
template <typename T, int TX, int NR>
__device__ __forceinline__ void node_phase(const T* v, int r,
                                           T (&cur)[TPUFEM_K + 1],
                                           T (&nxt)[TPUFEM_K + 1]) {
  using Tl = Tile<T, TX, NR>;
#define TPUFEM_NODE_TERM(t, a, za, ya, xa, z0, y0, x0, z1, y1, x1, z2, y2, \
                         x2, z3, y3, x3, k0, k1, k2, k3)                   \
  if ((t) / Tl::TPR == r) {                                                \
    const T* w = v + ((t) % Tl::TPR) * kVals * Tl::NCELL;                  \
    if constexpr (za == 0) {                                               \
      add_term<T, Tl::CX, Tl::NCELL, a, ya, xa, k0, k1, k2, k3>(w, cur);   \
    } else {                                                               \
      add_term<T, Tl::CX, Tl::NCELL, a, ya, xa, k0, k1, k2, k3>(w, nxt);   \
    }                                                                      \
  }
  TPUFEM_FOR_TA(TPUFEM_NODE_TERM)
#undef TPUFEM_NODE_TERM
}

// kStripe = false: K1 over the whole store grid (S0 planes, zbase 0).
// kStripe = true: B8 over one stripe of S0 planes starting at global store
// plane zbase, reading the extended stripe C [3, S0 + 2, S1, S2].  Block
// (bx, by, bz) owns columns bx TX .., rows by TY .. and planes bz tz ..
// (the last tile ragged in y and z).
template <typename T, bool kStripe, int TX, int NR>
__global__ void __launch_bounds__(kThreads, (Tile<T, TX, NR>::kMinBlocks))
fused_system_kernel(const T* __restrict__ C, T* __restrict__ data,
                    T* __restrict__ rhs, int S0, int S1, int S2, int m0,
                    int m1, int m2, int rhs_mode, int apply_bc, int zbase,
                    int tz, bool vec) {
  using Tl = Tile<T, TX, NR>;
  constexpr int PS = Tl::PS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);   // 3 planes x 3 coordinates
  T* vals = ring + 9 * PS;                // TPR x kVals x NCELL

  const long long plane = static_cast<long long>(S1) * S2;
  const long long ns = S0 * plane;
  // coordinate plane stride; the coordinate plane of output plane 0 and
  // the global store plane of output plane 0
  const long long nc = kStripe ? ns + 2 * plane : ns;
  const int coff = kStripe ? 1 : 0, zg0 = kStripe ? zbase : 0;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * Tl::TY;
  const int z0 = blockIdx.z * tz, z1 = min(z0 + tz, S0);
  const int sx = x0 + threadIdx.x % TX, sy = y0 + threadIdx.x / TX;
  const Box box{S0 + 2 * coff, S1, S2};
  const tpufem::Stage<T, Tl::RW, Tl::RY, kThreads> st(y0 - 1, x0 - Tl::H,
                                                      box, S2);
  // coordinate plane p (output-plane index) into ring slot `slot`
  auto stage = [&](int p, int slot) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      st.issue(ring + (3 * slot + d) * PS, C + d * nc, p + coff, box, S1,
               S2, y0 - 1, x0 - Tl::H, vec);
    }
  };

  // a plane's two partial sums: below, its za = 1 terms (added in the
  // step before, carried), and cur, its za = 0 terms; nxt: the za = 1
  // terms of the plane above
  T below[TPUFEM_K + 1], cur[TPUFEM_K + 1], nxt[TPUFEM_K + 1];
#pragma unroll
  for (int k = 0; k <= TPUFEM_K; ++k) below[k] = cur[k] = nxt[k] = T(0);
  // this thread's cell position: its node's cell (ya = xa = 0)
  const int me = (threadIdx.x / TX + 1) * Tl::CX + threadIdx.x % TX + 1;

  stage(z0 - 1, 0);
  tpufem::cp_async_commit();
  stage(z0, 1);
  tpufem::cp_async_commit();
  const int steps = z1 - z0 + 1;
  for (int s = 0; s < steps; ++s) {
    // cell plane p: coordinate planes p and p + 1 are in slots s and s + 1
    const int p = z0 - 1 + s;
    tpufem::cp_async_wait_all();
    __syncthreads();
    if (s + 2 <= steps) stage(p + 2, (s + 2) % 3);
    tpufem::cp_async_commit();
    const T* lo = ring + 3 * (s % 3) * PS;
    const T* hi = ring + 3 * ((s + 1) % 3) * PS;
    const int cz = zg0 + p - 1;   // the cells' global z
    const bool zok = cz >= 0 && cz < m0;
#pragma unroll 1
    for (int r = 0; r < NR; ++r) {
      if (r > 0) __syncthreads();   // the last round's values are read
      cell_phase<T, TX, NR>(lo, hi, vals, r, y0, x0, zok, m1, m2, rhs_mode);
      __syncthreads();
      node_phase<T, TX, NR>(vals + me, r, cur, nxt);
    }

    if (s > 0 && sy < S1) {
      // plane p is complete: join its partial sums, eliminate, store
#pragma unroll
      for (int k = 0; k <= TPUFEM_K; ++k) cur[k] = below[k] + cur[k];
      const int nz = zg0 + p - 1, ny = sy - 1, nx = sx - 1;
      if (apply_bc) {
        // zero-Dirichlet elimination on the box boundary: Dirichlet rows
        // become identity rows with zero load, couplings into Dirichlet
        // columns vanish
        auto on_bd = [&](int z, int y, int x) {
          const bool inside = z >= 0 && z <= m0 && y >= 0 && y <= m1 &&
                              x >= 0 && x <= m2;
          return inside && (z == 0 || z == m0 || y == 0 || y == m1 ||
                            x == 0 || x == m2);
        };
        const bool bc_row = on_bd(nz, ny, nx);
#define TPUFEM_BC_TERM(k, dz, dy, dx)                                       \
  if (bc_row) {                                                             \
    cur[k] = ((dz) == 0 && (dy) == 0 && (dx) == 0) ? T(1) : T(0);           \
  } else if (on_bd(nz + (dz), ny + (dy), nx + (dx))) {                      \
    cur[k] = T(0);                                                          \
  }
        TPUFEM_FOR_OFFSETS(TPUFEM_BC_TERM)
#undef TPUFEM_BC_TERM
        if (bc_row) cur[TPUFEM_K] = T(0);
      }
      const long long row = p * plane + static_cast<long long>(sy) * S2 + sx;
#pragma unroll
      for (int k = 0; k < TPUFEM_K; ++k) data[k * ns + row] = cur[k];
      rhs[row] = cur[TPUFEM_K];
    }
#pragma unroll
    for (int k = 0; k <= TPUFEM_K; ++k) {
      below[k] = nxt[k];
      cur[k] = nxt[k] = T(0);
    }
  }
}

template <typename T, bool kStripe, int TX, int NR>
int launch_tile(const T* C, T* data, T* rhs, int S0, int S1, int S2, int m0,
                int m1, int m2, int rhs_mode, int apply_bc, int zbase,
                int tz, cudaStream_t stream) {
  using Tl = Tile<T, TX, NR>;
  const dim3 grid(S2 / TX, tpufem::ceil_div(S1, Tl::TY),
                  tpufem::ceil_div(S0, tz));
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      tpufem::allow_smem<fused_system_kernel<T, kStripe, TX, NR>>(Tl::kSmem);
  if (err != 0) return err;
  // every plane and row of C is a whole number of 16-byte chunks (S2 is a
  // multiple of TX), so its base decides the copies' width
  fused_system_kernel<T, kStripe, TX, NR>
      <<<grid, kThreads, Tl::kSmem, stream>>>(C, data, rhs, S0, S1, S2, m0, m1, m2, rhs_mode, apply_bc, zbase, tz,
      tpufem::aligned16({C}));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kStripe>
int launch(const T* C, T* data, T* rhs, int S0, int S1, int S2, int m0,
           int m1, int m2, int rhs_mode, int apply_bc, int zbase, int tx,
           int nr, int tz, void* stream) {
  // a tile of tx columns dividing the rows, tz >= 1 planes; the cells lie
  // inside the store grid's padding (a node's store index is one more)
  if (S0 < 1 || S1 < 1 || tx < 1 || S2 < tx || S2 % tx || tz < 1 ||
      m0 < 1 || m1 < 1 || m2 < 1 || m1 + 2 > S1 || m2 + 2 > S2 ||
      (rhs_mode != 0 && rhs_mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPUFEM_CASE(TX, NR)                                                 \
  if (tx == TX && nr == NR) {                                               \
    return launch_tile<T, kStripe, TX, NR>(C, data, rhs, S0, S1, S2, m0,    \
                                           m1, m2, rhs_mode, apply_bc,      \
                                           zbase, tz, s);                   \
  }
  TPUFEM_FUSED_TILES(TPUFEM_CASE)
#undef TPUFEM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
size_t smem_of(int tx, int nr) {
#define TPUFEM_CASE(TX, NR) \
  if (tx == TX && nr == NR) return Tile<T, TX, NR>::kSmem;
  TPUFEM_FUSED_TILES(TPUFEM_CASE)
#undef TPUFEM_CASE
  return 0;
}

}  // namespace

extern "C" {

// m0, m1, m2: cells per axis (node_grid - 1); rhs_mode 0 = quadrature,
// 1 = interp; tx, nr, tz: a block's columns, its rounds of types and its
// planes (fused_tiling).
int tpufem_fused_system_f32(const float* C, float* data, float* rhs, int S0,
                            int S1, int S2, int m0, int m1, int m2,
                            int rhs_mode, int apply_bc, int tx, int nr, int tz,
                            void* stream) {
  return launch<float, false>(C, data, rhs, S0, S1, S2, m0, m1, m2,
                              rhs_mode, apply_bc, 0, tx, nr, tz, stream);
}

int tpufem_fused_system_f64(const double* C, double* data, double* rhs,
                            int S0, int S1, int S2, int m0, int m1, int m2,
                            int rhs_mode, int apply_bc, int tx, int nr, int tz,
                            void* stream) {
  return launch<double, false>(C, data, rhs, S0, S1, S2, m0, m1, m2,
                               rhs_mode, apply_bc, 0, tx, nr, tz, stream);
}

// B8: C_ext [3, L + 2, S1, S2], data [K, L, S1, S2], rhs [L, S1, S2]; the
// stripe's first plane is global store plane zbase; m0, m1, m2 are the
// global cell counts.
int tpufem_fused_system_stripe_f32(const float* C_ext, float* data,
                                   float* rhs, int L, int S1, int S2,
                                   int m0, int m1, int m2, int rhs_mode,
                                   int apply_bc, int zbase, int tx, int nr,
                                   int tz,
                                   void* stream) {
  return launch<float, true>(C_ext, data, rhs, L, S1, S2, m0, m1, m2,
                             rhs_mode, apply_bc, zbase, tx, nr, tz, stream);
}

int tpufem_fused_system_stripe_f64(const double* C_ext, double* data,
                                   double* rhs, int L, int S1, int S2,
                                   int m0, int m1, int m2, int rhs_mode,
                                   int apply_bc, int zbase, int tx, int nr,
                                   int tz,
                                   void* stream) {
  return launch<double, true>(C_ext, data, rhs, L, S1, S2, m0, m1, m2,
                              rhs_mode, apply_bc, zbase, tx, nr, tz, stream);
}

// Dynamic shared memory (bytes) of a block of tx columns and nr rounds of
// types with values of itemsize bytes (4 or 8); -1 for a tile the
// launcher has no kernel for.
int tpufem_fused_smem(int itemsize, int tx, int nr) {
  const size_t bytes = itemsize == 4   ? smem_of<float>(tx, nr)
                       : itemsize == 8 ? smem_of<double>(tx, nr)
                                       : 0;
  return bytes > 0 ? static_cast<int>(bytes) : -1;
}

}  // extern "C"
