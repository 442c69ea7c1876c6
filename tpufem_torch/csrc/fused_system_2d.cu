// One-pass 2D P1 Poisson system build: stiffness + RHS + zero-Dirichlet
// elimination, from the embedded node coordinates.  Kernel B7.
//
// Replaces tpufem/ops/fused_system_pallas.py::_kernel_2d (the 2D path of
// build_poisson_system_pallas, launched from _build_2d).  Input C [2, S0,
// S1] (x, y coordinate planes, node (y, x) at store (y+1, x+1)); outputs
// data [K, S0, S1] (K = 7 stencil planes: the axes and the anti-diagonal
// of the cell split) and rhs [S0, S1].
//
// Bound on the card (chip_smoke.py's): bytes, 2 coordinate planes in and
// K + 1 planes out, against about 104 operations a triangle (geometry,
// the 6 distinct stiffness entries, the RHS quadrature at 3 points).  What
// bounds this design (scripts/structured_build_ablation.py, PERF.md): the
// separately rounded arithmetic of the cell phase, then the node phase's
// stores, which overlap it only partly.
//
// The first design ran one thread per store row, which for each of the
// 6 (type t, local node a) pairs reloaded the 6 coordinates of the one
// triangle whose local node a it is and recomputed that triangle,
// quadrature included: every triangle was computed 3 times, 0.0392 ms at
// n=1024 fp32 against a 0.0142 ms bound (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py), with nvcc's contraction into fused multiply-adds.
//
// This design computes each triangle once per tile, K1's pattern
// (fused_system.cu) one dimension down.  A block of TX threads takes TX
// consecutive cells of a row, one a thread, and completes the TX - 1
// store columns whose two cells those are (tiles overlap by a cell; the
// first tile also completes column 0), marching down a band of store rows
// (fused_2d_tiling in ops/fused_system_cuda.py).  A step takes one cell
// row c:
//   * cell phase: each thread loads its cell's 4 corners' coordinates
//     (coalesced along x) and computes its two triangles once: the 6
//     distinct entries of each symmetric 3 x 3 stiffness and the 3 loads
//     (the quadrature of f, or the interp mass row), 9 values a triangle,
//     into a ring of three cell rows in shared memory.  A cell outside the
//     cell grid is skipped by its index: it is not computed and its
//     values are not read.  The ring's third row lets one barrier a step
//     suffice.
//   * node phase: store row c + 1 (its cells of row c, ya = 0, and of row
//     c - 1, ya = 1) is complete: each thread adds its node's 6 (t, a)
//     terms in order, runs the zero-Dirichlet elimination and stores its
//     K + 1 outputs, a warp's 32 consecutive columns at a time.  The
//     march's first step (cell row y0 - 2) only fills the ring.
// So each triangle is computed TX / (TX - 1) x (rows + 1) / rows times,
// against 3 times in the first design.  Tiles of TX columns with TX + 1
// cells (a thread a column, and one more thread or warp for the cell
// before the tile) measured slower: the extra cell's work fell to one
// warp a block (PERF.md).
//
// Rounding and order: this source is built with -fmad=false (no fused
// multiply-add, in the kernel's formulas and in the generated RHS
// expression alike), and every formula is the plain version's
// (assemble.planar.p1_gradients and _det_inv_2x2, the quadrature sum of
// ops.fused_system_cuda._plain_rows) in its order, each sum of the plain
// version's Python sum() starting from 0 as there; a row sums its terms
// in (t, a, b) order, as the plain version adds them.  So the output
// equals build_poisson_system_plain bit for bit.  No atomics: it is
// bit-reproducible.  The plan tables (triangle vertex offsets, target
// stencil slots, quadrature points) and f(x, y) come from a generated
// header (tpufem_fused_tables.h), as trace-time constants of the Pallas
// kernel; boundary masks come from the node indices.
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"
#include "tpufem_fused_tables.h"

// The generated header defines:
//   TPUFEM_K                       number of stencil offsets (7)
//   TPUFEM_FOR_OFFSETS(X)          X(k, dy, dx) for every offset
//   TPUFEM_FOR_QP(X)               X(phi0, phi1, phi2, w) per point
//   TPUFEM_FOR_TYPES(X)            X(t, y0, x0, y1, x1, y2, x2) per type:
//                                  its vertex offsets in the cell
//   TPUFEM_FOR_TA(X)               X(t, a, ya, xa, y0, x0, y1, x1, y2, x2,
//                                    k0, k1, k2) per (type, local node)
//   template <typename T> __device__ T rhs_f(T x, T y)

namespace {

// values a cell holds per type: the 6 entries of the upper triangle of
// its 3 x 3 stiffness, then its 3 loads
constexpr int kEntries = 6;
constexpr int kVals = kEntries + 3;
#define TPUFEM_ONE(...) +1
constexpr int kTypes = 0 TPUFEM_FOR_TYPES(TPUFEM_ONE);
#undef TPUFEM_ONE
constexpr int kRing = 3;   // cell rows in shared memory

// Slot of stiffness entry (a, b) among the upper triangle's 6.
__host__ __device__ constexpr int entry_slot(int a, int b) {
  return a <= b ? a * 3 - a * (a - 1) / 2 + (b - a) : entry_slot(b, a);
}

__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

// A tile of TX threads, one a cell of the row, which completes the TX - 1
// columns whose two cells those are (tiles overlap by a cell).  Shared
// memory: a ring of kRing cell rows, kVals values for each type of each of
// the TX cells.
template <typename T, int TX>
struct Tile {
  static constexpr int STRIDE = TX - 1;   // columns a tile completes
  static constexpr int ROW = kTypes * kVals * TX;   // one cell row
  static constexpr size_t kSmem = size_t(kRing) * ROW * sizeof(T);
  // blocks an SM must hold: 1024 fp32 or 512 fp64 threads' registers
  static constexpr int kMinBlocks = (sizeof(T) == 4 ? 1024 : 512) / TX;
};

// The tiles TX the launcher instantiates (fused_2d_tiling picks one).
#define TPUFEM_2D_TILES(X) X(64)

// One triangle's 9 values into out[v * stride]: X[m][d] coordinate d (x,
// y) of vertex m.
template <typename T>
__device__ __forceinline__ void tri_values(const T (&X)[3][2], int rhs_mode,
                                           T* out, int stride) {
  // geometry, as assemble.planar.p1_gradients / _det_inv_2x2 compute it
  const T j00 = X[0][0] - X[2][0], j01 = X[1][0] - X[2][0];
  const T j10 = X[0][1] - X[2][1], j11 = X[1][1] - X[2][1];
  const T det = j00 * j11 - j01 * j10;
  const T inv_det = rcp_rn(det);
  // G[n][d] = d phi_n / d x_d: rows of J^-1, last = -(0 + sum)
  const T g00 = j11 * inv_det, g01 = -j01 * inv_det;
  const T g10 = -j10 * inv_det, g11 = j00 * inv_det;
  const T G[3][2] = {{g00, g01},
                     {g10, g11},
                     {-(T(0) + g00 + g10), -(T(0) + g01 + g11)}};
  const T adet = abs_of(det);
  const T area = adet * T(0.5);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = a; b < 3; ++b) {
      out[entry_slot(a, b) * stride] =
          (T(0) + G[a][0] * G[b][0] + G[a][1] * G[b][1]) * area;
    }
  }

  // the loads, each sum from 0 as the plain version's
  T facc[3] = {T(0), T(0), T(0)};
  if (rhs_mode == 0) {
    // quadrature: sum_q f(x(q)) w_q phi_a(q)
#define TPUFEM_QP_COORD(p0, p1, p2, d) \
  (T(0) + T(p0) * X[0][d] + T(p1) * X[1][d] + T(p2) * X[2][d])
#define TPUFEM_QP_TERM(p0, p1, p2, w)                                      \
  {                                                                        \
    const T fq = rhs_f<T>(TPUFEM_QP_COORD(p0, p1, p2, 0),                  \
                          TPUFEM_QP_COORD(p0, p1, p2, 1));                 \
    constexpr double phi[3] = {p0, p1, p2};                                \
    _Pragma("unroll") for (int a = 0; a < 3; ++a) facc[a] =                \
        facc[a] + fq * T((w) * phi[a]);                                    \
  }
    TPUFEM_FOR_QP(TPUFEM_QP_TERM)
#undef TPUFEM_QP_TERM
#undef TPUFEM_QP_COORD
  } else {
    // interp: the reference mass matrix (1 + delta_ab) / 24 times f at
    // the vertices
    T fv[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) fv[b] = rhs_f<T>(X[b][0], X[b][1]);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b)
        facc[a] = facc[a] + T((a == b ? 2.0 : 1.0) / 24.0) * fv[b];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) out[(kEntries + a) * stride] = facc[a] * adet;
}

// The cell phase of cell row c into ring row `row` (kVals planes of TX
// per type): thread lx computes cell (c, xc + lx), whose corner (y, x) is
// node (c + y, xc + lx + x) at store (c + 1 + y, xc + 1 + lx + x).  A
// cell outside the grid is skipped.
template <typename T, int TX>
__device__ __forceinline__ void cell_phase(const T* __restrict__ C, T* row,
                                           int c, int xc, int m1,
                                           long long ns, int S1,
                                           int rhs_mode) {
  const int lx = threadIdx.x, cx = xc + lx;
  if (static_cast<unsigned>(cx) >= static_cast<unsigned>(m1)) return;
  const T* p = C + static_cast<long long>(c + 1) * S1 + (cx + 1);
  T Q[2][2][2];   // corner (y, x), coordinate d
#pragma unroll
  for (int y = 0; y < 2; ++y) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      Q[y][x][0] = p[y * S1 + x];
      Q[y][x][1] = p[ns + y * S1 + x];
    }
  }
#define TPUFEM_TYPE_TRI(t, y0, x0, y1, x1, y2, x2)                          \
  {                                                                         \
    const T X[3][2] = {{Q[y0][x0][0], Q[y0][x0][1]},                        \
                       {Q[y1][x1][0], Q[y1][x1][1]},                        \
                       {Q[y2][x2][0], Q[y2][x2][1]}};                       \
    tri_values<T>(X, rhs_mode, row + (t) * kVals * TX + lx, TX);            \
  }
  TPUFEM_FOR_TYPES(TPUFEM_TYPE_TRI)
#undef TPUFEM_TYPE_TRI
}

// Block (bx, 0, by) owns columns bx STRIDE .. and store rows by rows ..
// (the last band ragged).
template <typename T, int TX>
__global__ void __launch_bounds__(TX, (Tile<T, TX>::kMinBlocks))
fused_system_2d_kernel(const T* __restrict__ C, T* __restrict__ data,
                       T* __restrict__ rhs, int S0, int S1, int m0, int m1,
                       int rhs_mode, int apply_bc, int rows) {
  using Tl = Tile<T, TX>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);   // kRing x kTypes x kVals x TX

  const long long ns = static_cast<long long>(S0) * S1;
  const int x0 = blockIdx.x * Tl::STRIDE;
  const int y0 = blockIdx.z * rows, y1 = min(y0 + rows, S0);
  // this thread's column and node, which its cell and the one before it
  // complete (the first thread's only in the first tile, column 0), and
  // the tile's first cell
  const int sx = x0 + threadIdx.x, nx = sx - 1, xc = x0 - 1;
  const bool owner = sx < S1 && (threadIdx.x > 0 || x0 == 0);
  // this thread's cell position (its node's cell, xa = 0), and which of
  // the cells (., nx - xa) before its column lie in the grid
  const int me = threadIdx.x;
  const bool in_x[2] = {static_cast<unsigned>(nx) < static_cast<unsigned>(m1),
                        static_cast<unsigned>(nx - 1) <
                            static_cast<unsigned>(m1)};
  // the elimination's column tests, the same in every row: node nx + dx
  // lies in the grid, and on its x boundary
  bool x_in[3], x_bd[3];
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    x_in[dx + 1] = nx + dx >= 0 && nx + dx <= m1;
    x_bd[dx + 1] = nx + dx == 0 || nx + dx == m1;
  }

  for (int c = y0 - 2, s = 0; c <= y1 - 2; ++c, ++s) {
    // cell row c into ring row s % kRing; the rows read by the node phase
    // of the step before (s - 1 and s - 2) are not overwritten
    const bool cin = c >= 0 && c < m0;
    if (cin) {
      cell_phase<T, TX>(C, ring + (s % kRing) * Tl::ROW, c, xc, m1, ns, S1,
                        rhs_mode);
    }
    __syncthreads();
    if (s == 0 || !owner) continue;

    // store row sy = c + 1, node ny = c: its cells (c - ya, nx - xa)
    const int sy = c + 1, ny = c;
    const bool in_y[2] = {cin, c - 1 >= 0 && c - 1 < m0};
    const T* rows_of[2] = {ring + (s % kRing) * Tl::ROW + me,
                           ring + ((s - 1) % kRing) * Tl::ROW + me};
    T acc[TPUFEM_K];
#pragma unroll
    for (int k = 0; k < TPUFEM_K; ++k) acc[k] = T(0);
    T racc = T(0);
#define TPUFEM_NODE_TERM(t, a, ya, xa, y0, x0, y1, x1, y2, x2, k0, k1, k2)   \
  if (in_y[ya] && in_x[xa]) {                                               \
    const T* v = rows_of[ya] + (t) * kVals * TX - (xa);                     \
    acc[k0] = acc[k0] + v[entry_slot(a, 0) * TX];                           \
    acc[k1] = acc[k1] + v[entry_slot(a, 1) * TX];                           \
    acc[k2] = acc[k2] + v[entry_slot(a, 2) * TX];                           \
    racc = racc + v[(kEntries + (a)) * TX];                                 \
  }
    TPUFEM_FOR_TA(TPUFEM_NODE_TERM)
#undef TPUFEM_NODE_TERM

    if (apply_bc) {
      // zero-Dirichlet elimination on the box boundary: Dirichlet rows
      // become identity rows with zero load, couplings into Dirichlet
      // columns vanish
      bool y_in[3], y_bd[3];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        y_in[dy + 1] = ny + dy >= 0 && ny + dy <= m0;
        y_bd[dy + 1] = ny + dy == 0 || ny + dy == m0;
      }
      auto on_bd = [&](int dy, int dx) {
        return y_in[dy + 1] && x_in[dx + 1] && (y_bd[dy + 1] || x_bd[dx + 1]);
      };
      const bool bc_row = on_bd(0, 0);
#define TPUFEM_BC_TERM(k, dy, dx)                                           \
  if (bc_row) {                                                             \
    acc[k] = ((dy) == 0 && (dx) == 0) ? T(1) : T(0);                        \
  } else if (on_bd(dy, dx)) {                                               \
    acc[k] = T(0);                                                          \
  }
      TPUFEM_FOR_OFFSETS(TPUFEM_BC_TERM)
#undef TPUFEM_BC_TERM
      if (bc_row) racc = T(0);
    }
    const long long idx = static_cast<long long>(sy) * S1 + sx;
#pragma unroll
    for (int k = 0; k < TPUFEM_K; ++k) data[k * ns + idx] = acc[k];
    rhs[idx] = racc;
  }
}

template <typename T, int TX>
int launch_tile(const T* C, T* data, T* rhs, int S0, int S1, int m0, int m1,
                int rhs_mode, int apply_bc, int rows, cudaStream_t stream) {
  using Tl = Tile<T, TX>;
  // the tiles' columns cover 0 .. S1 - 1 (a tile completes STRIDE
  // columns, the first also column 0)
  const dim3 grid(tpufem::ceil_div(S1 - 1, Tl::STRIDE), 1,
                  tpufem::ceil_div(S0, rows));
  if (grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      tpufem::allow_smem<fused_system_2d_kernel<T, TX>>(Tl::kSmem);
  if (err != 0) return err;
  fused_system_2d_kernel<T, TX><<<grid, TX, Tl::kSmem, stream>>>(
      C, data, rhs, S0, S1, m0, m1, rhs_mode, apply_bc, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* C, T* data, T* rhs, int S0, int S1, int m0, int m1,
           int rhs_mode, int apply_bc, int tx, int rows, void* stream) {
  // bands of rows >= 1; the cells lie inside the store grid's padding (a
  // node's store index is one more)
  if (S0 < 1 || rows < 1 || m0 < 1 || m1 < 1 || m0 + 2 > S0 ||
      m1 + 2 > S1 || (rhs_mode != 0 && rhs_mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPUFEM_CASE(TX)                                                     \
  if (tx == TX) {                                                           \
    return launch_tile<T, TX>(C, data, rhs, S0, S1, m0, m1, rhs_mode,       \
                              apply_bc, rows, s);                           \
  }
  TPUFEM_2D_TILES(TPUFEM_CASE)
#undef TPUFEM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
size_t smem_of(int tx) {
#define TPUFEM_CASE(TX) \
  if (tx == TX) return Tile<T, TX>::kSmem;
  TPUFEM_2D_TILES(TPUFEM_CASE)
#undef TPUFEM_CASE
  return 0;
}

}  // namespace

extern "C" {

// m0, m1: cells per axis (node_grid - 1); rhs_mode 0 = quadrature,
// 1 = interp; tx, rows: a block's columns and its band of store rows
// (fused_2d_tiling).
int tpufem_fused_system_2d_f32(const float* C, float* data, float* rhs,
                               int S0, int S1, int m0, int m1, int rhs_mode,
                               int apply_bc, int tx, int rows, void* stream) {
  return launch<float>(C, data, rhs, S0, S1, m0, m1, rhs_mode, apply_bc, tx,
                       rows, stream);
}

int tpufem_fused_system_2d_f64(const double* C, double* data, double* rhs,
                               int S0, int S1, int m0, int m1, int rhs_mode,
                               int apply_bc, int tx, int rows, void* stream) {
  return launch<double>(C, data, rhs, S0, S1, m0, m1, rhs_mode, apply_bc,
                        tx, rows, stream);
}

// Dynamic shared memory (bytes) of a block of tx columns with values of
// itemsize bytes (4 or 8); -1 for a tile the launcher has no kernel for.
int tpufem_fused_2d_smem(int itemsize, int tx) {
  const size_t bytes = itemsize == 4   ? smem_of<float>(tx)
                       : itemsize == 8 ? smem_of<double>(tx)
                                       : 0;
  return bytes > 0 ? static_cast<int>(bytes) : -1;
}

}  // extern "C"
