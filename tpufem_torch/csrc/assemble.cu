// Fused P1 stiffness assembly on a structured Kuhn-tetrahedron grid:
// embedded element coordinates in, the K embedded stencil planes out (no
// RHS, no boundary elimination).  Kernel B13.
//
// Replaces tpufem/ops/assemble_pallas.py::_type_kernel (the kernel of
// assemble_stencil_pallas).  Input X [T, 4, 3, S0, S1, S2]: coordinate d
// of local node n of the type-t tetrahedron of cell (cz, cy, cx) at
// (cz, cy + 1, cx + 1) (element_coords_bt_embedded; padding cells hold a
// unit simplex, which this kernel never reads).  Output data [K, S0, S1,
// S2], every plane written once, zeros included.
//
// Bound on the card (chip_smoke.py's): bytes, the cell-grid part of the
// 72 coordinate planes in and K planes out; about 171 separately rounded
// operations per tetrahedron (geometry once, the 16 entries), under the
// bytes when each tetrahedron is computed once.  What bounds this design
// (scripts/structured_build_ablation.py, PERF.md): the coordinate loads,
// 72 planes read a tile row at a time, about 60% of the card's rate.
//
// The first design ran one thread per store row, which for each of the
// 24 (type t, local row a) pairs loaded the 12 coordinates of the one
// cell whose local node a it is and computed that tetrahedron's whole
// geometry to add row a of its stiffness: every tetrahedron was computed
// and loaded four times, 0.2103 ms at n=96 fp32 against a 0.1009 ms bound
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).
//
// This design computes each tetrahedron once per tile, on the pattern of
// K1 (fused_system.cu).  A block of TX x TY threads owns a tile of TX
// store columns by TY rows, one column a thread, and marches over tz
// store planes (the launcher's tile, assemble_tiling in
// ops/assemble_cuda.py).  A step takes one cell plane c:
//   * cell phase: the 6 (type, cell) units of each of the (TY + 1) x
//     (TX + 1) cells (the tile and the one cell before it in y and x,
//     whose nodes reach into the tile), spread evenly over the threads,
//     load their 12 coordinates straight from device memory (coalesced
//     along x), kAhead = 4 units a thread at once so that 48 loads are in
//     flight (8 at once measured slower: 189 registers fp32, spills fp64),
//     and compute the geometry once, in the formulas and order of the
//     first design, into the 10 distinct entries of the symmetric 4 x 4
//     stiffness in shared memory.  A cell outside the cell grid is
//     skipped by its index: its geometry is not computed and its slots
//     are not read.
//   * node phase: store plane c + 1 (its cells of plane c, za = 0, and of
//     plane c - 1, za = 1) is complete: each thread adds its row's terms
//     and stores its K outputs, a warp's 32 consecutive columns at a
//     time; then it reads the za = 1 terms that plane c gives plane c + 2.
//     The march's first step (cell plane z0 - 2) only reads those.
// So each tetrahedron is computed (TY + 1)(TX + 1) / (TY TX) x (tz + 1) /
// tz times, against 4 times in the first design.  Staging a round of
// types' coordinate planes through shared memory with cp.async, a
// sub-step ahead (K1's way), measured slower than the loads straight
// from device memory: 0.2181 ms with 4-byte copies, 0.2335 ms with
// 16-byte chunks, against 0.1764 ms (n=96 fp32, NVIDIA H100 80GB HBM3,
// 700 W, scripts/structured_build_ablation.py; PERF.md).
//
// Rounding and order: every product and sum is rounded on its own (no
// fused multiply-add), and each acc[k] sums its terms in the order t, a,
// b of the plain version (ops.assemble_cuda.assemble_stencil_plain),
// which it equals bit for bit, as the first design did.  That order
// interleaves a row's za = 1 and za = 0 terms, which reach the row one
// step apart.  The za = 1 terms of slot k that come before its first
// za = 0 term are summed in the step that reads them (a prefix sum, the
// start of acc[k]); each later one is carried to the next step as its
// value and added in its place.  The generated header lists both
// sequences: 24 values carried a thread in the Kuhn split (10 prefix
// sums, 14 values), against the 48 of all the za = 1 terms.  No atomics:
// the output is bit-reproducible.  The plan tables come from a generated
// header (tpufem_assemble_tables.h), as they were trace-time constants of
// the Pallas kernel: every slot index is then a literal and the sums stay
// in registers.
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"
#include "tpufem_assemble_tables.h"

// The generated header defines:
//   TPUFEM_ASM_K                   number of stencil offsets
//   TPUFEM_ASM_TYPES               tetrahedra a cell
//   TPUFEM_ASM_CARRIED             values a thread carries from a step to
//                                  the next
//   TPUFEM_ASM_FOR_EARLY(S, C)     per za = 1 term in (t, a, b) order:
//                                  S(t, a, b, ya, xa, k) adds it to the
//                                  prefix sum of slot k, C(t, a, b, ya,
//                                  xa, i) keeps it as carried value i
//   TPUFEM_ASM_FOR_LATE(S, C)      per term added after the prefix sums,
//                                  in (t, a, b) order: S(t, a, b, ya, xa,
//                                  k) a za = 0 term, C(t, a, b, ya, xa, k,
//                                  i) carried value i

namespace {

using tpufem::add_rn;
using tpufem::mul_rn;

// the 10 entries of the upper triangle of a tetrahedron's stiffness
constexpr int kEntries = 10;
constexpr int kTypes = TPUFEM_ASM_TYPES;

// Slot of stiffness entry (a, b) among the upper triangle's 10.
__host__ __device__ constexpr int entry_slot(int a, int b) {
  return a <= b ? a * 4 - a * (a - 1) / 2 + (b - a) : entry_slot(b, a);
}

template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b) {
  return add_rn(a, -b);  // negation is exact
}
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }

template <typename T>
__device__ __forceinline__ T cofactor(T a, T b, T c, T e) {
  return sub_rn(mul_rn(a, b), mul_rn(c, e));
}

// One tetrahedron's 10 stiffness entries into out[slot * stride].  V[n][d]:
// coordinate d of vertex n.  The formulas and their order are
// assemble.planar.p1_gradients / p1_stiffness_views'.
template <typename T>
__device__ __forceinline__ void tet_entries(const T (&V)[4][3], T* out,
                                            int stride) {
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
  // entry (a, b) = (b, a): the products commute exactly
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a; b < 4; ++b) {
      const T dot = add_rn(add_rn(mul_rn(G[a][0], G[b][0]),
                                  mul_rn(G[a][1], G[b][1])),
                           mul_rn(G[a][2], G[b][2]));
      out[entry_slot(a, b) * stride] = mul_rn(dot, vol);
    }
  }
}

// Units (type, cell) of the cell phase whose coordinates a thread loads
// at once.
constexpr int kAhead = 4;

// A tile of TX columns by TY rows, one column a thread.  Shared memory:
// kEntries values for each type of each of the NCELL cells.
template <typename T, int TX, int TY>
struct Tile {
  static constexpr int NT = TX * TY;
  static constexpr int CX = TX + 1, CY = TY + 1, NCELL = CX * CY;
  static constexpr size_t kSmem = size_t(kTypes) * kEntries * NCELL *
                                  sizeof(T);
  // blocks an SM must hold: 512 fp32 or 256 fp64 threads' registers
  static constexpr int kMinBlocks = (sizeof(T) == 4 ? 512 : 256) / NT;
  static_assert(kMinBlocks >= 1, "a block's registers fit the SM");
};

// The tiles (TX, TY) the launcher instantiates (assemble_tiling picks one).
#define TPUFEM_ASM_TILES(X) X(64, 4) X(32, 4)

// The cell phase of cell plane c: each valid cell's tetrahedra into vals
// (kEntries planes of NCELL per type).  Cell (ly, lx) is cell (cy, cx) =
// (y0 - 2 + ly, x0 - 2 + lx), stored at (c, cy + 1, cx + 1).  A thread
// takes its units kAhead at a time: their 12 coordinates each are loaded
// together, then they are computed.  A cell outside the grid is skipped.
template <typename T, int TX, int TY>
__device__ __forceinline__ void cell_phase(const T* __restrict__ X, T* vals,
                                           int c, int y0, int x0, int m1,
                                           int m2, long long plane,
                                           long long ns, int S2) {
  using Tl = Tile<T, TX, TY>;
  constexpr int kUnits = kTypes * Tl::NCELL;
  for (int u0 = threadIdx.x; u0 < kUnits; u0 += kAhead * Tl::NT) {
    T V[kAhead][4][3];
    bool in[kAhead];
    int at[kAhead];   // the unit's first value in vals
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int u = u0 + j * Tl::NT;
      const int t = u / Tl::NCELL, cell = u - t * Tl::NCELL;
      const int ly = cell / Tl::CX, lx = cell - ly * Tl::CX;
      const int cy = y0 - 2 + ly, cx = x0 - 2 + lx;
      in[j] = u < kUnits &&
              static_cast<unsigned>(cy) < static_cast<unsigned>(m1) &&
              static_cast<unsigned>(cx) < static_cast<unsigned>(m2);
      at[j] = t * kEntries * Tl::NCELL + cell;
      if (in[j]) {
        const T* Xt = X + static_cast<long long>(t) * 12 * ns + c * plane +
                      static_cast<long long>(cy + 1) * S2 + (cx + 1);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int d = 0; d < 3; ++d) V[j][n][d] = Xt[(n * 3 + d) * ns];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (in[j]) tet_entries<T>(V[j], vals + at[j], Tl::NCELL);
    }
  }
}

// Block (bx, by, bz) owns columns bx TX .., rows by TY .. and store planes
// bz tz .. (the last tile ragged in y and z).
template <typename T, int TX, int TY>
__global__ void __launch_bounds__(TX * TY, (Tile<T, TX, TY>::kMinBlocks))
assemble_kernel(const T* __restrict__ X, T* __restrict__ data, int S0,
                int S1, int S2, int m0, int m1, int m2, int tz) {
  using Tl = Tile<T, TX, TY>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* vals = reinterpret_cast<T*>(smem);   // kTypes x kEntries x NCELL

  const long long plane = static_cast<long long>(S1) * S2;
  const long long ns = S0 * plane;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int z0 = blockIdx.z * tz, z1 = min(z0 + tz, S0);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int sx = x0 + tx, sy = y0 + ty;
  // this thread's cell position (its node's cell, ya = xa = 0), and which
  // of the cells (sy - 1 - ya, sx - 1 - xa) before its row lie in the grid
  const int me = (ty + 1) * Tl::CX + tx + 1;
  bool in_yx[2][2];
#pragma unroll
  for (int ya = 0; ya < 2; ++ya) {
#pragma unroll
    for (int xa = 0; xa < 2; ++xa) {
      in_yx[ya][xa] = static_cast<unsigned>(sy - 1 - ya) <
                          static_cast<unsigned>(m1) &&
                      static_cast<unsigned>(sx - 1 - xa) <
                          static_cast<unsigned>(m2);
    }
  }

  // acc: the row's sums (the prefix sums of the za = 1 terms, carried in);
  // kept: the later za = 1 terms' values, carried in (kept_in: their cell
  // plane lies in the grid)
  T acc[TPUFEM_ASM_K];
  T kept[TPUFEM_ASM_CARRIED > 0 ? TPUFEM_ASM_CARRIED : 1];
#pragma unroll
  for (int k = 0; k < TPUFEM_ASM_K; ++k) acc[k] = T(0);
  bool kept_in = false;

#define TPUFEM_ASM_VAL(t, a, b, ya, xa)                                     \
  vals[((t) * kEntries + entry_slot(a, b)) * Tl::NCELL + me -              \
       (ya) * Tl::CX - (xa)]
  // the march: cell planes z0 - 2 .. z1 - 2; store plane c + 1 completes
  // at cell plane c, the first step only warms up
  for (int c = z0 - 2; c <= z1 - 2; ++c) {
    const bool zin = c >= 0 && c < m0;   // the cell plane lies in the grid
    if (c > z0 - 2) __syncthreads();     // the last step's values are read
    if (zin) {
      cell_phase<T, TX, TY>(X, vals, c, y0, x0, m1, m2, plane, ns, S2);
    }
    __syncthreads();

    if (c > z0 - 2) {
      // store plane c + 1 is complete: its za = 0 terms (cell plane c) and
      // the carried ones, in (t, a, b) order after the prefix sums
#define TPUFEM_ASM_LATE_SUM(t, a, b, ya, xa, k)                             \
  if (zin && in_yx[ya][xa])                                                 \
    acc[k] = add_rn(acc[k], TPUFEM_ASM_VAL(t, a, b, ya, xa));
#define TPUFEM_ASM_LATE_KEPT(t, a, b, ya, xa, k, i)                         \
  if (kept_in && in_yx[ya][xa]) acc[k] = add_rn(acc[k], kept[i]);
      TPUFEM_ASM_FOR_LATE(TPUFEM_ASM_LATE_SUM, TPUFEM_ASM_LATE_KEPT)
#undef TPUFEM_ASM_LATE_KEPT
#undef TPUFEM_ASM_LATE_SUM
      if (sy < S1) {
        const long long row =
            (c + 1) * plane + static_cast<long long>(sy) * S2 + sx;
#pragma unroll
        for (int k = 0; k < TPUFEM_ASM_K; ++k) data[k * ns + row] = acc[k];
      }
    }

    // the za = 1 terms cell plane c gives store plane c + 2
#pragma unroll
    for (int k = 0; k < TPUFEM_ASM_K; ++k) acc[k] = T(0);
#define TPUFEM_ASM_EARLY_SUM(t, a, b, ya, xa, k)                            \
  if (zin && in_yx[ya][xa])                                                 \
    acc[k] = add_rn(acc[k], TPUFEM_ASM_VAL(t, a, b, ya, xa));
#define TPUFEM_ASM_EARLY_KEEP(t, a, b, ya, xa, i)                           \
  kept[i] = TPUFEM_ASM_VAL(t, a, b, ya, xa);
    TPUFEM_ASM_FOR_EARLY(TPUFEM_ASM_EARLY_SUM, TPUFEM_ASM_EARLY_KEEP)
#undef TPUFEM_ASM_EARLY_KEEP
#undef TPUFEM_ASM_EARLY_SUM
    kept_in = zin;
  }
#undef TPUFEM_ASM_VAL
}

template <typename T, int TX, int TY>
int launch_tile(const T* X, T* data, int S0, int S1, int S2, int m0, int m1,
                int m2, int tz, cudaStream_t stream) {
  using Tl = Tile<T, TX, TY>;
  const dim3 grid(S2 / TX, tpufem::ceil_div(S1, TY), tpufem::ceil_div(S0, tz));
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      tpufem::allow_smem<assemble_kernel<T, TX, TY>>(Tl::kSmem);
  if (err != 0) return err;
  assemble_kernel<T, TX, TY><<<grid, Tl::NT, Tl::kSmem, stream>>>(
      X, data, S0, S1, S2, m0, m1, m2, tz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* X, T* data, int S0, int S1, int S2, int m0, int m1,
           int m2, int tx, int ty, int tz, void* stream) {
  // a tile of tx columns dividing the rows, tz >= 1 planes; the cells lie
  // inside the store grid's padding (cell (cz, cy, cx) at (cz, cy + 1,
  // cx + 1), its rows at most two planes up)
  if (S0 < 1 || S1 < 1 || tx < 1 || S2 < tx || S2 % tx || tz < 1 ||
      m0 < 1 || m1 < 1 || m2 < 1 || m0 + 2 > S0 || m1 + 2 > S1 ||
      m2 + 2 > S2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPUFEM_CASE(TX, TY)                                                 \
  if (tx == TX && ty == TY) {                                               \
    return launch_tile<T, TX, TY>(X, data, S0, S1, S2, m0, m1, m2, tz, s);  \
  }
  TPUFEM_ASM_TILES(TPUFEM_CASE)
#undef TPUFEM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
size_t smem_of(int tx, int ty) {
#define TPUFEM_CASE(TX, TY) \
  if (tx == TX && ty == TY) return Tile<T, TX, TY>::kSmem;
  TPUFEM_ASM_TILES(TPUFEM_CASE)
#undef TPUFEM_CASE
  return 0;
}

}  // namespace

extern "C" {

// S0, S1, S2: the store grid; m0, m1, m2: cells per axis; tx, ty, tz: a
// block's columns, rows and planes (assemble_tiling).
int tpufem_assemble_stencil_f32(const float* X, float* data, int S0, int S1,
                                int S2, int m0, int m1, int m2, int tx,
                                int ty, int tz, void* stream) {
  return launch<float>(X, data, S0, S1, S2, m0, m1, m2, tx, ty, tz, stream);
}

int tpufem_assemble_stencil_f64(const double* X, double* data, int S0,
                                int S1, int S2, int m0, int m1, int m2,
                                int tx, int ty, int tz, void* stream) {
  return launch<double>(X, data, S0, S1, S2, m0, m1, m2, tx, ty, tz, stream);
}

// Dynamic shared memory (bytes) of a block of tx columns by ty rows with
// values of itemsize bytes (4 or 8); -1 for a tile the launcher has no
// kernel for.
int tpufem_assemble_smem(int itemsize, int tx, int ty) {
  const size_t bytes = itemsize == 4   ? smem_of<float>(tx, ty)
                       : itemsize == 8 ? smem_of<double>(tx, ty)
                                       : 0;
  return bytes > 0 ? static_cast<int>(bytes) : -1;
}

}  // extern "C"
