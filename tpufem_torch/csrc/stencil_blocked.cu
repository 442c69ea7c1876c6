// Blocked stencil kernel for large 3D store grids: kernel B3, the
// general-coefficient stencil with K2/B4's five epilogues.
//
// Replaces tpufem/ops/stencil_pallas.py::_kernel2, ::_kernel2_residual,
// ::_kernel2_smooth, ::_kernel2_matvec_dot and ::_kernel2_smooth_dot: the
// (Bz, By)-blocked twins that the reference runs instead of the flat
// kernels once a grid passes its _needs_2d rule (about 300^3).  B3 computes
// the same functions as K2/B4 (stencil.cu), whose epilogues, dot and
// rounding it shares (common.cuh).  The wrappers carry the reference's
// routing rule over unchanged; on this card it is a routing rule, not a
// memory limit.  The const-weight twins (B5b, ::_kernel2_const_*) compute
// B5's function, and their route launches B5's staged kernel
// (const_stencil.cu) on the same store grid.
//
// Bound on the card: bytes, as for the flat kernels: per row K coefficient
// planes, the epilogue's vectors and one y.  Design, for this card rather
// than block by block from the TPU: one CTA per (z tile of BZ rows, y tile
// of 8 rows, 128-wide x strip) of the store grid (store axes are multiples
// of 8, 8 and 128).  The CTA loads the haloed x slab [BZ+2][10][130] into
// shared memory once, then each thread walks its x column down the tile's
// rows: the 15 neighbours come from the slab, every data plane and vector
// streams from HBM in coalesced 128-wide rows.  The offset count is a
// compile-time 15 and B3 works on two rows at a time, so 30 coefficient
// loads are in flight at once: with a run-time count and one row at a time
// B3's fp32 matvec at n=384 took 2.57 ms against the flat K2's 1.83
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py).  The slab's halo is
// read by flat store index j = ((z-1+sz) S1 + y-1+sy) S2 + x-1+sx, 0 outside
// [0, NS): exactly the value the flat kernel reads at the same offset, so
// each row's terms, summed in the same offset order, are the flat kernel's.
// BZ is 4 for 4-byte vectors and 2 for fp64 (31 and 42 KB of static shared
// memory).  Every index product is 64-bit (NS = 78.7M rows at n=384, and
// K NS > 2^31).  The dot is per-block fp64 partials plus a fixed-order
// second pass (common.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using tpufem::kMatvec;
using tpufem::kResidual;
using tpufem::kSmooth;

constexpr int kBX = 128;          // x strip
constexpr int kBY = 8;            // y rows of a tile
constexpr int kSX = kBX + 2;      // slab extents with the halo
constexpr int kSY = kBY + 2;
constexpr int kColumns = tpufem::kBlock / kBX;   // threads per x column

template <typename TV>
constexpr int tile_z() {
  return sizeof(TV) == 8 ? 2 : 4;
}

struct Grid {
  int s0, s1, s2;
};

// The 3D Kuhn stencil's 15 offsets, the only stencil on the grids the
// blocked route takes; a compile-time count, so a row's loads unroll and
// are in flight at once.
constexpr int kOffsets = 15;

// Offsets as slab index deltas: dz * kSY * kSX + dy * kSX + dx.
struct Steps {
  int delta[kOffsets];
};

__device__ __forceinline__ long long block_id() {
  return (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
             gridDim.x + blockIdx.x;
}

// Fill the tile's haloed slab with load(j) at flat store index j (0 outside
// [0, ns)), then synchronise.
template <int BZ, typename T, typename Load>
__device__ __forceinline__ void load_slab(T* __restrict__ slab, const Grid& g,
                                          long long ns, Load load) {
  const int x0 = blockIdx.x * kBX, y0 = blockIdx.y * kBY,
            z0 = blockIdx.z * BZ;
  for (int s = threadIdx.x; s < (BZ + 2) * kSY * kSX; s += tpufem::kBlock) {
    const int sx = s % kSX;
    const int sy = (s / kSX) % kSY;
    const int sz = s / (kSX * kSY);
    const long long j =
        (static_cast<long long>(z0 - 1 + sz) * g.s1 + (y0 - 1 + sy)) * g.s2 +
        (x0 - 1 + sx);
    slab[s] = (j >= 0 && j < ns) ? load(j) : T(0);
  }
  __syncthreads();
}

// Row p of this thread's column: (store row i, slab index of its centre).
template <int BZ>
__device__ __forceinline__ void tile_row(int p, const Grid& g, long long& i,
                                         int& c) {
  const int lx = threadIdx.x % kBX, ly = p % kBY, lz = p / kBY;
  i = (static_cast<long long>(blockIdx.z * BZ + lz) * g.s1 +
       (blockIdx.y * kBY + ly)) * g.s2 + (blockIdx.x * kBX + lx);
  c = ((lz + 1) * kSY + (ly + 1)) * kSX + (lx + 1);
}

template <typename TD, typename TV, int EPI, int BZ>
__global__ void __launch_bounds__(tpufem::kBlock)
stencil_blocked_kernel(const TD* __restrict__ data, const TV* __restrict__ x,
                       const TV* __restrict__ b,
                       const TD* __restrict__ inv_diag, TV* __restrict__ y,
                       double* __restrict__ partials, Grid g, Steps st,
                       double omega) {
  __shared__ TV slab[(BZ + 2) * kSY * kSX];
  const long long ns = static_cast<long long>(g.s0) * g.s1 * g.s2;
  load_slab<BZ>(slab, g, ns, [&](long long j) { return x[j]; });
  double part = 0.0;
  // two rows at a time: 30 coefficient loads in flight
#pragma unroll 2
  for (int p = threadIdx.x / kBX; p < BZ * kBY; p += kColumns) {
    long long i;
    int c;
    tile_row<BZ>(p, g, i, c);
    TV acc = TV(0);
#pragma unroll
    for (int k = 0; k < kOffsets; ++k) {
      acc += TV(tpufem::widen(data[k * ns + i])) * slab[c + st.delta[k]];
    }
    TV out;
    if (EPI == kMatvec) {
      out = acc;
      part += static_cast<double>(slab[c]) * static_cast<double>(out);
    } else if (EPI == kResidual) {
      out = b[i] - acc;
    } else {
      out = slab[c] +
            tpufem::omega_inv_diag<TD, TV>(omega, inv_diag[i]) * (b[i] - acc);
      part += static_cast<double>(b[i]) * static_cast<double>(out);
    }
    y[i] = out;
  }
  if (partials != nullptr) {
    part = tpufem::block_sum<tpufem::kBlock>(part);
    if (threadIdx.x == 0) partials[block_id()] = part;
  }
}

// The launch grid of a store grid, or false if the grid does not tile.
template <int BZ>
bool tiles(const Grid& g, dim3& grid) {
  if (g.s0 <= 0 || g.s0 % BZ || g.s1 % kBY || g.s2 % kBX ||
      g.s0 / BZ > 65535 || g.s1 / kBY > 65535) {
    return false;
  }
  grid = dim3(g.s2 / kBX, g.s1 / kBY, g.s0 / BZ);
  return true;
}

// Slab index delta of each offset from its (dz, dy, dx) in {-1, 0, 1}.
bool slab_deltas(const int* steps, int k, int* delta) {
  if (k != kOffsets) return false;
  for (int i = 0; i < k; ++i) {
    const int dz = steps[3 * i], dy = steps[3 * i + 1], dx = steps[3 * i + 2];
    if (dz < -1 || dz > 1 || dy < -1 || dy > 1 || dx < -1 || dx > 1) {
      return false;
    }
    delta[i] = (dz * kSY + dy) * kSX + dx;
  }
  return true;
}

// The second pass of a launch with a dot, or the launch's own status.
template <typename T>
int finish(T* dot, const double* partials, dim3 grid, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dot == nullptr) return static_cast<int>(err);
  tpufem::finish_dot_kernel<T><<<1, tpufem::kFinishBlock, 0, s>>>(
      partials, static_cast<int>(grid.x * grid.y * grid.z), dot);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int stencil_dispatch(int epilogue, const void* data, const void* x,
                     const void* b, const void* inv_diag, void* y,
                     double* partials, void* dot, int s0, int s1, int s2,
                     const int* steps, int k, double omega, void* stream) {
  constexpr int BZ = tile_z<TV>();
  const Grid g{s0, s1, s2};
  dim3 grid;
  Steps st;
  if (!tiles<BZ>(g, grid) || !slab_deltas(steps, k, st.delta) ||
      (dot != nullptr && epilogue == kResidual)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TD* d = static_cast<const TD*>(data);
  const TV* xv = static_cast<const TV*>(x);
  const TV* bv = static_cast<const TV*>(b);
  const TD* inv = static_cast<const TD*>(inv_diag);
  TV* yv = static_cast<TV*>(y);
  double* part = dot != nullptr ? partials : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kMatvec:
      stencil_blocked_kernel<TD, TV, kMatvec, BZ>
          <<<grid, tpufem::kBlock, 0, s>>>(d, xv, bv, inv, yv, part, g, st,
                                           omega);
      break;
    case kResidual:
      stencil_blocked_kernel<TD, TV, kResidual, BZ>
          <<<grid, tpufem::kBlock, 0, s>>>(d, xv, bv, inv, yv, part, g, st,
                                           omega);
      break;
    case kSmooth:
      stencil_blocked_kernel<TD, TV, kSmooth, BZ>
          <<<grid, tpufem::kBlock, 0, s>>>(d, xv, bv, inv, yv, part, g, st,
                                           omega);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return finish(static_cast<TV*>(dot), partials, grid, s);
}

}  // namespace

extern "C" {

// B3.  epilogue: 0 matvec (dot <x, y>), 1 residual (no dot), 2 smooth (dot
// <b, y>); b: the residual's b or the sweep's r; inv_diag: the sweep's.
// s0, s1, s2: the store grid; steps: the k = 15 offsets as (dz, dy, dx)
// triples, each in {-1, 0, 1}.  partials: fp64 scratch of
// tpufem_blocked_num_blocks(s0, s1, s2, sizeof vector) slots, used when
// dot != NULL.
#define TPUFEM_BLOCKED_ENTRY(NAME, TD, TV)                                   \
  int NAME(int epilogue, const void* data, const void* x, const void* b,    \
           const void* inv_diag, void* y, double* partials, void* dot,      \
           int s0, int s1, int s2, const int* steps, int k, double omega,   \
           void* stream) {                                                  \
    return stencil_dispatch<TD, TV>(epilogue, data, x, b, inv_diag, y,      \
                                    partials, dot, s0, s1, s2, steps, k,    \
                                    omega, stream);                         \
  }

TPUFEM_BLOCKED_ENTRY(tpufem_stencil_blocked_f32, float, float)
TPUFEM_BLOCKED_ENTRY(tpufem_stencil_blocked_bf16_f32, __nv_bfloat16, float)
TPUFEM_BLOCKED_ENTRY(tpufem_stencil_blocked_f64, double, double)

#undef TPUFEM_BLOCKED_ENTRY

// Launch blocks (= dot partial slots) of a store grid for vectors of
// vec_bytes bytes; 0 if the grid does not tile.
int tpufem_blocked_num_blocks(int s0, int s1, int s2, int vec_bytes) {
  const Grid g{s0, s1, s2};
  dim3 grid;
  const bool ok = vec_bytes == 8 ? tiles<2>(g, grid) : tiles<4>(g, grid);
  return ok ? static_cast<int>(grid.x * grid.y * grid.z) : 0;
}

}  // extern "C"
