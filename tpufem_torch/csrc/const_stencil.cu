// Constant-coefficient (uniform-grid) stencil on the embedded layout:
// kernel B5, which B5b's route runs too.
//
// Replaces tpufem/ops/stencil_pallas.py::_kernel_const_matvec,
// ::_kernel_const_residual, ::_kernel_const_smooth and
// ::_kernel_const_smooth_dot (B5, one body, _apply_const_stencil) and
// ::_kernel2_const_matvec, ::_kernel2_const_residual,
// ::_kernel2_const_smooth, ::_kernel2_const_smooth_dot (B5b, the
// (Bz, By)-blocked twins the reference runs past its _needs_2d rule, about
// 300^3): one function, so one kernel serves both routes.  On the uniform
// box every interior row of the Dirichlet-eliminated Poisson operator
// carries the same K weights, so a level is K numbers plus the row-type
// code plane (1 interior, 2 Dirichlet, 0 padding).  The epilogues:
//     matvec     y = A x
//     residual   y = b - A x
//     smooth     y = x + omega invd (b - A x),  invd = 1/w0 on interior
//                rows and 1 elsewhere            (optionally <b, y>)
// Interior rows apply the weights to the interior-masked neighbours (a
// neighbour counts when ITS code is 1); Dirichlet rows give x (so the sweep
// gives x + omega (b - x)), padding rows 0.  The code plane may be stored in
// bf16 after cast_hierarchy; its values are exact, and the weights, 1/w0
// and omega are scalars, so the result does not depend on its type.
//
// Bound on the card: bytes.  A row reads code and x (and b) and writes y:
// 12-16 bytes in fp32, 0.0050-0.0066 ms at 3D level 96 and 0.28-0.38 ms at
// n=384 at 3.35 TB/s.
//
// The first design (B5 and B5b's own slab kernel) ran one thread per store
// row, each loading code and x at every one of its K neighbours through L1
// behind a bounds select: 30 loads for a 3D row that needs 16 bytes from
// HBM.  It took 0.0239 ms at 3D level 96 fp32 (28% of its bound), and the
// slab kernel, whose loads all waited at one barrier before any compute,
// 0.8708 ms at n=384 (43%) (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).
//
// This design is K3's residual loop (mg_transfer.cu) without the
// restriction.  A block of 256 threads owns a tile of 128 store columns by
// TY rows and marches over a range of planes: in 3D over TZ planes of the
// store grid; in 2D down TZ bands of TY rows, each staged with a halo row
// either side, so that every tap of the 2D stencil lies in its band: a
// step as large as a 3D one (a march of one row a step, 128 values a copy,
// left the copies far below the rate the 3D steps reach).
//   * x and code arrive plane by plane with 16-byte cp.async (element by
//     element where a pointer is not 16-byte aligned; a bf16 code plane 8
//     values a chunk), a plane ahead of their use, each thread's chunks
//     planned once per block (tpufem::Stage; per band in 2D); b's tile
//     likewise, a plane ahead of the outputs.  Outside the store grid they
//     read 0;
//   * each element is formed once into a ring of masked planes,
//     m = code == 1 ? x : 0, the value every tap reads, as the first design
//     read it;
//   * the K taps run from shared memory at offsets fixed at compile time
//     (the stencil's table, tpufem::tap_step, which the launcher checks);
//   * the epilogue takes the centre's code and x from the staged planes and
//     b from its staged tile; every row of the store grid is written once
//     (padding 0, Dirichlet x).
// One barrier a step: a step forms plane p while it writes the outputs of
// plane p - 2 in 3D (whose planes either side earlier steps formed), of
// band p - 1 in 2D; so the rings hold four planes of x and code in 3D
// (three in 2D), four masked ones (two) and two tiles of b.  TY is a
// template parameter (the rows each thread owns unroll).
//
// Each output keeps the first design's operations and order (the taps in
// offset order from 0, each an FMA under nvcc's default contraction; the
// epilogue's expression), so y equals its y bit for bit.  Interior rows lie
// off the store grid's border (the embedded layout pads every axis), so no
// tap leaves the grid, where the first design's flat index reached a
// padding row of the next plane and this one reads 0: the same value.  The
// dot sums per-block fp64 partials in a fixed order (reproducible; other
// blocks than the first design's).
//
// Shared memory, registers (-Xptxas -v) and blocks per SM of each tile:
// PERF.md and const_tiling (ops/stencil_cuda.py), which computes the same
// bytes as const_smem here (tpufem_const_smem).  Above 48 KB the launcher
// raises the kernel's dynamic shared memory limit; a refused launch
// returns its error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using tpufem::Box;
using tpufem::chunk;
using tpufem::ConstOp;
using tpufem::kMatvec;
using tpufem::kResidual;
using tpufem::kSmooth;

constexpr int kTileX = 128;          // store columns of a tile
constexpr int kThreads = 256;        // two row groups of 128 columns

// Planes either side of the one a tap reads: the 3D stencil reaches the
// planes below and above (a block writes plane q once q + 1 is formed);
// every tap of the 2D one lies in its band of rows.
template <int K>
__host__ __device__ constexpr int plane_halo() {
  return K == 15 ? 1 : 0;
}

// Raw planes of x and code a block keeps: the one formed, the one staged
// ahead of it, and the 1 + plane_halo behind it whose outputs lag.
template <int K>
__host__ __device__ constexpr int raw_planes() {
  return 3 + plane_halo<K>();
}

// Masked planes: those an output reads and the one being formed.
template <int K>
__host__ __device__ constexpr int masked_planes() {
  return 2 + 2 * plane_halo<K>();
}

// x and code raw_planes each of ty + 2 rows (a halo row either side) by
// 128 columns and a 16-byte chunk either side (code in its own type), the
// masked x masked_planes such planes, and b 2 tiles of ty x 128.
template <int K, typename T, typename TC>
__host__ __device__ constexpr size_t const_smem(int ty) {
  const size_t ry = ty + 2, nr = raw_planes<K>();
  return ((nr + masked_planes<K>()) * ry * (kTileX + 2 * chunk<T>()) +
          2 * size_t(ty) * kTileX) *
             sizeof(T) +
         nr * ry * (kTileX + 2 * chunk<TC>()) * sizeof(TC);
}

// Tile rows the launcher instantiates: the rows const_tiling picks (8 in
// fp32, 6 in fp64) and 4.
#define TPUFEM_CONST_ROWS(X) X(4) X(6) X(8)

struct Grid {
  int s0, s1, s2;
};

// A block owns 128 store columns from x0 and TY rows of each plane it
// marches over.  3D: the rows y0 .. y0 + TY - 1 of planes z0 .. z1 - 1,
// plane p staged as rows y0 - 1 .. y0 + TY of store plane p.  2D (the
// store grid viewed as (1, S0, S1)): bands z0 .. z1 - 1 of TY rows each,
// band p staged as rows p TY - 1 .. p TY + TY of the one plane.  Launch
// bounds of 3 blocks a SM: 85 registers a thread.
template <int K, int TY, int EPI, typename TC, typename T>
__global__ void __launch_bounds__(kThreads, 3)
const_stencil_kernel(const TC* __restrict__ code, const T* __restrict__ x,
                     const T* __restrict__ b, T* __restrict__ y,
                     double* __restrict__ partials, Grid g,
                     ConstOp<K, T> op, int tz, bool vec) {
  constexpr int H = chunk<T>(), HC = chunk<TC>(), HZ = plane_halo<K>();
  constexpr int RW = kTileX + 2 * H, RWC = kTileX + 2 * HC, RY = TY + 2;
  constexpr int PS = RY * RW, PSC = RY * RWC, CS = TY * kTileX;
  constexpr int NM = masked_planes<K>(), NRAW = raw_planes<K>();
  constexpr int NR = TY / 2;               // output rows of a thread
  constexpr int NC = RW / H;               // chunks of a staged row
  static_assert(TY % 2 == 0, "two row groups");
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);              // NRAW planes of x
  T* ring = raw + NRAW * PS;                        // NM masked planes
  T* bs = ring + NM * PS;                           // 2 tiles of b
  TC* rawc = reinterpret_cast<TC*>(bs + 2 * CS);    // NRAW planes of code

  const int x0 = blockIdx.x * kTileX;
  const int y0 = HZ ? blockIdx.y * TY : 0;
  const int np = HZ ? g.s0 : (g.s1 + TY - 1) / TY;   // planes or bands
  const int z0 = blockIdx.z * tz, z1 = min(z0 + tz, np);
  const Box box{g.s0, g.s1, g.s2};
  const int col = threadIdx.x % kTileX, rg = threadIdx.x / kTileX;
  // step i forms plane p0 + i (nf of them) and, from step 1 + 2 HZ on,
  // writes plane p0 + i - 1 - HZ; x and code of a plane are staged a step
  // before it is formed, b of a plane a step before it is written.  Slots:
  // raw planes i (formed), i + 1 (staged) and i - 1 - HZ (the outputs'
  // centre) mod NRAW; masked planes i mod NM; b tiles i mod 2
  const int p0 = z0 - HZ, nf = z1 - z0 + 2 * HZ;
  const tpufem::Stage<T, RW, RY, kThreads> sx(y0 - 1, x0 - H, box, g.s2);
  const tpufem::Stage<TC, RWC, RY, kThreads> sc(y0 - 1, x0 - HC, box, g.s2);
  const tpufem::Stage<T, kTileX, TY, kThreads> sb(y0, x0, box, g.s2);
  auto stage_plane = [&](int p, int slot) {
    T* dx = raw + slot * PS;
    TC* dc = rawc + slot * PSC;
    if constexpr (HZ == 1) {
      sx.issue(dx, x, p, box, g.s1, g.s2, y0 - 1, x0 - H, vec);
      sc.issue(dc, code, p, box, g.s1, g.s2, y0 - 1, x0 - HC, vec);
    } else {   // a band's rows: the plans move with it
      const int yl = p * TY - 1;
      tpufem::Stage<T, RW, RY, kThreads>(yl, x0 - H, box, g.s2)
          .issue(dx, x, 0, box, g.s1, g.s2, yl, x0 - H, vec);
      tpufem::Stage<TC, RWC, RY, kThreads>(yl, x0 - HC, box, g.s2)
          .issue(dc, code, 0, box, g.s1, g.s2, yl, x0 - HC, vec);
    }
  };
  auto stage_b = [&](int q, int slot) {
    T* db = bs + slot * CS;
    if constexpr (HZ == 1) {
      sb.issue(db, b, q, box, g.s1, g.s2, y0, x0, vec);
    } else {
      tpufem::Stage<T, kTileX, TY, kThreads>(q * TY, x0, box, g.s2)
          .issue(db, b, 0, box, g.s1, g.s2, q * TY, x0, vec);
    }
  };
  stage_plane(p0, 0);
  tpufem::cp_async_commit();
  double part = 0.0;
  for (int i = 0; i <= nf; ++i) {
    tpufem::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nf) stage_plane(p0 + i + 1, (i + 1) % NRAW);
    const int qs = p0 + i - HZ;
    if (EPI != kMatvec && qs >= z0 && qs < z1) stage_b(qs, (i + 1) & 1);
    tpufem::cp_async_commit();
    if (i < nf) {
      // masked plane p0 + i: m = code == 1 ? x : 0, 16 bytes of x at a
      // time (the code row has its own chunk width)
      struct alignas(16) V { T v[H]; };
      struct alignas(H * sizeof(TC)) C { TC v[H]; };
      const V* src = reinterpret_cast<const V*>(raw + (i % NRAW) * PS);
      const TC* cp = rawc + (i % NRAW) * PSC + (HC - H);
      V* m = reinterpret_cast<V*>(ring + (i % NM) * PS);
      for (int k = threadIdx.x; k < RY * NC; k += kThreads) {
        const int row = k / NC;
        const C c = *reinterpret_cast<const C*>(cp + row * RWC +
                                                (k - row * NC) * H);
        const V a = src[k];
        V out;
#pragma unroll
        for (int h = 0; h < H; ++h)
          out.v[h] = T(tpufem::widen(c.v[h])) == T(1) ? a.v[h] : T(0);
        m[k] = out;
      }
    }
    if (i < 1 + 2 * HZ) continue;
    const int q = p0 + i - 1 - HZ;   // the output plane
    const int sm = (i - 1 - HZ) % NRAW;
    const T* mid = ring + ((i - 1 - HZ) % NM) * PS;
    const T* below = HZ ? ring + ((i - 2 - HZ) % NM) * PS : mid;
    const T* above = HZ ? ring + ((i - HZ) % NM) * PS : mid;
    const T* cx = raw + sm * PS;
    const TC* cc = rawc + sm * PSC;
    const T* bb = bs + (i & 1) * CS;
    T* yq = y + static_cast<long long>(HZ ? q : 0) * g.s1 * g.s2 + x0 + col;
    const int r0 = HZ ? y0 : q * TY;   // the tile's first grid row
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int row = rg + 2 * k, yy = r0 + row;
      const int j = (row + 1) * RW + col + H;
      const T c = T(tpufem::widen(cc[(row + 1) * RWC + col + HC]));
      const T v = cx[j];
      const T t = tpufem::taps<K, RW>(below, mid, above, j, op);
      const T ax = c == T(1) ? t : (c == T(2) ? v : T(0));
      T out;
      if constexpr (EPI == kMatvec) {
        out = ax;
      } else if constexpr (EPI == kResidual) {
        out = bb[row * kTileX + col] - ax;
      } else {
        const T bv = bb[row * kTileX + col];
        const T invd = c == T(1) ? op.inv_w0 : T(1);
        out = v + op.omega * invd * (bv - ax);
        if (yy < g.s1)
          part += static_cast<double>(bv) * static_cast<double>(out);
      }
      if (yy < g.s1) yq[static_cast<long long>(yy) * g.s2] = out;
    }
  }
  if (partials != nullptr) {
    part = tpufem::block_sum<kThreads>(part);
    if (threadIdx.x == 0)
      partials[(static_cast<long long>(blockIdx.z) * gridDim.y +
                blockIdx.y) * gridDim.x + blockIdx.x] = part;
  }
}

// One launch of the (K, TY) kernel with the epilogue's instance.
template <int K, int TY, typename TC, typename T>
int launch_rows(int epilogue, const TC* code, const T* x, const T* b, T* y,
                double* part, const Grid& g, const ConstOp<K, T>& op,
                int tz, bool vec, dim3 grid, cudaStream_t s) {
  const size_t smem = const_smem<K, T, TC>(TY);
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (epilogue) {
#define TPUFEM_CASE(EPI)                                                    \
  case EPI:                                                                 \
    err = tpufem::allow_smem<const_stencil_kernel<K, TY, EPI, TC, T>>(smem); \
    if (err != 0) return err;                                               \
    const_stencil_kernel<K, TY, EPI, TC, T>                                 \
        <<<grid, kThreads, smem, s>>>(code, x, b, y, part, g, op, tz, vec); \
    return static_cast<int>(cudaGetLastError());
    TPUFEM_CASE(kMatvec)
    TPUFEM_CASE(kResidual)
    TPUFEM_CASE(kSmooth)
#undef TPUFEM_CASE
  }
  return err;
}

template <int K, typename TC, typename T>
int launch(int epilogue, const TC* code, const T* x, const T* b, T* y,
           double* partials, T* dot, const Grid& g, const int* steps,
           const double* weights, int k, double inv_w0, double omega,
           int ty, int tz, void* stream) {
  if (!tpufem::is_tap_table<K>(steps, k) || tz < 1 || ty < 1 ||
      g.s0 < 1 || g.s1 < 1 || g.s2 < kTileX || g.s2 % kTileX ||
      (K == 7 && g.s0 != 1) || (dot != nullptr && epilogue != kSmooth) ||
      (epilogue != kMatvec && b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 3D: (columns, rows, planes) of tiles; 2D: (columns, 1, bands)
  const int np = K == 15 ? g.s0 : static_cast<int>(tpufem::ceil_div(g.s1, ty));
  const dim3 grid(g.s2 / kTileX, K == 15 ? tpufem::ceil_div(g.s1, ty) : 1,
                  tpufem::ceil_div(np, tz));
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConstOp<K, T> op =
      tpufem::make_const_op<K, T>(weights, inv_w0, omega);
  const bool vec = tpufem::aligned16({code, x, b});
  double* part = dot != nullptr ? partials : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
#define TPUFEM_CASE(TY)                                                     \
  case TY:                                                                  \
    err = launch_rows<K, TY>(epilogue, code, x, b, y, part, g, op, tz, vec, \
                             grid, s);                                      \
    break;
  switch (ty) { TPUFEM_CONST_ROWS(TPUFEM_CASE) }
#undef TPUFEM_CASE
  if (err != 0 || dot == nullptr) return err;
  tpufem::finish_dot_kernel<T><<<1, tpufem::kFinishBlock, 0, s>>>(
      partials, static_cast<int>(grid.x * grid.y * grid.z), dot);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, typename T>
int dispatch(int epilogue, const void* code, const void* x, const void* b,
             void* y, double* partials, void* dot, const int* store_grid,
             const int* steps, const double* weights, int k, double inv_w0,
             double omega, int ty, int tz, void* stream) {
  const Grid g{store_grid[0], store_grid[1], store_grid[2]};
  const TC* c = static_cast<const TC*>(code);
  const T* xv = static_cast<const T*>(x);
  const T* bv = static_cast<const T*>(b);
  T* yv = static_cast<T*>(y);
  T* dv = static_cast<T*>(dot);
  switch (k) {
    case 15:
      return launch<15>(epilogue, c, xv, bv, yv, partials, dv, g, steps,
                        weights, k, inv_w0, omega, ty, tz, stream);
    case 7:
      return launch<7>(epilogue, c, xv, bv, yv, partials, dv, g, steps,
                       weights, k, inv_w0, omega, ty, tz, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename TC>
size_t smem_of(int k, int ty) {
  return k == 15 ? const_smem<15, T, TC>(ty) : const_smem<7, T, TC>(ty);
}

}  // namespace

extern "C" {

// epilogue: 0 matvec, 1 residual, 2 smooth (dot <b, y> when dot != NULL).
// b: the residual's b or the sweep's r (NULL for matvec).  store_grid: the
// kernel's grid (3 ints): the 3D store grid, or (S0, 1, S1) for a 2D one
// (rows of 128 columns).  steps: the k = 15 or 7 offsets as (dz, dy, dx)
// triples on it, which must be the stencil's table (tpufem::tap_step).
// weights: the k interior weights; inv_w0 = 1 / the centre's.  ty, tz:
// rows and planes (2D: bands) of a block's tile (const_tiling).
// partials: fp64 scratch of one slot per block, used when dot != NULL.
#define TPUFEM_CONST_ENTRY(NAME, TC, T)                                      \
  int NAME(int epilogue, const void* code, const void* x, const void* b,    \
           void* y, double* partials, void* dot, const int* store_grid,     \
           const int* steps, const double* weights, int k, double inv_w0,   \
           double omega, int ty, int tz, void* stream) {                    \
    return dispatch<TC, T>(epilogue, code, x, b, y, partials, dot,          \
                           store_grid, steps, weights, k, inv_w0, omega,    \
                           ty, tz, stream);                                 \
  }

TPUFEM_CONST_ENTRY(tpufem_const_stencil_f32, float, float)
TPUFEM_CONST_ENTRY(tpufem_const_stencil_bf16_f32, __nv_bfloat16, float)
TPUFEM_CONST_ENTRY(tpufem_const_stencil_f64, double, double)

#undef TPUFEM_CONST_ENTRY

// Dynamic shared memory (bytes) of a block with k = 15 or 7 offsets,
// vectors of itemsize bytes, a code plane of code_itemsize bytes and ty
// tile rows; -1 for any other combination.
int tpufem_const_smem(int k, int itemsize, int code_itemsize, int ty) {
  if ((k != 15 && k != 7) || ty < 1) return -1;
  size_t bytes = 0;
  if (itemsize == 4 && code_itemsize == 4)
    bytes = smem_of<float, float>(k, ty);
  if (itemsize == 4 && code_itemsize == 2)
    bytes = smem_of<float, __nv_bfloat16>(k, ty);
  if (itemsize == 8 && code_itemsize == 8)
    bytes = smem_of<double, double>(k, ty);
  return bytes > 0 ? static_cast<int>(bytes) : -1;
}

}  // extern "C"
