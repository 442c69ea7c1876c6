// ELL sparse matrix-vector products: kernel B9 (its per-block route B11),
// its absolute-column form B9g and kernel B10 (many right-hand sides),
// templates on the value type T (float, double) and the index type Idx
// (int16, int32); B10 also on q and on the form (banded or absolute).
//
// Replaces tpufem/sparse/ell_pallas.py::_kernel (B9; its segmented and
// global calls; B9g is the same kernel on absolute columns), ::_kernel_pb
// (B11, the per-block delta-table variant) and ::_kernel_multi (B10).  The
// banded plan stores the matrix transposed, data_t[K, NP] and rel[K, NP],
// with each column as a window-relative position: row i of block j = i / R
// reads x at (j - 1) R + rel[k, i]
//     y[i] = sum_k data_t[k, i] * x[(i / R - 1) R + rel[k, i]]
// summed in slot order.  The TPU kernel builds that gather out of lane
// gathers and sublane selects over a VMEM window of 3R values, looping over
// the window-row deltas each slot uses (statically, per segment of blocks,
// or per block from an SMEM table: that is all the segmentation and the
// B11 table are for).  A CUDA thread gathers any column directly, so one
// kernel serves the three TPU variants and each call is one launch.
//
// Rounding: each product and each sum is rounded separately
// (__fmul_rn / __fadd_rn, no fused multiply-add), in slot order, which is
// the reference's arithmetic and the plain PyTorch version's, so every
// form's y equals its plain version's bit for bit.  The sum starts at +0
// and a round-to-nearest sum whose exact value is 0 is +0, so it is never
// -0, and adding a padding slot's product 0 x = +-0 (x finite) leaves it
// as it is: the forms below stop at a row's length, skip zero values (B9g)
// and pad packed rows with zeros, and the plan drops the slot planes that
// hold no nonzero (sparse/ell_cuda.py), all without changing a bit for
// finite x.  The one difference: an inf or NaN of x that only padding
// reaches no longer reaches y.
//
// B9 on the AMG hierarchies (sparse/ell_cuda.py's ell_band_design picks
// the form per plan).  Bound on the card: the bytes the nonzeros need,
// each value and index once, x and y once.  The reference's Galerkin
// product pads each coarse level to max(4K, 24) slots, so the padded
// width grows 4x a level while the rows stay short (the P2 hierarchy's
// level 4: 314 rows, K = 6144, its longest row 95), and the restrictions
// Qr are 85-99% empty rows.  The first design, one thread a row over all K
// slot planes, walked the padding: 0.6828 ms at that level against a
// 0.0114 ms CSR product, 0.1254 ms at the P2 Qr of 1,002,001 rows (CSR
// 0.0371), 7.4758 ms of device time per p2 PCG iteration (NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md).  Forms:
//   * "rows": one thread a row on the plan's planes (consecutive threads
//     on consecutive rows, each plane read in coalesced lines), up to the
//     row's length, kRowsAhead slots' indices and values then their x
//     loaded before the group is summed (keep_order).  Where the rows are
//     many and their lengths even (P1, Q1 quads and hexes): it reads the
//     planes themselves, no copy, and measured 7-38% faster than "sliced"
//     there (1,002,001 rows, K = 8 fp32: 0.0259 ms against 0.0358).
//   * "sliced": one thread a row on the rows sorted by length within
//     windows and laid out in slices of 32 (ell_band_prepare), a group of
//     4 slots a 16-byte load, its slice's 32 rows' groups one line.  Where
//     lengths vary within a warp (P2: 9 to 19, P2-tet: 10 to 63) the
//     planes' lines carry the neighbours' padding; sorted in slices, a
//     row's lane reads its own bytes in coalesced lines.  With the
//     non-empty rows alone where they are fewer than half (Qr), extra
//     blocks writing the empty rows' zeros.
//   * "split": the rows packed row after row, 256 / TR lanes a row, where
//     the rows are too few to fill the card (the coarse levels): each lane
//     multiplies its share of the row into shared memory, kSplitAhead
//     slots' loads in flight, then the row's lane 0 adds them in slot
//     order.  The load chain of a row is split over its lanes; the sum,
//     out of shared memory, stays one chain, which bounds a long row (the
//     P2-tet hierarchy's Qr rows of up to 8163 slots).
//
// B9g (absolute columns, row-major data / cols [N, K]; the Dirichlet
// corrections, ELLMatrix.matvec without a plan, the gather transfers):
// on tall matrices, by row length (sparse/ell_cuda.py's
// ell_gather_tiling): a thread a row on the rows as they are (ell_packed,
// 16-byte groups of 4 where K allows; short rows, whose warp already reads
// whole lines); fp64 rows of 17-32 slots staged (ell_gather_staged: a
// block's rows copied into shared memory 16 slots at a time with
// cp.async, in whole lines); longer fp64 rows 4 lanes a row
// (ell_gather_lanes: whole lines a load, the sum relayed in slot order);
// else the "split" tiles.  All skip a zero value's x gather.  Without row
// lengths every slot's value is read, so the padded bytes bound it:
// 0.2328 ms at the P2-tet K = 80 shape (4 lanes a row 0.2996, a thread a
// row 0.3366, staged 0.3978), 0.1144 ms at hex K = 32 (staged 0.1552, a
// thread a row 0.1621, 4 lanes 0.1658), 0.0215 ms at K = 8 fp32 (a
// thread a row 0.0388).  The first design read a warp's rows K values
// apart, one slot at a time: 1.5952 ms at the P2-tet shape against a
// 0.3407 ms CSR product (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// B10: X [rows, q] and Y row-major, as the reference's [N, q].  Bound on
// the card: bytes, the matrix once and X and Y once: 72.1 MB at 1,002,001
// rows, K = 8, q = 3, fp32 with int16 rel, 21.6 us at 3.35 TB/s.  The
// first design ran one thread per (row, column), a row's q threads
// adjacent: a warp spanned 32 / q rows, so every data_t and rel plane took
// q times B9's load instructions, and every thread repeated the 64-bit
// division t / q, the window base's and its row's index loads (0.0598 ms
// at q = 3, 36% of the bound).  Design: one thread a row, consecutive
// threads on consecutive rows (each slot's plane read in coalesced
// lines), the q sums in registers (q a template parameter for q = 2 .. 8,
// a run-time instance in passes of 8 beyond), the slots in groups of
// kMultiAhead whose indices and values load before their X rows are
// gathered, each X row read as q contiguous values and each Y row written
// so (16- or 8-byte accesses where q and the alignment allow).  On the
// banded plan a 256-row block first finds the span of its columns and,
// where it fits the window of shared memory the chooser gives
// (sparse/ell_cuda.py's ell_multi_tiling: 2560 rows at q = 3), stages
// X's rows there with cp.async, so the gathers read shared memory; a
// wider span gathers from device memory.  The absolute form takes its
// row's contiguous slots 16 bytes a group.  What is left above the bound
// at q = 3 (0.0490 ms): the scattered X gathers, about 0.012 ms (0.0373
// with every slot on the diagonal), and each thread's chain of groups:
// larger groups raise the registers and cost more than they hide
// (PERF.md, Findings).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "spmv_probe.cuh"

namespace {

using tpufem::add_rn;
using tpufem::mul_rn;
using tpufem::window_base;

// Layout of one B10 launch.  Banded: row_stride 1, slot_stride NP,
// block_rows R.  Absolute: row_stride K, slot_stride 1, block_rows 0.
struct EllLayout {
  long long rows;         // rows computed (the matrix's n)
  int k;                  // slots per row
  long long row_stride;   // elements between rows of data / idx
  long long slot_stride;  // elements between slots of one row
  long long block_rows;   // R of the banded plan; 0 for absolute columns
};

// -- B9 on the banded plan ---------------------------------------------------

// One B9 launch.  "rows": the plan's planes data_t / rel [k, plane] (plane
// = NP) and each row's length len[i] (the slot after its last nonzero).
// "split": the rows' slots up to their lengths packed row after row
// (data / idx [ptr[count]], row j at [ptr[j], ptr[j + 1])), for every row
// or, with LIVE, for the non-empty rows live[j] alone (ascending).
// "sliced": the rows in slices of 32 (ell_packed; plane = the groups of 4
// a row of a slice holds), position j standing for row order[j].
struct BandLayout {
  long long rows;        // the matrix's n: y[0, n) is written
  long long count;       // rows computed: n, or the non-empty m
  long long plane;       // "rows": elements between slots; "sliced": groups
  long long block_rows;  // R
  int k;                 // slot planes of the plan
  unsigned work_blocks;  // blocks computing rows; the rest write 0s
};

// LIVE: the blocks past the computing ones write y = 0 on the empty rows
// (bit i % 32 of word i / 32 of `bits` clear), a thread a row, in
// coalesced lines.  True for those blocks.
template <typename T>
__device__ __forceinline__ bool zero_empty_rows(const int* __restrict__ bits,
                                                T* __restrict__ y,
                                                const BandLayout& l) {
  if (blockIdx.x < l.work_blocks) return false;
  const long long e = (blockIdx.x - l.work_blocks) *
                          static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e < l.rows && !((bits[e >> 5] >> (e & 31)) & 1)) y[e] = T(0);
  return true;
}

// Slots of a row whose indices and values load before they are summed
// ("rows"), and of a lane's share of a row before they are multiplied
// ("split", B9g).
constexpr int kRowsAhead = 4;
constexpr int kSplitAhead = 4;
// "sliced" and B9g a thread a row: groups of 4 slots loaded before their
// x gathers (of 2, 3 and 4 groups, the fastest at the p2 fine A and, for
// B9g, at the P2-tet K = 80 rows; PERF.md)
constexpr int kSlicedGroups = 2;
constexpr int kGatherGroups = 4;
constexpr int kRowsThreads = 256;
constexpr int kSplitThreads = 256;
// a block's dynamic shared memory: up to 227 KB ("split" on a few long
// rows), 48 KB for B9g
constexpr int kSplitMaxSmem = 232448 - 16;
constexpr int kGatherMaxSmem = 48 * 1024;

// "rows": one thread a row (consecutive threads on consecutive rows, so
// each slot plane is read in coalesced lines), its slots up to len[i] in
// groups of kRowsAhead whose indices and values load, then their x,
// behind keep_order(), before the group is summed.  Where every row is as
// long as the plan (len null), a plain loop over its k slots, whose loads
// the compiler keeps ahead on its own (fenced groups measured 13% slower
// at 1,002,001 rows, K = 8: PERF.md).
template <typename T, typename Idx>
__global__ void __launch_bounds__(kRowsThreads)
ell_rows(const T* __restrict__ data, const Idx* __restrict__ idx,
         const int* __restrict__ len, const T* __restrict__ x,
         T* __restrict__ y, BandLayout l) {
  constexpr int A = kRowsAhead;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= l.count) return;
  const long long base = window_base(i, l.block_rows);
  const T* __restrict__ d = data + i;
  const Idx* __restrict__ c = idx + i;
  T acc = T(0);
  if (len == nullptr) {  // every row as long as the plan: the plain loop
    for (int s = 0; s < l.k; ++s)
      acc = add_rn(acc, mul_rn(d[s * l.plane],
                               x[base + static_cast<long long>(
                                            c[s * l.plane])]));
    y[i] = acc;
    return;
  }
  const int n = len[i];
  int s = 0;
  for (; s + A <= n; s += A) {
    Idx gc[A];
    T gv[A], gx[A];
#pragma unroll
    for (int u = 0; u < A; ++u) gc[u] = c[(s + u) * l.plane];
#pragma unroll
    for (int u = 0; u < A; ++u) gv[u] = d[(s + u) * l.plane];
#pragma unroll
    for (int u = 0; u < A; ++u) gx[u] = x[base + static_cast<long long>(gc[u])];
    keep_order();  // the group's loads stay issued before its sums
#pragma unroll
    for (int u = 0; u < A; ++u) acc = add_rn(acc, mul_rn(gv[u], gx[u]));
  }
  for (; s < n; ++s)
    acc = add_rn(acc, mul_rn(d[s * l.plane],
                             x[base + static_cast<long long>(c[s * l.plane])]));
  y[i] = acc;
}

// Odd, so that the rows' products sit a pitch apart on distinct banks.
__host__ __device__ constexpr int pitch_of(int chunk) { return chunk | 1; }

// Lane `lane` of `lanes` multiplies slots lane, lane + lanes, ... of
// [c0, end) of a row whose values and indices start at d and c (its
// slots contiguous) into prod[slot - c0], in groups of kSplitAhead slots
// whose loads issue before their x gathers and those before the products
// (the last group predicated, so a short row loads in one round).  With SKIP (the
// absolute form, whose padding has no length to stop at) a zero value
// loads no index and gathers no x, and its product is +0: 0 x is +-0 for a
// finite x, which leaves the row's sum as it is.
template <typename T, typename Idx, bool SKIP, bool TAIL>
__device__ __forceinline__ void lane_group(const T* __restrict__ d,
                                           const Idx* __restrict__ c,
                                           const T* __restrict__ x,
                                           long long base, int s, int c0,
                                           int end, int lanes, T* prod) {
  constexpr int A = kSplitAhead;
  bool ok[A];
  Idx gc[A];
  T gv[A], gx[A];
#pragma unroll
  for (int u = 0; u < A; ++u) {
    ok[u] = !TAIL || s + u * lanes < end;
    gv[u] = ok[u] ? d[s + u * lanes] : T(0);
  }
#pragma unroll
  for (int u = 0; u < A; ++u) {
    if (SKIP) ok[u] = ok[u] && gv[u] != T(0);
    gc[u] = ok[u] ? c[s + u * lanes] : Idx(0);
  }
#pragma unroll
  for (int u = 0; u < A; ++u)
    gx[u] = ok[u] ? x[base + static_cast<long long>(gc[u])] : T(0);
#pragma unroll
  for (int u = 0; u < A; ++u)
    if (!TAIL || s + u * lanes < end)
      prod[s + u * lanes - c0] = ok[u] ? mul_rn(gv[u], gx[u]) : T(0);
}

template <typename T, typename Idx, bool SKIP>
__device__ __forceinline__ void lane_products(const T* __restrict__ d,
                                              const Idx* __restrict__ c,
                                              const T* __restrict__ x,
                                              long long base, int c0,
                                              int end, int lane, int lanes,
                                              T* prod) {
  constexpr int A = kSplitAhead;
  int s = c0 + lane;
  for (; s + (A - 1) * lanes < end; s += A * lanes)
    lane_group<T, Idx, SKIP, false>(d, c, x, base, s, c0, end, lanes, prod);
  if (s < end)  // the last, partial group: one round of loads
    lane_group<T, Idx, SKIP, true>(d, c, x, base, s, c0, end, lanes, prod);
}

// Thread r of a block of `tr` rows adds prod[r][0, n) to acc in slot
// order.
template <typename T>
__device__ __forceinline__ T add_in_order(T acc, const T* prod, int n) {
#pragma unroll 8
  for (int t = 0; t < n; ++t) acc = add_rn(acc, prod[t]);
  return acc;
}

// Four consecutive elements from p (16-byte loads where `vec`: p then
// lies on 4 elements' alignment), v[u] = 0 past `n`.
__device__ __forceinline__ void load4(const float* p, bool vec, int n,
                                      float (&v)[4]) {
  if (vec) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = u < n ? __ldg(p + u) : 0.0f;
}
__device__ __forceinline__ void load4(const double* p, bool vec, int n,
                                      double (&v)[4]) {
  if (vec) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = u < n ? __ldg(p + u) : 0.0;
}
__device__ __forceinline__ void load4(const int* p, bool vec, int n,
                                      int (&v)[4]) {
  if (vec) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = u < n ? __ldg(p + u) : 0;
}
__device__ __forceinline__ void load4(const int16_t* p, bool vec, int n,
                                      int16_t (&v)[4]) {
  if (vec) {
    const short4 w = __ldg(reinterpret_cast<const short4*>(p));
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = u < n ? __ldg(p + u) : int16_t(0);
}

// "sliced" (and B9g on tall matrices, ABS): one thread a row, its slots
// in groups of 4 read as 16-byte loads, G groups loaded before their x
// gathers and those before the sums.  Sliced: the computed rows, sorted
// by length within windows of rows (order[j]: the row at position j),
// stored in slices of 32 positions, group g of position j at (((j / 32) *
// plane + g) * 32 + j % 32) * 4: a warp's lanes read a group of their 32
// rows as one contiguous line, and no lane loads past its own ng[j]
// groups (rows of a slice, sorted, are about as long as each other).
// ABS: absolute columns, row i at data / idx + i k (vec where k and the
// pointers allow 16-byte loads), a zero value's column and x skipped (a
// group of four zeros loads no columns): 0 x is +-0 for a finite x, which
// leaves the sum as it is.  ZERO: the non-empty rows alone are computed,
// and blocks past the computing ones write the empty rows' zeros.
template <typename T, typename Idx, bool ZERO, bool ABS, int G>
__global__ void __launch_bounds__(kRowsThreads)
ell_packed(const T* __restrict__ data, const Idx* __restrict__ idx,
           const int* __restrict__ ng, const int* __restrict__ order,
           const int* __restrict__ bits, const T* __restrict__ x,
           T* __restrict__ y, BandLayout l, bool vec) {
  if (ZERO && zero_empty_rows(bits, y, l)) return;
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (j >= l.count) return;
  const long long i = ABS ? j : static_cast<long long>(order[j]);
  const int groups = ABS ? (l.k + 3) >> 2 : ng[j];
  const long long start =
      ABS ? i * l.k : (((j >> 5) * l.plane) * 32 + (j & 31)) * 4;
  const long long stride = ABS ? 4 : 128;  // elements between groups
  const long long base = ABS ? 0 : window_base(i, l.block_rows);
  T acc = T(0);
  for (int g0 = 0; g0 < groups; g0 += G) {
    T v[G][4], gx[G][4];
    Idx c[G][4];
    int nh[G];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const int g = g0 + h;
      nh[h] = g >= groups ? 0 : ABS ? min(4, l.k - 4 * g) : 4;
      if (nh[h] > 0)
        load4(data + start + g * stride, vec && nh[h] == 4, nh[h], v[h]);
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      bool any = nh[h] > 0;
      if (ABS) any = any && (v[h][0] != T(0) || v[h][1] != T(0) ||
                             v[h][2] != T(0) || v[h][3] != T(0));
      if (any) {
        load4(idx + start + (g0 + h) * stride, vec && nh[h] == 4, nh[h],
              c[h]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) c[h][u] = Idx(0);
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool use = u < nh[h] && (!ABS || v[h][u] != T(0));
        gx[h][u] = use ? x[base + static_cast<long long>(c[h][u])] : T(0);
      }
    keep_order();  // the groups' loads stay issued before their sums
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < nh[h] && (!ABS || v[h][u] != T(0)))
          acc = add_rn(acc, mul_rn(v[h][u], gx[h][u]));
  }
  y[i] = acc;
}

// "split": a block of 2^tile_shift packed rows (TR), 256 / TR lanes a row
// (r = thread / lanes, a row's lanes adjacent, so they read its slots in
// consecutive addresses).  Per chunk of slots each lane multiplies its
// share of its row into shared memory (prod[r][slot], rows a pitch
// apart), then the row's lane 0 adds them in slot order.  The loads of a
// row spread over its lanes; only the sum, out of shared memory, stays
// one chain.  With LIVE row j stands for row live[j], and blocks past the
// computing ones write the empty rows' zeros.
template <typename T, typename Idx, bool LIVE>
__global__ void __launch_bounds__(kSplitThreads)
ell_split(const T* __restrict__ data, const Idx* __restrict__ idx,
          const int* __restrict__ ptr, const int* __restrict__ live,
          const int* __restrict__ bits, const T* __restrict__ x,
          T* __restrict__ y, BandLayout l, int tile_shift, int chunk) {
  if (LIVE && zero_empty_rows(bits, y, l)) return;
  extern __shared__ __align__(16) char smem[];
  T* prod = reinterpret_cast<T*>(smem);
  __shared__ int tile_len;
  const int lanes = kSplitThreads >> tile_shift;
  const int lane_shift = 8 - tile_shift;
  const int r = threadIdx.x >> lane_shift;
  const int lane = threadIdx.x & (lanes - 1);
  const int pitch = pitch_of(chunk);
  const long long j = (static_cast<long long>(blockIdx.x) << tile_shift) + r;
  const bool in = j < l.count;
  const long long i = in ? (LIVE ? static_cast<long long>(live[j]) : j) : 0;
  const int start = in ? ptr[j] : 0;
  const int n = in ? ptr[j + 1] - start : 0;
  const long long base = window_base(i, l.block_rows);
  if (threadIdx.x == 0) tile_len = 0;
  __syncthreads();
  if (lane == 0 && n > 0) atomicMax(&tile_len, n);
  __syncthreads();
  const int most = tile_len;
  T acc = T(0);
  for (int c0 = 0; c0 < most; c0 += chunk) {
    const int end = min(n, c0 + chunk);
    lane_products<T, Idx, false>(data + start, idx + start, x, base, c0, end,
                                 lane, lanes, prod + r * pitch);
    __syncthreads();
    if (lane == 0) acc = add_in_order(acc, prod + r * pitch, end - c0);
    __syncthreads();
  }
  if (!in || lane != 0) return;
  y[i] = acc;
}

// -- B9g: absolute columns, row-major data / cols [N, K] ---------------------

// The "split" kernel on the matrix's own rows: a block of 2^tile_shift
// rows, 256 / TR lanes a row (the block reads one contiguous span), a zero
// value's index and x skipped (lane_products with SKIP), then each row's
// lane 0 adds its products in slot order.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
ell_gather(const T* __restrict__ data, const int* __restrict__ cols,
           const T* __restrict__ x, T* __restrict__ y, long long rows, int k,
           int tile_shift, int chunk) {
  extern __shared__ __align__(16) char smem[];
  T* prod = reinterpret_cast<T*>(smem);
  const int lanes = kSplitThreads >> tile_shift;
  const int lane_shift = 8 - tile_shift;
  const int r = threadIdx.x >> lane_shift;
  const int lane = threadIdx.x & (lanes - 1);
  const int pitch = pitch_of(chunk);
  const long long i = (static_cast<long long>(blockIdx.x) << tile_shift) + r;
  const bool in = i < rows;
  const long long row = (in ? i : 0) * k;
  T acc = T(0);
  for (int c0 = 0; c0 < k; c0 += chunk) {
    const int end = in ? min(k, c0 + chunk) : c0;
    lane_products<T, int, true>(data + row, cols + row, x, 0, c0, end, lane,
                                lanes, prod + r * pitch);
    __syncthreads();
    if (lane == 0) acc = add_in_order(acc, prod + r * pitch, end - c0);
    __syncthreads();
  }
  if (in && lane == 0) y[i] = acc;
}

// B9g staged: a block of kStageRows rows, a thread each.  Per chunk of
// `chunk` slots (a multiple of 4) the block copies its rows' values and
// columns of the chunk (each row's piece a run of 16-byte units, the rows
// K apart) into shared memory with cp.async, each row at an odd pitch of
// 16-byte units, so that a warp's 16-byte reads of one group of 4 slots
// (eight lanes a phase) fall on distinct banks; then each thread sums its
// row's groups from shared memory in slot order, kGatherGroups groups'
// x gathers issued before their sums, a zero value's gather skipped.  The
// device reads of a row's values and columns are whole lines; what is
// left is the x gathers.  Requires k % 4 == 0 and 16-byte aligned arrays.
constexpr int kStageRows = 128;

template <typename T>
__host__ __device__ constexpr int stage_units(int chunk) {
  return chunk * static_cast<int>(sizeof(T)) / 16;
}

template <typename T>
size_t stage_smem(int chunk) {
  return static_cast<size_t>(kStageRows) *
         ((stage_units<T>(chunk) | 1) + ((chunk / 4) | 1)) * 16;
}

// Four values of T from shared memory (one or two 16-byte units).
__device__ __forceinline__ void smem4(const uint4* p, float (&v)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
}
__device__ __forceinline__ void smem4(const uint4* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 1);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(kStageRows)
ell_gather_staged(const T* __restrict__ data, const int* __restrict__ cols,
                  const T* __restrict__ x, T* __restrict__ y, long long rows,
                  int k, int chunk) {
  constexpr int G = kGatherGroups;
  constexpr int VG = 4 * static_cast<int>(sizeof(T)) / 16;  // units a group
  extern __shared__ __align__(16) char smem[];
  const int vpitch = stage_units<T>(chunk) | 1;
  const int cpitch = (chunk / 4) | 1;
  uint4* sv = reinterpret_cast<uint4*>(smem);
  uint4* sc = sv + kStageRows * vpitch;
  constexpr int VU = 16 / static_cast<int>(sizeof(T));  // values a unit
  const long long r0 = static_cast<long long>(blockIdx.x) * kStageRows;
  const int nr = static_cast<int>(min(static_cast<long long>(kStageRows),
                                      rows - r0));
  const int r = threadIdx.x;
  const uint4* mv = sv + r * vpitch;
  const int4* mc = reinterpret_cast<const int4*>(sc + r * cpitch);
  T acc = T(0);
  for (int c0 = 0; c0 < k; c0 += chunk) {
    const int cn = min(chunk, k - c0);
    const int nv = stage_units<T>(cn), nc = cn / 4;
    for (int e = threadIdx.x; e < nr * nv; e += kStageRows) {
      const int q = e / nv, u = e - q * nv;
      tpufem::cp_async<16>(
          sv + q * vpitch + u,
          data + (r0 + q) * static_cast<long long>(k) + c0 + u * VU, 16);
    }
    for (int e = threadIdx.x; e < nr * nc; e += kStageRows) {
      const int q = e / nc, u = e - q * nc;
      tpufem::cp_async<16>(sc + q * cpitch + u,
                           cols + (r0 + q) * static_cast<long long>(k) + c0 +
                               u * 4,
                           16);
    }
    tpufem::cp_async_commit();
    tpufem::cp_async_wait_all();
    __syncthreads();
    if (r < nr) {
      for (int g0 = 0; g0 < nc; g0 += G) {
        T v[G][4], gx[G][4];
        int c[G][4];
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (g0 + h < nc) {
            smem4(mv + (g0 + h) * VG, v[h]);
            const int4 w = mc[g0 + h];
            c[h][0] = w.x, c[h][1] = w.y, c[h][2] = w.z, c[h][3] = w.w;
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) v[h][u] = T(0), c[h][u] = 0;
          }
        }
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            gx[h][u] = v[h][u] != T(0) ? x[c[h][u]] : T(0);
        keep_order();  // the groups' gathers stay issued before their sums
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (v[h][u] != T(0)) acc = add_rn(acc, mul_rn(v[h][u], gx[h][u]));
      }
    }
    __syncthreads();
  }
  if (r < nr) y[r0 + r] = acc;
}

// B9g, lanes a row: L lanes of a warp share a row (32 / L consecutive
// rows a warp), lane l taking the row's groups of 4 slots l, l + L, ...,
// so that one load of the warp reads its rows' pieces of 4 L slots: whole
// lines where 4 L sizeof(T) >= 128.  kLaneAhead rounds of groups load
// their values, then their columns (none for a group of four zeros), then
// their x, before any sum; then the row's sum runs in slot order as a
// relay: the lane of group g adds its products (a zero value's skipped:
// 0 x is +-0 for a finite x) and a shuffle hands the sum to the lane of
// group g + 1.
constexpr int kLaneAhead = 2;
constexpr int kLaneThreads = 256;

template <typename T, int L>
__global__ void __launch_bounds__(kLaneThreads)
ell_gather_lanes(const T* __restrict__ data, const int* __restrict__ cols,
                 const T* __restrict__ x, T* __restrict__ y, long long rows,
                 int k, bool vec) {
  constexpr int A = kLaneAhead;
  const int sub = threadIdx.x & (L - 1);
  const int lead = (threadIdx.x & 31) - sub;  // the row's first lane
  const long long i =
      (blockIdx.x * static_cast<long long>(kLaneThreads) + threadIdx.x) / L;
  const bool in = i < rows;
  const T* __restrict__ d = data + (in ? i : 0) * static_cast<long long>(k);
  const int* __restrict__ c = cols + (in ? i : 0) * static_cast<long long>(k);
  const int groups = (k + 3) >> 2;
  T acc = T(0);
  for (int g0 = 0; g0 < groups; g0 += A * L) {
    T v[A][4], gx[A][4];
    int cc[A][4], n[A];
#pragma unroll
    for (int h = 0; h < A; ++h) {
      const int g = g0 + h * L + sub;
      n[h] = in && g < groups ? min(4, k - 4 * g) : 0;
      if (n[h] > 0) {
        load4(d + 4 * g, vec, n[h], v[h]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) v[h][u] = T(0);
      }
    }
#pragma unroll
    for (int h = 0; h < A; ++h) {
      if (v[h][0] != T(0) || v[h][1] != T(0) || v[h][2] != T(0) ||
          v[h][3] != T(0)) {
        load4(c + 4 * (g0 + h * L + sub), vec, n[h], cc[h]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) cc[h][u] = 0;
      }
    }
#pragma unroll
    for (int h = 0; h < A; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        gx[h][u] = v[h][u] != T(0) ? x[cc[h][u]] : T(0);
    keep_order();  // the rounds' loads stay issued before the relay
#pragma unroll
    for (int h = 0; h < A; ++h) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (sub == l) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (v[h][u] != T(0)) acc = add_rn(acc, mul_rn(v[h][u], gx[h][u]));
        }
        acc = __shfl_sync(0xffffffffu, acc, lead + l);
      }
    }
  }
  if (in && sub == 0) y[i] = acc;
}

template <typename T>
size_t split_smem(int tile_shift, int chunk) {
  return (static_cast<size_t>(1) << tile_shift) * pitch_of(chunk) * sizeof(T);
}

// form 0: "rows" (len: row lengths [count = rows]); 1: "split" (len: the
// packed rows' offsets [count + 1]; live, bits non-null: the non-empty
// rows alone); 2: "sliced" (len: each position's groups [count], live:
// its row, plane: the slices' groups; bits non-null: the non-empty rows
// alone; 16-byte aligned arrays).
template <typename T, typename Idx>
int launch_band(const void* data, const void* idx, const void* len,
                const void* live, const void* bits, const void* x, void* y,
                long long rows, long long count, long long plane,
                long long block_rows, int k, int form, int tile_shift,
                int chunk, void* stream) {
  if (rows < 0 || count < 0 || count > rows || k < 0 || block_rows < 1 ||
      form < 0 || form > 2 ||
      (form == 0 && (live != nullptr || count != rows || plane < rows)) ||
      (form != 0 && len == nullptr) ||
      (form == 1 && ((live == nullptr && count != rows) ||
                     ((live == nullptr) != (bits == nullptr)))) ||
      (form == 2 && (live == nullptr || plane < 0 ||
                     (bits == nullptr && count != rows))) ||
      (form == 1 && (tile_shift < 0 || tile_shift > 7 || chunk < 1 ||
                     split_smem<T>(tile_shift, chunk) > kSplitMaxSmem)) ||
      (form == 2 && !tpufem::aligned16({data, idx})))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const long long tr = form == 1 ? 1LL << tile_shift : kRowsThreads;
  const auto work = static_cast<unsigned>((count + tr - 1) / tr);
  // LIVE: the blocks that write the empty rows' zeros, after the work
  const unsigned zero_blocks =
      bits == nullptr ? 0
                      : static_cast<unsigned>((rows + kSplitThreads - 1) /
                                              kSplitThreads);
  const BandLayout l{rows, count, plane, block_rows, k, work};
  const auto* dv = static_cast<const T*>(data);
  const auto* iv = static_cast<const Idx*>(idx);
  const auto* nv = static_cast<const int*>(len);
  const auto* lv = static_cast<const int*>(live);
  const auto* bv = static_cast<const int*>(bits);
  const auto* xv = static_cast<const T*>(x);
  auto* yv = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = work + zero_blocks;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (form == 0) {
    ell_rows<T, Idx><<<blocks, kRowsThreads, 0, s>>>(dv, iv, nv, xv, yv, l);
    return static_cast<int>(cudaGetLastError());
  }
  if (form == 2) {
    if (bv != nullptr)
      ell_packed<T, Idx, true, false, kSlicedGroups>
          <<<blocks, kRowsThreads, 0, s>>>(dv, iv, nv, lv, bv, xv, yv, l,
                                           true);
    else
      ell_packed<T, Idx, false, false, kSlicedGroups>
          <<<blocks, kRowsThreads, 0, s>>>(dv, iv, nv, lv, bv, xv, yv, l,
                                           true);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = split_smem<T>(tile_shift, chunk);
  int err;
  if (lv != nullptr) {
    err = tpufem::allow_smem<ell_split<T, Idx, true>>(smem);
    if (err == 0)
      ell_split<T, Idx, true><<<blocks, kSplitThreads, smem, s>>>(
          dv, iv, nv, lv, bv, xv, yv, l, tile_shift, chunk);
  } else {
    err = tpufem::allow_smem<ell_split<T, Idx, false>>(smem);
    if (err == 0)
      ell_split<T, Idx, false><<<blocks, kSplitThreads, smem, s>>>(
          dv, iv, nv, lv, bv, xv, yv, l, tile_shift, chunk);
  }
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// tile_shift -1: a thread a row, on the rows as they are (ell_packed,
// absolute; chunk 0) or staged in chunks of `chunk` slots
// (ell_gather_staged); -2, -3: 4 or 8 lanes a row (ell_gather_lanes);
// else the split kernel's tile (ell_gather).
template <typename T>
int launch_gather(const void* data, const void* cols, const void* x, void* y,
                  long long rows, int k, int tile_shift, int chunk,
                  void* stream) {
  const bool staged = tile_shift == -1 && chunk > 0;
  const bool lanes = tile_shift == -2 || tile_shift == -3;
  if (rows < 0 || k < 1 || tile_shift < -3 || tile_shift > 7 ||
      (tile_shift >= 0 &&
       (chunk < 1 || split_smem<T>(tile_shift, chunk) > kGatherMaxSmem)) ||
      (staged && (k % 4 != 0 || chunk % 4 != 0 ||
                  stage_smem<T>(chunk) > kSplitMaxSmem ||
                  !tpufem::aligned16({data, cols}))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dv = static_cast<const T*>(data);
  const auto* cv = static_cast<const int*>(cols);
  const auto* xv = static_cast<const T*>(x);
  auto* yv = static_cast<T*>(y);
  if (lanes) {  // 4 or 8 lanes a row
    const bool vec = k % 4 == 0 && tpufem::aligned16({data, cols});
    const long long threads = rows << -tile_shift;
    const auto blocks =
        static_cast<unsigned>((threads + kLaneThreads - 1) / kLaneThreads);
    if (tile_shift == -2)
      ell_gather_lanes<T, 4>
          <<<blocks, kLaneThreads, 0, s>>>(dv, cv, xv, yv, rows, k, vec);
    else
      ell_gather_lanes<T, 8>
          <<<blocks, kLaneThreads, 0, s>>>(dv, cv, xv, yv, rows, k, vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (staged) {
    const size_t smem = stage_smem<T>(chunk);
    const int err = tpufem::allow_smem<ell_gather_staged<T>>(smem);
    if (err != 0) return err;
    ell_gather_staged<T>
        <<<static_cast<unsigned>((rows + kStageRows - 1) / kStageRows),
           kStageRows, smem, s>>>(dv, cv, xv, yv, rows, k, chunk);
    return static_cast<int>(cudaGetLastError());
  }
  if (tile_shift < 0) {
    const auto blocks =
        static_cast<unsigned>((rows + kRowsThreads - 1) / kRowsThreads);
    const BandLayout l{rows, rows, 0, 0, k, blocks};
    ell_packed<T, int, false, true, kGatherGroups>
        <<<blocks, kRowsThreads, 0, s>>>(dv, cv, nullptr, nullptr, nullptr,
                                         xv, yv, l,
        k % 4 == 0 && tpufem::aligned16({data, cols}));
    return static_cast<int>(cudaGetLastError());
  }
  const long long tr = 1LL << tile_shift;
  ell_gather<T><<<static_cast<unsigned>((rows + tr - 1) / tr), kSplitThreads,
                  split_smem<T>(tile_shift, chunk), s>>>(
      dv, cv, xv, yv, rows, k, tile_shift, chunk);
  return static_cast<int>(cudaGetLastError());
}

// -- B10: q right-hand sides ------------------------------------------------

// Slots a group on the banded plan: their indices and values load, then
// their X rows are gathered, then they are summed.  2 measured fastest
// (scripts/spmv_ablation.py builds others through TPUFEM_ELL_AHEAD,
// spmv_probe.cuh).
constexpr int kMultiAhead = TPUFEM_ELL_AHEAD;

constexpr int kMultiMaxQ = 8;         // unrolled q; larger q in passes of 8
constexpr int kMultiMaxThreads = 256;
constexpr int kSmemPerBlock = 232448;  // 227 KB of dynamic shared memory
// at least the static shared memory of ell_spmv_multi (block_min_max's),
// which counts against the same limit
constexpr int kStaticSmem = 1024;

// 16 and 8 bytes of T: the widest accesses of an X or Y row.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using v16 = float4;
  using v8 = float2;
};
template <>
struct Vec<double> {
  using v16 = double2;
  using v8 = double;
};
template <>
struct Vec<int> {
  using v16 = int4;
  using v8 = int2;
};

__device__ __forceinline__ void unpack(const float4& w, float* v) {
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void unpack(const float2& w, float* v) {
  v[0] = w.x;
  v[1] = w.y;
}
__device__ __forceinline__ void unpack(const double2& w, double* v) {
  v[0] = w.x;
  v[1] = w.y;
}
__device__ __forceinline__ void unpack(double w, double* v) { v[0] = w; }
__device__ __forceinline__ void unpack(const int4& w, int* v) {
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void unpack(const int2& w, int* v) {
  v[0] = w.x;
  v[1] = w.y;
}
__device__ __forceinline__ float4 pack16(const float* v) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ double2 pack16(const double* v) {
  return make_double2(v[0], v[1]);
}
__device__ __forceinline__ float2 pack8(const float* v) {
  return make_float2(v[0], v[1]);
}
__device__ __forceinline__ double pack8(const double* v) { return v[0]; }

// Bytes of the widest access to a row of Q values of T: 16 or 8 where Q
// values fill whole accesses and `align` (the bytes every row of the
// array is aligned to) allows it, else sizeof(T).
template <typename T, int Q>
__device__ __forceinline__ int row_access(int align) {
  constexpr int bytes = Q * static_cast<int>(sizeof(T));
  return (bytes % 16 == 0 && align % 16 == 0)  ? 16
         : (bytes % 8 == 0 && align % 8 == 0) ? 8
                                               : static_cast<int>(sizeof(T));
}

// The widest access (16, 8 or sizeof(T) bytes) that Q values of T at p
// fill and p's alignment allows.
template <typename T, int Q>
__device__ __forceinline__ int span_access(const void* p) {
  return row_access<T, Q>(
      static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15) == 0
          ? 16
          : static_cast<int>(reinterpret_cast<uintptr_t>(p) & 7) == 0 ? 8
                                                                      : 4);
}

// v[j] = p[j] for j < n (n == Q unless Q is the pass of the run-time q).
template <typename T, int Q>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int n,
                                         int access, T (&v)[Q]) {
  using V = Vec<T>;
  constexpr int E = static_cast<int>(sizeof(T));
  if constexpr ((Q * E) % 16 == 0) {
    if (access == 16) {
#pragma unroll
      for (int h = 0; h < (Q * E) / 16; ++h)
        unpack(__ldg(reinterpret_cast<const typename V::v16*>(p) + h),
               v + h * (16 / E));
      return;
    }
  }
  if constexpr ((Q * E) % 8 == 0) {
    if (access == 8) {
#pragma unroll
      for (int h = 0; h < (Q * E) / 8; ++h)
        unpack(__ldg(reinterpret_cast<const typename V::v8*>(p) + h),
               v + h * (8 / E));
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) v[j] = j < n ? __ldg(p + j) : T(0);
}

template <typename T, int Q>
__device__ __forceinline__ void store_row(T* __restrict__ p, int n,
                                          int access, const T (&v)[Q]) {
  using V = Vec<T>;
  constexpr int E = static_cast<int>(sizeof(T));
  if constexpr ((Q * E) % 16 == 0) {
    if (access == 16) {
#pragma unroll
      for (int h = 0; h < (Q * E) / 16; ++h)
        reinterpret_cast<typename V::v16*>(p)[h] = pack16(v + h * (16 / E));
      return;
    }
  }
  if constexpr ((Q * E) % 8 == 0) {
    if (access == 8) {
#pragma unroll
      for (int h = 0; h < (Q * E) / 8; ++h)
        reinterpret_cast<typename V::v8*>(p)[h] = pack8(v + h * (8 / E));
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j)
    if (j < n) p[j] = v[j];
}

// The smallest and largest of lo, hi over the block (every thread gets
// them).  blockDim.x is a multiple of 32.
__device__ __forceinline__ void block_min_max(int& lo, int& hi) {
  __shared__ int part[2][kMultiMaxThreads / 32];
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = lo;
    part[1][warp] = hi;
  }
  __syncthreads();
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    lo = min(lo, part[0][w]);
    hi = max(hi, part[1][w]);
  }
}

// One thread per row i (consecutive threads on consecutive rows) holds
// the Q sums Y[i, j0 + j] in registers.  The block first finds the span
// [lo, hi] of its rows' columns and, where it fits the `window` rows of
// shared memory, copies X[lo .. hi] (one contiguous span) into it, so the
// gathers read shared memory; a wider span is gathered from device
// memory.  Each group of G slots loads its indices and values (the first
// group's values before the staging), then gathers its X rows, then sums
// them in slot order: G = kMultiAhead on the banded plan; ABS, the
// absolute form (int32 columns, row-major: a row's slots contiguous),
// takes 16 bytes of a row's values a group, in 8- or 16-byte accesses.
// Q = 0: q at run time, in passes of kMultiMaxQ columns.  `align`: the
// bytes every row of X and Y is aligned to.
template <typename T, typename Idx, int Q, bool ABS>
__global__ void __launch_bounds__(kMultiMaxThreads)
ell_spmv_multi(const T* __restrict__ data, const Idx* __restrict__ idx,
               const T* __restrict__ X, T* __restrict__ Y, EllLayout l,
               int q, int align, int window) {
  static_assert(!ABS || sizeof(Idx) == 4, "absolute columns are int32");
  extern __shared__ __align__(16) char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  constexpr int QC = Q > 0 ? Q : kMultiMaxQ;
  constexpr int G = ABS ? 16 / static_cast<int>(sizeof(T)) : kMultiAhead;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const bool live = i < l.rows;
  const long long base = window_base(live ? i : 0, l.block_rows);
  const T* __restrict__ d = data + (live ? i : 0) * l.row_stride;
  const Idx* __restrict__ c = idx + (live ? i : 0) * l.row_stride;
  const int nq = Q > 0 ? Q : q;

  T v0[G];  // the first group's values, in flight across the staging
  if (live) {
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (u < l.k) v0[u] = d[u * l.slot_stride];
  }
  bool staged = false;
  int lo = INT_MAX, hi = INT_MIN;
  if (window > 0) {  // the same for every block
    if (live) {
      for (int s = 0; s < l.k; ++s) {
        const int cs = static_cast<int>(base + c[s * l.slot_stride]);
        lo = min(lo, cs);
        hi = max(hi, cs);
      }
    }
    block_min_max(lo, hi);
    staged = hi >= lo && hi - lo < window;
    if (staged) {
      const T* src = X + static_cast<long long>(lo) * nq;
      for (int e = threadIdx.x; e < (hi - lo + 1) * nq; e += blockDim.x)
        tpufem::cp_async<sizeof(T)>(xs + e, src + e, sizeof(T));
      tpufem::cp_async_commit();
      tpufem::cp_async_wait_all();
    }
    __syncthreads();
  }
  if (!live) return;
  const int access = Q > 0 ? row_access<T, QC>(align) : 0;

  for (int j0 = 0; j0 < nq; j0 += QC) {
    const int n = min(QC, nq - j0);
    T acc[QC];
#pragma unroll
    for (int j = 0; j < QC; ++j) acc[j] = T(0);
    for (int s0 = 0; s0 < l.k; s0 += G) {
      int col[G];
      T v[G];
      T xv[G][QC];
      if (ABS && s0 + G <= l.k) {  // the group's slots are contiguous
        int ci[G];
        T dv[G];
        const int* cp = reinterpret_cast<const int*>(c) + s0;
        load_row<int, G>(cp, G, span_access<int, G>(cp), ci);
        load_row<T, G>(d + s0, G, span_access<T, G>(d + s0), dv);
#pragma unroll
        for (int u = 0; u < G; ++u) {
          col[u] = static_cast<int>(base + ci[u]);
          v[u] = s0 == 0 ? v0[u] : dv[u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if (s0 + u >= l.k) break;
          const long long o = (s0 + u) * l.slot_stride;
          col[u] = static_cast<int>(base + c[o]);
          v[u] = s0 == 0 ? v0[u] : d[o];
        }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (s0 + u >= l.k) break;
        if (staged) {  // row col - lo of the window
          const T* row = xs + (col[u] - lo) * nq + j0;
#pragma unroll
          for (int j = 0; j < QC; ++j) xv[u][j] = j < n ? row[j] : T(0);
        } else {
          load_row<T, QC>(X + static_cast<long long>(col[u]) * nq + j0, n,
                          access, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (s0 + u >= l.k) break;
#pragma unroll
        for (int j = 0; j < QC; ++j)
          acc[j] = add_rn(acc[j], mul_rn(v[u], xv[u][j]));
      }
    }
    store_row<T, QC>(Y + i * nq + j0, n, access, acc);
  }
}

template <typename T, typename Idx, int Q, bool ABS>
int launch_multi_form(const T* data, const Idx* idx, const T* x, T* y,
                      const EllLayout& l, int q, int align, int threads,
                      int window, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(window) * q * sizeof(T);
  const int err =
      tpufem::allow_smem<ell_spmv_multi<T, Idx, Q, ABS>>(smem + kStaticSmem);
  if (err != 0) return err;
  const auto blocks = static_cast<unsigned>((l.rows + threads - 1) / threads);
  ell_spmv_multi<T, Idx, Q, ABS><<<blocks, threads, smem, s>>>(
      data, idx, x, y, l, q, align, window);
  return static_cast<int>(cudaGetLastError());
}

// The banded instance, or the absolute form's (row-major int32 columns).
template <typename T, typename Idx, int Q>
int launch_multi_q(const T* data, const Idx* idx, const T* x, T* y,
                   const EllLayout& l, int q, int align, int threads,
                   int window, cudaStream_t s) {
  if constexpr (sizeof(Idx) == 4) {
    if (l.block_rows == 0 && l.slot_stride == 1)
      return launch_multi_form<T, Idx, Q, true>(data, idx, x, y, l, q, align,
                                                threads, window, s);
  }
  return launch_multi_form<T, Idx, Q, false>(data, idx, x, y, l, q, align,
                                             threads, window, s);
}

// B10 on q >= 2 columns: the instance of q up to 8, the run-time one
// beyond; threads a block (one row each), staging up to `window` rows of
// X.  align: the bytes every row of X and Y starts on (the wrapper's: both
// base pointers and the row pitch q sizeof(T)).  Columns must fit an int.
template <typename T, typename Idx>
int launch_multi(const void* data, const void* idx, const void* x, void* y,
                 long long rows, int k, long long row_stride,
                 long long slot_stride, long long block_rows, int q,
                 int align, int threads, int window, void* stream) {
  if (rows < 0 || rows > INT_MAX || k < 1 || q < 2 || block_rows < 0 ||
      threads < 32 || threads > kMultiMaxThreads || threads % 32 != 0 ||
      align < 1 || window < 0 ||
      static_cast<long long>(window) * q * sizeof(T) + kStaticSmem >
          kSmemPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const EllLayout l{rows, k, row_stride, slot_stride, block_rows};
  const auto* dv = static_cast<const T*>(data);
  const auto* iv = static_cast<const Idx*>(idx);
  const auto* xv = static_cast<const T*>(x);
  auto* yv = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q) {
#define TPUFEM_ELL_Q(Q)                                                      \
  case Q:                                                                    \
    return launch_multi_q<T, Idx, Q>(dv, iv, xv, yv, l, q, align, threads,   \
                                     window, s);
    TPUFEM_ELL_Q(2)
    TPUFEM_ELL_Q(3)
    TPUFEM_ELL_Q(4)
    TPUFEM_ELL_Q(5)
    TPUFEM_ELL_Q(6)
    TPUFEM_ELL_Q(7)
    TPUFEM_ELL_Q(8)
#undef TPUFEM_ELL_Q
    default:
      return launch_multi_q<T, Idx, 0>(dv, iv, xv, yv, l, q, align, threads,
                                       window, s);
  }
}

}  // namespace

extern "C" {

// B9 on the banded plan: y = A x.  form 0 "rows": the planes data_t / rel
// [k, plane] and the row lengths len [rows]; forms 1 "split" (tile_shift,
// chunk) and 2 "packed": the packed rows data / idx with offsets len
// [count + 1] and, for the non-empty rows alone, live [count] and their
// bitmap bits [(rows + 31) / 32].
#define TPUFEM_ELL_BAND_ENTRY(NAME, T, IDX)                                  \
  int NAME(const void* data, const void* idx, const void* len,               \
           const void* live, const void* bits, const void* x, void* y,       \
           long long rows, long long count, long long plane,                 \
           long long block_rows, int k, int form, int tile_shift, int chunk, \
           void* stream) {                                                   \
    return launch_band<T, IDX>(data, idx, len, live, bits, x, y, rows,       \
                               count, plane, block_rows, k, form,            \
                               tile_shift, chunk, stream);                   \
  }

TPUFEM_ELL_BAND_ENTRY(tpufem_ell_band_f32_i16, float, int16_t)
TPUFEM_ELL_BAND_ENTRY(tpufem_ell_band_f32_i32, float, int32_t)
TPUFEM_ELL_BAND_ENTRY(tpufem_ell_band_f64_i16, double, int16_t)
TPUFEM_ELL_BAND_ENTRY(tpufem_ell_band_f64_i32, double, int32_t)

#undef TPUFEM_ELL_BAND_ENTRY

// B9g: y = A x on row-major data / int32 cols [rows, k], blocks of
// 2^tile_shift rows, slots in chunks of `chunk`.
int tpufem_ell_gather_f32(const void* data, const void* cols, const void* x,
                          void* y, long long rows, int k, int tile_shift,
                          int chunk, void* stream) {
  return launch_gather<float>(data, cols, x, y, rows, k, tile_shift, chunk,
                              stream);
}

int tpufem_ell_gather_f64(const void* data, const void* cols, const void* x,
                          void* y, long long rows, int k, int tile_shift,
                          int chunk, void* stream) {
  return launch_gather<double>(data, cols, x, y, rows, k, tile_shift, chunk,
                               stream);
}

// B10: Y = A X for X and Y [rows, q] row-major (q >= 2), the same
// layouts, in blocks of `threads` rows staging up to `window` rows of X;
// align: the bytes every row of X and Y starts on.
#define TPUFEM_ELL_MULTI_ENTRY(NAME, T, IDX)                                 \
  int NAME(const void* data, const void* idx, const void* x, void* y,        \
           long long rows, int k, long long row_stride,                      \
           long long slot_stride, long long block_rows, int q, int align,    \
           int threads, int window, void* stream) {                          \
    return launch_multi<T, IDX>(data, idx, x, y, rows, k, row_stride,        \
                                slot_stride, block_rows, q, align, threads,  \
                                window, stream);                             \
  }

TPUFEM_ELL_MULTI_ENTRY(tpufem_ell_spmv_multi_f32_i16, float, int16_t)
TPUFEM_ELL_MULTI_ENTRY(tpufem_ell_spmv_multi_f32_i32, float, int32_t)
TPUFEM_ELL_MULTI_ENTRY(tpufem_ell_spmv_multi_f64_i16, double, int16_t)
TPUFEM_ELL_MULTI_ENTRY(tpufem_ell_spmv_multi_f64_i32, double, int32_t)

#undef TPUFEM_ELL_MULTI_ENTRY

}  // extern "C"
