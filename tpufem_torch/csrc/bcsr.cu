// BCSR (block-ELL) sparse matrix-vector product: kernel B12 on the banded
// plan, and B12g, its absolute-column (gather) form.  Both are templates on
// the value type T (float, double) and the block size B (2 in 2D, 3 in 3D
// elasticity, 3 to 6 on the levels and transfers of the block AMG
// hierarchies: m = 3 rigid modes in 2D, 6 in 3D); B12 also on the window
// index type Idx (int16, int32).
//
// B12 replaces tpufem/sparse/ell_pallas.py::_block_kernel and its
// per-block delta-table twin ::_block_kernel_pb.  The banded plan of
// bcsr_band_plan stores the matrix block-plane major, data_t[K, B, B, NP],
// beside the node pattern's window-relative columns rel[K, NP] (B9's plan):
// block row i of window block j = i / R reads node (j - 1) R + rel[k, i],
// and with x and y component-major [B, n]
//     y[c][i] = sum_k sum_d data_t[k, c, d, i] * x[d][(i / R - 1) R + rel]
// summed k outer, then source component d, each product added to every
// output c as it is formed: the TPU kernel's order.  The TPU kernel builds
// that gather from lane gathers and sublane selects over a VMEM window of
// 3R values, sharing each gather across the B outputs, and its per-block
// twin loops over an SMEM table of window-row deltas; a CUDA thread gathers
// any column directly, so one launch serves both, and the per_block option
// only selects the schedule the TPU needed.
//
// B12 bound on the card: bytes.  Per block row it reads K B^2 values and K
// indices and writes B outputs; x is gathered within the RCM band (x fits
// the 50 MB L2), so it costs about one read.  2D (B = 2) at 491,401 block
// rows, K = 8, fp32 with int16 rel: 78.6 MB, 23.5 us at 3.35 TB/s; 3D (B =
// 3) at 68,921 block rows, K = 16: 43.5 MB, 13.0 us.  What held the first
// design (one thread a row, the slot loop run to a run-time K) at 43% of
// that at the 3D shape was not the bytes but each thread's chain: a
// slot's index load, then its dependent x gathers, one slot after another,
// and a few warps an SM to hide it (scripts/spmv_ablation.py: moving every
// gather onto the diagonal left its time within 2%).  Design: one thread a
// block row, consecutive threads on consecutive rows (each (k, c, d) plane
// of data_t and each rel plane read in coalesced lines), the slots
// unrolled for K = 8 and 16 (a run-time instance for any other K), and
// each slot's index and values loaded kBandAhead slots before they are
// summed, the order held by keep_order(), so that several slots' loads and
// gathers are in flight at once.  Tiles of 384 rows (the chooser,
// sparse/ell_cuda.py's bcsr_band_tiling).  Tried and measured slower
// (PERF.md, Findings): B threads a row, one per output (3x the gathers); x's
// band staged in shared memory per block (the copy before any sum
// serialised each block); tiles balanced over the SMs.  At the 3D shape
// the random gathers still cost about 0.003 ms (0.0188 ms, against 0.0158
// with every gather on the diagonal), and the rest runs at about 80% of
// the bytes bound (PERF.md).  Only the n real
// rows are computed: their columns lie in [0, n), and the padding rows up
// to NP are never read.
//
// The AMG hierarchies' levels and transfers (3 x 3 to 6 x 6 blocks, K
// from 4 to 512 on 264 to 491,401 rows) take the run-time-K instance in
// groups of slots loaded ahead (loop_ahead), or, for B = 2, 3 on fewer
// than 65,536 rows, B threads a row (bcsr_spmv_out below); the wrapper
// picks (sparse/ell_cuda.py's bcsr_band_design).  Staging a chunk of
// slots' values and gathers through shared memory was measured slower
// than a thread a row at every AMG shape (each thread's staging loads
// came one after another).  On the fat-K levels of a few hundred rows the sum
// order (each output's slots in turn) leaves each thread a chain of K / U
// dependent loads, and torch's BSR product, which splits a row's slots,
// is faster there (PERF.md).
//
// B12g replaces the gather form of the reference's BCSRMatrix
// (tpufem/sparse/bcsr.py:152-154, XLA's gather and reduce; the Pallas
// kernel above is its banded counterpart).  It has no plan: row-major
// data[NR, K, B, B], int32 cols[NR, K], node-major x / y [NR * B], the
// columns anywhere.  Bound on the card: bytes, K B^2 values and K columns
// per row, x and y once: 86.4 MB (2D, 491,401 rows, b = 2, K = 8, fp32),
// 25.8 us at 3.35 TB/s; 45.7 MB (3D, 68,921 rows, b = 3, K = 16), 13.7 us.
// A thread that owns a row and reads its K B^2 contiguous values on its
// own (the earlier design) puts a warp's lanes a row apart: each load
// touches 32 lines and uses 4 bytes of each sector, and the lines are
// evicted from L1 before the row's later slots reuse them.  Design: a
// persistent grid (blocks per SM as shared memory allows, at least two)
// walks tiles of tile_rows consecutive rows.  A tile's values and its
// columns are each one contiguous span; the whole block copies both into
// shared memory with 16-byte cp.async (neighbouring threads on neighbouring
// addresses; a span that does not start or end on 16 bytes copies its
// partial first and last chunks element by element: the scalar head and
// tail), in a ring of two buffers, so the next tile's copy is in flight
// while one is reduced.  A tile holds about 24 KB, so four blocks share an
// SM.  In shared memory 16 bytes of padding follow every 128, so rows a
// 128-byte multiple apart do not share a bank.  Each thread then owns one
// output y[row, c] (B threads a row, consecutive threads on consecutive
// outputs, so y is written coalesced), gathers each slot's B source values
// from L2 (one 8- or 16-byte access for B = 2), four slots ahead of their
// use, and sums them in the plain version's order.  With a random
// numbering each slot's gather is a 32-byte L2 sector of its own (3.9M at
// the 2D shape), and those gathers, not the staged stream, take most of
// the time above the bound: see PERF.md.
//
// Rounding: each product and each sum is rounded on its own (no fused
// multiply-add), in the order above, so y equals the plain PyTorch
// versions' bit for bit.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "spmv_probe.cuh"

namespace {

using tpufem::add_rn;
using tpufem::mul_rn;
using tpufem::window_base;

// Element strides of one launch: data (row 1, slot B*B*NP, component NP),
// index (row 1, slot NP), block_rows R, x / y [B, n].
struct BcsrLayout {
  long long rows;                    // block rows computed (n)
  int k;                             // slots per block row
  long long d_row, d_slot, d_comp;   // data: row, slot, component c*B+d
  long long i_row, i_slot;           // index: row, slot
  long long block_rows;              // R of the banded plan
  long long x_comp, x_node;          // x: component, node
  long long y_comp, y_node;          // y: component, node
};

// Slots whose columns and values are loaded ahead of the one being summed:
// 16 bytes of each value plane, 4 slots in fp32 and 2 in fp64 (the fastest
// in scripts/spmv_ablation.py's sweep, which sets TPUFEM_BCSR_AHEAD,
// spmv_probe.cuh).
template <typename T>
constexpr int kBandAhead = TPUFEM_BCSR_AHEAD > 0
                               ? TPUFEM_BCSR_AHEAD
                               : 16 / static_cast<int>(sizeof(T));
constexpr int kBandMaxThreads = 384;

// The run-time-K instance (K = 0): slots loaded a group ahead of their
// sums, as many as about 128 32-bit registers of values and gathered x
// hold (b = 2, 3 fp32: 8; b = 6 fp32: 3, fp64: 1), at most 8.  The AMG
// levels' fat K (up to 512 slots on a few hundred rows) left one slot's
// dependent index and x loads at a time in flight on a thread: at the n
// = 40 box's 6 x 6 level of 4,288 rows and K = 64, 0.1321 ms one slot at a
// time, 0.0878 in groups of 3 (scripts/bcsr_amg_ab.py, PERF.md).
// TPUFEM_BCSR_LOOP_AHEAD (spmv_probe.cuh) sets it in probe builds.
template <typename T, int B>
__host__ __device__ constexpr int loop_ahead() {
  if (TPUFEM_BCSR_LOOP_AHEAD > 0) return TPUFEM_BCSR_LOOP_AHEAD;
  const int u = 128 / ((B * B + B) * static_cast<int>(sizeof(T) / 4));
  return u < 1 ? 1 : (u > 8 ? 8 : u);
}

// Thread r of a block of tile_rows threads computes block row
// i = blockIdx.x * tile_rows + r and all B of its outputs.  It loads its
// first P slots' columns and values, then sums the slots in order, each
// slot's column and values loaded P slots before it is summed, so P
// slots' index loads, x gathers and value loads are in flight at once.
// (The first loads sit in the `live` branch before the early return, each
// slot's behind keep_order(): so placed, ptxas keeps them ahead, 79 and 70
// registers at the 3D shape in fp32 and fp64 with int16 windows; without,
// it sinks them to their uses, 40 to 44, and the time goes back to the
// parent's.)  K slots known at compile time; K = 0: l.k at run time,
// loaded as summed.
template <typename T, typename Idx, int B, int K>
__global__ void __launch_bounds__(kBandMaxThreads)
bcsr_spmv(const T* __restrict__ data, const Idx* __restrict__ idx,
          const T* __restrict__ x, T* __restrict__ y, BcsrLayout l,
          int tile_rows) {
  constexpr int P = K > 0 && (kBandAhead<T>) > K ? K : kBandAhead<T>;
  const long long i =
      static_cast<long long>(blockIdx.x) * tile_rows + threadIdx.x;
  const bool live = i < l.rows;
  const long long base = window_base(live ? i : 0, l.block_rows);
  const Idx* __restrict__ ip = idx + (live ? i : 0) * l.i_row;
  const T* __restrict__ dp = data + (live ? i : 0) * l.d_row;
  const auto column = [&](int s) {
    return static_cast<int>(base + ip[s * l.i_slot]);
  };
  const auto value = [&](int s, int c, int d) {
    return dp[s * l.d_slot + (c * B + d) * l.d_comp];
  };
  const auto gather = [&](int col, int d) {
    return x[d * l.x_comp + static_cast<long long>(col) * l.x_node];
  };

  int col[K > 0 ? K : 1];
  T v[K > 0 ? K : 1][B][B];
  if constexpr (K > 0) {
    if (live) {
#pragma unroll
      for (int s = 0; s < P; ++s) {
        col[s] = column(s);
#pragma unroll
        for (int c = 0; c < B; ++c)
#pragma unroll
          for (int d = 0; d < B; ++d) v[s][c][d] = value(s, c, d);
      }
    }
  }
  keep_order();
  if (!live) return;

  T acc[B];
#pragma unroll
  for (int c = 0; c < B; ++c) acc[c] = T(0);
  if constexpr (K > 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s + P < K) {
        col[s + P] = column(s + P);
#pragma unroll
        for (int c = 0; c < B; ++c)
#pragma unroll
          for (int d = 0; d < B; ++d) v[s + P][c][d] = value(s + P, c, d);
      }
      keep_order();
#pragma unroll
      for (int d = 0; d < B; ++d) {
        const T xv = gather(col[s], d);
#pragma unroll
        for (int c = 0; c < B; ++c)
          acc[c] = add_rn(acc[c], mul_rn(v[s][c][d], xv));
      }
    }
  } else {
    // groups of U slots: their columns, values and gathers loaded first,
    // then summed in slot order; the last k % U slots one at a time.  K <
    // 0: groups of one (k under two groups, where the groups' registers
    // would only cost occupancy; the fence still helps, PERF.md)
    constexpr int U = K < 0 ? 1 : loop_ahead<T, B>();
    int s = 0;
    for (; s + U <= l.k; s += U) {
      int gc[U];
      T gv[U][B][B];
      T gx[U][B];
#pragma unroll
      for (int u = 0; u < U; ++u) gc[u] = column(s + u);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < B; ++c)
#pragma unroll
          for (int d = 0; d < B; ++d) gv[u][c][d] = value(s + u, c, d);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int d = 0; d < B; ++d) gx[u][d] = gather(gc[u], d);
      keep_order();  // the group's loads stay issued before its sums
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int d = 0; d < B; ++d)
#pragma unroll
          for (int c = 0; c < B; ++c)
            acc[c] = add_rn(acc[c], mul_rn(gv[u][c][d], gx[u][d]));
    }
    for (; s < l.k; ++s) {
      const int cs = column(s);
#pragma unroll
      for (int d = 0; d < B; ++d) {
        const T xv = gather(cs, d);
#pragma unroll
        for (int c = 0; c < B; ++c)
          acc[c] = add_rn(acc[c], mul_rn(value(s, c, d), xv));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < B; ++c) y[c * l.y_comp + i * l.y_node] = acc[c];
}

template <typename T, typename Idx, int B, int K>
int launch_band(const void* data, const void* idx, const void* x, void* y,
                const BcsrLayout& l, int tile_rows, cudaStream_t stream) {
  const auto blocks = static_cast<unsigned>((l.rows + tile_rows - 1) /
                                            tile_rows);
  bcsr_spmv<T, Idx, B, K><<<blocks, tile_rows, 0, stream>>>(
      static_cast<const T*>(data), static_cast<const Idx*>(idx),
      static_cast<const T*>(x), static_cast<T*>(y), l, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

// The instance for l.k (8 and 16 unrolled for B = 2 and 3, any other K and
// every K of B = 4 to 6 at run time, in groups of loop_ahead slots: the
// AMG hierarchies' transfers and coarse levels, whose B^2 values a slot
// and run-time K would not fit the registers of the unrolled form), in
// blocks of tile_rows block rows (one thread each, at most 384; the
// wrapper's bcsr_loop_tiling gives the run-time instance fewer rows a
// block where the rows are few).  Columns must fit an int.
template <typename T, typename Idx, int B>
int launch(const void* data, const void* idx, const void* x, void* y,
           const BcsrLayout& l, int tile_rows, void* stream) {
  if (l.rows < 0 || l.rows > INT_MAX || l.k < 1 || l.block_rows < 1 ||
      tile_rows < 1 || tile_rows > kBandMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (l.rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (B <= 3) {
    if (l.k == 8)
      return launch_band<T, Idx, B, 8>(data, idx, x, y, l, tile_rows, s);
    if (l.k == 16)
      return launch_band<T, Idx, B, 16>(data, idx, x, y, l, tile_rows, s);
  }
  if (l.k < 2 * loop_ahead<T, B>())
    return launch_band<T, Idx, B, -1>(data, idx, x, y, l, tile_rows, s);
  return launch_band<T, Idx, B, 0>(data, idx, x, y, l, tile_rows, s);
}

// B threads a row: thread (r, c) of a block of tile_rows * B threads sums
// output c of block row r (consecutive threads on consecutive rows of one
// c: each (slot, c, d) value plane read coalesced), in the plain version's
// order (slot, then d), in groups of out_ahead slots whose column, B
// values and B gathers are loaded before their sums.  A thread holds 2B + 1
// values a slot, not B^2 + B, so more slots fit its registers, and B times
// the threads run: the wrapper's form for B = 2, 3 on fewer than 65,536
// rows (the 982k hierarchy's coarse levels and transfers: its 705-row K =
// 512 level 0.1470 ms a thread a row one slot at a time, 0.0952 in groups,
// 0.0626 so; scripts/bcsr_amg_ab.py).  At B = 6 its B^2 gathers a row made
// it slower than a thread a row in groups.
template <typename T, int B>
__host__ __device__ constexpr int out_ahead() {
  const int u = 128 / (2 * B * static_cast<int>(sizeof(T) / 4) + 1);
  return u < 1 ? 1 : (u > 16 ? 16 : u);
}

template <typename T, typename Idx, int B>
__global__ void __launch_bounds__(kBandMaxThreads)
bcsr_spmv_out(const T* __restrict__ data, const Idx* __restrict__ idx,
              const T* __restrict__ x, T* __restrict__ y, BcsrLayout l,
              int tile_rows) {
  constexpr int U = out_ahead<T, B>();
  const int r = threadIdx.x % tile_rows;
  const int c = threadIdx.x / tile_rows;
  const long long i = static_cast<long long>(blockIdx.x) * tile_rows + r;
  if (i >= l.rows) return;
  const long long base = window_base(i, l.block_rows);
  const Idx* __restrict__ ip = idx + i * l.i_row;
  const T* __restrict__ dp = data + i * l.d_row + c * B * l.d_comp;
  T acc = T(0);
  int s = 0;
  for (; s + U <= l.k; s += U) {
    int gc[U];
    T gv[U][B];
    T gx[U][B];
#pragma unroll
    for (int u = 0; u < U; ++u)
      gc[u] = static_cast<int>(base + ip[(s + u) * l.i_slot]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int d = 0; d < B; ++d)
        gv[u][d] = dp[(s + u) * l.d_slot + d * l.d_comp];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int d = 0; d < B; ++d)
        gx[u][d] = x[d * l.x_comp + static_cast<long long>(gc[u]) * l.x_node];
    keep_order();  // the group's loads stay issued before its sums
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int d = 0; d < B; ++d) acc = add_rn(acc, mul_rn(gv[u][d], gx[u][d]));
  }
  for (; s < l.k; ++s) {
    const long long col = base + ip[s * l.i_slot];
#pragma unroll
    for (int d = 0; d < B; ++d)
      acc = add_rn(acc, mul_rn(dp[s * l.d_slot + d * l.d_comp],
                               x[d * l.x_comp + col * l.x_node]));
  }
  y[c * l.y_comp + i * l.y_node] = acc;
}

template <typename T, typename Idx, int B>
int launch_out(const void* data, const void* idx, const void* x, void* y,
               const BcsrLayout& l, int tile_rows, void* stream) {
  if (l.rows < 0 || l.rows > INT_MAX || l.k < 1 || l.block_rows < 1 ||
      tile_rows < 1 || tile_rows * B > kBandMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (l.rows == 0) return static_cast<int>(cudaSuccess);
  const auto blocks =
      static_cast<unsigned>((l.rows + tile_rows - 1) / tile_rows);
  bcsr_spmv_out<T, Idx, B><<<blocks, tile_rows * B, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const Idx*>(idx),
      static_cast<const T*>(x), static_cast<T*>(y), l, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

// -- B12g: the gather form -------------------------------------------------

constexpr int kGatherMaxThreads = 384;  // tile_rows * B
constexpr int kGatherAhead = 4;         // slots gathered ahead of their use
constexpr int kSmemPerBlock = 232448;   // 227 KB of dynamic shared memory
constexpr int kSmemPerSM = 233472;      // 228 KB, 1 KB of it kept per block
constexpr int kMaxDevices = 64;

// Streaming multiprocessors of the current device, queried once per
// device; 0 if the query fails.
int multiprocessors() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    count[dev] = 0;
  return count[dev];
}

// Where byte o of a staged span's 16-byte window lies in shared memory: 16
// bytes of padding after every 128.
__host__ __device__ __forceinline__ int padded(int o) {
  return o + ((o >> 7) << 4);
}

// Shared memory of a staged span of `bytes` bytes that may start anywhere
// in a 16-byte chunk: its window of whole chunks, padded.  The wrapper's
// bcsr_gather_tiling computes the same.
__host__ __device__ __forceinline__ long long span_region(long long bytes) {
  const long long window = (bytes + 30) / 16 * 16;
  return window + (((window - 16) >> 7) << 4);
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, L2 asked to fetch the whole 128-byte line (the span streams on)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(
                   smem_address(dst)),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The whole block copies `bytes` bytes at src (E-byte elements) to dst in
// the padded layout: byte o of src's 16-byte window to dst + padded(o).
// Neighbouring threads take neighbouring chunks; a whole chunk is one
// 16-byte copy, the partial first and last ones (a span off a 16-byte
// boundary) go element by element: the scalar head and tail.
template <int E>
__device__ __forceinline__ void stage_span(char* dst, const char* src,
                                           int bytes) {
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const char* window = src - head;
  const int end = head + bytes;
  for (int q = threadIdx.x; q < (end + 15) >> 4; q += blockDim.x) {
    const int lo = q == 0 ? head : 0;
    const int hi = min(16, end - (q << 4));
    char* d = dst + padded(q << 4);
    const char* s = window + (q << 4);
    if (lo == 0 && hi == 16) {
      cp_async_16(d, s);
    } else {
      for (int o = lo; o < hi; o += E) cp_async_small<E>(d + o, s + o);
    }
  }
}

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// x[col * B + d] for d < B: one 8- or 16-byte access for B = 2 when x is
// aligned to a pair.
template <typename T, int B>
__device__ __forceinline__ void gather_x(const T* __restrict__ x, int col,
                                         bool pairs, T (&xv)[B]) {
  if constexpr (B == 2) {
    if (pairs) {
      const auto v =
          __ldg(reinterpret_cast<const typename Pair<T>::type*>(x) + col);
      xv[0] = v.x;
      xv[1] = v.y;
      return;
    }
  }
#pragma unroll
  for (int d = 0; d < B; ++d)
    xv[d] = __ldg(x + static_cast<long long>(col) * B + d);
}

// One staged slot j of this thread's output: acc += v[j, c, d] x[col_j, d]
// for d in order.  v0: the byte of v[row, 0, c, 0] in the value window.
template <typename T, int B>
__device__ __forceinline__ T add_slot(T acc, const char* vals, int v0, int j,
                                      const T (&xv)[B]) {
#pragma unroll
  for (int d = 0; d < B; ++d) {
    const T v = *reinterpret_cast<const T*>(
        vals + padded(v0 + (j * B * B + d) * static_cast<int>(sizeof(T))));
    acc = add_rn(acc, mul_rn(v, xv[d]));
  }
  return acc;
}

// A persistent block walks the tiles blockIdx.x, + gridDim.x, ... over a
// ring of two buffers: each turn starts the copy of the next tile into the
// buffer the last turn freed, waits for its own tile's copy, and reduces
// it: thread (r, c) sums y[row r, c] over the slots, kGatherAhead slots'
// x values gathered before they are used.
template <typename T, int B>
__global__ void __launch_bounds__(kGatherMaxThreads)
bcsr_gather_spmv(const T* __restrict__ data, const int* __restrict__ cols,
                 const T* __restrict__ x, T* __restrict__ y, long long nr,
                 int k, int tile_rows, int vals_region, int stage_bytes) {
  extern __shared__ __align__(16) char smem[];
  constexpr int E = static_cast<int>(sizeof(T));
  const long long tiles = (nr + tile_rows - 1) / tile_rows;
  const int row_vals = k * B * B;
  const bool pairs =
      B == 2 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  const auto head = [](const void* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  };
  const auto stage = [&](long long t, int buf) {
    if (t < tiles) {
      const long long r0 = t * tile_rows;
      const int rows =
          static_cast<int>(min(static_cast<long long>(tile_rows), nr - r0));
      char* dst = smem + buf * stage_bytes;
      stage_span<E>(dst, reinterpret_cast<const char*>(data + r0 * row_vals),
                    rows * row_vals * E);
      stage_span<4>(dst + vals_region,
                    reinterpret_cast<const char*>(cols + r0 * k),
                    rows * k * 4);
    }
    cp_async_commit();  // empty past the last tile: the count stays fixed
  };

  stage(blockIdx.x, 0);
  const int r = threadIdx.x / B;
  const int c = threadIdx.x - r * B;
  int buf = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    stage(t + gridDim.x, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    const long long r0 = t * tile_rows;
    if (r0 + r < nr) {
      const char* vals = smem + buf * stage_bytes;
      const char* idx = vals + vals_region;
      const int v0 = head(data + r0 * row_vals) + (r * row_vals + c * B) * E;
      const int c0 = head(cols + r0 * k) + r * k * 4;
      T acc = T(0);
      int j = 0;
      for (; j + kGatherAhead <= k; j += kGatherAhead) {
        int col[kGatherAhead];
        T xv[kGatherAhead][B];
#pragma unroll
        for (int u = 0; u < kGatherAhead; ++u)
          col[u] = *reinterpret_cast<const int*>(idx +
                                                 padded(c0 + 4 * (j + u)));
#pragma unroll
        for (int u = 0; u < kGatherAhead; ++u)
          gather_x<T, B>(x, col[u], pairs, xv[u]);
#pragma unroll
        for (int u = 0; u < kGatherAhead; ++u)
          acc = add_slot<T, B>(acc, vals, v0, j + u, xv[u]);
      }
      for (; j < k; ++j) {
        T xv[B];
        const int col =
            *reinterpret_cast<const int*>(idx + padded(c0 + 4 * j));
        gather_x<T, B>(x, col, pairs, xv);
        acc = add_slot<T, B>(acc, vals, v0, j, xv);
      }
      y[(r0 + r) * B + c] = acc;
    }
    __syncthreads();  // the buffer is refilled next turn
    buf ^= 1;
  }
  cp_async_wait<0>();
}

template <typename T, int B>
int launch_gather(const void* data, const void* cols, const void* x, void* y,
                  long long nr, int k, int tile_rows, void* stream) {
  if (nr < 0 || k < 1 || tile_rows < 1 || tile_rows * B > kGatherMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nr == 0) return static_cast<int>(cudaSuccess);
  const long long slots = static_cast<long long>(tile_rows) * k;
  const long long vals_region = span_region(slots * B * B * sizeof(T));
  const long long stage_bytes = vals_region + span_region(slots * 4);
  if (2 * stage_bytes > kSmemPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = bcsr_gather_spmv<T, B>;
  const int smem = static_cast<int>(2 * stage_bytes);
  const int threads = tile_rows * B;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  // dynamic shared memory above 48 KB needs the opt-in, once per device
  static bool opted[kMaxDevices] = {};
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  const int sms = multiprocessors();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int per_sm =
      std::max(1, std::min(kSmemPerSM / (smem + 1024), 2048 / threads));
  const long long tiles = (nr + tile_rows - 1) / tile_rows;
  const unsigned grid = static_cast<unsigned>(
      std::min(tiles, static_cast<long long>(per_sm) * sms));
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(cols),
      static_cast<const T*>(x), static_cast<T*>(y), nr, k, tile_rows,
      static_cast<int>(vals_region), static_cast<int>(stage_bytes));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B12: y = A x for a BCSR matrix of B x B blocks on the banded plan
// (block_rows > 0: data_t [K, B, B, NP], rel [K, NP]).  Strides in
// elements; blocks of tile_rows block rows (one thread each);
// cudaErrorInvalidValue past 384.
#define TPUFEM_BCSR_ENTRY(NAME, T, IDX, B)                                   \
  int NAME(const void* data, const void* idx, const void* x, void* y,        \
           long long rows, int k, long long d_row, long long d_slot,         \
           long long d_comp, long long i_row, long long i_slot,              \
           long long block_rows, long long x_comp, long long x_node,         \
           long long y_comp, long long y_node, int tile_rows,                \
           void* stream) {                                                   \
    const BcsrLayout l{rows,       k,      d_row,  d_slot, d_comp, i_row,    \
                       i_slot,     block_rows, x_comp, x_node, y_comp,       \
                       y_node};                                              \
    return launch<T, IDX, B>(data, idx, x, y, l, tile_rows, stream);         \
  }

TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i16_b2, float, int16_t, 2)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i32_b2, float, int32_t, 2)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i16_b2, double, int16_t, 2)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i32_b2, double, int32_t, 2)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i16_b3, float, int16_t, 3)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i32_b3, float, int32_t, 3)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i16_b3, double, int16_t, 3)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i32_b3, double, int32_t, 3)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i16_b4, float, int16_t, 4)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i32_b4, float, int32_t, 4)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i16_b4, double, int16_t, 4)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i32_b4, double, int32_t, 4)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i16_b5, float, int16_t, 5)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i32_b5, float, int32_t, 5)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i16_b5, double, int16_t, 5)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i32_b5, double, int32_t, 5)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i16_b6, float, int16_t, 6)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i32_b6, float, int32_t, 6)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i16_b6, double, int16_t, 6)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i32_b6, double, int32_t, 6)

#undef TPUFEM_BCSR_ENTRY

// B12, B threads a row (bcsr_spmv_out): the B12 arguments; blocks of
// tile_rows block rows, tile_rows * B threads.
#define TPUFEM_BCSR_OUT_ENTRY(NAME, T, IDX, B)                               \
  int NAME(const void* data, const void* idx, const void* x, void* y,        \
           long long rows, int k, long long d_row, long long d_slot,         \
           long long d_comp, long long i_row, long long i_slot,              \
           long long block_rows, long long x_comp, long long x_node,         \
           long long y_comp, long long y_node, int tile_rows,                \
           void* stream) {                                                   \
    const BcsrLayout l{rows,       k,      d_row,  d_slot, d_comp, i_row,    \
                       i_slot,     block_rows, x_comp, x_node, y_comp,       \
                       y_node};                                              \
    return launch_out<T, IDX, B>(data, idx, x, y, l, tile_rows, stream);     \
  }

TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f32_i16_b2, float, int16_t, 2)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f32_i32_b2, float, int32_t, 2)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f64_i16_b2, double, int16_t, 2)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f64_i32_b2, double, int32_t, 2)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f32_i16_b3, float, int16_t, 3)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f32_i32_b3, float, int32_t, 3)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f64_i16_b3, double, int16_t, 3)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f64_i32_b3, double, int32_t, 3)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f32_i16_b4, float, int16_t, 4)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f32_i32_b4, float, int32_t, 4)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f64_i16_b4, double, int16_t, 4)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f64_i32_b4, double, int32_t, 4)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f32_i16_b5, float, int16_t, 5)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f32_i32_b5, float, int32_t, 5)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f64_i16_b5, double, int16_t, 5)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f64_i32_b5, double, int32_t, 5)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f32_i16_b6, float, int16_t, 6)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f32_i32_b6, float, int32_t, 6)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f64_i16_b6, double, int16_t, 6)
TPUFEM_BCSR_OUT_ENTRY(tpufem_bcsr_out_f64_i32_b6, double, int32_t, 6)

#undef TPUFEM_BCSR_OUT_ENTRY

// B12g: y = A x on row-major data [nr, k, B, B], int32 cols [nr, k] and
// node-major x, y [nr * B] (contiguous), in tiles of tile_rows rows over a
// ring of two buffers; returns cudaErrorInvalidValue where the ring would
// not fit 227 KB.
#define TPUFEM_BCSR_GATHER_ENTRY(NAME, T, B)                                 \
  int NAME(const void* data, const void* cols, const void* x, void* y,       \
           long long nr, int k, int tile_rows, void* stream) {               \
    return launch_gather<T, B>(data, cols, x, y, nr, k, tile_rows, stream);  \
  }

TPUFEM_BCSR_GATHER_ENTRY(tpufem_bcsr_gather_f32_b2, float, 2)
TPUFEM_BCSR_GATHER_ENTRY(tpufem_bcsr_gather_f64_b2, double, 2)
TPUFEM_BCSR_GATHER_ENTRY(tpufem_bcsr_gather_f32_b3, float, 3)
TPUFEM_BCSR_GATHER_ENTRY(tpufem_bcsr_gather_f64_b3, double, 3)
TPUFEM_BCSR_GATHER_ENTRY(tpufem_bcsr_gather_f32_b4, float, 4)
TPUFEM_BCSR_GATHER_ENTRY(tpufem_bcsr_gather_f64_b4, double, 4)
TPUFEM_BCSR_GATHER_ENTRY(tpufem_bcsr_gather_f32_b5, float, 5)
TPUFEM_BCSR_GATHER_ENTRY(tpufem_bcsr_gather_f64_b5, double, 5)
TPUFEM_BCSR_GATHER_ENTRY(tpufem_bcsr_gather_f32_b6, float, 6)
TPUFEM_BCSR_GATHER_ENTRY(tpufem_bcsr_gather_f64_b6, double, 6)

#undef TPUFEM_BCSR_GATHER_ENTRY

}  // extern "C"
