// ELL sparse matrix-vector products: kernel B9 (its per-block route B11)
// and kernel B10 (many right-hand sides), templates on the value type T
// (float, double) and the index type Idx (int16, int32); B10 also on q and
// on the form (banded or absolute columns).
//
// Replaces tpufem/sparse/ell_pallas.py::_kernel (B9; its segmented and
// global calls), ::_kernel_pb (B11, the per-block delta-table variant) and
// ::_kernel_multi (B10).  The banded plan stores the matrix transposed,
// data_t[K, NP] and rel[K, NP], with each column as a window-relative
// position: row i of block j = i / R reads x at (j - 1) R + rel[k, i]
//     y[i] = sum_k data_t[k, i] * x[(i / R - 1) R + rel[k, i]]
// summed in slot order.  The TPU kernel builds that gather out of lane
// gathers and sublane selects over a VMEM window of 3R values, looping over
// the window-row deltas each slot uses (statically, per segment of blocks,
// or per block from an SMEM table: that is all the segmentation and the
// B11 table are for).  A CUDA thread gathers any column directly, so one
// kernel serves the three TPU variants and each call is one launch.
//
// The same template, with the window base 0 and a row stride of K,
// serves the gather form (absolute columns, row-major data/cols [N, K]):
// ELLMatrix.matvec on a matrix without a banded plan, and the Dirichlet
// right-hand-side correction.
//
// Bound on the card: bytes.  Per row it reads K values and K indices and
// writes one y; x is gathered.  At 1,002,001 rows, K = 8, fp32 with int16
// rel: data 32.2 MB, rel 16.1 MB, x 4.0 MB, y 4.0 MB, about 56 MB, so about
// 16.8 us at 3.35 TB/s; in fp64 about 97 MB, 28.9 us.  The x gather has
// the RCM band's locality (each block reads a window of 3R values, and x
// fits the 50 MB L2), so x costs about one read.  Design: one thread per
// row, consecutive threads on consecutive rows, so each slot's data and
// rel plane is read in fully coalesced lines (the plan is transposed for
// exactly that); no shared memory.  Only the n real rows are computed:
// their columns lie in [0, n), and the padding rows up to NP, which point
// at themselves with value 0, are never read.
//
// Rounding: each product and each sum is rounded separately
// (__fmul_rn / __fadd_rn, no fused multiply-add), in slot order, which is
// the reference's arithmetic and the plain PyTorch version's, so the
// banded kernel's y equals its plain version's bit for bit.
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

// Layout of one launch.  Banded: row_stride 1, slot_stride NP,
// block_rows R.  Absolute: row_stride K, slot_stride 1, block_rows 0.
struct EllLayout {
  long long rows;         // rows computed (the matrix's n)
  int k;                  // slots per row
  long long row_stride;   // elements between rows of data / idx
  long long slot_stride;  // elements between slots of one row
  long long block_rows;   // R of the banded plan; 0 for absolute columns
};

template <typename T, typename Idx>
__global__ void __launch_bounds__(tpufem::kBlock)
ell_spmv(const T* __restrict__ data, const Idx* __restrict__ idx,
         const T* __restrict__ x, T* __restrict__ y, EllLayout l) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= l.rows) return;
  const long long base = window_base(i, l.block_rows);
  const T* __restrict__ d = data + i * l.row_stride;
  const Idx* __restrict__ c = idx + i * l.row_stride;
  T acc = T(0);
  for (int s = 0; s < l.k; ++s) {
    const long long o = s * l.slot_stride;
    acc = add_rn(acc, mul_rn(d[o], x[base + static_cast<long long>(c[o])]));
  }
  y[i] = acc;
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

template <typename T, typename Idx>
int launch(const void* data, const void* idx, const void* x, void* y,
           long long rows, int k, long long row_stride, long long slot_stride,
           long long block_rows, int q, void* stream) {
  if (rows < 0 || k < 1 || q != 1 || block_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const EllLayout l{rows, k, row_stride, slot_stride, block_rows};
  ell_spmv<T, Idx><<<tpufem::num_blocks(rows), tpufem::kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const Idx*>(idx),
      static_cast<const T*>(x), static_cast<T*>(y), l);
  return static_cast<int>(cudaGetLastError());
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

// B9: y = A x (kernel ell_spmv; q must be 1).  block_rows > 0: the banded
// plan (data_t / rel [K, NP]: row_stride 1, slot_stride NP); block_rows
// == 0: absolute columns (data / cols [N, K]: row_stride K, slot_stride 1).
#define TPUFEM_ELL_ENTRY(NAME, T, IDX)                                       \
  int NAME(const void* data, const void* idx, const void* x, void* y,        \
           long long rows, int k, long long row_stride,                      \
           long long slot_stride, long long block_rows, int q,               \
           void* stream) {                                                   \
    return launch<T, IDX>(data, idx, x, y, rows, k, row_stride, slot_stride, \
                          block_rows, q, stream);                           \
  }

TPUFEM_ELL_ENTRY(tpufem_ell_spmv_f32_i16, float, int16_t)
TPUFEM_ELL_ENTRY(tpufem_ell_spmv_f32_i32, float, int32_t)
TPUFEM_ELL_ENTRY(tpufem_ell_spmv_f64_i16, double, int16_t)
TPUFEM_ELL_ENTRY(tpufem_ell_spmv_f64_i32, double, int32_t)

#undef TPUFEM_ELL_ENTRY

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
