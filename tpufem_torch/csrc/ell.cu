// ELL sparse matrix-vector products: kernel B9 (its per-block route B11)
// and kernel B10 (many right-hand sides), one template each on the value
// type T (float, double) and the index type Idx (int16, int32).
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
// B10: X [rows, q] and Y row-major, as the reference's [N, q].  One thread
// per (row, column), the q threads of a row adjacent: a row's K (value,
// index) pairs are read by one warp instruction for all its columns (one
// DRAM read of the matrix per call, as the TPU kernel's constant index
// maps achieve), and X and Y move in contiguous runs of q.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

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

template <typename T, typename Idx>
__global__ void __launch_bounds__(tpufem::kBlock)
ell_spmv_multi(const T* __restrict__ data, const Idx* __restrict__ idx,
               const T* __restrict__ X, T* __restrict__ Y, EllLayout l,
               int q) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= l.rows * q) return;
  const long long i = t / q;
  const long long j = t - i * q;
  const long long base = window_base(i, l.block_rows);
  const T* __restrict__ d = data + i * l.row_stride;
  const Idx* __restrict__ c = idx + i * l.row_stride;
  T acc = T(0);
  for (int s = 0; s < l.k; ++s) {
    const long long o = s * l.slot_stride;
    const long long col = base + static_cast<long long>(c[o]);
    acc = add_rn(acc, mul_rn(d[o], X[col * q + j]));
  }
  Y[t] = acc;
}

template <typename T, typename Idx>
int launch(const void* data, const void* idx, const void* x, void* y,
           long long rows, int k, long long row_stride, long long slot_stride,
           long long block_rows, int q, void* stream) {
  if (rows < 0 || k < 1 || q < 1 || block_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const EllLayout l{rows, k, row_stride, slot_stride, block_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* dv = static_cast<const T*>(data);
  const Idx* iv = static_cast<const Idx*>(idx);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  if (q == 1) {
    ell_spmv<T, Idx><<<tpufem::num_blocks(rows), tpufem::kBlock, 0, s>>>(
        dv, iv, xv, yv, l);
  } else {
    ell_spmv_multi<T, Idx>
        <<<tpufem::num_blocks(rows * q), tpufem::kBlock, 0, s>>>(dv, iv, xv,
                                                                 yv, l, q);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = A x (q == 1, kernel ell_spmv) or Y = A X (q > 1, X and Y [rows, q]
// row-major, kernel ell_spmv_multi).  block_rows > 0: the banded plan
// (data_t / rel [K, NP]: row_stride 1, slot_stride NP); block_rows == 0:
// absolute columns (data / cols [N, K]: row_stride K, slot_stride 1).
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

}  // extern "C"
