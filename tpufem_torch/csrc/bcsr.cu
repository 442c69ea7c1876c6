// BCSR (block-ELL) sparse matrix-vector product: kernel B12, one template
// on the value type T (float, double), the index type Idx (int16, int32)
// and the block size B (2 in 2D, 3 in 3D elasticity).
//
// Replaces tpufem/sparse/ell_pallas.py::_block_kernel (B12) and its
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
// The same template with absolute columns (block_rows 0) serves the gather
// form of BCSRMatrix: row-major data[NR, K, B, B], int32 cols[NR, K] and
// node-major x / y [NR * B], summed in the same order.
//
// Bound on the card: bytes.  Per block row it reads K B^2 values and K
// indices and writes B outputs; x is gathered within the RCM band (a window
// of 3R nodes per block, and x fits the 50 MB L2), so it costs about one
// read.  2D (B = 2) at 491,401 block rows, K = 8, R = 1024, fp32 with int16
// rel: data 62.9 MB, rel 7.9 MB, x and y 3.9 MB each, about 78.6 MB, so
// about 23.5 us at 3.35 TB/s.  Design: one thread per block row,
// consecutive threads on consecutive rows, so each (k, c, d) plane of
// data_t and each rel plane is read in fully coalesced lines (the plan is
// transposed for exactly that); each thread gathers x_d[col] once per
// (k, d) and feeds all B accumulators, as the TPU kernel shares its
// gathers; no shared memory.  Only the n real rows are computed: their
// columns lie in [0, n), and the padding rows up to NP are never read.
//
// Rounding: each product and each sum is rounded on its own (no fused
// multiply-add), in the order above, so y equals the plain PyTorch
// versions' bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using tpufem::add_rn;
using tpufem::mul_rn;
using tpufem::window_base;

// Element strides of one launch.  Banded: data (row 1, slot B*B*NP,
// component NP), index (row 1, slot NP), block_rows R, x / y [B, n].
// Absolute: data (row K*B*B, slot B*B, component 1), index (row K, slot 1),
// block_rows 0, x / y node-major (component 1, node B).
struct BcsrLayout {
  long long rows;                    // block rows computed (n)
  int k;                             // slots per block row
  long long d_row, d_slot, d_comp;   // data: row, slot, component c*B+d
  long long i_row, i_slot;           // index: row, slot
  long long block_rows;              // R of the banded plan; 0: absolute
  long long x_comp, x_node;          // x: component, node
  long long y_comp, y_node;          // y: component, node
};

template <typename T, typename Idx, int B>
__global__ void __launch_bounds__(tpufem::kBlock)
bcsr_spmv(const T* __restrict__ data, const Idx* __restrict__ idx,
          const T* __restrict__ x, T* __restrict__ y, BcsrLayout l) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= l.rows) return;
  const long long base = window_base(i, l.block_rows);
  T acc[B];
#pragma unroll
  for (int c = 0; c < B; ++c) acc[c] = T(0);
  for (int s = 0; s < l.k; ++s) {
    const long long col =
        base + static_cast<long long>(idx[i * l.i_row + s * l.i_slot]);
    const T* __restrict__ d = data + i * l.d_row + s * l.d_slot;
#pragma unroll
    for (int dd = 0; dd < B; ++dd) {
      const T xv = x[dd * l.x_comp + col * l.x_node];
#pragma unroll
      for (int c = 0; c < B; ++c)
        acc[c] = add_rn(acc[c], mul_rn(d[(c * B + dd) * l.d_comp], xv));
    }
  }
#pragma unroll
  for (int c = 0; c < B; ++c) y[c * l.y_comp + i * l.y_node] = acc[c];
}

template <typename T, typename Idx, int B>
int launch(const void* data, const void* idx, const void* x, void* y,
           const BcsrLayout& l, void* stream) {
  if (l.rows < 0 || l.k < 1 || l.block_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (l.rows == 0) return static_cast<int>(cudaSuccess);
  bcsr_spmv<T, Idx, B>
      <<<tpufem::num_blocks(l.rows), tpufem::kBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(data), static_cast<const Idx*>(idx),
          static_cast<const T*>(x), static_cast<T*>(y), l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = A x for a BCSR matrix of B x B blocks: block_rows > 0, the banded
// plan (data_t [K, B, B, NP], rel [K, NP]); block_rows == 0, absolute
// columns (data [NR, K, B, B], cols [NR, K]).  Strides in elements.
#define TPUFEM_BCSR_ENTRY(NAME, T, IDX, B)                                   \
  int NAME(const void* data, const void* idx, const void* x, void* y,        \
           long long rows, int k, long long d_row, long long d_slot,         \
           long long d_comp, long long i_row, long long i_slot,              \
           long long block_rows, long long x_comp, long long x_node,         \
           long long y_comp, long long y_node, void* stream) {               \
    const BcsrLayout l{rows,       k,      d_row,  d_slot, d_comp, i_row,    \
                       i_slot,     block_rows, x_comp, x_node, y_comp,       \
                       y_node};                                              \
    return launch<T, IDX, B>(data, idx, x, y, l, stream);                    \
  }

TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i16_b2, float, int16_t, 2)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i32_b2, float, int32_t, 2)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i16_b2, double, int16_t, 2)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i32_b2, double, int32_t, 2)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i16_b3, float, int16_t, 3)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f32_i32_b3, float, int32_t, 3)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i16_b3, double, int16_t, 3)
TPUFEM_BCSR_ENTRY(tpufem_bcsr_spmv_f64_i32_b3, double, int32_t, 3)

#undef TPUFEM_BCSR_ENTRY

}  // extern "C"
