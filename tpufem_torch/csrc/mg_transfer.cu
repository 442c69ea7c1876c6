// Fused V-cycle transfers of the constant-coefficient 3D multigrid, on the
// embedded layout (node (z, y, x) at store (z+1, y+1, x+1)).
//
// K3 replaces tpufem/ops/mg_transfer_pallas.py::_kern_rr:
//     rc = mask_c(sample2(W (r - A e)))
// K4 replaces tpufem/ops/mg_transfer_pallas.py::_kern_pas:
//     e' = e + mask(W inject2(ec));  y = e' + omega D^-1 (r - A e')
//     (optionally <r, y>)
// A is the constant-weight stencil gated by the row-type code plane
// (0 padding, 1 interior, 2 Dirichlet identity); W = I + 1/2 adjacency of
// the Kuhn split; coarse node i sits on fine node 2i, i.e. coarse store
// index s <-> fine store index 2s - 1 on every axis.
//
// Bound on the card: bytes.  K3 reads code, r, e on the fine level and
// writes the 1/8-size coarse vector; K4 reads ec (1/8), code, r, e and
// writes y.  Design: one thread per output node, neighbours read straight
// from device memory (consecutive threads on consecutive x, so every plane
// streams in coalesced lines; the 15-fold neighbour reuse is served by
// L1/L2).  The row of A_const is tpufem::const_apply (common.cuh), shared
// with the const stencil kernel B5 (csrc/const_stencil.cu).  The TPU's 0/1
// selection matmuls for stride-2 sampling become direct 2i+1 indexing; its
// halo-row streams and roll wrap-around are gone:
// K3 only evaluates interior coarse rows, whose fine stencil never leaves
// the node grid, and K4 injects only from coarse node positions.  The 15
// weights, 1/w0 and omega arrive by value.  K4's dot is per-block fp64
// partials plus a fixed-order second pass (common.cuh).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// The 3D Kuhn stencil has 15 offsets; a fixed count lets every offset
// loop unroll so that its loads issue together.
constexpr int kOffsets = 15;

struct ConstOp {
  tpufem::ConstStencil<kOffsets> st;  // fine-level flat offsets + weights
  int dz[kOffsets];                   // the same offsets as grid steps
  int dy[kOffsets];
  int dx[kOffsets];
  double inv_w0;                      // 1 / w[offset 0]
  double omega;                       // Jacobi damping
};

struct Dims {
  int f0, f1, f2;  // fine store grid
  int c0, c1, c2;  // coarse store grid
  int n0, n1, n2;  // coarse node grid
};

// Kuhn-split adjacency (tpufem/ops/mg_transfer_pallas.py
// _adjacency_offsets_3d), in the order the reference sums it.
__constant__ int kAdj[14][3] = {
    {-1, 0, 0}, {1, 0, 0},   {0, -1, 0},  {0, 1, 0},  {0, 0, -1},
    {0, 0, 1},  {-1, -1, 0}, {1, 1, 0},   {-1, 0, -1}, {1, 0, 1},
    {0, -1, -1}, {0, 1, 1},  {-1, -1, -1}, {1, 1, 1}};

template <typename T>
__global__ void __launch_bounds__(tpufem::kBlock)
residual_restrict_kernel(const T* __restrict__ code_f,
                         const T* __restrict__ code_c,
                         const T* __restrict__ r, const T* __restrict__ e,
                         T* __restrict__ rc, Dims g, ConstOp op) {
  const long long nsc = static_cast<long long>(g.c0) * g.c1 * g.c2;
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= nsc) return;
  const int X = static_cast<int>(idx % g.c2);
  const int Y = static_cast<int>((idx / g.c2) % g.c1);
  const int Z = static_cast<int>(idx / (static_cast<long long>(g.c1) * g.c2));
  // coarse Dirichlet / padding rows stay zero; an interior row lies on a
  // coarse node, so its fine centre and that centre's neighbours are in
  // the fine store grid
  if (code_c[idx] != T(1) || Z < 1 || Z > g.n0 || Y < 1 || Y > g.n1 ||
      X < 1 || X > g.n2) {
    rc[idx] = T(0);
    return;
  }
  const long long nsf = static_cast<long long>(g.f0) * g.f1 * g.f2;
  const long long sy = g.f2, sz = static_cast<long long>(g.f1) * g.f2;
  const long long p = (2 * Z - 1) * sz + (2 * Y - 1) * sy + (2 * X - 1);
  T acc = r[p] - tpufem::const_apply(code_f, e, p, nsf, op.st);
#pragma unroll
  for (int j = 0; j < 14; ++j) {
    const long long q = p + kAdj[j][0] * sz + kAdj[j][1] * sy + kAdj[j][2];
    acc += T(0.5) * (r[q] - tpufem::const_apply(code_f, e, q, nsf, op.st));
  }
  rc[idx] = acc;
}

// Injected coarse value at fine store position (a, b, c): ec at a coarse
// node when all three coordinates are odd, else zero.  The load is issued
// unconditionally (from a clamped index) so that neighbouring lookups
// overlap.
template <typename T>
__device__ __forceinline__ T injected(const T* __restrict__ ec, int a, int b,
                                      int c, const Dims& g) {
  const int Z = (a + 1) >> 1, Y = (b + 1) >> 1, X = (c + 1) >> 1;
  const bool ok = a >= 0 && b >= 0 && c >= 0 && (a & b & c & 1) &&
                  Z <= g.n0 && Y <= g.n1 && X <= g.n2;
  const T v = ec[ok ? (static_cast<long long>(Z) * g.c1 + Y) * g.c2 + X : 0];
  return ok ? v : T(0);
}

// (W inject2(ec)) at fine store position (a, b, c).  A fine node whose
// coordinates are all odd (a coarse node) takes ec there; otherwise the set
// of even axes is one of the 7 Kuhn adjacency directions, and the node is
// the midpoint of the two coarse nodes one step either way along it.
template <typename T>
__device__ __forceinline__ T prolonged(const T* __restrict__ ec, int a, int b,
                                       int c, const Dims& g) {
  const int dz = (a & 1) ? 0 : 1, dy = (b & 1) ? 0 : 1, dx = (c & 1) ? 0 : 1;
  if (!(dz | dy | dx)) return injected(ec, a, b, c, g);
  return T(0.5) * injected(ec, a - dz, b - dy, c - dx, g) +
         T(0.5) * injected(ec, a + dz, b + dy, c + dx, g);
}

template <typename T>
__global__ void __launch_bounds__(tpufem::kBlock)
prolong_add_smooth_kernel(const T* __restrict__ code_f,
                          const T* __restrict__ ec, const T* __restrict__ r,
                          const T* __restrict__ e, T* __restrict__ y,
                          double* __restrict__ partials, Dims g, ConstOp op) {
  const long long nsf = static_cast<long long>(g.f0) * g.f1 * g.f2;
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  double part = 0.0;
  if (idx < nsf) {
    const int sx = static_cast<int>(idx % g.f2);
    const int sy = static_cast<int>((idx / g.f2) % g.f1);
    const int sz = static_cast<int>(idx / (static_cast<long long>(g.f1) * g.f2));
    const T c = code_f[idx];
    // e' = e + P ec, with P ec existing only on node rows
    const T ep = e[idx] + (c != T(0) ? prolonged(ec, sz, sy, sx, g) : T(0));
    T ax = c == T(2) ? ep : T(0);
    if (c == T(1)) {
      // interior row: A_const on e' of the interior-masked neighbours,
      // whose grid positions come from the offsets' grid steps
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < kOffsets; ++k) {
        const long long q = idx + op.st.off[k];
        const bool in = q >= 0 && q < nsf;
        const long long qq = in ? q : idx;
        const T eq = e[qq] + prolonged(ec, sz + op.dz[k], sy + op.dy[k],
                                       sx + op.dx[k], g);
        acc += T(op.st.w[k]) * ((in && code_f[qq] == T(1)) ? eq : T(0));
      }
      ax = acc;
    }
    const T invd = c == T(1) ? T(op.inv_w0) : T(1);
    const T out = ep + T(op.omega) * invd * (r[idx] - ax);
    y[idx] = out;
    part = static_cast<double>(r[idx]) * static_cast<double>(out);
  }
  if (partials != nullptr) {
    part = tpufem::block_sum<tpufem::kBlock>(part);
    if (threadIdx.x == 0) partials[blockIdx.x] = part;
  }
}

ConstOp make_op(const long long* offsets, const int* grid_offsets,
                const double* weights, double inv_w0, double omega) {
  ConstOp op;
  for (int i = 0; i < kOffsets; ++i) {
    op.st.off[i] = offsets[i];
    op.dz[i] = grid_offsets[3 * i];
    op.dy[i] = grid_offsets[3 * i + 1];
    op.dx[i] = grid_offsets[3 * i + 2];
    op.st.w[i] = weights[i];
  }
  op.inv_w0 = inv_w0;
  op.omega = omega;
  return op;
}

Dims make_dims(const int* fine_sg, const int* coarse_sg,
               const int* coarse_ng) {
  return Dims{fine_sg[0],   fine_sg[1],   fine_sg[2],
              coarse_sg[0], coarse_sg[1], coarse_sg[2],
              coarse_ng[0], coarse_ng[1], coarse_ng[2]};
}

template <typename T>
int launch_rr(const T* code_f, const T* code_c, const T* r, const T* e, T* rc,
              const int* fine_sg, const int* coarse_sg, const int* coarse_ng,
              const long long* offsets, const int* grid_offsets,
              const double* weights, int k, void* stream) {
  if (k != kOffsets) return static_cast<int>(cudaErrorInvalidValue);
  const Dims g = make_dims(fine_sg, coarse_sg, coarse_ng);
  const ConstOp op = make_op(offsets, grid_offsets, weights, 0.0, 0.0);
  const long long nsc = static_cast<long long>(g.c0) * g.c1 * g.c2;
  residual_restrict_kernel<T><<<tpufem::num_blocks(nsc), tpufem::kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      code_f, code_c, r, e, rc, g, op);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pas(const T* code_f, const T* ec, const T* r, const T* e, T* y,
               double* partials, T* dot, const int* fine_sg,
               const int* coarse_sg, const int* coarse_ng,
               const long long* offsets, const int* grid_offsets,
               const double* weights, int k, double inv_w0, double omega,
               void* stream) {
  if (k != kOffsets) return static_cast<int>(cudaErrorInvalidValue);
  const Dims g = make_dims(fine_sg, coarse_sg, coarse_ng);
  const ConstOp op = make_op(offsets, grid_offsets, weights, inv_w0, omega);
  const long long nsf = static_cast<long long>(g.f0) * g.f1 * g.f2;
  const unsigned int nb = tpufem::num_blocks(nsf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  prolong_add_smooth_kernel<T><<<nb, tpufem::kBlock, 0, s>>>(
      code_f, ec, r, e, y, dot != nullptr ? partials : nullptr, g, op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dot == nullptr) return static_cast<int>(err);
  tpufem::finish_dot_kernel<T><<<1, tpufem::kFinishBlock, 0, s>>>(
      partials, static_cast<int>(nb), dot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fine_sg / coarse_sg: store grids; coarse_ng: coarse node grid (3 ints
// each).  offsets / grid_offsets / weights: the fine level's k = 15 flat
// offsets, the same as (dz, dy, dx) triples, and the 15 weights.
int tpufem_residual_restrict_f32(const float* code_f, const float* code_c,
                                 const float* r, const float* e, float* rc,
                                 const int* fine_sg, const int* coarse_sg,
                                 const int* coarse_ng,
                                 const long long* offsets,
                                 const int* grid_offsets,
                                 const double* weights, int k, void* stream) {
  return launch_rr<float>(code_f, code_c, r, e, rc, fine_sg, coarse_sg,
                          coarse_ng, offsets, grid_offsets, weights, k,
                          stream);
}

int tpufem_residual_restrict_f64(const double* code_f, const double* code_c,
                                 const double* r, const double* e, double* rc,
                                 const int* fine_sg, const int* coarse_sg,
                                 const int* coarse_ng,
                                 const long long* offsets,
                                 const int* grid_offsets,
                                 const double* weights, int k, void* stream) {
  return launch_rr<double>(code_f, code_c, r, e, rc, fine_sg, coarse_sg,
                           coarse_ng, offsets, grid_offsets, weights, k,
                           stream);
}

// partials: fp64 scratch of num_blocks(fine rows) slots, used when
// dot != NULL.
int tpufem_prolong_add_smooth_f32(const float* code_f, const float* ec,
                                  const float* r, const float* e, float* y,
                                  double* partials, float* dot,
                                  const int* fine_sg, const int* coarse_sg,
                                  const int* coarse_ng,
                                  const long long* offsets,
                                  const int* grid_offsets,
                                  const double* weights, int k, double inv_w0,
                                  double omega, void* stream) {
  return launch_pas<float>(code_f, ec, r, e, y, partials, dot, fine_sg,
                           coarse_sg, coarse_ng, offsets, grid_offsets,
                           weights, k, inv_w0, omega, stream);
}

int tpufem_prolong_add_smooth_f64(const double* code_f, const double* ec,
                                  const double* r, const double* e, double* y,
                                  double* partials, double* dot,
                                  const int* fine_sg, const int* coarse_sg,
                                  const int* coarse_ng,
                                  const long long* offsets,
                                  const int* grid_offsets,
                                  const double* weights, int k, double inv_w0,
                                  double omega, void* stream) {
  return launch_pas<double>(code_f, ec, r, e, y, partials, dot, fine_sg,
                            coarse_sg, coarse_ng, offsets, grid_offsets,
                            weights, k, inv_w0, omega, stream);
}

int tpufem_num_blocks(long long n) {
  return static_cast<int>(tpufem::num_blocks(n));
}

}  // extern "C"
