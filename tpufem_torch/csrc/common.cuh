// Shared device helpers of the port's kernels: a deterministic two-pass
// dot product, the separately rounded product and sum and the banded
// window base of the sparse kernels, the widening load of stored
// coefficients, the stencil epilogues and the sweep's rounding of
// omega * inv_diag, the taps of the constant-coefficient (uniform-grid)
// operator, and the staging of store planes into shared memory with
// cp.async (with its host side: alignment, the shared-memory limit).
//
// The TPU kernels accumulate a dot into one SMEM cell across their
// sequential grid (tpufem/ops/stencil_pallas.py::_kernel_matvec_dot,
// tpufem/ops/mg_transfer_pallas.py::_kern_pas).  On the GPU blocks run in no
// order, so each block writes its partial sum (fp64) to its own slot and a
// second one-block pass sums the slots in a fixed order: the result is
// bit-reproducible from run to run, with no float atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace tpufem {

constexpr int kBlock = 256;        // threads per block of every 1-D launch
constexpr int kFinishBlock = 1024; // threads of the second dot pass

// Sum of v over the block (result valid in thread 0).  blockDim.x == BLOCK.
template <int BLOCK>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[BLOCK / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  v = (threadIdx.x < BLOCK / 32) ? warp_sums[threadIdx.x] : 0.0;
  if (wid == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Second pass: out[0] = sum of partials[0..n), in a fixed order.
template <typename T>
__global__ void finish_dot_kernel(const double* __restrict__ partials, int n,
                                  T* __restrict__ out) {
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kFinishBlock) v += partials[i];
  v = block_sum<kFinishBlock>(v);
  if (threadIdx.x == 0) out[0] = static_cast<T>(v);
}

inline unsigned int num_blocks(long long n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

// A stored value in its arithmetic type: bf16 coefficient planes widen to
// fp32 on load (exactly), as the reference's products promote in-register.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A product and a sum each rounded on its own (no fused multiply-add): the
// sparse kernels (B9-B12) add in the reference's order with its rounding,
// so they equal their plain PyTorch versions bit for bit.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// First column of the window of row i in a banded plan of block_rows R:
// row i of block j = i / R reads x at (j - 1) R + rel.  block_rows 0 marks
// absolute columns (base 0).
__device__ __forceinline__ long long window_base(long long i,
                                                 long long block_rows) {
  return block_rows > 0 ? (i / block_rows - 1) * block_rows : 0;
}

// The stencil kernels' epilogues (K2/B4, B5 and their blocked twins B3,
// B5b): y = A x, y = b - A x, y = x + omega invd (b - A x).
enum Epilogue : int { kMatvec = 0, kResidual = 1, kSmooth = 2 };

// The sweep's omega * inv_diag, rounded to the coefficient type TD before
// it meets the residual in the vector type TV, as the reference's weakly
// typed scalar product is.
template <typename TD, typename TV>
__device__ __forceinline__ TV omega_inv_diag(double omega, TD inv_diag) {
  return TV(widen(TD(TV(omega) * TV(widen(inv_diag)))));
}

template <>
__device__ __forceinline__ float omega_inv_diag<__nv_bfloat16, float>(
    double omega, __nv_bfloat16 inv_diag) {
  const float w =
      __bfloat162float(__float2bfloat16(static_cast<float>(omega)));
  return __bfloat162float(__float2bfloat16(w * __bfloat162float(inv_diag)));
}

// -- the constant-coefficient (uniform-grid) operator on staged planes -------
// (B5 and B5b in const_stencil.cu; K3 and K4 in mg_transfer.cu)

// The stencils' grid steps (dz, dy, dx) in the embedded plans' offset order
// (flat offsets ascending): the 3D Kuhn split (K = 15) and the 2D
// anti-diagonal split (K = 7) on a 2D store grid (S0, S1) viewed as
// (1, S0, S1), whose (dy, dx) become (0, dy, dx).  The taps' offsets are
// compile-time constants; each launcher checks a level's steps against
// its table.
template <int K>
__host__ __device__ constexpr int tap_step(int k, int axis) {
  static_assert(K == 15 || K == 7, "the Kuhn (15) or the 2D (7) stencil");
  if constexpr (K == 15) {
    constexpr int steps[15][3] = {
        {-1, -1, -1}, {-1, -1, 0}, {-1, 0, -1}, {-1, 0, 0}, {0, -1, -1},
        {0, -1, 0},   {0, 0, -1},  {0, 0, 0},   {0, 0, 1},  {0, 1, 0},
        {0, 1, 1},    {1, 0, 0},   {1, 0, 1},   {1, 1, 0},  {1, 1, 1}};
    return steps[k][axis];
  } else {
    constexpr int steps[7][3] = {{0, -1, 0}, {0, -1, 1}, {0, 0, -1},
                                 {0, 0, 0},  {0, 0, 1},  {0, 1, -1},
                                 {0, 1, 0}};
    return steps[k][axis];
  }
}

// Whether k (dz, dy, dx) triples are the stencil's table.
template <int K>
inline bool is_tap_table(const int* steps, int k) {
  if (k != K) return false;
  for (int i = 0; i < K; ++i)
    for (int a = 0; a < 3; ++a)
      if (steps[3 * i + a] != tap_step<K>(i, a)) return false;
  return true;
}

// A level's weights, 1 / w0 and omega in the vector type (rounded on the
// host as the device would round them), passed by value.
template <int K, typename T>
struct ConstOp {
  T w[K];
  T inv_w0;
  T omega;
};

template <int K, typename T>
ConstOp<K, T> make_const_op(const double* weights, double inv_w0,
                            double omega) {
  ConstOp<K, T> op;
  for (int i = 0; i < K; ++i) op.w[i] = static_cast<T>(weights[i]);
  op.inv_w0 = static_cast<T>(inv_w0);
  op.omega = static_cast<T>(omega);
  return op;
}

// An interior row of A_const from a ring of three masked planes (the row's
// plane and its neighbours below and above; rows of W values), the taps in
// offset order from 0: each term an FMA under nvcc's default contraction.
template <int K, int W, typename T>
__device__ __forceinline__ T taps(const T* below, const T* mid,
                                  const T* above, int j,
                                  const ConstOp<K, T>& op) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int dz = tap_step<K>(k, 0);
    const T* pl = dz < 0 ? below : (dz > 0 ? above : mid);
    acc += op.w[k] * pl[j + tap_step<K>(k, 1) * W + tap_step<K>(k, 2)];
  }
  return acc;
}

// -- staging store planes into shared memory ---------------------------------

// Values a 16-byte chunk holds.
template <typename T>
__host__ __device__ constexpr int chunk() {
  return 16 / static_cast<int>(sizeof(T));
}

// A block stages positions [0, hi) on each axis; 0 outside.
struct Box {
  int z1, y1, x1;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (4, 8 or 16) into shared memory; src_bytes 0 fills
// zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [y_lo, y_lo + rows) x columns [x_lo, x_lo + W) of store
// plane z into dst (row stride W) element by element, 0 outside the box:
// the staging of a tile whose source is not 16-byte aligned.  Elements of
// 2 bytes (a bf16 code plane), which cp.async does not take, are copied
// with a load and a store.
template <typename T, int W, int THREADS>
__device__ __forceinline__ void stage_elements(T* dst,
                                               const T* __restrict__ src,
                                               int z, int y_lo, int rows,
                                               int x_lo, const Box& box,
                                               int f1, int f2) {
  const bool zok = z >= 0 && z < box.z1;
  for (int i = threadIdx.x; i < rows * W; i += THREADS) {
    const int row = i / W, col = i - row * W;
    const int y = y_lo + row, x = x_lo + col;
    const bool ok = zok && y >= 0 && y < box.y1 && x >= 0 && x < box.x1;
    const T* s = ok ? src + (static_cast<long long>(z) * f1 + y) * f2 + x
                    : src;
    if constexpr (sizeof(T) >= 4) {
      cp_async<sizeof(T)>(dst + i, s, ok ? static_cast<int>(sizeof(T)) : 0);
    } else {
      static_assert(sizeof(T) == 2, "2-byte elements");
      reinterpret_cast<unsigned short*>(dst)[i] =
          ok ? *reinterpret_cast<const unsigned short*>(s) : 0;
    }
  }
}

// A thread's share of a tile staged plane after plane (ROWS rows of W
// values from row y_lo, column x_lo; x_lo and W whole 16-byte chunks) by
// a block of THREADS threads: each chunk's offset in the tile and in a
// store plane, and whether it lies in the box's rows and columns.  Planned
// once per block, so that a plane's copy costs each thread a few
// instructions per chunk.
template <typename T, int W, int ROWS, int THREADS>
struct Stage {
  static constexpr int kChunks = ROWS * (W / chunk<T>());
  static constexpr int kN = (kChunks + THREADS - 1) / THREADS;
  int tile[kN];   // -1: no chunk
  int plane[kN];
  bool ok[kN];

  __device__ __forceinline__ Stage(int y_lo, int x_lo, const Box& box,
                                   int f2) {
    constexpr int H = chunk<T>(), NC = W / H;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int i = threadIdx.x + n * THREADS;
      const int row = i / NC, ch = i - row * NC;
      const int y = y_lo + row, x = x_lo + ch * H;
      tile[n] = i < kChunks ? row * W + ch * H : -1;
      ok[n] = y >= 0 && y < box.y1 && x >= 0 && x < box.x1;
      plane[n] = ok[n] ? y * f2 + x : 0;
    }
  }

  // Copy store plane z of src into dst, 0 outside the box; a chunk that
  // starts inside the box is copied whole (the store rows are whole
  // chunks).  Element by element where a pointer is not 16-byte aligned
  // (vec false).
  __device__ __forceinline__ void issue(T* dst, const T* __restrict__ src,
                                        int z, const Box& box, int f1,
                                        int f2, int y_lo, int x_lo,
                                        bool vec) const {
    if (!vec) {
      stage_elements<T, W, THREADS>(dst, src, z, y_lo, ROWS, x_lo, box, f1,
                                    f2);
      return;
    }
    const bool zok = z >= 0 && z < box.z1;
    const T* base = zok ? src + static_cast<long long>(z) * f1 * f2 : src;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (tile[n] < 0) continue;
      const bool in = zok && ok[n];
      cp_async<16>(dst + tile[n], in ? base + plane[n] : src, in ? 16 : 0);
    }
  }
};

// -- host side of the staged kernels -----------------------------------------

inline bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15u) == 0;
}

inline unsigned int ceil_div(int a, int b) {
  return static_cast<unsigned int>((a + b - 1) / b);
}

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared memory limit to `bytes` (once per
// kernel, device and size); 0 or the CUDA error.
template <auto Kernel>
int allow_smem(size_t bytes) {
  static size_t allowed[kMaxDevices] = {};
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && allowed[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch
    return static_cast<int>(err);
  }
  if (dev < kMaxDevices) allowed[dev] = bytes;
  return 0;
}

}  // namespace tpufem
