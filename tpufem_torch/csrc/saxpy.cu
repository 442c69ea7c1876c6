// SAXPY: out = a * x + y, with the scalar a read from device memory.
//
// Replaces examples/saxpy_pallas.py::saxpy_kernel (a from SMEM, x and y
// in (8, n/256) VMEM blocks over a grid of 32).  Bound on the card: bytes
// (x and y read once, out written once: 12 bytes an element in fp32, 805.3
// MB at n = 2^26, 0.2404 ms at 3.35 TB/s).  Design: each thread moves one
// 16-byte vector (float4 / double2) of x, y and out and reads a once into a
// register, after its vectors' loads are issued; the grid covers the
// vectors (a grid sized to the SMs with a grid-stride loop was slower at
// n = 2^26 in a trial on the card).  y moves as a vector when it
// shares x's 16-byte phase, else element by element.  Elements before x's
// first 16-byte boundary (a view such as x[1:]) form a scalar head, a
// ragged end a scalar tail, both in the one kernel; the wrapper allocates
// out at x's phase.  The product and the sum are each rounded on their own
// (no fused multiply-add), as the plain version (ops.saxpy_cuda.
// saxpy_plain) and the example's golden computation round them; the kernel
// equals both bit for bit.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using tpufem::add_rn;
using tpufem::mul_rn;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ float4 axpy(float a, float4 x,
                                                float4 y) {
    return make_float4(
        add_rn(mul_rn(a, x.x), y.x), add_rn(mul_rn(a, x.y), y.y),
        add_rn(mul_rn(a, x.z), y.z), add_rn(mul_rn(a, x.w), y.w));
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ double2 axpy(double a, double2 x,
                                                 double2 y) {
    return make_double2(add_rn(mul_rn(a, x.x), y.x),
                        add_rn(mul_rn(a, x.y), y.y));
  }
};

// head: elements before x's first 16-byte boundary; out shares x's phase
// (out_vec), y may (y_vec).  Then one vector a thread, then the tail.
template <typename T>
__global__ void __launch_bounds__(tpufem::kBlock)
saxpy_kernel(const T* __restrict__ a, const T* __restrict__ x,
             const T* __restrict__ y, T* __restrict__ out, long long n,
             int head, bool y_vec, bool out_vec) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::n;
  const long long i =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long nvec = (n - head) / W;
  V xi, yi;
  if (i < nvec) {
    xi = reinterpret_cast<const V*>(x + head)[i];
    if (y_vec) {
      yi = reinterpret_cast<const V*>(y + head)[i];
    } else {
      T* e = reinterpret_cast<T*>(&yi);
#pragma unroll
      for (int w = 0; w < W; ++w) e[w] = y[head + i * W + w];
    }
  }
  const T av = a[0];
  if (i < nvec) {
    const V o = Vec<T>::axpy(av, xi, yi);
    if (out_vec) {
      reinterpret_cast<V*>(out + head)[i] = o;
    } else {
      const T* e = reinterpret_cast<const T*>(&o);
#pragma unroll
      for (int w = 0; w < W; ++w) out[head + i * W + w] = e[w];
    }
  }
  const long long tail = head + nvec * W;
  if (i < head) out[i] = add_rn(mul_rn(av, x[i]), y[i]);
  if (i < n - tail)
    out[tail + i] = add_rn(mul_rn(av, x[tail + i]), y[tail + i]);
}

template <typename T>
int launch(const T* a, const T* x, const T* y, T* out, long long n,
           void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const auto phase = [](const T* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  };
  const int px = phase(x);
  const long long head = std::min<long long>(
      n, (16 - px) % 16 / static_cast<int>(sizeof(T)));
  // one thread a vector, and enough for the head and the tail
  const long long work = std::max((n - head) / Vec<T>::n, head + Vec<T>::n);
  saxpy_kernel<T><<<static_cast<unsigned>(tpufem::num_blocks(work)),
                    tpufem::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      a, x, y, out, n, static_cast<int>(head), phase(y) == px,
      phase(out) == px);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tpufem_saxpy_f32(const float* a, const float* x, const float* y,
                     float* out, long long n, void* stream) {
  return launch<float>(a, x, y, out, n, stream);
}

int tpufem_saxpy_f64(const double* a, const double* x, const double* y,
                     double* out, long long n, void* stream) {
  return launch<double>(a, x, y, out, n, stream);
}

}  // extern "C"
