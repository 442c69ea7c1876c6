// SAXPY: out = a * x + y, with the scalar a read from device memory.
//
// Replaces examples/saxpy_pallas.py::saxpy_kernel (a from SMEM, x and y
// in (8, n/256) VMEM blocks over a grid of 32).  Bound on the card: bytes
// (x and y read once, out written once).  Design: one thread per element,
// the product and the sum each rounded on their own (no fused
// multiply-add), as the plain version (ops.saxpy_cuda.saxpy_plain) and the
// example's golden computation round them; the kernel equals both bit for
// bit.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(tpufem::kBlock)
saxpy_kernel(const T* __restrict__ a, const T* __restrict__ x,
             const T* __restrict__ y, T* __restrict__ out, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i < n) out[i] = tpufem::add_rn(tpufem::mul_rn(a[0], x[i]), y[i]);
}

template <typename T>
int launch(const T* a, const T* x, const T* y, T* out, long long n,
           void* stream) {
  saxpy_kernel<T><<<tpufem::num_blocks(n), tpufem::kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, x, y, out, n);
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
