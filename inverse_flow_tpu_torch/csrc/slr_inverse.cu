// The inverse of the smooth leaky ReLU, y = alpha*x + (1-alpha)*softplus(x),
// by a fixed 100-step Newton-Raphson, for Hopper (sm_90a), float32.
//
// Replaces the JAX package's SmoothLeakyRelu.inverse
// (inverse_flow_tpu/layers/activations.py:38-46, :61-62), a jax.lax.fori_loop
// that XLA fuses into one loop. It is not a Pallas kernel: it is the card's
// counterpart of that fused loop. Written as torch ops, each Newton step
// launches about ten elementwise kernels, a thousand per layer inverse.
//
// One thread per element (a grid-stride loop past the resident threads): the
// element's x stays in registers for all the steps, so the kernel reads y once
// and writes x once. It is bound by operations, the special-function unit's:
// each step takes exp(-|x|) once and shares it between the softplus
// (max(x, 0) + log1p(e)) and the sigmoid, whose 1/(1+e) is folded into the
// Newton quotient, so a step costs one exp, one log and one division:
//
//   x <- x - (f(x) - y) * (1 + e) / max(alpha*(1 + e) + (1-alpha)*s, 0.01*(1 + e))
//
// with s = 1 for x >= 0, else e, which is f'(x) = alpha + (1-alpha)*sigmoid(x)
// floored at 1e-2, times (1 + e). Built without --use_fast_math, so expf and
// log1pf are the accurate ones, as torch's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFloor = 1e-2f;

__global__ void __launch_bounds__(kThreads)
slr_inverse_kernel(const float* __restrict__ y, float* __restrict__ x,
                   long long n, float alpha, int iters) {
  const float beta = 1.0f - alpha;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float yi = y[i];
    float xi = yi;
    for (int k = 0; k < iters; ++k) {
      const float e = expf(-fabsf(xi));
      const float softplus = fmaxf(xi, 0.0f) + log1pf(e);
      const float f = alpha * xi + beta * softplus;
      const float one_e = 1.0f + e;
      const float s = xi >= 0.0f ? 1.0f : e;
      const float den = fmaxf(alpha * one_e + beta * s, kFloor * one_e);
      xi -= (f - yi) * one_e / den;
    }
    x[i] = xi;
  }
}

}  // namespace

// x = the inverse of y (n floats each, device pointers) on `stream`. Returns
// the CUDA error of the launch (0 when it was taken).
extern "C" int slr_inverse_f32(const float* y, float* x, long long n,
                               float alpha, int iters, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // every thread resident at once (2,048 a SM), the rest by the grid stride
  const long long resident = static_cast<long long>(sms) * (2048 / kThreads);
  const long long need = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < resident ? need : resident);
  slr_inverse_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(y, x, n, alpha,
                                                            iters);
  return static_cast<int>(cudaGetLastError());
}
