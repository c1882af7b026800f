// The inverses of the smooth leaky ReLU, y = alpha*x + (1-alpha)*softplus(x),
// and of the smooth tanh, y = tanh(alpha*x) + beta*x, by Newton-Raphson from
// x = y, at most 100 steps, for Hopper (sm_90a), float32.
//
// Replaces the JAX package's SmoothLeakyRelu.inverse
// (inverse_flow_tpu/layers/activations.py:38-46, :61-62), a jax.lax.fori_loop
// of 100 steps that XLA fuses into one loop. It is not a Pallas kernel: it is
// the card's counterpart of that fused loop. Written as torch ops, each Newton
// step launches about ten elementwise kernels, a thousand per layer inverse.
//
// One thread per element: the element's x stays in registers for all the
// steps, so a kernel reads y once and writes x once. Each step takes
// exp(-|x|) once and shares it between the softplus (max(x, 0) + log1p(e))
// and the sigmoid, whose 1/(1+e) is folded into the Newton quotient:
//
//   x <- x - (f(x) - y) * (1 + e) / max(alpha*(1 + e) + (1-alpha)*s, 0.01*(1 + e))
//
// with s = 1 for x >= 0, else e, which is f'(x) = alpha + (1-alpha)*sigmoid(x)
// floored at 1e-2, times (1 + e). Built without --use_fast_math.
//
// Two kernels for the smooth leaky ReLU, chosen by
// ops/activations.py:slr_inverse:
//
// newton_inverse_kernel<SlrStep>, "slr_inverse_kernel" (every call). A
// step's cost is one dependent chain of about 530 cycles (the accurate expf, log1pf and an IEEE division), and from
// x = y the iterate settles within a few steps for |y| <= 40, so running all
// 100 recomputes a constant. Each warp stops once a step has moved every
// lane's x by at most kExitTol * max(1, |x|) (__all_sync): 2 ulp of 1 below
// |x| = 1, 2-4 ulp of x above. An exit at a bitwise fixed point would give the
// 100-step bits exactly, but the reference's own iterate cycles between floats
// 3 ulp apart for 15.5% of y in [-40, 40] at alpha 0.3 (the residual's rounding,
// about ulp(y), over f'), which would keep most warps at 100 steps. Within the
// tolerance Newton has converged, so the result differs from the 100-step x by
// at most about one such cycle: 2.4e-7 * max(1, |x|) on the reference loop
// (tests/test_torch_wide.py). The residual f(x) - y, which sets the fixed
// point, keeps the accurate expf and log1pf; the quotient, which only sets the
// path to it, uses the approximate division (__fdividef). A grid of one
// thread per element, so that warps that finish free their slots for waiting
// blocks; it is bound by the special-function unit's operations on the steps
// these inputs need (chip_smoke.py counts them).
//
// slr_inverse_fixed_kernel, the first design: all `iters` steps, the IEEE
// division, a grid of at most the resident threads with a grid stride. Kept as
// a forced variant for the timings.
//
// The smooth tanh's inverse (ops/activations.py:smooth_tanh_inverse).
// Replaces SmoothTanh.inverse (inverse_flow_tpu/layers/activations.py:38-46,
// :117-121), the same 100-step fori_loop on f(x) = tanh(alpha*x) + beta*x,
// f' = beta + alpha/cosh^2(alpha*x) floored at 1e-2. One thread per element,
// x in registers. The residual f(x) - y keeps the accurate tanhf, which sets
// the fixed point. f' takes 1/cosh^2 = 1 - t^2 from that same t, so a step
// costs tanhf's EX2 and RCP and the quotient's __fdividef (its divisor lies
// in [0.01, alpha + beta]): 3 special-function operations, which
// chip_smoke.py reads from the SASS. f' only sets the path: 1 - t^2 stays
// within 1e-7 * alpha of 1/cosh^2 (torch's float32 tanh over |alpha*x| <=
// 40), against an f' of at least 1e-2; the reference loop's coshf and IEEE
// division would add an EX2, two RCPs and a slow path to each step.
//
// newton_lane_exit_kernel<TanhStep> (every call). Each lane stops once its
// own iterate is done, by either of two tests: the step moved x by at most
// kExitTol * max(1, |x|), or the residual f(x) - y that the step computed
// is at most kExitTol * max(1, |y|), 2 ulp of max(1, |y|). The lane keeps
// that step's x from then on; the warp stops when every lane is done. The step test alone left 0.02-0.26% of y in [-40, 40] at 100
// steps: where f' is near beta (|alpha*x| of 2-4) the residual's rounding
// over f' keeps the iterate in a cycle wider than the test (up to 4.2e-7 of
// |x| at beta 0.1, 2.7e-6 at 0.01), and one such lane held its warp for all
// 100 steps. In that cycle the residual is already at its rounding, so the
// residual test ends it: on the reference loop over 200,001 y in [-40, 40]
// at alpha 1 no element needs more than 5 steps at beta 0.1 and 8 at 0.01,
// each within ops/activations.py:smooth_tanh_inverse_limit of the 100-step
// x (tests/test_torch_bspline_kernel.py). The residual is read from the
// step's own f - y, so a step still costs 3 special-function operations.
//
// newton_inverse_kernel<TanhStep>, the first design ("step_exit"), kept as
// a forced variant for the timings: the SLR kernel's warp exit, every lane
// settled by the step test at the same step.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr float kFloor = 1e-2f;
// a Newton iterate is done once a step moved x by at most this times
// max(1, |x|) (or, in newton_lane_exit_kernel, once its residual is at most
// this times max(1, |y|)): 2^-22
constexpr float kExitTol = 2.384185791015625e-7f;

// One Newton step of the smooth leaky ReLU's inverse: the sigmoid's
// 1/(1+e) folded into the quotient.
struct SlrStep {
  float alpha;
  __device__ float operator()(float xi, float yi) const {
    const float beta = 1.0f - alpha;
    const float e = expf(-fabsf(xi));
    const float f = alpha * xi + beta * (fmaxf(xi, 0.0f) + log1pf(e));
    const float one_e = 1.0f + e;
    const float s = xi >= 0.0f ? 1.0f : e;
    const float den = fmaxf(alpha * one_e + beta * s, kFloor * one_e);
    return xi - (f - yi) * __fdividef(one_e, den);
  }
};

// One Newton step of the smooth tanh's inverse; `res` gets the residual
// f(x) - y at the step's x.
struct TanhStep {
  float alpha, beta;
  __device__ float operator()(float xi, float yi, float& res) const {
    const float t = tanhf(alpha * xi);
    res = t + beta * xi - yi;
    const float fprime = fmaxf(beta + alpha * (1.0f - t * t), kFloor);
    return xi - __fdividef(res, fprime);
  }
  __device__ float operator()(float xi, float yi) const {
    float res;
    return (*this)(xi, yi, res);
  }
};

template <class Step>
__global__ void __launch_bounds__(kThreads)
newton_inverse_kernel(const float* __restrict__ y, float* __restrict__ x,
                      long long n, Step step, int iters) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < n;  // every lane of a warp takes part in the vote
  const float yi = live ? y[i] : 0.0f;
  float xi = yi;
  for (int k = 0; k < iters; ++k) {
    const float next = step(xi, yi);
    const bool settled =
        !live || fabsf(next - xi) <= kExitTol * fmaxf(1.0f, fabsf(xi));
    xi = next;
    if (__all_sync(0xffffffffu, settled)) break;
  }
  if (live) x[i] = xi;
}

// Each lane stops at its own step test or residual test, keeping that
// step's x; the warp stops when every lane has stopped.
template <class Step>
__global__ void __launch_bounds__(kThreads)
newton_lane_exit_kernel(const float* __restrict__ y, float* __restrict__ x,
                        long long n, Step step, int iters) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < n;  // every lane of a warp takes part in the vote
  const float yi = live ? y[i] : 0.0f;
  const float res_tol = kExitTol * fmaxf(1.0f, fabsf(yi));
  float xi = yi;
  bool done = !live;
  // a lane that is done still runs the warp's steps (SIMT) but keeps its x
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    float res;
    const float next = step(xi, yi, res);
    const bool now = fabsf(next - xi) <= kExitTol * fmaxf(1.0f, fabsf(xi)) ||
                     fabsf(res) <= res_tol;
    xi = done ? xi : next;
    done = done || now;
    if (__all_sync(0xffffffffu, done)) break;
  }
  if (live) x[i] = xi;
}

__global__ void __launch_bounds__(kThreads)
slr_inverse_fixed_kernel(const float* __restrict__ y, float* __restrict__ x,
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

// One thread per element; kLaneExit picks newton_lane_exit_kernel.
template <bool kLaneExit, class Step>
int launch_newton(const float* y, float* x, long long n, Step step, int iters,
                  void* stream) {
  const long long need = (n + kThreads - 1) / kThreads;
  if (need > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kLaneExit) {
    newton_lane_exit_kernel<<<static_cast<int>(need), kThreads, 0, s>>>(
        y, x, n, step, iters);
  } else {
    newton_inverse_kernel<<<static_cast<int>(need), kThreads, 0, s>>>(
        y, x, n, step, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x = the smooth leaky ReLU's inverse of y (n floats each, device pointers)
// on `stream`. Returns the CUDA error of the launch (0 when it was taken).
extern "C" int slr_inverse_f32(const float* y, float* x, long long n,
                               float alpha, int iters, void* stream) {
  return launch_newton<false>(y, x, n, SlrStep{alpha}, iters, stream);
}

// x = the smooth tanh's inverse of y: the same, with tanh's alpha and beta,
// each lane stopping on its own (newton_lane_exit_kernel).
extern "C" int smooth_tanh_inverse_f32(const float* y, float* x, long long n,
                                       float alpha, float beta, int iters,
                                       void* stream) {
  return launch_newton<true>(y, x, n, TanhStep{alpha, beta}, iters, stream);
}

// The first design of the smooth tanh's inverse, the SLR kernel's warp exit
// (newton_inverse_kernel<TanhStep>): the same arguments.
extern "C" int smooth_tanh_inverse_step_exit_f32(const float* y, float* x,
                                                 long long n, float alpha,
                                                 float beta, int iters,
                                                 void* stream) {
  return launch_newton<false>(y, x, n, TanhStep{alpha, beta}, iters,
                              stream);
}

// The first design of the smooth leaky ReLU's inverse, all `iters` steps:
// the same arguments as slr_inverse_f32.
extern "C" int slr_inverse_fixed_f32(const float* y, float* x, long long n,
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
  slr_inverse_fixed_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      y, x, n, alpha, iters);
  return static_cast<int>(cudaGetLastError());
}
