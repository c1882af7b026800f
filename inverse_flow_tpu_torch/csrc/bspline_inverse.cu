// The inverse of the monotone cubic B-spline bijection of [0, 1] and the
// log-det of that inverse, for Hopper (sm_90a), float32, one thread per
// element.
//
// Replaces the JAX package's monotone_cubic_b_spline(..., inverse=True)
// (inverse_flow_tpu/layers/splines.py:227-253), the inverse of
// BSplineActivation, BSplineCoupling and ConditionalBSplineTransformer. It is
// not a Pallas kernel: it finds the bin, then runs 20 bisection steps and 5
// Newton steps in fori_loops that XLA fuses. Written as torch ops
// (ops/bspline.py:monotone_cubic_b_spline, the plain version), each step
// gathers the bin's control points from the (..., K+3) coefficients and
// launches a few dozen elementwise kernels: about 1,430 launch calls a layer
// inverse.
//
// Each thread reads its element's y and its K+3 raw coefficients where the
// caller keeps them (`inner`):
//   inner == 0: one set shared by every element (BSplineActivation, (K+3,));
//   inner >= 1: element i = (row, s) with s = i % inner, coefficient j at
//     (row * (K+3) + j) * inner + s: channel-major (B, C*(K+3), H, W) straight
//     from a coupling net at inner = H*W, the last dim (..., K+3) at
//     inner = 1.
// In registers it then does what the plain version does, in its order: the
// softmax, the min_step floor and the cumsum into the control points c; the
// knot values v_j = (c_j + 4 c_{j+1} + c_{j+2}) / 6 and their normalized
// vn_j; the bin by the same y >= vn_j comparisons; 20 bisection steps and 5
// Newton steps on that bin's four control points, held in registers (no
// gather per step); and (i + t) / K and -log(max(dy/dx, 1e-12)), written
// once. The divisions by 6 and by the knots' span become products with
// their reciprocals: the spline's value and slope move by an ulp or two,
// and the root and the log-det by that over the slope, inside the port's
// 1e-5 rule.
//
// What bounds it: a thread does 930 floating-point operations at K = 8
// (894 at K = 5): the softmax and the knots, and 26 evaluations of the bin's
// cubic in this B-spline basis form, 25 each. The least the plain version's
// algorithm needs is 234 an element, with the cubic in power form, plus the
// softmax, knots and power form once per coefficient set
// (chip_smoke.py:bspline_flops); against that, 12 bytes of y, x and the
// log-det an element, plus 4 (K+3) bytes of its own coefficients
// where it has its own: the function is bound by bytes in every layout, and
// this kernel does 2.4-4 times its least operations. K is a runtime
// argument up to kMaxBins: the coefficient arrays are unrolled to that size
// with guards, so they stay in registers. Built without --use_fast_math.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 16;
constexpr int kMaxCoeffs = kMaxBins + 3;
// monotone_cubic_b_spline's min_step, the floor of each softmax step
constexpr float kMinStep = 1e-4f;
constexpr float kSixth = 1.0f / 6.0f;
constexpr int kBisections = 20;
constexpr int kNewtonSteps = 5;

// The four control points of one bin, its knot value v_0 and the
// reciprocal of the knots' span v_K - v_0.
struct Bin {
  float c0, c1, c2, c3, v0, inv_scale;

  // (f(t) - v_0) / (v_K - v_0): the spline at local parameter t, in
  // normalized output coordinates
  __device__ float value(float t) const {
    const float omt = 1.0f - t;
    const float t2 = t * t, t3 = t2 * t;
    const float omt3 = omt * omt * omt;
    const float f = (c0 * omt3 + c1 * (3.0f * t3 - 6.0f * t2 + 4.0f) +
                     c2 * (-3.0f * t3 + 3.0f * t2 + 3.0f * t + 1.0f) +
                     c3 * t3) *
                    kSixth;
    return (f - v0) * inv_scale;
  }

  // d value / dx at t, x = (i + t) / k
  __device__ float slope(float t, float k) const {
    const float omt = 1.0f - t;
    const float t2 = t * t;
    const float dfdt = ((c1 - c0) * (omt * omt) +
                        (c2 - c1) * (-2.0f * t2 + 2.0f * t + 1.0f) +
                        (c3 - c2) * t2) *
                       0.5f;
    return k * dfdt * inv_scale;
  }
};

__global__ void __launch_bounds__(kThreads)
bspline_inverse_kernel(const float* __restrict__ y,
                       const float* __restrict__ coeffs,
                       float* __restrict__ x, float* __restrict__ logdet,
                       long long n, int bins, long long inner) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int kp3 = bins + 3;
  const float* u = coeffs;
  long long stride = 1;
  if (inner > 0) {
    u += (i / inner) * kp3 * inner + i % inner;
    stride = inner;
  }

  // softmax, floored at kMinStep, summed into the control points. c is
  // only ever indexed by unrolled constants, so it stays in registers:
  // every entry is written on every path (those past K+3 with values no
  // one reads), and the picks below keep the last j <= bins (bin), which
  // the compiler does not turn into an indexed load from local memory as
  // it does j == bins.
  float c[kMaxCoeffs];
  float top = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxCoeffs; ++j) {
    c[j] = j < kp3 ? u[j * stride] : -INFINITY;
    top = fmaxf(top, c[j]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxCoeffs; ++j) {
    c[j] = j < kp3 ? expf(c[j] - top) : 0.0f;
    sum += c[j];
  }
  const float spread = 1.0f - kp3 * kMinStep;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxCoeffs; ++j) {
    if (j < kp3) acc += kMinStep + spread * (c[j] / sum);
    c[j] = acc;
  }

  // the knot values; the bin by the normalized ones
  const float v0 = (c[0] + 4.0f * c[1] + c[2]) * kSixth;
  float vk = 0.0f;
#pragma unroll
  for (int j = 1; j <= kMaxBins; ++j) {
    if (j <= bins) vk = (c[j] + 4.0f * c[j + 1] + c[j + 2]) * kSixth;
  }
  const float inv_scale = 1.0f / (vk - v0);
  const float yc = fminf(fmaxf(y[i], 0.0f), 1.0f);
  int above = 0;
#pragma unroll
  for (int j = 0; j <= kMaxBins; ++j) {
    if (j <= bins) {
      const float vj = (c[j] + 4.0f * c[j + 1] + c[j + 2]) * kSixth;
      above += yc >= (vj - v0) * inv_scale;
    }
  }
  const int bin = min(max(above - 1, 0), bins - 1);
  Bin b{0.0f, 0.0f, 0.0f, 0.0f, v0, inv_scale};
#pragma unroll
  for (int j = 0; j < kMaxBins; ++j) {
    if (j <= bin) {
      b.c0 = c[j];
      b.c1 = c[j + 1];
      b.c2 = c[j + 2];
      b.c3 = c[j + 3];
    }
  }

  // bisection on [0, 1], then a Newton polish
  float lo = 0.0f, hi = 1.0f;
#pragma unroll 4
  for (int s = 0; s < kBisections; ++s) {
    const float mid = 0.5f * (lo + hi);
    const bool below = b.value(mid) < yc;
    lo = below ? mid : lo;
    hi = below ? hi : mid;
  }
  const float k = static_cast<float>(bins);
  float t = 0.5f * (lo + hi);
#pragma unroll
  for (int s = 0; s < kNewtonSteps; ++s) {
    const float step = (b.value(t) - yc) * k / fmaxf(b.slope(t, k), 1e-9f);
    t = fminf(fmaxf(t - step, 0.0f), 1.0f);
  }
  x[i] = (static_cast<float>(bin) + t) / k;
  logdet[i] = -logf(fmaxf(b.slope(t, k), 1e-12f));
}

}  // namespace

// x, logdet = the inverse of the monotone cubic B-spline with `bins` bins
// at y (n floats each, device pointers) and the log-det of that inverse;
// the coefficients as the note above says by `inner`. On `stream`. Returns
// the CUDA error of the launch (0 when it was taken).
extern "C" int bspline_inverse_f32(const float* y, const float* coeffs,
                                   float* x, float* logdet, long long n,
                                   int bins, long long inner, void* stream) {
  if (bins < 1 || bins > kMaxBins || inner < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long need = (n + kThreads - 1) / kThreads;
  if (need > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  bspline_inverse_kernel<<<static_cast<int>(need), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      y, coeffs, x, logdet, n, bins, inner);
  return static_cast<int>(cudaGetLastError());
}
