// The inverse of the monotone cubic B-spline bijection of [0, 1] and the
// log-det of that inverse, for Hopper (sm_90a), float32, with the affine
// maps and identity tails that the B-spline layers put around it.
//
// Replaces the JAX package's monotone_cubic_b_spline(..., inverse=True)
// (inverse_flow_tpu/layers/splines.py:227-253), the inverse of
// BSplineActivation, BSplineCoupling and ConditionalBSplineTransformer. It is
// not a Pallas kernel: it finds the bin, then runs 20 bisection steps and 5
// Newton steps in fori_loops that XLA fuses. Written as torch ops
// (ops/bspline.py:monotone_cubic_b_spline, the plain version), each step
// gathers the bin's control points and launches a few dozen elementwise
// kernels: about 1,430 launch calls a layer inverse.
//
// The coefficients are read where the caller keeps them (`inner`):
//   inner == 0: one set shared by every element (BSplineActivation, (K+3,));
//   inner >= 1: element i = (row, s) with s = i % inner, coefficient j at
//     (row * (K+3) + j) * inner + s: channel-major (B, C*(K+3), H, W) straight
//     from a coupling net at inner = H*W, the last dim (..., K+3) at
//     inner = 1.
//
// bspline_newton_{shared,channels,last}_kernel<B> (every call; B = 8 for
// up to 8 bins, else 16). What bounds the function is bytes:
// 12 an element (y, x, the log-det), plus 4 (K+3) of its own coefficients
// where it has its own. The first design (below) did about 1,100
// instructions an element instead, for three reasons, and this one removes
// each:
// - Every thread redid its set's softmax, cumsum and knots, also where one
//   set is shared by all. Here one warp of each block prepares a shared set
//   once (lanes 0..K-1, lane j the power form of bin j) into shared memory,
//   while the other threads' loads of y are in flight; every thread then
//   only picks its bin and finds its root. A block walks the elements with
//   a grid stride, the grid at most the blocks that are resident at once, so
//   that the preparation is paid once a block; each thread loads its next y
//   before it solves the current one. Where each element has its
//   own set, the thread prepares it with one reciprocal of the softmax's sum
//   (no division a coefficient) and builds the power form of its own bin
//   only.
// - The cubic was evaluated 26 times in its B-spline basis form, 25 FLOPs
//   each, 20 of them bisection steps that halve [0, 1] however close the
//   start. Here it is in power form, (f(t) - y) / (v_K - v_0) = b0 + a1 t +
//   a2 t^2 + a3 t^3 with b0 = vn_i - y, by Horner: 3 FMAs the value, 2 the
//   slope. Newton starts at the chord (y - vn_i) / (vn_{i+1} - vn_i) and
//   keeps a bracket [lo, hi] of the evaluated points (sentinels -1 and 2
//   until one side is evaluated, so that a step clamped to 0 or 1 is taken):
//   a step that is not strictly inside it, or that a slope <= 0 gives,
//   becomes the bracket's midpoint, so that a 2-cycle of Newton iterates
//   turns into halvings of the bracket. The quotient takes __frcp_rn of the
//   slope. Each lane stops on its own: at a residual of at most 2^-23 |b0|
//   (one to two ulp of b0, the size of the residual's own rounding at the
//   root), at a Newton step of at most 2^-23, at a bracket narrower than
//   2^-23, or at kMaxSteps. Over 1,000,000 y a draw, 5 and 8 bins, no lane
//   needs more than 5 steps at coefficients of std 0.5 (2.15 on average)
//   and 12 at std 3 (3.1), where some bins sit at min_step
//   (tests/test_torch_bspline_design.py emulates this in float32 torch).
// - The last-dim layout read each thread's K+3 floats 4 (K+3) bytes apart
//   from its neighbour's, 11-19 sectors a load instruction. Here the block
//   stages its contiguous blockDim.x * (K+3) floats into shared memory with
//   16-byte loads, rows at an odd pitch (no bank conflicts), and each thread
//   reads its row there.
//
// Precision. The softmax is float32 as in the plain version; its cumsum,
// the knot values w_j = 6 v_j = c_j + 4 c_{j+1} + c_{j+2} and the normalized
// vn_i are double, so b0 = (vn_i - y) is the float of a double difference
// (vn_i kept as two floats, hi + lo) and the power form's coefficients come
// from the steps themselves, not from differences of a float cumsum. On
// wide draws (std 3) the root is ill-conditioned, x moving by the
// residual's rounding over a slope of 1e-4: there the plain version's
// float32 cumsum puts its x up to 3e-4 from the float64 root, and this
// design lands closer in every draw so far, up to 80 times where each
// element has its own set (PERF.md section 6). The log-det takes the slope
// at the final t in the basis form (a sum of non-negative terms; the power
// form cancels where a bin is steep at one end and flat at the other):
// -log(max(K dvn/dt, 1e-12)).
//
// The layers' elementwise work is in the launch: y -> (y - lo) / (hi - lo),
// clipped to [0, 1]; x -> x * out_span + out_lo; with `tails`, the identity
// and a log-det of 0 wherever !(lo < y < hi); the log-det written only when
// the caller gives it somewhere to go. The two divisions of an element,
// by hi - lo and by K, are products with reciprocals taken once a launch
// (an ulp of u and of x). y may be a batch-strided view (a coupling's
// second half): element i at (i / y_row) * y_stride + i % y_row.
//
// bspline_inverse_first_kernel, the first design, kept as a forced variant
// for the timings: one thread an element redoes its set's softmax and knots
// in registers, picks its bin, then 20 bisection and 5 Newton steps on the
// cubic in its basis form, as the plain version does.
//
// Built without --use_fast_math.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 16;
constexpr int kMaxCoeffs = kMaxBins + 3;
// monotone_cubic_b_spline's min_step, the floor of each softmax step
constexpr float kMinStep = 1e-4f;
// the hard cap on a lane's Newton steps: the emulation needs at most 12,
// on wide draws (tests/test_torch_bspline_design.py)
constexpr int kMaxSteps = 16;
// a Newton step or a bracket this small, in t, ends a lane
constexpr float kStepTol = 0x1p-23f;
// a residual within this fraction of |b0| ends a lane
constexpr float kResTol = 0x1p-23f;

// ---------------------------------------------------------------------------
// bspline_newton_kernel
// ---------------------------------------------------------------------------

// The elementwise work of the layers around the spline, and where y is.
struct Args {
  const float* y;
  const float* coeffs;
  float* x;
  float* logdet;  // nullptr: not asked for
  int* steps;     // nullptr: not asked for; else each element's Newton steps
  long long n, inner, y_row, y_stride;
  int bins;
  float inv_bins;
  float lo, hi, inv_span;  // y -> (y - lo) / (hi - lo) on [0, 1]
  float out_lo, out_span;  // x -> x * out_span + out_lo
  int tails;               // the identity wherever !(lo < y < hi)
};

// One coefficient set of at most B bins, prepared: the floored softmax
// steps (float, as the plain version) and, in double, the knot values
// scaled by 6 and the reciprocal of their span. Indexed only by unrolled
// constants, so it stays in registers; the kernels are built for B = 8 and
// B = 16, so that the common sets (5 and 8 bins) unroll to 11 coefficients,
// not 19.
template <int B>
struct Set {
  float step[B + 3];
  double w[B + 1];
  double span, inv;  // w_K - w_0 and its reciprocal
};

// One bin's cubic in power form, in normalized output coordinates: vn_i as
// hi + lo, the basis form's slope weights e_j = d_j * 3 / (w_K - w_0) (d_j the
// bin's three steps; a1 = e1 + e2, a2 = e2 - e1, a3 = (e3 - 2 e2 + e1) / 3)
// and the reciprocal of the bin's span vn_{i+1} - vn_i.
struct Form {
  float a0_hi, a0_lo, e1, e2, e3, rspan;
};

template <int B>
__device__ __forceinline__ void prepare(const float* u, long long stride,
                                        int bins, Set<B>& s) {
  const int kp3 = bins + 3;
  float top = -INFINITY;
#pragma unroll
  for (int j = 0; j < B + 3; ++j) {
    s.step[j] = j < kp3 ? u[j * stride] : -INFINITY;
    top = fmaxf(top, s.step[j]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < B + 3; ++j) {
    s.step[j] = j < kp3 ? expf(s.step[j] - top) : 0.0f;
    sum += s.step[j];
  }
  const float inv_sum = 1.0f / sum;
  const float spread = 1.0f - kp3 * kMinStep;
  double c[B + 3];
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < B + 3; ++j) {
    s.step[j] = j < kp3 ? kMinStep + spread * (s.step[j] * inv_sum) : 0.0f;
    acc += static_cast<double>(s.step[j]);
    c[j] = acc;
  }
  double wk = 0.0;
#pragma unroll
  for (int j = 0; j <= B; ++j) {
    s.w[j] = c[j] + 4.0 * c[j + 1] + c[j + 2];
    if (j <= bins) wk = s.w[j];
  }
  // 1 / span: the float reciprocal and two Newton steps in double
  s.span = wk - s.w[0];
  double r = static_cast<double>(__frcp_rn(static_cast<float>(s.span)));
  r = r * (2.0 - s.span * r);
  s.inv = r * (2.0 - s.span * r);
}

// The power form of bin `bin` of a prepared set; picks by j <= bin, which
// keep the arrays in registers.
template <int B>
__device__ __forceinline__ Form bin_form(const Set<B>& s, int bin) {
  double wi = s.w[0], wi1 = s.w[1];
  float d1 = s.step[1], d2 = s.step[2], d3 = s.step[3];
#pragma unroll
  for (int j = 1; j < B; ++j) {
    if (j <= bin) {
      wi = s.w[j];
      wi1 = s.w[j + 1];
      d1 = s.step[j + 1];
      d2 = s.step[j + 2];
      d3 = s.step[j + 3];
    }
  }
  const double vn = (wi - s.w[0]) * s.inv;
  const double vn1 = (wi1 - s.w[0]) * s.inv;
  Form f;
  f.a0_hi = static_cast<float>(vn);
  f.a0_lo = static_cast<float>(vn - static_cast<double>(f.a0_hi));
  f.rspan = __frcp_rn(static_cast<float>(vn1 - vn));
  const float h = static_cast<float>(3.0 * s.inv);
  f.e1 = d1 * h;
  f.e2 = d2 * h;
  f.e3 = d3 * h;
  return f;
}

// The root t in [0, 1] of the bin's cubic at yc, by bracketed Newton from
// the chord (the note at the top); `steps` gets the steps taken.
__device__ __forceinline__ float solve(const Form& f, float yc, int& steps) {
  const float b0 = (f.a0_hi - yc) + f.a0_lo;
  const float a1 = f.e1 + f.e2;
  const float a2 = f.e2 - f.e1;
  const float a3 = ((f.e3 - f.e2) - (f.e2 - f.e1)) * (1.0f / 3.0f);
  const float tol = kResTol * fabsf(b0);
  float t = fminf(fmaxf(-b0 * f.rspan, 0.0f), 1.0f);
  float lo = -1.0f, hi = 2.0f;
  int n = 0;
  while (n < kMaxSteps) {
    float v = fmaf(a3, t, a2);
    float d = fmaf(a3, t, v);
    v = fmaf(v, t, a1);
    d = fmaf(d, t, v);
    const float r = fmaf(v, t, b0);
    if (fabsf(r) <= tol) break;
    if (r < 0.0f) {
      lo = t;
    } else {
      hi = t;
    }
    const bool newton = d > 0.0f;
    float tn = fminf(fmaxf(fmaf(-r, __frcp_rn(d), t), 0.0f), 1.0f);
    const bool small = newton && fabsf(tn - t) <= kStepTol;
    if (!small && !(newton && lo < tn && tn < hi)) {
      tn = 0.5f * (fmaxf(lo, 0.0f) + fminf(hi, 1.0f));
    }
    t = tn;
    ++n;
    if (small || hi - lo <= kStepTol) break;
  }
  steps = n;
  return t;
}

__device__ __forceinline__ float load_y(const Args& a, long long i) {
  if (a.y_row >= a.n) return a.y[i];
  return a.y[(i / a.y_row) * a.y_stride + i % a.y_row];
}

// yv mapped onto [0, 1]; false where the tails leave it as it is
__device__ __forceinline__ bool to_unit(const Args& a, float yv, float& yc) {
  yc = fminf(fmaxf((yv - a.lo) * a.inv_span, 0.0f), 1.0f);
  return !a.tails || (a.lo < yv && yv < a.hi);
}

__device__ __forceinline__ void write_identity(const Args& a, long long i,
                                               float yv) {
  a.x[i] = yv;
  if (a.logdet) a.logdet[i] = 0.0f;
  if (a.steps) a.steps[i] = 0;
}

// x and the log-det of element i from its bin's root t
__device__ __forceinline__ void finish(const Args& a, long long i,
                                       const Form& f, int bin, float t,
                                       int steps) {
  const float x01 = (static_cast<float>(bin) + t) * a.inv_bins;
  a.x[i] = __fadd_rn(__fmul_rn(x01, a.out_span), a.out_lo);
  if (a.logdet) {
    const float omt = 1.0f - t;
    const float slope =
        static_cast<float>(a.bins) *
        (f.e1 * (omt * omt) + f.e2 * fmaf(2.0f * t, omt, 1.0f) +
         f.e3 * (t * t));
    a.logdet[i] = -logf(fmaxf(slope, 1e-12f));
  }
  if (a.steps) a.steps[i] = steps;
}

// one set for every element: one warp prepares it into shared memory; each
// thread loads its next y before it solves the current one
template <int B>
__global__ void __launch_bounds__(kThreads)
bspline_newton_shared_kernel(Args a) {
  __shared__ float s_vn[B];
  __shared__ Form s_form[B];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float yv = i < a.n ? load_y(a, i) : 0.0f;
  if (threadIdx.x < a.bins) {
    Set<B> s;
    prepare(a.coeffs, 1, a.bins, s);
    const Form f = bin_form(s, threadIdx.x);
    s_form[threadIdx.x] = f;
    s_vn[threadIdx.x] = f.a0_hi;
  }
  __syncthreads();
  for (; i < a.n; i += stride) {
    const float y_next = i + stride < a.n ? load_y(a, i + stride) : 0.0f;
    float yc;
    if (to_unit(a, yv, yc)) {
      // the bin: how many of vn_1 .. vn_{K-1} are at most y
      int bin = 0;
#pragma unroll
      for (int j = 1; j < B; ++j) {
        if (j < a.bins) bin += yc >= s_vn[j];
      }
      const Form f = s_form[bin];
      int steps;
      const float t = solve(f, yc, steps);
      finish(a, i, f, bin, t, steps);
    } else {
      write_identity(a, i, yv);
    }
    yv = y_next;
  }
}

// each element's own set, prepared by its thread from u (stride `stride`)
template <int B>
__device__ __forceinline__ void own_set_element(const Args& a, long long i,
                                                float yv, const float* u,
                                                long long stride) {
  float yc;
  if (!to_unit(a, yv, yc)) {
    write_identity(a, i, yv);
    return;
  }
  Set<B> s;
  prepare(u, stride, a.bins, s);
  // the bin: how many of w_1 .. w_{K-1} are at most w_0 + y (w_K - w_0)
  const double yw = fma(static_cast<double>(yc), s.span, s.w[0]);
  int bin = 0;
#pragma unroll
  for (int j = 1; j < B; ++j) {
    if (j < a.bins) bin += s.w[j] <= yw;
  }
  const Form f = bin_form(s, bin);
  int steps;
  const float t = solve(f, yc, steps);
  finish(a, i, f, bin, t, steps);
}

// channel-major coefficients: coefficient j of element (row, s) at
// (row * (K+3) + j) * inner + s, read coalesced across s
template <int B>
__global__ void __launch_bounds__(kThreads)
bspline_newton_channels_kernel(Args a) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int kp3 = a.bins + 3;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < a.n; i += stride) {
    const long long row = i / a.inner, s = i - row * a.inner;
    own_set_element<B>(a, i, load_y(a, i),
                       a.coeffs + row * kp3 * a.inner + s, a.inner);
  }
}

// last-dim coefficients: the block stages its rows into shared memory with
// 16-byte loads, at an odd pitch
template <int B>
__global__ void __launch_bounds__(kThreads)
bspline_newton_last_kernel(Args a) {
  __shared__ float tile[kThreads * (B + 3)];
  const int kp3 = a.bins + 3;
  const int pitch = kp3 | 1;
  // f / kp3 for f < kThreads * (B + 3), by one multiply
  const unsigned magic = 0xFFFFFFFFu / kp3 + 1u;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < a.n; base += static_cast<long long>(gridDim.x) * kThreads) {
    const long long i = base + threadIdx.x;
    const float yv = i < a.n ? load_y(a, i) : 0.0f;
    const int rows = static_cast<int>(min(static_cast<long long>(kThreads),
                                          a.n - base));
    const int floats = rows * kp3;
    const float* src = a.coeffs + base * kp3;
    for (int q = threadIdx.x; q < floats / 4; q += kThreads) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const unsigned f = 4u * q + m;
        const unsigned r = __umulhi(f, magic);
        tile[r * pitch + (f - r * kp3)] = e[m];
      }
    }
    for (int f = (floats & ~3) + threadIdx.x; f < floats; f += kThreads) {
      const unsigned r = __umulhi(static_cast<unsigned>(f), magic);
      tile[r * pitch + (f - r * kp3)] = src[f];
    }
    __syncthreads();
    if (i < a.n) own_set_element<B>(a, i, yv, tile + threadIdx.x * pitch, 1);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// bspline_inverse_first_kernel, the first design
// ---------------------------------------------------------------------------

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
bspline_inverse_first_kernel(const float* __restrict__ y,
                             const float* __restrict__ coeffs,
                             float* __restrict__ x,
                             float* __restrict__ logdet, long long n,
                             int bins, long long inner) {
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

// Blocks of `kernel` resident at once on the current device, found once a
// process (every card of a process is the same part).
int resident_blocks(const void* kernel, int* cache) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    *cache = sms * per_sm;
  }
  return *cache;
}

// One launch of the layout's kernel (by inner: 0 shared, 1 last dim, else
// channel-major) for sets of at most B bins, the grid at most the blocks
// resident at once.
template <int B>
int launch(const Args& a, cudaStream_t s) {
  static int cache[3] = {0, 0, 0};
  const void* kernels[3] = {
      reinterpret_cast<const void*>(bspline_newton_shared_kernel<B>),
      reinterpret_cast<const void*>(bspline_newton_last_kernel<B>),
      reinterpret_cast<const void*>(bspline_newton_channels_kernel<B>)};
  const int which = a.inner == 0 ? 0 : a.inner == 1 ? 1 : 2;
  const int resident = resident_blocks(kernels[which], &cache[which]);
  if (resident == 0) return static_cast<int>(cudaGetLastError());
  const long long need = (a.n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(need < resident ? need : resident);
  if (which == 0) {
    bspline_newton_shared_kernel<B><<<grid, kThreads, 0, s>>>(a);
  } else if (which == 1) {
    bspline_newton_last_kernel<B><<<grid, kThreads, 0, s>>>(a);
  } else {
    bspline_newton_channels_kernel<B><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (and, where logdet is not null, the log-det) of the inverse of the
// monotone cubic B-spline with `bins` bins at the n elements of y, with the
// layers' maps and tails as the note above says (lo, hi, span = hi - lo,
// out_lo, out_span, tails; 0, 1, 1, 0, 1, 0 for the bare spline); where
// `steps` is not null, each element's Newton steps. Device pointers; the
// coefficients by `inner` as above, 16-byte aligned for the last dim
// (inner == 1); y element i at (i / y_row) * y_stride + i % y_row. On
// `stream`. Returns the CUDA error of the launch (0 when it was taken).
extern "C" int bspline_inverse_f32(const float* y, const float* coeffs,
                                   float* x, float* logdet, int* steps,
                                   long long n, int bins, long long inner,
                                   long long y_row, long long y_stride,
                                   float lo, float hi, float span,
                                   float out_lo, float out_span, int tails,
                                   void* stream) {
  if (bins < 1 || bins > kMaxBins || inner < 0 || y_row < 1 ||
      (inner == 1 && reinterpret_cast<unsigned long long>(coeffs) % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Args a{y,        coeffs, x,    logdet,      steps,
               n,        inner,  y_row, y_stride,   bins,
               1.0f / bins, lo, hi,    1.0f / span, out_lo,
               out_span, tails};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bins <= 8) return launch<8>(a, s);
  return launch<kMaxBins>(a, s);
}

// The first design (bspline_inverse_first_kernel): x, logdet = the inverse
// at y with the bare spline's arguments, on `stream`.
extern "C" int bspline_inverse_first_f32(const float* y, const float* coeffs,
                                         float* x, float* logdet, long long n,
                                         int bins, long long inner,
                                         void* stream) {
  if (bins < 1 || bins > kMaxBins || inner < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long need = (n + kThreads - 1) / kThreads;
  if (need > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  bspline_inverse_first_kernel<<<static_cast<int>(need), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      y, coeffs, x, logdet, n, bins, inner);
  return static_cast<int>(cudaGetLastError());
}
