// Whole-flow NSF/MAF kernels for Hopper (sm_90a).
//
// nsf_density replaces the TPU kernel zuko_tpu/ops/nsf_fused.py::_fused_impl
// (pallas_call at :1842; math _full_math_T :1268): log_prob of an
// autoregressive flow, every MADE hyper pass, every univariate forward and
// its log-Jacobian, the softclips between the layers, plus the base term
// (standard normal, or a constant box), in one launch.
//
// nsf_sample replaces zuko_tpu/ops/nsf_fused.py::_sample_core (pallas_call at
// :1658; math _sample_math_T :1348): the whole autoregressive inversion,
// layers in reverse, min(passes, F) Jacobi sweeps per layer (each sweep
// evaluates the hyper-net on the whole current iterate, then inverts every
// feature: in closed form for the affine map and the splines, by bisection
// and Newton steps for the polynomials), and with kLogQ the log-density of the returned
// point, base(z) + the forward ladj of every layer at its solved x. In its
// raw mode (kRawLadj) the sum starts at zero instead of base(z): the bare
// sum of forward ladjs at the solved point, which is what the density of an
// inverted flow is made of. The base term never enters the sum, so nothing
// is subtracted afterwards.
//
// nsf_apply replaces zuko_tpu/ops/nsf_fused.py::_apply_impl (pallas_call at
// :2183; kernel body _apply_kernel_T :2052): the forward map T(x) of the
// whole flow and the bare sum of its log-Jacobians, no base term. It is the
// density kernel's body (one template, kRaw) with another epilogue: each row
// writes its F transformed values and its summed ladj, 4 * F more output
// bytes a row than the density. An inverted flow samples through it.
//
// What bounds them on an H100: arithmetic. Per row and layer the hyper-net
// costs 2 * sum(d_in * d_out) flops (about 26.6K for the flagship D=6,
// 64x64 MADE, K=8), against 4 * (F + C) bytes in and 4 bytes out per row,
// so at 1M rows the density does ~80 GFLOP against ~28 MB: compute-bound on
// the fp32 pipes (no tensor cores: float32 throughout, no TF32). Sampling
// repeats the hyper-net min(passes, F) times per layer. nsf_apply does the
// density's operations and stays bound by them.
//
// The per-thread design (the first one; since redesigned for the closed-form
// family, the circular spline and the smaller polynomials, below):
// one thread per batch row, blocks of 128
// rows. Each block stages one AR layer's pre-masked weights and biases into
// dynamic shared memory (about 53 KB for the flagship), so every weight is
// read from device memory once per block and layer, and a warp's 32 threads
// read the same weight at the same time (a shared-memory broadcast). The
// hidden activations live in per-thread local memory. For each feature the
// thread computes only that feature's T parameters of the last linear
// (T = 3K - 1 for the spline, 2 for the affine) and evaluates the
// univariate at once, so the F * T outputs never exist together.
//
// Two tiers, chosen by the wrapper from the flow's shape alone
// (zuko_tpu_torch/ops/nsf_fused.py plan_nsf). The narrow tier (kWide false)
// is the design above, within its limits: widths of kMaxWidth, kMaxBins
// bins, kMaxLinear linears, kMaxLayers layers, and one layer's weights in a
// block's shared memory (227 KB on an H100); but the sampler of the
// closed-form family (affine and RQS), of the circular spline and of a
// polynomial of at most kPolyRegs coefficients (the Bernstein polynomial's
// M + 5, the sum of squares' P (L + 1) at kSospNodes nodes or fewer), all
// three modes, is the tiled nsf_sample_tiled (below), and the density and
// apply of the same univariates the tiled nsf_density_tiled, within the
// same limits where their tile fits (a larger polynomial samples, and takes
// its density and apply, through the per-thread nsf_sample_kernel and
// nsf_density_kernel). The wide tier takes any shape:
// the weights are read through the read-only data cache (__ldg), one address
// per warp at a time, as the NAF kernels read theirs; a row's activations,
// raw parameters and knots live in a workspace in device memory, one column
// of `stride` rows per value (slot), so neighbouring threads touch
// neighbouring addresses as in local memory; the widths and passes lie in a
// small device buffer. The wrapper allocates both; the rows run in chunks of
// `stride`, one launch each, so the workspace stays bounded.
//
// The univariates (Univariate, one per flow): the affine map (MAF), the
// rational-quadratic spline (NSF), the circular spline (NCSF: the spline on
// [-pi, pi] after the shift x -> (x mod 2 pi) - pi, the sampler's root
// shifted back), the sum-of-squares polynomial (SOSPF: the mean of P squared
// polynomials of degree L in x / B plus the minimum slope, integrated from 0
// by the L + 1 Gauss-Legendre nodes and weights the wrapper hands in, plus a
// shift) and the bounds-pinned Bernstein polynomial (BPF: M + 5 increasing
// coefficients from the softmax of the M raw ones, De Casteljau's lerps for
// the value and, on the coefficients' differences, for the derivative; the
// line of slope 1 through the bounds outside them). The polynomials have no
// closed-form inverse: the sampler bisects [-B, B] ceil(log2(2B / 1e-3))
// times in a layer's first sweep, and in the later ones ceil(log2(2 * 0.0625
// / 1e-3)) = 7 times from a bracket of radius 0.0625 around the previous
// sweep's root (the full bracket for a row where two evaluations say it does
// not hold the root), then takes 4 Newton steps with the forward's own
// derivative, each clipped to [-B, B]; a Bernstein target beyond the ends
// takes the closed form of the line (zuko_tpu/ops/nsf_fused.py
// _poly_inverse_F :849). A feature's coefficients (the Bernstein softmax and
// cumsum) are made once a sweep, before its solve, not at every evaluation.
// The kernels are instantiated per family of univariates (Family): the
// closed-form ones (affine, spline) over the standard normal, the circular
// spline over its box, the polynomials over the standard normal; so the
// affine and spline kernels carry neither the shift's fmodf nor the
// polynomials' state. The NSF kernels' speed is sensitive to what else the
// sampler's body holds (measured on an H100 with chip_ab.py, a tree without
// the new modes against this file): the spline's knots stay in arrays of the
// call that uses them, and the softclip's inverse is a call, not inlined.
//
// Each C entry point checks its arguments, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include <string.h>

#include <type_traits>
#include <vector>

#include "rqs.cuh"

namespace {

// the narrow tier's limits, mirrored in zuko_tpu_torch/ops/nsf_fused.py
constexpr int kMaxWidth = 256;  // widest hyper layer, F + C inputs included
constexpr int kMaxBins = 32;
constexpr int kMaxT = 3 * kMaxBins - 1;  // a feature's raw parameters
constexpr int kMaxTheta = 64;            // Bernstein coefficients, M + 5
constexpr int kPolyRegs = 24;            // a polynomial's coefficients in the tiled sampler
constexpr int kSospNodes = 8;            // and the sum of squares' nodes there, L + 1
constexpr int kMaxNodes = 32;            // Gauss-Legendre nodes, L + 1
constexpr int kMaxLinear = 8;
constexpr int kMaxLayers = 64;
constexpr int kThreads = 128;
constexpr int kMaxShared = 232448;  // a block's shared memory on an H100 (227 KB)
constexpr float kHalfLog2Pi = 0.91893853320467274f;
// the polynomial inverse (zuko_tpu/ops/nsf_fused.py _POLY_WARM_R :987)
constexpr float kWarmR = 0.0625f;
constexpr int kNewton = 4;
constexpr float kBernsteinEps = 1e-6f;

enum Univariate { kAffine = 0, kRQS = 1, kCRQS = 2, kSOSP = 3, kBernstein = 4 };

// The kernels' instantiations: the closed-form univariates (affine, RQS), the
// circular spline (its base the box), the polynomials (SOSP, Bernstein).
enum Family { kClosed = 0, kCircular = 1, kPolynomial = 2 };

constexpr int family_of(int univ) {
  return univ == kCRQS ? kCircular : (univ == kSOSP || univ == kBernstein) ? kPolynomial : kClosed;
}

// The narrow tier's description of the flow, by value.
struct Shape {
  int n_lin;         // linears per hyper-net
  int n_ar;          // autoregressive layers
  int F, C, K, T;    // features, context, bins (SOSP: polynomials; Bernstein: M), parameters
  int K2;            // SOSP: Gauss-Legendre nodes, L + 1
  int kn;            // floats of each of a feature's three knot/coefficient arrays
  int univ;          // Univariate
  int layer_floats;  // floats of one layer's packed [W0, b0, W1, b1, ...]
  int last_off;      // offset of the last linear's weights in a layer
  float bound, log_s, slope;
  int box;           // base: 0 standard normal, 1 the box [lo, hi]^F
  float lo, hi, log_box;
  int n_cold, n_warm;  // the polynomial solve's bisection steps
  int w_max;         // widest hyper layer but the last
  int widths[kMaxLinear + 1];
  int passes[kMaxLayers];
  float clips[kMaxLayers];  // softclip bound after each layer, 0 for none
  float nodes[kMaxNodes], weights[kMaxNodes];
};

// The wide tier's: the same fields, the arrays in the device buffer `desc`.
struct WideShape {
  int n_lin, n_ar, F, C, K, T, K2, kn, univ;
  long long layer_floats;
  int last_off;
  float bound, log_s, slope;
  int box;
  float lo, hi, log_box;
  int n_cold, n_warm;
  int w_max;
  const int* widths;
  const int* passes;
  const float* clips;
  const float* nodes;
  const float* weights;
};

template <bool kWide>
using ShapeOf = typename std::conditional<kWide, WideShape, Shape>::type;

// A slot column of the wide tier's workspace: one of a row's arrays,
// `stride` floats between consecutive elements.
struct Column {
  float* p;
  long long stride;
  __device__ __forceinline__ float& operator[](int i) const { return p[i * stride]; }
};

// What indexes one of a row's arrays: a pointer into a per-thread array
// (narrow) or a workspace column (wide).
template <bool kWide>
using Vec = typename std::conditional<kWide, Column, float*>::type;

// The wide tier's state of a row: xcv = [x, c], the current iterate (or
// input) with its context; the sampler's target y; the hyper-net's
// activations; one feature's raw parameters and its three knot (or
// coefficient) arrays; as columns of the workspace from column i on, in this
// order (the slots mirrored in nsf_fused.py plan_nsf): F + C, F, 2 w_max, T
// and 3 kn. The narrow tier keeps the same arrays in the thread (local
// memory).
struct WideRow {
  Column xcv, y, a, b, p, xs, ys, ds;
  __device__ __forceinline__ void init(const WideShape& s, float* work, long long stride,
                                       long long i) {
    float* q = work + i;
    const long long widths[8] = {s.F + s.C, s.F, s.w_max, s.w_max, s.T, s.kn, s.kn, s.kn};
    Column* cs[8] = {&xcv, &y, &a, &b, &p, &xs, &ys, &ds};
    for (int k = 0; k < 8; ++k) {
      *cs[k] = {q, stride};
      q += widths[k] * stride;
    }
  }
};

// One of a row's arrays in the tier: the workspace column or the local array.
template <bool kWide>
__device__ __forceinline__ Vec<kWide> pick(const Column& column, float* local) {
  if constexpr (kWide) {
    return column;
  } else {
    return local;
  }
}

// A feature's three knot arrays: the spline's xs, ys, ds; the Bernstein
// polynomial's coefficients, their differences times the order, and the De
// Casteljau scratch.
template <bool kWide>
struct Knots {
  Vec<kWide> xs, ys, ds;
};

// A weight: from shared memory (narrow) or through the read-only cache (wide).
template <bool kWide>
__device__ __forceinline__ float ldw(const float* p) {
  if constexpr (kWide) {
    return __ldg(p);
  } else {
    return *p;
  }
}

__device__ __forceinline__ void stage_layer(float* smem, const float* __restrict__ params,
                                            const Shape& s, int layer) {
  const float* src = params + (size_t)layer * s.layer_floats;
  for (int i = threadIdx.x; i < s.layer_floats; i += blockDim.x) smem[i] = src[i];
}

// The hidden ReLU layers, from a[0 .. widths[0]) on; returns the array that
// holds the last hidden activations (a or b).
template <bool kWide, class Sh>
__device__ __forceinline__ Vec<kWide> hidden_layers(const float* w, const Sh& s, Vec<kWide> a,
                                                    Vec<kWide> b) {
  Vec<kWide> cur = a, nxt = b;
  for (int i = 0; i < s.n_lin - 1; ++i) {
    const int din = s.widths[i], dout = s.widths[i + 1];
    const float* bias = w + dout * din;
    for (int o = 0; o < dout; ++o) {
      const float* row = w + o * din;
      float acc = ldw<kWide>(bias + o);
      for (int j = 0; j < din; ++j) acc = fmaf(ldw<kWide>(row + j), cur[j], acc);
      nxt[o] = fmaxf(acc, 0.0f);
    }
    w = bias + dout;
    const Vec<kWide> t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Feature f's T raw parameters: rows f*T .. f*T + T - 1 of the last linear.
template <bool kWide, class Sh>
__device__ __forceinline__ void feature_params(const float* w, const Sh& s, const Vec<kWide> h,
                                               int f, const Vec<kWide> p) {
  const int din = s.widths[s.n_lin - 1], dout = s.widths[s.n_lin];
  const float* bias = w + dout * din;
  for (int t = 0; t < s.T; ++t) {
    const int o = f * s.T + t;
    const float* row = w + o * din;
    float acc = ldw<kWide>(bias + o);
    for (int j = 0; j < din; ++j) acc = fmaf(ldw<kWide>(row + j), h[j], acc);
    p[t] = acc;
  }
}

// Raw (widths, heights, derivatives) -> K + 1 knots: slope clamp, softmax,
// cumsum (zuko_tpu/transforms.py MonotonicRQSTransform).
template <class V, class Knots, class Sh>
__device__ __forceinline__ void rqs_knots(V p, const Sh& s, Knots xs, Knots ys, Knots ds) {
  const int K = s.K;
  const float B = s.bound, ls = s.log_s;
  float mw = -INFINITY, mh = -INFINITY;
  for (int j = 0; j < K; ++j) {
    float w = p[j], h = p[K + j];
    w = w / (1.0f + fabsf(2.0f * w / ls));
    h = h / (1.0f + fabsf(2.0f * h / ls));
    p[j] = w;
    p[K + j] = h;
    mw = fmaxf(mw, w);
    mh = fmaxf(mh, h);
  }
  float sw = 0.0f, sh = 0.0f;
  for (int j = 0; j < K; ++j) {
    p[j] = expf(p[j] - mw);
    p[K + j] = expf(p[K + j] - mh);
    sw += p[j];
    sh += p[K + j];
  }
  float cw = 0.0f, ch = 0.0f;
  xs[0] = -B;
  ys[0] = -B;
  for (int j = 0; j < K; ++j) {
    cw += p[j] / sw;
    ch += p[K + j] / sh;
    xs[j + 1] = B * (2.0f * cw - 1.0f);
    ys[j + 1] = B * (2.0f * ch - 1.0f);
  }
  ds[0] = 1.0f;
  ds[K] = 1.0f;
  for (int j = 0; j < K - 1; ++j) {
    const float d = p[2 * K + j];
    ds[j + 1] = expf(d / (1.0f + fabsf(d / ls)));
  }
}

template <class V>
__device__ __forceinline__ float affine_log_scale(const V& p, float ls) {
  return p[1] / (1.0f + fabsf(p[1] / ls));
}

// (x mod 2B) - B: the circular shift, its own inverse on the circle.
__device__ __forceinline__ float circular_wrap(float x, float B) {
  float r = fmodf(x, 2.0f * B);
  if (r < 0.0f) r += 2.0f * B;
  return r - B;
}

// Spline (kCircular: after the shift) or affine forward of one feature from
// its raw parameters p (overwritten); the knots in the row's columns k
// (wide) or in arrays of the call (narrow: the compiler sees that they
// alias nothing, which the NSF sampler's speed depends on).
template <bool kWide, bool kCircular, class Sh>
__device__ __forceinline__ float closed_forward(float x, Vec<kWide> p, const Sh& s,
                                                const Knots<kWide>& k, float* ladj) {
  if (!kCircular && s.univ == kAffine) {
    const float lsc = affine_log_scale(p, s.log_s);
    *ladj = lsc;
    return x * expf(lsc) + p[0];
  }
  if (kCircular) x = circular_wrap(x, s.bound);
  if constexpr (kWide) {
    rqs_knots(p, s, k.xs, k.ys, k.ds);
    return rqs::forward(x, k.xs, k.ys, k.ds, s.K, ladj);
  } else {
    float xs[kMaxBins + 1], ys[kMaxBins + 1], ds[kMaxBins + 1];
    rqs_knots(p, s, xs, ys, ds);
    return rqs::forward(x, xs, ys, ds, s.K, ladj);
  }
}

template <bool kWide, bool kCircular, class Sh>
__device__ __forceinline__ float closed_inverse(float y, Vec<kWide> p, const Sh& s,
                                                const Knots<kWide>& k) {
  if (!kCircular && s.univ == kAffine) {
    return (y - p[0]) / expf(affine_log_scale(p, s.log_s));
  }
  float x;
  if constexpr (kWide) {
    rqs_knots(p, s, k.xs, k.ys, k.ds);
    x = rqs::inverse<false>(y, k.xs, k.ys, k.ds, s.K, nullptr);
  } else {
    float xs[kMaxBins + 1], ys[kMaxBins + 1], ds[kMaxBins + 1];
    rqs_knots(p, s, xs, ys, ds);
    x = rqs::inverse<false>(y, xs, ys, ds, s.K, nullptr);
  }
  return kCircular ? circular_wrap(x, s.bound) : x;
}

// The Bernstein coefficients of one feature from its M raw parameters p
// (overwritten by their exponentials): k.xs = theta (M + 5, increasing from
// -B to B), k.ys = order * (theta_{i+1} - theta_i) (M + 4), taken from the
// steps themselves, which are positive, rather than from differences of
// theta (zuko_tpu/ops/nsf_fused.py _bernstein_forward_F :764).
template <bool kWide, class Sh>
__device__ __forceinline__ void bernstein_coefficients(Vec<kWide> p, const Sh& s,
                                                       const Knots<kWide>& k) {
  const int M = s.K;
  const float B = s.bound, d = (2.0f * B) / (M + 4), scale = 2.0f * B - 4.0f * d;
  const float order = (float)(M + 4);
  float mx = -INFINITY;
  for (int j = 0; j < M; ++j) mx = fmaxf(mx, p[j]);
  float sum = 0.0f;
  for (int j = 0; j < M; ++j) {
    p[j] = expf(p[j] - mx);
    sum += p[j];
  }
  const float inv = 1.0f / sum;
  k.xs[0] = -B;
  k.xs[1] = -B + d;
  k.xs[2] = -B + 2.0f * d;
  k.ys[0] = order * d;
  k.ys[1] = order * d;
  float run = 0.0f;
  for (int j = 0; j < M; ++j) {
    const float sm = p[j] * inv;
    run += sm;
    k.xs[3 + j] = (-B + 2.0f * d) + scale * run;
    k.ys[2 + j] = order * scale * sm;
  }
  k.xs[M + 3] = B - d;
  k.xs[M + 4] = B;
  k.ys[M + 2] = order * d;
  k.ys[M + 3] = order * d;
}

// De Casteljau: the Bezier sum of c[0 .. n) at u, lerps in the scratch sc.
template <class V>
__device__ __forceinline__ float decasteljau(const V& c, int n, float u, const V& sc) {
  for (int i = 0; i < n; ++i) sc[i] = c[i];
  for (int m = n - 1; m > 0; --m) {
    for (int i = 0; i < m; ++i) sc[i] = fmaf(u, sc[i + 1] - sc[i], sc[i]);
  }
  return sc[0];
}

// The sum-of-squares integrand g(v) = mean_k (1 + p_k(v / B))^2 + slope,
// p_k's L + 1 coefficients at p[k (L + 1) ...], by Horner's rule.
template <class V, class Sh>
__device__ __forceinline__ float sosp_integrand(float v, const V& p, const Sh& s) {
  const int P = s.K, L1 = s.K2;
  const float u = v / s.bound;
  float acc = 0.0f;
  for (int k = 0; k < P; ++k) {
    float q = p[k * L1 + L1 - 1];
    for (int l = L1 - 2; l >= 0; --l) q = fmaf(q, u, p[k * L1 + l]);
    q += 1.0f;
    acc = fmaf(q, q, acc);
  }
  return acc / P + s.slope;
}

// A polynomial univariate at x, its coefficients made (poly_prepare): the
// value and, with kGrad, the derivative dy/dx in *dydx.
template <bool kGrad, bool kWide, class Sh>
__device__ __forceinline__ float poly_eval(float x, const Vec<kWide>& p, const Sh& s,
                                           const Knots<kWide>& k, float* dydx) {
  if (s.univ == kSOSP) {
    const int L1 = s.K2;
    float quad = 0.0f;
    for (int t = 0; t < L1; ++t) {
      quad = fmaf(s.weights[t], sosp_integrand(x * (0.5f * (s.nodes[t] + 1.0f)), p, s), quad);
    }
    if (kGrad) *dydx = sosp_integrand(x, p, s);
    return 0.5f * x * quad + p[s.K * L1];
  }
  const float B = s.bound, u = (x + B) / (2.0f * B);
  if (u <= kBernsteinEps) {
    if (kGrad) *dydx = 1.0f;
    return 2.0f * B * (u - kBernsteinEps) - B;
  }
  if (u >= 1.0f - kBernsteinEps) {
    if (kGrad) *dydx = 1.0f;
    return 2.0f * B * (u - 1.0f + kBernsteinEps) + B;
  }
  const int N = s.K + 5;
  if (kGrad) *dydx = decasteljau(k.ys, N - 1, u, k.ds) / (2.0f * B);
  return decasteljau(k.xs, N, u, k.ds);
}

// Once a feature and sweep: what the polynomial's evaluations share.
template <bool kWide, class Sh>
__device__ __forceinline__ void poly_prepare(Vec<kWide> p, const Sh& s, const Knots<kWide>& k) {
  if (s.univ == kBernstein) bernstein_coefficients<kWide>(p, s, k);
}

// Solve a monotone polynomial univariate for y: a cold bisection of s.n_cold
// steps over [-B, B], or, after the first sweep, the bracket of kWarmR about
// the previous sweep's root x0 where it holds y and s.n_warm steps, then
// kNewton clipped Newton steps; with ends, the Bernstein polynomial's linear
// ends. eval(std::bool_constant<kGrad>{}, x, dydx) is the value at x and,
// with kGrad, dy/dx in *dydx. Every evaluator runs this one arithmetic.
template <class Eval, class Sh>
__device__ __forceinline__ float poly_solve(const Eval& eval, const Sh& s, bool ends, float y,
                                            float x0, int sweep) {
  const std::false_type value{};
  const std::true_type grad{};
  const float B = s.bound;
  float lo = -B, hi = B;
  int iters = s.n_cold;
  if (sweep > 0) {
    const float lo0 = fminf(fmaxf(x0 - kWarmR, -B), B), hi0 = fminf(fmaxf(x0 + kWarmR, -B), B);
    if (eval(value, lo0, nullptr) < y && y < eval(value, hi0, nullptr)) {
      lo = lo0;
      hi = hi0;
    }
    iters = s.n_warm;
  }
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (eval(value, mid, nullptr) < y) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  float x = 0.5f * (lo + hi);
  for (int it = 0; it < kNewton; ++it) {
    float g;
    const float v = eval(grad, x, &g);
    x = fminf(fmaxf(x - (v - y) / g, -B), B);
  }
  if (ends) {
    float g;
    const float f_hi = eval(grad, B, &g);
    if (y > f_hi) x = B + (y - f_hi) / g;
    const float f_lo = eval(grad, -B, &g);
    if (y < f_lo) x = -B + (y - f_lo) / g;
  }
  return x;
}

// Solve the prepared polynomial for y; x0 is the previous sweep's root
// (sweep > 0).
template <bool kWide, class Sh>
__device__ __forceinline__ float poly_inverse(float y, float x0, int sweep, const Vec<kWide>& p,
                                              const Sh& s, const Knots<kWide>& k) {
  const auto eval = [&](auto kGrad, float x, float* dydx) {
    return poly_eval<decltype(kGrad)::value, kWide>(x, p, s, k, dydx);
  };
  return poly_solve(eval, s, s.univ == kBernstein, y, x0, sweep);
}

// Univariate forward of one feature from its raw parameters p (overwritten);
// *ladj its log-Jacobian.
template <bool kWide, int kFam, class Sh>
__device__ __forceinline__ float univ_forward(float x, Vec<kWide> p, const Sh& s,
                                              const Knots<kWide>& k, float* ladj) {
  if constexpr (kFam == kPolynomial) {
    poly_prepare<kWide>(p, s, k);
    float g;
    const float y = poly_eval<true, kWide>(x, p, s, k, &g);
    *ladj = logf(g);
    return y;
  } else {
    return closed_forward<kWide, kFam == kCircular>(x, p, s, k, ladj);
  }
}

// A softclip x / (1 + |x / B|) in place, its log-Jacobian -2 log1p(|x / B|)
// added to *acc.
template <class V>
__device__ __forceinline__ void softclip(const V& x, int F, float B, float* acc) {
  for (int f = 0; f < F; ++f) {
    const float q = fabsf(x[f] / B);
    *acc -= 2.0f * log1pf(q);
    x[f] = x[f] / (1.0f + q);
  }
}

// The softclip's closed-form inverse y / (1 - |y / B|) in place, and with
// `ladj` its forward log-Jacobian at the result added to *acc. Not inlined:
// inlined into the sampler's body it cost the NSF sampler with log q 17%
// (227 against 193 ms at 1M rows), though no NSF has a softclip.
template <bool kWide>
__device__ __noinline__ void softclip_inverse(Vec<kWide> y, int F, float B, bool ladj,
                                              float* acc) {
  for (int f = 0; f < F; ++f) {
    const float x = y[f] / (1.0f - fabsf(y[f] / B));
    if (ladj) *acc -= 2.0f * log1pf(fabsf(x / B));
    y[f] = x;
  }
}

// The base's log-density of the F values of v: the box (kBox) or the
// standard normal.
template <bool kBox, class V, class Sh>
__device__ __forceinline__ float base_log_prob(const V& v, const Sh& s) {
  if (kBox) {
    bool inside = true;
    for (int f = 0; f < s.F; ++f) inside = inside && v[f] >= s.lo && v[f] <= s.hi;
    return inside ? -s.F * s.log_box : -INFINITY;
  }
  float sq = 0.0f;
  for (int f = 0; f < s.F; ++f) sq = fmaf(v[f], v[f], sq);
  return -0.5f * sq - s.F * kHalfLog2Pi;
}

// kRaw false: out[row] = log_prob. kRaw true (nsf_apply): y[row, :] = T(x)
// and out[row] = the bare sum of ladjs. Rows [row0, row_end) of the launch;
// thread i takes row row0 + i, and in the wide tier workspace column i.
template <bool kWide, bool kRaw, int kFam>
__global__ void __launch_bounds__(kThreads)
nsf_density_kernel(const float* __restrict__ xc, float* __restrict__ y,
                   float* __restrict__ out, const float* __restrict__ params,
                   const __grid_constant__ ShapeOf<kWide> s, float* __restrict__ work,
                   long long stride, long long row0, long long row_end) {
  extern __shared__ float smem[];
  // the polynomials' coefficients (the splines keep their knots in the call)
  constexpr int kKnots = kFam == kPolynomial ? kMaxTheta : 1;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = row0 + i;
  const bool active = row < row_end;
  if (kWide && !active) return;  // the wide tier has no barriers
  const int D0 = s.F + s.C;
  float xcv_l[kWide ? 1 : kMaxWidth], a_l[kWide ? 1 : kMaxWidth], b_l[kWide ? 1 : kMaxWidth];
  float p_l[kWide ? 1 : kMaxT];
  float xs_l[kWide ? 1 : kKnots], ys_l[kWide ? 1 : kKnots], ds_l[kWide ? 1 : kKnots];
  WideRow wr;
  if constexpr (kWide) wr.init(s, work, stride, i);
  const Vec<kWide> xcv = pick<kWide>(wr.xcv, xcv_l), a = pick<kWide>(wr.a, a_l),
                   b = pick<kWide>(wr.b, b_l), p = pick<kWide>(wr.p, p_l);
  const Knots<kWide> k{pick<kWide>(wr.xs, xs_l), pick<kWide>(wr.ys, ys_l),
                       pick<kWide>(wr.ds, ds_l)};
  if (active) {
    for (int j = 0; j < D0; ++j) xcv[j] = xc[row * D0 + j];
  }
  float acc = 0.0f;
  for (int l = 0; l < s.n_ar; ++l) {
    const float* w = kWide ? params + (size_t)l * s.layer_floats : smem;
    if constexpr (!kWide) {
      __syncthreads();  // every thread is done with the previous layer
      stage_layer(smem, params, s, l);
      __syncthreads();
      if (!active) continue;
    }
    for (int j = 0; j < D0; ++j) a[j] = xcv[j];
    const Vec<kWide> h = hidden_layers<kWide>(w, s, a, b);
    // the hidden activations already hold x, so x updates in place
    for (int f = 0; f < s.F; ++f) {
      feature_params<kWide>(w + s.last_off, s, h, f, p);
      float ladj;
      xcv[f] = univ_forward<kWide, kFam>(xcv[f], p, s, k, &ladj);
      acc += ladj;
    }
    if (s.clips[l] > 0.0f) softclip(xcv, s.F, s.clips[l], &acc);
  }
  if (!active) return;
  if (kRaw) {
    for (int f = 0; f < s.F; ++f) y[row * s.F + f] = xcv[f];
    out[row] = acc;
  } else {
    out[row] = acc + base_log_prob<kFam == kCircular>(xcv, s);
  }
}

// What the sampling kernel sums beside the solve: nothing, log q (base(z) +
// the forward ladjs), or the bare forward ladjs.
enum SampleMode { kNoLadj = 0, kLogQ = 1, kRawLadj = 2 };

template <bool kWide, int kMode, int kFam>
__global__ void __launch_bounds__(kThreads)
nsf_sample_kernel(const float* __restrict__ zc, float* __restrict__ xout,
                  float* __restrict__ logq, const float* __restrict__ params,
                  const __grid_constant__ ShapeOf<kWide> s, float* __restrict__ work,
                  long long stride, long long row0, long long row_end) {
  extern __shared__ float smem[];
  // the polynomials' coefficients (the splines keep their knots in the call)
  constexpr int kKnots = kFam == kPolynomial ? kMaxTheta : 1;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = row0 + i;
  const bool active = row < row_end;
  if (kWide && !active) return;
  const int D0 = s.F + s.C;
  // xcv = [x, c] is the current iterate with its context; y the target
  float xcv_l[kWide ? 1 : kMaxWidth], y_l[kWide ? 1 : kMaxWidth], a_l[kWide ? 1 : kMaxWidth];
  float b_l[kWide ? 1 : kMaxWidth], p_l[kWide ? 1 : kMaxT];
  float xs_l[kWide ? 1 : kKnots], ys_l[kWide ? 1 : kKnots], ds_l[kWide ? 1 : kKnots];
  WideRow wr;
  if constexpr (kWide) wr.init(s, work, stride, i);
  const Vec<kWide> xcv = pick<kWide>(wr.xcv, xcv_l), y = pick<kWide>(wr.y, y_l),
                   a = pick<kWide>(wr.a, a_l), b = pick<kWide>(wr.b, b_l),
                   p = pick<kWide>(wr.p, p_l);
  const Knots<kWide> k{pick<kWide>(wr.xs, xs_l), pick<kWide>(wr.ys, ys_l),
                       pick<kWide>(wr.ds, ds_l)};
  float acc = 0.0f;
  if (active) {
    for (int j = 0; j < s.F; ++j) y[j] = zc[row * D0 + j];
    for (int j = s.F; j < D0; ++j) xcv[j] = zc[row * D0 + j];
    if (kMode == kLogQ) acc = base_log_prob<kFam == kCircular>(y, s);
  }
  for (int l = s.n_ar - 1; l >= 0; --l) {
    const float* w = kWide ? params + (size_t)l * s.layer_floats : smem;
    if constexpr (!kWide) {
      __syncthreads();
      stage_layer(smem, params, s, l);
      __syncthreads();
      if (!active) continue;
    }
    const float B = s.clips[l];
    if (B > 0.0f) softclip_inverse<kWide>(y, s.F, B, kMode != kNoLadj, &acc);
    for (int f = 0; f < s.F; ++f) xcv[f] = 0.0f;
    const int sweeps = min(s.passes[l], s.F);
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      for (int j = 0; j < D0; ++j) a[j] = xcv[j];
      const Vec<kWide> h = hidden_layers<kWide>(w, s, a, b);
      // Jacobi: h was computed from the whole previous iterate
      for (int f = 0; f < s.F; ++f) {
        feature_params<kWide>(w + s.last_off, s, h, f, p);
        if constexpr (kFam == kPolynomial) {
          poly_prepare<kWide>(p, s, k);
          xcv[f] = poly_inverse<kWide>(y[f], xcv[f], sweep, p, s, k);
        } else {
          xcv[f] = closed_inverse<kWide, kFam == kCircular>(y[f], p, s, k);
        }
      }
    }
    if (kMode != kNoLadj) {
      for (int j = 0; j < D0; ++j) a[j] = xcv[j];
      const Vec<kWide> h = hidden_layers<kWide>(w, s, a, b);
      for (int f = 0; f < s.F; ++f) {
        feature_params<kWide>(w + s.last_off, s, h, f, p);
        float ladj;
        univ_forward<kWide, kFam>(xcv[f], p, s, k, &ladj);
        acc += ladj;
      }
    }
    for (int f = 0; f < s.F; ++f) y[f] = xcv[f];
  }
  if (active) {
    for (int f = 0; f < s.F; ++f) xout[row * s.F + f] = y[f];
    if (kMode != kNoLadj) logq[row] = acc;
  }
}

// ------------------------------------------------------------------------
// The narrow tier of the closed-form sampler (affine and RQS), of the
// circular spline's and of the polynomials' (all three modes):
// nsf_sample_tiled, a block a tile of R rows (128, or 64 or 32 where a flow's
// tile passes 227 KB at 128; the polynomials' samplers 64 or 32 rows, two
// blocks an SM, where they fit) for the whole inversion.
//
// The same function as nsf_sample_kernel<kWide = true, mode, family>, with
// every float32 sum in the same order: the layers in reverse, the softclip's
// inverse, min(passes, F) Jacobi sweeps a layer, the log-q (or raw) forward
// pass at the solved point. What held the per-thread design back (one thread
// a row, its activations in local memory that spilled to L2, one shared
// weight and one local activation loaded a multiply-add, the features solved
// one after another) it does so:
// - the tile's iterate and context [F + C][R], its targets [F][R], the
//   MADE's hidden activations ping-ponged [H][R] and the last linear's
//   outputs [pad8(F T)][R] live in shared memory beside the layer's weights,
//   staged once a layer as W^T [in][pad8(out)] and a padded bias (the
//   wrapper builds them: _tiled_weights in ops/nsf_fused.py);
// - each linear is a register-blocked product: a thread owns a patch of 4
//   rows x 8 outputs, whose 4 activations and 8 weights come in three
//   16-byte loads for 32 multiply-adds; the 32 patches of a warp are 32
//   row groups of the same outputs (the weights a broadcast, the
//   activations and the write-back conflict-free); each sum from the bias
//   in the order of the inputs, one fmaf a term, as the wide tier's;
// - the spline's inverse and its forward log-Jacobian run one thread a
//   (row, feature) pair, F R pairs over the block: the pair's raw
//   parameters are normalised in place in its column of the outputs, and
//   the knots are streamed in registers (the bin is the last knot below the
//   value, the cumulative sums those of rqs_knots), so no knot array exists;
//   the circular spline is the same with the shift: its root wrapped, its
//   forward at the wrapped point (closed_inverse, closed_forward);
// - the polynomials' solves and forward log-Jacobians run one thread a pair
//   too, the pair's coefficients in registers (up to kPolyRegs), every
//   evaluation, bisection and Newton step in the wide tier's order: the
//   Bernstein polynomial's coefficients, their steps and De Casteljau's
//   scratch (bernstein_registers), the sum of squares' P (L + 1)
//   coefficients in the order Horner's rule reads them (sosp_registers);
//   what held the per-thread kernel back there was reading a local-memory
//   float for every lerp (two, and one written) or Horner step;
// - thread r < R owns row r's running sum (base, softclips, the layers'
//   log-Jacobians, in the wide tier's order) and its softclip inverse.
// The masked products are dense (the masks' zeros are multiplied as in the
// wide tier, so the sums match it bit for bit).

constexpr int kSampleThreads = 256;

__host__ __device__ __forceinline__ int pad8(int v) { return (v + 7) & ~7; }

// A tile's arrays in dynamic shared memory, as float offsets (tile_plan;
// mirrored in ops/nsf_fused.py _sample_tile_floats). Every offset is a
// multiple of 4 floats.
struct SampleTile {
  int R, lr;     // rows of a tile, log2 R
  int wfloats;   // one layer's staged weights, from offset 0
  int xc;        // [F + C][R]: the iterate, then the context
  int y;         // [F][R]: the layer's targets
  int a, b;      // [pad8(widest hidden)][R], ping-pong
  int p;         // [pad8(F T)][R]: the last linear's outputs
  int floats;
};

// Element t of a (row, feature) pair's column: p[t * R].
struct Strided {
  float* p;
  int R;
  __device__ __forceinline__ float& operator[](int t) const { return p[t * R]; }
};

// out[o][r] = act(b[o] + sum_k W[o, k] in[k][r]) for the pad8(dout) = dp
// outputs o and the R rows r, from wt = W^T [din][dp] then b [dp]; ReLU when
// kRelu. A patch of 4 rows x 8 outputs a thread.
template <bool kRelu>
__device__ __forceinline__ void tile_linear(const float* in, int din, const float* wt, int dp,
                                            float* out, int R, int lr) {
  const int nrg = R >> 2, ncg = dp >> 3;
  for (int q = threadIdx.x; q < nrg * ncg; q += kSampleThreads) {
    const int cg = q >> (lr - 2), rg = q & (nrg - 1);
    const float* bias = wt + din * dp + 8 * cg;
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bv = bias[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = bv;
    }
    const float* ap = in + 4 * rg;
    const float* bp = wt + 8 * cg;
#pragma unroll 4
    for (int k = 0; k < din; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(ap + k * R);
      const float4 b0 = *reinterpret_cast<const float4*>(bp + k * dp);
      const float4 b1 = *reinterpret_cast<const float4*>(bp + k * dp + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(bv[j], av[i], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float4 o;
      o.x = kRelu ? fmaxf(acc[0][j], 0.0f) : acc[0][j];
      o.y = kRelu ? fmaxf(acc[1][j], 0.0f) : acc[1][j];
      o.z = kRelu ? fmaxf(acc[2][j], 0.0f) : acc[2][j];
      o.w = kRelu ? fmaxf(acc[3][j], 0.0f) : acc[3][j];
      *reinterpret_cast<float4*>(out + (8 * cg + j) * R + 4 * rg) = o;
    }
  }
}

// The hyper-net on the tile's iterate: the hidden ReLU layers, then the last
// linear into the outputs p. Ends synchronised.
__device__ __forceinline__ void made_tiled(const Shape& s, const SampleTile& tl, float* sm) {
  const float* in = sm + tl.xc;
  const float* w = sm;
  int din = s.widths[0];
  for (int i = 0; i < s.n_lin; ++i) {
    const int dp = pad8(s.widths[i + 1]);
    const bool last = i == s.n_lin - 1;
    float* out = sm + (last ? tl.p : (i & 1) ? tl.b : tl.a);
    if (last) {
      tile_linear<false>(in, din, w, dp, out, tl.R, tl.lr);
    } else {
      tile_linear<true>(in, din, w, dp, out, tl.R, tl.lr);
    }
    __syncthreads();
    w += din * dp + dp;
    in = out;
    din = s.widths[i + 1];
  }
}

__device__ __forceinline__ float knot_slope(float d, float ls) {
  return expf(d / (1.0f + fabsf(d / ls)));
}

// The spline of one (row, feature) pair from its raw parameters p
// (normalised in place, as rqs_knots does), at v: the inverse (kInverse) or
// the forward with its log-Jacobian in *ladj. The knots are streamed: the
// bin is the last knot below v, which is what find_bin counts, the knots
// nondecreasing.
template <bool kInverse>
__device__ __forceinline__ float spline_streamed(float v, const Strided& p, const Shape& s,
                                                 float* ladj) {
  const int K = s.K;
  const float B = s.bound, ls = s.log_s;
  float mw = -INFINITY, mh = -INFINITY;
  for (int j = 0; j < K; ++j) {
    float w = p[j], h = p[K + j];
    w = w / (1.0f + fabsf(2.0f * w / ls));
    h = h / (1.0f + fabsf(2.0f * h / ls));
    p[j] = w;
    p[K + j] = h;
    mw = fmaxf(mw, w);
    mh = fmaxf(mh, h);
  }
  float sw = 0.0f, sh = 0.0f;
  for (int j = 0; j < K; ++j) {
    p[j] = expf(p[j] - mw);
    p[K + j] = expf(p[K + j] - mh);
    sw += p[j];
    sh += p[K + j];
  }
  float cw = 0.0f, ch = 0.0f, x0 = -B, y0 = -B, x1 = -B, y1 = -B;
  int k = -B < v ? 0 : -1;
  for (int j = 0; j < K; ++j) {
    cw += p[j] / sw;
    ch += p[K + j] / sh;
    const float xn = B * (2.0f * cw - 1.0f), yn = B * (2.0f * ch - 1.0f);
    if (k == j) {
      x1 = xn;
      y1 = yn;
    }
    if ((kInverse ? yn : xn) < v) {
      k = j + 1;
      x0 = xn;
      y0 = yn;
    }
  }
  if (k < 0 || k >= K) {  // out of domain: identity, ladj 0
    if (!kInverse) *ladj = 0.0f;
    return v;
  }
  const float d0 = k == 0 ? 1.0f : knot_slope(p[2 * K + k - 1], ls);
  const float d1 = k + 1 == K ? 1.0f : knot_slope(p[2 * K + k], ls);
  if (kInverse) return rqs::inverse_in_bin<false>(v, x0, x1, y0, y1, d0, d1, nullptr);
  return rqs::forward_in_bin(v, x0, x1, y0, y1, d0, d1, ladj);
}

// The Bernstein polynomial of one (row, feature) pair in registers, for
// N = M + 5 <= kN coefficients: bernstein_coefficients' theta and steps,
// then poly_eval's arithmetic on them, solved by poly_solve, every lerp of
// De Casteljau's in its order (the loops unrolled to kN, the levels past N
// skipped), so that no array is indexed at run time.

// theta (N) and order * the steps (N - 1) into th and st, from the pair's M
// raw parameters p (overwritten by their exponentials).
template <int kN>
__device__ __forceinline__ void bernstein_registers(const Strided& p, const Shape& s,
                                                    float (&th)[kN], float (&st)[kN]) {
  const int M = s.K;
  const float B = s.bound, d = (2.0f * B) / (M + 4), scale = 2.0f * B - 4.0f * d;
  const float order = (float)(M + 4);
  float mx = -INFINITY;
  for (int j = 0; j < M; ++j) mx = fmaxf(mx, p[j]);
  float sum = 0.0f;
  for (int j = 0; j < M; ++j) {
    p[j] = expf(p[j] - mx);
    sum += p[j];
  }
  const float inv = 1.0f / sum;
  th[0] = -B;
  th[1] = -B + d;
  th[2] = -B + 2.0f * d;
  st[0] = order * d;
  st[1] = order * d;
  st[kN - 1] = 0.0f;
  float run = 0.0f;
#pragma unroll
  for (int i = 3; i < kN; ++i) {
    const int j = i - 3;
    if (j < M) {
      const float sm = p[j] * inv;
      run += sm;
      th[i] = (-B + 2.0f * d) + scale * run;
      st[i - 1] = order * scale * sm;
    } else if (i == M + 3) {
      th[i] = B - d;
      st[i - 1] = order * d;
    } else if (i == M + 4) {
      th[i] = B;
      st[i - 1] = order * d;
    } else {
      th[i] = 0.0f;
      st[i - 1] = 0.0f;
    }
  }
}

// De Casteljau: the Bezier sum of c[0 .. m) at u (decasteljau's lerps).
template <int kN>
__device__ __forceinline__ float casteljau(const float (&c)[kN], int m, float u) {
  float sc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) sc[i] = c[i];
#pragma unroll
  for (int k = kN - 1; k > 0; --k) {
    if (k < m) {
#pragma unroll
      for (int i = 0; i < kN - 1; ++i)
        if (i < k) sc[i] = fmaf(u, sc[i + 1] - sc[i], sc[i]);
    }
  }
  return sc[0];
}

// poly_eval of the Bernstein univariate at x: the value and, with kGrad,
// dy/dx in *dydx.
template <bool kGrad, int kN>
__device__ __forceinline__ float bernstein_eval(const float (&th)[kN], const float (&st)[kN],
                                                const Shape& s, float x, float* dydx) {
  const float B = s.bound, u = (x + B) / (2.0f * B);
  if (u <= kBernsteinEps) {
    if (kGrad) *dydx = 1.0f;
    return 2.0f * B * (u - kBernsteinEps) - B;
  }
  if (u >= 1.0f - kBernsteinEps) {
    if (kGrad) *dydx = 1.0f;
    return 2.0f * B * (u - 1.0f + kBernsteinEps) + B;
  }
  const int N = s.K + 5;
  if (kGrad) *dydx = casteljau(st, N - 1, u) / (2.0f * B);
  return casteljau(th, N, u);
}

// The sum-of-squares polynomial of one (row, feature) pair in registers:
// sosp_integrand's and poly_eval's arithmetic, solved by poly_solve, every
// Horner step, square and Gauss-Legendre term in their order, for P (L + 1) <=
// kPolyRegs coefficients and kL = L + 1 <= kSospNodes nodes known at compile
// time (sosp_pair dispatches on L + 1), so that every loop unrolls, no
// run-time index reaches the coefficients, and the L + 1 evaluations of the
// integrand are independent chains; the polynomial slots past P are skipped
// by a uniform branch.

// c[k kL + i] = polynomial k's coefficient of degree L - i (the order
// Horner's rule reads them) from the pair's raw parameters p; returns the
// shift.
template <int kL>
__device__ __forceinline__ float sosp_registers(const Strided& p, const Shape& s,
                                                float (&c)[kPolyRegs]) {
#pragma unroll
  for (int k = 0; k < kPolyRegs / kL; ++k) {
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      c[k * kL + i] = 0.0f;
      if (k < s.K) c[k * kL + i] = p[k * kL + kL - 1 - i];
    }
  }
  return p[s.K * kL];
}

// sosp_integrand: g(v) = mean_k (1 + p_k(v / B))^2 + slope.
template <int kL>
__device__ __forceinline__ float sosp_g(const float (&c)[kPolyRegs], const Shape& s, float v) {
  const float u = v / s.bound;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kPolyRegs / kL; ++k) {
    if (k < s.K) {
      float q = c[k * kL];
#pragma unroll
      for (int i = 1; i < kL; ++i) q = fmaf(q, u, c[k * kL + i]);
      q += 1.0f;
      acc = fmaf(q, q, acc);
    }
  }
  return acc / s.K + s.slope;
}

// poly_eval of the sum of squares at x: the value and, with kGrad, dy/dx in
// *dydx.
template <bool kGrad, int kL>
__device__ __forceinline__ float sosp_eval(const float (&c)[kPolyRegs], float shift,
                                           const Shape& s, float x, float* dydx) {
  float quad = 0.0f;
#pragma unroll
  for (int t = 0; t < kL; ++t) {
    quad = fmaf(s.weights[t], sosp_g<kL>(c, s, x * (0.5f * (s.nodes[t] + 1.0f))), quad);
  }
  if (kGrad) *dydx = sosp_g<kL>(c, s, x);
  return 0.5f * x * quad + shift;
}

// What sosp_pair computes: the solve for a target, the forward log-Jacobian,
// or the forward value with its log-Jacobian.
enum SospOp { kSospSolve = 0, kSospLadj = 1, kSospForward = 2 };

// One pair of the sum of squares at its L + 1 = s.K2 nodes (kL, then the
// next, up to kSospNodes): kSospLadj the forward log-Jacobian log g(v);
// kSospForward the value at v (poly_eval's), log g(v) in *ladj; kSospSolve
// the solve for the target v, x0 the previous sweep's root.
template <int kOp, int kL = 1>
__device__ __forceinline__ float sosp_pair(const Strided& p, const Shape& s, float v, float x0,
                                           int sweep, float* ladj = nullptr) {
  if constexpr (kL < kSospNodes) {
    if (s.K2 != kL) return sosp_pair<kOp, kL + 1>(p, s, v, x0, sweep, ladj);
  }
  float c[kPolyRegs];
  const float shift = sosp_registers<kL>(p, s, c);
  if constexpr (kOp == kSospForward) {
    float g;
    const float y = sosp_eval<true, kL>(c, shift, s, v, &g);
    *ladj = logf(g);
    return y;
  }
  if (kOp == kSospLadj) return logf(sosp_g<kL>(c, s, v));
  const auto eval = [&](auto kGrad, float x, float* dydx) {
    return sosp_eval<decltype(kGrad)::value, kL>(c, shift, s, x, dydx);
  };
  return poly_solve(eval, s, false, v, x0, sweep);
}

// kUniv kAffine (0): the closed-form univariates (affine, RQS); kCRQS: the
// circular spline over its box; kBernstein, kSOSP: the polynomials of at
// most kPolyRegs coefficients in registers, whose solves want the warps of
// two blocks an SM (the planner's tile of 64 rows for them; at most 128
// registers a thread).
template <int kMode, int kUniv>
__global__ void __launch_bounds__(kSampleThreads, kUniv == kBernstein || kUniv == kSOSP ? 2 : 1)
    nsf_sample_tiled(const float* __restrict__ zc, float* __restrict__ xout,
                     float* __restrict__ logq, const float* __restrict__ tiled,
                     const __grid_constant__ Shape s, const __grid_constant__ SampleTile tl,
                     long long n) {
  extern __shared__ __align__(16) float sm[];
  const int R = tl.R, lr = tl.lr, tid = threadIdx.x, F = s.F, D0 = s.F + s.C, T = s.T;
  const long long row0 = (long long)blockIdx.x * R;
  float* xc = sm + tl.xc;
  float* y = sm + tl.y;
  float* P = sm + tl.p;
  for (int e = tid; e < D0 * R; e += kSampleThreads) {
    const int j = e >> lr, r = e & (R - 1);
    const float v = row0 + r < n ? zc[(row0 + r) * D0 + j] : 0.0f;
    if (j < F) {
      y[e] = v;
    } else {
      xc[e] = v;
    }
  }
  __syncthreads();
  // thread r < R owns row r's sum
  const bool owner = tid < R;
  float acc = 0.0f;
  if (kMode == kLogQ && owner) acc = base_log_prob<kUniv == kCRQS>(Strided{y + tid, R}, s);
  for (int l = s.n_ar - 1; l >= 0; --l) {
    __syncthreads();  // every thread is done with the previous layer's weights
    {
      const float4* src = reinterpret_cast<const float4*>(tiled + (size_t)l * tl.wfloats);
      float4* dst = reinterpret_cast<float4*>(sm);
      for (int q = tid; q < (tl.wfloats >> 2); q += kSampleThreads) dst[q] = src[q];
    }
    if (owner) {
      const float B = s.clips[l];
      if (B > 0.0f) {
        for (int f = 0; f < F; ++f) {
          const float v = y[f * R + tid];
          const float x = v / (1.0f - fabsf(v / B));
          if (kMode != kNoLadj) acc -= 2.0f * log1pf(fabsf(x / B));
          y[f * R + tid] = x;
        }
      }
      for (int f = 0; f < F; ++f) xc[f * R + tid] = 0.0f;
    }
    __syncthreads();
    const int sweeps = min(s.passes[l], F);
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      made_tiled(s, tl, sm);  // Jacobi: every feature's parameters from the same iterate
      for (int e = tid; e < F * R; e += kSampleThreads) {
        const int f = e >> lr, r = e & (R - 1);
        const Strided p{P + f * T * R + r, R};
        if constexpr (kUniv == kBernstein) {
          float th[kPolyRegs], st[kPolyRegs];
          bernstein_registers(p, s, th, st);
          const auto eval = [&](auto kGrad, float x, float* dydx) {
            return bernstein_eval<decltype(kGrad)::value>(th, st, s, x, dydx);
          };
          xc[e] = poly_solve(eval, s, true, y[e], xc[e], sweep);
        } else if constexpr (kUniv == kSOSP) {
          xc[e] = sosp_pair<kSospSolve>(p, s, y[e], xc[e], sweep);
        } else if constexpr (kUniv == kCRQS) {
          xc[e] = circular_wrap(spline_streamed<true>(y[e], p, s, nullptr), s.bound);
        } else {
          xc[e] = s.univ == kAffine ? (y[e] - p[0]) / expf(affine_log_scale(p, s.log_s))
                                    : spline_streamed<true>(y[e], p, s, nullptr);
        }
      }
      __syncthreads();
    }
    if (kMode != kNoLadj) {
      made_tiled(s, tl, sm);
      for (int e = tid; e < F * R; e += kSampleThreads) {
        const int f = e >> lr, r = e & (R - 1);
        const Strided p{P + f * T * R + r, R};
        float ladj;
        if constexpr (kUniv == kBernstein) {
          float th[kPolyRegs], st[kPolyRegs], g;
          bernstein_registers(p, s, th, st);
          bernstein_eval<true>(th, st, s, xc[e], &g);
          ladj = logf(g);
        } else if constexpr (kUniv == kSOSP) {
          ladj = sosp_pair<kSospLadj>(p, s, xc[e], 0.0f, 0);
        } else if constexpr (kUniv == kCRQS) {
          spline_streamed<false>(circular_wrap(xc[e], s.bound), p, s, &ladj);
        } else if (s.univ == kAffine) {
          ladj = affine_log_scale(p, s.log_s);
        } else {
          spline_streamed<false>(xc[e], p, s, &ladj);
        }
        p[0] = ladj;  // the pair's column is read no more
      }
      __syncthreads();
      if (owner)
        for (int f = 0; f < F; ++f) acc += P[f * T * R + tid];
    }
    if (owner)
      for (int f = 0; f < F; ++f) y[f * R + tid] = xc[f * R + tid];
  }
  __syncthreads();
  for (int e = tid; e < F * R; e += kSampleThreads) {
    const int f = e >> lr, r = e & (R - 1);
    if (row0 + r < n) xout[(row0 + r) * F + f] = y[e];
  }
  if (kMode != kNoLadj && owner && row0 + tid < n) logq[row0 + tid] = acc;
}

// The narrow tier of the density and apply (affine and RQS, the circular
// spline, the polynomials of at most kPolyRegs coefficients, the sum of
// squares of at most kSospNodes nodes): nsf_density_tiled, the tiled
// sampler's log-q pass once a layer, in forward order, with no sweeps. A
// block a tile of R rows (density_tile_rows in
// ops/nsf_fused.py), its arrays those of the sampler's tile but the targets
// (tile_plan without them). The same function as nsf_density_kernel<kWide =
// true, kRaw, family>: for each layer the hyper-net on the tile's x
// (made_tiled), then one thread a (row, feature) pair takes the forward and
// updates x in place (every feature's parameters are already in P), its
// log-Jacobian left in the pair's column: kUniv 0 the affine map or
// spline_streamed<false>; kCRQS the same spline at the wrapped point (the
// hyper-net read the unwrapped x, as closed_forward's); kBernstein the
// pair's coefficients in registers (bernstein_registers, bernstein_eval, as
// the sampler's log-q pass); kSOSP the sum of squares' P (L + 1)
// coefficients and shift in registers (sosp_pair's forward: sosp_eval, the
// value and g, then log g, poly_eval's arithmetic). Thread r < R owns row r's
// sum (the layers' log-Jacobians feature by feature, then the softclip's, in
// the wide tier's order) and the softclip of its row's x after each layer
// that has one (SOSPF's). kRaw false: out[row] = the sum + the base (the
// circular spline's box, else the standard normal) at T(x); kRaw true
// (nsf_apply): y[row, :] = T(x) and out[row] = the sum. The launch bounds:
// the polynomials' instantiations the samplers', at most 128 registers, so
// that their tiles of 64 rows put two blocks on an SM; the others' no minimum
// of blocks (0 emits none: a minimum of 1 changes how ptxas allocates the
// closed-form instantiation's registers, and its code).
template <bool kRaw, int kUniv>
__global__ void __launch_bounds__(kSampleThreads, kUniv == kBernstein || kUniv == kSOSP ? 2 : 0)
    nsf_density_tiled(const float* __restrict__ xcin, float* __restrict__ y,
                      float* __restrict__ out, const float* __restrict__ tiled,
                      const __grid_constant__ Shape s, const __grid_constant__ SampleTile tl,
                      long long n) {
  extern __shared__ __align__(16) float sm[];
  const int R = tl.R, lr = tl.lr, tid = threadIdx.x, F = s.F, D0 = s.F + s.C, T = s.T;
  const long long row0 = (long long)blockIdx.x * R;
  float* xc = sm + tl.xc;
  float* P = sm + tl.p;
  for (int e = tid; e < D0 * R; e += kSampleThreads) {
    const int j = e >> lr, r = e & (R - 1);
    xc[e] = row0 + r < n ? xcin[(row0 + r) * D0 + j] : 0.0f;
  }
  const bool owner = tid < R;
  float acc = 0.0f;
  for (int l = 0; l < s.n_ar; ++l) {
    __syncthreads();  // every thread is done with the previous layer's weights and x
    {
      const float4* src = reinterpret_cast<const float4*>(tiled + (size_t)l * tl.wfloats);
      float4* dst = reinterpret_cast<float4*>(sm);
      for (int q = tid; q < (tl.wfloats >> 2); q += kSampleThreads) dst[q] = src[q];
    }
    __syncthreads();
    made_tiled(s, tl, sm);
    for (int e = tid; e < F * R; e += kSampleThreads) {
      const int f = e >> lr, r = e & (R - 1);
      const Strided p{P + f * T * R + r, R};
      float ladj;
      if constexpr (kUniv == kBernstein) {
        float th[kPolyRegs], st[kPolyRegs], g;
        bernstein_registers(p, s, th, st);
        xc[e] = bernstein_eval<true>(th, st, s, xc[e], &g);
        ladj = logf(g);
      } else if constexpr (kUniv == kSOSP) {
        xc[e] = sosp_pair<kSospForward>(p, s, xc[e], 0.0f, 0, &ladj);
      } else if constexpr (kUniv == kCRQS) {
        xc[e] = spline_streamed<false>(circular_wrap(xc[e], s.bound), p, s, &ladj);
      } else if (s.univ == kAffine) {
        ladj = affine_log_scale(p, s.log_s);
        xc[e] = xc[e] * expf(ladj) + p[0];
      } else {
        xc[e] = spline_streamed<false>(xc[e], p, s, &ladj);
      }
      p[0] = ladj;  // the pair's column is read no more
    }
    __syncthreads();
    if (owner) {
      for (int f = 0; f < F; ++f) acc += P[f * T * R + tid];
      const float B = s.clips[l];
      if (B > 0.0f) softclip(Strided{xc + tid, R}, F, B, &acc);
    }
  }
  __syncthreads();
  if (kRaw) {
    for (int e = tid; e < F * R; e += kSampleThreads) {
      const int f = e >> lr, r = e & (R - 1);
      if (row0 + r < n) y[(row0 + r) * F + f] = xc[e];
    }
  }
  if (owner && row0 + tid < n)
    out[row0 + tid] =
        kRaw ? acc : acc + base_log_prob<kUniv == kCRQS>(Strided{xc + tid, R}, s);
}

// The flow's description as the wrapper hands it over, checked.
struct Desc {
  int n_lin, n_ar, F, C, K, T, K2, kn, univ;
  long long layer_floats;
  int last_off;
  float bound, log_s, slope;
  int box;
  float lo, hi, log_box;
  int n_cold, n_warm;
  int w_max;
  std::vector<int> widths, passes;
  std::vector<float> clips, nodes, weights;
};

// The base and the solver's settings: box, lo, hi, log(hi - lo), and the
// Gauss-Legendre nodes then weights (K2 of each).
struct Extras {
  float slope;
  const float* clips;
  const float* rule;
  int box;
  float lo, hi, log_box;
};

int describe(Desc* d, const int* widths, const int* passes, int n_lin, int n_ar, int F, int C,
             int K, int K2, int univ, float bound, float log_s, const Extras& e) {
  if (n_lin < 1 || n_ar < 1 || F < 1 || C < 0 || univ < kAffine || univ > kBernstein ||
      ((univ == kRQS || univ == kCRQS || univ == kBernstein) && K < 1) ||
      (univ == kSOSP && (K < 1 || K2 < 1)) || !(bound > 0.0f) || (e.box && !(e.hi > e.lo)) ||
      (e.box != 0) != (univ == kCRQS))  // the box is the circular spline's base, and only its
    return cudaErrorInvalidValue;
  int T = 2, kn = K + 1;
  if (univ == kRQS || univ == kCRQS) T = 3 * K - 1;
  if (univ == kSOSP) T = K * K2 + 1, kn = 0;
  if (univ == kBernstein) T = K, kn = K + 5;
  *d = Desc{n_lin, n_ar, F, C, K, T, univ == kSOSP ? K2 : 0, kn, univ, 0, 0, bound, log_s,
            e.slope, e.box, e.lo, e.hi, e.log_box,
            (int)ceil(log2(2.0 * bound / 1e-3)), (int)ceil(log2(2.0 * kWarmR / 1e-3)), 0,
            {}, {}, {}, {}, {}};
  if (widths[0] != F + C || widths[n_lin] != F * T) return cudaErrorInvalidValue;
  long long floats = 0;
  for (int i = 0; i <= n_lin; ++i) {
    if (widths[i] < 1) return cudaErrorInvalidValue;
    d->widths.push_back(widths[i]);
    if (i == n_lin - 1) d->last_off = (int)floats;
    if (i < n_lin) {
      d->w_max = widths[i] > d->w_max ? widths[i] : d->w_max;
      floats += (long long)widths[i + 1] * (widths[i] + 1);
    }
  }
  if (floats > 0x7fffffffLL) return cudaErrorInvalidValue;  // offsets in a layer are ints
  d->layer_floats = floats;
  for (int l = 0; l < n_ar; ++l) {
    if (passes[l] < 1 || !(e.clips[l] >= 0.0f)) return cudaErrorInvalidValue;
    d->passes.push_back(passes[l]);
    d->clips.push_back(e.clips[l]);
  }
  for (int t = 0; t < d->K2; ++t) {
    d->nodes.push_back(e.rule[t]);
    d->weights.push_back(e.rule[d->K2 + t]);
  }
  return cudaSuccess;
}

bool fits_narrow(const Desc& d) {
  bool arrays = true;
  if (d.univ == kRQS || d.univ == kCRQS) arrays = d.K <= kMaxBins;
  if (d.univ == kSOSP) arrays = d.T <= kMaxT && d.K2 <= kMaxNodes;
  if (d.univ == kBernstein) arrays = d.T <= kMaxT && d.K + 5 <= kMaxTheta;
  return d.n_lin <= kMaxLinear && d.n_ar <= kMaxLayers && d.w_max <= kMaxWidth &&
         d.F <= kMaxWidth && arrays;
}

Shape narrow_shape(const Desc& d) {
  Shape s{};
  s.n_lin = d.n_lin;
  s.n_ar = d.n_ar;
  s.F = d.F;
  s.C = d.C;
  s.K = d.K;
  s.T = d.T;
  s.K2 = d.K2;
  s.kn = d.kn;
  s.univ = d.univ;
  s.layer_floats = (int)d.layer_floats;
  s.last_off = d.last_off;
  s.bound = d.bound;
  s.log_s = d.log_s;
  s.slope = d.slope;
  s.box = d.box;
  s.lo = d.lo;
  s.hi = d.hi;
  s.log_box = d.log_box;
  s.n_cold = d.n_cold;
  s.n_warm = d.n_warm;
  s.w_max = d.w_max;
  for (int i = 0; i <= d.n_lin; ++i) s.widths[i] = d.widths[i];
  for (int l = 0; l < d.n_ar; ++l) {
    s.passes[l] = d.passes[l];
    s.clips[l] = d.clips[l];
  }
  for (int t = 0; t < d.K2; ++t) {
    s.nodes[t] = d.nodes[t];
    s.weights[t] = d.weights[t];
  }
  return s;
}

// What a launch needs besides the flow (see naf_fused.cu): the input, the
// outputs, the packed weights, the rows, the tier and the wide tier's
// workspace and descriptor buffer.
struct Launch {
  const float* in;
  float* out0;
  float* out1;
  const float* params;
  long long n;
  int wide;
  float* work;
  long long work_floats, stride;
  void* desc;
  long long desc_bytes;
  cudaStream_t stream;
  const float* tiled;  // the tiled sampler's staged weights (_tiled_weights)
  int tile;            // and its tile rows
};

// kDensity, kApply: the density kernel without or with kRaw; the sample
// modes as SampleMode + 2.
enum Op { kDensity = 0, kApply = 1, kSample = 2, kSampleLogQ = 3, kSampleRaw = 4 };

template <bool kWide, int kFam>
int launch(int op, const Launch& l, const ShapeOf<kWide>& s, long long stride, size_t smem) {
  for (long long row0 = 0; row0 < l.n; row0 += stride) {
    const long long row_end = row0 + stride < l.n ? row0 + stride : l.n;
    const unsigned blocks = (unsigned)((row_end - row0 + kThreads - 1) / kThreads);
    const auto args = [&](auto kernel) {
      kernel<<<blocks, kThreads, smem, l.stream>>>(l.in, l.out0, l.out1, l.params, s, l.work,
                                                    stride, row0, row_end);
    };
    // the narrow tier here is the polynomials' per-thread one (run_narrow):
    // the other families' narrow kernels are tiled (run_tiled)
    switch (op) {
      case kDensity: args(nsf_density_kernel<kWide, false, kFam>); break;
      case kApply: args(nsf_density_kernel<kWide, true, kFam>); break;
      case kSample: args(nsf_sample_kernel<kWide, kNoLadj, kFam>); break;
      case kSampleLogQ: args(nsf_sample_kernel<kWide, kLogQ, kFam>); break;
      default: args(nsf_sample_kernel<kWide, kRawLadj, kFam>);
    }
    const int rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

template <class Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The per-thread narrow tier: the polynomials that no tiled kernel takes
// (past kPolyRegs coefficients, or the sum of squares past kSospNodes nodes:
// the density, the apply and the sampler alike).
int run_narrow(int op, const Launch& l, const Desc& d) {
  const Shape s = narrow_shape(d);
  const size_t smem = (size_t)s.layer_floats * sizeof(float);
  int rc;
  switch (op) {
    case kDensity: rc = allow_smem(nsf_density_kernel<false, false, kPolynomial>, smem); break;
    case kApply: rc = allow_smem(nsf_density_kernel<false, true, kPolynomial>, smem); break;
    case kSample: rc = allow_smem(nsf_sample_kernel<false, kNoLadj, kPolynomial>, smem); break;
    case kSampleLogQ: rc = allow_smem(nsf_sample_kernel<false, kLogQ, kPolynomial>, smem); break;
    default: rc = allow_smem(nsf_sample_kernel<false, kRawLadj, kPolynomial>, smem);
  }
  if (rc != cudaSuccess) return rc;
  return launch<false, kPolynomial>(op, l, s, l.n > 0 ? l.n : 1, smem);
}

// The tiled kernels' tile of R rows (SampleTile; R = 0: no plan), with the
// sampler's targets or (the density) without them.
SampleTile tile_plan(const Desc& d, int R, bool targets) {
  SampleTile t{};
  if (R != 32 && R != 64 && R != 128) return t;
  t.R = R;
  t.lr = R == 32 ? 5 : R == 64 ? 6 : 7;
  int hidden = 0;
  for (int i = 0; i < d.n_lin; ++i) {
    t.wfloats += d.widths[i] * pad8(d.widths[i + 1]) + pad8(d.widths[i + 1]);
    if (i > 0) hidden = d.widths[i] > hidden ? d.widths[i] : hidden;
  }
  t.xc = t.wfloats;
  t.y = t.xc + (d.F + d.C) * R;
  t.a = t.y + (targets ? d.F * R : 0);
  t.b = t.a + pad8(hidden) * R;
  t.p = t.b + pad8(hidden) * R;
  t.floats = t.p + pad8(d.F * d.T) * R;
  return t;
}

// Whether the narrow tier is tiled (nsf_density_tiled, nsf_sample_tiled):
// the closed-form and circular families, and the polynomials of at most
// kPolyRegs coefficients, the sum of squares of at most kSospNodes nodes
// (mirrored in ops/nsf_fused.py _tiled).
bool tiled(const Desc& d) {
  if (d.univ == kBernstein) return d.K + 5 <= kPolyRegs;
  if (d.univ == kSOSP) return d.K * d.K2 <= kPolyRegs && d.K2 <= kSospNodes;
  return true;
}

// The tiled narrow tier: a block a tile of l.tile rows; a density or apply,
// or a sampler. It reads the staged weights (l.tiled) alone.
int run_tiled(int op, const Launch& l, const Desc& d) {
  const SampleTile t = tile_plan(d, l.tile, op >= kSample);
  const size_t smem = 4 * (size_t)t.floats;
  if (t.R == 0 || l.tiled == nullptr || smem > (size_t)kMaxShared) return cudaErrorInvalidValue;
  if (l.n == 0) return cudaSuccess;
  const Shape s = narrow_shape(d);
  const unsigned blocks = (unsigned)((l.n + t.R - 1) / t.R);
  const auto go = [&](auto kernel) {
    const int rc = allow_smem(kernel, smem);
    if (rc != cudaSuccess) return rc;
    kernel<<<blocks, kSampleThreads, smem, l.stream>>>(l.in, l.out0, l.out1, l.tiled, s, t, l.n);
    return (int)cudaGetLastError();
  };
  if (op == kDensity || op == kApply) {
    const auto raw = [&](auto density, auto apply) {
      return op == kDensity ? go(density) : go(apply);
    };
    if (d.univ == kCRQS) return raw(nsf_density_tiled<false, kCRQS>, nsf_density_tiled<true, kCRQS>);
    if (d.univ == kBernstein) {
      return raw(nsf_density_tiled<false, kBernstein>, nsf_density_tiled<true, kBernstein>);
    }
    if (d.univ == kSOSP) return raw(nsf_density_tiled<false, kSOSP>, nsf_density_tiled<true, kSOSP>);
    return raw(nsf_density_tiled<false, 0>, nsf_density_tiled<true, 0>);
  }
  const auto modes = [&](auto sample, auto log_q, auto raw) {
    return op == kSample ? go(sample) : op == kSampleLogQ ? go(log_q) : go(raw);
  };
  if (d.univ == kCRQS) {
    return modes(nsf_sample_tiled<kNoLadj, kCRQS>, nsf_sample_tiled<kLogQ, kCRQS>,
                 nsf_sample_tiled<kRawLadj, kCRQS>);
  }
  if (d.univ == kSOSP) {
    return modes(nsf_sample_tiled<kNoLadj, kSOSP>, nsf_sample_tiled<kLogQ, kSOSP>,
                 nsf_sample_tiled<kRawLadj, kSOSP>);
  }
  if (d.univ == kBernstein) {
    return modes(nsf_sample_tiled<kNoLadj, kBernstein>, nsf_sample_tiled<kLogQ, kBernstein>,
                 nsf_sample_tiled<kRawLadj, kBernstein>);
  }
  return modes(nsf_sample_tiled<kNoLadj, 0>, nsf_sample_tiled<kLogQ, 0>,
               nsf_sample_tiled<kRawLadj, 0>);
}

int run(int op, const Launch& l, const Desc& d) {
  if (l.n < 0) return cudaErrorInvalidValue;
  const int fam = family_of(d.univ);
  if (!l.wide) {
    if (!fits_narrow(d)) return cudaErrorInvalidValue;
    if (tiled(d)) return run_tiled(op, l, d);
    if (l.params == nullptr) return cudaErrorInvalidValue;
    return run_narrow(op, l, d);
  }
  if (l.params == nullptr) return cudaErrorInvalidValue;
  // the device buffer: widths, passes (ints), clips, nodes, weights (floats)
  const long long words = (long long)(d.n_lin + 1) + 2LL * d.n_ar + 2LL * d.K2;
  const long long need = words * 4;
  const long long slots = (long long)(d.F + d.C) + d.F + 2LL * d.w_max + d.T + 3LL * d.kn;
  if (l.desc == nullptr || l.desc_bytes < need || l.work == nullptr || l.stride < 1 ||
      slots * l.stride > l.work_floats)
    return cudaErrorInvalidValue;
  // a pageable source is staged before cudaMemcpyAsync returns
  std::vector<int> image(d.widths);
  image.insert(image.end(), d.passes.begin(), d.passes.end());
  for (const std::vector<float>* part : {&d.clips, &d.nodes, &d.weights}) {
    for (float v : *part) {
      int bits;
      memcpy(&bits, &v, sizeof bits);
      image.push_back(bits);
    }
  }
  const int rc = cudaMemcpyAsync(l.desc, image.data(), (size_t)need, cudaMemcpyHostToDevice,
                                 l.stream);
  if (rc != cudaSuccess) return rc;
  const int* di = (const int*)l.desc;
  const float* df = (const float*)l.desc;
  const int off = d.n_lin + 1 + d.n_ar;
  const WideShape ws{d.n_lin,  d.n_ar,    d.F,     d.C,      d.K,      d.T,      d.K2,
                     d.kn,     d.univ,    d.layer_floats,    d.last_off,         d.bound,
                     d.log_s,  d.slope,   d.box,   d.lo,     d.hi,     d.log_box, d.n_cold,
                     d.n_warm, d.w_max,   di,      di + d.n_lin + 1,   df + off,
                     df + off + d.n_ar,   df + off + d.n_ar + d.K2};
  if (fam == kCircular) return launch<true, kCircular>(op, l, ws, l.stride, 0);
  return fam == kPolynomial ? launch<true, kPolynomial>(op, l, ws, l.stride, 0)
                            : launch<true, kClosed>(op, l, ws, l.stride, 0);
}

int entry(int op, const float* in, float* out0, float* out1, const float* params,
          const int* widths, const int* passes, const float* clips, int n_lin, int n_ar, int F,
          int C, int K, int K2, int univ, float bound, float log_s, float slope,
          const float* rule, int box, float lo, float hi, float log_box, long long n, int wide,
          float* work, long long work_floats, long long stride, void* desc,
          long long desc_bytes, void* stream, const float* tiled = nullptr, int tile = 0) {
  Desc d;
  const int rc = describe(&d, widths, passes, n_lin, n_ar, F, C, K, K2, univ, bound, log_s,
                          Extras{slope, clips, rule, box, lo, hi, log_box});
  if (rc != cudaSuccess) return rc;
  return run(op,
             {in, out0, out1, params, n, wide, work, work_floats, stride, desc, desc_bytes,
              (cudaStream_t)stream, tiled, tile},
             d);
}

}  // namespace

// Each entry point takes the flow as the wrapper packs it (per AR layer
// [M*W_0, b_0, M*W_1, b_1, ...]; null on the tiled narrow tier, which reads
// `tiled` alone), `widths` of the hyper-net, `passes` and the
// softclip bound after each layer (0 for none), the univariate's code and
// sizes K, K2, its bound, log-slope and slope, the SOSP Gauss-Legendre rule
// (K2 nodes, then K2 weights), the base (box 0: standard normal; 1: the box
// [lo, hi]^F, log_box = log(hi - lo))), then the tier: wide 0, the narrow
// tier (work and desc unused); wide 1, the wide tier, with a workspace of
// work_floats floats for `stride` rows a launch and a descriptor buffer of
// desc_bytes bytes on the device.
#define NSF_FLOW                                                                               \
  const float *params, const int *widths, const int *passes, const float *clips, int n_lin,  \
      int n_ar, int F, int C, int K, int K2, int univ, float bound, float log_s, float slope, \
      const float *rule, int box, float lo, float hi, float log_box, long long n, int wide,   \
      float *work, long long work_floats, long long stride, void *desc, long long desc_bytes, \
      void *stream
#define NSF_ARGS                                                                              \
  params, widths, passes, clips, n_lin, n_ar, F, C, K, K2, univ, bound, log_s, slope, rule, \
      box, lo, hi, log_box, n, wide, work, work_floats, stride, desc, desc_bytes, stream

// out (n,) = log_prob of xc (n, F + C). The tiled narrow tier takes `tiled`
// and `tile` as nsf_sample_f32 does; the other densities ignore both.
extern "C" int nsf_density_f32(const float* xc, float* out, NSF_FLOW, const float* tiled,
                               int tile) {
  return entry(kDensity, xc, nullptr, out, NSF_ARGS, tiled, tile);
}

// y (n, F) = T(x), ladj (n,) = the bare sum of the forward log-Jacobians;
// `tiled` and `tile` as nsf_density_f32's.
extern "C" int nsf_apply_f32(const float* xc, float* y, float* ladj, NSF_FLOW,
                             const float* tiled, int tile) {
  return entry(kApply, xc, y, ladj, NSF_ARGS, tiled, tile);
}

// x (n, F) = T^-1(z) of zc = [z, c]; logq may be null: the solve alone. The
// tiled narrow tier (wide 0: affine, RQS, the circular spline, or a
// polynomial of at most kPolyRegs coefficients, a sum of squares of at most
// kSospNodes nodes) takes `tiled`, each layer's
// linears as W^T [in][pad8(out)] then the bias padded to pad8(out),
// zero-filled, and its tile of `tile` rows (32, 64 or 128); the other
// samplers ignore both.
extern "C" int nsf_sample_f32(const float* zc, float* x, float* logq, NSF_FLOW,
                              const float* tiled, int tile) {
  return entry(logq != nullptr ? kSampleLogQ : kSample, zc, x, logq, NSF_ARGS, tiled, tile);
}

// The raw mode: ladj (n,) = the bare sum of the forward log-Jacobians at the
// solved x, with no base term.
extern "C" int nsf_sample_raw_f32(const float* zc, float* x, float* ladj, NSF_FLOW,
                                  const float* tiled, int tile) {
  if (ladj == nullptr) return cudaErrorInvalidValue;
  return entry(kSampleRaw, zc, x, ladj, NSF_ARGS, tiled, tile);
}

// Shared memory a block may opt into on `device` (bytes), or -1.
extern "C" int nsf_max_shared_bytes(int device) {
  int v = -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return v;
}

extern "C" const char* nsf_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
