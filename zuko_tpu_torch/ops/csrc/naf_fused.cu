// Whole-flow neural autoregressive flow kernels for Hopper (sm_90a), for the
// monotone-network (MNN, NAF) and the unconstrained monotone-network (UMNN,
// UNAF) univariates.
//
// naf_density replaces the TPU kernel zuko_tpu/ops/naf_fused.py::_naf_density_impl
// (pallas_call at :949; kernel body _naf_density_kernel_T :821, math
// _naf_density_math_T :657): log_prob of a NAF or UNAF in one launch. Per
// autoregressive layer, the MADE pass on the layer's input; then per feature f
// its T outputs (the S signal values, and for a UMNN its additive constant),
// the univariate network's first layer split into its signal part
// pre1 = W1[:, 1:] s + b1 (hoisted) and its x column, and:
//   MNN: the monotone network and its x-derivative g by forward mode through
//     the TwoWayELU layers; the output is the new value, log g the ladj;
//   UMNN (_umnn_vg_hoisted :456): y = c + (x / 2) sum_k w_k g(x (t_k + 1) / 2)
//     over the 16 Gauss-Legendre nodes, with g = exp(d / (1 + |d / 7|)) and d
//     the ELU integrand network's output; the ladj is log g(x), one more
//     integrand evaluation (17 a feature and layer).
// A softclip x / (1 + |x / B|) adds -2 log1p(|x / B|) per feature; the
// standard-normal base term closes the sum.
//
// naf_sample replaces zuko_tpu/ops/naf_fused.py::_naf_sample_core (pallas_call
// at :1128; kernel body _naf_kernel_T :802, solver _ar_inverse_sweeps_T :492):
// the whole inversion, stages in reverse. A softclip inverts as
// y / (1 - |y / B|). An autoregressive layer takes min(passes, F) sweeps, each
// one MADE pass on the current iterate and then, feature by feature, the
// hoist and the solve of f(x) = y (a UMNN solves for y less its constant).
// Within a sweep the features are independent at fixed MADE outputs, so this
// equals the TPU's all-features-at-once loop while only one feature's hoisted
// values are live. Sweep 0 bisects [-10, 10] 10 times; later sweeps bracket
// the previous root by +-0.0625, checked by 2 evaluations (a row whose root
// left the window takes the full bracket), and bisect 3 times. Then Newton
// steps x - (f - y) / max(f', 1e-12), clamped to [-10, 10]: 3 for a monotone
// network; for a UMNN 4 in sweep 0 and 3 later, the integral by GL-4 in the
// bisection and the checks, GL-8 in the Newton steps but the last, GL-16 in
// the last. With kLogQ it also returns log q of the returned point: base(z),
// each softclip's forward ladj at its solved input, and per layer one more
// MADE pass and log g at the solved x.
//
// What bounds them on an H100: operations. A density row of the flagship
// NAF(6, transforms=3, signal=16), 64x64 MADE and monotone nets 17-64-64-1,
// costs about 0.4M flops against 28 bytes, a sample row about 11.6M; a UNAF
// density row about 2.7M (306 integrand evaluations of ~8.4K), a sample row
// about 54M (84 evaluations a feature in the cold sweep, 55 in a warm one).
//
// Two tiers, chosen by the wrapper from the flow's shape alone
// (zuko_tpu_torch/ops/naf_fused.py plan_naf). The narrow tier of both
// kernels, in both modes, is tiled (naf_density_tiled, naf_sample_tiled
// below): a block of 512 threads owns a tile of rows, and the network
// evaluations of a step over the tile's rows are products from shared
// memory. It takes the flow's description in the kernel parameter
// (__grid_constant__), up to kMaxF features, a signal of kMaxS, MADE widths
// of kMaxMade, network widths of kMaxMono, kMaxLinear linears a network and
// kMaxStages stages, and a shared-memory plan within 227 KB at its tile. The
// wide tier takes any shape: one thread a row, blocks of 128 rows, no shared
// memory and no synchronisation; a row's state lives in a workspace in
// device memory, one column of `stride` rows per value (slot), so
// neighbouring threads touch neighbouring addresses; the layer widths and
// the stages lie in a small device buffer. Its weights are read through the
// read-only data cache (__ldg): every thread of a warp reads the same
// address at the same time, one broadcast per warp; the MADE's F * T
// outputs are never stored together: a feature computes its T values from
// the last hidden layer when it needs them. The wrapper allocates the
// workspace and the buffer; the rows run in chunks of `stride`, one launch
// each, so the workspace stays bounded. Float32 throughout (expf, expm1f,
// logf, log1pf); no tensor cores, no TF32.
//
// Each C entry point checks its arguments, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include <vector>

namespace {

// the narrow tier's limits, mirrored in zuko_tpu_torch/ops/naf_fused.py
constexpr int kMaxF = 64;       // features
constexpr int kMaxS = 64;       // signal size
constexpr int kMaxMono = 128;   // univariate-network hidden widths
constexpr int kMaxMade = 256;   // MADE widths, the F + C inputs included
constexpr int kMaxLinear = 8;   // linears per network
constexpr int kMaxStages = 64;  // autoregressive layers and softclips together
constexpr int kThreads = 128;   // the wide tier's rows a block

constexpr float kHalfLog2Pi = 0.91893853320467274f;
// the solve (zuko_tpu/ops/naf_fused.py:62-85, 385-406, 603-654)
constexpr float kBound = 10.0f;
constexpr float kWarmR = 0.0625f;
constexpr float kDfFloor = 1e-12f;
constexpr int kCoarse = 10;  // ceil(log2(2 * 10 / 2e-2))
constexpr int kWarm = 3;     // ceil(log2(2 * 0.0625 / 2e-2))
constexpr int kNewton = 3;
constexpr int kNewtonUMNN = 4;  // sweep 0; one fewer in the warm sweeps

// Gauss-Legendre rules on [0, 1] as the UMNN integral uses them: the
// fraction (t + 1) / 2 of x at which each node evaluates the integrand, and
// the node's weight; 4 nodes at [0, 4), 8 at [4, 12), 16 at [12, 28).
// numpy.polynomial.legendre.leggauss's float64 values, rounded to float.
__constant__ float kGLPoint[28] = {
    // 4
    0.06943184420297371, 0.33000947820757187, 0.6699905217924281, 0.9305681557970262,
    // 8
    0.019855071751231912, 0.10166676129318664, 0.2372337950418355, 0.4082826787521751,
    0.5917173212478248, 0.7627662049581645, 0.8983332387068134, 0.9801449282487681,
    // 16
    0.005299532504175031, 0.0277124884633837, 0.06718439880608412, 0.1222977958224985,
    0.19106187779867811, 0.2709916111713863, 0.35919822461037054, 0.4524937450811813,
    0.5475062549188188, 0.6408017753896295, 0.7290083888286136, 0.8089381222013219,
    0.8777022041775016, 0.9328156011939159, 0.9722875115366163, 0.994700467495825};
__constant__ float kGLWeight[28] = {
    // 4
    0.3478548451374537, 0.6521451548625462, 0.6521451548625462, 0.3478548451374537,
    // 8
    0.10122853629037669, 0.22238103445337434, 0.31370664587788705, 0.36268378337836177,
    0.36268378337836177, 0.31370664587788705, 0.22238103445337434, 0.10122853629037669,
    // 16
    0.027152459411754037, 0.062253523938647706, 0.09515851168249259, 0.12462897125553403,
    0.14959598881657676, 0.16915651939500262, 0.1826034150449236, 0.18945061045506859,
    0.18945061045506859, 0.1826034150449236, 0.16915651939500262, 0.14959598881657676,
    0.12462897125553403, 0.09515851168249259, 0.062253523938647706, 0.027152459411754037};

enum Kind { kSoftclip = 0, kAR = 1 };
enum Mode { kMNN = 0, kUMNN = 1 };

struct Stage {
  int kind;
  int passes;     // autoregressive layers
  float bound;    // softclips
  long long off;  // offset of the layer's parameters in `packed` (floats)
};

// The narrow tier's description of the flow, a __grid_constant__ parameter
// (it is indexed in loops; a by-value copy would land in every thread's local
// memory). All autoregressive layers share one shape: per layer, MADE linear
// i's weights (out, in) row-major at made_off[i], its bias right after;
// network linear i as (F, out, in) at mono_off[i], its (F, out) bias right
// after. A feature has T = S (MNN) or S + 1 (UMNN, the constant last)
// outputs, T known from the kernel's mode.
struct Shape {
  int F, C, S, n_stages, n_made, n_mono;
  int made_w[kMaxLinear + 1];  // made_w[0] = F + C, made_w[n_made] = F * T
  int mono_w[kMaxLinear + 1];  // mono_w[0] = 1 + S, mono_w[n_mono] = 1
  int made_off[kMaxLinear];
  int mono_off[kMaxLinear];
  Stage st[kMaxStages];
};

// The wide tier's: the same fields, the arrays in the device buffer `desc`.
struct WideShape {
  int F, C, S, n_stages, n_made, n_mono, made_max, mono_max;
  const int* made_w;
  const int* mono_w;
  const int* made_off;
  const int* mono_off;
  const Stage* st;
};

// A slot column of the wide tier's workspace: one of a row's arrays,
// `stride` floats between consecutive elements.
struct Column {
  float* p;
  long long stride;
  __device__ __forceinline__ float& operator[](int i) const { return p[i * stride]; }
};

// The state of a row in the wide tier: the current iterate (or input) with
// its context, the MADE's activations, one feature's T outputs (the signal,
// then a UMNN's constant), its hoisted first layer, its network's
// activations (with their derivatives, MNN) and the sampler's target y, as
// columns of the workspace from column i on, in this order (the slots
// mirrored in naf_fused.py plan_naf).
struct Row {
  Column xc, a, b, sig, pre1, u, du, t, dt, y;
  __device__ __forceinline__ void init(const WideShape& s, float* work, long long stride,
                                       long long i) {
    float* p = work + i;
    const long long widths[10] = {s.F + s.C, s.made_max, s.made_max, s.S + 1, s.mono_max,
                                  s.mono_max, s.mono_max, s.mono_max, s.mono_max, s.F};
    Column* cs[10] = {&xc, &a, &b, &sig, &pre1, &u, &du, &t, &dt, &y};
    for (int k = 0; k < 10; ++k) {
      *cs[k] = {p, stride};
      p += widths[k] * stride;
    }
  }
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// The MADE's hidden ReLU layers on a[0 .. made_w[0]); returns the array that
// holds the last hidden activations (a or b).
__device__ __forceinline__ Column made_hidden(const float* __restrict__ w, const WideShape& s,
                                              Column a, Column b) {
  Column cur = a, nxt = b;
  for (int i = 0; i < s.n_made - 1; ++i) {
    const int din = s.made_w[i], dout = s.made_w[i + 1];
    const float* W = w + s.made_off[i];
    const float* bias = W + dout * din;
    for (int o = 0; o < dout; ++o) {
      const float* row = W + o * din;
      float acc = ld(bias + o);
      for (int j = 0; j < din; ++j) acc = fmaf(ld(row + j), cur[j], acc);
      nxt[o] = fmaxf(acc, 0.0f);
    }
    const Column t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Feature f's T outputs f*T .. f*T + T - 1 of the MADE's last linear into
// r.sig (the signal, then a UMNN's constant), and from the signal the hoisted
// first network layer r.pre1[k] = b1[k] + W1[k, 1:] s.
template <int kMode>
__device__ __forceinline__ void signal_and_hoist(const float* __restrict__ w, const WideShape& s,
                                                 const Column h, int f, Row& r) {
  const int T = s.S + (kMode == kUMNN);
  const int din = s.made_w[s.n_made - 1], dout = s.made_w[s.n_made];
  const float* W = w + s.made_off[s.n_made - 1];
  const float* bias = W + dout * din;
  for (int t = 0; t < T; ++t) {
    const int o = f * T + t;
    const float* row = W + o * din;
    float acc = ld(bias + o);
    for (int j = 0; j < din; ++j) acc = fmaf(ld(row + j), h[j], acc);
    r.sig[t] = acc;
  }
  const int in1 = s.mono_w[0], H1 = s.mono_w[1];
  const float* W1 = w + s.mono_off[0] + f * H1 * in1;
  const float* b1 = w + s.mono_off[0] + s.F * H1 * in1 + f * H1;
  for (int k = 0; k < H1; ++k) {
    const float* row = W1 + k * in1 + 1;
    float acc = ld(b1 + k);
    for (int t = 0; t < s.S; ++t) acc = fmaf(ld(row + t), r.sig[t], acc);
    r.pre1[k] = acc;
  }
}

// TwoWayELU of unit o of a layer of width `width`: elu(z) on the first half,
// -elu(-z) on the second; *d is its derivative, elu'(z) or elu'(-z).
__device__ __forceinline__ float two_way_elu(float z, int o, int width, float* d) {
  if (o < width / 2) {
    *d = z > 0.0f ? 1.0f : expf(z);
    return z > 0.0f ? z : expm1f(z);
  }
  *d = z < 0.0f ? 1.0f : expf(-z);
  return z < 0.0f ? z : -expm1f(-z);
}

__device__ __forceinline__ float elu(float z) { return z > 0.0f ? z : expm1f(z); }

// Feature f's monotone network at x from its hoisted first layer; with kGrad
// also its x-derivative in *g (forward mode: dz1/dx is the x column). The
// activations ping-pong between (u, du) and (t, dt).
template <bool kGrad>
__device__ __forceinline__ float monotone_net(float x, const float* __restrict__ w,
                                              const WideShape& s, int f, Row& r, float* g) {
  const int in1 = s.mono_w[0], H1 = s.mono_w[1];
  const float* W1 = w + s.mono_off[0] + f * H1 * in1;
  for (int k = 0; k < H1; ++k) {
    const float wx = ld(W1 + k * in1);
    float d;
    r.u[k] = two_way_elu(fmaf(wx, x, r.pre1[k]), k, H1, &d);
    if (kGrad) r.du[k] = d * wx;
  }
  Column cur = r.u, dcur = r.du, nxt = r.t, dnxt = r.dt;
  for (int i = 1; i < s.n_mono - 1; ++i) {
    const int din = s.mono_w[i], dout = s.mono_w[i + 1];
    const float* W = w + s.mono_off[i] + f * dout * din;
    const float* bias = w + s.mono_off[i] + s.F * dout * din + f * dout;
    for (int o = 0; o < dout; ++o) {
      const float* row = W + o * din;
      float acc = ld(bias + o), dacc = 0.0f;
      for (int j = 0; j < din; ++j) {
        const float wv = ld(row + j);
        acc = fmaf(wv, cur[j], acc);
        if (kGrad) dacc = fmaf(wv, dcur[j], dacc);
      }
      float d;
      nxt[o] = two_way_elu(acc, o, dout, &d);
      if (kGrad) dnxt[o] = d * dacc;
    }
    Column tmp = cur;
    cur = nxt;
    nxt = tmp;
    tmp = dcur;
    dcur = dnxt;
    dnxt = tmp;
  }
  const int din = s.mono_w[s.n_mono - 1];
  const float* WL = w + s.mono_off[s.n_mono - 1] + f * din;
  float acc = ld(w + s.mono_off[s.n_mono - 1] + s.F * din + f), dacc = 0.0f;
  for (int j = 0; j < din; ++j) {
    const float wv = ld(WL + j);
    acc = fmaf(wv, cur[j], acc);
    if (kGrad) dacc = fmaf(wv, dcur[j], dacc);
  }
  if (kGrad) *g = dacc;
  return acc;
}

// Feature f's UMNN integrand g(x) = exp(d / (1 + |d / 7|)), d the ELU
// network's output at [x, s], from the hoisted first layer. The activations
// ping-pong between u and t.
__device__ __forceinline__ float integrand(float x, const float* __restrict__ w,
                                           const WideShape& s, int f, Row& r) {
  const int in1 = s.mono_w[0], H1 = s.mono_w[1];
  const float* W1 = w + s.mono_off[0] + f * H1 * in1;
  for (int k = 0; k < H1; ++k) r.u[k] = elu(fmaf(ld(W1 + k * in1), x, r.pre1[k]));
  Column cur = r.u, nxt = r.t;
  for (int i = 1; i < s.n_mono - 1; ++i) {
    const int din = s.mono_w[i], dout = s.mono_w[i + 1];
    const float* W = w + s.mono_off[i] + f * dout * din;
    const float* bias = w + s.mono_off[i] + s.F * dout * din + f * dout;
    for (int o = 0; o < dout; ++o) {
      const float* row = W + o * din;
      float acc = ld(bias + o);
      for (int j = 0; j < din; ++j) acc = fmaf(ld(row + j), cur[j], acc);
      nxt[o] = elu(acc);
    }
    const Column tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  const int din = s.mono_w[s.n_mono - 1];
  const float* WL = w + s.mono_off[s.n_mono - 1] + f * din;
  float d = ld(w + s.mono_off[s.n_mono - 1] + s.F * din + f);
  for (int j = 0; j < din; ++j) d = fmaf(ld(WL + j), cur[j], d);
  return expf(d / (1.0f + fabsf(d / 7.0f)));
}

// Feature f's integral of g from 0 to x by the N-point Gauss-Legendre rule
// (N = 4, 8 or 16).
template <int N>
__device__ __forceinline__ float umnn_integral(float x, const float* __restrict__ w,
                                               const WideShape& s, int f, Row& r) {
  constexpr int at = N - 4;  // 4 -> 0, 8 -> 4, 16 -> 12
  float acc = 0.0f;
  for (int k = 0; k < N; ++k) {
    acc += kGLWeight[at + k] * integrand(x * kGLPoint[at + k], w, s, f, r);
  }
  return 0.5f * x * acc;
}

// The univariate's value (without a UMNN's constant) and, with kGrad, its
// derivative: a monotone network, or a UMNN integral by GL-N and g(x).
template <int kMode, int N, bool kGrad>
__device__ __forceinline__ float univariate(float x, const float* __restrict__ w,
                                            const WideShape& s, int f, Row& r, float* g) {
  if (kMode == kMNN) return monotone_net<kGrad>(x, w, s, f, r, g);
  const float v = umnn_integral<N>(x, w, s, f, r);
  if (kGrad) *g = integrand(x, w, s, f, r);
  return v;
}

// MADE pass on the row's xc; copies it first, so xc may change while the
// hidden activations are read.
__device__ __forceinline__ Column made_pass(const float* __restrict__ w, const WideShape& s,
                                            Row& r) {
  for (int j = 0; j < s.F + s.C; ++j) r.a[j] = r.xc[j];
  return made_hidden(w, s, r.a, r.b);
}

// The density's wide tier (the narrow tier is naf_density_tiled): rows
// [row0, row_end) of the launch; thread i takes row row0 + i and workspace
// column i.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
naf_density_kernel(const float* __restrict__ xc, float* __restrict__ out,
                   const float* __restrict__ packed, const __grid_constant__ WideShape s,
                   float* __restrict__ work, long long stride, long long row0, long long row_end) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = row0 + i;
  if (row >= row_end) return;
  const int F = s.F, D0 = s.F + s.C;
  Row r;
  r.init(s, work, stride, i);
  for (int j = 0; j < D0; ++j) r.xc[j] = xc[row * D0 + j];
  float acc = 0.0f;
  for (int si = 0; si < s.n_stages; ++si) {
    const Stage& st = s.st[si];
    if (st.kind == kSoftclip) {
      for (int f = 0; f < F; ++f) {
        const float q = fabsf(r.xc[f] / st.bound);
        acc -= 2.0f * log1pf(q);
        r.xc[f] = r.xc[f] / (1.0f + q);
      }
      continue;
    }
    const float* w = packed + st.off;
    const Column h = made_pass(w, s, r);
    for (int f = 0; f < F; ++f) {
      signal_and_hoist<kMode>(w, s, h, f, r);
      float g;
      const float v = univariate<kMode, 16, true>(r.xc[f], w, s, f, r, &g);
      r.xc[f] = kMode == kUMNN ? v + r.sig[s.S] : v;
      acc += logf(g);
    }
  }
  float sq = 0.0f;
  for (int f = 0; f < F; ++f) sq = fmaf(r.xc[f], r.xc[f], sq);
  out[row] = acc - 0.5f * sq - F * kHalfLog2Pi;
}

// Solve feature f's f(x) = target at fixed hoisted layer; x0 is the previous
// sweep's root (sweep > 0). The bisection evaluates the univariate without
// its derivative (a UMNN by GL-4), the Newton steps with it (a UMNN by GL-8,
// the last one by GL-16).
template <int kMode>
__device__ __forceinline__ float solve(float target, float x0, int sweep,
                                       const float* __restrict__ w, const WideShape& s, int f,
                                       Row& r) {
  float lo = -kBound, hi = kBound;
  int iters = kCoarse;
  if (sweep > 0) {
    const float lo0 = x0 - kWarmR, hi0 = x0 + kWarmR;
    const float flo = univariate<kMode, 4, false>(lo0, w, s, f, r, nullptr);
    const float fhi = univariate<kMode, 4, false>(hi0, w, s, f, r, nullptr);
    if (flo < target && target < fhi) {
      lo = lo0;
      hi = hi0;
    }
    iters = kWarm;
  }
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (univariate<kMode, 4, false>(mid, w, s, f, r, nullptr) < target) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  float x = 0.5f * (lo + hi);
  const int steps = kMode == kMNN ? kNewton : (sweep == 0 ? kNewtonUMNN : kNewtonUMNN - 1);
  for (int it = 0; it < steps; ++it) {
    float g, v;
    // one inlined copy of the network for a monotone net (N does not apply)
    if (kMode == kMNN || it < steps - 1) {
      v = univariate<kMode, 8, true>(x, w, s, f, r, &g);
    } else {
      v = univariate<kMode, 16, true>(x, w, s, f, r, &g);
    }
    x = fminf(fmaxf(x - (v - target) / fmaxf(g, kDfFloor), -kBound), kBound);
  }
  return x;
}

// The sampler's wide tier (the narrow tier is naf_sample_tiled): one thread a
// row, its state and its current stage's target y in the workspace.
template <int kMode, bool kLogQ>
__global__ void __launch_bounds__(kThreads)
naf_sample_kernel(const float* __restrict__ zc, float* __restrict__ xout,
                  float* __restrict__ logq, const float* __restrict__ packed,
                  const __grid_constant__ WideShape s, float* __restrict__ work,
                  long long stride, long long row0, long long row_end) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = row0 + i;
  if (row >= row_end) return;
  const int F = s.F, D0 = s.F + s.C;
  Row r;
  r.init(s, work, stride, i);
  const Column y = r.y;
  float acc = 0.0f;
  for (int f = 0; f < F; ++f) y[f] = zc[row * D0 + f];
  for (int j = F; j < D0; ++j) r.xc[j] = zc[row * D0 + j];
  if (kLogQ) {
    float sq = 0.0f;
    for (int f = 0; f < F; ++f) sq = fmaf(y[f], y[f], sq);
    acc = -0.5f * sq - F * kHalfLog2Pi;
  }
  for (int si = s.n_stages - 1; si >= 0; --si) {
    const Stage& st = s.st[si];
    if (st.kind == kSoftclip) {
      for (int f = 0; f < F; ++f) {
        y[f] = y[f] / (1.0f - fabsf(y[f] / st.bound));
        if (kLogQ) acc -= 2.0f * log1pf(fabsf(y[f] / st.bound));
      }
      continue;
    }
    const float* w = packed + st.off;
    for (int f = 0; f < F; ++f) r.xc[f] = 0.0f;
    const int sweeps = min(st.passes, F);
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      const Column h = made_pass(w, s, r);
      // Jacobi: h holds the MADE outputs of the whole previous iterate
      for (int f = 0; f < F; ++f) {
        signal_and_hoist<kMode>(w, s, h, f, r);
        const float target = kMode == kUMNN ? y[f] - r.sig[s.S] : y[f];
        r.xc[f] = solve<kMode>(target, r.xc[f], sweep, w, s, f, r);
      }
    }
    if (kLogQ) {
      const Column h = made_pass(w, s, r);
      for (int f = 0; f < F; ++f) {
        signal_and_hoist<kMode>(w, s, h, f, r);
        float g;
        if (kMode == kMNN) {
          monotone_net<true>(r.xc[f], w, s, f, r, &g);
        } else {
          g = integrand(r.xc[f], w, s, f, r);
        }
        acc += logf(g);
      }
    }
    for (int f = 0; f < F; ++f) y[f] = r.xc[f];
  }
  for (int f = 0; f < F; ++f) xout[row * F + f] = y[f];
  if (kLogQ) logq[row] = acc;
}

// ------------------------------------------------------------ the tiled kernels
//
// naf_sample_tiled is K9's narrow tier in both modes: the same function as
// naf_sample_kernel<kMode, *> (the same stages in reverse, sweeps, brackets,
// warm window and its checks, bisections, Newton steps, rules, clamps and
// kDfFloor), with every sum in the same order. With one thread a row, each
// multiply-add of the 64 x 64 hidden layer takes a weight and an activation
// from memory, and the loads bound it; but the evaluations of a solver step,
// over the rows of a tile, are evaluations of one network: a matrix product.
// A block of 512 threads owns a tile of R rows for the whole inversion (UMNN
// 64, or 32 or 16 at few rows; MNN 128, or 64 or 32; from the wrapper):
// - a row's bracket, iterate and target stay in the registers of thread r
//   (r < R), which updates them between the steps;
// - the MADE pass, the T signal values and the hoisted first layer pre1 of
//   a feature are small tile products from shared memory, laid out [unit][row];
// - the evaluations of one solver step are the rows of an activation matrix
//   in shared memory, [unit][node row], M node rows a chunk; each
//   hidden-to-hidden layer is then a register-tiled float32 product
//   (tile_layer): a thread holds a patch of 4 (or 2) rows x 8 outputs
//   (outputs cg + j ncg), its operands from shared memory in 16-byte loads
//   (the feature's weights, staged transposed once per feature and sweep
//   with a thread's outputs side by side), and writes the activation back in
//   place; one thread a node row then takes the last layer's dot.
// UMNN (tile_nodes): R rows x 4 nodes in a bisection, 8 for the warm
// window's two checks, 8 + 1 in a Newton step, 16 + 1 in the last (g(x) one
// more node); a node row is u = elu(w1x x_m + pre1[row]), the last dot gives
// g = exp(d / (1 + |d / 7|)), and the row's thread takes the Gauss-Legendre
// sum. The activations' row stride is M + 4 (M a multiple of 32), so the
// in-place write-back of a quarter warp's patches falls on distinct banks.
// MNN (tile_mnn): a step has few evaluations a row (one in a bisection, two
// in the warm check, one with its x-derivative in a Newton step), hence the
// larger tile; a patch is 2 rows of TwoWayELU values or, with the derivative,
// 2 value rows and their 2 tangent rows, which ride the same product:
// dnxt = elu'(z) (W dcur), elu' taken at the value row's pre-activation, in
// the same thread. The stride is 2 M + 4 slots (M a multiple of 16).
// 16 warps a block (one block an SM, by its shared memory) keep the SM
// issuing. Full float32 on the CUDA cores. A flow whose MADE has no hidden
// layer takes its own instantiation (kFlat), whose sweeps read a copy of
// the iterate, so that the others' code is not touched by it.
//
// naf_density_tiled is K8's narrow tier in both modes, on the same engine
// and plan: the same function as naf_density_kernel<kMode>, with every sum in
// the same order. It is the sampler's log-q pass without the solve: per
// autoregressive layer a MADE pass on the tile, then per feature the hoist
// and one evaluation with its derivative at the feature's input column
// (tile_mnn<true>: a value row and its tangent row a row of the tile;
// tile_nodes: the 16 Gauss-Legendre nodes and g(x), 17 node rows a row, and
// the row's GL-16 sum).

constexpr int kTileThreads = 512;
constexpr int kMaxNodes = 17;   // UMNN evaluations a row in one solver step: GL-16 and g(x)
constexpr int kNodeRows = 256;  // UMNN node rows a chunk, at most
constexpr int kMnnRows = 128;   // MNN value rows a chunk, at most
constexpr int kMaxShared = 232448;  // a block's shared memory on an H100 (227 KB)

// A tile's arrays in dynamic shared memory, as float offsets, and its chunk
// of node rows (tile_plan; mirrored in ops/naf_fused.py _tile_floats).
struct Tile {
  int R, lr;    // rows of a tile and log2 R
  int M, Ms;    // node rows a chunk and the activations' row stride
  int xc;       // [F + C][R]: the iterate, then the context
  int a, b;     // [MADE hidden][R], ping-pong
  int y;        // [F][R]: the stage's targets
  int sig;      // [T][R]: a feature's MADE outputs
  int pre1;     // [H1][R]: its hoisted first layer
  int xp;       // [2][R]: the step's evaluation points
  int g;        // UMNN [kMaxNodes][R]: the step's integrand values, node-major;
                // MNN [3][R]: the values at the points, then the derivative
  int act;      // [H][Ms]: node activations
  int wt;       // per middle layer [din][dout rounded to 8] and its bias
  int misc;     // the x column, the last layer and its bias (UMNN: the GL rules)
  int floats;
};

__host__ __device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }

// The MADE's hidden layers on the tile; returns the last hidden
// activations (or the input, without hidden layers). Ends synchronised.
__device__ __forceinline__ const float* made_tile(const float* __restrict__ w, const Shape& s,
                                                  const Tile& tl, const float* xc, float* a,
                                                  float* b) {
  const int R = tl.R, lr = tl.lr;
  const float* cur = xc;
  float* bufs[2] = {a, b};
  for (int i = 0; i < s.n_made - 1; ++i) {
    const int din = s.made_w[i], dout = s.made_w[i + 1];
    const float* W = w + s.made_off[i];
    const float* bias = W + dout * din;
    float* nxt = bufs[i & 1];
    for (int e = threadIdx.x; e < dout * R; e += kTileThreads) {
      const int o = e >> lr, r = e & (R - 1);
      const float* row = W + o * din;
      float acc = ld(bias + o);
      for (int j = 0; j < din; ++j) acc = fmaf(ld(row + j), cur[j * R + r], acc);
      nxt[e] = fmaxf(acc, 0.0f);
    }
    __syncthreads();
    cur = nxt;
  }
  return cur;
}

// Feature f: its T MADE outputs (the signal, then a UMNN's constant), its
// network's weights into shared memory (the x column, each middle layer
// transposed with its bias, the last layer and its bias) and the hoisted
// first layer pre1[k][r] = b1[k] + W1[k, 1:] s. Ends synchronised.
template <int kMode>
__device__ __forceinline__ void hoist_tile(const float* __restrict__ w, const Shape& s,
                                           const Tile& tl, const float* h, int f, float* sm) {
  const int R = tl.R, lr = tl.lr, T = s.S + (kMode == kUMNN);
  const int H1 = s.mono_w[1], HL = s.mono_w[s.n_mono - 1], in1 = s.mono_w[0];
  float* sig = sm + tl.sig;
  float* w1x = sm + tl.misc;
  float* wl = w1x + H1;
  __syncthreads();  // the previous feature's solve is done with them
  {
    const int din = s.made_w[s.n_made - 1];
    const float* W = w + s.made_off[s.n_made - 1];
    const float* bias = W + s.made_w[s.n_made] * din;
    for (int e = threadIdx.x; e < T * R; e += kTileThreads) {
      const int o = f * T + (e >> lr), r = e & (R - 1);
      const float* row = W + o * din;
      float acc = ld(bias + o);
      for (int j = 0; j < din; ++j) acc = fmaf(ld(row + j), h[j * R + r], acc);
      sig[e] = acc;
    }
  }
  const float* W1 = w + s.mono_off[0] + f * H1 * in1;
  const float* b1 = w + s.mono_off[0] + s.F * H1 * in1 + f * H1;
  for (int k = threadIdx.x; k < H1; k += kTileThreads) w1x[k] = ld(W1 + k * in1);
  float* wt = sm + tl.wt;
  for (int i = 1; i + 1 < s.n_mono; ++i) {
    const int din = s.mono_w[i], dout = s.mono_w[i + 1], dp = round8(dout);
    const float* W = w + s.mono_off[i] + f * dout * din;
    const float* bias = w + s.mono_off[i] + s.F * dout * din + f * dout;
    // output o = cg + j ncg of a thread's patch at 4 ncg (j / 4) + 4 cg + j % 4,
    // so its 8 outputs are two 16-byte pieces
    const int ncg = dp >> 3;
    for (int e = threadIdx.x; e < dout * din; e += kTileThreads) {
      const int o = e / din, i = e - o * din, j = o / ncg;
      wt[i * dp + (j >> 2) * 4 * ncg + 4 * (o - j * ncg) + (j & 3)] = ld(W + e);
    }
    for (int o = threadIdx.x; o < dout; o += kTileThreads) wt[din * dp + o] = ld(bias + o);
    wt += din * dp + dp;
  }
  const float* WL = w + s.mono_off[s.n_mono - 1] + f * HL;
  for (int k = threadIdx.x; k < HL; k += kTileThreads) wl[k] = ld(WL + k);
  if (threadIdx.x == 0) wl[HL] = ld(w + s.mono_off[s.n_mono - 1] + s.F * HL + f);
  __syncthreads();
  float* pre1 = sm + tl.pre1;
  for (int e = threadIdx.x; e < H1 * R; e += kTileThreads) {
    const int k = e >> lr, r = e & (R - 1);
    const float* row = W1 + k * in1 + 1;
    float acc = ld(b1 + k);
    for (int t = 0; t < s.S; ++t) acc = fmaf(ld(row + t), sig[t * R + r], acc);
    pre1[e] = acc;
  }
  __syncthreads();
}

// One hidden-to-hidden layer din -> dout on the chunk's Mc node rows, in
// place in act. A thread's patch of kPR rows x 8 outputs accumulates from the
// bias in the order of the inputs, then its activation replaces the layer's
// input: UMNN 4 rows, ELU; MNN 2 rows, TwoWayELU; MNN with kGrad 2 value rows
// and, in the patch's rows 2 and 3, their tangents, which accumulate from 0
// and take elu' at their value row's pre-activation.
template <int kMode, bool kGrad>
__device__ __forceinline__ void tile_layer(float* act, int Ms, const float* wt, int din,
                                           int dout, int Mc) {
  constexpr int kPR = (kMode == kUMNN || kGrad) ? 4 : 2;  // slots of a patch
  constexpr int kVR = kMode == kUMNN ? 4 : 2;             // node rows of a patch
  const int dp = round8(dout), ncg = dp >> 3;
  const int rg = threadIdx.x / ncg, cg = threadIdx.x - rg * ncg;
  const bool active = rg * kVR < Mc;
  float acc[kPR][8];
  if (active) {
    const float* bias = wt + din * dp;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bv = bias[cg + j * ncg];
#pragma unroll
      for (int i = 0; i < kPR; ++i) acc[i][j] = i < kVR ? bv : 0.0f;
    }
    const float* ap = act + rg * kPR;
    const float* bp = wt + 4 * cg;  // the patch's outputs, permuted by hoist_tile
#pragma unroll 2
    for (int k = 0; k < din; ++k) {
      float av[kPR];
      if constexpr (kPR == 4) {
        const float4 a = *reinterpret_cast<const float4*>(ap + k * Ms);
        av[0] = a.x, av[1] = a.y, av[2] = a.z, av[3] = a.w;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(ap + k * Ms);
        av[0] = a.x, av[1] = a.y;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(bp + k * dp);
      const float4 b1 = *reinterpret_cast<const float4*>(bp + k * dp + 4 * ncg);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kPR; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();  // every patch has read the layer's input
  if (active) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cg + j * ncg;
      if (col >= dout) continue;
      float* out = act + col * Ms + rg * kPR;
      if constexpr (kMode == kUMNN) {
        *reinterpret_cast<float4*>(out) =
            make_float4(elu(acc[0][j]), elu(acc[1][j]), elu(acc[2][j]), elu(acc[3][j]));
      } else if constexpr (kGrad) {
        float d0, d1;
        const float v0 = two_way_elu(acc[0][j], col, dout, &d0);
        const float v1 = two_way_elu(acc[1][j], col, dout, &d1);
        *reinterpret_cast<float4*>(out) = make_float4(v0, v1, d0 * acc[2][j], d1 * acc[3][j]);
      } else {
        float d;
        *reinterpret_cast<float2*>(out) = make_float2(two_way_elu(acc[0][j], col, dout, &d),
                                                      two_way_elu(acc[1][j], col, dout, &d));
      }
    }
  }
  __syncthreads();
}

// The integrand at every node of a solver step, for every row of the tile:
// P points xp[p][r], each by the N-point rule (nodes xp * t_k), and with
// `grad` the point xp[0][r] itself as node P * N. Leaves g[node][r].
// Ends synchronised.
__device__ __forceinline__ void tile_nodes(const Shape& s, const Tile& tl, float* sm, int P,
                                           int N, bool grad) {
  const int R = tl.R, lr = tl.lr, M = tl.M, Ms = tl.Ms;
  const int H1 = s.mono_w[1], HL = s.mono_w[s.n_mono - 1];
  const float* xp = sm + tl.xp;
  const float* pre1 = sm + tl.pre1;
  const float* w1x = sm + tl.misc;
  const float* wl = w1x + H1;
  const float* glp = wl + HL + 4;
  float* act = sm + tl.act;
  float* gv = sm + tl.g;
  const int pn = P * N, total = (pn + (grad ? 1 : 0)) << lr;
  const int at = N - 4, ln = N == 16 ? 4 : N == 8 ? 3 : 2;  // 4 -> 0, 8 -> 4, 16 -> 12
  const int tid = threadIdx.x;
  // the first layer: node row tid % kNodeRows, half of the units each
  const int mi = tid % kNodeRows, kh = (H1 + 1) / 2, k0 = tid / kNodeRows * kh;
  const int k1 = k0 + kh < H1 ? k0 + kh : H1;
  for (int m0 = 0; m0 < total; m0 += M) {
    const int Mc = total - m0 < M ? total - m0 : M;
    if (mi < Mc) {
      const int m = m0 + mi, node = m >> lr, r = m & (R - 1);
      const float x =
          node < pn ? xp[((node >> ln) << lr) + r] * glp[at + (node & (N - 1))] : xp[r];
#pragma unroll 4
      for (int k = k0; k < k1; ++k) act[k * Ms + mi] = elu(fmaf(w1x[k], x, pre1[(k << lr) + r]));
    }
    __syncthreads();
    const float* wt = sm + tl.wt;
    for (int i = 1; i + 1 < s.n_mono; ++i) {
      const int din = s.mono_w[i], dout = s.mono_w[i + 1];
      tile_layer<kUMNN, false>(act, Ms, wt, din, dout, Mc);
      wt += din * round8(dout) + round8(dout);
    }
    if (tid < Mc) {
      float d = wl[HL];
#pragma unroll 4
      for (int k = 0; k < HL; ++k) d = fmaf(wl[k], act[k * Ms + tid], d);
      gv[m0 + tid] = expf(d / (1.0f + fabsf(d / 7.0f)));
    }
    __syncthreads();
  }
}

// Row r's (thread r's) integral of g from 0 to xp[p][r] by the N-point rule,
// from the values tile_nodes left.
__device__ __forceinline__ float tile_integral(const Tile& tl, const float* sm, const float* glw,
                                               int p, int N) {
  const int r = threadIdx.x, at = N - 4;
  const float* gv = sm + tl.g + ((p * N) << tl.lr) + r;
  float acc = 0.0f;
  for (int k = 0; k < N; ++k) acc += glw[at + k] * gv[k << tl.lr];
  return 0.5f * sm[tl.xp + p * tl.R + r] * acc;
}

// The monotone network at P points xp[p][r] of every row of the tile: the
// values into g[p][r] and, with kGrad (P = 1), the x-derivatives into
// g[2][r] by forward mode. Value row m of a chunk lies in slot m, or with
// kGrad in slot 2 m - m % 2 with its tangent two slots on (a patch's rows
// 2 and 3). Ends synchronised.
template <bool kGrad>
__device__ __forceinline__ void tile_mnn(const Shape& s, const Tile& tl, float* sm, int P) {
  const int R = tl.R, lr = tl.lr, M = tl.M, Ms = tl.Ms;
  const int H1 = s.mono_w[1], HL = s.mono_w[s.n_mono - 1];
  const float* xp = sm + tl.xp;
  const float* pre1 = sm + tl.pre1;
  const float* w1x = sm + tl.misc;
  const float* wl = w1x + H1;
  float* act = sm + tl.act;
  float* gv = sm + tl.g;
  const int total = P << lr, tid = threadIdx.x;
  const auto slot = [](int m) { return kGrad ? 2 * m - (m & 1) : m; };
  // the first layer: node row tid % M, a share of the units each
  const int mi = tid % M, groups = kTileThreads / M, kh = (H1 + groups - 1) / groups;
  const int k0 = tid / M * kh, k1 = k0 + kh < H1 ? k0 + kh : H1;
  for (int m0 = 0; m0 < total; m0 += M) {
    const int Mc = total - m0 < M ? total - m0 : M;
    if (mi < Mc) {
      const int m = m0 + mi, sv = slot(mi);
      const float x = xp[m];  // point m >> lr, row m & (R - 1)
      const float* pr = pre1 + (m & (R - 1));
      for (int k = k0; k < k1; ++k) {
        const float wx = w1x[k];
        float d;
        act[k * Ms + sv] = two_way_elu(fmaf(wx, x, pr[k << lr]), k, H1, &d);
        if (kGrad) act[k * Ms + sv + 2] = d * wx;
      }
    }
    __syncthreads();
    const float* wt = sm + tl.wt;
    for (int i = 1; i + 1 < s.n_mono; ++i) {
      const int din = s.mono_w[i], dout = s.mono_w[i + 1];
      tile_layer<kMNN, kGrad>(act, Ms, wt, din, dout, Mc);
      wt += din * round8(dout) + round8(dout);
    }
    if (tid < Mc) {
      const float* ap = act + slot(tid);
      float v = wl[HL], g = 0.0f;
      for (int k = 0; k < HL; ++k) {
        v = fmaf(wl[k], ap[k * Ms], v);
        if (kGrad) g = fmaf(wl[k], ap[k * Ms + 2], g);
      }
      gv[m0 + tid] = v;
      if (kGrad) gv[2 * R + m0 + tid] = g;
    }
    __syncthreads();
  }
}

// Row r's (thread r's, `own`) solve of its f(x) = target at feature f's
// hoisted layer, as solve() takes it: the warm window from its previous root
// x0 (sweep > 0), the bisection, the Newton steps; every thread takes part in
// the tile's evaluations. A UMNN integrates by GL-4 in the bisection and the
// checks, GL-8 in the Newton steps but the last and GL-16 in the last.
template <int kMode>
__device__ __forceinline__ float tile_solve(const Shape& s, const Tile& tl, float* sm, bool own,
                                            float target, float x0, int sweep) {
  const int R = tl.R, tid = threadIdx.x;
  float* xp = sm + tl.xp;
  const float* gv = sm + tl.g;
  const float* glw = sm + tl.misc + s.mono_w[1] + s.mono_w[s.n_mono - 1] + 4 + 28;
  // f at the P points of xp, read back at point p
  const auto values = [&](int P) {
    if constexpr (kMode == kUMNN) {
      tile_nodes(s, tl, sm, P, 4, false);
    } else {
      tile_mnn<false>(s, tl, sm, P);
    }
  };
  const auto value = [&](int p) {
    if constexpr (kMode == kUMNN) {
      return tile_integral(tl, sm, glw, p, 4);
    } else {
      return gv[p * R + tid];
    }
  };
  float lo = -kBound, hi = kBound, x = 0.0f;
  int iters = kCoarse;
  if (sweep > 0) {
    if (own) {
      xp[tid] = x0 - kWarmR;
      xp[R + tid] = x0 + kWarmR;
    }
    __syncthreads();
    values(2);
    if (own) {
      const float flo = value(0), fhi = value(1);
      if (flo < target && target < fhi) {
        lo = xp[tid];
        hi = xp[R + tid];
      }
    }
    iters = kWarm;
  }
  for (int it = 0; it < iters; ++it) {
    if (own) xp[tid] = 0.5f * (lo + hi);
    __syncthreads();
    values(1);
    if (own) {
      if (value(0) < target) {
        lo = xp[tid];
      } else {
        hi = xp[tid];
      }
    }
  }
  if (own) x = 0.5f * (lo + hi);
  const int steps = kMode == kMNN ? kNewton : (sweep == 0 ? kNewtonUMNN : kNewtonUMNN - 1);
  for (int it = 0; it < steps; ++it) {
    if (own) xp[tid] = x;
    __syncthreads();
    float v = 0.0f, g = 0.0f;
    if constexpr (kMode == kUMNN) {
      const int N = it < steps - 1 ? 8 : 16;
      tile_nodes(s, tl, sm, 1, N, true);
      if (own) {
        v = tile_integral(tl, sm, glw, 0, N);
        g = gv[(N << tl.lr) + tid];
      }
    } else {
      tile_mnn<true>(s, tl, sm, 1);
      if (own) {
        v = gv[tid];
        g = gv[2 * R + tid];
      }
    }
    if (own) x = fminf(fmaxf(x - (v - target) / fmaxf(g, kDfFloor), -kBound), kBound);
  }
  return x;
}

// What a tiled kernel stages once: a UMNN's Gauss-Legendre rules, and zeros
// in the padded outputs of the middle layers' weights (no barrier).
template <int kMode>
__device__ __forceinline__ void tile_setup(const Shape& s, const Tile& tl, float* sm) {
  if (kMode == kUMNN) {
    float* glp = sm + tl.misc + s.mono_w[1] + s.mono_w[s.n_mono - 1] + 4;
    for (int e = threadIdx.x; e < 28; e += kTileThreads) {
      glp[e] = kGLPoint[e];
      glp[28 + e] = kGLWeight[e];
    }
  }
  for (int e = tl.wt + threadIdx.x; e < tl.misc; e += kTileThreads) sm[e] = 0.0f;
}

template <int kMode, bool kLogQ, bool kFlat>
__global__ void __launch_bounds__(kTileThreads, 1)
naf_sample_tiled(const float* __restrict__ zc, float* __restrict__ xout,
                 float* __restrict__ logq, const float* __restrict__ packed,
                 const __grid_constant__ Shape s, const __grid_constant__ Tile tl, long long n) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, R = tl.R, lr = tl.lr;
  const bool own = tid < R;  // thread r keeps row r's solver state
  const long long row0 = (long long)blockIdx.x * R;
  const int F = s.F, D0 = s.F + s.C, S = s.S;
  float* xc = sm + tl.xc;
  float* y = sm + tl.y;
  float* xp = sm + tl.xp;
  const float* gv = sm + tl.g;
  for (int e = tid; e < R * D0; e += kTileThreads) {
    const int r = e / D0, j = e - r * D0;
    const long long row = row0 + r;
    const float v = row < n ? zc[row * D0 + j] : 0.0f;
    if (j < F) {
      y[j * R + r] = v;
    } else {
      xc[j * R + r] = v;
    }
  }
  tile_setup<kMode>(s, tl, sm);
  __syncthreads();
  float acc = 0.0f;
  if (kLogQ && own) {
    float sq = 0.0f;
    for (int f = 0; f < F; ++f) sq = fmaf(y[f * R + tid], y[f * R + tid], sq);
    acc = -0.5f * sq - F * kHalfLog2Pi;
  }
  for (int si = s.n_stages - 1; si >= 0; --si) {
    const Stage& st = s.st[si];
    if (st.kind == kSoftclip) {
      if (own) {
        for (int f = 0; f < F; ++f) {
          float v = y[f * R + tid];
          v = v / (1.0f - fabsf(v / st.bound));
          y[f * R + tid] = v;
          if (kLogQ) acc -= 2.0f * log1pf(fabsf(v / st.bound));
        }
      }
      __syncthreads();
      continue;
    }
    const float* w = packed + st.off;
    for (int e = tid; e < F * R; e += kTileThreads) xc[e] = 0.0f;
    const int sweeps = min(st.passes, F);
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      __syncthreads();
      // Jacobi: h holds the MADE outputs of the whole previous iterate;
      // without a hidden layer that is the iterate itself, copied into a
      // (as made_pass does; hoist_tile's first barrier orders the copy)
      // before the sweep writes the new one into xc
      const float* h;
      if constexpr (kFlat) {
        for (int e = tid; e < D0 * R; e += kTileThreads) sm[tl.a + e] = xc[e];
        h = sm + tl.a;
      } else {
        h = made_tile(w, s, tl, xc, sm + tl.a, sm + tl.b);
      }
      for (int f = 0; f < F; ++f) {
        hoist_tile<kMode>(w, s, tl, h, f, sm);
        float target = 0.0f, x0 = 0.0f;
        if (own) {
          target = y[f * R + tid] - (kMode == kUMNN ? sm[tl.sig + S * R + tid] : 0.0f);
          x0 = xc[f * R + tid];
        }
        const float x = tile_solve<kMode>(s, tl, sm, own, target, x0, sweep);
        if (own) xc[f * R + tid] = x;
      }
    }
    if (kLogQ) {
      __syncthreads();
      const float* h = made_tile(w, s, tl, xc, sm + tl.a, sm + tl.b);
      for (int f = 0; f < F; ++f) {
        hoist_tile<kMode>(w, s, tl, h, f, sm);
        if (own) xp[tid] = xc[f * R + tid];
        __syncthreads();
        if constexpr (kMode == kUMNN) {
          tile_nodes(s, tl, sm, 0, 4, true);
          if (own) acc += logf(gv[tid]);
        } else {
          tile_mnn<true>(s, tl, sm, 1);
          if (own) acc += logf(gv[2 * R + tid]);
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < F * R; e += kTileThreads) y[e] = xc[e];
    __syncthreads();
  }
  for (int e = tid; e < R * F; e += kTileThreads) {
    const int r = e / F, f = e - r * F;
    if (row0 + r < n) xout[(row0 + r) * F + f] = y[f * R + r];
  }
  if (kLogQ && own && row0 + tid < n) logq[row0 + tid] = acc;
}

// The tiled density: thread r < R keeps row r's sum of log-Jacobians. A
// feature's output goes to y, not to xc, which the later features' inputs
// and MADE outputs (made_tile's result) still read; y replaces xc after the
// layer's last feature. Rows past n read zeros and are not written.
template <int kMode>
__global__ void __launch_bounds__(kTileThreads, 1)
naf_density_tiled(const float* __restrict__ xin, float* __restrict__ out,
                  const float* __restrict__ packed, const __grid_constant__ Shape s,
                  const __grid_constant__ Tile tl, long long n) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, R = tl.R;
  const bool own = tid < R;
  const long long row0 = (long long)blockIdx.x * R;
  const int F = s.F, D0 = s.F + s.C, S = s.S;
  float* xc = sm + tl.xc;
  float* y = sm + tl.y;
  float* xp = sm + tl.xp;
  const float* gv = sm + tl.g;
  const float* glw = sm + tl.misc + s.mono_w[1] + s.mono_w[s.n_mono - 1] + 4 + 28;
  for (int e = tid; e < R * D0; e += kTileThreads) {
    const int r = e / D0, j = e - r * D0;
    const long long row = row0 + r;
    xc[j * R + r] = row < n ? xin[row * D0 + j] : 0.0f;
  }
  tile_setup<kMode>(s, tl, sm);
  __syncthreads();
  float acc = 0.0f;
  for (int si = 0; si < s.n_stages; ++si) {
    const Stage& st = s.st[si];
    if (st.kind == kSoftclip) {
      if (own) {
        for (int f = 0; f < F; ++f) {
          const float v = xc[f * R + tid];
          const float q = fabsf(v / st.bound);
          acc -= 2.0f * log1pf(q);
          xc[f * R + tid] = v / (1.0f + q);
        }
      }
      __syncthreads();
      continue;
    }
    const float* w = packed + st.off;
    const float* h = made_tile(w, s, tl, xc, sm + tl.a, sm + tl.b);
    for (int f = 0; f < F; ++f) {
      hoist_tile<kMode>(w, s, tl, h, f, sm);
      if (own) xp[tid] = xc[f * R + tid];
      __syncthreads();
      if constexpr (kMode == kUMNN) {
        tile_nodes(s, tl, sm, 1, 16, true);
        if (own) {
          y[f * R + tid] = tile_integral(tl, sm, glw, 0, 16) + sm[tl.sig + S * R + tid];
          acc += logf(gv[(16 << tl.lr) + tid]);
        }
      } else {
        tile_mnn<true>(s, tl, sm, 1);
        if (own) {
          y[f * R + tid] = gv[tid];
          acc += logf(gv[2 * R + tid]);
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < F * R; e += kTileThreads) xc[e] = y[e];
    __syncthreads();
  }
  if (own && row0 + tid < n) {
    float sq = 0.0f;
    for (int f = 0; f < F; ++f) sq = fmaf(xc[f * R + tid], xc[f * R + tid], sq);
    out[row0 + tid] = acc - 0.5f * sq - F * kHalfLog2Pi;
  }
}

// The flow's description as the wrapper hands it over, checked; the tiers'
// shapes are made from it.
struct Desc {
  int mode, F, C, S, T, n_stages, n_made, n_mono, made_max, mono_max;
  std::vector<int> made_w, mono_w, made_off, mono_off;
  std::vector<Stage> st;
};

int describe(Desc* d, const int* kinds, const int* passes, const float* bounds,
             const long long* offs, int n_stages, const int* made_w, int n_made,
             const int* mono_w, int n_mono, int F, int C, int S, int mode) {
  if (F < 1 || C < 0 || S < 1 || n_stages < 1 || n_made < 1 || n_mono < 2 ||
      (mode != kMNN && mode != kUMNN))
    return cudaErrorInvalidValue;
  *d = Desc{mode, F, C, S, S + (mode == kUMNN), n_stages, n_made, n_mono, 0, 0,
            {}, {}, {}, {}, {}};
  if (made_w[0] != F + C || made_w[n_made] != F * d->T || mono_w[0] != 1 + S ||
      mono_w[n_mono] != 1)
    return cudaErrorInvalidValue;
  long long off = 0;
  for (int i = 0; i <= n_made; ++i) {
    if (made_w[i] < 1) return cudaErrorInvalidValue;
    d->made_w.push_back(made_w[i]);
    if (i < n_made) {
      d->made_max = made_w[i] > d->made_max ? made_w[i] : d->made_max;
      d->made_off.push_back((int)off);
      off += (long long)made_w[i + 1] * (made_w[i] + 1);
    }
  }
  for (int i = 0; i <= n_mono; ++i) {
    const bool hidden = i > 0 && i < n_mono;
    if (mono_w[i] < 1 || (hidden && mode == kMNN && mono_w[i] % 2)) return cudaErrorInvalidValue;
    d->mono_w.push_back(mono_w[i]);
    if (hidden) d->mono_max = mono_w[i] > d->mono_max ? mono_w[i] : d->mono_max;
    if (i < n_mono) {
      d->mono_off.push_back((int)off);
      off += (long long)F * mono_w[i + 1] * (mono_w[i] + 1);
    }
  }
  if (off > 0x7fffffffLL) return cudaErrorInvalidValue;  // offsets are ints
  for (int i = 0; i < n_stages; ++i) {
    const Stage st{kinds[i], passes[i], bounds[i], offs[i]};
    if ((st.kind != kSoftclip && st.kind != kAR) || (st.kind == kAR && st.passes < 1) ||
        (st.kind == kSoftclip && !(st.bound > 0.0f)))
      return cudaErrorInvalidValue;
    d->st.push_back(st);
  }
  return cudaSuccess;
}

bool fits_narrow(const Desc& d) {
  return d.F <= kMaxF && d.S <= kMaxS && d.n_stages <= kMaxStages && d.n_made <= kMaxLinear &&
         d.n_mono <= kMaxLinear && d.made_max <= kMaxMade && d.mono_max <= kMaxMono;
}

Shape narrow_shape(const Desc& d) {
  Shape s;
  s.F = d.F;
  s.C = d.C;
  s.S = d.S;
  s.n_stages = d.n_stages;
  s.n_made = d.n_made;
  s.n_mono = d.n_mono;
  for (int i = 0; i <= d.n_made; ++i) s.made_w[i] = d.made_w[i];
  for (int i = 0; i <= d.n_mono; ++i) s.mono_w[i] = d.mono_w[i];
  for (int i = 0; i < d.n_made; ++i) s.made_off[i] = d.made_off[i];
  for (int i = 0; i < d.n_mono; ++i) s.mono_off[i] = d.mono_off[i];
  for (int i = 0; i < d.n_stages; ++i) s.st[i] = d.st[i];
  return s;
}

// The tiled kernels' shared memory for tiles of R rows (each array from a
// 16-byte boundary; mirrored in ops/naf_fused.py _tile_floats). The node
// rows of a chunk: UMNN at most 256, MNN at most 128 value rows (their
// tangent rows beside them), and at most one patch a thread in the widest
// middle layer.
Tile tile_plan(const Desc& d, int R) {
  Tile t{};
  t.R = R;
  while ((1 << t.lr) < R) ++t.lr;
  int mh = 0, hmax = 0, hp = 8, wt = 0;
  for (int i = 1; i < d.n_made; ++i) mh = d.made_w[i] > mh ? d.made_w[i] : mh;
  for (int i = 1; i < d.n_mono; ++i) hmax = d.mono_w[i] > hmax ? d.mono_w[i] : hmax;
  for (int i = 1; i + 1 < d.n_mono; ++i) {
    const int dp = round8(d.mono_w[i + 1]);
    hp = dp > hp ? dp : hp;
    wt += d.mono_w[i] * dp + dp;
  }
  const bool umnn = d.mode == kUMNN;
  if (umnn) {
    t.M = 16384 / hp / 32 * 32;
    t.M = t.M < kNodeRows ? t.M : kNodeRows;
    t.Ms = t.M + 4;
  } else {
    t.M = 8192 / hp / 16 * 16;
    t.M = t.M < kMnnRows ? t.M : kMnnRows;
    t.Ms = 2 * t.M + 4;
  }
  int at = 0;
  auto take = [&at](int floats) {
    const int off = at;
    at += (floats + 3) / 4 * 4;
    return off;
  };
  t.xc = take((d.F + d.C) * R);
  t.a = take((mh > 0 ? mh : d.F + d.C) * R);  // without hidden layers, the sampler's copy
  t.b = take(mh * R);
  t.y = take(d.F * R);
  t.sig = take(d.T * R);
  t.pre1 = take(d.mono_w[1] * R);
  t.xp = take(2 * R);
  t.g = take((umnn ? kMaxNodes : 3) * R);
  t.act = take(hmax * t.Ms);
  t.wt = take(wt);
  t.misc = take(d.mono_w[1] + d.mono_w[d.n_mono - 1] + 4 + (umnn ? 56 : 0));
  t.floats = at;
  return t;
}

// What a launch needs besides the flow: the input, the outputs, the packed
// parameters, the rows, the tier, the wide tier's workspace (work_floats
// floats, `stride` rows a launch) and descriptor buffer (desc_bytes bytes).
struct Launch {
  const float* in;
  float* out0;
  float* out1;
  const float* packed;
  long long n;
  int wide;
  float* work;
  long long work_floats, stride;
  void* desc;
  long long desc_bytes;
  cudaStream_t stream;
};

enum Op { kDensity = 0, kSample = 1, kSampleLogQ = 2 };

// The wide tier: the rows in chunks of `stride`, one launch each.
template <int kMode>
int launch_wide(int op, const Launch& l, const WideShape& s, long long stride) {
  for (long long row0 = 0; row0 < l.n; row0 += stride) {
    const long long row_end = row0 + stride < l.n ? row0 + stride : l.n;
    const unsigned blocks = (unsigned)((row_end - row0 + kThreads - 1) / kThreads);
    if (op == kDensity) {
      naf_density_kernel<kMode><<<blocks, kThreads, 0, l.stream>>>(
          l.in, l.out0, l.packed, s, l.work, stride, row0, row_end);
    } else {
      if (op == kSampleLogQ) {
        naf_sample_kernel<kMode, true><<<blocks, kThreads, 0, l.stream>>>(
            l.in, l.out0, l.out1, l.packed, s, l.work, stride, row0, row_end);
      } else {
        naf_sample_kernel<kMode, false><<<blocks, kThreads, 0, l.stream>>>(
            l.in, l.out0, nullptr, l.packed, s, l.work, stride, row0, row_end);
      }
    }
    const int rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

// The narrow tier: one block of kTileThreads a tile of R rows (UMNN 16, 32
// or 64, MNN 32, 64 or 128), its shared memory from tile_plan.
template <int kMode, bool kFlat>
auto sample_tiled(bool log_q) {
  return log_q ? naf_sample_tiled<kMode, true, kFlat> : naf_sample_tiled<kMode, false, kFlat>;
}

template <int kMode>
int launch_tiled(int op, const Launch& l, const Desc& d, const Shape& s, int R) {
  if (kMode == kUMNN ? (R != 16 && R != 32 && R != 64) : (R != 32 && R != 64 && R != 128))
    return cudaErrorInvalidValue;
  const Tile t = tile_plan(d, R);
  const int bytes = 4 * t.floats;
  const long long blocks = (l.n + R - 1) / R;
  if (bytes > kMaxShared || blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (l.n == 0) return cudaSuccess;
  int rc;
  if (op == kDensity) {
    rc = cudaFuncSetAttribute(naf_density_tiled<kMode>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return rc;
    naf_density_tiled<kMode><<<(unsigned)blocks, kTileThreads, bytes, l.stream>>>(
        l.in, l.out0, l.packed, s, t, l.n);
    return cudaGetLastError();
  }
  auto kernel = s.n_made == 1 ? sample_tiled<kMode, true>(op == kSampleLogQ)
                              : sample_tiled<kMode, false>(op == kSampleLogQ);
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return rc;
  kernel<<<(unsigned)blocks, kTileThreads, bytes, l.stream>>>(l.in, l.out0, l.out1, l.packed, s,
                                                              t, l.n);
  return cudaGetLastError();
}

// Bytes of the wide tier's descriptor buffer: made_w, mono_w, made_off,
// mono_off (ints), then the stages from a 16-byte boundary (bounded from
// above in naf_fused.py plan_naf).
long long stage_at(const Desc& d) {
  const long long ints = 2LL * (d.n_made + d.n_mono) + 2;
  return (ints * (long long)sizeof(int) + 15) / 16 * 16;
}

int run(int op, int mode, const Launch& l, const Desc& d, int tile) {
  if (l.n < 0) return cudaErrorInvalidValue;
  if (!l.wide) {
    if (!fits_narrow(d)) return cudaErrorInvalidValue;
    const Shape s = narrow_shape(d);
    return mode == kUMNN ? launch_tiled<kUMNN>(op, l, d, s, tile)
                         : launch_tiled<kMNN>(op, l, d, s, tile);
  }
  const long long at = stage_at(d);
  const long long need = at + (long long)d.n_stages * (long long)sizeof(Stage);
  const long long slots = (long long)(d.F + d.C) + 2LL * d.made_max + (d.S + 1) +
                          5LL * d.mono_max + d.F;  // the fields of Row
  if (l.desc == nullptr || l.desc_bytes < need || l.work == nullptr || l.stride < 1 ||
      slots * l.stride > l.work_floats)
    return cudaErrorInvalidValue;
  // the host image of the buffer, copied in one transfer; a pageable source
  // is staged before cudaMemcpyAsync returns, so the image may go
  std::vector<unsigned char> image((size_t)need, 0);
  int* iw = (int*)image.data();
  for (int v : d.made_w) *iw++ = v;
  for (int v : d.mono_w) *iw++ = v;
  for (int v : d.made_off) *iw++ = v;
  for (int v : d.mono_off) *iw++ = v;
  memcpy(image.data() + at, d.st.data(), d.st.size() * sizeof(Stage));
  int rc = cudaMemcpyAsync(l.desc, image.data(), (size_t)need, cudaMemcpyHostToDevice, l.stream);
  if (rc != cudaSuccess) return rc;
  const int* dw = (const int*)l.desc;
  const WideShape ws{d.F, d.C, d.S, d.n_stages, d.n_made, d.n_mono, d.made_max, d.mono_max,
                     dw, dw + d.n_made + 1, dw + d.n_made + d.n_mono + 2,
                     dw + 2 * d.n_made + d.n_mono + 2,
                     (const Stage*)((const unsigned char*)l.desc + at)};
  return mode == kUMNN ? launch_wide<kUMNN>(op, l, ws, l.stride)
                       : launch_wide<kMNN>(op, l, ws, l.stride);
}

}  // namespace

// out (n,) = log_prob of xc (n, F + C). `packed` holds each autoregressive
// layer's parameters at offs[i] in the layout of Shape; kinds[i] is 0 for a
// softclip of bound bounds[i], 1 for an autoregressive layer of passes[i].
// mode 0: monotone networks (NAF), 1: UMNN integrands (UNAF). wide 0: the
// narrow tier, the tiled kernel with tiles of `tile` rows (UMNN 16, 32 or 64;
// MNN 32, 64 or 128; work and desc unused); 1: the wide tier, with a
// workspace of work_floats floats for `stride` rows a launch and a
// descriptor buffer of desc_bytes bytes, both on the device (tile unused).
extern "C" int naf_density_f32(const float* xc, float* out, const float* packed,
                               const int* kinds, const int* passes, const float* bounds,
                               const long long* offs, int n_stages, const int* made_w,
                               int n_made, const int* mono_w, int n_mono, int F, int C, int S,
                               int mode, long long n, int wide, float* work,
                               long long work_floats, long long stride, void* desc,
                               long long desc_bytes, int tile, void* stream) {
  Desc d;
  const int rc = describe(&d, kinds, passes, bounds, offs, n_stages, made_w, n_made, mono_w,
                          n_mono, F, C, S, mode);
  if (rc != cudaSuccess) return rc;
  return run(kDensity, mode,
             {xc, out, nullptr, packed, n, wide, work, work_floats, stride, desc, desc_bytes,
              (cudaStream_t)stream},
             d, tile);
}

// xout (n, F) = T^-1(z) of zc = [z, c] (n, F + C), and logq (n,) = log q(xout)
// unless logq is null; the arguments as naf_density_f32's.
extern "C" int naf_sample_f32(const float* zc, float* xout, float* logq, const float* packed,
                              const int* kinds, const int* passes, const float* bounds,
                              const long long* offs, int n_stages, const int* made_w,
                              int n_made, const int* mono_w, int n_mono, int F, int C, int S,
                              int mode, long long n, int wide, float* work,
                              long long work_floats, long long stride, void* desc,
                              long long desc_bytes, int tile, void* stream) {
  Desc d;
  const int rc = describe(&d, kinds, passes, bounds, offs, n_stages, made_w, n_made, mono_w,
                          n_mono, F, C, S, mode);
  if (rc != cudaSuccess) return rc;
  return run(logq != nullptr ? kSampleLogQ : kSample, mode,
             {zc, xout, logq, packed, n, wide, work, work_floats, stride, desc, desc_bytes,
              (cudaStream_t)stream},
             d, tile);
}

extern "C" const char* naf_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
