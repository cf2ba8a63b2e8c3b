// Whole-flow neural autoregressive flow (NAF) kernels for Hopper (sm_90a),
// for the monotone-network (MNN) univariate.
//
// naf_density replaces the TPU kernel zuko_tpu/ops/naf_fused.py::_naf_density_impl
// (pallas_call at :949; kernel body _naf_density_kernel_T :821, math
// _naf_density_math_T :657): log_prob of a NAF in one launch. Per
// autoregressive layer, the MADE pass on the layer's input; then per feature f
// its S signal outputs, the monotone network's first layer split into its
// signal part pre1 = W1[:, 1:] s + b1 (hoisted) and its x column, the network
// and its x-derivative g by forward mode through the TwoWayELU layers. The
// output is the feature's new value and log g its log-Jacobian. A softclip
// x / (1 + |x / B|) adds -2 log1p(|x / B|) per feature; the standard-normal
// base term closes the sum.
//
// naf_sample replaces zuko_tpu/ops/naf_fused.py::_naf_sample_core (pallas_call
// at :1128; kernel body _naf_kernel_T :802, solver _ar_inverse_sweeps_T :492):
// the whole inversion, stages in reverse. A softclip inverts as
// y / (1 - |y / B|). An autoregressive layer takes min(passes, F) sweeps, each
// one MADE pass on the current iterate and then, feature by feature, the
// hoist and the solve of f(x) = y. Within a sweep the features are
// independent at fixed MADE outputs, so this equals the TPU's all-features-at-
// once loop while only one feature's H1 hoisted values are live. Sweep 0
// bisects [-10, 10] 10 times; later sweeps bracket the previous root by
// +-0.0625, checked by 2 evaluations (a row whose root left the window takes
// the full bracket), and bisect 3 times. Then 3 Newton steps
// x - (f - y) / max(f', 1e-12), clamped to [-10, 10]. With kLogQ it also
// returns log q of the returned point: base(z), each softclip's forward ladj
// at its solved input, and per layer one more MADE pass and log g at the
// solved x.
//
// What bounds them on an H100: operations. A density row of the flagship
// NAF(6, transforms=3, signal=16), 64x64 MADE and monotone nets 17-64-64-1,
// costs about 0.4M flops against 28 bytes; a sample row about 11.6M (per
// layer and feature 35 plain evaluations and 18 with the derivative, 6
// sweeps of MADE passes and hoists).
//
// Design (simple and right first): one thread per row, blocks of 128 rows,
// no shared memory and no synchronisation. Weights are read through the
// read-only data cache (__ldg): every thread of a warp reads the same
// address at the same time, one broadcast per warp, and one layer's weights
// (172 KB for the flagship: 6 monotone nets of 5.4K floats and a MADE of
// 10.8K) stay in L1 and L2 across the block's rows. A row's state lives in
// per-thread arrays (local memory): the MADE's input and hidden activations,
// one feature's signal, hoisted layer and monotone activations with their
// derivatives. The MADE's F * S outputs are never stored together: a feature
// computes its S signal values from the last hidden layer when it needs them.
// Float32 throughout (expf, expm1f, logf, log1pf); no tensor cores, no TF32.
//
// Each C entry point checks its arguments, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

// limits, mirrored in zuko_tpu_torch/ops/naf_fused.py
constexpr int kMaxF = 64;       // features
constexpr int kMaxS = 64;       // signal size
constexpr int kMaxMono = 128;   // monotone-net hidden widths
constexpr int kMaxMade = 256;   // MADE widths, the F + C inputs included
constexpr int kMaxLinear = 8;   // linears per network
constexpr int kMaxStages = 64;  // autoregressive layers and softclips together
constexpr int kThreads = 128;

constexpr float kHalfLog2Pi = 0.91893853320467274f;
// the solve (zuko_tpu/ops/naf_fused.py:62-80, 603-654)
constexpr float kBound = 10.0f;
constexpr float kWarmR = 0.0625f;
constexpr float kDfFloor = 1e-12f;
constexpr int kCoarse = 10;  // ceil(log2(2 * 10 / 2e-2))
constexpr int kWarm = 3;     // ceil(log2(2 * 0.0625 / 2e-2))
constexpr int kNewton = 3;

enum Kind { kSoftclip = 0, kAR = 1 };

struct Stage {
  int kind;
  int passes;     // autoregressive layers
  float bound;    // softclips
  long long off;  // offset of the layer's parameters in `packed` (floats)
};

// The kernels take it as a __grid_constant__ parameter (it is indexed in
// loops; a by-value copy would land in every thread's local memory). All
// autoregressive layers share one shape: per layer, MADE linear i's weights
// (out, in) row-major at made_off[i], its bias right after; monotone linear i
// as (F, out, in) at mono_off[i], its (F, out) bias right after.
struct Shape {
  int F, C, S, n_stages, n_made, n_mono;
  int made_w[kMaxLinear + 1];  // made_w[0] = F + C, made_w[n_made] = F * S
  int mono_w[kMaxLinear + 1];  // mono_w[0] = 1 + S, mono_w[n_mono] = 1
  int made_off[kMaxLinear];
  int mono_off[kMaxLinear];
  Stage st[kMaxStages];
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// The MADE's hidden ReLU layers on a[0 .. made_w[0]); returns the buffer that
// holds the last hidden activations (a or b).
__device__ __forceinline__ const float* made_hidden(const float* __restrict__ w, const Shape& s,
                                                    float* a, float* b) {
  float* cur = a;
  float* nxt = b;
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
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Feature f's signal, outputs f*S .. f*S + S - 1 of the MADE's last linear,
// and from it the hoisted first monotone layer pre1[k] = b1[k] + W1[k, 1:] s.
__device__ __forceinline__ void signal_and_hoist(const float* __restrict__ w, const Shape& s,
                                                 const float* h, int f, float* sig,
                                                 float* pre1) {
  const int din = s.made_w[s.n_made - 1], dout = s.made_w[s.n_made];
  const float* W = w + s.made_off[s.n_made - 1];
  const float* bias = W + dout * din;
  for (int t = 0; t < s.S; ++t) {
    const int o = f * s.S + t;
    const float* row = W + o * din;
    float acc = ld(bias + o);
    for (int j = 0; j < din; ++j) acc = fmaf(ld(row + j), h[j], acc);
    sig[t] = acc;
  }
  const int in1 = s.mono_w[0], H1 = s.mono_w[1];
  const float* W1 = w + s.mono_off[0] + f * H1 * in1;
  const float* b1 = w + s.mono_off[0] + s.F * H1 * in1 + f * H1;
  for (int k = 0; k < H1; ++k) {
    const float* row = W1 + k * in1 + 1;
    float acc = ld(b1 + k);
    for (int t = 0; t < s.S; ++t) acc = fmaf(ld(row + t), sig[t], acc);
    pre1[k] = acc;
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

// Feature f's monotone network at x from its hoisted first layer; with kGrad
// also its x-derivative in *g (forward mode: dz1/dx is the x column). The
// activations ping-pong between (u, du) and (t, dt).
template <bool kGrad>
__device__ __forceinline__ float monotone(float x, const float* __restrict__ w, const Shape& s,
                                          int f, const float* pre1, float* u, float* du,
                                          float* t, float* dt, float* g) {
  const int in1 = s.mono_w[0], H1 = s.mono_w[1];
  const float* W1 = w + s.mono_off[0] + f * H1 * in1;
  for (int k = 0; k < H1; ++k) {
    const float wx = ld(W1 + k * in1);
    float d;
    u[k] = two_way_elu(fmaf(wx, x, pre1[k]), k, H1, &d);
    if (kGrad) du[k] = d * wx;
  }
  float* cur = u;
  float* dcur = du;
  float* nxt = t;
  float* dnxt = dt;
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
    float* tmp = cur;
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

// The per-thread state of a row.
struct Row {
  float xc[kMaxMade];  // the current iterate (or input) and the context
  float a[kMaxMade], b[kMaxMade];
  float sig[kMaxS], pre1[kMaxMono];
  float u[kMaxMono], du[kMaxMono], t[kMaxMono], dt[kMaxMono];
};

// MADE pass on the row's xc; copies it first, so xc may change while the
// hidden activations are read.
__device__ __forceinline__ const float* made_pass(const float* __restrict__ w, const Shape& s,
                                                  Row& r) {
  for (int j = 0; j < s.F + s.C; ++j) r.a[j] = r.xc[j];
  return made_hidden(w, s, r.a, r.b);
}

__global__ void __launch_bounds__(kThreads)
naf_density_kernel(const float* __restrict__ xc, float* __restrict__ out,
                   const float* __restrict__ packed, const __grid_constant__ Shape s,
                   long long n) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int F = s.F, D0 = s.F + s.C;
  Row r;
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
    const float* h = made_pass(w, s, r);
    for (int f = 0; f < F; ++f) {
      signal_and_hoist(w, s, h, f, r.sig, r.pre1);
      float g;
      r.xc[f] = monotone<true>(r.xc[f], w, s, f, r.pre1, r.u, r.du, r.t, r.dt, &g);
      acc += logf(g);
    }
  }
  float sq = 0.0f;
  for (int f = 0; f < F; ++f) sq = fmaf(r.xc[f], r.xc[f], sq);
  out[row] = acc - 0.5f * sq - F * kHalfLog2Pi;
}

// Solve feature f's f(x) = target at fixed hoisted layer; x0 is the previous
// sweep's root (sweep > 0).
__device__ __forceinline__ float solve(float target, float x0, int sweep,
                                       const float* __restrict__ w, const Shape& s, int f,
                                       Row& r) {
  float lo = -kBound, hi = kBound;
  int iters = kCoarse;
  if (sweep > 0) {
    const float lo0 = x0 - kWarmR, hi0 = x0 + kWarmR;
    const float flo = monotone<false>(lo0, w, s, f, r.pre1, r.u, r.du, r.t, r.dt, nullptr);
    const float fhi = monotone<false>(hi0, w, s, f, r.pre1, r.u, r.du, r.t, r.dt, nullptr);
    if (flo < target && target < fhi) {
      lo = lo0;
      hi = hi0;
    }
    iters = kWarm;
  }
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (monotone<false>(mid, w, s, f, r.pre1, r.u, r.du, r.t, r.dt, nullptr) < target) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  float x = 0.5f * (lo + hi);
  for (int it = 0; it < kNewton; ++it) {
    float g;
    const float v = monotone<true>(x, w, s, f, r.pre1, r.u, r.du, r.t, r.dt, &g);
    x = fminf(fmaxf(x - (v - target) / fmaxf(g, kDfFloor), -kBound), kBound);
  }
  return x;
}

template <bool kLogQ>
__global__ void __launch_bounds__(kThreads)
naf_sample_kernel(const float* __restrict__ zc, float* __restrict__ xout,
                  float* __restrict__ logq, const float* __restrict__ packed,
                  const __grid_constant__ Shape s, long long n) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int F = s.F, D0 = s.F + s.C;
  Row r;
  float y[kMaxF];  // the current stage's target
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
      const float* h = made_pass(w, s, r);
      // Jacobi: h holds the MADE outputs of the whole previous iterate
      for (int f = 0; f < F; ++f) {
        signal_and_hoist(w, s, h, f, r.sig, r.pre1);
        r.xc[f] = solve(y[f], r.xc[f], sweep, w, s, f, r);
      }
    }
    if (kLogQ) {
      const float* h = made_pass(w, s, r);
      for (int f = 0; f < F; ++f) {
        signal_and_hoist(w, s, h, f, r.sig, r.pre1);
        float g;
        monotone<true>(r.xc[f], w, s, f, r.pre1, r.u, r.du, r.t, r.dt, &g);
        acc += logf(g);
      }
    }
    for (int f = 0; f < F; ++f) y[f] = r.xc[f];
  }
  for (int f = 0; f < F; ++f) xout[row * F + f] = y[f];
  if (kLogQ) logq[row] = acc;
}

// Fill the kernel's description of the flow from the wrapper's arrays and
// check it against the limits.
int make_shape(Shape* s, const int* kinds, const int* passes, const float* bounds,
               const long long* offs, int n_stages, const int* made_w, int n_made,
               const int* mono_w, int n_mono, int F, int C, int S) {
  if (F < 1 || F > kMaxF || C < 0 || S < 1 || S > kMaxS || n_stages < 1 ||
      n_stages > kMaxStages || n_made < 1 || n_made > kMaxLinear || n_mono < 2 ||
      n_mono > kMaxLinear)
    return cudaErrorInvalidValue;
  s->F = F;
  s->C = C;
  s->S = S;
  s->n_stages = n_stages;
  s->n_made = n_made;
  s->n_mono = n_mono;
  if (made_w[0] != F + C || made_w[n_made] != F * S || mono_w[0] != 1 + S || mono_w[n_mono] != 1)
    return cudaErrorInvalidValue;
  int off = 0;
  for (int i = 0; i <= n_made; ++i) {
    if (made_w[i] < 1 || (i < n_made && made_w[i] > kMaxMade)) return cudaErrorInvalidValue;
    s->made_w[i] = made_w[i];
    if (i < n_made) {
      s->made_off[i] = off;
      off += made_w[i + 1] * (made_w[i] + 1);
    }
  }
  for (int i = 0; i <= n_mono; ++i) {
    if (mono_w[i] < 1 || (i > 0 && i < n_mono && (mono_w[i] > kMaxMono || mono_w[i] % 2)))
      return cudaErrorInvalidValue;
    s->mono_w[i] = mono_w[i];
    if (i < n_mono) {
      s->mono_off[i] = off;
      off += F * mono_w[i + 1] * (mono_w[i] + 1);
    }
  }
  for (int i = 0; i < n_stages; ++i) {
    Stage& st = s->st[i];
    st.kind = kinds[i];
    st.passes = passes[i];
    st.bound = bounds[i];
    st.off = offs[i];
    if ((st.kind != kSoftclip && st.kind != kAR) || (st.kind == kAR && st.passes < 1) ||
        (st.kind == kSoftclip && !(st.bound > 0.0f)))
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// out (n,) = log_prob of xc (n, F + C). `packed` holds each autoregressive
// layer's parameters at offs[i] in the layout of Shape; kinds[i] is 0 for a
// softclip of bound bounds[i], 1 for an autoregressive layer of passes[i].
extern "C" int naf_density_f32(const float* xc, float* out, const float* packed,
                               const int* kinds, const int* passes, const float* bounds,
                               const long long* offs, int n_stages, const int* made_w,
                               int n_made, const int* mono_w, int n_mono, int F, int C, int S,
                               long long n, void* stream) {
  Shape s;
  int rc = make_shape(&s, kinds, passes, bounds, offs, n_stages, made_w, n_made, mono_w, n_mono,
                      F, C, S);
  if (rc != cudaSuccess) return rc;
  if (n <= 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  naf_density_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(xc, out, packed, s, n);
  return cudaGetLastError();
}

// xout (n, F) = T^-1(z) of zc = [z, c] (n, F + C), and logq (n,) = log q(xout)
// unless logq is null.
extern "C" int naf_sample_f32(const float* zc, float* xout, float* logq, const float* packed,
                              const int* kinds, const int* passes, const float* bounds,
                              const long long* offs, int n_stages, const int* made_w,
                              int n_made, const int* mono_w, int n_mono, int F, int C, int S,
                              long long n, void* stream) {
  Shape s;
  int rc = make_shape(&s, kinds, passes, bounds, offs, n_stages, made_w, n_made, mono_w, n_mono,
                      F, C, S);
  if (rc != cudaSuccess) return rc;
  if (n <= 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (logq != nullptr) {
    naf_sample_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(zc, xout, logq,
                                                                           packed, s, n);
  } else {
    naf_sample_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(zc, xout, nullptr,
                                                                            packed, s, n);
  }
  return cudaGetLastError();
}

extern "C" const char* naf_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
