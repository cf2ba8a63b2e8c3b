// Whole-flow NSF/MAF kernels for Hopper (sm_90a).
//
// nsf_density replaces the TPU kernel zuko_tpu/ops/nsf_fused.py::_fused_impl
// (pallas_call at :1842; math _full_math_T :1268): log_prob of an
// autoregressive flow, every MADE hyper pass, every univariate forward and
// its log-Jacobian, plus the standard-normal base term, in one launch.
//
// nsf_sample replaces zuko_tpu/ops/nsf_fused.py::_sample_core (pallas_call at
// :1658; math _sample_math_T :1348): the whole autoregressive inversion,
// layers in reverse, min(passes, F) Jacobi sweeps per layer (each sweep
// evaluates the hyper-net on the whole current iterate, then inverts every
// feature in closed form), and with kLogQ the log-density of the returned
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
// Design (simple and right first): one thread per batch row, blocks of 128
// rows. Each block stages one AR layer's pre-masked weights and biases into
// dynamic shared memory (about 53 KB for the flagship), so every weight is
// read from device memory once per block and layer, and a warp's 32 threads
// read the same weight at the same time (a shared-memory broadcast). The
// hidden activations live in per-thread local memory. For each feature the
// thread computes only that feature's T parameters of the last linear
// (T = 3K - 1 for the spline, 2 for the affine) and evaluates the
// univariate at once, so the F * T outputs never exist together.
//
// Each C entry point checks its arguments, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "rqs.cuh"

namespace {

// limits, mirrored in zuko_tpu_torch/ops/nsf_fused.py
constexpr int kMaxWidth = 256;  // widest hyper layer, F + C inputs included
constexpr int kMaxBins = 32;
constexpr int kMaxT = 3 * kMaxBins - 1;
constexpr int kMaxLinear = 8;
constexpr int kMaxLayers = 64;
constexpr int kThreads = 128;
constexpr float kHalfLog2Pi = 0.91893853320467274f;

enum Univariate { kAffine = 0, kRQS = 1 };

struct Shape {
  int n_lin;         // linears per hyper-net
  int n_ar;          // autoregressive layers
  int F, C, K, T;    // features, context, bins, parameters per feature
  int univ;          // Univariate
  int layer_floats;  // floats of one layer's packed [W0, b0, W1, b1, ...]
  int last_off;      // offset of the last linear's weights in a layer
  float bound, log_s;
  int widths[kMaxLinear + 1];
  int passes[kMaxLayers];
};

__device__ __forceinline__ void stage_layer(float* smem, const float* __restrict__ params,
                                            const Shape& s, int layer) {
  const float* src = params + (size_t)layer * s.layer_floats;
  for (int i = threadIdx.x; i < s.layer_floats; i += blockDim.x) smem[i] = src[i];
}

// The hidden ReLU layers, from a[0 .. widths[0]) on; returns the buffer that
// holds the last hidden activations (a or b).
__device__ __forceinline__ const float* hidden_layers(const float* w, const Shape& s, float* a,
                                                      float* b) {
  float* cur = a;
  float* nxt = b;
  for (int i = 0; i < s.n_lin - 1; ++i) {
    const int din = s.widths[i], dout = s.widths[i + 1];
    const float* bias = w + dout * din;
    for (int o = 0; o < dout; ++o) {
      const float* row = w + o * din;
      float acc = bias[o];
      for (int j = 0; j < din; ++j) acc = fmaf(row[j], cur[j], acc);
      nxt[o] = fmaxf(acc, 0.0f);
    }
    w = bias + dout;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Feature f's T raw parameters: rows f*T .. f*T + T - 1 of the last linear.
__device__ __forceinline__ void feature_params(const float* w, const Shape& s, const float* h,
                                               int f, float* p) {
  const int din = s.widths[s.n_lin - 1], dout = s.widths[s.n_lin];
  const float* bias = w + dout * din;
  for (int t = 0; t < s.T; ++t) {
    const int o = f * s.T + t;
    const float* row = w + o * din;
    float acc = bias[o];
    for (int j = 0; j < din; ++j) acc = fmaf(row[j], h[j], acc);
    p[t] = acc;
  }
}

// Raw (widths, heights, derivatives) -> K + 1 knots: slope clamp, softmax,
// cumsum (zuko_tpu/transforms.py MonotonicRQSTransform).
__device__ __forceinline__ void rqs_knots(float* p, const Shape& s, float* xs, float* ys,
                                          float* ds) {
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

__device__ __forceinline__ float affine_log_scale(const float* p, float ls) {
  return p[1] / (1.0f + fabsf(p[1] / ls));
}

// Univariate forward of one feature from its raw parameters p (overwritten).
__device__ __forceinline__ float univ_forward(float x, float* p, const Shape& s, float* ladj) {
  if (s.univ == kAffine) {
    const float lsc = affine_log_scale(p, s.log_s);
    *ladj = lsc;
    return x * expf(lsc) + p[0];
  }
  float xs[kMaxBins + 1], ys[kMaxBins + 1], ds[kMaxBins + 1];
  rqs_knots(p, s, xs, ys, ds);
  return rqs::forward(x, xs, ys, ds, s.K, ladj);
}

__device__ __forceinline__ float univ_inverse(float y, float* p, const Shape& s) {
  if (s.univ == kAffine) {
    return (y - p[0]) / expf(affine_log_scale(p, s.log_s));
  }
  float xs[kMaxBins + 1], ys[kMaxBins + 1], ds[kMaxBins + 1];
  rqs_knots(p, s, xs, ys, ds);
  return rqs::inverse<false>(y, xs, ys, ds, s.K, nullptr);
}

// kRaw false: out[row] = log_prob. kRaw true (nsf_apply): y[row, :] = T(x)
// and out[row] = the bare sum of ladjs.
template <bool kRaw>
__global__ void __launch_bounds__(kThreads)
nsf_density_kernel(const float* __restrict__ xc, float* __restrict__ y,
                   float* __restrict__ out, const float* __restrict__ params, Shape s,
                   long long n) {
  extern __shared__ float smem[];
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = row < n;
  const int D0 = s.F + s.C;
  float xcv[kMaxWidth], a[kMaxWidth], b[kMaxWidth], p[kMaxT];
  if (active) {
    for (int j = 0; j < D0; ++j) xcv[j] = xc[row * D0 + j];
  }
  float acc = 0.0f;
  for (int l = 0; l < s.n_ar; ++l) {
    __syncthreads();  // every thread is done with the previous layer
    stage_layer(smem, params, s, l);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < D0; ++j) a[j] = xcv[j];
    const float* h = hidden_layers(smem, s, a, b);
    // the hidden activations already hold x, so x updates in place
    for (int f = 0; f < s.F; ++f) {
      feature_params(smem + s.last_off, s, h, f, p);
      float ladj;
      xcv[f] = univ_forward(xcv[f], p, s, &ladj);
      acc += ladj;
    }
  }
  if (!active) return;
  if (kRaw) {
    for (int f = 0; f < s.F; ++f) y[row * s.F + f] = xcv[f];
    out[row] = acc;
  } else {
    float sq = 0.0f;
    for (int f = 0; f < s.F; ++f) sq = fmaf(xcv[f], xcv[f], sq);
    out[row] = acc - 0.5f * sq - s.F * kHalfLog2Pi;
  }
}

// What the sampling kernel sums beside the solve: nothing, log q (base(z) +
// the forward ladjs), or the bare forward ladjs.
enum SampleMode { kNoLadj = 0, kLogQ = 1, kRawLadj = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
nsf_sample_kernel(const float* __restrict__ zc, float* __restrict__ xout,
                  float* __restrict__ logq, const float* __restrict__ params,
                  Shape s, long long n) {
  extern __shared__ float smem[];
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = row < n;
  const int D0 = s.F + s.C;
  // xcv = [x, c] is the current iterate with its context; y the target
  float xcv[kMaxWidth], y[kMaxWidth], a[kMaxWidth], b[kMaxWidth], p[kMaxT];
  float acc = 0.0f;
  if (active) {
    for (int j = 0; j < s.F; ++j) y[j] = zc[row * D0 + j];
    for (int j = s.F; j < D0; ++j) xcv[j] = zc[row * D0 + j];
    if (kMode == kLogQ) {
      float sq = 0.0f;
      for (int f = 0; f < s.F; ++f) sq = fmaf(y[f], y[f], sq);
      acc = -0.5f * sq - s.F * kHalfLog2Pi;
    }
  }
  for (int l = s.n_ar - 1; l >= 0; --l) {
    __syncthreads();
    stage_layer(smem, params, s, l);
    __syncthreads();
    if (!active) continue;
    for (int f = 0; f < s.F; ++f) xcv[f] = 0.0f;
    const int sweeps = min(s.passes[l], s.F);
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      for (int j = 0; j < D0; ++j) a[j] = xcv[j];
      const float* h = hidden_layers(smem, s, a, b);
      // Jacobi: h was computed from the whole previous iterate
      for (int f = 0; f < s.F; ++f) {
        feature_params(smem + s.last_off, s, h, f, p);
        xcv[f] = univ_inverse(y[f], p, s);
      }
    }
    if (kMode != kNoLadj) {
      for (int j = 0; j < D0; ++j) a[j] = xcv[j];
      const float* h = hidden_layers(smem, s, a, b);
      for (int f = 0; f < s.F; ++f) {
        feature_params(smem + s.last_off, s, h, f, p);
        float ladj;
        univ_forward(xcv[f], p, s, &ladj);
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

int make_shape(Shape* s, const int* widths, const int* passes, int n_lin,
               int n_ar, int F, int C, int K, int univ, float bound,
               float log_s) {
  if (n_lin < 1 || n_lin > kMaxLinear || n_ar < 1 || n_ar > kMaxLayers || F < 1 ||
      C < 0 || (univ != kAffine && univ != kRQS) ||
      (univ == kRQS && (K < 1 || K > kMaxBins)))
    return cudaErrorInvalidValue;
  s->n_lin = n_lin;
  s->n_ar = n_ar;
  s->F = F;
  s->C = C;
  s->K = K;
  s->T = univ == kRQS ? 3 * K - 1 : 2;
  s->univ = univ;
  s->bound = bound;
  s->log_s = log_s;
  if (widths[0] != F + C || widths[n_lin] != F * s->T) return cudaErrorInvalidValue;
  int floats = 0;
  for (int i = 0; i <= n_lin; ++i) {
    if (widths[i] < 1 || (i < n_lin && widths[i] > kMaxWidth)) return cudaErrorInvalidValue;
    s->widths[i] = widths[i];
    if (i == n_lin - 1) s->last_off = floats;
    if (i < n_lin) floats += widths[i + 1] * (widths[i] + 1);
  }
  s->layer_floats = floats;
  for (int l = 0; l < n_ar; ++l) s->passes[l] = passes[l];
  return cudaSuccess;
}

template <typename Kernel>
int configure(Kernel kernel, const Shape& s, size_t* smem) {
  *smem = (size_t)s.layer_floats * sizeof(float);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <bool kRaw>
int launch_density(const float* xc, float* y, float* out, const float* params,
                   const int* widths, const int* passes, int n_lin, int n_ar, int F, int C,
                   int K, int univ, float bound, float log_s, long long n, void* stream) {
  Shape s;
  int rc = make_shape(&s, widths, passes, n_lin, n_ar, F, C, K, univ, bound, log_s);
  if (rc != cudaSuccess) return rc;
  if (n <= 0) return cudaSuccess;
  size_t smem;
  rc = configure(nsf_density_kernel<kRaw>, s, &smem);
  if (rc != cudaSuccess) return rc;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  nsf_density_kernel<kRaw><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(xc, y, out,
                                                                            params, s, n);
  return cudaGetLastError();
}

template <int kMode>
int launch_sample(const float* zc, float* x, float* ladj, const float* params,
                  const int* widths, const int* passes, int n_lin, int n_ar, int F, int C,
                  int K, int univ, float bound, float log_s, long long n, void* stream) {
  Shape s;
  int rc = make_shape(&s, widths, passes, n_lin, n_ar, F, C, K, univ, bound, log_s);
  if (rc != cudaSuccess) return rc;
  if (n <= 0) return cudaSuccess;
  size_t smem;
  rc = configure(nsf_sample_kernel<kMode>, s, &smem);
  if (rc != cudaSuccess) return rc;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  nsf_sample_kernel<kMode><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(zc, x, ladj,
                                                                            params, s, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nsf_density_f32(const float* xc, float* out, const float* params,
                               const int* widths, const int* passes, int n_lin,
                               int n_ar, int F, int C, int K, int univ,
                               float bound, float log_s, long long n,
                               void* stream) {
  return launch_density<false>(xc, nullptr, out, params, widths, passes, n_lin, n_ar, F, C, K,
                               univ, bound, log_s, n, stream);
}

// y (n, F) = T(x), ladj (n,) = the bare sum of the forward log-Jacobians.
extern "C" int nsf_apply_f32(const float* xc, float* y, float* ladj, const float* params,
                             const int* widths, const int* passes, int n_lin,
                             int n_ar, int F, int C, int K, int univ,
                             float bound, float log_s, long long n,
                             void* stream) {
  return launch_density<true>(xc, y, ladj, params, widths, passes, n_lin, n_ar, F, C, K, univ,
                              bound, log_s, n, stream);
}

// logq may be null: the solve alone.
extern "C" int nsf_sample_f32(const float* zc, float* x, float* logq,
                              const float* params, const int* widths,
                              const int* passes, int n_lin, int n_ar, int F,
                              int C, int K, int univ, float bound, float log_s,
                              long long n, void* stream) {
  if (logq != nullptr)
    return launch_sample<kLogQ>(zc, x, logq, params, widths, passes, n_lin, n_ar, F, C, K,
                                univ, bound, log_s, n, stream);
  return launch_sample<kNoLadj>(zc, x, nullptr, params, widths, passes, n_lin, n_ar, F, C, K,
                                univ, bound, log_s, n, stream);
}

// The raw mode: ladj (n,) = the bare sum of the forward log-Jacobians at the
// solved x, with no base term.
extern "C" int nsf_sample_raw_f32(const float* zc, float* x, float* ladj,
                                  const float* params, const int* widths,
                                  const int* passes, int n_lin, int n_ar, int F,
                                  int C, int K, int univ, float bound, float log_s,
                                  long long n, void* stream) {
  if (ladj == nullptr) return cudaErrorInvalidValue;
  return launch_sample<kRawLadj>(zc, x, ladj, params, widths, passes, n_lin, n_ar, F, C, K,
                                 univ, bound, log_s, n, stream);
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
