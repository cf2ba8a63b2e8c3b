// Whole-flow continuous normalizing flow (CNF, FFJORD) kernels for Hopper
// (sm_90a).
//
// cnf_density replaces the TPU kernel zuko_tpu/ops/cnf_fused.py::_cnf_impl
// (pallas_call at :863; kernel body _cnf_kernel :678, integration
// _cnf_tile_integrate :302): log_prob of a CNF in one launch. Each row is
// integrated from t = 0 to 1 by adaptive Dormand-Prince 4(5) over the
// augmented state (x, l), dx/dt = f(t, x) and dl/dt = s tr(df/dx) with
// s = trace_scale; log_prob = -|z|^2 / 2 - F log(2 pi) / 2 + l / s at the
// endpoint z.
//
// cnf_sample replaces zuko_tpu/ops/cnf_fused.py::_cnf_sample_impl (pallas_call
// at :1312; kernel body _cnf_sample_kernel :692): the base draws integrated
// from t = 1 to 0 (the slopes negated, :374-376), x alone (error control over
// x only) or, with log q, beside the trace: log q = log N(z) - l / s.
//
// The dynamics f is the ODE network, biased linears with ELU between them, on
// [cos(f_k t), sin(f_k t), x, c]. The first layer is split by the wrapper
// into its x columns W1_x and its time-embedding columns W1_te; the context's
// columns are folded into the first bias, one vector or one per row
// (zuko_tpu's _kernel_params :782 and _batched_aug :802).
//
// Step control is per tile, as on the TPU: a tile of 256 rows (kTile; the
// wide tier's kernel takes its tile from blockDim.x, one thread a row; the
// narrow tier spreads a tile over a cluster of blocks, cnf_cluster below).
// Every attempt the tile max-reduces the rows' error ratio,
// max |err| / (atol + rtol max(|x|, |y|)) over x and l, NaN counting as
// infinite (warp shuffles, then shared memory), so every thread takes the
// same accept decision and the same next step 0.9 ratio^(-1/5) clipped to
// [0.1, 10]: the control flow never diverges. Rows past n take no part in the
// decision. A tile still short of t = 1 after 4 max_steps attempts writes
// NaN, as the TPU kernel does (:439-444).
//
// The time-embedding term sum_k W1_te[:, k] cos(f_k t) + W1_te[:, nf + k]
// sin(f_k t) (plus a shared first bias) is the same for every row of a tile:
// the block computes it once per stage into shared memory.
//
// The exact trace needs only the diagonal of the Jacobian. For column j the
// thread takes W1_x[:, j] through the hidden layers, v <- W (elu'(h) v), and
// only row j of the last layer: one hidden vector live at a time, where the
// TPU kernel carries the whole (H, F * tile) tangent block (:325-331), and
// F - 1 of the F rows of the last product skipped; the same sum to roundoff.
// Hutchinson's trace takes the row's probe e through once and dots the
// network's tangent with e.
//
// What bounds them on an H100: operations. The flagship CNF(6) (network
// 12-64-64-6, about 21 KB of weights) costs per attempt 7 network evaluations,
// each about 5K multiply-adds for the values and 25K for the 6 tangent
// columns of the exact trace, against 28 bytes a row in and out.
//
// Design: the narrow tier of both is cnf_cluster, the rows' state and the
// padded weights in shared memory; its limits are kMaxF features, hidden
// widths of kMaxWidth, kMaxLinear linears, kMaxFreqs frequencies and
// kMaxSharedFloats floats of weights, and a plan that fits 227 KB. The
// wide tier takes any shape: a row's state in a workspace in device memory,
// one column of `stride` rows per value (slot), the weights read through the
// read-only data cache (__ldg; every thread of a warp reads the same address
// at the same time), the widths, offsets and frequencies in a small device
// buffer. The wrapper (zuko_tpu_torch/ops/cnf_fused.py plan_cnf) picks the
// tier from the shapes and allocates the workspace; the rows then run in
// chunks of `stride` (whole tiles), one launch each. Float32 throughout
// (expf, expm1f, powf, cosf, sinf); no tensor cores, no TF32.
//
// Each C entry point checks its arguments, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#ifdef __CUDACC__
#include <cooperative_groups.h>
#endif
#include <math.h>
#include <string.h>

#include <type_traits>
#include <vector>

namespace {

// the narrow tier's limits, mirrored in zuko_tpu_torch/ops/cnf_fused.py
constexpr int kMaxF = 16;                 // features
constexpr int kMaxWidth = 128;            // hidden widths
constexpr int kMaxLinear = 4;             // linears of the ODE network
constexpr int kMaxFreqs = 16;             // time-embedding frequencies
constexpr int kMaxSharedFloats = 32768;   // the packed weights
constexpr int kTile = 256;                // rows of a tile: one block of the wide tier
constexpr int kRed = 32;                  // shared floats of the block's max

constexpr float kHalfLog2Pi = 0.91893853320467274f;

enum Trace { kNone = 0, kExact = 1, kHutchinson = 2 };

// Dormand-Prince 4(5) (zuko_tpu/utils.py:345-356): stage times, stage weights
// (row i: the weights of slopes 0..i-1), fifth-order weights and the
// differences of the fifth- and fourth-order weights (the error estimate).
__constant__ float kDpC[7] = {0.0f, (float)(1.0 / 5), (float)(3.0 / 10), (float)(4.0 / 5),
                              (float)(8.0 / 9), 1.0f, 1.0f};
__constant__ float kDpA[7][6] = {
    {0, 0, 0, 0, 0, 0},
    {(float)(1.0 / 5), 0, 0, 0, 0, 0},
    {(float)(3.0 / 40), (float)(9.0 / 40), 0, 0, 0, 0},
    {(float)(44.0 / 45), (float)(-56.0 / 15), (float)(32.0 / 9), 0, 0, 0},
    {(float)(19372.0 / 6561), (float)(-25360.0 / 2187), (float)(64448.0 / 6561),
     (float)(-212.0 / 729), 0, 0},
    {(float)(9017.0 / 3168), (float)(-355.0 / 33), (float)(46732.0 / 5247), (float)(49.0 / 176),
     (float)(-5103.0 / 18656), 0},
    {(float)(35.0 / 384), 0, (float)(500.0 / 1113), (float)(125.0 / 192),
     (float)(-2187.0 / 6784), (float)(11.0 / 84)}};
__constant__ float kDpB5[7] = {(float)(35.0 / 384), 0, (float)(500.0 / 1113),
                               (float)(125.0 / 192), (float)(-2187.0 / 6784),
                               (float)(11.0 / 84), 0};
__constant__ float kDpE[7] = {
    (float)(35.0 / 384 - 5179.0 / 57600), 0, (float)(500.0 / 1113 - 7571.0 / 16695),
    (float)(125.0 / 192 - 393.0 / 640), (float)(-2187.0 / 6784 + 92097.0 / 339200),
    (float)(11.0 / 84 - 187.0 / 2100), (float)(-1.0 / 40)};

// The narrow tier's description of the network, a __grid_constant__ parameter.
// Linear i maps w[i] inputs to w[i + 1] outputs (w[0] = w[n_lin] = F: the x
// columns of the first layer, and the slopes); its weights (out, in)
// row-major lie at off[i] in the packed buffer, its bias right after, except
// the first linear's: W1_x (H1, F) at off[0], then W1_te (H1, 2 nf) at off_te,
// then its bias at off_b1 (none when the bias comes per row).
struct Net {
  int F, nf, n_lin, off_te, off_b1, total, max_attempts;
  float atol, rtol, scale;
  int w[kMaxLinear + 1];
  int off[kMaxLinear];
  float freqs[kMaxFreqs];
};

// The wide tier's: the same fields, the arrays in the device buffer `desc`.
struct WideNet {
  int F, nf, n_lin, off_te, off_b1, total, max_attempts;
  float atol, rtol, scale;
  const int* w;
  const int* off;
  const float* freqs;
  int sum_hidden, max_hidden;
};

// A slot column of the wide tier's workspace: one of a row's arrays, `stride`
// floats between consecutive elements.
struct Column {
  float* p;
  long long stride;
  __device__ __forceinline__ float& operator[](int i) const { return p[i * stride]; }
  // the same column from element `off` on
  __device__ __forceinline__ Column at(int off) const { return {p + off * stride, stride}; }
};

// A row's state in the wide tier: x, the current stage's input xs, the probe
// e, the 7 stage slopes of x and of l (F + 1 each), elu' of every hidden
// layer, and two buffers each of the activations and of the tangent, as
// columns of the workspace from column i on, in this order (the slots
// mirrored in cnf_fused.py plan_cnf).
struct Row {
  Column x, xs, e, k, d, a0, a1, v0, v1;
  __device__ __forceinline__ void init(const WideNet& s, float* work, long long stride,
                                       long long i) {
    float* p = work + i;
    const long long widths[9] = {s.F, s.F, s.F, 7LL * (s.F + 1), s.sum_hidden, s.max_hidden,
                                 s.max_hidden, s.max_hidden, s.max_hidden};
    Column* cs[9] = {&x, &xs, &e, &k, &d, &a0, &a1, &v0, &v1};
    for (int c = 0; c < 9; ++c) {
      *cs[c] = {p, stride};
      p += widths[c] * stride;
    }
  }
};

// The block's max of v; every thread gets it. Ends with a barrier, so `red`
// may be written again at once.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int i = 1; i < warps; ++i) m = fmaxf(m, red[i]);
  __syncthreads();
  return m;
}

// out(o, init(o) + sum_j Wm[o, j] in[j]) for o < dout: eight outputs at a
// time in registers, so that each in[j] is loaded once for eight of them (each
// sum in the order of j, one fmaf a term, as one output at a time would be).
// The weights through the read-only cache.
template <class V, class Init, class Out>
__device__ __forceinline__ void matvec(const float* Wm, int din, int dout, const V& in, Init init,
                                       Out out) {
  for (int o0 = 0; o0 < dout; o0 += 8) {
    float acc[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[b] = o0 + b < dout ? init(o0 + b) : 0.0f;
    for (int j = 0; j < din; ++j) {
      const float v = in[j];
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (o0 + b < dout) acc[b] = fmaf(__ldg(Wm + (o0 + b) * din + j), v, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (o0 + b < dout) out(o0 + b, acc[b]);
  }
}

// One evaluation of the dynamics at the row's stage input r.xs, into slope
// slot `ks` of r.k: F values, then trace_scale times the trace (kTrace != kNone).
// te holds the tile's time-embedding term (with the shared first bias);
// brow is the row's first bias, or null.
template <int kTrace>
__device__ __forceinline__ void dynamics(const WideNet& net, const float* W, const float* te,
                                         const float* brow, Row& r, int ks) {
  const int F = net.F, L = net.n_lin, H1 = net.w[1];
  const int kb = ks * (F + 1);
  const float* W1x = W + net.off[0];
  const auto zero = [](int) { return 0.0f; };
  // the first layer: the slopes themselves when it is the only one
  Column cur = r.a0, nxt = r.a1;
  matvec(W1x, F, H1, r.xs,
         [&](int o) { return brow != nullptr ? te[o] + __ldg(brow + o) : te[o]; },
         [&](int o, float acc) {
           if (L == 1) {
             r.k[kb + o] = acc;
           } else {
             cur[o] = acc > 0.0f ? acc : expm1f(acc);
             r.d[o] = acc > 0.0f ? 1.0f : expf(acc);
           }
         });
  int dofs = 0;  // where elu' of the current hidden layer starts in r.d
  for (int i = 1; i < L; ++i) {
    const int din = net.w[i], dout = net.w[i + 1];
    const float* Wi = W + net.off[i];
    const float* bi = Wi + dout * din;
    const bool last = i == L - 1;
    matvec(Wi, din, dout, cur, [&](int o) { return __ldg(bi + o); }, [&](int o, float acc) {
      if (last) {
        r.k[kb + o] = acc;
      } else {
        nxt[o] = acc > 0.0f ? acc : expm1f(acc);
        r.d[dofs + din + o] = acc > 0.0f ? 1.0f : expf(acc);
      }
    });
    if (!last) {
      dofs += din;
      const Column t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  if (kTrace == kNone) return;
  float tr = 0.0f;
  const float* WL = W + net.off[L - 1];
  const int dl = net.w[L - 1];  // the last layer's inputs
  if (L == 1) {
    for (int j = 0; j < F; ++j) {
      if (kTrace == kExact) {
        tr += __ldg(W1x + j * F + j);
      } else {
        float acc = 0.0f;
        for (int q = 0; q < F; ++q) acc = fmaf(__ldg(W1x + j * F + q), r.e[q], acc);
        tr = fmaf(r.e[j], acc, tr);
      }
    }
  } else {
    const int passes = kTrace == kExact ? F : 1;
    for (int j = 0; j < passes; ++j) {
      // v = elu'(h1) * W1_x[:, j] (exact) or elu'(h1) * (W1_x e)
      Column vc = r.v0, vn = r.v1;
      if (kTrace == kExact) {
        for (int o = 0; o < H1; ++o) vc[o] = r.d[o] * __ldg(W1x + o * F + j);
      } else {
        matvec(W1x, F, H1, r.e, zero, [&](int o, float u) { vc[o] = r.d[o] * u; });
      }
      int dv = 0;
      for (int i = 1; i < L - 1; ++i) {
        const int din = net.w[i], dout = net.w[i + 1];
        dv += din;
        matvec(W + net.off[i], din, dout, vc, zero,
               [&](int o, float acc) { vn[o] = r.d[dv + o] * acc; });
        const Column t = vc;
        vc = vn;
        vn = t;
      }
      if (kTrace == kExact) {  // row j of the last layer only
        float acc = 0.0f;
        for (int q = 0; q < dl; ++q) acc = fmaf(__ldg(WL + j * dl + q), vc[q], acc);
        tr += acc;
      } else {
        matvec(WL, dl, F, vc, zero, [&](int o, float acc) { tr = fmaf(r.e[o], acc, tr); });
      }
    }
  }
  r.k[kb + F] = tr * net.scale;
}

// The tile's time-embedding term at time tt (and the shared first bias),
// computed by the whole block into te; the weights through the read-only
// cache. Starts with a barrier: the previous stage's readers are done.
template <class N>
__device__ __forceinline__ void time_embedding(const N& net, const float* W, float tt,
                                               bool row_bias, float* te) {
  __syncthreads();
  const int H1 = net.w[1], nf = net.nf;
  const float* Wte = W + net.off_te;
  for (int o = threadIdx.x; o < H1; o += blockDim.x) {
    float acc = row_bias ? 0.0f : __ldg(W + net.off_b1 + o);
    for (int q = 0; q < nf; ++q) {
      const float ft = net.freqs[q] * tt;
      acc = fmaf(__ldg(Wte + o * 2 * nf + q), cosf(ft), acc);
      acc = fmaf(__ldg(Wte + o * 2 * nf + nf + q), sinf(ft), acc);
    }
    te[o] = acc;
  }
  __syncthreads();
}

// The fifth-order solution of element f (f = F: l) of the current step.
__device__ __forceinline__ float fifth(const Row& r, int F, int f, float x0, float dt) {
  float y = x0;
  for (int i = 0; i < 7; ++i)
    if (kDpB5[i] != 0.0f) y = fmaf(dt * kDpB5[i], r.k[i * (F + 1) + f], y);
  return y;
}

// The wide tier of K10 (kReverse false) and K11 (kReverse true): one block a
// tile, one thread a row, the row's state in workspace columns. The narrow
// tier of both is cnf_cluster (below).
template <int kTrace, bool kReverse, bool kRowBias>
__global__ void __launch_bounds__(kTile)
    cnf_kernel(const float* __restrict__ in, const float* __restrict__ eps,
               const float* __restrict__ bias_rows, float* __restrict__ out_x,
               float* __restrict__ out_lp, const float* __restrict__ packed,
               const __grid_constant__ WideNet net, float* work, long long stride,
               long long row0, long long row_end) {
  extern __shared__ float smem[];
  const int F = net.F, H1 = net.w[1];
  const int tile = blockDim.x;
  const long long i = (long long)blockIdx.x * tile + threadIdx.x;  // row in the chunk
  const long long row = row0 + i;
  const bool valid = row < row_end;
  float* te = smem;
  float* red = smem + H1;
  const float* W = packed;
  // the launch covers whole tiles of a chunk of `stride` rows (a multiple of
  // the tile), so every thread has a workspace row of its own
  Row r;
  r.init(net, work, stride, i);
  const float* brow = kRowBias && valid ? bias_rows + row * H1 : nullptr;
  float base = 0.0f;  // -|z|^2 / 2 of the sampler's input
  for (int f = 0; f < F; ++f) {
    const float v = valid ? in[row * F + f] : 0.0f;
    r.x[f] = v;
    base = fmaf(-0.5f * v, v, base);
    if (kTrace == kHutchinson) r.e[f] = valid ? eps[row * F + f] : 0.0f;
  }
  // the tile's time and step: the same in every thread
  float l = 0.0f, t = 0.0f, dt = 1.0f;
  for (int attempt = 0; t < 1.0f && attempt < net.max_attempts; ++attempt) {
    dt = fminf(dt, 1.0f - t);
    for (int s = 0; s < 7; ++s) {
      for (int f = 0; f < F; ++f) {
        float v = r.x[f];
        for (int q = 0; q < s; ++q)
          if (kDpA[s][q] != 0.0f) v = fmaf(dt * kDpA[s][q], r.k[q * (F + 1) + f], v);
        r.xs[f] = v;
      }
      const float st = t + kDpC[s] * dt;
      time_embedding(net, W, kReverse ? 1.0f - st : st, kRowBias, te);
      dynamics<kTrace>(net, W, te, brow, r, s);
      if (kReverse)
        for (int f = 0; f <= (kTrace == kNone ? F - 1 : F); ++f)
          r.k[s * (F + 1) + f] = -r.k[s * (F + 1) + f];
    }
    // the row's error ratio, then the tile's
    const int n_el = kTrace == kNone ? F : F + 1;
    float ratio = 0.0f;
    for (int f = 0; f < n_el; ++f) {
      const float x0 = f < F ? r.x[f] : l;
      float err = 0.0f;
      for (int q = 0; q < 7; ++q)
        if (kDpE[q] != 0.0f) err = fmaf(dt * kDpE[q], r.k[q * (F + 1) + f], err);
      const float y = fifth(r, F, f, x0, dt);
      float q = fabsf(err) / (net.atol + net.rtol * fmaxf(fabsf(x0), fabsf(y)));
      if (isnan(q)) q = INFINITY;
      ratio = fmaxf(ratio, q);
    }
    ratio = block_max(valid ? ratio : 0.0f, red);
    if (ratio <= 1.0f) {
      for (int f = 0; f < F; ++f) r.x[f] = fifth(r, F, f, r.x[f], dt);
      if (kTrace != kNone) l = fifth(r, F, F, l, dt);
      t += dt;
    }
    dt *= fminf(fmaxf(0.9f * powf(fmaxf(ratio, FLT_MIN), -0.2f), 0.1f), 10.0f);
  }
  if (!valid) return;
  const bool exhausted = t < 1.0f - 64.0f * FLT_EPSILON;
  float sq = 0.0f;
  for (int f = 0; f < F; ++f) {
    const float v = exhausted ? NAN : r.x[f];
    sq = fmaf(v, v, sq);
    if (out_x != nullptr) out_x[row * F + f] = v;
  }
  if (exhausted) l = NAN;
  if (out_lp == nullptr) return;
  out_lp[row] = kReverse ? base - F * kHalfLog2Pi - l / net.scale
                         : -0.5f * sq - F * kHalfLog2Pi + l / net.scale;
}

// ------------------------------------------------------------------------
// cnf_adjoint: the continuous adjoint of cnf_sample (K12).
//
// Replaces zuko_tpu/ops/cnf_fused.py::_cnf_adjoint_pallas (pallas_call at
// :1044; kernel body _cnf_adjoint_kernel :613, _cnf_tile_adjoint :506). Per
// tile of rows it integrates, from the samples u(0) = x (t = 0) to the base
// draws (t = 1),
//   du/dt = f(t, u),   da/dt = -d/du Phi,   dg/dt = -d/dtheta Phi,
//   Phi = a . f - Lbar tr(df/du)   (Lbar = the log-q cotangent glq, 0 without
// it; tr unscaled), with theta = [W1_x, W1_te, b1, W2, b2, ...]: u and a per
// row, g per tile (summed over the tile's rows; a per-row first bias has a
// per-row accumulator instead). Dormand-Prince 4(5) with the error ratio the
// max over every leaf, u, a, each accumulator entry (rows past n excluded),
// the block max of K10 and its step rule; an exhausted tile is NaN in every
// leaf.
//
// The pullback, written out (h_l the pre-activations, z_l = elu(h_l),
// d_l = elu'(h_l), elu''(h_l) = d_l where h_l <= 0 and 0 where h_l > 0,
// f = h_L; the primal cotangent of f is a):
//   primal:  hbar_L = a; for l = L-1..1: Wbar_{l+1} += hbar_{l+1} (x) z_l,
//            bbar_{l+1} += hbar_{l+1}, hbar_l = d_l o (W_{l+1}^T hbar_{l+1})
//            + htan_l; Wbar1_x += hbar_1 (x) u, b1bar += hbar_1,
//            W1_te bar += hbar_1 (x) [cos(f t), sin(f t)], ubar = W1_x^T hbar_1.
//   trace:   the exact trace is sum_j (v^j_L)_j with v^j_1 = W1_x[:, j],
//            v^j_{l+1} = W_{l+1} (d_l o v^j_l); Hutchinson's e . v_L with
//            v_1 = W1_x e. Each tangent is pulled back from vbar_L = -Lbar e_j
//            (or -Lbar e): for l = L-1..1, with w = W_{l+1}^T vbar_{l+1},
//            Wbar_{l+1} += vbar_{l+1} (x) (d_l o v_l), htan_l += elu''(h_l)
//            o v_l o w (d_l depends on h_l), vbar_l = d_l o w; then
//            W1_x bar[:, j] += vbar_1 (exact) or Wbar1_x += vbar_1 (x) e.
// The slopes are ka = -ubar, kg = -(the sums of the bars over the tile's rows).
//
// The wide tier (cnf_adjoint_kernel): one block a tile (the tile taken from
// blockDim.x, as K10), one thread a row. A row's state lives in columns of
// the workspace ([slot][row], AdjointRow); the weights are read through
// __ldg. Each stage every thread writes its row's outer-product factors
// (left and right vectors of each linear, 1 + F pairs with the exact trace)
// into the tile's part of the workspace; after a barrier the threads reduce
// them, each owning strips of eight entries of one column of a weight,
// summing over the pairs and the rows in a fixed order: no atomics, so two
// runs agree. Only the increment and the error estimate of each
// accumulator are kept (the accumulators do not feed back into the
// dynamics), two floats an entry, and stage 2 (b5 = b4 = 0) needs no
// reduction. The narrow tier (cnf_adjoint_cluster, below) spreads a tile
// over a cluster of blocks and keeps the rows' vectors and the factors out
// of device memory.
//
// What bounds it on an H100: operations. Per row and stage the network, F
// tangent columns forward and back, and the outer products (about 4x K10's
// work a row for the flagship 12-64-64-6).

// A row's columns of the adjoint's workspace, in this order (the slots
// mirrored in cnf_fused.py plan_cnf_adjoint): u, a, the stage's inputs us
// and as, the probe e, the 7 stage slopes of u and of a, z and d of every
// hidden layer, the tangent part htan of every hidden layer's cotangent, the
// tangent v of every hidden layer, two buffers of the largest width, and the
// per-row first bias's accumulator with its increment and error.
struct AdjointRow {
  Column u, a, us, as, e, ku, ka, z, d, ht, v, c0, c1, gb, incb, errb;
  __device__ __forceinline__ void init(int F, int sh, int mw, int H1, float* work,
                                       long long stride, long long i) {
    float* p = work + i;
    const int widths[16] = {F, F, F, F, F, 7 * F, 7 * F, sh, sh, sh, sh, mw, mw, H1, H1, H1};
    Column* cs[16] = {&u, &a, &us, &as, &e, &ku, &ka, &z, &d, &ht, &v, &c0, &c1, &gb, &incb, &errb};
    for (int c = 0; c < 16; ++c) {
      *cs[c] = {p, stride};
      p += widths[c] * stride;
    }
  }
};

template <class N>
__device__ __forceinline__ int sum_hidden(const N& net) {
  int s = 0;
  for (int i = 1; i < net.n_lin; ++i) s += net.w[i];
  return s;
}

template <class N>
__device__ __forceinline__ int max_width(const N& net) {
  int m = 0;
  for (int i = 0; i <= net.n_lin; ++i) m = net.w[i] > m ? net.w[i] : m;
  return m;
}

// out(q, sum_o Wm[o, q] in[o]) for q < din: the transposed product, eight
// outputs at a time.
template <class V, class Out>
__device__ __forceinline__ void matvec_t(const float* Wm, int din, int dout, const V& in, Out out) {
  for (int q0 = 0; q0 < din; q0 += 8) {
    float acc[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[b] = 0.0f;
    for (int o = 0; o < dout; ++o) {
      const float v = in[o];
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (q0 + b < din) acc[b] = fmaf(__ldg(Wm + o * din + q0 + b), v, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (q0 + b < din) out(q0 + b, acc[b]);
  }
}

// a o b, element by element
struct Product {
  Column a, b;
  __device__ __forceinline__ float operator[](int j) const { return a[j] * b[j]; }
};

// The tile's outer-product factors of linear li (inputs w[li], outputs
// w[li + 1]): for pair p and row r, the left vector (outputs) and the right
// vector (inputs), after those of the linears before it.
struct Factors {
  float* buf;
  int pairs, tile;
  template <class N>
  __device__ __forceinline__ float* base(const N& net, int li) const {
    long long off = 0;
    for (int m = 0; m < li; ++m) off += (long long)pairs * tile * (net.w[m] + net.w[m + 1]);
    return buf + off;
  }
  template <class N>
  __device__ __forceinline__ float* left(const N& net, int li, int p, int r) const {
    return base(net, li) + ((long long)p * tile + r) * net.w[li + 1];
  }
  template <class N>
  __device__ __forceinline__ float* right(const N& net, int li, int p, int r) const {
    return base(net, li) + (long long)pairs * tile * net.w[li + 1] +
           ((long long)p * tile + r) * net.w[li];
  }
};

// One row's slopes at stage s: ku[s] = f(us), ka[s] = -ubar, its factors of
// every linear into fac, and for a per-row first bias its accumulator's
// increment (cb5 = dt b5_s) and error (ce = dt (b5_s - b4_s)).
template <int kTrace, bool kRowBias, class N>
__device__ __forceinline__ void adjoint_row(const N& net, const float* W, const float* te,
                                            const float* brow, float lbar, const AdjointRow& r,
                                            int s, const Factors& fac, int row, int sh,
                                            float cb5, float ce) {
  const int F = net.F, L = net.n_lin, H1 = net.w[1];
  const float* W1x = W + net.off[0];
  const auto zero = [](int) { return 0.0f; };
  // forward: z and d of the hidden layers, then f
  matvec(W1x, F, H1, r.us,
                [&](int o) { return brow != nullptr ? te[o] + __ldg(brow + o) : te[o]; },
                [&](int o, float acc) {
                  if (L == 1) {
                    r.ku[s * F + o] = acc;
                  } else {
                    r.z[o] = acc > 0.0f ? acc : expm1f(acc);
                    r.d[o] = acc > 0.0f ? 1.0f : expf(acc);
                  }
                });
  int hoff = 0;  // where the current hidden layer starts in z, d, ht, v
  for (int i = 1; i < L; ++i) {
    const int din = net.w[i], dout = net.w[i + 1];
    const float* Wi = W + net.off[i];
    const float* bi = Wi + dout * din;
    const bool last = i == L - 1;
    matvec(Wi, din, dout, r.z.at(hoff), [&](int o) { return __ldg(bi + o); },
                  [&](int o, float acc) {
                    if (last) {
                      r.ku[s * F + o] = acc;
                    } else {
                      r.z[hoff + din + o] = acc > 0.0f ? acc : expm1f(acc);
                      r.d[hoff + din + o] = acc > 0.0f ? 1.0f : expf(acc);
                    }
                  });
    if (!last) hoff += din;
  }
  const int top = L > 1 ? sh - net.w[L - 1] : 0;  // where hidden layer L - 1 starts
  // the trace's part: each tangent pulled back from -lbar e_j (or -lbar e)
  if (kTrace != kNone) {
    for (int q = 0; q < sh; ++q) r.ht[q] = 0.0f;
    const int passes = kTrace == kExact ? F : 1;
    for (int j = 0; j < passes; ++j) {
      const int pair = 1 + j;
      if (L > 1) {
        if (kTrace == kExact) {
          for (int o = 0; o < H1; ++o) r.v[o] = __ldg(W1x + o * F + j);
        } else {
          matvec(W1x, F, H1, r.e, zero, [&](int o, float acc) { r.v[o] = acc; });
        }
        int vo = 0;
        for (int i = 1; i < L - 1; ++i) {
          const int din = net.w[i], dout = net.w[i + 1];
          matvec(W + net.off[i], din, dout, Product{r.d.at(vo), r.v.at(vo)}, zero,
                        [&](int o, float acc) { r.v[vo + din + o] = acc; });
          vo += din;
        }
      }
      Column cur = r.c0, nxt = r.c1;
      for (int o = 0; o < F; ++o)
        cur[o] = kTrace == kExact ? (o == j ? -lbar : 0.0f) : -lbar * r.e[o];
      int lo = top;
      for (int li = L - 1; li >= 1; --li) {
        const int din = net.w[li], dout = net.w[li + 1];
        float* left = fac.left(net, li, pair, row);
        float* right = fac.right(net, li, pair, row);
        for (int o = 0; o < dout; ++o) left[o] = cur[o];
        for (int q = 0; q < din; ++q) right[q] = r.d[lo + q] * r.v[lo + q];
        matvec_t(W + net.off[li], din, dout, cur, [&](int q, float w) {
          const float dq = r.d[lo + q];
          r.ht[lo + q] = fmaf(r.z[lo + q] > 0.0f ? 0.0f : dq * r.v[lo + q], w, r.ht[lo + q]);
          nxt[q] = dq * w;
        });
        const Column t = cur;
        cur = nxt;
        nxt = t;
        if (li > 1) lo -= net.w[li - 1];
      }
      float* left = fac.left(net, 0, pair, row);
      for (int o = 0; o < H1; ++o) left[o] = cur[o];
      if (kTrace == kHutchinson) {
        float* right = fac.right(net, 0, pair, row);
        for (int q = 0; q < F; ++q) right[q] = r.e[q];
      }
    }
  }
  // the primal part, from hbar_L = a
  Column cur = r.c0, nxt = r.c1;
  for (int o = 0; o < F; ++o) cur[o] = r.as[o];
  int lo = top;
  for (int li = L - 1; li >= 1; --li) {
    const int din = net.w[li], dout = net.w[li + 1];
    float* left = fac.left(net, li, 0, row);
    float* right = fac.right(net, li, 0, row);
    for (int o = 0; o < dout; ++o) left[o] = cur[o];
    for (int q = 0; q < din; ++q) right[q] = r.z[lo + q];
    matvec_t(W + net.off[li], din, dout, cur, [&](int q, float w) {
      const float hq = r.d[lo + q] * w;
      nxt[q] = kTrace != kNone ? hq + r.ht[lo + q] : hq;
    });
    const Column t = cur;
    cur = nxt;
    nxt = t;
    if (li > 1) lo -= net.w[li - 1];
  }
  float* left = fac.left(net, 0, 0, row);
  float* right = fac.right(net, 0, 0, row);
  for (int o = 0; o < H1; ++o) left[o] = cur[o];
  for (int q = 0; q < F; ++q) right[q] = r.us[q];
  matvec_t(W1x, F, H1, cur, [&](int q, float w) { r.ka[s * F + q] = -w; });
  if (kRowBias)
    for (int o = 0; o < H1; ++o) {
      r.incb[o] = fmaf(cb5, -cur[o], r.incb[o]);
      r.errb[o] = fmaf(ce, -cur[o], r.errb[o]);
    }
}

// The tile's parameter slopes at stage time st from the factors: entry
// (o, q) of a linear's weight sums left[o] right[q] over the pairs and the
// rows (the exact trace's first-linear pairs have the unit vector e_{p-1} on
// the right, not stored); a bias sums the primal left vectors, and W1_te's
// entries are b1's sum times cos(f t) and sin(f t). Each accumulator entry
// takes dt b5 and dt (b5 - b4) times its slope. Strips of eight outputs of
// one input column, the columns fastest across the threads.
template <int kTrace, bool kRowBias, class N>
__device__ __forceinline__ void adjoint_reduce(const N& net, const Factors& fac, float* inc,
                                               float* err, float cb5, float ce, float st) {
  const int T = fac.tile, tid = threadIdx.x;
  const auto add = [&](int e, float k) {
    inc[e] = fmaf(cb5, k, inc[e]);
    err[e] = fmaf(ce, k, err[e]);
  };
  for (int li = 0; li < net.n_lin; ++li) {
    const int din = net.w[li], dout = net.w[li + 1];
    const float* Lb = fac.left(net, li, 0, 0);
    const float* Rb = fac.right(net, li, 0, 0);
    const int strips = ((dout + 7) / 8) * din;
    for (int sidx = tid; sidx < strips; sidx += T) {
      const int q = sidx % din, o0 = (sidx / din) * 8;
      float acc[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[b] = 0.0f;
      for (int p = 0; p < fac.pairs; ++p) {
        const float* Lp = Lb + (long long)p * T * dout;
        if (li == 0 && kTrace == kExact && p > 0) {
          if (q != p - 1) continue;
          for (int row = 0; row < T; ++row)
#pragma unroll
            for (int b = 0; b < 8; ++b)
              if (o0 + b < dout) acc[b] += Lp[(long long)row * dout + o0 + b];
          continue;
        }
        const float* Rp = Rb + (long long)p * T * din;
        for (int row = 0; row < T; ++row) {
          const float rv = Rp[(long long)row * din + q];
#pragma unroll
          for (int b = 0; b < 8; ++b)
            if (o0 + b < dout) acc[b] = fmaf(Lp[(long long)row * dout + o0 + b], rv, acc[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (o0 + b < dout) add(net.off[li] + (o0 + b) * din + q, -acc[b]);
    }
    for (int o = tid; o < dout; o += T) {
      float sum = 0.0f;
      for (int row = 0; row < T; ++row) sum += Lb[(long long)row * dout + o];
      if (li > 0) {
        add(net.off[li] + dout * din + o, -sum);
        continue;
      }
      if (!kRowBias) add(net.off_b1 + o, -sum);
      const int nf = net.nf;
      for (int k = 0; k < nf; ++k) {
        const float ft = net.freqs[k] * st;
        add(net.off_te + o * 2 * nf + k, -sum * cosf(ft));
        add(net.off_te + o * 2 * nf + nf + k, -sum * sinf(ft));
      }
    }
  }
}

// The wide tier's kernel (the narrow tier is cnf_adjoint_cluster below).
template <int kTrace, bool kRowBias>
__global__ void __launch_bounds__(kTile)
    cnf_adjoint_kernel(const float* __restrict__ xin, const float* __restrict__ ain,
                       const float* __restrict__ glq, const float* __restrict__ eps,
                       const float* __restrict__ bias_rows, float* __restrict__ u_out,
                       float* __restrict__ a_out, float* __restrict__ g_out,
                       float* __restrict__ gb_out, const float* __restrict__ packed,
                       const __grid_constant__ WideNet net, float* work, long long stride,
                       long long row_floats, long long tile_floats, long long row0,
                       long long row_end) {
  extern __shared__ float smem[];
  const int F = net.F, H1 = net.w[1], P = net.total;
  const int T = blockDim.x, tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * T + tid;  // row in the chunk
  const long long row = row0 + i;
  const bool valid = row < row_end;
  float* te = smem;
  float* red = smem + H1;
  const float* W = packed;
  const int sh = sum_hidden(net);
  AdjointRow r;
  r.init(F, sh, max_width(net), H1, work, stride, i);
  // the tile's part of the workspace: the accumulators' increments and
  // errors, then the factors
  float* tw = work + row_floats * stride + (long long)blockIdx.x * tile_floats;
  float* inc = tw;
  float* err = tw + P;
  const Factors fac{tw + 2LL * P, kTrace == kExact ? F + 1 : (kTrace == kHutchinson ? 2 : 1), T};
  float* g = g_out + (row0 / T + blockIdx.x) * (long long)P;  // this tile's partial sums
  for (int q = tid; q < P; q += T) g[q] = inc[q] = err[q] = 0.0f;
  const float* brow = kRowBias && valid ? bias_rows + row * H1 : nullptr;
  const float lbar = kTrace != kNone && valid ? glq[row] : 0.0f;
  for (int f = 0; f < F; ++f) {
    r.u[f] = valid ? xin[row * F + f] : 0.0f;
    r.a[f] = valid ? ain[row * F + f] : 0.0f;
    if (kTrace == kHutchinson) r.e[f] = valid ? eps[row * F + f] : 0.0f;
  }
  if (kRowBias)
    for (int o = 0; o < H1; ++o) r.gb[o] = r.incb[o] = r.errb[o] = 0.0f;
  float t = 0.0f, dt = 1.0f;
  for (int attempt = 0; t < 1.0f && attempt < net.max_attempts; ++attempt) {
    dt = fminf(dt, 1.0f - t);
    for (int s = 0; s < 7; ++s) {
      for (int f = 0; f < F; ++f) {
        float vu = r.u[f], va = r.a[f];
        for (int q = 0; q < s; ++q)
          if (kDpA[s][q] != 0.0f) {
            vu = fmaf(dt * kDpA[s][q], r.ku[q * F + f], vu);
            va = fmaf(dt * kDpA[s][q], r.ka[q * F + f], va);
          }
        r.us[f] = vu;
        r.as[f] = va;
      }
      const float st = t + kDpC[s] * dt;
      const float cb5 = dt * kDpB5[s], ce = dt * kDpE[s];
      time_embedding(net, W, st, kRowBias, te);
      adjoint_row<kTrace, kRowBias>(net, W, te, brow, lbar, r, s, fac, tid, sh, cb5, ce);
      __syncthreads();
      if (kDpB5[s] != 0.0f || kDpE[s] != 0.0f)
        adjoint_reduce<kTrace, kRowBias>(net, fac, inc, err, cb5, ce, st);
    }
    __syncthreads();
    // the row's error ratio over u, a (and its first bias), this thread's
    // share of the tile's accumulators, then the tile's
    float ratio = 0.0f;
    const auto worst = [&](float x0, float y, float e) {
      float q = fabsf(e) / (net.atol + net.rtol * fmaxf(fabsf(x0), fabsf(y)));
      if (isnan(q)) q = INFINITY;
      ratio = fmaxf(ratio, q);
    };
    if (valid) {
      for (int f = 0; f < F; ++f) {
        float yu = r.u[f], ya = r.a[f], eu = 0.0f, ea = 0.0f;
        for (int q = 0; q < 7; ++q) {
          if (kDpB5[q] != 0.0f) {
            yu = fmaf(dt * kDpB5[q], r.ku[q * F + f], yu);
            ya = fmaf(dt * kDpB5[q], r.ka[q * F + f], ya);
          }
          if (kDpE[q] != 0.0f) {
            eu = fmaf(dt * kDpE[q], r.ku[q * F + f], eu);
            ea = fmaf(dt * kDpE[q], r.ka[q * F + f], ea);
          }
        }
        worst(r.u[f], yu, eu);
        worst(r.a[f], ya, ea);
      }
      if (kRowBias)
        for (int o = 0; o < H1; ++o) worst(r.gb[o], r.gb[o] + r.incb[o], r.errb[o]);
    }
    for (int q = tid; q < P; q += T) worst(g[q], g[q] + inc[q], err[q]);
    ratio = block_max(ratio, red);
    if (ratio <= 1.0f) {
      if (valid)
        for (int f = 0; f < F; ++f) {
          float yu = r.u[f], ya = r.a[f];
          for (int q = 0; q < 7; ++q)
            if (kDpB5[q] != 0.0f) {
              yu = fmaf(dt * kDpB5[q], r.ku[q * F + f], yu);
              ya = fmaf(dt * kDpB5[q], r.ka[q * F + f], ya);
            }
          r.u[f] = yu;
          r.a[f] = ya;
        }
      if (kRowBias)
        for (int o = 0; o < H1; ++o) r.gb[o] += r.incb[o];
      for (int q = tid; q < P; q += T) g[q] += inc[q];
      t += dt;
    }
    for (int q = tid; q < P; q += T) inc[q] = err[q] = 0.0f;
    if (kRowBias)
      for (int o = 0; o < H1; ++o) r.incb[o] = r.errb[o] = 0.0f;
    dt *= fminf(fmaxf(0.9f * powf(fmaxf(ratio, FLT_MIN), -0.2f), 0.1f), 10.0f);
  }
  const bool exhausted = t < 1.0f - 64.0f * FLT_EPSILON;
  if (exhausted)
    for (int q = tid; q < P; q += T) g[q] = NAN;
  if (!valid) return;
  for (int f = 0; f < F; ++f) {
    u_out[row * F + f] = exhausted ? NAN : r.u[f];
    a_out[row * F + f] = exhausted ? NAN : r.a[f];
  }
  if (kRowBias)
    for (int o = 0; o < H1; ++o) gb_out[row * H1 + o] = exhausted ? NAN : r.gb[o];
}

// ------------------------------------------------------------------------
// The narrow tier of cnf_adjoint: a tile over a cluster of blocks, every
// row's vectors in shared memory, the outer products reduced from there.
//
// The same function as cnf_adjoint_kernel (the same tile of rows, stages,
// error ratio over every leaf, step rule and NaN-poisoning); only the order
// of the float32 sums over the rows and pairs changes. What it does about
// what held the one-block design back:
// - a tile of `tile` rows (256) is a cluster of cl blocks of rb = 64 rows
//   (4 blocks on neighbouring SMs: 64 tiles fill 256 blocks, not 64), four
//   threads a row (a quad of one warp), which share out each product's
//   outputs eight at a time and every loop over a row's elements; the
//   tile's step decision is the max of the blocks' ratios through
//   distributed shared memory and a cluster barrier;
// - a row's vectors (u, a, the stage's inputs, the probe, z and d of every
//   hidden layer, the tangents and their cotangents) are columns [slot][row]
//   in the block's shared memory, when they fit (else in the workspace);
//   the stage slopes ku, ka and a per-row first bias's accumulator stay in
//   the workspace (a few touches a stage);
// - the weights are staged padded, W^T [in][out rounded to 8] for the
//   products and W [out][in rounded to 8] for the pullbacks, so that a
//   thread's eight outputs come in two 16-byte loads (the wrapper builds
//   them, _padded_weights in ops/cnf_fused.py);
// - no factor reaches device memory: at each pullback step the block
//   (after a barrier) sums left (x) right over its rows straight from the
//   columns, a thread a patch of 4 x 8 entries in registers, and adds dt b5
//   and dt (b5 - b4) times the sum to its block's increments and errors;
//   at the end of an attempt rank k of the cluster sums the cl blocks'
//   increments and errors (in rank order) over its share of the entries,
//   takes their error ratio and, on an accepted step, adds them to the
//   tile's g;
// - what is zero is skipped: the exact trace's column j enters the last
//   linear as -Lbar e_j, so only row j of that linear is pulled back and
//   reduced, and its first-linear pairs add the left vector to column j.

constexpr int kAdjRows = 64;    // rows of a block of the narrow tier
constexpr int kQuad = 4;        // threads of a row, neighbours in one warp
constexpr int kMaxCluster = 8;  // blocks of a cluster (portable)
constexpr int kMaxShared = 232448;  // a block's shared memory on an H100 (227 KB)

__host__ __device__ __forceinline__ int pad8(int v) { return (v + 7) & ~7; }

// This thread's place in its row's quad, and the quad's barrier.
__device__ __forceinline__ int quad_lane() { return threadIdx.x % kQuad; }
__device__ __forceinline__ void quad_sync() { __syncwarp(); }

// Where linear li's padded copies start in `padded`: per linear W^T then W.
template <class N>
__device__ __forceinline__ int padded_at(const N& net, int li) {
  int off = 0;
  for (int m = 0; m < li; ++m)
    off += net.w[m] * pad8(net.w[m + 1]) + net.w[m + 1] * pad8(net.w[m]);
  return off;
}

// out(o, init(o) + sum_j W[o, j] in[j]) for o < dout from WT = W^T [din]
// [pad8(dout)]: eight outputs at a time, their weights in two 16-byte loads,
// each sum in the order of j, one fmaf a term (as matvec); the quad's
// threads take every fourth eight.
template <class V, class Init, class Out>
__device__ __forceinline__ void tmatvec(const float* WT, int din, int dout, const V& in, Init init,
                                        Out out) {
  const int dp = pad8(dout);
  for (int o0 = 8 * quad_lane(); o0 < dout; o0 += 8 * kQuad) {
    float acc[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[b] = o0 + b < dout ? init(o0 + b) : 0.0f;
    const float* wp = WT + o0;
#pragma unroll 4
    for (int j = 0; j < din; ++j) {
      const float v = in[j];
      const float4 w0 = *reinterpret_cast<const float4*>(wp + j * dp);
      const float4 w1 = *reinterpret_cast<const float4*>(wp + j * dp + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[b] = fmaf(wv[b], v, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (o0 + b < dout) out(o0 + b, acc[b]);
  }
}

// out(q, sum_o W[o, q] in[o]) for q < din from Wp = W [dout][pad8(din)]:
// the transposed product, eight outputs at a time (as matvec_t), shared out
// as tmatvec's.
template <class V, class Out>
__device__ __forceinline__ void tmatvec_t(const float* Wp, int din, int dout, const V& in, Out out) {
  const int dp = pad8(din);
  for (int q0 = 8 * quad_lane(); q0 < din; q0 += 8 * kQuad) {
    float acc[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[b] = 0.0f;
    const float* wp = Wp + q0;
#pragma unroll 4
    for (int o = 0; o < dout; ++o) {
      const float v = in[o];
      const float4 w0 = *reinterpret_cast<const float4*>(wp + o * dp);
      const float4 w1 = *reinterpret_cast<const float4*>(wp + o * dp + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[b] = fmaf(wv[b], v, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (q0 + b < din) out(q0 + b, acc[b]);
  }
}

// The block's rows as columns: element (slot, r) of row r of the block at
// p[slot * stride + r], in shared memory or in the workspace.
struct Block {
  float* p;
  long long stride;
  int rows;
  __device__ __forceinline__ float operator()(int slot, int r) const { return p[slot * stride + r]; }
  // this thread's row (its quad's), from `slot` on
  __device__ __forceinline__ Column row(int slot) const {
    return {p + slot * stride + threadIdx.x / kQuad, stride};
  }
};

// G(o, q) = sum over the block's rows r, in order, of L(o, r) R(q, r) for
// o in [o_lo, o_hi), q < din; then inc[e] += cb5 (-G) and err[e] += ce (-G)
// at e = at + o * ld + q. A thread a patch of 4 x 8 entries in registers.
template <class Lf, class Rf>
__device__ __forceinline__ void reduce_outer(int o_lo, int o_hi, int din, int rows, Lf L, Rf R,
                                             int at, int ld, float* inc, float* err, float cb5,
                                             float ce) {
  constexpr int PO = 4, PQ = 8;
  const int no = (o_hi - o_lo + PO - 1) / PO, nq = (din + PQ - 1) / PQ;
  for (int p = threadIdx.x; p < no * nq; p += blockDim.x) {
    const int o0 = o_lo + (p / nq) * PO, q0 = (p % nq) * PQ;
    float acc[PO][PQ];
#pragma unroll
    for (int i = 0; i < PO; ++i)
#pragma unroll
      for (int j = 0; j < PQ; ++j) acc[i][j] = 0.0f;
    for (int r = 0; r < rows; ++r) {
      float lv[PO], rv[PQ];
#pragma unroll
      for (int i = 0; i < PO; ++i) lv[i] = o0 + i < o_hi ? L(o0 + i, r) : 0.0f;
#pragma unroll
      for (int j = 0; j < PQ; ++j) rv[j] = q0 + j < din ? R(q0 + j, r) : 0.0f;
#pragma unroll
      for (int i = 0; i < PO; ++i)
#pragma unroll
        for (int j = 0; j < PQ; ++j) acc[i][j] = fmaf(lv[i], rv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < PO; ++i)
#pragma unroll
      for (int j = 0; j < PQ; ++j)
        if (o0 + i < o_hi && q0 + j < din) {
          const int e = at + (o0 + i) * ld + q0 + j;
          inc[e] = fmaf(cb5, -acc[i][j], inc[e]);
          err[e] = fmaf(ce, -acc[i][j], err[e]);
        }
  }
}

// The cluster's barrier (the block's with one block a cluster), and a float
// in the shared memory of block `rank` of the cluster.
__device__ __forceinline__ void cluster_sync(int cl) {
#ifdef __CUDA_ARCH__
  if (cl > 1) {
    cooperative_groups::this_cluster().sync();
    return;
  }
#endif
  __syncthreads();
}

__device__ __forceinline__ float cluster_peer(float* p, int rank) {
#ifdef __CUDA_ARCH__
  return *cooperative_groups::this_cluster().map_shared_rank(p, rank);
#else
  return *p;
#endif
}

// The narrow tier's plan of a launch (adjoint_plan; mirrored in
// ops/cnf_fused.py plan_cnf_adjoint): the cluster and its blocks, the shared
// memory (the padded weights, the time-embedding term, the block max, the
// rows' columns), the workspace (per row and per block).
struct AdjTile {
  int cl, rb, rbs;          // blocks a tile, rows a block, the columns' stride in shared memory
  int hot;                  // floats of a row's columns (u ... c1)
  int weights;              // floats of the padded weights
  int weights_shared, rows_shared;
  int smem_floats;
  long long row_floats;     // floats a row in the workspace: ku, ka, [gb, incb, errb], [columns]
};

// A row's columns, from slot 0: u, a, us, as, e (F each), z, d, ht, v (the
// hidden layers' sum each), c0, c1 (the largest width each).
struct HotSlots {
  int u, a, us, as, e, z, d, ht, v, c0, c1, total;
  __host__ __device__ HotSlots(int F, int sh, int mw)
      : u(0), a(F), us(2 * F), as(3 * F), e(4 * F), z(5 * F), d(5 * F + sh), ht(5 * F + 2 * sh),
        v(5 * F + 3 * sh), c0(5 * F + 4 * sh), c1(5 * F + 4 * sh + mw),
        total(5 * F + 4 * sh + 2 * mw) {}
};

// One stage of the tile's adjoint for every row of the block: the row's
// slopes ku[s] = f(us) and ka[s] = -ubar, and, when `reduce`, the block's
// share of the parameters' slopes times dt b5 (inc) and dt (b5 - b4) (err);
// a per-row first bias's accumulator per row. W the padded weights, packed
// the biases and W1_te (through the read-only cache). A quad's threads share
// out each product and loop (quad_lane), with the quad's barrier before a
// row's vector is read whole.
template <int kTrace, bool kRowBias>
__device__ __forceinline__ void adjoint_tile_stage(const Net& net, const float* W,
                                                   const float* __restrict__ packed,
                                                   const float* te, const float* brow, float lbar,
                                                   const Block& blk, const HotSlots& hs,
                                                   const Column& ku, const Column& ka,
                                                   const Column& incb, const Column& errb, int s,
                                                   bool reduce, float* inc, float* err, float cb5,
                                                   float ce, float st) {
  const int F = net.F, L = net.n_lin, H1 = net.w[1], rows = blk.rows, tid = threadIdx.x;
  const int ql = quad_lane(), sh = hs.ht - hs.d;
  const Column us = blk.row(hs.us), as = blk.row(hs.as), e = blk.row(hs.e);
  const Column z = blk.row(hs.z), d = blk.row(hs.d), ht = blk.row(hs.ht), v = blk.row(hs.v);
  const float* WT0 = W + padded_at(net, 0);
  const float* Wp0 = WT0 + F * pad8(H1);
  const auto zero = [](int) { return 0.0f; };
  // forward: z and d of the hidden layers, then f
  tmatvec(WT0, F, H1, us,
          [&](int o) { return brow != nullptr ? te[o] + __ldg(brow + o) : te[o]; },
          [&](int o, float acc) {
            if (L == 1) {
              ku[s * F + o] = acc;
            } else {
              z[o] = acc > 0.0f ? acc : expm1f(acc);
              d[o] = acc > 0.0f ? 1.0f : expf(acc);
            }
          });
  int hoff = 0;
  for (int i = 1; i < L; ++i) {
    const int din = net.w[i], dout = net.w[i + 1];
    const float* bi = packed + net.off[i] + dout * din;
    const bool last = i == L - 1;
    quad_sync();
    tmatvec(W + padded_at(net, i), din, dout, z.at(hoff), [&](int o) { return __ldg(bi + o); },
            [&](int o, float acc) {
              if (last) {
                ku[s * F + o] = acc;
              } else {
                z[hoff + din + o] = acc > 0.0f ? acc : expm1f(acc);
                d[hoff + din + o] = acc > 0.0f ? 1.0f : expf(acc);
              }
            });
    if (!last) hoff += din;
  }
  const int top = L > 1 ? sh - net.w[L - 1] : 0;  // where hidden layer L - 1 starts
  const auto one = [](int, int) { return 1.0f; };
  // the trace's part: each tangent pulled back from -lbar e_j (or -lbar e)
  if (kTrace != kNone) {
    for (int q = ql; q < sh; q += kQuad) ht[q] = 0.0f;
    const int passes = kTrace == kExact ? F : 1;
    for (int j = 0; j < passes; ++j) {
      quad_sync();  // z, d, ht; the previous pair's v and cotangents are read no more
      if (L > 1) {
        if (kTrace == kExact) {
          for (int o = ql; o < H1; o += kQuad) v[o] = Wp0[o * pad8(F) + j];
        } else {
          tmatvec(WT0, F, H1, e, zero, [&](int o, float acc) { v[o] = acc; });
        }
        int vo = 0;
        for (int i = 1; i < L - 1; ++i) {
          const int din = net.w[i], dout = net.w[i + 1];
          quad_sync();
          tmatvec(W + padded_at(net, i), din, dout, Product{d.at(vo), v.at(vo)}, zero,
                  [&](int o, float acc) { v[vo + din + o] = acc; });
          vo += din;
        }
      }
      int cs = hs.c0, ns = hs.c1;
      {
        const Column cur = blk.row(cs);
        for (int o = ql; o < F; o += kQuad)
          cur[o] = kTrace == kExact ? (o == j ? -lbar : 0.0f) : -lbar * e[o];
      }
      int lo = top;
      for (int li = L - 1; li >= 1; --li) {
        const int din = net.w[li], dout = net.w[li + 1];
        // only row j of the last linear with the exact trace
        const bool row_j = kTrace == kExact && li == L - 1;
        const float* Wp = W + padded_at(net, li) + din * pad8(dout);
        quad_sync();
        if (reduce) {
          __syncthreads();
          reduce_outer(row_j ? j : 0, row_j ? j + 1 : dout, din, rows,
                       [&](int o, int r) { return blk(cs + o, r); },
                       [&](int q, int r) { return blk(hs.d + lo + q, r) * blk(hs.v + lo + q, r); },
                       net.off[li], din, inc, err, cb5, ce);
        }
        const Column cur = blk.row(cs), nxt = blk.row(ns);
        const auto pull = [&](int q, float w) {
          const float dq = d[lo + q];
          ht[lo + q] = fmaf(z[lo + q] > 0.0f ? 0.0f : dq * v[lo + q], w, ht[lo + q]);
          nxt[q] = dq * w;
        };
        if (row_j) {
          const float cj = cur[j];
          for (int q = ql; q < din; q += kQuad) pull(q, Wp[j * pad8(din) + q] * cj);
        } else {
          tmatvec_t(Wp, din, dout, cur, pull);
        }
        const int t = cs;
        cs = ns;
        ns = t;
        if (li > 1) lo -= net.w[li - 1];
      }
      quad_sync();
      if (reduce) {
        __syncthreads();
        if (kTrace == kExact) {  // the right vector is e_j: column j
          reduce_outer(0, H1, 1, rows, [&](int o, int r) { return blk(cs + o, r); }, one,
                       net.off[0] + j, F, inc, err, cb5, ce);
        } else {
          reduce_outer(0, H1, F, rows, [&](int o, int r) { return blk(cs + o, r); },
                       [&](int q, int r) { return blk(hs.e + q, r); }, net.off[0], F, inc, err,
                       cb5, ce);
        }
        __syncthreads();  // before the next pullback writes its first cotangent
      }
    }
  }
  // the primal part, from hbar_L = a
  int cs = hs.c0, ns = hs.c1;
  quad_sync();
  {
    const Column cur = blk.row(cs);
    for (int o = ql; o < F; o += kQuad) cur[o] = as[o];
  }
  int lo = top;
  for (int li = L - 1; li >= 1; --li) {
    const int din = net.w[li], dout = net.w[li + 1];
    quad_sync();
    if (reduce) {
      __syncthreads();
      const auto left = [&](int o, int r) { return blk(cs + o, r); };
      reduce_outer(0, dout, din, rows, left, [&](int q, int r) { return blk(hs.z + lo + q, r); },
                   net.off[li], din, inc, err, cb5, ce);
      reduce_outer(0, dout, 1, rows, left, one, net.off[li] + dout * din, 1, inc, err, cb5, ce);
    }
    const Column cur = blk.row(cs), nxt = blk.row(ns);
    tmatvec_t(W + padded_at(net, li) + din * pad8(dout), din, dout, cur, [&](int q, float w) {
      const float hq = d[lo + q] * w;
      nxt[q] = kTrace != kNone ? hq + ht[lo + q] : hq;
    });
    const int t = cs;
    cs = ns;
    ns = t;
    if (li > 1) lo -= net.w[li - 1];
  }
  quad_sync();
  const Column cur = blk.row(cs);
  if (reduce) {
    __syncthreads();
    reduce_outer(0, H1, F, rows, [&](int o, int r) { return blk(cs + o, r); },
                 [&](int q, int r) { return blk(hs.us + q, r); }, net.off[0], F, inc, err, cb5,
                 ce);
    // the first bias (unless per row) and W1_te from the rows' sums
    for (int o = tid; o < H1; o += blockDim.x) {
      float sum = 0.0f;
      for (int r = 0; r < rows; ++r) sum += blk(cs + o, r);
      const auto add = [&](int at, float k) {
        inc[at] = fmaf(cb5, k, inc[at]);
        err[at] = fmaf(ce, k, err[at]);
      };
      if (!kRowBias) add(net.off_b1 + o, -sum);
      const int nf = net.nf;
      for (int k = 0; k < nf; ++k) {
        const float ft = net.freqs[k] * st;
        add(net.off_te + o * 2 * nf + k, -sum * cosf(ft));
        add(net.off_te + o * 2 * nf + nf + k, -sum * sinf(ft));
      }
    }
  }
  tmatvec_t(Wp0, F, H1, cur, [&](int q, float w) { ka[s * F + q] = -w; });
  if (kRowBias)
    for (int o = ql; o < H1; o += kQuad) {
      incb[o] = fmaf(cb5, -cur[o], incb[o]);
      errb[o] = fmaf(ce, -cur[o], errb[o]);
    }
  quad_sync();                  // ka, before the next stage's inputs read it
  if (reduce) __syncthreads();  // the rows' columns are read no more this stage
}

template <int kTrace, bool kRowBias>
__global__ void __launch_bounds__(kAdjRows * kQuad)
    cnf_adjoint_cluster(const float* __restrict__ xin, const float* __restrict__ ain,
                        const float* __restrict__ glq, const float* __restrict__ eps,
                        const float* __restrict__ bias_rows, float* __restrict__ u_out,
                        float* __restrict__ a_out, float* __restrict__ g_out,
                        float* __restrict__ gb_out, const float* __restrict__ packed,
                        const float* __restrict__ padded, const __grid_constant__ Net net,
                        const __grid_constant__ AdjTile at, float* work, long long stride,
                        long long row0, long long row_end) {
  extern __shared__ __align__(16) float smem[];
  const int F = net.F, H1 = net.w[1], P = net.total, tid = threadIdx.x, nt = blockDim.x;
  const int cl = at.cl, rb = at.rb, rank = blockIdx.x % cl, ql = quad_lane();
  const long long i0 = (long long)blockIdx.x * rb, i = i0 + tid / kQuad;  // rows in the chunk
  const long long row = row0 + i;
  const bool valid = row < row_end;
  // shared memory: [padded weights][te][red][the rows' columns]
  float* te = smem + (at.weights_shared ? at.weights : 0);
  float* red = te + pad8(H1);
  const float* W = padded;
  if (at.weights_shared) {
    for (int q = tid; q < at.weights; q += nt) smem[q] = padded[q];
    W = smem;
  }
  const int sh = sum_hidden(net);
  const HotSlots hs(F, sh, max_width(net));
  // the workspace: per row ku, ka, [gb, incb, errb], [the columns]; then per
  // block the increments and errors of the parameters' accumulators
  const auto wcol = [&](long long slot) { return Column{work + slot * stride + i, stride}; };
  const Column ku = wcol(0), ka = wcol(7LL * F);
  const Column gb = wcol(14LL * F), incb = wcol(14LL * F + H1), errb = wcol(14LL * F + 2 * H1);
  const long long hot_at = 14LL * F + (kRowBias ? 3LL * H1 : 0);
  const Block blk = at.rows_shared ? Block{red + kRed, at.rbs, rb}
                                   : Block{work + hot_at * stride + i0, stride, rb};
  float* inc = work + at.row_floats * stride + (long long)blockIdx.x * 2 * P;
  float* err = inc + P;
  const long long tile0 = (long long)blockIdx.x - rank;  // the tile's first block
  float* g = g_out + (row0 / ((long long)rb * cl) + blockIdx.x / cl) * (long long)P;
  // this rank's share of the tile's accumulators
  const int e0 = (int)((long long)P * rank / cl), e1 = (int)((long long)P * (rank + 1) / cl);
  for (int q = tid; q < P; q += nt) inc[q] = err[q] = 0.0f;
  for (int q = e0 + tid; q < e1; q += nt) g[q] = 0.0f;
  const float* brow = kRowBias && valid ? bias_rows + row * H1 : nullptr;
  const float lbar = kTrace != kNone && valid ? glq[row] : 0.0f;
  const Column u = blk.row(hs.u), a = blk.row(hs.a), e = blk.row(hs.e);
  for (int f = ql; f < F; f += kQuad) {
    u[f] = valid ? xin[row * F + f] : 0.0f;
    a[f] = valid ? ain[row * F + f] : 0.0f;
    if (kTrace == kHutchinson) e[f] = valid ? eps[row * F + f] : 0.0f;
  }
  if (kRowBias)
    for (int o = ql; o < H1; o += kQuad) gb[o] = incb[o] = errb[o] = 0.0f;
  __syncthreads();
  const Column us = blk.row(hs.us), as = blk.row(hs.as);
  // the tile's accumulators' increments and errors at entry q: the blocks'
  // in rank order
  const auto tile_sum = [&](int q, float* k_err) {
    float si = 0.0f, se = 0.0f;
    for (int b = 0; b < cl; ++b) {
      const float* ib = work + at.row_floats * stride + (tile0 + b) * 2LL * P;
      si += ib[q];
      se += ib[P + q];
    }
    *k_err = se;
    return si;
  };
  float t = 0.0f, dt = 1.0f;
  for (int attempt = 0; t < 1.0f && attempt < net.max_attempts; ++attempt) {
    dt = fminf(dt, 1.0f - t);
    for (int s = 0; s < 7; ++s) {
      for (int f = ql; f < F; f += kQuad) {
        float vu = u[f], va = a[f];
        for (int q = 0; q < s; ++q)
          if (kDpA[s][q] != 0.0f) {
            vu = fmaf(dt * kDpA[s][q], ku[q * F + f], vu);
            va = fmaf(dt * kDpA[s][q], ka[q * F + f], va);
          }
        us[f] = vu;
        as[f] = va;
      }
      const float st = t + kDpC[s] * dt;
      time_embedding(net, packed, st, kRowBias, te);  // and the block's barrier
      adjoint_tile_stage<kTrace, kRowBias>(net, W, packed, te, brow, lbar, blk, hs, ku, ka, incb,
                                           errb, s, kDpB5[s] != 0.0f || kDpE[s] != 0.0f, inc,
                                           err, dt * kDpB5[s], dt * kDpE[s], st);
    }
    __threadfence();
    cluster_sync(cl);  // every block's increments and errors are in
    // the row's error ratio over u, a (and its first bias), this rank's
    // share of the tile's accumulators, then the tile's
    float ratio = 0.0f;
    const auto worst = [&](float x0, float y, float e) {
      float q = fabsf(e) / (net.atol + net.rtol * fmaxf(fabsf(x0), fabsf(y)));
      if (isnan(q)) q = INFINITY;
      ratio = fmaxf(ratio, q);
    };
    if (valid) {
      for (int f = ql; f < F; f += kQuad) {
        float yu = u[f], ya = a[f], eu = 0.0f, ea = 0.0f;
        for (int q = 0; q < 7; ++q) {
          if (kDpB5[q] != 0.0f) {
            yu = fmaf(dt * kDpB5[q], ku[q * F + f], yu);
            ya = fmaf(dt * kDpB5[q], ka[q * F + f], ya);
          }
          if (kDpE[q] != 0.0f) {
            eu = fmaf(dt * kDpE[q], ku[q * F + f], eu);
            ea = fmaf(dt * kDpE[q], ka[q * F + f], ea);
          }
        }
        worst(u[f], yu, eu);
        worst(a[f], ya, ea);
      }
      if (kRowBias)
        for (int o = ql; o < H1; o += kQuad) worst(gb[o], gb[o] + incb[o], errb[o]);
    }
    for (int q = e0 + tid; q < e1; q += nt) {
      float ke;
      const float ki = tile_sum(q, &ke);
      worst(g[q], g[q] + ki, ke);
    }
    ratio = block_max(ratio, red);
    if (cl > 1) {
      if (tid == 0) red[kRed - 1] = ratio;
      cluster_sync(cl);
      for (int b = 0; b < cl; ++b) ratio = fmaxf(ratio, cluster_peer(red + kRed - 1, b));
    }
    if (ratio <= 1.0f) {
      if (valid)
        for (int f = ql; f < F; f += kQuad) {
          float yu = u[f], ya = a[f];
          for (int q = 0; q < 7; ++q)
            if (kDpB5[q] != 0.0f) {
              yu = fmaf(dt * kDpB5[q], ku[q * F + f], yu);
              ya = fmaf(dt * kDpB5[q], ka[q * F + f], ya);
            }
          u[f] = yu;
          a[f] = ya;
        }
      if (kRowBias)
        for (int o = ql; o < H1; o += kQuad) gb[o] += incb[o];
      for (int q = e0 + tid; q < e1; q += nt) {
        float ke;
        g[q] += tile_sum(q, &ke);
      }
      t += dt;
    }
    cluster_sync(cl);  // every rank has read the blocks' increments and its peers' max
    for (int q = tid; q < P; q += nt) inc[q] = err[q] = 0.0f;
    if (kRowBias)
      for (int o = ql; o < H1; o += kQuad) incb[o] = errb[o] = 0.0f;
    dt *= fminf(fmaxf(0.9f * powf(fmaxf(ratio, FLT_MIN), -0.2f), 0.1f), 10.0f);
  }
  const bool exhausted = t < 1.0f - 64.0f * FLT_EPSILON;
  if (exhausted)
    for (int q = e0 + tid; q < e1; q += nt) g[q] = NAN;
  if (!valid) return;
  for (int f = ql; f < F; f += kQuad) {
    u_out[row * F + f] = exhausted ? NAN : u[f];
    a_out[row * F + f] = exhausted ? NAN : a[f];
  }
  if (kRowBias)
    for (int o = ql; o < H1; o += kQuad) gb_out[row * H1 + o] = exhausted ? NAN : gb[o];
}

// ------------------------------------------------------------------------
// The narrow tier of cnf_density (K10) and cnf_sample (K11): cnf_cluster, a
// tile over a cluster of blocks, as K12's cnf_adjoint_cluster.
//
// The same function as cnf_kernel<trace, reverse, row bias> (the same tile
// of rows, stages, error ratio, step rule and NaN-poisoning); only the order
// of float32 sums could change, and it does not: every sum keeps the
// one-thread-a-row order. What held the per-thread design back (a row's
// 1,060 floats in local memory, one shared-memory load a multiply-add, the
// exact trace's chain repeated F times a row, and for K11 at (l)'s 16,384
// rows 64 blocks on 132 SMs) it does so:
// - a tile of `tile` rows (256) is a cluster of cl blocks of rb = 64 rows,
//   384 threads a block; the tile's step decision is the max of the
//   blocks' ratios through distributed shared memory and a cluster barrier;
// - the rows' state are columns [slot][row] of the block's shared memory:
//   x, the stage inputs, the probe, the 7 stage slopes of x and l, the
//   hidden activations (one buffer, each layer written over its input), the
//   ELU derivatives of every hidden layer, the tangents; the padded weights
//   W^T [in][pad8(out)] (_padded_weights in ops/cnf_fused.py, K12's) beside
//   them (W^T only), the biases and W1_te through the read-only cache;
// - each product is register-blocked from shared memory (den_product): a
//   thread owns 4 rows (columns of the tile) x 8 outputs, its operands in
//   three 16-byte loads for 32 multiply-adds, each sum from its init in the
//   order of the inputs;
// - the exact trace's F tangent columns v <- W (d o v) ride the same
//   products as extra columns, nc = F of them a pass where shared memory
//   holds them (the flagship) and fewer a pass, down to one, where it does
//   not (density_plan); only row j of the last layer is taken for column j;
//   Hutchinson's trace takes the probe as one column;
// - the sampler (kReverse) takes the time embedding at 1 - t and stores
//   each slope negated, as the wide tier negates it after the stage;
//   without a trace (kNone, K11 without log q) it keeps no probe, l, ELU
//   derivatives, trace terms or tangents: its error ratio is over x alone,
//   and its block of about 50 KB runs two to an SM.

constexpr int kDenRows = 64;      // rows of a block
constexpr int kDenThreads = 384;  // threads of a block

// The narrow tier's plan of a launch (density_plan; mirrored in
// ops/cnf_fused.py plan_cnf): the cluster and its blocks, the tangent
// columns a pass, and the block's shared memory as float offsets (every one
// a multiple of 4).
struct DenTile {
  int cl, rb, lr, nc;  // blocks a tile, rows a block and log2 of it, tangent columns a pass
  int weights;  // the padded weights, from offset 0
  int te, red, x, xs, e, l, k, act, d, tj, v;
  int smem_floats;
};

// Where linear li's W^T starts among the staged weights (W^T of each linear,
// one after another).
__device__ __forceinline__ int den_at(const Net& net, int li) {
  int off = 0;
  for (int m = 0; m < li; ++m) off += net.w[m] * pad8(net.w[m + 1]);
  return off;
}

// out(o, c0, acc) for the patch's kPC columns c0 .. c0 + kPC - 1, acc[i] =
// init(o, c0 + i) + sum_q W[o, q] in[q][c0 + i] in the order of q (one fmaf
// a term), for o < dout and the ncols columns of `in` ([din][ld]); W from
// WT = W^T [din][pad8(dout)]. A thread a patch of kPC columns x 8 outputs.
// A round takes whole column groups, the column groups fastest within a
// warp (the weights a broadcast, the columns' loads and out's vector stores
// conflict-free), and writes after the round's barrier, so out may write
// over in. Ends synchronised.
template <int kPC, class Init, class Out>
__device__ __forceinline__ void den_product(const float* in, int din, int ld, const float* WT,
                                            int dout, int ncols, Init init, Out out) {
  const int dp = pad8(dout), ncg = dp >> 3, groups = ncols / kPC;
  const int per_round = min(groups, kDenThreads / ncg), tid = threadIdx.x;
  for (int g0 = 0; g0 < groups; g0 += per_round) {
    const int og = tid / per_round, g = g0 + tid - og * per_round;
    const bool mine = og < ncg && g < groups;
    const int c0 = g * kPC;
    float acc[8][kPC];
    if (mine) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < kPC; ++i) acc[j][i] = 8 * og + j < dout ? init(8 * og + j, c0 + i) : 0.0f;
      const float* ap = in + c0;
      const float* wp = WT + 8 * og;
#pragma unroll 4
      for (int k = 0; k < din; ++k) {
        float av[kPC];
        if constexpr (kPC == 4) {
          const float4 a = *reinterpret_cast<const float4*>(ap + k * ld);
          av[0] = a.x, av[1] = a.y, av[2] = a.z, av[3] = a.w;
        } else if constexpr (kPC == 2) {
          const float2 a = *reinterpret_cast<const float2*>(ap + k * ld);
          av[0] = a.x, av[1] = a.y;
        } else {
          av[0] = ap[k * ld];
        }
        const float4 b0 = *reinterpret_cast<const float4*>(wp + k * dp);
        const float4 b1 = *reinterpret_cast<const float4*>(wp + k * dp + 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kPC; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j][i] = fmaf(bv[j], av[i], acc[j][i]);
      }
    }
    __syncthreads();  // the round's columns are read
    if (mine) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * og + j < dout) out(8 * og + j, c0, acc[j]);
    }
  }
  __syncthreads();
}

// kPC floats of v from v[0], and a store of kPC floats, in one access.
template <int kPC>
__device__ __forceinline__ void vload(const float* p, float* v) {
  if constexpr (kPC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (kPC == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

template <int kPC>
__device__ __forceinline__ void vstore(float* p, const float* v) {
  if constexpr (kPC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kPC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// A hidden layer's post: its ELU into act and elu' into d, kPC columns.
template <int kPC>
__device__ __forceinline__ void elu_out(float* act, float* d, const float* acc) {
  float z[kPC], e[kPC];
#pragma unroll
  for (int i = 0; i < kPC; ++i) {
    z[i] = acc[i] > 0.0f ? acc[i] : expm1f(acc[i]);
    e[i] = acc[i] > 0.0f ? 1.0f : expf(acc[i]);
  }
  vstore<kPC>(act, z);
  vstore<kPC>(d, e);
}

// A tangent's post: v = elu'(h) o (W v), kPC columns.
template <int kPC>
__device__ __forceinline__ void tangent_out(float* v, const float* d, const float* acc) {
  float dv[kPC], r[kPC];
  vload<kPC>(d, dv);
#pragma unroll
  for (int i = 0; i < kPC; ++i) r[i] = dv[i] * acc[i];
  vstore<kPC>(v, r);
}

// One evaluation of the dynamics for the block's rows at their stage inputs
// xs, into slope slot s: F values, then (kTrace != kNone) trace_scale times
// the trace; each negated for the sampler (kReverse). W the padded weights in
// shared memory, packed the biases (read-only cache), te the tile's
// time-embedding term, brows the block's first per-row biases (or null).
template <int kTrace, bool kReverse, bool kRowBias>
__device__ __forceinline__ void den_stage(const Net& net, const float* W,
                                          const float* __restrict__ packed, const DenTile& tl,
                                          float* sm, const float* brows, int rows, int s) {
  const int F = net.F, L = net.n_lin, H1 = net.w[1], rb = tl.rb, tid = threadIdx.x;
  const int ne = kTrace == kNone ? F : F + 1;  // the slopes of x, then of l
  const float sign = kReverse ? -1.0f : 1.0f;
  const float* te = sm + tl.te;
  float* act = sm + tl.act;
  float* d = sm + tl.d;
  float* k = sm + tl.k + s * ne * rb;  // slot s: [ne][rb]
  const float* WT0 = W + padded_at(net, 0);
  // rows past n (c >= rows) have no first bias of their own
  const auto first = [&](int o, int c) {
    return kRowBias && c < rows ? te[o] + __ldg(brows + (long long)c * H1 + o) : te[o];
  };
  // a hidden layer's post: the ELU into act, and elu' into d where a trace
  // needs it
  const auto hidden = [&](float* a_out, float* d_out, const float* a) {
    if constexpr (kTrace == kNone) {
      float z[2];
      for (int i = 0; i < 2; ++i) z[i] = a[i] > 0.0f ? a[i] : expm1f(a[i]);
      vstore<2>(a_out, z);
    } else {
      elu_out<2>(a_out, d_out, a);
    }
  };
  if (L == 1) {
    den_product<2>(sm + tl.xs, F, rb, WT0, F, rb, first, [&](int o, int c, const float* a) {
      const float v[2] = {sign * a[0], sign * a[1]};
      vstore<2>(k + o * rb + c, v);
    });
  } else {
    den_product<2>(sm + tl.xs, F, rb, WT0, H1, rb, first, [&](int o, int c, const float* a) {
      hidden(act + o * rb + c, d + o * rb + c, a);
    });
  }
  int dofs = 0;  // where elu' of the current hidden layer starts in d
  for (int i = 1; i < L; ++i) {
    const int din = net.w[i], dout = net.w[i + 1];
    const float* WTi = W + den_at(net, i);
    const float* bi = packed + net.off[i] + dout * din;
    const auto bias = [&](int o, int) { return __ldg(bi + o); };
    if (i == L - 1) {
      den_product<1>(act, din, rb, WTi, dout, rb, bias,
                     [&](int o, int c, const float* a) { k[o * rb + c] = sign * a[0]; });
    } else {
      const int at = dofs + din;
      den_product<2>(act, din, rb, WTi, dout, rb, bias, [&](int o, int c, const float* a) {
        hidden(act + o * rb + c, d + (at + o) * rb + c, a);
      });
      dofs += din;
    }
  }
  if constexpr (kTrace == kNone) {
    return;  // den_product ends synchronised
  } else {
    const float* e = sm + tl.e;
    float* tj = sm + tl.tj;
    if (L == 1) {
      if (tid < rb) {
        float tr = 0.0f;
        const int dp = pad8(F);
        for (int j = 0; j < F; ++j) {
          if (kTrace == kExact) {
            tr += WT0[j * dp + j];
          } else {
            float acc = 0.0f;
            for (int q = 0; q < F; ++q) acc = fmaf(WT0[q * dp + j], e[q * rb + tid], acc);
            tr = fmaf(e[j * rb + tid], acc, tr);
          }
        }
        k[F * rb + tid] = sign * (tr * net.scale);
      }
      __syncthreads();
      return;
    }
    float* v = sm + tl.v;
    const int dl = net.w[L - 1], dpl = pad8(F), dp1 = pad8(H1);
    const float* WTL = W + den_at(net, L - 1);
    const int cols = kTrace == kExact ? tl.nc : 1, ldv = cols * rb;
    for (int j0 = 0; j0 < (kTrace == kExact ? F : 1); j0 += cols) {
      const int nc = kTrace == kExact ? min(cols, F - j0) : 1, nv = nc * rb;
      // v = elu'(h1) o W1_x[:, j] (exact) or elu'(h1) o (W1_x e)
      if (kTrace == kExact) {
        const int r = tid & (rb - 1);
        for (int jj = 0; jj < nc; ++jj)
          for (int o = tid >> tl.lr; o < H1; o += kDenThreads >> tl.lr)
            v[o * ldv + jj * rb + r] = d[o * rb + r] * WT0[(j0 + jj) * dp1 + o];
        __syncthreads();
      } else {
        den_product<4>(e, F, rb, WT0, H1, rb, [](int, int) { return 0.0f; },
                       [&](int o, int c, const float* u) {
                         tangent_out<4>(v + o * ldv + c, d + o * rb + c, u);
                       });
      }
      int dv = 0;
      for (int i = 1; i < L - 1; ++i) {
        const int din = net.w[i], dout = net.w[i + 1];
        dv += din;
        den_product<4>(v, din, ldv, W + den_at(net, i), dout, nv, [](int, int) { return 0.0f; },
                       [&](int o, int c, const float* a) {
                         tangent_out<4>(v + o * ldv + c, d + (dv + o) * rb + (c & (rb - 1)), a);
                       });
      }
      // exact: row j of the last layer for column j; Hutchinson: every row
      const int outs = kTrace == kExact ? nv : F * rb;
      for (int q = tid; q < outs; q += kDenThreads) {
        const int r = q & (rb - 1), j = (kTrace == kExact ? j0 : 0) + (q >> tl.lr);
        const int c = kTrace == kExact ? q : r;
        float acc = 0.0f;
        for (int p = 0; p < dl; ++p) acc = fmaf(WTL[p * dpl + j], v[p * ldv + c], acc);
        tj[j * rb + r] = acc;
      }
      __syncthreads();
    }
    if (tid < rb) {
      float tr = 0.0f;
      for (int j = 0; j < F; ++j) {
        if (kTrace == kExact) {
          tr += tj[j * rb + tid];
        } else {
          tr = fmaf(e[j * rb + tid], tj[j * rb + tid], tr);
        }
      }
      k[F * rb + tid] = sign * (tr * net.scale);
    }
    __syncthreads();
  }
}

// K10 (kReverse false: out_lp the log-densities of xin) and K11 (kReverse
// true: out_x the samples of the base draws xin, and with a trace out_lp
// their log q) over tiles of tl.cl blocks of tl.rb rows.
template <int kTrace, bool kReverse, bool kRowBias>
__global__ void __launch_bounds__(kDenThreads, kTrace == kNone ? 2 : 1)
    cnf_cluster(const float* __restrict__ xin, const float* __restrict__ eps,
                const float* __restrict__ bias_rows, float* __restrict__ out_x,
                float* __restrict__ out_lp, const float* __restrict__ packed,
                const float* __restrict__ padded, const __grid_constant__ Net net,
                const __grid_constant__ DenTile tl, long long n) {
  extern __shared__ __align__(16) float sm[];
  const int F = net.F, H1 = net.w[1], rb = tl.rb, cl = tl.cl, tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * rb;  // the block's first row
  // each linear's W^T from the padded copies (W^T, then W, per linear)
  for (int i = 0, at = 0; i < net.n_lin; ++i) {
    const int size = net.w[i] * pad8(net.w[i + 1]);
    const float4* src = reinterpret_cast<const float4*>(padded + padded_at(net, i));
    float4* dst = reinterpret_cast<float4*>(sm + at);
    for (int q = tid; q < (size >> 2); q += kDenThreads) dst[q] = src[q];
    at += size;
  }
  float* te = sm + tl.te;
  float* red = sm + tl.red;
  float* x = sm + tl.x;
  float* xs = sm + tl.xs;
  float* lrow = sm + tl.l;  // l: none without a trace
  const float* k = sm + tl.k;
  const float* brows = kRowBias ? bias_rows + row0 * H1 : nullptr;
  const int rows = n - row0 < rb ? (int)(n - row0) : rb;  // of this block, below n
  const int lr = tl.lr;
  for (int q = tid; q < F * rb; q += kDenThreads) {
    const int f = q >> lr, r = q & (rb - 1);
    const bool valid = row0 + r < n;
    x[q] = valid ? xin[(row0 + r) * F + f] : 0.0f;
    if (kTrace == kHutchinson) sm[tl.e + q] = valid ? eps[(row0 + r) * F + f] : 0.0f;
  }
  if (kTrace != kNone)
    for (int r = tid; r < rb; r += kDenThreads) lrow[r] = 0.0f;
  __syncthreads();
  const int ne = kTrace == kNone ? F : F + 1;  // x, and l with a trace
  float t = 0.0f, dt = 1.0f;
  for (int attempt = 0; t < 1.0f && attempt < net.max_attempts; ++attempt) {
    dt = fminf(dt, 1.0f - t);
    for (int s = 0; s < 7; ++s) {
      for (int q = tid; q < F * rb; q += kDenThreads) {
        const int f = q >> lr, r = q & (rb - 1);
        float v = x[q];
        for (int p = 0; p < s; ++p)
          if (kDpA[s][p] != 0.0f) v = fmaf(dt * kDpA[s][p], k[(p * ne + f) * rb + r], v);
        xs[q] = v;
      }
      const float st = t + kDpC[s] * dt;
      // and the block's barriers
      time_embedding(net, packed, kReverse ? 1.0f - st : st, kRowBias, te);
      den_stage<kTrace, kReverse, kRowBias>(net, sm, packed, tl, sm, brows, rows, s);
    }
    // the rows' error ratios, then the tile's
    float ratio = 0.0f;
    for (int q = tid; q < ne * rb; q += kDenThreads) {
      const int f = q >> lr, r = q & (rb - 1);
      if (row0 + r >= n) continue;
      const float x0 = f < F ? x[q] : lrow[r];
      float err = 0.0f, y = x0;
      for (int p = 0; p < 7; ++p) {
        if (kDpE[p] != 0.0f) err = fmaf(dt * kDpE[p], k[(p * ne + f) * rb + r], err);
        if (kDpB5[p] != 0.0f) y = fmaf(dt * kDpB5[p], k[(p * ne + f) * rb + r], y);
      }
      float e = fabsf(err) / (net.atol + net.rtol * fmaxf(fabsf(x0), fabsf(y)));
      if (isnan(e)) e = INFINITY;
      ratio = fmaxf(ratio, e);
    }
    ratio = block_max(ratio, red);
    if (cl > 1) {
      if (tid == 0) red[kRed - 1] = ratio;
      cluster_sync(cl);
      for (int b = 0; b < cl; ++b) ratio = fmaxf(ratio, cluster_peer(red + kRed - 1, b));
    }
    if (ratio <= 1.0f) {
      for (int q = tid; q < ne * rb; q += kDenThreads) {
        const int f = q >> lr, r = q & (rb - 1);
        float y = f < F ? x[q] : lrow[r];
        for (int p = 0; p < 7; ++p)
          if (kDpB5[p] != 0.0f) y = fmaf(dt * kDpB5[p], k[(p * ne + f) * rb + r], y);
        if (f < F) {
          x[q] = y;
        } else {
          lrow[r] = y;
        }
      }
      t += dt;
    }
    cluster_sync(cl);  // every rank has read its peers' max; x and l are whole
    dt *= fminf(fmaxf(0.9f * powf(fmaxf(ratio, FLT_MIN), -0.2f), 0.1f), 10.0f);
  }
  const bool exhausted = t < 1.0f - 64.0f * FLT_EPSILON;
  if (kReverse)
    for (int q = tid; q < F * rb; q += kDenThreads) {
      const int f = q >> lr, r = q & (rb - 1);
      if (row0 + r < n) out_x[(row0 + r) * F + f] = exhausted ? NAN : x[q];
    }
  if (kTrace == kNone || tid >= rb || row0 + tid >= n) return;
  const float l = exhausted ? NAN : lrow[tid];
  if (kReverse) {  // log q: the base's log-density at the draw, less l / s
    float base = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float v = xin[(row0 + tid) * F + f];
      base = fmaf(-0.5f * v, v, base);
    }
    out_lp[row0 + tid] = base - F * kHalfLog2Pi - l / net.scale;
  } else {
    float sq = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float v = exhausted ? NAN : x[f * rb + tid];
      sq = fmaf(v, v, sq);
    }
    out_lp[row0 + tid] = -0.5f * sq - F * kHalfLog2Pi + l / net.scale;
  }
}

// The network as the host describes it: the widths, the offsets of the
// linears in the packed buffer, the frequencies, the tolerances.
struct Desc {
  int F, nf, n_lin, off_te, off_b1, total, max_attempts, sum_hidden, max_hidden;
  float atol, rtol, scale;
  std::vector<int> w, off;
  std::vector<float> freqs;
};

int describe(Desc* d, const int* widths, int n_lin, int nf, const float* freqs, float atol,
             float rtol, float scale, int max_steps, bool row_bias) {
  if (n_lin < 1 || nf < 0 || max_steps < 1 || !(scale > 0.0f)) return cudaErrorInvalidValue;
  d->F = widths[0];
  d->nf = nf;
  d->n_lin = n_lin;
  d->atol = atol;
  d->rtol = rtol;
  d->scale = scale;
  d->max_attempts = 4 * max_steps;
  if (d->F < 1 || widths[n_lin] != d->F) return cudaErrorInvalidValue;
  d->sum_hidden = 0;
  d->max_hidden = 1;
  for (int i = 0; i <= n_lin; ++i) {
    if (widths[i] < 1) return cudaErrorInvalidValue;
    d->w.push_back(widths[i]);
    if (i > 0 && i < n_lin) {
      d->sum_hidden += widths[i];
      d->max_hidden = widths[i] > d->max_hidden ? widths[i] : d->max_hidden;
    }
  }
  // W1_x, W1_te, the first bias unless per row, then each linear and its bias
  const int H1 = widths[1];
  long long off = 0;
  d->off.push_back(0);
  off += (long long)H1 * d->F;
  d->off_te = (int)off;
  off += 2LL * H1 * nf;
  d->off_b1 = (int)off;
  if (!row_bias) off += H1;
  for (int i = 1; i < n_lin; ++i) {
    d->off.push_back((int)off);
    off += (long long)widths[i + 1] * (widths[i] + 1);
  }
  if (off > 0x7fffffffLL) return cudaErrorInvalidValue;  // offsets are ints
  d->total = (int)off;
  for (int q = 0; q < nf; ++q) d->freqs.push_back(freqs[q]);
  return cudaSuccess;
}

bool fits_narrow(const Desc& d) {
  return d.F <= kMaxF && d.n_lin <= kMaxLinear && d.nf <= kMaxFreqs &&
         d.total <= kMaxSharedFloats && (d.n_lin == 1 || d.max_hidden <= kMaxWidth);
}

Net narrow_net(const Desc& d) {
  Net s;
  s.F = d.F;
  s.nf = d.nf;
  s.n_lin = d.n_lin;
  s.off_te = d.off_te;
  s.off_b1 = d.off_b1;
  s.total = d.total;
  s.max_attempts = d.max_attempts;
  s.atol = d.atol;
  s.rtol = d.rtol;
  s.scale = d.scale;
  for (int i = 0; i <= d.n_lin; ++i) s.w[i] = d.w[i];
  for (int i = 0; i < d.n_lin; ++i) s.off[i] = d.off[i];
  for (int q = 0; q < d.nf; ++q) s.freqs[q] = d.freqs[q];
  return s;
}

// The wide tier's description: the widths, offsets and frequencies copied in
// one transfer into the device buffer `desc` (a pageable source is staged
// before cudaMemcpyAsync returns), the scalars in *s.
int wide_net(const Desc& d, void* desc, long long desc_bytes, cudaStream_t stream, WideNet* s) {
  const long long need = (2LL * d.n_lin + 1 + d.nf) * 4;
  if (desc == nullptr || desc_bytes < need) return cudaErrorInvalidValue;
  std::vector<unsigned char> image((size_t)need, 0);
  int* iw = (int*)image.data();
  for (int v : d.w) *iw++ = v;
  for (int v : d.off) *iw++ = v;
  memcpy(iw, d.freqs.data(), d.freqs.size() * sizeof(float));
  const int rc = cudaMemcpyAsync(desc, image.data(), (size_t)need, cudaMemcpyHostToDevice, stream);
  if (rc != cudaSuccess) return rc;
  const int* dw = (const int*)desc;
  *s = WideNet{d.F, d.nf, d.n_lin, d.off_te, d.off_b1, d.total, d.max_attempts,
               d.atol, d.rtol, d.scale, dw, dw + d.n_lin + 1,
               (const float*)(dw + 2 * d.n_lin + 1), d.sum_hidden, d.max_hidden};
  return cudaSuccess;
}

// What a launch needs besides the network: the input, the probe, the per-row
// first biases, the outputs, the packed weights, the rows, the tier, the wide
// tier's workspace (work_floats floats, `stride` rows a launch) and
// descriptor buffer (desc_bytes bytes).
struct Launch {
  const float* in;
  const float* eps;
  const float* bias;
  float* out_x;
  float* out_lp;
  const float* packed;
  long long n;
  int wide;
  float* work;
  long long work_floats, stride;
  void* desc;
  long long desc_bytes;
  cudaStream_t stream;
  const float* padded;  // the narrow tier: the padded linears (_padded_weights)
  int tile;             // and its tile rows
};

// The wide tier: the rows in chunks of `stride`, one launch each, a block a
// tile.
template <int kTrace, bool kReverse, bool kRowBias>
int launch(const Launch& l, const WideNet& s, size_t smem) {
  auto kernel = cnf_kernel<kTrace, kReverse, kRowBias>;
  if (smem > 48 * 1024) {
    const int rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  for (long long row0 = 0; row0 < l.n; row0 += l.stride) {
    const long long row_end = row0 + l.stride < l.n ? row0 + l.stride : l.n;
    const unsigned blocks = (unsigned)((row_end - row0 + kTile - 1) / kTile);
    kernel<<<blocks, kTile, smem, l.stream>>>(l.in, l.eps, l.bias, l.out_x, l.out_lp, l.packed,
                                              s, l.work, l.stride, row0, row_end);
    const int rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

// The narrow tier of cnf_density and cnf_sample for tiles of `tile` rows
// (cl = 0: no plan): a cluster of tile / rb blocks of rb = min(tile, 64)
// rows, or of 32 where 64 do not fit; shared memory holds the linears W^T
// [in][pad8(out)] one after another, the time-embedding term and the block
// max, then [slot][row] columns: x and the stage inputs (F each), and with
// a trace the probe (F) and l (1), the stage slopes (7 (F + 1) with a
// trace, 7 F without), the hidden activations (pad8(widest hidden)), and
// with a trace the ELU derivatives (sum of the hidden widths), the trace's
// terms (F) and the tangents, pad8(widest hidden) rows of nc rb columns:
// nc = F (exact) or 1 (Hutchinson), fewer where 227 KB cannot hold them.
DenTile density_plan(const Desc& d, int tile, int trace) {
  int hidden = 0, weights = 0;
  for (int i = 0; i < d.n_lin; ++i) {
    weights += d.w[i] * pad8(d.w[i + 1]);
    if (i > 0) hidden = d.w[i] > hidden ? d.w[i] : hidden;
  }
  hidden = pad8(hidden);
  const bool tr = trace != kNone;
  for (int rb = kDenRows; rb >= kDenRows / 2; rb /= 2) {
    DenTile t{};
    t.rb = tile < rb ? tile : rb;
    if (tile < 4 || tile % t.rb != 0 || (t.rb & (t.rb - 1)) != 0 || tile / t.rb > kMaxCluster)
      continue;
    while ((1 << t.lr) < t.rb) ++t.lr;
    const int F = d.F;
    t.weights = weights;
    int at = weights;
    t.te = at, at += pad8(d.w[1]);
    t.red = at, at += kRed;
    t.x = at, at += F * t.rb;
    t.xs = at, at += F * t.rb;
    t.e = at, at += tr ? F * t.rb : 0;
    t.l = at, at += tr ? t.rb : 0;
    t.k = at, at += 7 * (tr ? F + 1 : F) * t.rb;
    t.act = at, at += hidden * t.rb;
    t.d = at, at += tr ? d.sum_hidden * t.rb : 0;
    t.tj = at, at += tr ? F * t.rb : 0;
    t.v = at;
    // no tangents without a trace
    for (int nc = tr ? (trace == kExact ? F : 1) : 0; nc >= (tr ? 1 : 0); --nc) {
      if (4LL * (at + (long long)hidden * nc * t.rb) <= kMaxShared) {
        t.nc = nc;
        t.smem_floats = at + hidden * nc * t.rb;
        t.cl = tile / t.rb;
        return t;
      }
    }
  }
  return DenTile{};
}

// The narrow tier: the rows in one launch, a cluster of t.cl blocks of t.rb
// rows a tile.
template <int kTrace, bool kReverse, bool kRowBias>
int launch_cluster_tiles(const Launch& l, const Net& s, const DenTile& t) {
  auto kernel = cnf_cluster<kTrace, kReverse, kRowBias>;
  const size_t smem = 4 * (size_t)t.smem_floats;
  if (smem > 48 * 1024) {
    const int rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  if (l.n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((l.n + l.tile - 1) / l.tile * t.cl);
#ifdef __CUDACC__
  if (t.cl > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3((unsigned)kDenThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = l.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)t.cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int rc = cudaLaunchKernelEx(&cfg, kernel, l.in, l.eps, l.bias, l.out_x, l.out_lp,
                                      l.packed, l.padded, s, t, l.n);
    if (rc != cudaSuccess) return rc;
  } else
#endif
  {
    kernel<<<blocks, kDenThreads, smem, l.stream>>>(l.in, l.eps, l.bias, l.out_x, l.out_lp,
                                                    l.packed, l.padded, s, t, l.n);
  }
  return cudaGetLastError();
}

template <int kTrace, bool kReverse>
int run_mode(const Launch& l, const Desc& d) {
  const bool row_bias = l.bias != nullptr;
  if (!l.wide) {  // cnf_cluster
    if (!fits_narrow(d)) return cudaErrorInvalidValue;
    const Net s = narrow_net(d);
    const DenTile t = density_plan(d, l.tile, kTrace);
    if (t.cl == 0 || l.padded == nullptr) return cudaErrorInvalidValue;
    return row_bias ? launch_cluster_tiles<kTrace, kReverse, true>(l, s, t)
                    : launch_cluster_tiles<kTrace, kReverse, false>(l, s, t);
  }
  const long long slots = 3LL * d.F + 7LL * (d.F + 1) + d.sum_hidden + 4LL * d.max_hidden;
  if (l.work == nullptr || l.stride < kTile || l.stride % kTile != 0 ||
      slots * l.stride > l.work_floats)
    return cudaErrorInvalidValue;
  WideNet s;
  const int rc = wide_net(d, l.desc, l.desc_bytes, l.stream, &s);
  if (rc != cudaSuccess) return rc;
  const size_t te = (size_t)(d.w[1] + kRed) * sizeof(float);
  return row_bias ? launch<kTrace, kReverse, true>(l, s, te)
                  : launch<kTrace, kReverse, false>(l, s, te);
}

// What an adjoint launch needs: the inputs (samples, their cotangent, the
// log-q cotangent, the probe, the per-row first biases), the outputs (u1, a1,
// the per-tile partial sums, the per-row first bias's cotangent), the packed
// weights, the rows, the tile, the tier, the workspace (`stride` rows a
// launch) and the wide tier's descriptor buffer.
struct AdjointLaunch {
  const float *x, *a, *glq, *eps, *bias;
  float *u1, *a1, *g, *gb;
  const float *packed, *padded;
  long long n;
  int tile, wide;
  float* work;
  long long work_floats, stride;
  void* desc;
  long long desc_bytes;
  cudaStream_t stream;
};

template <int kTrace, bool kRowBias>
int launch_adjoint(const AdjointLaunch& l, const WideNet& s, long long row_floats,
                   long long tile_floats, size_t smem) {
  auto kernel = cnf_adjoint_kernel<kTrace, kRowBias>;
  if (smem > 48 * 1024) {
    const int rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  for (long long row0 = 0; row0 < l.n; row0 += l.stride) {
    const long long row_end = row0 + l.stride < l.n ? row0 + l.stride : l.n;
    const unsigned blocks = (unsigned)((row_end - row0 + l.tile - 1) / l.tile);
    kernel<<<blocks, l.tile, smem, l.stream>>>(l.x, l.a, l.glq, l.eps, l.bias, l.u1, l.a1, l.g,
                                               l.gb, l.packed, s, l.work, l.stride, row_floats,
                                               tile_floats, row0, row_end);
    const int rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

// The narrow tier's plan for tiles of `tile` rows (cl = 0: no plan).
AdjTile adjoint_plan(const Desc& d, int tile, bool row_bias) {
  AdjTile at{};
  at.rb = tile < kAdjRows ? tile : kAdjRows;
  if (tile < 1 || tile % at.rb != 0 || tile / at.rb > kMaxCluster) return at;
  at.cl = tile / at.rb;
  at.rbs = at.rb + 1;  // consecutive slots of one row fall on other banks
  int mw = 0;
  for (int i = 0; i <= d.n_lin; ++i) {
    mw = d.w[i] > mw ? d.w[i] : mw;
    if (i < d.n_lin) at.weights += d.w[i] * pad8(d.w[i + 1]) + d.w[i + 1] * pad8(d.w[i]);
  }
  at.hot = HotSlots(d.F, d.sum_hidden, mw).total;
  const int base = pad8(d.w[1]) + kRed;  // te and the block max
  at.weights_shared = 4LL * (at.weights + base) <= kMaxShared;
  at.rows_shared = at.weights_shared &&
                   4LL * (at.weights + base + (long long)at.hot * at.rbs) <= kMaxShared;
  at.smem_floats =
      (at.weights_shared ? at.weights : 0) + base + (at.rows_shared ? at.hot * at.rbs : 0);
  at.row_floats = 14LL * d.F + (row_bias ? 3LL * d.w[1] : 0) + (at.rows_shared ? 0 : at.hot);
  return at;
}

// The rows in chunks of `stride` (whole tiles), one launch each: a cluster
// of at.cl blocks of at.rb rows (a quad of threads a row) a tile.
template <int kTrace, bool kRowBias>
int launch_cluster(const AdjointLaunch& l, const Net& s, const AdjTile& at) {
  auto kernel = cnf_adjoint_cluster<kTrace, kRowBias>;
  const size_t smem = 4 * (size_t)at.smem_floats;
  if (smem > 48 * 1024) {
    const int rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  for (long long row0 = 0; row0 < l.n; row0 += l.stride) {
    const long long row_end = row0 + l.stride < l.n ? row0 + l.stride : l.n;
    const unsigned blocks = (unsigned)((row_end - row0 + l.tile - 1) / l.tile * at.cl);
#ifdef __CUDACC__
    if (at.cl > 1) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(blocks);
      cfg.blockDim = dim3((unsigned)(at.rb * kQuad));
      cfg.dynamicSmemBytes = smem;
      cfg.stream = l.stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = (unsigned)at.cl;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const int rc = cudaLaunchKernelEx(&cfg, kernel, l.x, l.a, l.glq, l.eps, l.bias, l.u1, l.a1,
                                        l.g, l.gb, l.packed, l.padded, s, at, l.work, l.stride,
                                        row0, row_end);
      if (rc != cudaSuccess) return rc;
    } else
#endif
    {
      kernel<<<blocks, at.rb * kQuad, smem, l.stream>>>(l.x, l.a, l.glq, l.eps, l.bias, l.u1,
                                                        l.a1, l.g, l.gb, l.packed, l.padded, s,
                                                        at, l.work, l.stride, row0, row_end);
    }
    const int rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

template <int kTrace>
int run_adjoint(const AdjointLaunch& l, const Desc& d) {
  const bool row_bias = l.bias != nullptr;
  const long long F = d.F, H1 = d.w[1];
  if (l.tile < 1 || l.tile > kTile || l.work == nullptr || l.stride < l.tile ||
      l.stride % l.tile != 0)
    return cudaErrorInvalidValue;
  if (!l.wide) {
    // the workspace (sized by cnf_fused.py plan_cnf_adjoint): the rows'
    // columns, then each block's increments and errors
    const AdjTile at = adjoint_plan(d, l.tile, row_bias);
    if (!fits_narrow(d) || l.padded == nullptr || at.cl == 0 ||
        at.row_floats * l.stride + 2LL * d.total * (l.stride / at.rb) > l.work_floats)
      return cudaErrorInvalidValue;
    const Net s = narrow_net(d);
    return row_bias ? launch_cluster<kTrace, true>(l, s, at) : launch_cluster<kTrace, false>(l, s, at);
  }
  // the wide tier's workspace: the rows' columns, then each tile's
  // accumulators and factors
  long long mw = 0, pairs_width = 0;
  for (int i = 0; i <= d.n_lin; ++i) mw = d.w[i] > mw ? d.w[i] : mw;
  for (int i = 0; i < d.n_lin; ++i) pairs_width += d.w[i] + d.w[i + 1];
  const long long pairs = kTrace == kExact ? F + 1 : (kTrace == kHutchinson ? 2 : 1);
  const long long row_floats = 19 * F + 4LL * d.sum_hidden + 2 * mw + 3 * H1;
  const long long tile_floats = 2LL * d.total + (long long)l.tile * pairs * pairs_width;
  if (row_floats * l.stride + tile_floats * (l.stride / l.tile) > l.work_floats)
    return cudaErrorInvalidValue;
  const size_t te = (size_t)(H1 + kRed) * sizeof(float);
  WideNet s;
  const int rc = wide_net(d, l.desc, l.desc_bytes, l.stream, &s);
  if (rc != cudaSuccess) return rc;
  return row_bias ? launch_adjoint<kTrace, true>(l, s, row_floats, tile_floats, te)
                  : launch_adjoint<kTrace, false>(l, s, row_floats, tile_floats, te);
}

}  // namespace

// out (n,) = log_prob of the rows x (n, F). eps (n, F) is the Hutchinson
// probe (trace 2; unused by the exact trace, trace 1); bias (n, H1) the
// per-row first bias, or null for the one in `packed`. packed holds W1_x
// (H1, F), W1_te (H1, 2 nf), the first bias unless per row, then each further
// linear's (out, in) weights and its bias; widths = [F, H1, ..., F] (n_lin + 1
// ints); freqs the nf frequencies. wide 0: the narrow tier (work and desc
// unused); 1: the wide tier, with a workspace of work_floats floats for
// `stride` rows a launch (a multiple of 256) and a descriptor buffer of
// desc_bytes bytes, both on the device. The narrow tier also takes `padded`,
// the linears W1_x, W2, ... each as W^T [in][pad8(out)] then W [out]
// [pad8(in)] (cnf_adjoint_f32's), and tiles of `tile` rows (256, a cluster
// of blocks of 64).
extern "C" int cnf_density_f32(const float* x, const float* eps, const float* bias, float* out,
                               const float* packed, const int* widths, int n_lin, int nf,
                               const float* freqs, float atol, float rtol, float scale,
                               int max_steps, int trace, long long n, int wide, float* work,
                               long long work_floats, long long stride, void* desc,
                               long long desc_bytes, void* stream, const float* padded,
                               int tile) {
  Desc d;
  int rc = describe(&d, widths, n_lin, nf, freqs, atol, rtol, scale, max_steps, bias != nullptr);
  if (rc != cudaSuccess) return rc;
  if (n < 0 || (trace == kHutchinson && eps == nullptr)) return cudaErrorInvalidValue;
  const Launch l{x, eps, bias, nullptr, out, packed, n, wide, work, work_floats, stride,
                 desc, desc_bytes, (cudaStream_t)stream, padded, tile};
  if (trace == kExact) return run_mode<kExact, false>(l, d);
  if (trace == kHutchinson) return run_mode<kHutchinson, false>(l, d);
  return cudaErrorInvalidValue;
}

// xout (n, F): the base draws z (n, F) integrated from t = 1 to 0; with trace
// 1 (exact) or 2 (Hutchinson, probe eps) also logq (n,) = log q(xout), with
// trace 0 (logq null) x alone. The other arguments as cnf_density_f32's,
// the narrow tier's padded linears and tile rows too.
extern "C" int cnf_sample_f32(const float* z, const float* eps, const float* bias, float* xout,
                              float* logq, const float* packed, const int* widths, int n_lin,
                              int nf, const float* freqs, float atol, float rtol, float scale,
                              int max_steps, int trace, long long n, int wide, float* work,
                              long long work_floats, long long stride, void* desc,
                              long long desc_bytes, void* stream, const float* padded,
                              int tile) {
  Desc d;
  int rc = describe(&d, widths, n_lin, nf, freqs, atol, rtol, scale, max_steps, bias != nullptr);
  if (rc != cudaSuccess) return rc;
  if (n < 0 || (trace == kHutchinson && eps == nullptr) || ((trace == kNone) != (logq == nullptr)))
    return cudaErrorInvalidValue;
  const Launch l{z, eps, bias, xout, logq, packed, n, wide, work, work_floats, stride,
                 desc, desc_bytes, (cudaStream_t)stream, padded, tile};
  if (trace == kNone) return run_mode<kNone, true>(l, d);
  if (trace == kExact) return run_mode<kExact, true>(l, d);
  if (trace == kHutchinson) return run_mode<kHutchinson, true>(l, d);
  return cudaErrorInvalidValue;
}

// The continuous adjoint of cnf_sample at the samples x (n, F), with the
// cotangent a (n, F) of x and, with trace 1 (exact) or 2 (Hutchinson, probe
// eps), glq (n,) of log q (trace 0: glq null, no trace term): u1 (n, F) the
// re-integrated base draws, a1 (n, F) the cotangent of the draws, g
// (ceil(n / tile), P) each tile's sums of the cotangents of the packed
// parameters (P floats, the layout of `packed`; cnf_density_f32), and with a
// per-row first bias `bias` (n, H1) its cotangent gb (n, H1). A tile is
// `tile` rows (at most 256). The narrow tier (wide 0) takes `padded`, the
// linears W1_x, W2, ... each as W^T [in][out rounded to 8] then W [out][in
// rounded to 8], zero-padded, and a workspace of `stride` rows a launch (a
// multiple of the tile): 14 F (+ 3 H1 with a per-row bias) floats a row, and
// the row's columns where shared memory cannot hold them (adjoint_plan),
// then 2 P floats a block of min(tile, 64) rows. The wide tier (wide 1;
// padded unused): one block of `tile` threads a tile, 19 F + 4 sum(hidden) +
// 2 max(widths) + 3 H1 floats a row and 2 P + tile (1 + F | 2 | 1) sum_l (w_l
// + w_{l+1}) floats a tile.
extern "C" int cnf_adjoint_f32(const float* x, const float* a, const float* glq, const float* eps,
                               const float* bias, float* u1, float* a1, float* g, float* gb,
                               const float* packed, const float* padded, const int* widths,
                               int n_lin, int nf,
                               const float* freqs, float atol, float rtol, int max_steps,
                               int trace, long long n, int tile, int wide, float* work,
                               long long work_floats, long long stride, void* desc,
                               long long desc_bytes, void* stream) {
  Desc d;
  int rc = describe(&d, widths, n_lin, nf, freqs, atol, rtol, 1.0f, max_steps, bias != nullptr);
  if (rc != cudaSuccess) return rc;
  if (n < 0 || (trace == kHutchinson && eps == nullptr) || ((trace == kNone) != (glq == nullptr)) ||
      ((bias == nullptr) != (gb == nullptr)))
    return cudaErrorInvalidValue;
  const AdjointLaunch l{x, a, glq, eps, bias, u1, a1, g, gb, packed, padded, n, tile, wide, work,
                        work_floats, stride, desc, desc_bytes, (cudaStream_t)stream};
  if (trace == kNone) return run_adjoint<kNone>(l, d);
  if (trace == kExact) return run_adjoint<kExact>(l, d);
  if (trace == kHutchinson) return run_adjoint<kHutchinson>(l, d);
  return cudaErrorInvalidValue;
}

extern "C" const char* cnf_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
