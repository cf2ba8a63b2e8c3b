// Whole-flow Gaussianization-flow (GF) kernels for Hopper (sm_90a).
//
// gf_density replaces the TPU kernel zuko_tpu/ops/gf_fused.py::_gf_impl
// (pallas_call at :562; kernel body _gf_kernel_T :450, math _gf_math_T :361):
// log_prob of a GF in one launch. Every element-wise gaussianization layer
//   m = (1 - eps) / K * sum_k erf((s_k x + b_k) / sqrt 2),  y = sqrt 2 erfinv(m),
// with its analytic log-Jacobian in log-sum-exp form,
//   ladj = y^2 / 2 + log((1 - eps) / K) + logsumexp_k(log s_k - (s_k x + b_k)^2 / 2),
// every rotation R x between the layers, and the standard-normal base term.
//
// gf_sample replaces zuko_tpu/ops/gf_fused.py::_gf_sample_core (pallas_call at
// :657; kernel body _gf_sample_kernel_T :456, math _gf_sample_math_T :416):
// the whole inversion, layers in reverse. A rotation inverts as R^T y; a
// gaussianization layer by 29 even subdivisions of [-10, 10] per feature, in
// erf space: m(mid) is compared with erf(y / sqrt 2), so the loop holds no
// erfinv and no derivative term. With kLogQ it also returns log q of the
// returned point: base(z) plus each layer's forward ladj at its solved x.
//
// Parameters. An unconditional layer (or one under a single context) has one
// (F, K) set of shifts and log-scales for all rows; the wrapper packs it as
// [F][3][K] = shift, scale = exp(log scale), log scale, so the kernel takes
// no log or exp of a weight, and every thread of a warp reads the same
// address (one L1 broadcast). Under a batched context every row brings its
// own 2 K F parameters per layer (288 floats a row for F = 6, K = 8, three
// layers). Those stay where the hyper-network wrote them: the kernel takes a
// pointer to the shifts and one to the log-scales with their common row and
// feature strides, so no pass reorders or copies them.
//
// What bounds them on an H100. Without per-row parameters: operations. A
// density row costs L F K erff and expf (144 each for the flagship) against
// 4 (F + 1) bytes; a sample row 29 times the erff. With per-row parameters
// the density is bound by bytes: 4 (F + 2 L K F + 1) = 1180 bytes a row
// against about 6K operations, a ratio of 5 operations a byte where the card
// does 20. The sampler stays bound by operations (29 erff per parameter pair).
//
// Design (simple and right first): one thread per row, blocks of 128 rows;
// the row's F values live in the thread (local arrays, F <= 64). Per-row
// parameters go through shared memory, a chunk of features at a time: the
// four warps of a block copy the chunk of 128 rows with neighbouring lanes on
// neighbouring addresses (a row's parameters are contiguous in the
// hyper-network's output), each thread then reads its own row of the tile,
// whose odd row stride keeps the 32 lanes on 32 banks. Each thread fills in
// scale = expf(log scale) for its row once, so the 29 bisection steps do not.
// The rotation products are plain float32 FMAs in the kernel body.
//
// The sampler's narrow tier where every gaussianization layer has the same
// K <= kGfRegs components (the flagship's 8) is tiled instead:
// gf_sample_tiled, below.
//
// Two tiers, chosen by the wrapper from the flow's shape alone
// (zuko_tpu_torch/ops/gf_fused.py plan_gf). The narrow tier (kWide false) is
// the design above, within its limits: kMaxF features, kMaxK components,
// kMaxStages stages. The wide tier takes any shape: a row's F values live in
// a workspace in device memory, one column of `stride` rows per value, so
// neighbouring threads touch neighbouring addresses as in local memory;
// per-row parameters are read where the hyper-network wrote them, with
// scale = expf(log scale) taken at each use; the stages lie in a small
// device buffer. The wrapper allocates both; the rows run in chunks of
// `stride`, one launch each, so the workspace stays bounded.
//
// Each C entry point checks its arguments, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <type_traits>
#include <vector>

namespace {

// the narrow tier's limits, mirrored in zuko_tpu_torch/ops/gf_fused.py
constexpr int kMaxF = 64;       // features
constexpr int kMaxK = 32;       // mixture components
constexpr int kMaxStages = 64;  // gaussianization layers and rotations together
constexpr int kGfRegs = 16;      // components the tiled sampler holds in registers
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileThreads = 256;  // the tiled sampler's block
constexpr int kMaxShared = 232448;  // a block's shared memory on an H100 (227 KB)
// floats of one row of the shared tile: a chunk of fc features holds
// fc * 3 * K of them (shift, scale, log scale), plus one to make the stride odd
constexpr int kTileRow = 145;
constexpr int kTileSlots = (kTileRow - 1) / 3 * 2 / 32;  // floats a lane copies per row

constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kSqrt2 = 1.41421356237309505f;
constexpr float kShrink = 1.0f - 1e-6f;  // the reference shrinks the mean of erfs
constexpr float kBound = 10.0f;          // the bisection's bracket
constexpr int kIters = 29;               // ceil(log2(2 * 10 / 1e-6)) + 4

enum Kind { kGauss = 0, kGaussBatched = 1, kRot = 2 };

struct Stage {
  int kind;
  int K;                // components (gaussianization layers)
  int fc;               // features per staged chunk (batched layers, narrow tier)
  int feat_stride;      // floats between two features of a row (batched layers)
  long long off;        // offset of the stage's floats in `packed` (other stages)
  long long row_stride; // floats between two rows (batched layers)
  const float* shift;   // (n, F, K) per-row shifts (batched layers)
  const float* raw;     // (n, F, K) per-row log-scales (batched layers)
};

// The narrow tier's description, a __grid_constant__ parameter: its stages
// are indexed in a loop, and a plain by-value parameter whose address is
// taken would be copied into every thread's local memory.
struct Shape {
  int F;
  int n_stages;
  Stage st[kMaxStages];
};

// The wide tier's: the stages in the device buffer `desc`.
struct WideShape {
  int F;
  int n_stages;
  const Stage* st;
};

template <bool kWide>
using ShapeOf = typename std::conditional<kWide, WideShape, Shape>::type;

// One of a row's arrays: a per-thread array (narrow) or a slot column of the
// workspace, `stride` floats between consecutive elements (wide).
template <bool kWide>
struct Vec {
  float* p;
  long long stride;
  __device__ __forceinline__ float& operator[](int i) const {
    return kWide ? p[i * stride] : p[i];
  }
};

// The narrow tier's per-thread arrays; nothing for the wide tier.
template <bool kWide>
struct Local {
  float a[kMaxF], b[kMaxF];
};
template <>
struct Local<true> {};

// The two arrays a row's F values ping-pong between (the workspace's two
// slots of F floats each in the wide tier, mirrored in gf_fused.py plan_gf).
template <bool kWide>
__device__ __forceinline__ void make_row(Local<kWide>& m, int F, float* work, long long stride,
                                         long long i, Vec<kWide>* a, Vec<kWide>* b) {
  if constexpr (kWide) {
    *a = {work + i, stride};
    *b = {work + i + F * stride, stride};
  } else {
    *a = {m.a, 1};
    *b = {m.b, 1};
  }
}

// A feature's mixture parameters [shift K][scale K][log scale K], packed by
// the wrapper or staged in the shared tile.
struct Packed {
  const float* p;
  int K;
  __device__ __forceinline__ float shift(int k) const { return p[k]; }
  __device__ __forceinline__ float scale(int k) const { return p[K + k]; }
  __device__ __forceinline__ float log_scale(int k) const { return p[2 * K + k]; }
};

// A feature's per-row parameters where the hyper-network wrote them (wide
// tier): the scale taken from the log-scale at each use.
struct PerRow {
  const float* sh;
  const float* raw;
  __device__ __forceinline__ float shift(int k) const { return __ldg(sh + k); }
  __device__ __forceinline__ float scale(int k) const { return expf(__ldg(raw + k)); }
  __device__ __forceinline__ float log_scale(int k) const { return __ldg(raw + k); }
};

// (1 - eps) / K * sum_k erf((s_k x + b_k) / sqrt 2)
template <class P>
__device__ __forceinline__ float mixture_mean(float x, const P& p, int K) {
  float m = 0.0f;
  for (int k = 0; k < K; ++k) m += erff(fmaf(p.scale(k), x, p.shift(k)) * kInvSqrt2);
  return m * (kShrink / (float)K);
}

// y = f(x) and log f'(x) of one feature. The log-sum-exp is streamed
// (running maximum, rescaled sum), so it stays finite where every
// exp(-z^2 / 2) underflows.
template <class P>
__device__ __forceinline__ float gauss_forward(float x, const P& p, int K, float* ladj) {
  float m = 0.0f, lmax = -INFINITY, acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float z = fmaf(p.scale(k), x, p.shift(k));
    m += erff(z * kInvSqrt2);
    const float li = fmaf(-0.5f * z, z, p.log_scale(k));
    // one of the two rescalings is by 1: a single exp of -|difference|
    const float d = li - lmax;
    const float e = expf(-fabsf(d));
    acc = d > 0.0f ? fmaf(acc, e, 1.0f) : acc + e;
    lmax = fmaxf(lmax, li);
  }
  const float c = kShrink / (float)K;
  const float y = kSqrt2 * erfinvf(m * c);
  *ladj = 0.5f * y * y + logf(c) + lmax + logf(acc);
  return y;
}

// Solve f(x) = y on [-10, 10]: f(x) = y iff m(x) = erf(y / sqrt 2).
template <class P>
__device__ __forceinline__ float gauss_inverse(float y, const P& p, int K) {
  const float target = erff(y * kInvSqrt2);
  float lo = -kBound, hi = kBound;
  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (mixture_mean(mid, p, K) < target) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return 0.5f * (lo + hi);
}

// Copy features [f0, f0 + nf) of the block's rows into the shared tile,
// row r at tile + r * ts as [feature][shift K | scale K | log scale K], the
// scale left for `fill_scales`. A lane's share of a row is the same for every
// row, so its offsets are worked out once.
__device__ __forceinline__ void stage_tile(float* tile, const Stage& st, int ts, int f0, int nf,
                                           long long row0, int rows) {
  const int K = st.K, per_row = nf * 2 * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int src[kTileSlots], dst[kTileSlots];
  bool is_raw[kTileSlots];
#pragma unroll
  for (int q = 0; q < kTileSlots; ++q) {
    const int j = lane + 32 * q;  // j = (feature * 2 + which) * K + k
    src[q] = 0;
    dst[q] = -1;
    is_raw[q] = false;
    if (j < per_row) {
      const int fl = j / (2 * K), rem = j - fl * 2 * K;
      const int which = rem >= K, k = rem - which * K;
      is_raw[q] = which;
      src[q] = (f0 + fl) * st.feat_stride + k;
      dst[q] = fl * 3 * K + which * 2 * K + k;
    }
  }
  for (int r = warp; r < rows; r += kWarps) {
    const long long at = (row0 + r) * st.row_stride;
#pragma unroll
    for (int q = 0; q < kTileSlots; ++q) {
      if (dst[q] >= 0) tile[r * ts + dst[q]] = (is_raw[q] ? st.raw : st.shift)[at + src[q]];
    }
  }
}

// scale = exp(log scale) for the thread's own row of the tile.
__device__ __forceinline__ void fill_scales(float* p, int nf, int K) {
  for (int fl = 0; fl < nf; ++fl) {
    for (int k = 0; k < K; ++k) p[fl * 3 * K + K + k] = expf(p[fl * 3 * K + 2 * K + k]);
  }
}

// kTranspose false: out = R in; true: out = R^T in (R is row-major F x F).
template <bool kTranspose, class V>
__device__ __forceinline__ void rotate(const float* __restrict__ R, int F, const V& in,
                                       const V& out) {
  for (int i = 0; i < F; ++i) {
    float acc = 0.0f;
    for (int j = 0; j < F; ++j) {
      acc = fmaf(kTranspose ? __ldg(R + j * F + i) : __ldg(R + i * F + j), in[j], acc);
    }
    out[i] = acc;
  }
}

// Feature f's per-row parameters of a batched layer at `row` (wide tier).
__device__ __forceinline__ PerRow per_row(const Stage& st, long long row, int f) {
  const long long at = row * st.row_stride + (long long)f * st.feat_stride;
  return {st.shift + at, st.raw + at};
}

// Rows [row0, row_end) of the launch; thread i takes row row0 + i, and in the
// wide tier workspace column i.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
gf_density_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const float* __restrict__ packed, const __grid_constant__ ShapeOf<kWide> s,
                  float* __restrict__ work, long long stride, long long row0,
                  long long row_end) {
  extern __shared__ float tile[];
  const long long block0 = row0 + (long long)blockIdx.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = row0 + i;
  const bool active = row < row_end;
  if (kWide && !active) return;  // the wide tier has no barriers
  const int rows = (int)min((long long)blockDim.x, row_end - block0);
  const int F = s.F;
  Local<kWide> m;
  Vec<kWide> cur, nxt;
  make_row(m, F, work, stride, i, &cur, &nxt);
  if (active) {
    for (int f = 0; f < F; ++f) cur[f] = x[row * F + f];
  }
  float acc = 0.0f;
  for (int si = 0; si < s.n_stages; ++si) {
    const Stage& st = s.st[si];
    if (st.kind == kRot) {
      if (active) rotate<false>(packed + st.off, F, cur, nxt);
      const Vec<kWide> t = cur;
      cur = nxt;
      nxt = t;
    } else if (st.kind == kGauss) {
      if (!active) continue;
      for (int f = 0; f < F; ++f) {
        float ladj;
        cur[f] = gauss_forward(cur[f], Packed{packed + st.off + f * 3 * st.K, st.K}, st.K, &ladj);
        acc += ladj;
      }
    } else if constexpr (kWide) {
      for (int f = 0; f < F; ++f) {
        float ladj;
        cur[f] = gauss_forward(cur[f], per_row(st, row, f), st.K, &ladj);
        acc += ladj;
      }
    } else {
      const int ts = (st.fc * 3 * st.K) | 1;
      for (int f0 = 0; f0 < F; f0 += st.fc) {
        const int nf = min(st.fc, F - f0);
        __syncthreads();  // every thread is done with the previous chunk
        stage_tile(tile, st, ts, f0, nf, block0, rows);
        __syncthreads();
        if (!active) continue;
        float* p = tile + threadIdx.x * ts;
        fill_scales(p, nf, st.K);
        for (int fl = 0; fl < nf; ++fl) {
          float ladj;
          cur[f0 + fl] = gauss_forward(cur[f0 + fl], Packed{p + fl * 3 * st.K, st.K}, st.K, &ladj);
          acc += ladj;
        }
      }
    }
  }
  if (!active) return;
  float sq = 0.0f;
  for (int f = 0; f < F; ++f) sq = fmaf(cur[f], cur[f], sq);
  out[row] = acc - 0.5f * sq - F * kHalfLog2Pi;
}

// One feature's inverse, and with kLogQ its forward ladj at the solved x.
template <bool kLogQ, class P>
__device__ __forceinline__ float invert(float y, const P& p, int K, float* acc) {
  const float xv = gauss_inverse(y, p, K);
  if (kLogQ) {
    float ladj;
    gauss_forward(xv, p, K, &ladj);
    *acc += ladj;
  }
  return xv;
}

template <bool kWide, bool kLogQ>
__global__ void __launch_bounds__(kThreads)
gf_sample_kernel(const float* __restrict__ z, float* __restrict__ xout,
                 float* __restrict__ logq, const float* __restrict__ packed,
                 const __grid_constant__ ShapeOf<kWide> s, float* __restrict__ work,
                 long long stride, long long row0, long long row_end) {
  extern __shared__ float tile[];
  const long long block0 = row0 + (long long)blockIdx.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = row0 + i;
  const bool active = row < row_end;
  if (kWide && !active) return;
  const int rows = (int)min((long long)blockDim.x, row_end - block0);
  const int F = s.F;
  Local<kWide> m;
  Vec<kWide> y, nxt;
  make_row(m, F, work, stride, i, &y, &nxt);
  float acc = 0.0f;
  if (active) {
    float sq = 0.0f;
    for (int f = 0; f < F; ++f) {
      y[f] = z[row * F + f];
      sq = fmaf(y[f], y[f], sq);
    }
    if (kLogQ) acc = -0.5f * sq - F * kHalfLog2Pi;
  }
  for (int si = s.n_stages - 1; si >= 0; --si) {
    const Stage& st = s.st[si];
    if (st.kind == kRot) {
      if (active) rotate<true>(packed + st.off, F, y, nxt);
      const Vec<kWide> t = y;
      y = nxt;
      nxt = t;
    } else if (st.kind == kGauss) {
      if (!active) continue;
      for (int f = 0; f < F; ++f) {
        y[f] = invert<kLogQ>(y[f], Packed{packed + st.off + f * 3 * st.K, st.K}, st.K, &acc);
      }
    } else if constexpr (kWide) {
      for (int f = 0; f < F; ++f) y[f] = invert<kLogQ>(y[f], per_row(st, row, f), st.K, &acc);
    } else {
      const int ts = (st.fc * 3 * st.K) | 1;
      for (int f0 = 0; f0 < F; f0 += st.fc) {
        const int nf = min(st.fc, F - f0);
        __syncthreads();
        stage_tile(tile, st, ts, f0, nf, block0, rows);
        __syncthreads();
        if (!active) continue;
        float* p = tile + threadIdx.x * ts;
        fill_scales(p, nf, st.K);
        for (int fl = 0; fl < nf; ++fl) {
          y[f0 + fl] = invert<kLogQ>(y[f0 + fl], Packed{p + fl * 3 * st.K, st.K}, st.K, &acc);
        }
      }
    }
  }
  if (!active) return;
  for (int f = 0; f < F; ++f) xout[row * F + f] = y[f];
  if (kLogQ) logq[row] = acc;
}

// The tiled narrow tier of the sampler: gf_sample_tiled<kLogQ, kK>, a block
// of kTileThreads threads a tile of R rows (32, 64 or 128: plan_gf in
// ops/gf_fused.py), for a flow whose gaussianization layers all have kK <=
// kGfRegs components. The same function as gf_sample_kernel<kWide = true,
// kLogQ>, with every float32 sum in the same order. What held the per-row
// design back (one thread a row: its F values in local memory indexed at run
// time, the row's features solved one after another, 2 K loads through
// Packed for the K erff of every bisection step, a loop over a run-time K
// that does not unroll, and under a batched context a staging pass behind
// two barriers a chunk of features) it does so:
// - the tile's values live in shared memory as [F][R] (and a second [F][R]
//   for a rotation's output); a gaussianization layer gives one thread a
//   (row, feature) pair, F R pairs over the block;
// - a pair loads its feature's K shifts, K scales and K log-scales into
//   registers once a layer (Mixture<kK>; under a batched context its row's
//   own parameters where the hyper-network wrote them, the scale expf of the
//   log-scale once, fill_scales' value), so the 29 bisection steps run the
//   K erff unrolled, with no loads, and the F R pairs' chains fill the warps;
// - a rotation R^T y is one thread an output (row, feature), R staged in
//   shared memory once a stage, the products in rotate<true>'s order over j;
// - with kLogQ each pair leaves its forward ladj at the solved x in a shared
//   column [F][R], and thread r < R sums row r's features in order after the
//   layer, from the base term, as gf_sample_kernel does.

// A pair's mixture parameters in registers, and mixture_mean's and
// gauss_forward's arithmetic on them with every loop over the kK components
// unrolled: overloads of their own, as the run-time K loops of the per-row
// and wide kernels keep their code only without an unroll pragma (a loop
// shared through a lambda moved 5-63 SASS lines of each of them). The
// bisection is gauss_inverse's, which calls the overload for a Mixture.
template <int kK>
struct Mixture {
  float shift[kK], scale[kK], log_scale[kK];
};

template <int kK>
__device__ __forceinline__ float mixture_mean(float x, const Mixture<kK>& p, int /*K = kK*/) {
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kK; ++k) m += erff(fmaf(p.scale[k], x, p.shift[k]) * kInvSqrt2);
  return m * (kShrink / (float)kK);
}

template <int kK>
__device__ __forceinline__ float gauss_forward(float x, const Mixture<kK>& p, int /*K = kK*/,
                                               float* ladj) {
  float m = 0.0f, lmax = -INFINITY, acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float z = fmaf(p.scale[k], x, p.shift[k]);
    m += erff(z * kInvSqrt2);
    const float li = fmaf(-0.5f * z, z, p.log_scale[k]);
    const float d = li - lmax;
    const float e = expf(-fabsf(d));
    acc = d > 0.0f ? fmaf(acc, e, 1.0f) : acc + e;
    lmax = fmaxf(lmax, li);
  }
  const float c = kShrink / (float)kK;
  const float y = kSqrt2 * erfinvf(m * c);
  *ladj = 0.5f * y * y + logf(c) + lmax + logf(acc);
  return y;
}

// The tile's arrays in dynamic shared memory, as float offsets (tile_plan;
// mirrored in ops/gf_fused.py _tile_floats): the values [F][R], a
// rotation's output [F][R], the ladjs [F][R], the rotation [F][F].
struct GfTile {
  int R, lr;  // rows of a tile, log2 R
  int t, lad, rot;
  int floats;
};

template <bool kLogQ, int kK>
__global__ void __launch_bounds__(kTileThreads)
    gf_sample_tiled(const float* __restrict__ z, float* __restrict__ xout,
                    float* __restrict__ logq, const float* __restrict__ packed,
                    const __grid_constant__ Shape s, const __grid_constant__ GfTile tl,
                    long long n) {
  extern __shared__ float tile[];
  const int R = tl.R, lr = tl.lr, tid = threadIdx.x, F = s.F;
  const long long row0 = (long long)blockIdx.x * R;
  float* y = tile;
  float* t = tile + tl.t;
  float* lad = tile + tl.lad;
  float* rot = tile + tl.rot;
  for (int e = tid; e < F * R; e += kTileThreads) {
    const int f = e >> lr, r = e & (R - 1);
    y[e] = row0 + r < n ? z[(row0 + r) * F + f] : 0.0f;
  }
  __syncthreads();
  // thread r < R owns row r's sum
  const bool owner = tid < R && row0 + tid < n;
  float acc = 0.0f;
  if (kLogQ && owner) {
    float sq = 0.0f;
    for (int f = 0; f < F; ++f) sq = fmaf(y[f * R + tid], y[f * R + tid], sq);
    acc = -0.5f * sq - F * kHalfLog2Pi;
  }
  for (int si = s.n_stages - 1; si >= 0; --si) {
    const Stage& st = s.st[si];
    __syncthreads();  // every thread is done with the previous stage's arrays
    if (st.kind == kRot) {
      for (int q = tid; q < F * F; q += kTileThreads) rot[q] = __ldg(packed + st.off + q);
      __syncthreads();
      for (int e = tid; e < F * R; e += kTileThreads) {
        const int i = e >> lr, r = e & (R - 1);
        float a = 0.0f;
        for (int j = 0; j < F; ++j) a = fmaf(rot[j * F + i], y[j * R + r], a);
        t[e] = a;
      }
      float* const w = y;
      y = t;
      t = w;
      continue;
    }
    for (int e = tid; e < F * R; e += kTileThreads) {
      const int f = e >> lr, r = e & (R - 1);
      const long long row = row0 + r;
      if (row >= n) continue;
      Mixture<kK> p;
      if (st.kind == kGauss) {
        const float* q = packed + st.off + f * 3 * kK;
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          p.shift[k] = __ldg(q + k);
          p.scale[k] = __ldg(q + kK + k);
          p.log_scale[k] = __ldg(q + 2 * kK + k);
        }
      } else {
        const long long at = row * st.row_stride + (long long)f * st.feat_stride;
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          p.shift[k] = __ldg(st.shift + at + k);
          p.log_scale[k] = __ldg(st.raw + at + k);
          p.scale[k] = expf(p.log_scale[k]);
        }
      }
      const float xv = gauss_inverse(y[e], p, kK);
      y[e] = xv;
      if (kLogQ) {
        float ladj;
        gauss_forward(xv, p, kK, &ladj);
        lad[e] = ladj;
      }
    }
    if (kLogQ) {
      __syncthreads();
      if (owner)
        for (int f = 0; f < F; ++f) acc += lad[f * R + tid];
    }
  }
  __syncthreads();
  for (int e = tid; e < F * R; e += kTileThreads) {
    const int f = e >> lr, r = e & (R - 1);
    if (row0 + r < n) xout[(row0 + r) * F + f] = y[e];
  }
  if (kLogQ && owner) logq[row0 + tid] = acc;
}

// The stages as the wrapper hands them over (one entry per stage), checked;
// the narrow tier's tile chunks sized.
int describe(std::vector<Stage>* out, const int* kinds, const int* Ks, const long long* offs,
             const void* const* shifts, const void* const* raws, const long long* row_strides,
             const int* feat_strides, int n_stages, int F) {
  if (F < 1 || n_stages < 1) return cudaErrorInvalidValue;
  out->clear();
  for (int i = 0; i < n_stages; ++i) {
    Stage st{kinds[i], Ks[i], 0, 0, offs[i], 0, nullptr, nullptr};
    if (st.kind != kRot) {
      if ((st.kind != kGauss && st.kind != kGaussBatched) || st.K < 1)
        return cudaErrorInvalidValue;
      if (st.kind == kGaussBatched) {
        if (shifts[i] == nullptr || raws[i] == nullptr) return cudaErrorInvalidValue;
        st.shift = (const float*)shifts[i];
        st.raw = (const float*)raws[i];
        st.row_stride = row_strides[i];
        st.feat_stride = feat_strides[i];
        st.fc = std::min(F, std::max(1, (kTileRow - 1) / (3 * st.K)));
      }
    }
    out->push_back(st);
  }
  return cudaSuccess;
}

bool fits_narrow(const std::vector<Stage>& st, int F) {
  if (F > kMaxF || (int)st.size() > kMaxStages) return false;
  for (const Stage& s : st) {
    if (s.kind != kRot && s.K > kMaxK) return false;
  }
  return true;
}

// What a launch needs besides the flow (see naf_fused.cu).
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
  int tile;  // the tiled sampler's tile rows (0: not tiled)
};

enum Op { kDensity = 0, kSample = 1, kSampleLogQ = 2 };

template <bool kWide>
int launch(int op, const Launch& l, const ShapeOf<kWide>& s, long long stride, size_t smem) {
  for (long long row0 = 0; row0 < l.n; row0 += stride) {
    const long long row_end = row0 + stride < l.n ? row0 + stride : l.n;
    const unsigned blocks = (unsigned)((row_end - row0 + kThreads - 1) / kThreads);
    if (op == kDensity) {
      gf_density_kernel<kWide><<<blocks, kThreads, smem, l.stream>>>(
          l.in, l.out0, l.packed, s, l.work, stride, row0, row_end);
    } else if (op == kSampleLogQ) {
      gf_sample_kernel<kWide, true><<<blocks, kThreads, smem, l.stream>>>(
          l.in, l.out0, l.out1, l.packed, s, l.work, stride, row0, row_end);
    } else {
      gf_sample_kernel<kWide, false><<<blocks, kThreads, smem, l.stream>>>(
          l.in, l.out0, nullptr, l.packed, s, l.work, stride, row0, row_end);
    }
    const int rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

template <typename Kernel>
int configure(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The components of every gaussianization layer where they are the same
// K <= kGfRegs, the sampler's tiled tier (mirrored in ops/gf_fused.py
// plan_gf); else 0.
int tiled_components(const std::vector<Stage>& stages) {
  int K = 0;
  for (const Stage& st : stages) {
    if (st.kind == kRot) continue;
    if (st.K > kGfRegs || (K != 0 && st.K != K)) return 0;
    K = st.K;
  }
  return K;
}

// The tiled sampler's tile of R rows (GfTile; R = 0: no plan).
GfTile tile_plan(int F, int R) {
  GfTile t{};
  if (R != 32 && R != 64 && R != 128) return t;
  t.R = R;
  t.lr = R == 32 ? 5 : R == 64 ? 6 : 7;
  t.t = F * R;
  t.lad = 2 * F * R;
  t.rot = 3 * F * R;
  t.floats = t.rot + F * F;
  return t;
}

// gf_sample_tiled<log q, kK> for the flow's K components, dispatched on K
// from kK = 1 up.
template <int kK = 1>
int run_tiled(int op, const Launch& l, const Shape& s, const GfTile& t, int K) {
  if constexpr (kK < kGfRegs) {
    if (K != kK) return run_tiled<kK + 1>(op, l, s, t, K);
  }
  const size_t smem = 4 * (size_t)t.floats;
  const auto go = [&](auto kernel, float* logq) {
    const int rc = configure(kernel, smem);
    if (rc != cudaSuccess) return rc;
    kernel<<<(unsigned)((l.n + t.R - 1) / t.R), kTileThreads, smem, l.stream>>>(
        l.in, l.out0, logq, l.packed, s, t, l.n);
    return (int)cudaGetLastError();
  };
  return op == kSampleLogQ ? go(gf_sample_tiled<true, kK>, l.out1)
                           : go(gf_sample_tiled<false, kK>, nullptr);
}

int run(int op, const Launch& l, const std::vector<Stage>& stages, int F) {
  if (l.n < 0) return cudaErrorInvalidValue;
  const int n_stages = (int)stages.size();
  if (!l.wide) {
    if (!fits_narrow(stages, F)) return cudaErrorInvalidValue;
    const int K = op == kDensity ? 0 : tiled_components(stages);
    // the tiled sampler takes exactly the flows it can, with a tile
    if ((K != 0) != (l.tile != 0)) return cudaErrorInvalidValue;
    Shape s;
    s.F = F;
    s.n_stages = n_stages;
    int tile_row = 0;
    for (int i = 0; i < n_stages; ++i) {
      s.st[i] = stages[i];
      if (stages[i].kind == kGaussBatched)
        tile_row = std::max(tile_row, (stages[i].fc * 3 * stages[i].K) | 1);
    }
    if (K != 0) {
      const GfTile t = tile_plan(F, l.tile);
      if (t.R == 0 || 4LL * t.floats > kMaxShared) return cudaErrorInvalidValue;
      return l.n == 0 ? cudaSuccess : run_tiled(op, l, s, t, K);
    }
    const size_t smem = (size_t)kThreads * tile_row * sizeof(float);
    int rc;
    switch (op) {
      case kDensity: rc = configure(gf_density_kernel<false>, smem); break;
      case kSampleLogQ: rc = configure(gf_sample_kernel<false, true>, smem); break;
      default: rc = configure(gf_sample_kernel<false, false>, smem); break;
    }
    if (rc != cudaSuccess) return rc;
    return launch<false>(op, l, s, l.n > 0 ? l.n : 1, smem);
  }
  const long long need = (long long)n_stages * (long long)sizeof(Stage);
  if (l.desc == nullptr || l.desc_bytes < need || l.work == nullptr || l.stride < 1 ||
      2LL * F * l.stride > l.work_floats)
    return cudaErrorInvalidValue;
  // a pageable source is staged before cudaMemcpyAsync returns
  const int rc = cudaMemcpyAsync(l.desc, stages.data(), (size_t)need, cudaMemcpyHostToDevice,
                                 l.stream);
  if (rc != cudaSuccess) return rc;
  const WideShape ws{F, n_stages, (const Stage*)l.desc};
  return launch<true>(op, l, ws, l.stride, 0);
}

}  // namespace

// The flow as the wrapper hands it over: `packed` holds the stages without
// per-row parameters at offs[i], a layer as [F][3][K] (shift, scale, log
// scale), a rotation as R (F, F) row-major; a layer with per-row parameters
// gives shifts[i] and raws[i], (n, F, K) with strides (row_strides[i],
// feat_strides[i], 1) in floats. Then the tier: wide 0, the narrow tier
// (work and desc unused); wide 1, the wide tier, with a workspace of
// work_floats floats for `stride` rows a launch and a descriptor buffer of
// desc_bytes bytes on the device.
#define GF_FLOW                                                                             \
  const float *packed, const int *kinds, const int *Ks, const long long *offs,             \
      const void *const *shifts, const void *const *raws, const long long *row_strides,    \
      const int *feat_strides, int n_stages, int F, long long n, int wide, float *work,      \
      long long work_floats, long long stride, void *desc, long long desc_bytes, void *stream

static int entry(int op, const float* in, float* out0, float* out1, GF_FLOW, int tile) {
  std::vector<Stage> stages;
  const int rc = describe(&stages, kinds, Ks, offs, shifts, raws, row_strides, feat_strides,
                          n_stages, F);
  if (rc != cudaSuccess) return rc;
  return run(op,
             {in, out0, out1, packed, n, wide, work, work_floats, stride, desc, desc_bytes,
              (cudaStream_t)stream, tile},
             stages, F);
}

// out (n,) = log_prob of x (n, F).
extern "C" int gf_density_f32(const float* x, float* out, GF_FLOW) {
  return entry(kDensity, x, out, nullptr, packed, kinds, Ks, offs, shifts, raws, row_strides,
               feat_strides, n_stages, F, n, wide, work, work_floats, stride, desc, desc_bytes,
               stream, 0);
}

// xout (n, F) = T^-1(z), and logq (n,) = log q(xout) unless logq is null.
// On the narrow tier (wide 0) a flow whose gaussianization layers share K <=
// kGfRegs components takes the tiled sampler with its tile of `tile` rows
// (32, 64 or 128), any other flow `tile` 0.
extern "C" int gf_sample_f32(const float* z, float* xout, float* logq, GF_FLOW, int tile) {
  return entry(logq != nullptr ? kSampleLogQ : kSample, z, xout, logq, packed, kinds, Ks, offs,
               shifts, raws, row_strides, feat_strides, n_stages, F, n, wide, work, work_floats,
               stride, desc, desc_bytes, stream, tile);
}

extern "C" const char* gf_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
