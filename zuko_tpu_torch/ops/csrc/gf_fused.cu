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
// Each C entry point checks its arguments, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

// limits, mirrored in zuko_tpu_torch/ops/gf_fused.py
constexpr int kMaxF = 64;       // features
constexpr int kMaxK = 32;       // mixture components
constexpr int kMaxStages = 64;  // gaussianization layers and rotations together
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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
  int fc;               // features per staged chunk (batched layers)
  int feat_stride;      // floats between two features of a row (batched layers)
  long long off;        // offset of the stage's floats in `packed` (other stages)
  long long row_stride; // floats between two rows (batched layers)
  const float* shift;   // (n, F, K) per-row shifts (batched layers)
  const float* raw;     // (n, F, K) per-row log-scales (batched layers)
};

// The kernels take it as a __grid_constant__ parameter: its stages are
// indexed in a loop, and a plain by-value parameter whose address is taken
// would be copied into every thread's local memory.
struct Shape {
  int F;
  int n_stages;
  Stage st[kMaxStages];
};

// (1 - eps) / K * sum_k erf((s_k x + b_k) / sqrt 2), p = [shift K][scale K][...]
__device__ __forceinline__ float mixture_mean(float x, const float* p, int K) {
  float m = 0.0f;
  for (int k = 0; k < K; ++k) m += erff(fmaf(p[K + k], x, p[k]) * kInvSqrt2);
  return m * (kShrink / (float)K);
}

// y = f(x) and log f'(x) of one feature, p = [shift K][scale K][log scale K].
// The log-sum-exp is streamed (running maximum, rescaled sum), so it stays
// finite where every exp(-z^2 / 2) underflows.
__device__ __forceinline__ float gauss_forward(float x, const float* p, int K, float* ladj) {
  float m = 0.0f, lmax = -INFINITY, acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float z = fmaf(p[K + k], x, p[k]);
    m += erff(z * kInvSqrt2);
    const float li = fmaf(-0.5f * z, z, p[2 * K + k]);
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
__device__ __forceinline__ float gauss_inverse(float y, const float* p, int K) {
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
template <bool kTranspose>
__device__ __forceinline__ void rotate(const float* __restrict__ R, int F, const float* in,
                                       float* out) {
  for (int i = 0; i < F; ++i) {
    float acc = 0.0f;
    for (int j = 0; j < F; ++j) {
      acc = fmaf(kTranspose ? __ldg(R + j * F + i) : __ldg(R + i * F + j), in[j], acc);
    }
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
gf_density_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const float* __restrict__ packed, const __grid_constant__ Shape s,
                  long long n) {
  extern __shared__ float tile[];
  const long long row0 = (long long)blockIdx.x * blockDim.x;
  const long long row = row0 + threadIdx.x;
  const bool active = row < n;
  const int rows = (int)min((long long)blockDim.x, n - row0);
  const int F = s.F;
  float a[kMaxF], b[kMaxF];
  float* cur = a;
  float* nxt = b;
  if (active) {
    for (int f = 0; f < F; ++f) cur[f] = x[row * F + f];
  }
  float acc = 0.0f;
  for (int si = 0; si < s.n_stages; ++si) {
    const Stage& st = s.st[si];
    if (st.kind == kRot) {
      if (active) rotate<false>(packed + st.off, F, cur, nxt);
      float* t = cur;
      cur = nxt;
      nxt = t;
    } else if (st.kind == kGauss) {
      if (!active) continue;
      for (int f = 0; f < F; ++f) {
        float ladj;
        cur[f] = gauss_forward(cur[f], packed + st.off + f * 3 * st.K, st.K, &ladj);
        acc += ladj;
      }
    } else {
      const int ts = (st.fc * 3 * st.K) | 1;
      for (int f0 = 0; f0 < F; f0 += st.fc) {
        const int nf = min(st.fc, F - f0);
        __syncthreads();  // every thread is done with the previous chunk
        stage_tile(tile, st, ts, f0, nf, row0, rows);
        __syncthreads();
        if (!active) continue;
        float* p = tile + threadIdx.x * ts;
        fill_scales(p, nf, st.K);
        for (int fl = 0; fl < nf; ++fl) {
          float ladj;
          cur[f0 + fl] = gauss_forward(cur[f0 + fl], p + fl * 3 * st.K, st.K, &ladj);
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

// One layer's inverse for features [f0, f0 + nf) of a row, parameters at p.
template <bool kLogQ>
__device__ __forceinline__ void invert_features(float* y, const float* p, int f0, int nf, int K,
                                                float* acc) {
  for (int fl = 0; fl < nf; ++fl) {
    const float* pf = p + fl * 3 * K;
    const float xv = gauss_inverse(y[f0 + fl], pf, K);
    if (kLogQ) {
      float ladj;
      gauss_forward(xv, pf, K, &ladj);
      *acc += ladj;
    }
    y[f0 + fl] = xv;
  }
}

template <bool kLogQ>
__global__ void __launch_bounds__(kThreads)
gf_sample_kernel(const float* __restrict__ z, float* __restrict__ xout,
                 float* __restrict__ logq, const float* __restrict__ packed,
                 const __grid_constant__ Shape s, long long n) {
  extern __shared__ float tile[];
  const long long row0 = (long long)blockIdx.x * blockDim.x;
  const long long row = row0 + threadIdx.x;
  const bool active = row < n;
  const int rows = (int)min((long long)blockDim.x, n - row0);
  const int F = s.F;
  float a[kMaxF], b[kMaxF];
  float* y = a;
  float* nxt = b;
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
      float* t = y;
      y = nxt;
      nxt = t;
    } else if (st.kind == kGauss) {
      if (active) invert_features<kLogQ>(y, packed + st.off, 0, F, st.K, &acc);
    } else {
      const int ts = (st.fc * 3 * st.K) | 1;
      for (int f0 = 0; f0 < F; f0 += st.fc) {
        const int nf = min(st.fc, F - f0);
        __syncthreads();
        stage_tile(tile, st, ts, f0, nf, row0, rows);
        __syncthreads();
        if (!active) continue;
        float* p = tile + threadIdx.x * ts;
        fill_scales(p, nf, st.K);
        invert_features<kLogQ>(y, p, f0, nf, st.K, &acc);
      }
    }
  }
  if (!active) return;
  for (int f = 0; f < F; ++f) xout[row * F + f] = y[f];
  if (kLogQ) logq[row] = acc;
}

// Fill the kernel's description of the flow from the wrapper's arrays (one
// entry per stage) and size the shared tile.
int make_shape(Shape* s, size_t* smem, const int* kinds, const int* Ks, const long long* offs,
               const void* const* shifts, const void* const* raws,
               const long long* row_strides, const int* feat_strides, int n_stages, int F) {
  if (F < 1 || F > kMaxF || n_stages < 1 || n_stages > kMaxStages) return cudaErrorInvalidValue;
  s->F = F;
  s->n_stages = n_stages;
  int tile_row = 0;
  for (int i = 0; i < n_stages; ++i) {
    Stage& st = s->st[i];
    st.kind = kinds[i];
    st.K = Ks[i];
    st.off = offs[i];
    st.fc = 0;
    st.feat_stride = 0;
    st.row_stride = 0;
    st.shift = nullptr;
    st.raw = nullptr;
    if (st.kind == kRot) continue;
    if ((st.kind != kGauss && st.kind != kGaussBatched) || st.K < 1 || st.K > kMaxK)
      return cudaErrorInvalidValue;
    if (st.kind == kGaussBatched) {
      if (shifts[i] == nullptr || raws[i] == nullptr) return cudaErrorInvalidValue;
      st.shift = (const float*)shifts[i];
      st.raw = (const float*)raws[i];
      st.row_stride = row_strides[i];
      st.feat_stride = feat_strides[i];
      st.fc = std::min(F, std::max(1, (kTileRow - 1) / (3 * st.K)));
      tile_row = std::max(tile_row, (st.fc * 3 * st.K) | 1);
    }
  }
  *smem = (size_t)kThreads * tile_row * sizeof(float);
  return cudaSuccess;
}

template <typename Kernel>
int configure(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// out (n,) = log_prob of x (n, F). `packed` holds the stages without per-row
// parameters at offs[i]: a layer as [F][3][K] (shift, scale, log scale), a
// rotation as R (F, F) row-major. A layer with per-row parameters gives
// shifts[i] and raws[i], (n, F, K) with strides (row_strides[i],
// feat_strides[i], 1) in floats.
extern "C" int gf_density_f32(const float* x, float* out, const float* packed,
                              const int* kinds, const int* Ks, const long long* offs,
                              const void* const* shifts, const void* const* raws,
                              const long long* row_strides, const int* feat_strides,
                              int n_stages, int F, long long n, void* stream) {
  Shape s;
  size_t smem;
  int rc = make_shape(&s, &smem, kinds, Ks, offs, shifts, raws, row_strides, feat_strides,
                      n_stages, F);
  if (rc != cudaSuccess) return rc;
  if (n <= 0) return cudaSuccess;
  rc = configure(gf_density_kernel, smem);
  if (rc != cudaSuccess) return rc;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  gf_density_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(x, out, packed, s, n);
  return cudaGetLastError();
}

// xout (n, F) = T^-1(z), and logq (n,) = log q(xout) unless logq is null.
extern "C" int gf_sample_f32(const float* z, float* xout, float* logq, const float* packed,
                             const int* kinds, const int* Ks, const long long* offs,
                             const void* const* shifts, const void* const* raws,
                             const long long* row_strides, const int* feat_strides,
                             int n_stages, int F, long long n, void* stream) {
  Shape s;
  size_t smem;
  int rc = make_shape(&s, &smem, kinds, Ks, offs, shifts, raws, row_strides, feat_strides,
                      n_stages, F);
  if (rc != cudaSuccess) return rc;
  if (n <= 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (logq != nullptr) {
    rc = configure(gf_sample_kernel<true>, smem);
    if (rc != cudaSuccess) return rc;
    gf_sample_kernel<true><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(z, xout, logq,
                                                                             packed, s, n);
  } else {
    rc = configure(gf_sample_kernel<false>, smem);
    if (rc != cudaSuccess) return rc;
    gf_sample_kernel<false><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(z, xout, nullptr,
                                                                              packed, s, n);
  }
  return cudaGetLastError();
}

extern "C" const char* gf_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
