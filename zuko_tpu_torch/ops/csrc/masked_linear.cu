// Masked linear layer (MADE) for Hopper (sm_90a).
//
// Replaces the TPU kernel zuko_tpu/ops/masked_linear.py::_masked_linear_pallas
// (pallas_call at :116; body _kernel :29): y[r, o] = sum_i x[r, i] * (W[o, i] *
// M[o, i]) (+ b[o]). As in the TPU kernel's body the mask is multiplied into
// the weights inside the kernel, so the masked weight matrix never exists in
// device memory; the bias is added in the epilogue.
//
// What bounds it on an H100: bytes, at the widths of tabular flows. A row
// moves 4 * (In + Out) bytes for 2 * In * Out operations, that is
// In * Out / (2 * (In + Out)) operations per byte: 16 for 64 -> 64 and 22
// for 64 -> 138, around the card's 20 float32 operations per byte, and 2.7
// for the 6 -> 64 input layer. Register-tiled float32 on the CUDA cores
// reached about 40% of the float32 rate there and took longer than the
// bytes (as long as torch.nn.functional.linear at 64 -> 64); so the product
// runs on the tensor cores as a 3-pass TF32 split (no plain TF32): each
// operand a = hi + lo with hi = tf32(a), lo = tf32(a - hi), and the product
// lo hi + hi lo + hi hi, which leaves out lo lo (2^-22 of |a||b|), with the
// sums in float32: float32 accuracy, held against float64 by the checks.
//
// Design: persistent blocks (two a streaming multiprocessor, from the
// wrapper's plan, ops/masked_linear.py plan_masked_linear) that walk row
// tiles. A block splits M * W (the mask multiplied in) into its TF32 parts
// once and stages them in shared memory in the order the mma.sync.m16n8k8
// fragments load (one 16-byte load a fragment: hi and lo of both halves),
// with the bias; it covers every output of its tile, so x is read from
// device memory once. A tile of x is one contiguous run of R * In floats:
// it is copied with 16-byte cp.async (4-byte ones for a base that is not
// 16-byte aligned, for In not a multiple of 4 and for the ragged end) into
// rows padded to a multiple of 8 inputs (zeros) plus 4 floats, so the A
// fragments load without bank conflicts, and the next tile's copy overlaps
// this tile's product (two buffers). A warp takes 16 rows and NT tiles of 8
// outputs: WC = 1 warp across the outputs up to 64 of them (tiles of 128
// rows), else WC = 2 (tiles of 64 rows). Each lane stores its pairs of
// outputs from the fragments, four lanes filling a 32-byte sector of a row.
// Weights larger than the shared memory planned for them are walked in
// chunks of inputs (and of outputs), restaged for every tile, with one x
// buffer; nothing is padded on the host.
//
// The C entry point checks its arguments, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShared = 232448;  // a block's shared memory on an H100 (227 KB)

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }

// Floats of shared memory for a chunk of kc inputs, WC warps across NT
// tiles of 8 outputs each: the split weights in fragment order [kc rounded
// to 8, / 8][NT WC][32][4] and the bias [8 NT WC], nb x buffers [16 kWarps /
// WC rows][kc rounded to 8, + 4], two when the weights stay resident, one
// when they are walked in chunks (mirrored in ops/masked_linear.py
// plan_masked_linear).
__host__ __device__ inline long long shared_floats(int nt, int wc, int kc, int nb) {
  const long long cn = 8LL * nt * wc, kp = round8(kc), rows = 16LL * kWarps / wc;
  return 2 * kp * cn + cn + nb * rows * (kp + 4);
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT, int WC>
__global__ void __launch_bounds__(kThreads, 2)
masked_linear_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ mask, const float* __restrict__ bias,
                     float* __restrict__ y, long long n, int in_f, int out_f, int kc) {
  // outputs a chunk, 8-output tiles a block, warps down the rows, rows a tile
  constexpr int CN = 8 * NT * WC, NTB = CN / 8, WR = kWarps / WC, kRows = 16 * WR;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;            // the fragments' row and column
  const int r0 = (warp % WR) * 16, wc = warp / WR;  // the warp's rows and its part of the outputs
  const int n_kc = (in_f + kc - 1) / kc, n_cc = (out_f + CN - 1) / CN;
  const bool resident = n_kc == 1 && n_cc == 1;
  const int nb = resident ? 2 : 1;
  const int kp_max = round8(kc), kps = kp_max + 4;
  float4* wf = reinterpret_cast<float4*>(sm);  // [kp / 8][NTB][32]: hi b0, hi b1, lo b0, lo b1
  float* bs = sm + 2 * kp_max * CN;            // [CN]
  float* xs[2] = {bs + CN, bs + CN + (nb - 1) * kRows * kps};  // nb of [kRows][kps]
  const long long tiles = (n + kRows - 1) / kRows;
  const bool y8 = out_f % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 7) == 0;

  // M * W of inputs [k0, k0 + kw) and outputs [c0, c0 + cw), split, in the
  // order the fragments load; zero past both
  auto stage_weights = [&](int k0, int kw, int c0, int cw) {
    const int kp = round8(kw);
    for (int e = tid; e < (kp / 8) * NTB * 32; e += kThreads) {
      const int lf = e & 31, f = e >> 5, nt = f % NTB, ks = f / NTB;
      const int o = nt * 8 + (lf >> 2), k = ks * 8 + (lf & 3);
      float v[2];
      for (int h = 0; h < 2; ++h) {
        v[h] = 0.0f;
        if (o < cw && k + 4 * h < kw) {
          const long long at = (long long)(c0 + o) * in_f + k0 + k + 4 * h;
          v[h] = w[at] * mask[at];
        }
      }
      const uint32_t h0 = tf32(v[0]), h1 = tf32(v[1]);
      wf[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(tf32(v[0] - __uint_as_float(h0))),
                          __uint_as_float(tf32(v[1] - __uint_as_float(h1))));
    }
    for (int o = tid; o < CN; o += kThreads) bs[o] = (o < cw && bias) ? bias[c0 + o] : 0.0f;
  };
  auto copy_tile = [&](float* dst, long long tile) {
    const long long row0 = tile * kRows;
    const long long rows = n - row0 < kRows ? n - row0 : kRows;
    const int cnt = (int)(rows * in_f);
    const float* src = x + row0 * in_f;
    int done = 0;
    if (in_f % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      done = cnt;
      const int quads = in_f / 4;
      for (int e = tid; e < cnt / 4; e += kThreads) {
        const int r = e / quads, c = 4 * (e - r * quads);
        __pipeline_memcpy_async(dst + r * kps + c, src + 4 * e, 16);
      }
    }
    for (int e = done + tid; e < cnt; e += kThreads) {
      const int r = e / in_f, c = e - r * in_f;
      __pipeline_memcpy_async(dst + r * kps + c, src + e, 4);
    }
    __pipeline_commit();
  };
  auto load_chunk = [&](float* dst, long long tile, int k0, int kw) {
    const long long row0 = tile * kRows;
    const int kp = round8(kw);
    for (int e = tid; e < kRows * kp; e += kThreads) {
      const int r = e / kp, k = e - r * kp;
      dst[r * kps + k] = row0 + r < n && k < kw ? x[(row0 + r) * in_f + k0 + k] : 0.0f;
    }
  };
  float acc[NT][4];
  auto product = [&](const float* xt, int kw) {
    const float* xa = xt + (r0 + g) * kps + t;
    const float4* wl = wf + wc * NT * 32 + lane;
    for (int k = 0; k < kw; k += 8) {
      uint32_t ah[4], al[4];
      const float av[4] = {xa[k], xa[8 * kps + k], xa[k + 4], xa[8 * kps + k + 4]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ah[q] = tf32(av[q]);
        al[q] = tf32(av[q] - __uint_as_float(ah[q]));
      }
      const float4* wk = wl + (k / 8) * NTB * 32;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 b = wk[j * 32];
        const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
        mma(acc[j], al, bh0, bh1);
        mma(acc[j], ah, __float_as_uint(b.z), __float_as_uint(b.w));
        mma(acc[j], ah, bh0, bh1);
      }
    }
  };
  // the bias added, each lane's pairs of outputs stored from its fragments:
  // 4 lanes fill a 32-byte sector of a row
  auto epilogue = [&](long long tile, int c0, int cw) {
    const long long row0 = tile * kRows;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = wc * 8 * NT + 8 * j + 2 * t;
      if (c >= cw) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + r0 + g + 8 * h;
        if (row >= n) continue;
        float* out = y + row * out_f + c0 + c;
        const float v0 = acc[j][2 * h] + bs[c], v1 = acc[j][2 * h + 1] + bs[c + 1];
        if (y8 && c + 1 < cw) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          out[0] = v0;
          if (c + 1 < cw) out[1] = v1;
        }
      }
    }
  };
  auto zero = [&]() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
  };

  long long tile = blockIdx.x;
  if (resident) {
    stage_weights(0, in_f, 0, out_f);
    // the x rows' padding past in_f stays zero: the copies write in_f floats
    for (int e = tid; e < nb * kRows * kps; e += kThreads) {
      if (e % kps >= in_f) xs[0][e] = 0.0f;
    }
    if (tile < tiles) copy_tile(xs[0], tile);
    for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
      const long long next = tile + gridDim.x;
      __syncthreads();  // every thread is past the last product on the buffer to fill
      if (next < tiles) {
        copy_tile(xs[(it + 1) & 1], next);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // this tile's x (and, the first time, the weights)
      zero();
      product(xs[it & 1], in_f);
      epilogue(tile, 0, out_f);
    }
    return;
  }
  for (; tile < tiles; tile += gridDim.x) {
    for (int cc = 0; cc < n_cc; ++cc) {
      const int c0 = cc * CN, cw = out_f - c0 < CN ? out_f - c0 : CN;
      zero();
      for (int k0 = 0; k0 < in_f; k0 += kc) {
        const int kw = in_f - k0 < kc ? in_f - k0 : kc;
        __syncthreads();  // the previous chunk's product is done
        stage_weights(k0, kw, c0, cw);
        load_chunk(xs[0], tile, k0, kw);
        __syncthreads();
        product(xs[0], kw);
      }
      epilogue(tile, c0, cw);
    }
  }
}

template <int NT, int WC>
int launch_nt(const float* x, const float* w, const float* mask, const float* bias, float* y,
              long long n, int in_f, int out_f, int kc, int nb, int blocks, cudaStream_t stream) {
  const int bytes = (int)(4 * shared_floats(NT, WC, kc, nb));
  // the most shared memory each instantiation may take, set once
  static bool opted = false;
  if (!opted) {
    const int rc = cudaFuncSetAttribute(masked_linear_kernel<NT, WC>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (rc != cudaSuccess) return rc;
    opted = true;
  }
  masked_linear_kernel<NT, WC><<<blocks, kThreads, bytes, stream>>>(x, w, mask, bias, y, n,
                                                                    in_f, out_f, kc);
  return cudaGetLastError();
}

// the instantiation (nt, WC), nt one of NTs
template <int WC, int... NTs>
int dispatch(int nt, const float* x, const float* w, const float* mask, const float* bias,
             float* y, long long n, int in_f, int out_f, int kc, int nb, int blocks,
             cudaStream_t stream) {
  int rc = cudaErrorInvalidValue;
  ((nt == NTs
        ? (rc = launch_nt<NTs, WC>(x, w, mask, bias, y, n, in_f, out_f, kc, nb, blocks, stream))
        : 0),
   ...);
  return rc;
}

}  // namespace

// x (n, in_f), w and mask (out_f, in_f), bias (out_f,) or null, y (n, out_f);
// all contiguous float32 (x may start at any float). kc inputs a chunk (in_f
// when the weights stay in shared memory) and `blocks` persistent blocks,
// from the wrapper's plan. One warp across the outputs up to 64 of them
// (NT = ceil(out_f / 8)), else two (NT = ceil(out_f / 16), at most 16:
// chunks of 256 outputs).
extern "C" int masked_linear_f32(const float* x, const float* w, const float* mask,
                                 const float* bias, float* y, long long n, int in_f,
                                 int out_f, int kc, int blocks, void* stream) {
  if (n < 0 || in_f < 1 || out_f < 1 || kc < 1 || kc > in_f || blocks < 1)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int wc = out_f <= 64 ? 1 : 2;
  const int nt = wc == 1 ? (out_f + 7) / 8 : ((out_f + 15) / 16 < 16 ? (out_f + 15) / 16 : 16);
  const int nb = kc == in_f && out_f <= 8 * nt * wc ? 2 : 1;  // resident: two x buffers
  if (4 * shared_floats(nt, wc, kc, nb) > kMaxShared) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (wc == 1)
    return dispatch<1, 1, 2, 3, 4, 5, 6, 7, 8>(nt, x, w, mask, bias, y, n, in_f, out_f, kc, nb,
                                               blocks, s);
  return dispatch<2, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16>(nt, x, w, mask, bias, y, n, in_f,
                                                                out_f, kc, nb, blocks, s);
}

extern "C" const char* masked_linear_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
