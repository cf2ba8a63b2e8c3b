// Masked linear layer (MADE) for Hopper (sm_90a).
//
// Replaces the TPU kernel zuko_tpu/ops/masked_linear.py::_masked_linear_pallas
// (pallas_call at :116; body _kernel :29): y[r, o] = sum_i x[r, i] * (W[o, i] *
// M[o, i]) (+ b[o]). As in the TPU kernel's body the mask is multiplied into
// the weight tile inside the kernel, so the masked weight matrix never
// exists in device memory; the bias is added in the epilogue.
//
// What bounds it on an H100: bytes, at the widths of tabular flows. A row
// moves 4 * (In + Out) bytes for 2 * In * Out operations, that is
// In * Out / (2 * (In + Out)) operations per byte: 16 for 64 -> 64 and 22
// for 64 -> 138, around the card's 20 float32 operations per byte, and 2.7
// for the 6 -> 64 input layer. Full float32 on the CUDA cores: no tensor
// cores, no TF32.
//
// Design (simple and right first): a block of 16 x 16 threads takes a tile
// of 64 rows x 64 outputs, walks the input width in steps of 16, stages the
// x tile and the masked weight tile in shared memory (the mask multiply
// happens while staging), and each thread accumulates a 4 x 4 patch with
// fmaf in registers. Ragged edges in all three sizes are masked in the
// kernel (zero-filled tiles, guarded stores): nothing is padded on the host.
// A row of 16 threads writes 64 consecutive outputs, so stores coalesce.
//
// The C entry point checks its arguments, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;  // rows of x per block
constexpr int kTileOut = 64;   // outputs per block
constexpr int kTileIn = 16;    // input features per step
constexpr int kPatch = 4;      // each thread: kPatch x kPatch outputs
constexpr int kSide = 16;      // threads per block side: kTileRows / kPatch
constexpr int kThreads = kSide * kSide;

__global__ void __launch_bounds__(kThreads)
masked_linear_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ mask, const float* __restrict__ bias,
                     float* __restrict__ y, long long n, int in_f, int out_f) {
  // one more column than the tile: the transposing stores spread over banks
  __shared__ float xs[kTileIn][kTileRows + 1];
  __shared__ float ws[kTileIn][kTileOut + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const long long row0 = (long long)blockIdx.x * kTileRows;
  const int out0 = blockIdx.y * kTileOut;

  float acc[kPatch][kPatch];
#pragma unroll
  for (int i = 0; i < kPatch; ++i)
#pragma unroll
    for (int j = 0; j < kPatch; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < in_f; k0 += kTileIn) {
    for (int e = tid; e < kTileRows * kTileIn; e += kThreads) {
      const int r = e / kTileIn, k = e % kTileIn;
      const long long row = row0 + r;
      xs[k][r] = (row < n && k0 + k < in_f) ? x[row * in_f + k0 + k] : 0.0f;
    }
    for (int e = tid; e < kTileOut * kTileIn; e += kThreads) {
      const int o = e / kTileIn, k = e % kTileIn;
      const int out = out0 + o;
      float v = 0.0f;
      if (out < out_f && k0 + k < in_f) {
        const long long at = (long long)out * in_f + k0 + k;
        v = w[at] * mask[at];
      }
      ws[k][o] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileIn; ++k) {
      float a[kPatch], b[kPatch];
#pragma unroll
      for (int i = 0; i < kPatch; ++i) a[i] = xs[k][ty * kPatch + i];
#pragma unroll
      for (int j = 0; j < kPatch; ++j) b[j] = ws[k][tx * kPatch + j];
#pragma unroll
      for (int i = 0; i < kPatch; ++i)
#pragma unroll
        for (int j = 0; j < kPatch; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const long long row = row0 + ty * kPatch + i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < kPatch; ++j) {
      const int out = out0 + tx * kPatch + j;
      if (out < out_f) y[row * out_f + out] = acc[i][j] + (bias ? bias[out] : 0.0f);
    }
  }
}

}  // namespace

// x (n, in_f), w and mask (out_f, in_f), bias (out_f,) or null, y (n, out_f);
// all contiguous float32.
extern "C" int masked_linear_f32(const float* x, const float* w, const float* mask,
                                 const float* bias, float* y, long long n, int in_f,
                                 int out_f, void* stream) {
  if (n < 0 || in_f < 1 || out_f < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long row_blocks = (n + kTileRows - 1) / kTileRows;
  const int out_blocks = (out_f + kTileOut - 1) / kTileOut;
  if (row_blocks > 2147483647LL || out_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)row_blocks, (unsigned)out_blocks);
  masked_linear_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, w, mask, bias, y, n,
                                                                   in_f, out_f);
  return cudaGetLastError();
}

extern "C" const char* masked_linear_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
