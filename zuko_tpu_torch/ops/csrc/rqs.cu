// Element-wise rational-quadratic spline for Hopper (sm_90a).
//
// Replaces the TPU kernel zuko_tpu/ops/rqs.py::_pallas_rqs (pallas_call at
// :106; body _kernel :84, math _rqs_math :34): given each element's K + 1
// horizontal, vertical and derivative knots, the spline's forward map or its
// closed-form inverse, and the log-Jacobian of the map that was applied (for
// the inverse: of the inverse map). An element outside [knot_0, knot_K)
// passes through unchanged with a zero log-Jacobian.
//
// What bounds it on an H100: bytes. An element reads 4 * (1 + 3 * (K + 1))
// bytes and writes 8 (116 in all at K = 8) for some 40 operations, far
// below the card's 20 float32 operations per byte, so the least time is the
// traffic's. The unfused flow pays it because the knots come from device
// memory; the whole-flow kernels (nsf_fused.cu) never write them.
//
// Design (simple and right first): one thread per element. The thread runs
// the shared device functions of rqs.cuh straight on its rows of the knot
// arrays in device memory: the bin search reads one row of K + 1 knots, the
// evaluation six more values of the bin found. A warp's 32 rows are
// contiguous, so every fetched line is used in full, across the iterations
// of the search through L1 rather than in one coalesced instruction. The
// knots are read where they lie, so any number of bins is taken.
//
// The C entry point checks its arguments, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "rqs.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
rqs_kernel(const float* __restrict__ x, const float* __restrict__ hs,
           const float* __restrict__ vs, const float* __restrict__ ds,
           float* __restrict__ out, float* __restrict__ ladj, int K, long long m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float* h = hs + i * (K + 1);
  const float* v = vs + i * (K + 1);
  const float* d = ds + i * (K + 1);
  float l;
  if (kInverse) {
    out[i] = rqs::inverse<true>(x[i], h, v, d, K, &l);
  } else {
    out[i] = rqs::forward(x[i], h, v, d, K, &l);
  }
  ladj[i] = l;
}

}  // namespace

// x, out, ladj: (m,); hs, vs, ds: (m, K + 1), contiguous.
extern "C" int rqs_f32(const float* x, const float* hs, const float* vs, const float* ds,
                       float* out, float* ladj, int K, long long m, int inverse,
                       void* stream) {
  if (K < 1 || m < 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (inverse) {
    rqs_kernel<true><<<blocks, kThreads, 0, st>>>(x, hs, vs, ds, out, ladj, K, m);
  } else {
    rqs_kernel<false><<<blocks, kThreads, 0, st>>>(x, hs, vs, ds, out, ladj, K, m);
  }
  return cudaGetLastError();
}

extern "C" const char* rqs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
