// The rational-quadratic spline's element arithmetic, shared by the
// whole-flow kernels (nsf_fused.cu) and the element-wise kernel (rqs.cu), so
// that one arithmetic serves all of them: the bin search, the forward map
// with its log-Jacobian, and the closed-form inverse. The knot pointers may
// point to registers, local, shared or device memory.
//
// Semantics (zuko_tpu/ops/rqs.py _rqs_math, zuko_tpu/transforms.py
// MonotonicRQSTransform): a value outside [knot_0, knot_K) passes through
// unchanged with a zero log-Jacobian; the inverse's discriminant is clamped
// at 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rqs {

// k = sum(knots < v) - 1; in the domain iff 0 <= k < K.
__device__ __forceinline__ int find_bin(const float* knots, int K, float v) {
  int k = -1;
  for (int j = 0; j <= K; ++j) k += knots[j] < v;
  return k;
}

// The derivative of the spline at the relative position z of a bin with
// slope s and end derivatives d0, d1; *denom is the rational's denominator.
__device__ __forceinline__ float jacobian(float z, float d0, float d1, float s, float* denom) {
  const float z1 = z * (1.0f - z);
  *denom = s + (d0 + d1 - 2.0f * s) * z1;
  return s * s * (2.0f * s * z1 + d0 * (1.0f - z) * (1.0f - z) + d1 * z * z) /
         (*denom * *denom);
}

__device__ __forceinline__ float forward(float x, const float* xs, const float* ys,
                                         const float* ds, int K, float* ladj) {
  const int k = find_bin(xs, K, x);
  if (k < 0 || k >= K) {  // out of domain: identity, ladj 0
    *ladj = 0.0f;
    return x;
  }
  const float x0 = xs[k], x1 = xs[k + 1], y0 = ys[k], y1 = ys[k + 1];
  const float d0 = ds[k], d1 = ds[k + 1];
  const float s = (y1 - y0) / (x1 - x0);
  const float z = (x - x0) / (x1 - x0);
  float denom;
  *ladj = logf(jacobian(z, d0, d1, s, &denom));
  return y0 + (y1 - y0) * (s * z * z + d0 * (z * (1.0f - z))) / denom;
}

// Closed-form quadratic root (zuko_tpu/ops/nsf_fused.py _spline_inverse_F).
// With kLadj, *ladj is the log-Jacobian of the inverse map at y: minus the
// forward one at the returned x.
template <bool kLadj>
__device__ __forceinline__ float inverse(float y, const float* xs, const float* ys,
                                         const float* ds, int K, float* ladj) {
  const int k = find_bin(ys, K, y);
  if (k < 0 || k >= K) {
    if (kLadj) *ladj = 0.0f;
    return y;
  }
  const float x0 = xs[k], x1 = xs[k + 1], y0 = ys[k], y1 = ys[k + 1];
  const float d0 = ds[k], d1 = ds[k + 1];
  const float s = (y1 - y0) / (x1 - x0);
  const float y_ = y - y0;
  const float t = d0 + d1 - 2.0f * s;
  const float a = (y1 - y0) * (s - d0) + y_ * t;
  const float b = (y1 - y0) * d0 - y_ * t;
  const float c = -s * y_;
  const float disc = fmaxf(b * b - 4.0f * a * c, 0.0f);
  const float z = 2.0f * c / (-b - sqrtf(disc));
  if (kLadj) {
    float denom;
    *ladj = -logf(jacobian(z, d0, d1, s, &denom));
  }
  return x0 + z * (x1 - x0);
}

}  // namespace rqs
