// What the two Jacobi kernels (jacobi_svd.cu, jacobi_eigh.cu) share: the
// round-robin schedule, the rotation angle and the constants of the JAX
// package's Jacobi programs (ttipm_tpu/ops/jacobi.py), in float64.
#pragma once

#include <cuda_runtime.h>

namespace ttipm {
namespace jacobi {

constexpr double kTiny = 1e-30;   // TINY, ttipm_tpu/ops/jacobi.py:46
constexpr int kMaxSweeps = 26;    // _MAX_SWEEPS
constexpr int kMaxDynamicSmem = 232448;

// The index at position p of step k of the round-robin schedule of even
// order n (_round_robin, ttipm_tpu/ops/jacobi.py:70-82): position 0 holds
// 0, position p >= 1 holds 1 + (p - 1 - k) mod (n - 1).  Step k pairs the
// indices at positions p and n - 1 - p, p < n / 2.
__device__ __forceinline__ int schedule_index(int n, int k, int p) {
  if (p == 0) return 0;
  const int r = (p - 1 - k) % (n - 1);
  return 1 + (r < 0 ? r + n - 1 : r);
}

// The position of index x at step k (the inverse of schedule_index).
__device__ __forceinline__ int schedule_position(int n, int k, int x) {
  return x == 0 ? 0 : 1 + (x - 1 + k) % (n - 1);
}

// (cs, sn) of the rotation with tangent t = sign(tau) / (|tau| + sqrt(1 +
// tau^2)), sign(0) = +1, t = 0 where it is not finite; the identity when
// `rotate` is false.  sqrt and the divisions are correctly rounded.
__device__ __forceinline__ void rotation(bool rotate, double tau, double& cs, double& sn) {
  double t = __ddiv_rn(tau >= 0.0 ? 1.0 : -1.0, fabs(tau) + __dsqrt_rn(1.0 + tau * tau));
  if (!isfinite(t)) t = 0.0;
  const double c = __ddiv_rn(1.0, __dsqrt_rn(1.0 + t * t));
  cs = rotate ? c : 1.0;
  sn = rotate ? c * t : 0.0;
}

// The larger of a and b, NaN if either is NaN (fmax drops a NaN).
__device__ __forceinline__ double max_nan(double a, double b) {
  return (a > b || isnan(a)) ? a : b;
}

}  // namespace jacobi
}  // namespace ttipm
