// The scalar operations the kernels are written over, for float and double.
//
// Every kernel of this directory is a template on its element type T and
// is instantiated for double (the f64 profile) and float (the f32
// profile).  The float instances compute in float throughout: no operand,
// product or sum is widened to double, so the overloads below are the only
// arithmetic beside +, - and * on T, and literals are written T(0), T(1).
// sqrt and the reciprocal are correctly rounded in both types (LAPACK's
// pivot and reflector arithmetic); fma rounds once.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace ttipm {

__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }

__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }

__device__ __forceinline__ double rcp_rn(double x) { return __drcp_rn(x); }
__device__ __forceinline__ float rcp_rn(float x) { return __frcp_rn(x); }

__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ double copysign_(double a, double b) { return copysign(a, b); }
__device__ __forceinline__ float copysign_(float a, float b) { return copysignf(a, b); }

// The smallest normal and the largest finite value of the type (the
// argument only selects the overload).
__device__ __forceinline__ double min_normal(double) { return DBL_MIN; }
__device__ __forceinline__ float min_normal(float) { return FLT_MIN; }
__device__ __forceinline__ double max_finite(double) { return DBL_MAX; }
__device__ __forceinline__ float max_finite(float) { return FLT_MAX; }

}  // namespace ttipm
