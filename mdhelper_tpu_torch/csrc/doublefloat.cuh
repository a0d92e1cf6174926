// Double-float (float32 pair) arithmetic on the device.
//
// The CUDA counterpart of mdhelper_tpu_torch/ops/doublefloat.py (and of
// mdhelper_tpu/ops/doublefloat.py), operation for operation and in the
// same order, except the product's error term (exact_prod below).  A value
// is an unevaluated sum hi + lo of two floats.
//
// Precision trap, FMA contraction: nvcc contracts a*b+c into one fused
// multiply-add by default.  That changes the rounding of exact_square's
// e + 2*x0*x1 and of every sum the plain version rounds twice, and
// double-float compares are split-sensitive on bin-edge tie pairs.  Every
// product and sum below is therefore spelled with the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts,
// and the one fused operation as __fmaf_rn; the library is also built with
// --fmad=false as a second guard.
#pragma once

namespace dfloat {

struct df {
  float hi;
  float lo;
};

// Error-free a + b = s + e (Knuth).
__device__ __forceinline__ df two_sum(float a, float b) {
  float s = __fadd_rn(a, b);
  float bb = __fsub_rn(s, a);
  float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return {s, e};
}

// Error-free a - b = s + e.
__device__ __forceinline__ df two_diff(float a, float b) {
  float s = __fsub_rn(a, b);
  float bb = __fsub_rn(s, a);
  float e = __fsub_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fadd_rn(b, bb));
  return {s, e};
}

// Error-free a * b = p + e by one fused multiply-add: p = fl(a b) and
// e = fma(a, b, -p), a b - p rounded once.  That difference is a float
// whenever a b is zero or |a b| >= 2^-101 (|a b - p| <= ulp(p) / 2 then
// holds at most 24 significant bits at or above 2^-149), so e is exact and
// equals the error term of Dekker's two_prod with 4097 splits
// (ops/doublefloat.py), which is exact on the same range while both factors
// stay below 2^115, where 4097 a would overflow (12-bit halves: every
// partial product exact).
// Both give +0 for a zero factor.  The magnitudes each kernel meets, and
// why they lie in that range, are in its note (cell_bin.cuh, trig_sums.cu).
__device__ __forceinline__ df exact_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  return {p, __fmaf_rn(a, b, -p)};
}

// (hi, lo) + (hi, lo) with renormalization.
__device__ __forceinline__ df df_add(df x, df y) {
  df s = two_sum(x.hi, y.hi);
  float e = __fadd_rn(__fadd_rn(s.lo, x.lo), y.lo);
  return two_sum(s.hi, e);
}

__device__ __forceinline__ df df_sub(df x, df y) {
  return df_add(x, {-y.hi, -y.lo});
}

__device__ __forceinline__ df df_sum3(df x, df y, df z) {
  return df_add(df_add(x, y), z);
}

// The plain version's df_square with exact_prod: e + (2 * x.hi) * x.lo
// rounded twice, never contracted, then renormalized.
__device__ __forceinline__ df exact_square(df x) {
  const df p = exact_prod(x.hi, x.hi);
  const float e = __fadd_rn(p.lo, __fmul_rn(__fmul_rn(2.0f, x.hi), x.lo));
  return two_sum(p.hi, e);
}

// x >= y (lexicographic on normalized pairs).
__device__ __forceinline__ bool df_ge(df x, df y) {
  return (x.hi > y.hi) || ((x.hi == y.hi) && (x.lo >= y.lo));
}

__device__ __forceinline__ bool df_lt(df x, df y) { return !df_ge(x, y); }

__device__ __forceinline__ df df_min(df x, df y) {
  return df_lt(y, x) ? y : x;
}

}  // namespace dfloat
