// Double-float (float32 pair) arithmetic on the device.
//
// The CUDA counterpart of mdhelper_tpu_torch/ops/doublefloat.py (and of
// mdhelper_tpu/ops/doublefloat.py), operation for operation and in the
// same order.  A value is an unevaluated sum hi + lo of two floats.
//
// Precision trap, FMA contraction: nvcc contracts a*b+c into one fused
// multiply-add by default.  That changes the rounding of two_prod's error
// term and of df_square's e + 2*x0*x1, and double-float compares are
// split-sensitive on bin-edge tie pairs.  Every product and sum below is
// therefore spelled with the round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn), which nvcc never contracts; the library is also
// built with --fmad=false as a second guard.
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

// Dekker split with the 2^12 + 1 splitter.
__device__ __forceinline__ df split(float a) {
  float c = __fmul_rn(4097.0f, a);
  float hi = __fsub_rn(c, __fsub_rn(c, a));
  return {hi, __fsub_rn(a, hi)};
}

// Error-free a * b = p + e (Dekker):
// e = ((a_hi*b_hi - p) + a_hi*b_lo + a_lo*b_hi) + a_lo*b_lo, left to right.
__device__ __forceinline__ df two_prod(float a, float b) {
  float p = __fmul_rn(a, b);
  df as = split(a);
  df bs = split(b);
  float e = __fsub_rn(__fmul_rn(as.hi, bs.hi), p);
  e = __fadd_rn(e, __fmul_rn(as.hi, bs.lo));
  e = __fadd_rn(e, __fmul_rn(as.lo, bs.hi));
  e = __fadd_rn(e, __fmul_rn(as.lo, bs.lo));
  return {p, e};
}

// two_prod of factors split beforehand (as = split(a), bs = split(b)): the
// same operations after the splits, for a factor that is split once and
// multiplied many times.
__device__ __forceinline__ df two_prod_split(float a, df as, float b, df bs) {
  float p = __fmul_rn(a, b);
  float e = __fsub_rn(__fmul_rn(as.hi, bs.hi), p);
  e = __fadd_rn(e, __fmul_rn(as.hi, bs.lo));
  e = __fadd_rn(e, __fmul_rn(as.lo, bs.hi));
  e = __fadd_rn(e, __fmul_rn(as.lo, bs.lo));
  return {p, e};
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

// (hi, lo)^2: e + (2 * x.hi) * x.lo, then renormalize.
__device__ __forceinline__ df df_square(df x) {
  df p = two_prod(x.hi, x.hi);
  float e = __fadd_rn(p.lo, __fmul_rn(__fmul_rn(2.0f, x.hi), x.lo));
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
