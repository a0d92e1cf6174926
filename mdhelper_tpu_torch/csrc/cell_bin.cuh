// Exact bin of one slot pair, shared by the cell-list kernels.
//
// The pair-binning math of the JAX package's _bin_exact +
// _exact_index_from_d2 with the "zero" boundary constants, written once so
// that cell_pair_histogram.cu and cross_pair_histogram.cu bin a pair
// identically: exact double-float minimum-image d^2 of two wrapped float32
// points, a float32-estimated bin, and a +-1 correction against the exact
// (k * dr)^2 boundaries.
//
// Precision traps, each named where it bites below: FMA contraction
// (doublefloat.cuh), half-to-even rounding of the image multiple, IEEE sqrt
// and division (no --use_fast_math), and truncating float -> int conversion
// of the bin estimate.
#pragma once

#include <cuda_runtime.h>

#include "doublefloat.cuh"

namespace cellbin {

using dfloat::df;

// Exact boundary (k * dr)^2 of the "zero" convention: k^2 formed in
// integers, then two_prod(k^2, dr2_hi) + k^2 * dr2_lo, normalized by a
// df_add onto zero exactly as the JAX kernels do (split-sensitive).
__device__ __forceinline__ df boundary(int k, float dr2_hi, float dr2_lo) {
  float k2 = static_cast<float>(k * k);
  df b = dfloat::two_prod(k2, dr2_hi);
  b.lo = __fadd_rn(b.lo, __fmul_rn(k2, dr2_lo));
  return dfloat::df_add({0.0f, 0.0f}, b);
}

// Bin of the pair (a, c) (xyz of two slots); n_bins or above means out of
// range.  `box` holds the frame's three orthorhombic lengths.
__device__ __forceinline__ int exact_bin(float4 a, float4 c,
                                         const float box[3], int n_bins,
                                         float inv_dr, float dr2_hi,
                                         float dr2_lo) {
  const float pa[3] = {a.x, a.y, a.z};
  const float pc[3] = {c.x, c.y, c.z};
  df sq[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    df s = dfloat::two_diff(pa[k], pc[k]);
    // Rounding trap: jnp.round rounds half to even; rintf does, roundf
    // would not.  IEEE division (__fdiv_rn), never the fast approximation.
    float m = rintf(__fdiv_rn(s.hi, box[k]));
    // Wrapped inputs give m in {-1, 0, 1}, so m * L is exact.
    df d = dfloat::df_sub(s, {__fmul_rn(m, box[k]), 0.0f});
    sq[k] = dfloat::df_square(d);
  }
  const df d2 = dfloat::df_sum3(sq[0], sq[1], sq[2]);
  // Truncation trap: convert_element_type truncates toward zero, so the
  // estimate uses a C cast, not __float2int_rn.  IEEE sqrt (__fsqrt_rn).
  // Clamping to n_bins before the cast keeps far pairs of huge boxes in
  // int range; it equals min((int)x, n_bins) for any x >= 0.
  const float est = __fmul_rn(__fsqrt_rn(fmaxf(d2.hi, 0.0f)), inv_dr);
  int idx = static_cast<int>(fminf(est, static_cast<float>(n_bins)));
  const int up = dfloat::df_ge(d2, boundary(idx + 1, dr2_hi, dr2_lo));
  const int down = dfloat::df_lt(d2, boundary(idx, dr2_hi, dr2_lo));
  return idx + up - down;
}

}  // namespace cellbin
