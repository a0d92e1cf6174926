// Exact bin of one slot pair, shared by the cell-list kernels.
//
// The pair-binning math of the JAX package's _bin_exact / _bin_exact_shift
// + _exact_index_from_d2 with the "zero" boundary constants, written once so
// that every cell-list kernel bins a pair identically: an exact double-float
// pair displacement, its square d^2, a float32-estimated bin, and a +-1
// correction against the exact (k * dr)^2 boundaries.
//
// The displacement is a policy (the `Image` template parameter of exact_bin):
//   OrthoImage  per-pair minimum image in an orthorhombic box (_bin_exact):
//               image multiple m = rint(s / L) on each axis;
//   ShiftImage  one lattice translation for the whole (cell, neighbour)
//               block of a triclinic grid (_bin_exact_shift): d = (i - j) -
//               shift, the shift a double-float row of the frame's image
//               table.  No per-pair rint, division or image search.
// Each policy is inlined, so the orthorhombic kernels compile to the code
// they had before the policy existed.
//
// Precision traps, each named where it bites below: FMA contraction
// (doublefloat.cuh), half-to-even rounding of the image multiple, IEEE sqrt
// and division (no --use_fast_math), and truncating float -> int conversion
// of the bin estimate.
//
// float32 operations of one binned pair, counted from this source (adds,
// subtractions, multiplications, divisions, sqrt, rint, min/max and the
// compares of df_ge; a negation folded into its add counts nothing):
// two_sum 6, two_diff 6, split 4, two_prod 17 (1 + 2 splits + 8),
// df_add 14, df_sub 14, df_square 26 (two_prod + 3 + two_sum), df_sum3 28,
// boundary 34 (1 conversion + two_prod + 2 + df_add), df_ge 3.
//   OrthoImage component: two_diff 6 + div + rint + mul + df_sub 14 +
//     df_square 26 = 49; ShiftImage component: two_diff 6 + df_sub 14 +
//     df_square 26 = 46.
//   exact_bin tail: df_sum3 28 + estimate 5 (max, sqrt, mul, min,
//     conversion) + 2 boundaries 68 + 2 compares 6 = 107.
//   One pair: 3 * 49 + 107 = 254 (orthorhombic), 3 * 46 + 107 = 245
//   (triclinic).
#pragma once

#include <cuda_runtime.h>

#include "doublefloat.cuh"

namespace cellbin {

using dfloat::df;

// Per-pair minimum image in an orthorhombic box of lengths `len`; assumes
// wrapped inputs (image multiple in {-1, 0, 1}).
struct OrthoImage {
  float len[3];

  __device__ __forceinline__ df component(int k, float a, float c) const {
    const df s = dfloat::two_diff(a, c);
    // Rounding trap: jnp.round rounds half to even; rintf does, roundf
    // would not.  IEEE division (__fdiv_rn), never the fast approximation.
    const float m = rintf(__fdiv_rn(s.hi, len[k]));
    // Wrapped inputs give m in {-1, 0, 1}, so m * L is exact.
    return dfloat::df_sub(s, {__fmul_rn(m, len[k]), 0.0f});
  }
};

// One lattice translation for a whole block: the double-float (hi, lo)
// shift per axis, built on the host in the JAX package's order (the
// diagonal term first, then the rows below), so the split matches the XLA
// 27-image sweep's candidate bit for bit.
struct ShiftImage {
  df shift[3];

  __device__ __forceinline__ df component(int k, float a, float c) const {
    return dfloat::df_sub(dfloat::two_diff(a, c), shift[k]);
  }
};

// Where a kernel's block of (frame, home cell, neighbour entry) gets its
// Image.  Orthorhombic: the frame's three lengths.
struct OrthoBlock {
  const float* boxes;  // (n_frames, 3)

  __device__ __forceinline__ OrthoImage at(int frame, int, int) const {
    return {{boxes[3 * frame], boxes[3 * frame + 1], boxes[3 * frame + 2]}};
  }
};

// Triclinic: the frame's double-float lattice translation in the block's
// row of the image table.
struct TriclinicBlock {
  const int* images;      // (n_cells, n_nbr), rows of the shift table
  const float* shift_hi;  // (n_frames, 27, 3)
  const float* shift_lo;  // (n_frames, 27, 3)
  int n_nbr;

  __device__ __forceinline__ ShiftImage at(int frame, int home,
                                           int entry) const {
    const int img = images[home * n_nbr + entry];
    const long long row = (static_cast<long long>(frame) * 27 + img) * 3;
    return {{{shift_hi[row], shift_lo[row]},
             {shift_hi[row + 1], shift_lo[row + 1]},
             {shift_hi[row + 2], shift_lo[row + 2]}}};
  }
};

// Exact boundary (k * dr)^2 of the "zero" convention: k^2 formed in
// integers, then two_prod(k^2, dr2_hi) + k^2 * dr2_lo, normalized by a
// df_add onto zero exactly as the JAX kernels do (split-sensitive).
__device__ __forceinline__ df boundary(int k, float dr2_hi, float dr2_lo) {
  float k2 = static_cast<float>(k * k);
  df b = dfloat::two_prod(k2, dr2_hi);
  b.lo = __fadd_rn(b.lo, __fmul_rn(k2, dr2_lo));
  return dfloat::df_add({0.0f, 0.0f}, b);
}

// Bin of the pair (a, c) (xyz of two slots) under the displacement policy
// `image`; n_bins or above means out of range.
template <class Image>
__device__ __forceinline__ int exact_bin(float4 a, float4 c,
                                         const Image& image, int n_bins,
                                         float inv_dr, float dr2_hi,
                                         float dr2_lo) {
  const float pa[3] = {a.x, a.y, a.z};
  const float pc[3] = {c.x, c.y, c.z};
  df sq[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sq[k] = dfloat::df_square(image.component(k, pa[k], pc[k]));
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
