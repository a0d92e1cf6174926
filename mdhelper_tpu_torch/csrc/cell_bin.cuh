// Exact bin of one slot pair, shared by the cell-list kernels.
//
// The pair-binning math of the JAX package's _bin_exact / _bin_exact_shift /
// _bin_exact_tri27 + _exact_index_from_d2 with the "zero" boundary constants,
// written once so that every cell-list kernel bins a pair identically: an
// exact double-float squared pair distance d^2 (the displacement policy's
// job), then one shared tail (index_from_d2): a float32-estimated bin and a
// +-1 correction against the exact (k * dr)^2 boundaries.
//
// The displacement is a policy (the `Image` template parameter of exact_bin),
// each with a d2(a, c) producer:
//   OrthoImage  per-pair minimum image in an orthorhombic box (_bin_exact):
//               image multiple m = rint(s / L) on each axis;
//   ShiftImage  one lattice translation for the whole (cell, neighbour)
//               block of a triclinic grid (_bin_exact_shift): d = (i - j) -
//               shift, the shift a double-float row of the frame's image
//               table.  No per-pair rint, division or image search;
//   Tri27Image  per-pair triclinic minimum image for grids whose blocks have
//               no single translation (_bin_exact_tri27, the "tri_pp" mode):
//               a base image multiple n0 from the rounded float32 fractional
//               displacement, then all 27 candidates n0 + {-1, 0, 1}^3 in
//               double-float and their double-float minimum.
// Each policy is inlined, so the orthorhombic and per-block kernels compile
// to the code they had before the policies gained d2 producers.
//
// Precision traps, each named where it bites below: FMA contraction
// (doublefloat.cuh), half-to-even rounding of the image multiples, IEEE sqrt
// and division (no --use_fast_math), the left-to-right order of the
// fractional products, and truncating float -> int conversion of the bin
// estimate.
//
// float32 operations of one binned pair, counted from this source (adds,
// subtractions, multiplications, divisions, sqrt, rint, min/max and the
// compares of df_ge; a negation folded into its add counts nothing; integer
// index and loop arithmetic is not counted; work done once a block, such as
// Tri27Block's splits of the box entries, is not counted a pair): two_sum 6,
// two_diff 6, split 4, two_prod 17 (1 + 2 splits + 8), two_prod_split 9,
// df_add 14, df_sub 14, df_square 26 (two_prod + 3 + two_sum; its two splits
// of one value are counted as written, though a compiler may merge them),
// df_sum3 28, boundary 34 (1 conversion + two_prod + 2 + df_add), df_ge 3,
// df_min 3 (its compares).
//   OrthoImage component: two_diff 6 + div + rint + mul + df_sub 14 +
//     df_square 26 = 49; d2 = 3 * 49 + df_sum3 28 = 175.
//   ShiftImage component: two_diff 6 + df_sub 14 + df_square 26 = 46;
//     d2 = 3 * 46 + 28 = 166.
//   Tri27Image: 3 two_diff 18 + n0 18 (3 x (3 mul + 2 add + rint)); one
//     candidate = 3 adds (m = n0 + shift) + 3 splits of m 12 + axis 0 95
//     (two_prod_split + 2 x (two_prod_split + df_add) + df_sub + df_square)
//     + axis 1 72 + axis 2 49 + df_sum3 28 = 259; d2 = 18 + 18 + 27 * 259 +
//     26 df_min * 3 = 7,107.
//   index_from_d2 tail: estimate 5 (max, sqrt, mul, min, conversion) + 2
//     boundaries 68 + 2 compares 6 = 79.
//   One pair: 175 + 79 = 254 (orthorhombic), 166 + 79 = 245 (per-block
//   triclinic), 7,107 + 79 = 7,186 (tri_pp: about 28 orthorhombic pairs).
#pragma once

#include <cuda_runtime.h>

#include "doublefloat.cuh"

namespace cellbin {

using dfloat::df;

// sum_k (component k of the displacement)^2 in double-float, for the
// policies whose displacement is per axis.
template <class Image>
__device__ __forceinline__ df sum_of_squares(const Image& image, float4 a,
                                             float4 c) {
  const float pa[3] = {a.x, a.y, a.z};
  const float pc[3] = {c.x, c.y, c.z};
  df sq[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sq[k] = dfloat::df_square(image.component(k, pa[k], pc[k]));
  }
  return dfloat::df_sum3(sq[0], sq[1], sq[2]);
}

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

  __device__ __forceinline__ df d2(float4 a, float4 c) const {
    return sum_of_squares(*this, a, c);
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

  __device__ __forceinline__ df d2(float4 a, float4 c) const {
    return sum_of_squares(*this, a, c);
  }
};

// Per-pair 27-candidate minimum image in a triclinic cell: `h` is the
// lower-triangular float32 box matrix (rows are the box vectors; only
// h[j][k] with j >= k is read), `hs` its entries' Dekker splits (made once
// a block, as is everything here) and `inv` the float32 inverse the host
// computed from it once a frame (the JAX package's flat (18,) box_arg).
struct Tri27Image {
  float h[3][3];
  df hs[3][3];
  float inv[3][3];

  // d^2 of the candidate image m: component k is s_k - sum_{j >= k} m_j
  // h[j][k], the sum df-accumulated in ascending j (the oracle's order).
  // Each m_j is split once for its 1 to 3 products.
  __device__ __forceinline__ df candidate(const df s[3], const float m[3])
      const {
    df ms[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) ms[j] = dfloat::split(m[j]);
    df sq[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      df t = dfloat::two_prod_split(m[k], ms[k], h[k][k], hs[k][k]);
#pragma unroll
      for (int j = k + 1; j < 3; ++j) {
        t = dfloat::df_add(
            t, dfloat::two_prod_split(m[j], ms[j], h[j][k], hs[j][k]));
      }
      sq[k] = dfloat::df_square(dfloat::df_sub(s[k], t));
    }
    return dfloat::df_sum3(sq[0], sq[1], sq[2]);
  }

  __device__ __forceinline__ df d2(float4 a, float4 c) const {
    const float pa[3] = {a.x, a.y, a.z};
    const float pc[3] = {c.x, c.y, c.z};
    df s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = dfloat::two_diff(pa[k], pc[k]);
    // Base image multiple: f_k = s0 inv[0][k] + s1 inv[1][k] + s2 inv[2][k]
    // left to right, each product and sum rounded on its own (no FMA), then
    // rounded half to even -- the order of _bin_exact_tri27 and of the
    // port's _exact_d2_triclinic (_row_times).
    float n0[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float f = __fadd_rn(
          __fadd_rn(__fmul_rn(s[0].hi, inv[0][k]),
                    __fmul_rn(s[1].hi, inv[1][k])),
          __fmul_rn(s[2].hi, inv[2][k]));
      n0[k] = rintf(f);
    }
    // The zero shift first, then the 26 others in lexicographic order of
    // (sx, sy, sz) in {-1, 0, 1}^3 (_TRI_PP_SHIFTS).  The minimum is a value
    // of the set whatever the order; the order is the JAX package's.
    const float m0[3] = {__fadd_rn(n0[0], 0.0f), __fadd_rn(n0[1], 0.0f),
                         __fadd_rn(n0[2], 0.0f)};
    df best = candidate(s, m0);
#pragma unroll 1
    for (int q = 1; q < 27; ++q) {
      const int lex = q <= 13 ? q - 1 : q;  // skip lexicographic 13, zero
      const float m[3] = {
          __fadd_rn(n0[0], static_cast<float>(lex / 9 - 1)),
          __fadd_rn(n0[1], static_cast<float>((lex / 3) % 3 - 1)),
          __fadd_rn(n0[2], static_cast<float>(lex % 3 - 1))};
      best = dfloat::df_min(best, candidate(s, m));
    }
    return best;
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

// Triclinic per pair (tri_pp): the frame's box matrix and its inverse.
struct Tri27Block {
  const float* boxes;  // (n_frames, 18): H row-major, then inv(H) row-major

  __device__ __forceinline__ Tri27Image at(int frame, int, int) const {
    const float* b = boxes + 18 * static_cast<long long>(frame);
    Tri27Image image;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        image.h[r][c] = b[3 * r + c];
        image.hs[r][c] = dfloat::split(image.h[r][c]);
        image.inv[r][c] = b[9 + 3 * r + c];
      }
    }
    return image;
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

// Bin of a double-float d^2; n_bins or above means out of range.
__device__ __forceinline__ int index_from_d2(df d2, int n_bins, float inv_dr,
                                             float dr2_hi, float dr2_lo) {
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

// Bin of the pair (a, c) (xyz of two slots) under the displacement policy
// `image`; n_bins or above means out of range.
template <class Image>
__device__ __forceinline__ int exact_bin(float4 a, float4 c,
                                         const Image& image, int n_bins,
                                         float inv_dr, float dr2_hi,
                                         float dr2_lo) {
  return index_from_d2(image.d2(a, c), n_bins, inv_dr, dr2_hi, dr2_lo);
}

}  // namespace cellbin
