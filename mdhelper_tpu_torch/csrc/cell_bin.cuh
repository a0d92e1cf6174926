// The bin of one slot pair, shared by the cell-list kernels.
//
// The pair-binning math of the JAX package's _bin_exact / _bin_exact_shift /
// _bin_exact_tri27 + _exact_index_from_d2 and of _bin_fast / _bin_fast_shift
// / _bin_fast_tri27 + _fast_index_from_dist, written once so that every
// cell-list kernel bins a pair identically.  Two policies make a bin:
//
// The displacement (the `Image` a kernel's block geometry makes), each with
// an exact double-float d^2 producer d2(a, c) and a float32 one fast_d2:
//   OrthoImage   per-pair minimum image in an orthorhombic box (_bin_exact,
//                _bin_fast): image multiple m = rint(s / L) on each axis;
//   OrthoImage2  the same over the first two axes only, the 2-D drop_axis
//                grids (the wrapper puts the kept axes first): d^2 is one
//                df_add of two components (_bin_exact with two axes);
//   ShiftImage   one lattice translation for the whole (cell, neighbour)
//                block of a triclinic grid (_bin_exact_shift): d = (i - j) -
//                shift, the shift a double-float row of the frame's image
//                table.  No per-pair rint, division or image search;
//   Tri27Image   per-pair triclinic minimum image for grids whose blocks have
//                no single translation (_bin_exact_tri27, the "tri_pp" mode):
//                a base image multiple n0 from the rounded float32 fractional
//                displacement, then all 27 candidates n0 + {-1, 0, 1}^3 in
//                double-float and their double-float minimum.
// The binning (the `Bins` kernel parameter, a convention and a precision):
//   ZeroExact    bins from 0, the "zero" constants: a float32-estimated bin
//                and a +-1 correction against the exact (k * dr)^2
//                boundaries (index_from_d2);
//   OffsetExact  bins from r_min > 0, the "offset" constants: boundaries
//                e0^2 + 2 e0 h k + h^2 k^2 accumulated in double-float, the
//                estimate clipped before the correction, the below-range
//                spill, the closed last edge (offset_index_from_d2);
//   ZeroFast, OffsetFast  the float32 distance sqrt(fast_d2) times 1 / h,
//                truncated (_fast_index_from_dist).
// Every policy is inlined: the instantiations of the "zero" exact policy
// compile to the code they had before the other policies existed.
//
// Precision traps, each named where it bites below: FMA contraction
// (doublefloat.cuh), half-to-even rounding of the image multiples, IEEE sqrt
// and division (no --use_fast_math), the left-to-right order of the
// fractional products and of the float32 squares, and truncating float ->
// int conversion of the bin estimate.
//
// float32 operations of one binned pair, counted from this source (adds,
// subtractions, multiplications, divisions, sqrt, rint, min/max, the float
// compares of the tails and conversions; a negation folded into its add
// counts nothing; integer index and loop arithmetic is not counted, nor are
// the compares of the exclusion ids; work done once a block or a thread,
// such as Tri27Block's splits of the box entries and OffsetExact's first
// and last boundaries, is not counted a pair): two_sum 6, two_diff 6,
// split 4, two_prod 17 (1 + 2 splits + 8), two_prod_split 9, df_add 14,
// df_sub 14, df_square 26 (two_prod + 3 + two_sum; its two splits of one
// value are counted as written, though a compiler may merge them), df_sum3
// 28, df_ge 3, df_min 3 (its compares).
//   OrthoImage component: two_diff 6 + div + rint + mul + df_sub 14 +
//     df_square 26 = 49; d2 = 3 * 49 + df_sum3 28 = 175.
//   OrthoImage2: d2 = 2 * 49 + df_add 14 = 112.
//   ShiftImage component: two_diff 6 + df_sub 14 + df_square 26 = 46;
//     d2 = 3 * 46 + 28 = 166.
//   Tri27Image: 3 two_diff 18 + n0 18 (3 x (3 mul + 2 add + rint)); one
//     candidate = 3 adds (m = n0 + shift) + 3 splits of m 12 + axis 0 95
//     (two_prod_split + 2 x (two_prod_split + df_add) + df_sub + df_square)
//     + axis 1 72 + axis 2 49 + df_sum3 28 = 259; d2 = 18 + 18 + 27 * 259 +
//     26 df_min * 3 = 7,107.
//   fast_d2: OrthoImage 3 x (sub, div, rint, mul, sub, square) + 2 adds =
//     20; OrthoImage2 2 x 6 + 1 = 13; ShiftImage 3 x (2 sub, square) + 2 =
//     11; Tri27Image 3 deltas + 3 fractions x 7 (3 mul, 2 add, rint, sub)
//     + back to Cartesian 9 (6 mul, 3 add) + square sum 5 + 26 candidates x
//     18 (shift 9: 6 mul, 3 add; 3 adds; square sum 5; min 1) = 506.
//   ZeroExact tail: estimate 5 (max, sqrt, mul, min, conversion) + 2
//     boundaries 68 (each: conversion + two_prod 17 + mul + add + df_add
//     14) + 2 compares 6 = 79.
//   OffsetExact tail: estimate 7 (max, sqrt, sub, mul, max, min,
//     conversion) + 2 boundaries 120 (each: conversion, k^2 mul, splits of
//     k and k^2 8, 2 two_prod_split 18, 2 x (mul + add), 2 df_add 28 = 60)
//     + 2 compares 6 + range test 8 (2 compares 6, 2 equalities) + min 1 =
//     142.
//   ZeroFast tail 4 (sqrt, mul, min, conversion); OffsetFast 7 (sqrt,
//     compare, sub, mul, max, min, conversion).
//   One pair, exact (zero / offset): 254 / 317 orthorhombic, 191 / 254 2-D,
//   245 / 308 per-block triclinic, 7,186 / 7,249 tri_pp (about 28
//   orthorhombic pairs); fast (zero / offset): 24 / 27, 17 / 20, 15 / 18,
//   510 / 513.
#pragma once

#include <cuda_runtime.h>

#include "doublefloat.cuh"

namespace cellbin {

using dfloat::df;

// One component of the orthorhombic minimum image, exact: s = a - c
// error-free, minus m * L with m = rint(s.hi / L).  Assumes wrapped inputs
// (image multiple in {-1, 0, 1}).
__device__ __forceinline__ df ortho_component(float a, float c, float len) {
  const df s = dfloat::two_diff(a, c);
  // Rounding trap: jnp.round rounds half to even; rintf does, roundf
  // would not.  IEEE division (__fdiv_rn), never the fast approximation.
  const float m = rintf(__fdiv_rn(s.hi, len));
  // Wrapped inputs give m in {-1, 0, 1}, so m * L is exact.
  return dfloat::df_sub(s, {__fmul_rn(m, len), 0.0f});
}

// The same component in float32 (_bin_fast): delta - L * rint(delta / L).
__device__ __forceinline__ float fast_ortho_component(float a, float c,
                                                      float len) {
  const float delta = __fsub_rn(a, c);
  return __fsub_rn(delta, __fmul_rn(len, rintf(__fdiv_rn(delta, len))));
}

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

// float32 squares of the n components, summed left to right (the JAX
// kernels' `d2 = delta * delta if d2 is None else d2 + delta * delta`).
__device__ __forceinline__ float sum_of_fast_squares(const float* delta,
                                                     int n) {
  float d2 = __fmul_rn(delta[0], delta[0]);
  for (int k = 1; k < n; ++k) d2 = __fadd_rn(d2, __fmul_rn(delta[k], delta[k]));
  return d2;
}

// Per-pair minimum image in an orthorhombic box of lengths `len`; assumes
// wrapped inputs (image multiple in {-1, 0, 1}).
struct OrthoImage {
  float len[3];

  __device__ __forceinline__ df component(int k, float a, float c) const {
    return ortho_component(a, c, len[k]);
  }

  __device__ __forceinline__ df d2(float4 a, float4 c) const {
    return sum_of_squares(*this, a, c);
  }

  __device__ __forceinline__ float fast_d2(float4 a, float4 c) const {
    const float delta[3] = {fast_ortho_component(a.x, c.x, len[0]),
                            fast_ortho_component(a.y, c.y, len[1]),
                            fast_ortho_component(a.z, c.z, len[2])};
    return sum_of_fast_squares(delta, 3);
  }
};

// The orthorhombic minimum image over the first two axes: the 2-D grids,
// whose slot tables hold the two kept coordinates first.  Summing two
// components with one df_add equals the XLA route's three-component sum of
// positions whose dropped coordinate is zeroed (a zero double-float is an
// identity of df_add): the JAX package's _bin_exact with two axes.
struct OrthoImage2 {
  float len[2];

  __device__ __forceinline__ df d2(float4 a, float4 c) const {
    return dfloat::df_add(dfloat::df_square(ortho_component(a.x, c.x, len[0])),
                          dfloat::df_square(ortho_component(a.y, c.y, len[1])));
  }

  __device__ __forceinline__ float fast_d2(float4 a, float4 c) const {
    const float delta[2] = {fast_ortho_component(a.x, c.x, len[0]),
                            fast_ortho_component(a.y, c.y, len[1])};
    return sum_of_fast_squares(delta, 2);
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

  // _bin_fast_shift: (i - shift_hi) - j on each axis, in that order.
  __device__ __forceinline__ float fast_d2(float4 a, float4 c) const {
    const float delta[3] = {__fsub_rn(__fsub_rn(a.x, shift[0].hi), c.x),
                            __fsub_rn(__fsub_rn(a.y, shift[1].hi), c.y),
                            __fsub_rn(__fsub_rn(a.z, shift[2].hi), c.z)};
    return sum_of_fast_squares(delta, 3);
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

  // _bin_fast_tri27: the float32 fractional displacement folded by rint,
  // back to Cartesian through the lower-triangular h (rows j >= k of column
  // k, ascending), then the smallest of its square and its 26 neighbouring
  // images' (shift s: base_k + sum_{j >= k} s_j h[j][k]), every product and
  // sum in the JAX kernel's order.
  __device__ __forceinline__ float fast_d2(float4 a, float4 c) const {
    const float delta[3] = {__fsub_rn(a.x, c.x), __fsub_rn(a.y, c.y),
                            __fsub_rn(a.z, c.z)};
    float frac[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float f = __fadd_rn(
          __fadd_rn(__fmul_rn(delta[0], inv[0][k]),
                    __fmul_rn(delta[1], inv[1][k])),
          __fmul_rn(delta[2], inv[2][k]));
      frac[k] = __fsub_rn(f, rintf(f));
    }
    float base[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float b = __fmul_rn(frac[k], h[k][k]);
#pragma unroll
      for (int j = k + 1; j < 3; ++j) {
        b = __fadd_rn(b, __fmul_rn(frac[j], h[j][k]));
      }
      base[k] = b;
    }
    float best = sum_of_fast_squares(base, 3);
#pragma unroll 1
    for (int q = 0; q < 27; ++q) {
      if (q == 13) continue;  // the zero shift, taken above
      const float shift[3] = {static_cast<float>(q / 9 - 1),
                              static_cast<float>((q / 3) % 3 - 1),
                              static_cast<float>(q % 3 - 1)};
      float cand[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float sv = __fmul_rn(shift[k], h[k][k]);
#pragma unroll
        for (int j = k + 1; j < 3; ++j) {
          sv = __fadd_rn(sv, __fmul_rn(shift[j], h[j][k]));
        }
        cand[k] = __fadd_rn(base[k], sv);
      }
      best = fminf(best, sum_of_fast_squares(cand, 3));
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

// Orthorhombic, 2-D grid: the frame's first two lengths (the kept axes).
struct Ortho2Block {
  const float* boxes;  // (n_frames, 3), the kept axes first

  __device__ __forceinline__ OrthoImage2 at(int frame, int, int) const {
    return {{boxes[3 * frame], boxes[3 * frame + 1]}};
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

// Bins from 0, exact: the "zero" constants of _bin_boundary_constants.
struct ZeroExact {
  float inv_dr, dr2_hi, dr2_lo;

  __device__ __forceinline__ ZeroExact prepared(int) const { return *this; }

  template <class Image>
  __device__ __forceinline__ int index(const Image& image, float4 a,
                                       float4 c, int n_bins) const {
    return index_from_d2(image.d2(a, c), n_bins, inv_dr, dr2_hi, dr2_lo);
  }
};

// Bins from r_min > 0, exact: the "offset" constants (e0 and 1 / h as
// float32, the double-float coefficients c0 = e0^2, c1 = 2 e0 h, c2 = h^2
// split from float64 on the host), replicating the offset tail of
// _exact_index_from_d2 and ops/histogram._exact_bin_indices operation for
// operation.  prepared() splits c1.hi and c2.hi once (two_prod_split then
// gives two_prod's bits) and forms the first and last boundaries, which
// every pair's range test reads.
struct OffsetExact {
  float e0, inv_h;
  df c0, c1, c2;
  df c1s, c2s;      // splits of c1.hi and c2.hi (prepared)
  df first, last;   // boundary(0) and boundary(n_bins) (prepared)

  // e0^2 + 2 e0 h k + h^2 k^2 as df_add(df_add(c0, t1), t2), t1 = k c1 and
  // t2 = k^2 c2 each a two_prod plus the low coefficient's product.
  __device__ __forceinline__ df boundary(int k) const {
    const float kf = static_cast<float>(k);
    const float k2 = __fmul_rn(kf, kf);
    const df t1 = dfloat::two_prod_split(kf, dfloat::split(kf), c1.hi, c1s);
    const df t2 = dfloat::two_prod_split(k2, dfloat::split(k2), c2.hi, c2s);
    const df acc = dfloat::df_add(
        c0, {t1.hi, __fadd_rn(t1.lo, __fmul_rn(kf, c1.lo))});
    return dfloat::df_add(acc,
                          {t2.hi, __fadd_rn(t2.lo, __fmul_rn(k2, c2.lo))});
  }

  __device__ __forceinline__ OffsetExact prepared(int n_bins) const {
    OffsetExact out = *this;
    out.c1s = dfloat::split(c1.hi);
    out.c2s = dfloat::split(c2.hi);
    out.first = out.boundary(0);
    out.last = out.boundary(n_bins);
    return out;
  }

  template <class Image>
  __device__ __forceinline__ int index(const Image& image, float4 a,
                                       float4 c, int n_bins) const {
    const df d2 = image.d2(a, c);
    const float dist = __fsqrt_rn(fmaxf(d2.hi, 0.0f));
    // The estimate clipped to [0, n_bins] before the truncating cast, which
    // equals the JAX package's clip of the truncated value.
    const float est = fminf(
        fmaxf(__fmul_rn(__fsub_rn(dist, e0), inv_h), 0.0f),
        static_cast<float>(n_bins));
    int idx = static_cast<int>(est);
    const int up = dfloat::df_ge(d2, boundary(idx + 1));
    const int down = dfloat::df_lt(d2, boundary(idx));
    idx = idx + up - down;
    // The closed last edge: a pair exactly on it (both halves equal)
    // belongs to the last bin, as in numpy.histogram.
    const bool at_last = d2.hi == last.hi && d2.lo == last.lo;
    const bool in_range =
        dfloat::df_ge(d2, first) && (dfloat::df_lt(d2, last) || at_last);
    return in_range ? min(idx, n_bins - 1) : n_bins;
  }
};

// Bins from 0, fast: trunc(sqrt(d2) * inv_dr), clamped to n_bins before
// the cast (which changes no index below it).
struct ZeroFast {
  float inv_dr;

  __device__ __forceinline__ ZeroFast prepared(int) const { return *this; }

  template <class Image>
  __device__ __forceinline__ int index(const Image& image, float4 a,
                                       float4 c, int n_bins) const {
    const float dist = __fsqrt_rn(image.fast_d2(a, c));
    return static_cast<int>(
        fminf(__fmul_rn(dist, inv_dr), static_cast<float>(n_bins)));
  }
};

// Bins from r_min > 0, fast: trunc((dist - e0) * inv_h), a distance under
// e0 spilled (truncation would round (-1, 0) up to bin 0).
struct OffsetFast {
  float e0, inv_h;

  __device__ __forceinline__ OffsetFast prepared(int) const { return *this; }

  template <class Image>
  __device__ __forceinline__ int index(const Image& image, float4 a,
                                       float4 c, int n_bins) const {
    const float dist = __fsqrt_rn(image.fast_d2(a, c));
    if (dist < e0) return n_bins;
    return static_cast<int>(
        fminf(fmaxf(__fmul_rn(__fsub_rn(dist, e0), inv_h), 0.0f),
              static_cast<float>(n_bins)));
  }
};

// Calls f(bins) with the binning policy of the entry points' arguments:
// the fast and offset flags and the 8 constants of the convention (zero:
// inv_dr, dr2_hi, dr2_lo; offset: e0, inv_h, c0, c1, c2 as (hi, lo)).
template <class F>
int with_bins(int fast, int offset, const float c[8], F&& f) {
  if (offset) {
    if (fast) return f(OffsetFast{c[0], c[1]});
    OffsetExact bins{};
    bins.e0 = c[0];
    bins.inv_h = c[1];
    bins.c0 = {c[2], c[3]};
    bins.c1 = {c[4], c[5]};
    bins.c2 = {c[6], c[7]};
    return f(bins);
  }
  if (fast) return f(ZeroFast{c[0]});
  return f(ZeroExact{c[0], c[1], c[2]});
}

}  // namespace cellbin
