// The bin of one slot pair, shared by the cell-list kernels.
//
// The pair-binning math of the JAX package's _bin_exact / _bin_exact_shift /
// _bin_exact_tri27 + _exact_index_from_d2 and of _bin_fast / _bin_fast_shift
// / _bin_fast_tri27 + _fast_index_from_dist, written once so that every
// cell-list kernel bins a pair identically.  Two policies make a bin:
//
// The displacement (the `Image` a kernel's block geometry makes), each with
// a float32 screen screen(a, c, cut, aux), the exact double-float d^2 of a
// pair that passed it exact_d2(a, c, aux), and a float32 d^2 fast_d2:
//   OrthoImage<3>  per-pair minimum image in an orthorhombic box
//                (_bin_exact, _bin_fast): image multiple m = rint(s / L) on
//                each axis, decided without a division (the half threshold
//                below);
//   OrthoImage<2>  the same over the first two axes only, the 2-D drop_axis
//                grids (the wrapper puts the kept axes first): d^2 is one
//                df_add of two components (_bin_exact with two axes);
//   ShiftImage   one lattice translation for the whole (cell, neighbour)
//                block of a triclinic grid (_bin_exact_shift): d = (i - j) -
//                shift, the shift a double-float row of the frame's image
//                table.  No per-pair image search;
//   Tri27Image   per-pair triclinic minimum image for grids whose blocks have
//                no single translation (_bin_exact_tri27, the "tri_pp" mode):
//                a base image multiple n0 from the rounded float32 fractional
//                displacement, then the double-float minimum over the 27
//                candidates n0 + {-1, 0, 1}^3 -- of which only those a
//                float32 screen cannot rule out are evaluated (below).
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
// Every policy is inlined.
//
// Precision traps, each named where it bites below: FMA contraction
// (doublefloat.cuh), half-to-even rounding of the image multiples, IEEE sqrt
// (no --use_fast_math), the left-to-right order of the fractional products
// and of the float32 squares, and truncating float -> int conversion of the
// bin estimate.
//
// Three changes from the first design, each giving the same bits:
//
// 1. two_prod by FMA (exact_prod).  p = fl(a b) and e = fma(a, b, -p): the
//    fused multiply-add rounds a b - p once, and that difference is a float
//    whenever a b neither overflows nor underflows (|a b - p| <= ulp(p) / 2
//    holds at most 24 significant bits at or above 2^-149 * 2^24).  Dekker's
//    product with two 4097 splits is then exact too (24-bit significands,
//    12-bit halves: every partial product is exact), so both give a b - p
//    and the same bits.  The products here are of coordinates, box entries,
//    image multiples and bin constants: magnitudes 2^-40..2^40, far from
//    2^-126 and 2^127 (and a zero factor gives +0 in both).  Only the
//    product's error term is fused; df_square's e + 2 x0 x1 stays two
//    roundings, as the plain version has it.  exact_prod and exact_square
//    live in doublefloat.cuh, shared with the trig sums.
// 2. No division for the orthorhombic image multiple.  Wrapped inputs give
//    |fl(s / L)| <= 1, where rint is 0 for |fl(s / L)| <= 0.5 (0.5 ties to
//    the even 0) and +-1 above.  fl(x / L) is odd and non-decreasing in x, so
//    with T the largest float whose fl(T / L) <= 0.5 (half_threshold: a walk
//    of at most two ulps up from L / 2, done once a work item from the
//    frame's box), m = (s > T) - (s < -T) is rint(fl(s / L)) for every s.
// 3. A float32 screen ahead of the double-float d^2.  The float32 d^2 f of
//    the same image (the fast components with the exact path's multiples)
//    lies within eps = 2^-18 sum_k A_k^2 of the double-float D, with A_k the
//    sum of the magnitudes component k is formed from (|s_k| and the
//    subtracted image terms).  Derivation: each float32 component makes at
//    most 9 roundings of values bounded by A_k (ignoring s.lo adds one more
//    u |s_k|), so it is within 10 u A_k (u = 2^-24) of the real component;
//    squaring gives 20 u A_k^2 (+ O(u^2)), the float32 squares and sums 3 u
//    sum A_k^2, the double-float D is within O(u^2) of the real d^2: |D - f|
//    <= 24 u sum A_k^2 against eps = 64 u sum A_k^2, a slack that also
//    covers the float32 rounding of A, of eps and of the compares below.
//    So a pair whose f - eps exceeds `cut` (the float above the last bin
//    boundary's high word, which is at least the boundary) lies strictly
//    beyond the last boundary and is counted by no exact policy: it skips
//    the double-float work.  Strictly larger real values of normalized
//    double-floats are strictly larger lexicographically (two_sum's low word
//    is within half the spacing on the side the high word was rounded from),
//    so in Tri27Image a candidate whose f exceeds min f + 2 eps is strictly
//    above the minimum, and df_min over the others equals the full 27-way
//    minimum, ties included (equal values are equal pairs).
//
// No tensor cores: a Gram-matrix d^2 (|a|^2 + |b|^2 - 2 a.b on wgmma) rounds
// otherwise than the per-pair minimum-image double-float, and the counts
// would no longer equal the plain version's.
//
// float32 operations of one binned pair, counted from this source as
// written (adds, subtractions, multiplications, FMAs, sqrt, rint, min/max,
// compares and selects, conversions; a negation or an absolute value
// folded into its operation counts nothing, a product by a constant +-1
// counts one though the compiler may fold it; integer index, queue and
// loop arithmetic is not counted, nor are the compares of the exclusion
// ids; work done once a work item or a thread, such as the half
// thresholds, eps of OrthoImage and the bin policies' prepared constants,
// is not counted a pair): two_sum 6, two_diff 6, exact_prod 2, df_add 14,
// df_sub 14, exact_square 11 (exact_prod + 3 + two_sum), df_sum3 28,
// df_ge 3, df_min 3.  Every pair pays its screen; only the pairs that pass
// it pay the exact part (which forms its components again, the sweep
// having queued the pair) and the tail:
//   OrthoImage<3> screen: 3 x (sub, image shift 4 (2 compares, 2
//     selects), sub) + squares 3 (mul, 2 FMAs) + eps test 2 = 23; exact:
//     3 x (two_diff 6 + image shift 4 + df_sub 14 + exact_square 11) +
//     df_sum3 28 = 133.
//   OrthoImage<2>: screen 2 x 6 + 2 + 2 = 16; exact 2 x 35 + df_add 14 =
//     84.
//   ShiftImage screen: 3 x (2 sub, |s| + |shift| add) + 2 x squares 3 +
//     eps mul + eps test 2 = 18; exact 3 x (two_diff 6 + df_sub 14 +
//     exact_square 11) + 28 = 121.
//   Tri27Image screen: two_diff 18 + n0 18 + A 15 + eps 4 + base
//     components 12 + the 27 candidates' f 110 (x - sigma h one add or
//     none; axis 2: 2 adds + 3 muls; axis 1: 12 adds + 9 FMAs; axis 0
//     base: 12 adds; axis 0: 18 adds + 27 FMAs + 27 mins) + eps test 2 +
//     threshold 2 + 27 compares = 208; exact: two_diff and n0 again 36,
//     then each kept candidate 3 adds + axis 0 59 + axis 1 43 + axis 2 27
//     + df_sum3 28 + df_min 3 = 163.
//   fast_d2: OrthoImage<3> 3 x (sub, image shift 4, sub, square) + 2 adds
//     = 23; OrthoImage<2> 2 x 7 + 1 = 15; ShiftImage 3 x (2 sub, square) +
//     2 = 11; Tri27Image 506 (unchanged: 3 deltas + 3 fractions x 7 + back
//     to Cartesian 9 + square sum 5 + 26 candidates x 18).
//   The row test (row_reaches) runs once a (home slot, ring tile), not a
//   pair: OrthoImage 3 x 9 + eps test 2, ShiftImage 3 x 12 + 3.
//   ZeroExact tail (exact pairs past the screen): estimate 5 (max, sqrt,
//     mul, min, conversion) + 2 boundaries 38 (each: conversion +
//     exact_prod 2 + mul + add + df_add 14) + 2 compares 6 = 49.
//   OffsetExact tail: estimate 7 + 2 boundaries 76 (each: conversion, k^2
//     mul, 2 exact_prod 4, 2 x (mul + add), 2 df_add 28 = 38) + 2 compares 6
//     + range test 8 + min 1 = 98.
//   ZeroFast tail 4 (sqrt, mul, min, conversion); OffsetFast 7 (sqrt,
//     compare, sub, mul, max, min, conversion).
//   One pair, exact (zero / offset tail): its screen, and for a pair that
//   passes it the exact part and the tail: orthorhombic 23 + 182 / 231,
//   2-D 16 + 133 / 182, per-block triclinic 18 + 170 / 219, tri_pp 208 +
//   36 + 163 k + 49 / 98 (k candidates kept: 1 for a pair away from the
//   Voronoi faces of its cell); fast (zero / offset): 27 / 30, 19 / 22,
//   15 / 18, 510 / 513.
#pragma once

#include <cmath>

#include <cuda_runtime.h>

#include "doublefloat.cuh"

namespace cellbin {

using dfloat::df;

// 2^-18, the screen's error bound factor (eps = kScreen * sum_k A_k^2).
constexpr float kScreen = 3.814697265625e-06f;

// Error-free products by one fused multiply-add (doublefloat.cuh; the note
// above: the same bits as Dekker's on these magnitudes).
using dfloat::exact_prod;
using dfloat::exact_square;

// The largest float T with fl(T / L) <= 0.5 (IEEE division: nvcc's
// default -prec-div=true, no fast math), from L / 2 (exact) up; fl(x / L)
// reaches 0.5 + 2^-24 within two ulps of L / 2, and the walk is bounded so
// that a poisoned (non-finite) box still ends.
__host__ __device__ inline float half_threshold(float len) {
  float t = 0.5f * len;
  for (int step = 0; step < 8; ++step) {
    const float next = nextafterf(t, INFINITY);
    if (next / len > 0.5f) break;
    t = next;
  }
  return t;
}

// m * L, m = rint(fl(s / L)) of a wrapped displacement, from the half
// threshold T: +-L or 0 (exactly the product, +0 included).
__device__ __forceinline__ float image_shift(float s, float t, float len) {
  return s > t ? len : (s < -t ? -len : 0.0f);
}

// One component of the orthorhombic minimum image, exact: s = a - c
// error-free, minus m * L.
__device__ __forceinline__ df ortho_component(float a, float c, float len,
                                              float half) {
  const df s = dfloat::two_diff(a, c);
  return dfloat::df_sub(s, {image_shift(s.hi, half, len), 0.0f});
}

// The same component in float32 (_bin_fast): delta - L * m, the multiple
// of the exact path (delta is its s.hi).
__device__ __forceinline__ float fast_ortho_component(float a, float c,
                                                      float len, float half) {
  const float delta = __fsub_rn(a, c);
  return __fsub_rn(delta, image_shift(delta, half, len));
}

// x^2 + y^2 (+ z^2) with fused multiply-adds: the screens' float32 d^2,
// fewer roundings than the fast policies' sum (whose order they need not
// keep: eps bounds either).
__device__ __forceinline__ float fused_squares(float x, float y) {
  return __fmaf_rn(y, y, __fmul_rn(x, x));
}
__device__ __forceinline__ float fused_squares(float x, float y, float z) {
  return __fmaf_rn(z, z, fused_squares(x, y));
}

// float32 squares of the n components, summed left to right (the JAX
// kernels' `d2 = delta * delta if d2 is None else d2 + delta * delta`).
__device__ __forceinline__ float sum_of_fast_squares(const float* delta,
                                                     int n) {
  float d2 = __fmul_rn(delta[0], delta[0]);
  for (int k = 1; k < n; ++k) d2 = __fadd_rn(d2, __fmul_rn(delta[k], delta[k]));
  return d2;
}

// Whether the screen rules the pair out: f - eps above `cut`.
__device__ __forceinline__ bool beyond(float f, float eps, float cut) {
  return __fsub_rn(f, eps) > cut;
}

// Per-pair minimum image in an orthorhombic box of `kAxes` (3, or the 2
// kept axes of a 2-D grid) lengths `len`; assumes wrapped inputs (image
// multiple in {-1, 0, 1}).  `half` are the half thresholds and `eps` the
// screen bound with A_k <= 2 L_k (|s_k| <= L_k, |m L_k| <= L_k), all made
// once a work item.  With two axes, summing the components with one df_add
// equals the XLA route's three-component sum of positions whose dropped
// coordinate is zeroed (a zero double-float is an identity of df_add): the
// JAX package's _bin_exact with two axes.
template <int kAxes>
struct OrthoImage {
  float len[kAxes];
  float half[kAxes];
  float eps;

  __host__ __device__ static OrthoImage of(const float* lengths) {
    OrthoImage image;
    float sum = 0.0f;
    for (int k = 0; k < kAxes; ++k) {
      image.len[k] = lengths[k];
      image.half[k] = half_threshold(lengths[k]);
      sum += 4.0f * lengths[k] * lengths[k];
    }
    image.eps = kScreen * sum;
    return image;
  }

  __device__ __forceinline__ float fast_d2(float4 a, float4 c) const {
    const float pa[3] = {a.x, a.y, a.z};
    const float pc[3] = {c.x, c.y, c.z};
    float delta[kAxes];
#pragma unroll
    for (int k = 0; k < kAxes; ++k) {
      delta[k] = fast_ortho_component(pa[k], pc[k], len[k], half[k]);
    }
    return sum_of_fast_squares(delta, kAxes);
  }

  // Whether the pair may lie at or below `cut` (false: strictly beyond).
  __device__ __forceinline__ bool screen(float4 a, float4 c, float cut,
                                         unsigned&) const {
    const float dx = fast_ortho_component(a.x, c.x, len[0], half[0]);
    const float dy = fast_ortho_component(a.y, c.y, len[1], half[1]);
    float f;
    if constexpr (kAxes == 2) {
      f = fused_squares(dx, dy);
    } else {
      f = fused_squares(dx, dy,
                        fast_ortho_component(a.z, c.z, len[2], half[2]));
    }
    return !beyond(f, eps, cut);
  }

  // Whether slot a may lie at or below `cut` from some slot of a tile whose
  // coordinates lie in [lo, hi] (false: every pair strictly beyond).  The
  // periodic distance from a_k to the interval is max(|t| - w, 0), t the
  // minimum image of a_k - mid (|a_k - mid| < L: the multiple from the
  // half threshold), w the half width; it bounds every pair's minimum
  // image component from below, and its float32 square sum is within the
  // screen's eps of that bound.
  __device__ __forceinline__ bool row_reaches(float4 a, const float* lo,
                                              const float* hi,
                                              float cut) const {
    const float pa[3] = {a.x, a.y, a.z};
    float lb = 0.0f;
#pragma unroll
    for (int k = 0; k < kAxes; ++k) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo[k], hi[k]));
      const float w = __fmul_rn(0.5f, __fsub_rn(hi[k], lo[k]));
      const float t = __fsub_rn(pa[k], mid);
      const float gap = fmaxf(
          __fsub_rn(fabsf(__fsub_rn(t, image_shift(t, half[k], len[k]))), w),
          0.0f);
      lb = __fmaf_rn(gap, gap, lb);
    }
    return !beyond(lb, eps, cut);
  }

  // The double-float d^2 of a pair that passed the screen.
  __device__ __forceinline__ df exact_d2(float4 a, float4 c,
                                         unsigned) const {
    const float pa[3] = {a.x, a.y, a.z};
    const float pc[3] = {c.x, c.y, c.z};
    df sq[kAxes];
#pragma unroll
    for (int k = 0; k < kAxes; ++k) {
      sq[k] = exact_square(ortho_component(pa[k], pc[k], len[k], half[k]));
    }
    if constexpr (kAxes == 2) {
      return dfloat::df_add(sq[0], sq[1]);
    } else {
      return dfloat::df_sum3(sq[0], sq[1], sq[2]);
    }
  }
};

// One lattice translation for a whole block: the double-float (hi, lo)
// shift per axis, built on the host in the JAX package's order (the
// diagonal term first, then the rows below), so the split matches the XLA
// 27-image sweep's candidate bit for bit.
struct ShiftImage {
  df shift[3];

  // _bin_fast_shift: (i - shift_hi) - j on each axis, in that order.
  __device__ __forceinline__ float fast_d2(float4 a, float4 c) const {
    const float delta[3] = {__fsub_rn(__fsub_rn(a.x, shift[0].hi), c.x),
                            __fsub_rn(__fsub_rn(a.y, shift[1].hi), c.y),
                            __fsub_rn(__fsub_rn(a.z, shift[2].hi), c.z)};
    return sum_of_fast_squares(delta, 3);
  }

  // The screen's components are (a - c) - shift_hi, A_k = |a_k - c_k| +
  // |shift_k|, per pair.
  __device__ __forceinline__ bool screen(float4 a, float4 c, float cut,
                                         unsigned&) const {
    const float pa[3] = {a.x, a.y, a.z};
    const float pc[3] = {c.x, c.y, c.z};
    float delta[3], mag[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = __fsub_rn(pa[k], pc[k]);
      delta[k] = __fsub_rn(s, shift[k].hi);
      mag[k] = __fadd_rn(fabsf(s), fabsf(shift[k].hi));
    }
    const float eps =
        __fmul_rn(kScreen, fused_squares(mag[0], mag[1], mag[2]));
    return !beyond(fused_squares(delta[0], delta[1], delta[2]), eps, cut);
  }

  // The row test of OrthoImage with the block's translation in place of
  // the minimum image: the gap from a - shift to [lo, hi] on each axis,
  // eps from magnitudes bounding every term (|a|, |shift|, the tile's).
  __device__ __forceinline__ bool row_reaches(float4 a, const float* lo,
                                              const float* hi,
                                              float cut) const {
    const float pa[3] = {a.x, a.y, a.z};
    float lb = 0.0f, mags = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo[k], hi[k]));
      const float w = __fmul_rn(0.5f, __fsub_rn(hi[k], lo[k]));
      const float t = __fsub_rn(__fsub_rn(pa[k], shift[k].hi), mid);
      const float gap = fmaxf(__fsub_rn(fabsf(t), w), 0.0f);
      lb = __fmaf_rn(gap, gap, lb);
      const float m = __fadd_rn(__fadd_rn(fabsf(pa[k]), fabsf(shift[k].hi)),
                                fmaxf(fabsf(lo[k]), fabsf(hi[k])));
      mags = __fmaf_rn(m, m, mags);
    }
    return !beyond(lb, __fmul_rn(kScreen, mags), cut);
  }

  __device__ __forceinline__ df exact_d2(float4 a, float4 c,
                                         unsigned) const {
    const float pa[3] = {a.x, a.y, a.z};
    const float pc[3] = {c.x, c.y, c.z};
    df sq[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sq[k] = exact_square(
          dfloat::df_sub(dfloat::two_diff(pa[k], pc[k]), shift[k]));
    }
    return dfloat::df_sum3(sq[0], sq[1], sq[2]);
  }
};

// Per-pair 27-candidate minimum image in a triclinic cell: `h` is the
// lower-triangular float32 box matrix (rows are the box vectors; only
// h[j][k] with j >= k is read) and `inv` the float32 inverse the host
// computed from it once a frame (the JAX package's flat (18,) box_arg).
struct Tri27Image {
  float h[3][3];
  float inv[3][3];

  // d^2 of the candidate image m: component k is s_k - sum_{j >= k} m_j
  // h[j][k], the sum df-accumulated in ascending j (the oracle's order).
  __device__ __forceinline__ df candidate(const df s[3], const float m[3])
      const {
    df sq[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      df t = exact_prod(m[k], h[k][k]);
#pragma unroll
      for (int j = k + 1; j < 3; ++j) {
        t = dfloat::df_add(t, exact_prod(m[j], h[j][k]));
      }
      sq[k] = exact_square(dfloat::df_sub(s[k], t));
    }
    return dfloat::df_sum3(sq[0], sq[1], sq[2]);
  }

  // The displacement's double-float components and the base image
  // multiple: f_k = s0 inv[0][k] + s1 inv[1][k] + s2 inv[2][k] left to
  // right, each product and sum rounded on its own (no FMA), then rounded
  // half to even -- the order of _bin_exact_tri27 and of the port's
  // _exact_d2_triclinic (_row_times).
  __device__ __forceinline__ void base_image(float4 a, float4 c, df s[3],
                                             float n0[3]) const {
    const float pa[3] = {a.x, a.y, a.z};
    const float pc[3] = {c.x, c.y, c.z};
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = dfloat::two_diff(pa[k], pc[k]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float f = __fadd_rn(
          __fadd_rn(__fmul_rn(s[0].hi, inv[0][k]),
                    __fmul_rn(s[1].hi, inv[1][k])),
          __fmul_rn(s[2].hi, inv[2][k]));
      n0[k] = rintf(f);
    }
  }

  // The screen of the note: the float32 d^2 of all 27 candidates n0 +
  // sigma, sigma in {-1, 0, 1}^3 (index q = 9 (sx + 1) + 3 (sy + 1) + sz +
  // 1, lexicographic), each within eps of its double-float d^2.  False
  // when the pair lies beyond `cut`; else `kept` gets the bit of every
  // candidate within 2 eps of the smallest f.
  __device__ __forceinline__ bool screen(float4 a, float4 c, float cut,
                                         unsigned& kept) const {
    df s[3];
    float n0[3];
    base_image(a, c, s, n0);
    // A_k = |s_k| + sum_{j >= k} (|n0_j| + 1) |h_jk| bounds every partial
    // value of component k of every candidate; the base components b_k =
    // s_k - sum_{j >= k} n0_j h_jk.
    float reach[3], base[3], mag[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) reach[j] = __fadd_rn(fabsf(n0[j]), 1.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float m = fabsf(s[k].hi);
      float b = s[k].hi;
#pragma unroll
      for (int j = k; j < 3; ++j) {
        m = __fadd_rn(m, __fmul_rn(reach[j], fabsf(h[j][k])));
        b = __fsub_rn(b, __fmul_rn(n0[j], h[j][k]));
      }
      mag[k] = m;
      base[k] = b;
    }
    const float eps =
        __fmul_rn(kScreen, fused_squares(mag[0], mag[1], mag[2]));
    // f of every candidate, component 2 outermost (it depends on sz only),
    // then 1 (sy, sz), then 0; x - sigma h as one add or subtraction, or
    // none.
    auto shifted = [](float x, float h_jk, int i) {
      return i == 0 ? __fadd_rn(x, h_jk) : i == 2 ? __fsub_rn(x, h_jk) : x;
    };
    float f[27];
    float fmin = INFINITY;
#pragma unroll
    for (int iz = 0; iz < 3; ++iz) {
      const float c2 = shifted(base[2], h[2][2], iz);
      const float sq2 = __fmul_rn(c2, c2);
#pragma unroll
      for (int iy = 0; iy < 3; ++iy) {
        const float c1 = shifted(shifted(base[1], h[1][1], iy), h[2][1], iz);
        const float sq12 = __fmaf_rn(c1, c1, sq2);
        const float b0 = shifted(shifted(base[0], h[1][0], iy), h[2][0], iz);
#pragma unroll
        for (int ix = 0; ix < 3; ++ix) {
          const float c0 = shifted(b0, h[0][0], ix);
          const float fq = __fmaf_rn(c0, c0, sq12);
          f[9 * ix + 3 * iy + iz] = fq;
          fmin = fminf(fmin, fq);
        }
      }
    }
    if (beyond(fmin, eps, cut)) return false;
    const float keep = __fadd_rn(fmin, __fmul_rn(2.0f, eps));
    kept = 0u;
#pragma unroll
    for (int q = 0; q < 27; ++q) {
      kept |= static_cast<unsigned int>(f[q] <= keep) << q;
    }
    return true;
  }

  // No row test: a tile's bounding box says little across 27 images.
  __device__ __forceinline__ bool row_reaches(float4, const float*,
                                              const float*, float) const {
    return true;
  }

  // The double-float minimum over the kept candidates (ascending q: the
  // minimum is a value of the set whatever the order).
  __device__ __forceinline__ df exact_d2(float4 a, float4 c,
                                         unsigned kept) const {
    df s[3];
    float n0[3];
    base_image(a, c, s, n0);
    df d2 = {INFINITY, 0.0f};
#pragma unroll 1
    while (kept) {
      const int q = __ffs(kept) - 1;
      kept &= kept - 1u;
      const float m[3] = {__fadd_rn(n0[0], static_cast<float>(q / 9 - 1)),
                          __fadd_rn(n0[1], static_cast<float>((q / 3) % 3 - 1)),
                          __fadd_rn(n0[2], static_cast<float>(q % 3 - 1))};
      d2 = dfloat::df_min(d2, candidate(s, m));
    }
    return d2;
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

// Where a work item gets its Image for (frame, home cell, neighbour entry);
// kPerEntry when it changes from entry to entry.  Orthorhombic: the frame's lengths (the kept axes first on a 2-D grid),
// with their half thresholds.
template <int kAxes>
struct OrthoBlock {
  static constexpr bool kPerEntry = false;
  const float* boxes;  // (n_frames, 3)

  __device__ __forceinline__ OrthoImage<kAxes> at(int frame, int,
                                                  int) const {
    return OrthoImage<kAxes>::of(boxes + 3 * static_cast<long long>(frame));
  }
};

// Triclinic: the frame's double-float lattice translation in the block's
// row of the image table.
struct TriclinicBlock {
  static constexpr bool kPerEntry = true;
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
  static constexpr bool kPerEntry = false;
  const float* boxes;  // (n_frames, 18): H row-major, then inv(H) row-major

  __device__ __forceinline__ Tri27Image at(int frame, int, int) const {
    const float* b = boxes + 18 * static_cast<long long>(frame);
    Tri27Image image;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        image.h[r][c] = b[3 * r + c];
        image.inv[r][c] = b[9 + 3 * r + c];
      }
    }
    return image;
  }
};

// The float just above a boundary's high word: at least the boundary's
// value (its low word is at most half an ulp of the high word).
__device__ __forceinline__ float above(df boundary) {
  return nextafterf(boundary.hi, INFINITY);
}

// Exact boundary (k * dr)^2 of the "zero" convention: k^2 formed in
// integers, then two_prod(k^2, dr2_hi) + k^2 * dr2_lo, normalized by a
// df_add onto zero exactly as the JAX kernels do (split-sensitive).
__device__ __forceinline__ df boundary(int k, float dr2_hi, float dr2_lo) {
  float k2 = static_cast<float>(k * k);
  df b = exact_prod(k2, dr2_hi);
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
// prepared() sets the screen's cut above boundary(n_bins).  Past 46,339
// bins the boundaries' k * k wraps in int32, in the plain version as here,
// and the counted set is no longer below one boundary: no pair is screened
// out there (cut = infinity).
struct ZeroExact {
  float inv_dr, dr2_hi, dr2_lo;
  float cut;

  __device__ __forceinline__ ZeroExact prepared(int n_bins) const {
    ZeroExact out = *this;
    out.cut = n_bins < 46340 ? above(boundary(n_bins, dr2_hi, dr2_lo))
                             : INFINITY;
    return out;
  }

  static constexpr bool kScreened = true;

  template <class Image>
  __device__ __forceinline__ bool screen(const Image& image, float4 a,
                                         float4 c, unsigned& aux) const {
    return image.screen(a, c, cut, aux);
  }

  // The bin of a pair that passed the screen (`aux` from it).
  template <class Image>
  __device__ __forceinline__ int index(const Image& image, float4 a,
                                       float4 c, unsigned aux,
                                       int n_bins) const {
    return index_from_d2(image.exact_d2(a, c, aux), n_bins, inv_dr, dr2_hi,
                         dr2_lo);
  }
};

// Bins from r_min > 0, exact: the "offset" constants (e0 and 1 / h as
// float32, the double-float coefficients c0 = e0^2, c1 = 2 e0 h, c2 = h^2
// split from float64 on the host), replicating the offset tail of
// _exact_index_from_d2 and ops/histogram._exact_bin_indices operation for
// operation.  prepared() forms the first and last boundaries, which every
// pair's range test reads, and the screen's cut above the last.
struct OffsetExact {
  float e0, inv_h;
  df c0, c1, c2;
  df first, last;  // boundary(0) and boundary(n_bins) (prepared)
  float cut;       // above(last) (prepared)

  // e0^2 + 2 e0 h k + h^2 k^2 as df_add(df_add(c0, t1), t2), t1 = k c1 and
  // t2 = k^2 c2 each a two_prod plus the low coefficient's product.
  __device__ __forceinline__ df boundary(int k) const {
    const float kf = static_cast<float>(k);
    const float k2 = __fmul_rn(kf, kf);
    const df t1 = exact_prod(kf, c1.hi);
    const df t2 = exact_prod(k2, c2.hi);
    const df acc = dfloat::df_add(
        c0, {t1.hi, __fadd_rn(t1.lo, __fmul_rn(kf, c1.lo))});
    return dfloat::df_add(acc,
                          {t2.hi, __fadd_rn(t2.lo, __fmul_rn(k2, c2.lo))});
  }

  __device__ __forceinline__ OffsetExact prepared(int n_bins) const {
    OffsetExact out = *this;
    out.first = out.boundary(0);
    out.last = out.boundary(n_bins);
    out.cut = above(out.last);
    return out;
  }

  static constexpr bool kScreened = true;

  template <class Image>
  __device__ __forceinline__ bool screen(const Image& image, float4 a,
                                         float4 c, unsigned& aux) const {
    return image.screen(a, c, cut, aux);
  }

  // The bin of a pair that passed the screen (`aux` from it).
  template <class Image>
  __device__ __forceinline__ int index(const Image& image, float4 a,
                                       float4 c, unsigned aux,
                                       int n_bins) const {
    const df d2 = image.exact_d2(a, c, aux);
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

  static constexpr bool kScreened = false;

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

  static constexpr bool kScreened = false;

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
  return f(ZeroExact{c[0], c[1], c[2], 0.0f});
}

}  // namespace cellbin
