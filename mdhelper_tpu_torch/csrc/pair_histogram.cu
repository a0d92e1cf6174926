// Brute-force pair-distance histogram of one group: the port of
// _hist_kernel, launched from pair_histogram in
// mdhelper_tpu/ops/pallas_kernels.py.
//
// What it computes.  Every ordered pair (i, j) of the n_atoms positions,
// identical atoms included (distance 0, bin 0), unless the exclusion drops
// i / e0 == j / e1 (global indices), is binned on [0, r_max] with the cell
// kernels' fast "zero" policy over OrthoImage<3>::fast_d2 (cell_bin.cuh:
// each component delta - L rint(delta / L), the multiple decided by the
// half thresholds without a division, squares summed left to right, IEEE
// sqrt, trunc(dist * inv_dr) with inv_dr = f32(n_bins / r_max)), and
// counted when its bin is below n_bins.  The wrapper does not wrap the
// positions: an i atom or a j tile with a coordinate outside [0, L] takes
// AnyImage, whose multiple comes from the division where |delta| > L, so
// any positions give the plain version's integers.  The box is an argument
// of the launch (the JAX kernel bakes it in).  The TPU kernel counts
// through a bf16 one-hot digit contraction into float32; here a
// shared-memory uint32 histogram with atomicAdd, flushed once a block into
// the int64 counts, gives the same integers (exact at any count, where
// float32 is exact below 2^24).
//
// Why the second design keeps the plain version's integers.
// 1. An exact cut on d^2.  The bin of a float32 d^2 is below n_bins iff
//    fl(fl(sqrt(d^2)) * inv_dr) < n_bins: sqrt, the product by a positive
//    constant and the clamp-and-truncate are non-decreasing, so that holds
//    for exactly the floats up to a largest one, D, and a NaN d^2 fails
//    every compare.  The wrapper finds D on the host in numpy float32 (IEEE
//    sqrt and product, as here) by walking float bit patterns from
//    (n_bins / inv_dr)^2, as cell_bin.cuh's half_threshold walks, and a
//    pair is binned iff d^2 <= D: one compare on every pair, and the sqrt,
//    the product and the truncation only on the pairs in range (about 0.7 %
//    at r_max 6 in the 100k-atom cube of 50 A).  No eps: the cut is exact
//    (tests/test_torch_kernel_math.py holds it against the plain
//    _fast_bin_index on every float within 64 ulps of D).
// 2. One d^2 a pair, for both orders.  fl(a - c) = -fl(c - a) under
//    round-to-nearest; the image shift is odd in s (s > T ? L : s < -T ?
//    -L : 0, and in AnyImage's division branch L rint(fl(s / L)), fl and
//    rint being odd, the branch chosen by |s|); so each component of (j, i)
//    is the negation of (i, j)'s and the squares, summed in the same order,
//    are the same bits (a zero component squares to +0 either way).  The
//    in-box and AnyImage formulas agree wherever both apply (|s| <= L), so
//    the path a thread takes changes no bit.  The kernel therefore sweeps
//    the block tiles with J >= I once: a tile pair J > I adds, for each
//    pair in range, the count of its two orders that the exclusion keeps,
//    (i / e0 != j / e1) + (j / e0 != i / e1), 0, 1 or 2 (2 without an
//    exclusion); a diagonal tile I == J sweeps its ordered pairs, i == j
//    included, each once, as the first design did, so an atom excluded from
//    itself or not (under (2, 3) atom 4 is not) counts as the plain version
//    counts it.  tests/test_torch_kernel_math.py checks the symmetry of the
//    plain version's d^2 bitwise, in and out of the box.
//
// What bounds it on the card: operations.  N (N - 1) / 2 unordered pairs
// of 24 float32 operations (cell_bin.cuh: OrthoImage<3> fast_d2 23 + the
// cut's compare; the compares of |delta| with L and the exclusion ids'
// integer work not counted), plus the tail of the pairs in range (sqrt,
// multiply, conversion: 3), against 12 N bytes of positions: at 100k atoms
// 5.0e9 pairs, a 1.79 ms bound.  The first design counted 27 on each of the
// N^2 ordered pairs (the tail on all of them), a 4.03 ms bound, and took
// 53.8 issue slots a pair (16.042 ms on an NVIDIA H100 80GB HBM3 at 700 W).
//
// The second design: a block of 128 threads owns a pair of 512-atom tiles
// (I, J >= I), the blocks numbered along the triangle; it stages tile J's
// positions (one float4 each) and exclusion ids (j / e0, j / e1: one int2)
// in shared memory, and each thread holds four i atoms of tile I in
// registers (t, t + 128, t + 256, t + 384: a warp's loads stay
// contiguous), so one broadcast shared load of a j atom serves four pairs.
// Padding i slots hold NaN, whose d^2 never passes the cut.  Four i atoms
// a thread ran a few per cent faster on the card than two or eight (to
// retune, edit kRows and rerun scripts/compare_op_designs.py).  Two other
// shapes ran slower there and were dropped: holding the box constants in
// registers by an opaque move (the compiler reloads them from the kernel's
// parameters each pair), and entering the tail once a j atom when any of
// the four pairs passes the cut.  Loops
// stride over blockDim, so a block of any width covers its tiles (the CPU
// rehearsal in scripts/check_kernel_modes.py runs one thread a block).
// Skipping far tiles, as a cell list does, is the cell kernels' job.

#include <cmath>

#include <cuda_runtime.h>

#include "cell_bin.cuh"

namespace {

constexpr int kThreads = 128;            // threads a block
constexpr int kRows = 4;                 // i atoms a thread
constexpr int kTile = kThreads * kRows;  // atoms of a tile (i and j)

// The orthorhombic minimum image of any displacement: OrthoImage<3>'s
// division-free multiple where |delta| <= L, so that fl(delta / L) lies in
// [-1, 1] and the half threshold decides rint exactly, and L * rint(fl(delta
// / L)) as the plain version computes it elsewhere.  The per-pair test costs
// the division's registers and issue slots, so pairs of two atoms in [0, L]
// (|fl(a - c)| <= L) take OrthoImage<3> alone.
struct AnyImage {
  cellbin::OrthoImage<3> image;

  __device__ __forceinline__ float fast_d2(float4 a, float4 c) const {
    const float pa[3] = {a.x, a.y, a.z};
    const float pc[3] = {c.x, c.y, c.z};
    float delta[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float len = image.len[k];
      const float s = __fsub_rn(pa[k], pc[k]);
      const float shift =
          fabsf(s) <= len ? cellbin::image_shift(s, image.half[k], len)
                          : __fmul_rn(len, rintf(__fdiv_rn(s, len)));
      delta[k] = __fsub_rn(s, shift);
    }
    return cellbin::sum_of_fast_squares(delta, 3);
  }

  __device__ __forceinline__ bool holds(float4 a) const {
    return a.x >= 0.0f && a.x <= image.len[0] && a.y >= 0.0f &&
           a.y <= image.len[1] && a.z >= 0.0f && a.z <= image.len[2];
  }
};

// The fast "zero" bin behind the exact cut: a pair with d2 <= d2_max lies
// in bin trunc(sqrt(d2) * inv_dr) < n_bins, any other in none.
struct CutBins {
  float d2_max;
  float inv_dr;

  __device__ __forceinline__ int index(float d2) const {
    return static_cast<int>(__fmul_rn(__fsqrt_rn(d2), inv_dr));
  }
};

// Bins the thread's i atoms `a` (ids i / e0, i / e1) against the staged
// tile under `image`: a diagonal tile counts the ordered pair (i, j), any
// other both orders.
template <bool kExclude, class Image>
__device__ __forceinline__ void count_rows(
    const Image& image, CutBins bins, const float4 (&a)[kRows],
    const int (&id0)[kRows], const int (&id1)[kRows], const float4* sj,
    const int2* ids, int nj, bool diagonal, unsigned int* hist) {
  for (int s = 0; s < nj; ++s) {
    const float4 c = sj[s];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float d2 = image.fast_d2(a[r], c);
      if (d2 <= bins.d2_max) {
        unsigned int w;
        if constexpr (kExclude) {
          const int2 jd = ids[s];  // j / e0, j / e1
          w = (id0[r] != jd.y) + (diagonal ? 0 : (jd.x != id1[r]));
        } else {
          w = diagonal ? 1u : 2u;
        }
        if (w) atomicAdd(&hist[bins.index(d2)], w);
      }
    }
  }
}

template <bool kExclude>
__global__ void __launch_bounds__(kThreads)
pair_histogram_kernel(const float* __restrict__ positions,
                      AnyImage image, CutBins bins,
                      unsigned long long* __restrict__ out, int n_atoms,
                      int n_bins, int e0, int e1) {
  extern __shared__ unsigned char smem[];
  float4* sj = reinterpret_cast<float4*>(smem);
  int2* ids = reinterpret_cast<int2*>(sj + kTile);
  int* tile_outside = reinterpret_cast<int*>(ids + kTile);  // a j atom
  unsigned int* hist = reinterpret_cast<unsigned int*>(tile_outside + 1);

  // Block b is the tile pair (I, J), I <= J, of b = J (J + 1) / 2 + I.
  const long long b = blockIdx.x;
  long long jt = static_cast<long long>(
      (sqrtf(8.0f * static_cast<float>(b) + 1.0f) - 1.0f) * 0.5f);
  while (jt * (jt + 1) / 2 > b) --jt;
  while ((jt + 1) * (jt + 2) / 2 <= b) ++jt;
  const int tile_j = static_cast<int>(jt);
  const int tile_i = static_cast<int>(b - jt * (jt + 1) / 2);
  const bool diagonal = tile_i == tile_j;
  const int i0 = tile_i * kTile;
  const int j0 = tile_j * kTile;
  const int nj = min(kTile, n_atoms - j0);

  if (threadIdx.x == 0) *tile_outside = 0;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) hist[k] = 0u;
  __syncthreads();
  for (int s = threadIdx.x; s < nj; s += blockDim.x) {
    const float* p = positions + 3LL * (j0 + s);
    sj[s] = {p[0], p[1], p[2], 0.0f};
    if (!image.holds(sj[s])) *tile_outside = 1;
    if constexpr (kExclude) ids[s] = {(j0 + s) / e0, (j0 + s) / e1};
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kThreads; t += blockDim.x) {
    float4 a[kRows];
    int id0[kRows], id1[kRows];
    bool inside = !*tile_outside;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + t + r * kThreads;
      if (i < n_atoms) {
        const float* p = positions + 3LL * i;
        a[r] = {p[0], p[1], p[2], 0.0f};
        inside = inside && image.holds(a[r]);
      } else {
        a[r] = {NAN, NAN, NAN, 0.0f};
      }
      id0[r] = kExclude ? i / e0 : 0;
      id1[r] = kExclude ? i / e1 : 0;
    }
    if (inside) {
      count_rows<kExclude>(image.image, bins, a, id0, id1, sj, ids, nj,
                           diagonal, hist);
    } else {
      count_rows<kExclude>(image, bins, a, id0, id1, sj, ids, nj, diagonal,
                           hist);
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    const unsigned int h = hist[k];
    if (h) atomicAdd(&out[k], static_cast<unsigned long long>(h));
  }
}

template <bool kExclude>
int launch(const void* positions, const float* box, CutBins bins, void* out,
           int n_atoms, int n_bins, int e0, int e1, cudaStream_t stream) {
  const size_t smem = kTile * (sizeof(float4) + sizeof(int2)) + sizeof(int) +
                      sizeof(unsigned int) * static_cast<size_t>(n_bins);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pair_histogram_kernel<kExclude>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_tiles = (n_atoms + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned int>(n_tiles * (n_tiles + 1) / 2));
  const AnyImage image{cellbin::OrthoImage<3>::of(box)};
  pair_histogram_kernel<kExclude><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(positions), image, bins,
      static_cast<unsigned long long*>(out), n_atoms, n_bins, e0, e1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `positions` is
// (n_atoms, 3) float32 in the orthorhombic box of lengths box_x, box_y,
// box_z (any coordinates; the minimum image is taken per pair); `out`
// (n_bins,) 64-bit counts, zeroed by the caller; `inv_dr` = f32(n_bins /
// r_max) and `d2_max` the largest float32 d^2 whose bin is below n_bins.
// With `exclude` != 0 the ordered pairs with i / e0 == j / e1 are dropped.
// n_atoms is at least 1.  Returns cudaGetLastError().
extern "C" int pair_histogram_launch(const void* positions, void* out,
                                     int n_atoms, int n_bins, int exclude,
                                     int e0, int e1, float box_x, float box_y,
                                     float box_z, float inv_dr, float d2_max,
                                     void* stream) {
  const float box[3] = {box_x, box_y, box_z};
  const CutBins bins{d2_max, inv_dr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exclude) {
    return launch<true>(positions, box, bins, out, n_atoms, n_bins, e0, e1,
                        s);
  }
  return launch<false>(positions, box, bins, out, n_atoms, n_bins, 1, 1, s);
}
