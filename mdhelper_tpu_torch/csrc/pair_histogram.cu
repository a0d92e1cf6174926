// Brute-force pair-distance histogram of one group: the port of
// _hist_kernel, launched from pair_histogram in
// mdhelper_tpu/ops/pallas_kernels.py.
//
// What it computes.  Every ordered pair (i, j) of the n_atoms positions,
// identical atoms included (distance 0, bin 0), unless the exclusion drops
// i / e0 == j / e1 (global indices), is binned on [0, r_max] with the cell
// kernels' fast "zero" policy (cellbin::ZeroFast over OrthoImage<3>::fast_d2:
// each component delta - L rint(delta / L), the multiple decided by the
// half thresholds without a division, squares summed left to right, IEEE
// sqrt, trunc(dist * inv_dr) with inv_dr = f32(n_bins / r_max)), and
// counted when its bin is below n_bins.  The wrapper does not wrap the
// positions: an i atom or a j tile with a coordinate outside [0, L] takes
// AnyImage, whose multiple comes from the division where |delta| > L, so
// any positions give the plain version's integers.  The box is an argument of the
// launch (the JAX kernel bakes it in).  The TPU kernel counts through a
// bf16 one-hot digit contraction into float32; here a shared-memory uint32
// histogram with atomicAdd, flushed once a block into the int64 counts, gives
// the same integers (exact at any count, where float32 is exact below 2^24).
//
// What bounds it on the card: operations.  N^2 pairs of 27 float32
// operations each for positions in the box (cell_bin.cuh: OrthoImage<3>
// fast_d2 23 + the ZeroFast tail 4; the compares of |delta| with L and of
// the exclusion ids are not counted; before the division-free image
// multiple it counted 24, with three IEEE divisions, each a subroutine,
// among them), against 12 N bytes of positions: at 100k atoms 1e10 pairs,
// a 4.0 ms bound.
//
// This first design: a block of 256 threads owns 256 i atoms (one a thread
// on the card) and stages a tile of 2,048 j atoms in shared memory, with
// their exclusion ids j / e1 beside them; every thread of a warp reads the
// same j atom (a broadcast).  Pairs beyond r_max, most of them, are never
// counted; in-range pairs go to the block's histogram.  Loops stride over
// blockDim, so a block of any width covers its tile (the CPU rehearsal in
// scripts/check_kernel_modes.py runs one thread a block).  Skipping far
// tiles, as a cell list does, is the cell kernels' job.

#include <cuda_runtime.h>

#include "cell_bin.cuh"

namespace {

constexpr int kThreads = 256;  // i atoms a block
constexpr int kTileJ = 2048;   // j atoms staged a block

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

// Bins atom a against the staged tile under `image`.
template <bool kExclude, class Image>
__device__ __forceinline__ void count_row(const Image& image,
                                          cellbin::ZeroFast bins, float4 a,
                                          int tile_i, const float4* sj,
                                          const int* tile_j, int nj,
                                          int n_bins, unsigned int* hist) {
  for (int s = 0; s < nj; ++s) {
    if constexpr (kExclude) {
      if (tile_j[s] == tile_i) continue;
    }
    const int idx = bins.index(image, a, sj[s], n_bins);
    if (idx < n_bins) atomicAdd(&hist[idx], 1u);
  }
}

template <bool kExclude>
__global__ void __launch_bounds__(kThreads)
pair_histogram_kernel(const float* __restrict__ positions,
                      AnyImage image, cellbin::ZeroFast bins,
                      unsigned long long* __restrict__ out, int n_atoms,
                      int n_bins, int e0, int e1) {
  extern __shared__ unsigned char smem[];
  float4* sj = reinterpret_cast<float4*>(smem);
  int* tile_j = reinterpret_cast<int*>(sj + kTileJ);
  int* tile_outside = tile_j + kTileJ;  // a staged j atom outside [0, L]
  unsigned int* hist = reinterpret_cast<unsigned int*>(tile_outside + 1);

  const int i0 = blockIdx.x * kThreads;
  const int j0 = blockIdx.y * kTileJ;
  const int nj = min(kTileJ, n_atoms - j0);

  if (threadIdx.x == 0) *tile_outside = 0;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0u;
  __syncthreads();
  for (int s = threadIdx.x; s < nj; s += blockDim.x) {
    const float* p = positions + 3LL * (j0 + s);
    sj[s] = {p[0], p[1], p[2], 0.0f};
    if (!image.holds(sj[s])) *tile_outside = 1;
    if constexpr (kExclude) tile_j[s] = (j0 + s) / e1;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kThreads; t += blockDim.x) {
    const int i = i0 + t;
    if (i >= n_atoms) continue;
    const float* p = positions + 3LL * i;
    const float4 a = {p[0], p[1], p[2], 0.0f};
    const int tile_i = kExclude ? i / e0 : 0;
    if (!*tile_outside && image.holds(a)) {
      count_row<kExclude>(image.image, bins, a, tile_i, sj, tile_j, nj,
                          n_bins, hist);
    } else {
      count_row<kExclude>(image, bins, a, tile_i, sj, tile_j, nj, n_bins,
                          hist);
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const unsigned int h = hist[b];
    if (h) atomicAdd(&out[b], static_cast<unsigned long long>(h));
  }
}

template <bool kExclude>
int launch(const void* positions, const float* box, float inv_dr, void* out,
           int n_atoms, int n_bins, int e0, int e1, cudaStream_t stream) {
  const size_t smem = kTileJ * (sizeof(float4) + sizeof(int)) + sizeof(int) +
                      sizeof(unsigned int) * static_cast<size_t>(n_bins);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pair_histogram_kernel<kExclude>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>((n_atoms + kThreads - 1) / kThreads),
                  static_cast<unsigned int>((n_atoms + kTileJ - 1) / kTileJ));
  const AnyImage image{cellbin::OrthoImage<3>::of(box)};
  pair_histogram_kernel<kExclude><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(positions), image, cellbin::ZeroFast{inv_dr},
      static_cast<unsigned long long*>(out), n_atoms, n_bins, e0, e1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `positions` is
// (n_atoms, 3) float32 in the orthorhombic box of lengths box_x, box_y,
// box_z (any coordinates; the minimum image is taken per pair); `out` (n_bins,) 64-bit counts, zeroed by the caller;
// `inv_dr` = f32(n_bins / r_max).  With `exclude` != 0 the ordered pairs
// with i / e0 == j / e1 are dropped.  n_atoms is at least 1.  Returns
// cudaGetLastError().
extern "C" int pair_histogram_launch(const void* positions, void* out,
                                     int n_atoms, int n_bins, int exclude,
                                     int e0, int e1, float box_x, float box_y,
                                     float box_z, float inv_dr, void* stream) {
  const float box[3] = {box_x, box_y, box_z};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exclude) {
    return launch<true>(positions, box, inv_dr, out, n_atoms, n_bins, e0, e1,
                        s);
  }
  return launch<false>(positions, box, inv_dr, out, n_atoms, n_bins, 1, 1, s);
}
