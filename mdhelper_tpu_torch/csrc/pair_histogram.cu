// Brute-force pair-distance histogram of one group: the port of
// _hist_kernel, launched from pair_histogram in
// mdhelper_tpu/ops/pallas_kernels.py.
//
// What it computes.  Every ordered pair (i, j) of the n_atoms positions,
// identical atoms included (distance 0, bin 0), unless the exclusion drops
// i / e0 == j / e1 (global indices), is binned on [0, r_max] with the cell
// kernels' fast "zero" policy (cellbin::ZeroFast over OrthoImage::fast_d2:
// each component delta - L rint(delta / L), squares summed left to right,
// IEEE sqrt, trunc(dist * inv_dr) with inv_dr = f32(n_bins / r_max)), and
// counted when its bin is below n_bins.  The box is an argument of the
// launch (the JAX kernel bakes it in).  The TPU kernel counts through a
// bf16 one-hot digit contraction into float32; here a shared-memory uint32
// histogram with atomicAdd, flushed once a block into the int64 counts, gives
// the same integers (exact at any count, where float32 is exact below 2^24).
//
// What bounds it on the card: operations.  N^2 pairs of 24 float32
// operations each (cell_bin.cuh: OrthoImage fast_d2 20 + the ZeroFast tail
// 4; the compare of the exclusion ids is not counted), against 12 N bytes of
// positions: at 100k atoms 1e10 pairs, a 3.6 ms bound.
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

template <bool kExclude>
__global__ void __launch_bounds__(kThreads)
pair_histogram_kernel(const float* __restrict__ positions,
                      cellbin::OrthoImage image, cellbin::ZeroFast bins,
                      unsigned long long* __restrict__ out, int n_atoms,
                      int n_bins, int e0, int e1) {
  extern __shared__ unsigned char smem[];
  float4* sj = reinterpret_cast<float4*>(smem);
  int* tile_j = reinterpret_cast<int*>(sj + kTileJ);
  unsigned int* hist = reinterpret_cast<unsigned int*>(tile_j + kTileJ);

  const int i0 = blockIdx.x * kThreads;
  const int j0 = blockIdx.y * kTileJ;
  const int nj = min(kTileJ, n_atoms - j0);

  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0u;
  for (int s = threadIdx.x; s < nj; s += blockDim.x) {
    const float* p = positions + 3LL * (j0 + s);
    sj[s] = {p[0], p[1], p[2], 0.0f};
    if constexpr (kExclude) tile_j[s] = (j0 + s) / e1;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kThreads; t += blockDim.x) {
    const int i = i0 + t;
    if (i >= n_atoms) continue;
    const float* p = positions + 3LL * i;
    const float4 a = {p[0], p[1], p[2], 0.0f};
    const int tile_i = kExclude ? i / e0 : 0;
    for (int s = 0; s < nj; ++s) {
      if constexpr (kExclude) {
        if (tile_j[s] == tile_i) continue;
      }
      const int idx = bins.index(image, a, sj[s], n_bins);
      if (idx < n_bins) atomicAdd(&hist[idx], 1u);
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
  const size_t smem = kTileJ * (sizeof(float4) + sizeof(int)) +
                      sizeof(unsigned int) * static_cast<size_t>(n_bins);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pair_histogram_kernel<kExclude>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>((n_atoms + kThreads - 1) / kThreads),
                  static_cast<unsigned int>((n_atoms + kTileJ - 1) / kTileJ));
  const cellbin::OrthoImage image{{box[0], box[1], box[2]}};
  pair_histogram_kernel<kExclude><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(positions), image, cellbin::ZeroFast{inv_dr},
      static_cast<unsigned long long*>(out), n_atoms, n_bins, e0, e1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `positions` is
// (n_atoms, 3) float32, wrapped into the orthorhombic box of lengths
// box_x, box_y, box_z; `out` (n_bins,) 64-bit counts, zeroed by the caller;
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
