// Cell-list pair-distance histogram between two disjoint groups, full shell,
// exact: orthorhombic and triclinic boxes.
//
// Replaces the TPU kernels of mdhelper_tpu/ops/pallas_cell_histogram.py
// launched from cross_pair_histogram_pallas, in the modes the cross RDF and
// the Van Hove distinct part use: all three axes, exact double-float
// binning with the "zero" boundary constants, optional (e0, e1) exclusion
// ids.
//   * _cross_kernel (orthorhombic, the resident-table layout) and
//     _cross_kernel_stream (the per-(cell, neighbour) streaming layout that
//     the JAX package picks for slot tables over 12 MB), over the reach-1
//     27-entry table or the deduped full table of a generalized reach-m
//     grid (any box size; the same code, another table):
//     cross_pair_histogram_kernel<OrthoBlock>, entry point
//     cross_pair_histogram_launch;
//   * _cross_kernel_tri and _cross_kernel_tri_stream (triclinic, one lattice
//     translation per block): cross_pair_histogram_kernel<TriclinicBlock>,
//     entry point triclinic_cross_pair_histogram_launch;
//   * _cross_kernel and _cross_kernel_stream in tri_pp mode (triclinic grids
//     under 3 cells or of reach above 1, over the deduped full table;
//     per-pair 27-candidate minimum image, _bin_exact_tri27):
//     cross_pair_histogram_kernel<Tri27Block>, entry point
//     tri_pp_cross_pair_histogram_launch.
// One block per (cell, neighbour) with its two slot blocks staged in shared
// memory is already the streaming layout, so each instantiation serves both
// TPU layouts.
//
// What it computes.  For each frame, group-1 home cell c and entry e of c's
// full-shell row, every slot pair (i, j) with i < occ1[c] and
// j < occ2[nbr[c, e]] -- minus the pairs with equal exclusion ids when
// exclusion is on -- gets the exact bin of cell_bin.cuh (per-pair minimum
// image, the block's lattice translation images[c, e] in a per-block
// triclinic grid, or the per-pair 27-image search of tri_pp) and one count
// when the bin is below n_bins.  No triangle mask and no identical-atom
// mask: the groups are disjoint and every ordered (group-1, group-2) pair
// is visited once (each table holds every ordered cell pair within reach
// once), so the counts are not doubled.
//
// What bounds it on the card: pair math, not bytes.  Each slot pair costs
// the same 254 float32 operations (245 per-block triclinic, 7,186 tri_pp;
// cell_bin.cuh) as in the self kernel; without the half shell it sweeps 27
// neighbour blocks instead of 14, so at equal N it does about twice the
// self kernel's pairs, against a slot-table read of 16 B a slot per block.
//
// This first design mirrors the self kernel: one thread block per (frame,
// home cell, neighbour); the two slot blocks (xyz + exclusion id as a
// float4, 16 B a slot) staged in shared memory; the threads stride over the
// occ1 * occ2 real pairs only; counts go to a shared-memory uint32
// histogram with atomicAdd (a block counts at most cap1 * cap2 pairs, so
// uint32 cannot overflow) and are flushed once per block into the global
// (B, n_bins) 64-bit counts.  The TPU's bf16 one-hot digit contraction
// (no fast scatter there) is replaced by the shared-memory atomics, with the
// same integer counts.  wgmma, TMA, warp-privatised histograms and
// persistent blocks are later work.

#include <cuda_runtime.h>

#include "cell_bin.cuh"

namespace {

constexpr int kThreads = 256;

using cellbin::OrthoBlock;
using cellbin::Tri27Block;
using cellbin::TriclinicBlock;

template <class Geometry>
__global__ void __launch_bounds__(kThreads)
cross_pair_histogram_kernel(const float4* __restrict__ table1,
                            const int* __restrict__ occupancy1,
                            const float4* __restrict__ table2,
                            const int* __restrict__ occupancy2,
                            const int* __restrict__ neighbors,
                            Geometry geometry,
                            unsigned long long* __restrict__ out,
                            int n_cells, int n_nbr, int capacity1,
                            int capacity2, int n_bins, int exclude,
                            float inv_dr, float dr2_hi, float dr2_lo) {
  extern __shared__ unsigned char smem[];
  float4* si = reinterpret_cast<float4*>(smem);
  float4* sj = si + capacity1;
  unsigned int* hist = reinterpret_cast<unsigned int*>(sj + capacity2);

  const int frame = blockIdx.y;
  const int home = blockIdx.x / n_nbr;
  const int entry = blockIdx.x % n_nbr;
  const int other = neighbors[home * n_nbr + entry];

  const long long frame_cells = static_cast<long long>(frame) * n_cells;
  const int oi = min(occupancy1[frame_cells + home], capacity1);
  const int oj = min(occupancy2[frame_cells + other], capacity2);
  // Uniform across the block, and before any barrier: an empty cell on
  // either side contributes nothing.
  if (oi == 0 || oj == 0) return;
  const float4* block1 = table1 + (frame_cells + home) * capacity1;
  const float4* block2 = table2 + (frame_cells + other) * capacity2;
  const auto image = geometry.at(frame, home, entry);

  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0u;
  for (int s = threadIdx.x; s < oi; s += blockDim.x) si[s] = block1[s];
  for (int s = threadIdx.x; s < oj; s += blockDim.x) sj[s] = block2[s];
  __syncthreads();

  // The wrapper bounds capacity1 * capacity2 below 2^31.
  const int n_pairs = oi * oj;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int i = p / oj;
    const int j = p - i * oj;
    const float4 a = si[i];
    const float4 c = sj[j];
    // Exclusion ids (index // e0, index // e1) are exact float32 integers.
    if (exclude && a.w == c.w) continue;
    const int idx =
        cellbin::exact_bin(a, c, image, n_bins, inv_dr, dr2_hi, dr2_lo);
    if (idx < n_bins) atomicAdd(&hist[idx], 1u);
  }
  __syncthreads();

  unsigned long long* frame_out = out + static_cast<long long>(frame) * n_bins;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const unsigned int h = hist[b];
    if (h) atomicAdd(&frame_out[b], static_cast<unsigned long long>(h));
  }
}

template <class Geometry>
int launch(const void* table1, const void* occupancy1, const void* table2,
           const void* occupancy2, const void* neighbors, Geometry geometry,
           void* out, int n_frames, int n_cells, int n_nbr, int capacity1,
           int capacity2, int n_bins, int exclude, float inv_dr,
           float dr2_hi, float dr2_lo, void* stream) {
  const size_t smem =
      sizeof(float4) * (static_cast<size_t>(capacity1) + capacity2) +
      sizeof(unsigned int) * static_cast<size_t>(n_bins);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_pair_histogram_kernel<Geometry>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>(n_cells * n_nbr),
                  static_cast<unsigned int>(n_frames));
  cross_pair_histogram_kernel<Geometry><<<grid, kThreads, smem,
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table1),
      static_cast<const int*>(occupancy1),
      static_cast<const float4*>(table2),
      static_cast<const int*>(occupancy2),
      static_cast<const int*>(neighbors), geometry,
      static_cast<unsigned long long*>(out), n_cells, n_nbr, capacity1,
      capacity2, n_bins, exclude, inv_dr, dr2_hi, dr2_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `table1` and
// `table2` are the (n_frames, n_cells * capacity{1,2}, 4) float32 slot
// tables of the two groups on one grid (xyz, exclusion id), `occupancy1`
// and `occupancy2` (n_frames, n_cells) int32, `neighbors` (n_cells, n_nbr)
// int32 full-shell table (reach-1 or deduped), `boxes` (n_frames, 3)
// float32, `out` (n_frames, n_bins) 64-bit counts, zeroed by the caller;
// `exclude` != 0 drops pairs with equal ids.  Returns cudaGetLastError().
extern "C" int cross_pair_histogram_launch(
    const void* table1, const void* occupancy1, const void* table2,
    const void* occupancy2, const void* neighbors, const void* boxes,
    void* out, int n_frames, int n_cells, int n_nbr, int capacity1,
    int capacity2, int n_bins, int exclude, float inv_dr, float dr2_hi,
    float dr2_lo, void* stream) {
  return launch(table1, occupancy1, table2, occupancy2, neighbors,
                OrthoBlock{static_cast<const float*>(boxes)}, out, n_frames,
                n_cells, n_nbr, capacity1, capacity2, n_bins, exclude,
                inv_dr, dr2_hi, dr2_lo, stream);
}

// The triclinic sweep: as cross_pair_histogram_launch, with the slot tables
// of the fractionally folded atoms, `images` (n_cells, n_nbr) int32 rows of
// the shift table for the full-shell table's entries, and `shift_hi`,
// `shift_lo` (n_frames, 27, 3) float32, each frame's 27 lattice
// translations as double-floats, in place of `boxes`.
extern "C" int triclinic_cross_pair_histogram_launch(
    const void* table1, const void* occupancy1, const void* table2,
    const void* occupancy2, const void* neighbors, const void* images,
    const void* shift_hi, const void* shift_lo, void* out, int n_frames,
    int n_cells, int n_nbr, int capacity1, int capacity2, int n_bins,
    int exclude, float inv_dr, float dr2_hi, float dr2_lo, void* stream) {
  const TriclinicBlock geometry{static_cast<const int*>(images),
                                static_cast<const float*>(shift_hi),
                                static_cast<const float*>(shift_lo), n_nbr};
  return launch(table1, occupancy1, table2, occupancy2, neighbors, geometry,
                out, n_frames, n_cells, n_nbr, capacity1, capacity2, n_bins,
                exclude, inv_dr, dr2_hi, dr2_lo, stream);
}

// The tri_pp sweep: as cross_pair_histogram_launch over the deduped full
// table of the folded atoms' grid, with `boxes` (n_frames, 18) float32:
// each frame's box matrix and then its float32 inverse, both row-major.
extern "C" int tri_pp_cross_pair_histogram_launch(
    const void* table1, const void* occupancy1, const void* table2,
    const void* occupancy2, const void* neighbors, const void* boxes,
    void* out, int n_frames, int n_cells, int n_nbr, int capacity1,
    int capacity2, int n_bins, int exclude, float inv_dr, float dr2_hi,
    float dr2_lo, void* stream) {
  return launch(table1, occupancy1, table2, occupancy2, neighbors,
                Tri27Block{static_cast<const float*>(boxes)}, out, n_frames,
                n_cells, n_nbr, capacity1, capacity2, n_bins, exclude,
                inv_dr, dr2_hi, dr2_lo, stream);
}
