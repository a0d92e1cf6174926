// Cell-list pair-distance histogram between two disjoint groups: the kernel
// template and its launch, shared by the orthorhombic entry point
// (cross_pair_histogram.cu) and the triclinic ones
// (triclinic_cross_pair_histogram.cu), each source its own nvcc process.
//
// Replaces the TPU kernels of mdhelper_tpu/ops/pallas_cell_histogram.py
// launched from cross_pair_histogram_pallas, in every mode:
//   * _cross_kernel (orthorhombic, the resident-table layout) and
//     _cross_kernel_stream (the per-(cell, neighbour) streaming layout that
//     the JAX package picks for slot tables over 12 MB), over the reach-1
//     27-entry table or the deduped full table of a generalized reach-m
//     grid (any box size; the same code, another table): Geometry
//     OrthoBlock, or Ortho2Block on the 2-D `axes` grids;
//   * _cross_kernel_tri and _cross_kernel_tri_stream (triclinic, one lattice
//     translation per block): Geometry TriclinicBlock;
//   * _cross_kernel and _cross_kernel_stream in tri_pp mode (triclinic grids
//     under 3 cells or of reach above 1, over the deduped full table;
//     per-pair 27-candidate minimum image): Geometry Tri27Block;
// each with any binning policy of cell_bin.cuh (bins from 0 or from r_min,
// exact or fast).  One block per (cell, neighbour) with its two slot blocks
// staged in shared memory is already the streaming layout, so each
// instantiation serves both TPU layouts.
//
// What it computes.  For each frame, group-1 home cell c and entry e of c's
// full-shell row, every slot pair (i, j) with i < occ1[c] and
// j < occ2[nbr[c, e]] -- minus the pairs with equal exclusion ids when
// exclusion is on -- gets the bin of cell_bin.cuh (per-pair minimum image,
// the block's lattice translation images[c, e] in a per-block triclinic
// grid, or the per-pair 27-image search of tri_pp) and one count when the
// bin is below n_bins.  No triangle mask and no identical-atom mask: the
// groups are disjoint and every ordered (group-1, group-2) pair is visited
// once (each table holds every ordered cell pair within reach once), so the
// counts are not doubled.
//
// What bounds it on the card: pair math, not bytes.  Each slot pair costs
// the same float32 operations as in the self kernel (cell_bin.cuh: 254
// orthorhombic exact from 0, 245 per-block triclinic, 7,186 tri_pp; other
// policies 15-7,249); without the half shell it sweeps 27 neighbour blocks
// instead of 14, so at equal N it does about twice the self kernel's pairs,
// against a slot-table read of 16 B a slot per block.
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
// persistent blocks are later work.  The exclusion stays a runtime flag; the
// geometry and the binning policy are template parameters.
#pragma once

#include <cuda_runtime.h>

#include "cell_bin.cuh"

namespace {

constexpr int kThreads = 256;

template <class Geometry, class Bins>
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
                            Bins bins) {
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
  const auto binner = bins.prepared(n_bins);

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
    const int idx = binner.index(image, a, c, n_bins);
    if (idx < n_bins) atomicAdd(&hist[idx], 1u);
  }
  __syncthreads();

  unsigned long long* frame_out = out + static_cast<long long>(frame) * n_bins;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const unsigned int h = hist[b];
    if (h) atomicAdd(&frame_out[b], static_cast<unsigned long long>(h));
  }
}

// What every cross launch takes besides its geometry and binning.
struct CrossArgs {
  const void* table1;
  const void* occupancy1;
  const void* table2;
  const void* occupancy2;
  const void* neighbors;
  void* out;
  int n_frames, n_cells, n_nbr, capacity1, capacity2, n_bins, exclude;
  void* stream;
};

template <class Geometry, class Bins>
int launch(const CrossArgs& a, Geometry geometry, Bins bins) {
  const size_t smem =
      sizeof(float4) * (static_cast<size_t>(a.capacity1) + a.capacity2) +
      sizeof(unsigned int) * static_cast<size_t>(a.n_bins);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_pair_histogram_kernel<Geometry, Bins>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>(a.n_cells * a.n_nbr),
                  static_cast<unsigned int>(a.n_frames));
  cross_pair_histogram_kernel<Geometry, Bins>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const float4*>(a.table1),
          static_cast<const int*>(a.occupancy1),
          static_cast<const float4*>(a.table2),
          static_cast<const int*>(a.occupancy2),
          static_cast<const int*>(a.neighbors), geometry,
          static_cast<unsigned long long*>(a.out), a.n_cells, a.n_nbr,
          a.capacity1, a.capacity2, a.n_bins, a.exclude, bins);
  return static_cast<int>(cudaGetLastError());
}

// The launch of the binning policy the runtime flags pick.
template <class Geometry>
int launch_modes(const CrossArgs& a, Geometry geometry, int fast, int offset,
                 const float c[8]) {
  return cellbin::with_bins(fast, offset, c, [&](auto bins) {
    return launch(a, geometry, bins);
  });
}

}  // namespace
