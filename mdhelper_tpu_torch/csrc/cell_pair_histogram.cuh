// Cell-list pair-distance histogram of one group: the kernel template and
// its launch, shared by the orthorhombic entry points
// (cell_pair_histogram.cu) and the triclinic ones
// (triclinic_cell_pair_histogram.cu), each source its own nvcc process.
//
// Replaces the TPU kernels of mdhelper_tpu/ops/pallas_cell_histogram.py
// launched from cell_pair_histogram_pallas, in every mode:
//   * _kernel (orthorhombic; per-pair minimum image, _bin_exact or
//     _bin_fast), and its streaming twin _kernel_stream: Geometry
//     OrthoBlock (three axes) or Ortho2Block (the 2-D `axes` grids), over a
//     half-shell table -- the reach-1 14-entry table, or the deduped half
//     table of a generalized reach-m grid -- and, in ordered mode (a small
//     box whose grid has no half table), over the deduped full table;
//   * _kernel_tri (triclinic; one lattice translation per (cell, neighbour)
//     block, _bin_exact_shift / _bin_fast_shift), and its streaming twin
//     _kernel_tri_stream: Geometry TriclinicBlock, half shell;
//   * _kernel and _kernel_stream in tri_pp mode (triclinic grids under 3
//     cells or of reach above 1; per-pair 27-candidate minimum image,
//     _bin_exact_tri27 / _bin_fast_tri27; always ordered): Geometry
//     Tri27Block.
// Each with any binning policy of cell_bin.cuh (bins from 0 or from r_min,
// exact or fast) and with or without the tile exclusion (the _ROW_EX_I /
// _ROW_EX_J id rows, the exclude mask and _asym_weights).  One block per
// (cell, neighbour) with both slot blocks staged in shared memory is already
// the streaming layout, so each instantiation serves both TPU layouts.
//
// What it computes.  For each frame, home cell c and entry nb of c's
// neighbour row (entry 0 is c itself), every slot pair (i, j) with
// i < occ[c], j < occ[nbr] -- in the home block, i < j in a half-shell
// sweep, and distinct atom ids (column 3) in an ordered one -- gets the bin
// of cell_bin.cuh and one count when the bin is below n_bins.  A half-shell
// table holds every unordered cell pair once, so the wrapper doubles those
// counts; an ordered (deduped full) table holds every ordered cell pair
// once, and its counts are not doubled.  In a triclinic grid the atoms are
// folded into the primary cell and assigned cells in fractional coordinates
// by the wrapper; the per-block mode's image row (images[c, nb]) picks the
// frame's double-float translation that moves the neighbour's atoms next to
// the home cell -- the minimum image of every pair within r_max while each
// cell is at least r_max wide along every lattice direction, which the
// wrapper checks per frame (NaN otherwise) -- and tri_pp searches the 27
// images of each pair.
//
// Tile exclusions (Tiles): column 3 holds the tile id i // e0 instead of the
// atom index.  A symmetric (e, e) tile drops pairs of equal ids: on the half
// shell beside the home block's triangle, in an ordered sweep beside the
// identical-atom drop (slot i == j of the home block: a tile id cannot tell
// atoms apart; equal atoms have equal ids anyway).  An asymmetric (e0, e1)
// tile needs each atom's second id i // e1 too, from a side table staged
// beside the slot blocks only by the asymmetric launches (the others keep
// 16-byte slots): the ordered sweep drops i // e0 == j // e1, and the half
// shell counts each unordered pair {a, b} with its ordered multiplicity
// [a // e0 != b // e1] + [b // e0 != a // e1] (0, 1 or 2; the wrapper does
// not double these counts).  Either way the wrapper adds back the identical
// pairs the tile keeps (i // e0 != i // e1, distance 0) into bin 0.
//
// What bounds it on the card: pair math, not bytes.  At the fused path's
// plan (100k atoms, 8x8x8 cells, capacity 256) a frame bins about 263M
// occupied slot pairs, each 254 float32 operations (cell_bin.cuh counts
// every policy: 17-510 fast, 191-7,249 exact), against about 8 MB of slot
// table read per frame.
//
// This first design: one thread block per (frame, home cell, neighbor):
// 7,168 blocks per frame at that plan, enough to fill 132 SMs.  The two
// slot blocks (xyz + id, 16 B a slot; 20 with the second ids of an
// asymmetric tile) are staged in shared memory; the threads stride over the
// occ_i * occ_j real pairs only (padding slots are never computed); counts
// go to a shared-memory uint32 histogram with atomicAdd (a block adds at
// most 2 * cap * cap) and are flushed once per block into the global
// (B, n_bins) 64-bit counts.  The TPU's bf16 one-hot "digit contraction"
// (with the asymmetric weights riding its coarse one-hot) exists only
// because the TPU has no fast scatter; the shared-memory atomics replace it
// and give the same integer counts.  Warp-level histogram privatisation,
// persistent blocks and tighter capacities are later work.
//
// Instantiations: only what changes the inner loop is a template parameter
// -- the geometry, the sweep's order, the binning policy and whether a tile
// exclusion is on; whether that tile is asymmetric is a runtime flag.
#pragma once

#include <cuda_runtime.h>

#include "cell_bin.cuh"

namespace {

constexpr int kThreads = 256;

// No tile exclusion: the kernel's code is the one it had before tiles.
struct NoTiles {
  static constexpr bool kEnabled = false;
};

// A tile exclusion: ids in column 3; with `asym`, second ids in `side`
// ((n_frames, n_cells * capacity) float32, the slot table's order).
struct Tiles {
  static constexpr bool kEnabled = true;
  const float* side;
  int asym;
};

template <class Geometry, bool kOrdered, class Bins, class TileMask>
__global__ void __launch_bounds__(kThreads)
cell_pair_histogram_kernel(const float4* __restrict__ table,
                           const int* __restrict__ occupancy,
                           const int* __restrict__ neighbors,
                           Geometry geometry,
                           unsigned long long* __restrict__ out,
                           int n_cells, int n_nbr, int capacity, int n_bins,
                           Bins bins, TileMask tiles) {
  extern __shared__ unsigned char smem[];
  float4* si = reinterpret_cast<float4*>(smem);
  float4* sj = si + capacity;
  unsigned int* hist = reinterpret_cast<unsigned int*>(sj + capacity);

  const int frame = blockIdx.y;
  const int home = blockIdx.x / n_nbr;
  const int entry = blockIdx.x % n_nbr;
  const int other = neighbors[home * n_nbr + entry];
  const bool self_block = entry == 0;

  const int* occ = occupancy + static_cast<long long>(frame) * n_cells;
  const int oi = min(occ[home], capacity);
  const int oj = min(occ[other], capacity);
  const float4* frame_table =
      table + static_cast<long long>(frame) * n_cells * capacity;
  const auto image = geometry.at(frame, home, entry);
  const auto binner = bins.prepared(n_bins);

  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0u;
  for (int s = threadIdx.x; s < oi; s += blockDim.x)
    si[s] = frame_table[static_cast<long long>(home) * capacity + s];
  for (int s = threadIdx.x; s < oj; s += blockDim.x)
    sj[s] = frame_table[static_cast<long long>(other) * capacity + s];
  // The asymmetric tiles' second ids, after the histogram.
  float* ti = reinterpret_cast<float*>(hist + n_bins);
  float* tj = ti + capacity;
  if constexpr (TileMask::kEnabled) {
    if (tiles.asym) {
      const float* side =
          tiles.side + static_cast<long long>(frame) * n_cells * capacity;
      for (int s = threadIdx.x; s < oi; s += blockDim.x)
        ti[s] = side[static_cast<long long>(home) * capacity + s];
      for (int s = threadIdx.x; s < oj; s += blockDim.x)
        tj[s] = side[static_cast<long long>(other) * capacity + s];
    }
  }
  __syncthreads();

  // The wrapper bounds capacity * capacity below 2^31.
  const int n_pairs = oi * oj;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int i = p / oj;
    const int j = p - i * oj;
    unsigned int weight = 1u;
    int idx;
    if constexpr (TileMask::kEnabled) {
      const float4 a = si[i];
      const float4 c = sj[j];
      if constexpr (kOrdered) {
        // Identical atoms (slot i == j of the home block), then the
        // ordered tile mask i // e0 != j // e1.
        if (self_block && i == j) continue;
        if (a.w == (tiles.asym ? tj[j] : c.w)) continue;
      } else {
        // Home block: strict upper slot triangle (drops identical atoms).
        if (self_block && i >= j) continue;
        if (tiles.asym) {
          // The unordered pair's ordered multiplicity (_asym_weights).
          weight = static_cast<unsigned int>(a.w != tj[j]) +
                   static_cast<unsigned int>(c.w != ti[i]);
          if (weight == 0u) continue;
        } else if (a.w == c.w) {
          continue;
        }
      }
      idx = binner.index(image, a, c, n_bins);
    } else if constexpr (kOrdered) {
      const float4 a = si[i];
      const float4 c = sj[j];
      // Home block: drop identical atoms by their id (the atom index;
      // the deduped table holds the home cell in entry 0 only).
      if (self_block && a.w == c.w) continue;
      idx = binner.index(image, a, c, n_bins);
    } else {
      // Home block: strict upper slot triangle (drops identical atoms too).
      if (self_block && i >= j) continue;
      idx = binner.index(image, si[i], sj[j], n_bins);
    }
    if (idx < n_bins) atomicAdd(&hist[idx], weight);
  }
  __syncthreads();

  unsigned long long* frame_out = out + static_cast<long long>(frame) * n_bins;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const unsigned int h = hist[b];
    if (h) atomicAdd(&frame_out[b], static_cast<unsigned long long>(h));
  }
}

// What every self launch takes besides its geometry and policies.
struct SelfArgs {
  const void* table;
  const void* occupancy;
  const void* neighbors;
  void* out;
  int n_frames, n_cells, n_nbr, capacity, n_bins;
  void* stream;
};

template <bool kOrdered, class Geometry, class Bins, class TileMask>
int launch(const SelfArgs& a, Geometry geometry, Bins bins, TileMask tiles) {
  size_t smem = 2 * sizeof(float4) * static_cast<size_t>(a.capacity) +
                sizeof(unsigned int) * static_cast<size_t>(a.n_bins);
  if constexpr (TileMask::kEnabled) {
    if (tiles.asym) smem += 2 * sizeof(float) * static_cast<size_t>(a.capacity);
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cell_pair_histogram_kernel<Geometry, kOrdered, Bins, TileMask>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>(a.n_cells * a.n_nbr),
                  static_cast<unsigned int>(a.n_frames));
  cell_pair_histogram_kernel<Geometry, kOrdered, Bins, TileMask>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const float4*>(a.table),
          static_cast<const int*>(a.occupancy),
          static_cast<const int*>(a.neighbors), geometry,
          static_cast<unsigned long long*>(a.out), a.n_cells, a.n_nbr,
          a.capacity, a.n_bins, bins, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The launch of the instantiation the runtime flags pick: the tile flag
// (with the asymmetric flag and the side table), the fast and offset flags
// and the convention's 8 constants (cellbin::with_bins).
template <bool kOrdered, class Geometry>
int launch_modes(const SelfArgs& a, Geometry geometry, int tiles, int asym,
                 const void* side, int fast, int offset, const float c[8]) {
  return cellbin::with_bins(fast, offset, c, [&](auto bins) {
    if (tiles) {
      return launch<kOrdered>(a, geometry, bins,
                              Tiles{static_cast<const float*>(side), asym});
    }
    return launch<kOrdered>(a, geometry, bins, NoTiles{});
  });
}

}  // namespace
