// Cell-list pair-distance histogram between two groups: the launch of the
// shared sweep (cell_sweep.cuh) as a cross sweep, used by the orthorhombic
// entry point (cross_pair_histogram.cu) and the triclinic ones
// (triclinic_cross_pair_histogram.cu), each source its own nvcc process.
//
// Replaces the TPU kernels of mdhelper_tpu/ops/pallas_cell_histogram.py
// launched from cross_pair_histogram_pallas, in every mode:
//   * _cross_kernel (orthorhombic, the resident-table layout) and
//     _cross_kernel_stream (the per-(cell, neighbour) streaming layout that
//     the JAX package picks for slot tables over 12 MB), over the reach-1
//     27-entry table or the deduped full table of a generalized reach-m
//     grid (any box size; the same code, another table): Geometry
//     OrthoBlock<3>, or OrthoBlock<2> on the 2-D `axes` grids;
//   * _cross_kernel_tri and _cross_kernel_tri_stream (triclinic, one lattice
//     translation per block): Geometry TriclinicBlock;
//   * _cross_kernel and _cross_kernel_stream in tri_pp mode (triclinic grids
//     under 3 cells or of reach above 1, over the deduped full table;
//     per-pair 27-candidate minimum image): Geometry Tri27Block;
// each with any binning policy of cell_bin.cuh (bins from 0 or from r_min,
// exact or fast).  The sweep streams the neighbour slots through shared
// memory whatever the table's size, so each instantiation serves both TPU
// layouts.
//
// What it computes.  For each frame, group-1 home cell c and entry e of c's
// full-shell row, every slot pair (i, j) with i < occ1[c] and
// j < occ2[nbr[c, e]] -- minus the pairs with equal exclusion ids when
// exclusion is on -- gets the bin of cell_bin.cuh (per-pair minimum image,
// the block's lattice translation images[c, e] in a per-block triclinic
// grid, or the per-pair 27-image search of tri_pp) and one count when the
// bin is below n_bins.  No triangle mask and no identical-atom mask: every
// ordered (group-1, group-2) pair is visited once (each table holds every
// ordered cell pair within reach once), so the counts are not doubled, and
// an atom in both groups of overlapping groups meets itself at distance 0,
// in bin 0, as in the JAX package's brute sweep (or is dropped by its equal
// exclusion ids).
//
// What bounds it on the card: the instruction issue rate, not bytes
// (cell_pair_histogram.cuh says what the issue rate is and where the
// instructions go).  Without the half shell it sweeps 27 neighbour blocks
// instead of 14, so at equal N it visits about twice the self kernel's
// pairs, against a slot-table read of 16 B a slot.
//
// This design (the second) is the self kernel's: the screened per-pair
// arithmetic of cell_bin.cuh and the work items of cell_sweep.cuh -- (frame,
// group-1 cell, 64 of its slots), its whole row of group-2 cells streamed
// through an asynchronous ring of 256-slot tiles, rows that cannot reach a
// tile skipped, screened pairs queued for full-warp exact binning,
// warp-private histograms flushed once a work item.  The first design ran
// one block per (cell, neighbour) pair, staging the home block again for
// each of the 27 entries, dividing an integer a pair and flushing up to
// n_bins 64-bit global atomics a block.  The exclusion stays a runtime flag;
// the geometry and the binning policy are template parameters.
#pragma once

#include <cuda_runtime.h>

#include "cell_sweep.cuh"

namespace {

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

// The launch of the binning policy the runtime flags pick.
template <class Geometry>
int launch_modes(const CrossArgs& a, Geometry geometry, int fast, int offset,
                 const float c[8]) {
  const cellsweep::SweepArgs sweep{
      a.table1,    a.occupancy1, nullptr,  a.table2,    a.occupancy2,
      nullptr,     a.neighbors,  a.out,    a.n_frames,  a.n_cells,
      a.n_nbr,     a.capacity1,  a.capacity2, a.n_bins, a.stream};
  return cellbin::with_bins(fast, offset, c, [&](auto bins) {
    return cellsweep::launch_sweep(sweep, geometry, bins,
                                   cellsweep::CrossPairs{a.exclude});
  });
}

}  // namespace
