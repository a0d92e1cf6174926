// Cell-list pair-distance histogram of one group: the launch of the shared
// sweep (cell_sweep.cuh) as a self sweep, used by the orthorhombic entry
// points (cell_pair_histogram.cu) and the triclinic ones
// (triclinic_cell_pair_histogram.cu), each source its own nvcc process.
//
// Replaces the TPU kernels of mdhelper_tpu/ops/pallas_cell_histogram.py
// launched from cell_pair_histogram_pallas, in every mode:
//   * _kernel (orthorhombic; per-pair minimum image, _bin_exact or
//     _bin_fast), and its streaming twin _kernel_stream: Geometry
//     OrthoBlock<3> (three axes) or OrthoBlock<2> (the 2-D `axes` grids),
//     over a half-shell table -- the reach-1 14-entry table, or the deduped
//     half table of a generalized reach-m grid -- and, in ordered mode (a
//     small box whose grid has no half table), over the deduped full table;
//   * _kernel_tri (triclinic; one lattice translation per (cell, neighbour)
//     block, _bin_exact_shift / _bin_fast_shift), and its streaming twin
//     _kernel_tri_stream: Geometry TriclinicBlock, half shell;
//   * _kernel and _kernel_stream in tri_pp mode (triclinic grids under 3
//     cells or of reach above 1; per-pair 27-candidate minimum image,
//     _bin_exact_tri27 / _bin_fast_tri27; always ordered): Geometry
//     Tri27Block.
// Each with any binning policy of cell_bin.cuh (bins from 0 or from r_min,
// exact or fast) and with or without the tile exclusion (the _ROW_EX_I /
// _ROW_EX_J id rows, the exclude mask and _asym_weights).  The sweep streams
// the neighbour slots through shared memory whatever the table's size, so
// each instantiation serves both TPU layouts.
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
// tile needs each atom's second id i // e1 too, from a side table that only
// the asymmetric launches copy beside the slots: the ordered sweep drops
// i // e0 == j // e1, and the half shell counts each unordered pair {a, b}
// with its ordered multiplicity [a // e0 != b // e1] + [b // e0 != a // e1]
// (0, 1 or 2; the wrapper does not double these counts).  Either way the
// wrapper adds back the identical pairs the tile keeps (i // e0 != i // e1,
// distance 0) into bin 0.
//
// What bounds it on the card: the instruction issue rate, not bytes.  At
// the fused path's plan (100k atoms, 8x8x8 cells, capacity 256) a frame
// visits about 263M occupied slot pairs, of which about 36M lie in range,
// against about 8 MB of slot table.  The kernels are built with
// --fmad=false (the double-float error terms depend on separate
// roundings), so each operation is mostly one instruction: an SM issues at
// most 128 a clock, about 33.5 T a second on 132 SMs -- half the 67 TFLOP/s
// peak, which counts an FMA as two.  The first design spent about 320
// instructions on every visited pair (254 counted operations, three IEEE
// division subroutines, an integer division, a shared atomic) and ran near
// that issue rate.
//
// This design (the second; the first staged both slot blocks of one
// (cell, neighbour) pair a block, divided an integer a pair to find (i, j)
// and flushed a shared histogram per (cell, neighbour)) cuts the
// instructions a visited pair: cell_bin.cuh's FMA error term, division-free
// image multiple and float32 screen leave the double-float d^2 to the pairs
// near or inside r_max (and a tri_pp pair only the candidate images the
// screen keeps); cell_sweep.cuh skips the home rows that cannot reach a
// neighbour tile's bounding box, queues the screened pairs so that the
// exact path runs with full warps, and walks a (frame, cell, 64 home slots)
// work item's whole neighbour row through an asynchronous ring of 256-slot
// tiles, with warp-private histograms flushed once a work item and no lane
// idle on the home block's triangle.  What is left is the screen loop over
// every visited pair -- about 65 SASS instructions an iteration, of which
// about 23 are the screen's arithmetic (scripts/compare_sass.py --loops) --
// and the pairs the cell grid makes it visit, seven for each pair in range
// at that plan.  Finer sub-cells, persistent blocks and thread-block
// clusters sharing a neighbour tile are later work.
//
// Instantiations: only what changes the inner loop is a template parameter
// -- the geometry, the sweep's order, the binning policy and whether a tile
// exclusion is on; whether that tile is asymmetric is a runtime flag.
#pragma once

#include <cuda_runtime.h>

#include "cell_sweep.cuh"

namespace {

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
int launch(const SelfArgs& a, const void* side, Geometry geometry, Bins bins,
           TileMask tiles) {
  const cellsweep::SweepArgs sweep{
      a.table,    a.occupancy, side,       a.table,    a.occupancy,
      side,       a.neighbors, a.out,      a.n_frames, a.n_cells,
      a.n_nbr,    a.capacity,  a.capacity, a.n_bins,   a.stream};
  if constexpr (kOrdered) {
    return cellsweep::launch_sweep(sweep, geometry, bins,
                                   cellsweep::OrderedPairs<TileMask>{tiles});
  } else {
    return cellsweep::launch_sweep(
        sweep, geometry, bins, cellsweep::HalfShellPairs<TileMask>{tiles});
  }
}

// The launch of the instantiation the runtime flags pick: the tile flag
// (with the asymmetric flag and the side table), the fast and offset flags
// and the convention's 8 constants (cellbin::with_bins).
template <bool kOrdered, class Geometry>
int launch_modes(const SelfArgs& a, Geometry geometry, int tiles, int asym,
                 const void* side, int fast, int offset, const float c[8]) {
  return cellbin::with_bins(fast, offset, c, [&](auto bins) {
    if (tiles) {
      return launch<kOrdered>(a, side, geometry, bins,
                              cellsweep::Tiles{asym});
    }
    return launch<kOrdered>(a, nullptr, geometry, bins,
                            cellsweep::NoTiles{0});
  });
}

}  // namespace
