// Cell-list pair-distance histogram of one group, orthorhombic boxes: the
// entry point of the _kernel / _kernel_stream modes of
// mdhelper_tpu/ops/pallas_cell_histogram.py (cell_pair_histogram_pallas)
// on 3-D and 2-D grids, half-shell and ordered sweeps, every binning
// policy, with or without tile exclusions.  The kernel, what it computes,
// what bounds it and its design: cell_pair_histogram.cuh.

#include <cuda_runtime.h>

#include "cell_pair_histogram.cuh"

// Launch on `stream` (a cudaStream_t passed as a pointer).  `table` is the
// (n_frames, n_cells * capacity, 4) float32 slot table (xyz -- a 2-D grid's
// two kept coordinates first -- and the atom id, or the tile id i // e0),
// `occupancy` (n_frames, n_cells) int32, `neighbors` (n_cells, n_nbr) int32
// neighbour table with the home cell in column 0 -- a half-shell table, or
// with `ordered` != 0 a deduped full table -- `boxes` (n_frames, 3) float32
// in the table's coordinate order, `out` (n_frames, n_bins) 64-bit counts,
// zeroed by the caller.  `n_axes` (2 or 3) distance components are summed.
// `tiles` != 0 turns the tile exclusion on, `asym` != 0 makes it asymmetric
// with the second ids in `side` ((n_frames, n_cells * capacity) float32).
// `fast`, `offset` and the 8 constants `c0`..`c7` pick the binning
// (cellbin::with_bins).  Returns cudaGetLastError().
extern "C" int cell_pair_histogram_launch(
    const void* table, const void* occupancy, const void* neighbors,
    const void* boxes, void* out, int n_frames, int n_cells, int n_nbr,
    int capacity, int n_bins, int ordered, int n_axes, int tiles, int asym,
    const void* side, int fast, int offset, float c0, float c1, float c2,
    float c3, float c4, float c5, float c6, float c7, void* stream) {
  const SelfArgs args{table,   occupancy, neighbors, out,   n_frames,
                      n_cells, n_nbr,     capacity,  n_bins, stream};
  const float c[8] = {c0, c1, c2, c3, c4, c5, c6, c7};
  const float* lengths = static_cast<const float*>(boxes);
  if (n_axes == 2) {
    const cellbin::OrthoBlock<2> geometry{lengths};
    if (ordered) {
      return launch_modes<true>(args, geometry, tiles, asym, side, fast,
                                offset, c);
    }
    return launch_modes<false>(args, geometry, tiles, asym, side, fast,
                               offset, c);
  }
  const cellbin::OrthoBlock<3> geometry{lengths};
  if (ordered) {
    return launch_modes<true>(args, geometry, tiles, asym, side, fast, offset,
                              c);
  }
  return launch_modes<false>(args, geometry, tiles, asym, side, fast, offset,
                             c);
}
