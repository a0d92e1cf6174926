// Cell-list pair-distance histogram of one group, triclinic boxes: the
// entry points of the _kernel_tri / _kernel_tri_stream modes (one lattice
// translation per block, half shell) and of the tri_pp modes of _kernel /
// _kernel_stream (per-pair 27-image search, ordered) of
// mdhelper_tpu/ops/pallas_cell_histogram.py, every binning policy, with or
// without tile exclusions.  The kernel, what it computes, what bounds it
// and its design: cell_pair_histogram.cuh.

#include <cuda_runtime.h>

#include "cell_pair_histogram.cuh"

// The per-block sweep: as cell_pair_histogram_launch over the 14-entry
// half-shell table, with the slot table of the fractionally folded atoms,
// `images` (n_cells, n_nbr) int32 rows of the shift table for the table's
// entries, and `shift_hi`, `shift_lo` (n_frames, 27, 3) float32, each
// frame's 27 lattice translations as double-floats, in place of `boxes`.
extern "C" int triclinic_cell_pair_histogram_launch(
    const void* table, const void* occupancy, const void* neighbors,
    const void* images, const void* shift_hi, const void* shift_lo,
    void* out, int n_frames, int n_cells, int n_nbr, int capacity,
    int n_bins, int tiles, int asym, const void* side, int fast, int offset,
    float c0, float c1, float c2, float c3, float c4, float c5, float c6,
    float c7, void* stream) {
  const SelfArgs args{table,   occupancy, neighbors, out,   n_frames,
                      n_cells, n_nbr,     capacity,  n_bins, stream};
  const float c[8] = {c0, c1, c2, c3, c4, c5, c6, c7};
  const cellbin::TriclinicBlock geometry{
      static_cast<const int*>(images), static_cast<const float*>(shift_hi),
      static_cast<const float*>(shift_lo), n_nbr};
  return launch_modes<false>(args, geometry, tiles, asym, side, fast, offset,
                             c);
}

// The tri_pp sweep: ordered, over the deduped full table of the folded
// atoms' grid, with `boxes` (n_frames, 18) float32: each frame's box matrix
// and then its float32 inverse, both row-major.
extern "C" int tri_pp_cell_pair_histogram_launch(
    const void* table, const void* occupancy, const void* neighbors,
    const void* boxes, void* out, int n_frames, int n_cells, int n_nbr,
    int capacity, int n_bins, int tiles, int asym, const void* side,
    int fast, int offset, float c0, float c1, float c2, float c3, float c4,
    float c5, float c6, float c7, void* stream) {
  const SelfArgs args{table,   occupancy, neighbors, out,   n_frames,
                      n_cells, n_nbr,     capacity,  n_bins, stream};
  const float c[8] = {c0, c1, c2, c3, c4, c5, c6, c7};
  return launch_modes<true>(
      args, cellbin::Tri27Block{static_cast<const float*>(boxes)}, tiles,
      asym, side, fast, offset, c);
}
