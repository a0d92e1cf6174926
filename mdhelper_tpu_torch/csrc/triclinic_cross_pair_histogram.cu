// Cell-list pair-distance histogram between two groups, triclinic
// boxes: the entry points of the _cross_kernel_tri /
// _cross_kernel_tri_stream modes (one lattice translation per block) and of
// the tri_pp modes of _cross_kernel / _cross_kernel_stream (per-pair
// 27-image search) of mdhelper_tpu/ops/pallas_cell_histogram.py, every
// binning policy, optional (e0, e1) exclusion ids.  The kernel, what it
// computes, what bounds it and its design: cross_pair_histogram.cuh.

#include <cuda_runtime.h>

#include "cross_pair_histogram.cuh"

// The per-block sweep: as cross_pair_histogram_launch, with the slot tables
// of the fractionally folded atoms, `images` (n_cells, n_nbr) int32 rows of
// the shift table for the full-shell table's entries, and `shift_hi`,
// `shift_lo` (n_frames, 27, 3) float32, each frame's 27 lattice
// translations as double-floats, in place of `boxes`.
extern "C" int triclinic_cross_pair_histogram_launch(
    const void* table1, const void* occupancy1, const void* table2,
    const void* occupancy2, const void* neighbors, const void* images,
    const void* shift_hi, const void* shift_lo, void* out, int n_frames,
    int n_cells, int n_nbr, int capacity1, int capacity2, int n_bins,
    int exclude, int fast, int offset, float c0, float c1, float c2,
    float c3, float c4, float c5, float c6, float c7, void* stream) {
  const CrossArgs args{table1,    occupancy1, table2, occupancy2, neighbors,
                       out,       n_frames,   n_cells, n_nbr,     capacity1,
                       capacity2, n_bins,     exclude, stream};
  const float c[8] = {c0, c1, c2, c3, c4, c5, c6, c7};
  const cellbin::TriclinicBlock geometry{
      static_cast<const int*>(images), static_cast<const float*>(shift_hi),
      static_cast<const float*>(shift_lo), n_nbr};
  return launch_modes(args, geometry, fast, offset, c);
}

// The tri_pp sweep: as cross_pair_histogram_launch over the deduped full
// table of the folded atoms' grid, with `boxes` (n_frames, 18) float32:
// each frame's box matrix and then its float32 inverse, both row-major.
extern "C" int tri_pp_cross_pair_histogram_launch(
    const void* table1, const void* occupancy1, const void* table2,
    const void* occupancy2, const void* neighbors, const void* boxes,
    void* out, int n_frames, int n_cells, int n_nbr, int capacity1,
    int capacity2, int n_bins, int exclude, int fast, int offset, float c0,
    float c1, float c2, float c3, float c4, float c5, float c6, float c7,
    void* stream) {
  const CrossArgs args{table1,    occupancy1, table2, occupancy2, neighbors,
                       out,       n_frames,   n_cells, n_nbr,     capacity1,
                       capacity2, n_bins,     exclude, stream};
  const float c[8] = {c0, c1, c2, c3, c4, c5, c6, c7};
  return launch_modes(args,
                      cellbin::Tri27Block{static_cast<const float*>(boxes)},
                      fast, offset, c);
}
