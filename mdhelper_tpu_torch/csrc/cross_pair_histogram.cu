// Cell-list pair-distance histogram between two groups,
// orthorhombic boxes: the entry point of the _cross_kernel /
// _cross_kernel_stream modes of mdhelper_tpu/ops/pallas_cell_histogram.py
// (cross_pair_histogram_pallas) on 3-D and 2-D grids, every binning policy,
// optional (e0, e1) exclusion ids.  The kernel, what it computes, what
// bounds it and its design: cross_pair_histogram.cuh.

#include <cuda_runtime.h>

#include "cross_pair_histogram.cuh"

// Launch on `stream` (a cudaStream_t passed as a pointer).  `table1` and
// `table2` are the (n_frames, n_cells * capacity{1,2}, 4) float32 slot
// tables of the two groups on one grid (xyz -- a 2-D grid's two kept
// coordinates first -- and the exclusion id), `occupancy1` and `occupancy2`
// (n_frames, n_cells) int32, `neighbors` (n_cells, n_nbr) int32 full-shell
// table (reach-1 or deduped), `boxes` (n_frames, 3) float32 in the tables'
// coordinate order, `out` (n_frames, n_bins) 64-bit counts, zeroed by the
// caller; `exclude` != 0 drops pairs with equal ids; `n_axes` (2 or 3)
// distance components are summed; `fast`, `offset` and `c0`..`c7` pick the
// binning (cellbin::with_bins).  Returns cudaGetLastError().
extern "C" int cross_pair_histogram_launch(
    const void* table1, const void* occupancy1, const void* table2,
    const void* occupancy2, const void* neighbors, const void* boxes,
    void* out, int n_frames, int n_cells, int n_nbr, int capacity1,
    int capacity2, int n_bins, int exclude, int n_axes, int fast, int offset,
    float c0, float c1, float c2, float c3, float c4, float c5, float c6,
    float c7, void* stream) {
  const CrossArgs args{table1,    occupancy1, table2, occupancy2, neighbors,
                       out,       n_frames,   n_cells, n_nbr,     capacity1,
                       capacity2, n_bins,     exclude, stream};
  const float c[8] = {c0, c1, c2, c3, c4, c5, c6, c7};
  const float* lengths = static_cast<const float*>(boxes);
  if (n_axes == 2) {
    return launch_modes(args, cellbin::OrthoBlock<2>{lengths}, fast, offset,
                        c);
  }
  return launch_modes(args, cellbin::OrthoBlock<3>{lengths}, fast, offset, c);
}
