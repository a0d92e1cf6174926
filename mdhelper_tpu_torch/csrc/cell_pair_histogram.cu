// Cell-list pair-distance histogram of one group, exact: orthorhombic and
// triclinic boxes, half-shell and ordered sweeps.
//
// Replaces the TPU kernels of mdhelper_tpu/ops/pallas_cell_histogram.py
// launched from cell_pair_histogram_pallas, in the modes the RDF uses: all
// three axes, exact double-float binning (the "zero" boundary constants),
// no exclusion-id rows.
//   * _kernel (orthorhombic; per-pair minimum image, _bin_exact), and its
//     streaming twin _kernel_stream: cell_pair_histogram_kernel<OrthoBlock,
//     false> over a half-shell table -- the reach-1 14-entry table, or the
//     deduped half table of a generalized reach-m grid -- and, in ordered
//     mode (a small box whose grid has no half table),
//     cell_pair_histogram_kernel<OrthoBlock, true> over the deduped full
//     table; entry point cell_pair_histogram_launch;
//   * _kernel_tri (triclinic; one lattice translation per (cell, neighbour)
//     block, _bin_exact_shift), and its streaming twin _kernel_tri_stream:
//     cell_pair_histogram_kernel<TriclinicBlock, false>, entry point
//     triclinic_cell_pair_histogram_launch;
//   * _kernel and _kernel_stream in tri_pp mode (triclinic grids under 3
//     cells or of reach above 1; per-pair 27-candidate minimum image,
//     _bin_exact_tri27; always ordered): cell_pair_histogram_kernel<
//     Tri27Block, true>, entry point tri_pp_cell_pair_histogram_launch.
// One block per (cell, neighbour) with both slot blocks staged in shared
// memory is already the streaming layout, so each instantiation serves both
// TPU layouts.
//
// What it computes.  For each frame, home cell c and entry nb of c's
// neighbour row (entry 0 is c itself), every slot pair (i, j) with
// i < occ[c], j < occ[nbr] -- in the home block, i < j in a half-shell
// sweep, and distinct atom ids (column 3) in an ordered one -- gets the
// exact d^2 of cell_bin.cuh in double-float, a float32-estimated bin with a
// +-1 correction against the exact (k*dr)^2 boundaries, and one count when
// the bin is below n_bins.  A half-shell table holds every unordered cell
// pair once, so the wrapper doubles those counts; an ordered (deduped full)
// table holds every ordered cell pair once, and its counts are not
// doubled.  In a triclinic grid the atoms are folded into the primary cell
// and assigned cells in fractional coordinates by the wrapper; the
// per-block mode's image row (images[c, nb]) picks the frame's double-float
// translation that moves the neighbour's atoms next to the home cell --
// the minimum image of every pair within r_max while each cell is at least
// r_max wide along every lattice direction, which the wrapper checks per
// frame (NaN otherwise) -- and tri_pp searches the 27 images of each pair.
//
// What bounds it on the card: pair math, not bytes.  At the main path's
// plan (100k atoms, 8x8x8 cells, capacity 256) a frame bins about 263M
// occupied slot pairs, each 254 float32 operations (245 for a shifted
// block, 7,186 for a tri_pp pair; counted in cell_bin.cuh), against about
// 8 MB of slot table read per frame.
//
// This first design: one thread block per (frame, home cell, neighbor):
// 7,168 blocks per frame at that plan, enough to fill 132 SMs.  The two
// slot blocks (xyz + id, 16 B a slot) are staged in shared memory; the
// threads stride over the occ_i * occ_j real pairs only (padding slots are
// never computed); counts go to a shared-memory uint32 histogram with
// atomicAdd and are flushed once per block into the global (B, n_bins)
// 64-bit counts.  The TPU's bf16 one-hot "digit contraction" exists only
// because the TPU has no fast scatter; the shared-memory atomics replace
// it and give the same integer counts.  Warp-level histogram
// privatisation, persistent blocks and tighter capacities are later work.

#include <cuda_runtime.h>

#include "cell_bin.cuh"

namespace {

constexpr int kThreads = 256;

using cellbin::OrthoBlock;
using cellbin::Tri27Block;
using cellbin::TriclinicBlock;

template <class Geometry, bool kOrdered>
__global__ void __launch_bounds__(kThreads)
cell_pair_histogram_kernel(const float4* __restrict__ table,
                           const int* __restrict__ occupancy,
                           const int* __restrict__ neighbors,
                           Geometry geometry,
                           unsigned long long* __restrict__ out,
                           int n_cells, int n_nbr, int capacity, int n_bins,
                           float inv_dr, float dr2_hi, float dr2_lo) {
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

  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0u;
  for (int s = threadIdx.x; s < oi; s += blockDim.x)
    si[s] = frame_table[static_cast<long long>(home) * capacity + s];
  for (int s = threadIdx.x; s < oj; s += blockDim.x)
    sj[s] = frame_table[static_cast<long long>(other) * capacity + s];
  __syncthreads();

  // The wrapper bounds capacity * capacity below 2^31.
  const int n_pairs = oi * oj;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int i = p / oj;
    const int j = p - i * oj;
    int idx;
    if constexpr (kOrdered) {
      const float4 a = si[i];
      const float4 c = sj[j];
      // Home block: drop identical atoms by their id (the atom index;
      // the deduped table holds the home cell in entry 0 only).
      if (self_block && a.w == c.w) continue;
      idx = cellbin::exact_bin(a, c, image, n_bins, inv_dr, dr2_hi, dr2_lo);
    } else {
      // Home block: strict upper slot triangle (drops identical atoms too).
      if (self_block && i >= j) continue;
      idx = cellbin::exact_bin(si[i], sj[j], image, n_bins, inv_dr, dr2_hi,
                               dr2_lo);
    }
    if (idx < n_bins) atomicAdd(&hist[idx], 1u);
  }
  __syncthreads();

  unsigned long long* frame_out = out + static_cast<long long>(frame) * n_bins;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const unsigned int h = hist[b];
    if (h) atomicAdd(&frame_out[b], static_cast<unsigned long long>(h));
  }
}

template <bool kOrdered, class Geometry>
int launch(const void* table, const void* occupancy, const void* neighbors,
           Geometry geometry, void* out, int n_frames, int n_cells, int n_nbr,
           int capacity, int n_bins, float inv_dr, float dr2_hi,
           float dr2_lo, void* stream) {
  const size_t smem = 2 * sizeof(float4) * static_cast<size_t>(capacity) +
                      sizeof(unsigned int) * static_cast<size_t>(n_bins);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cell_pair_histogram_kernel<Geometry, kOrdered>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>(n_cells * n_nbr),
                  static_cast<unsigned int>(n_frames));
  cell_pair_histogram_kernel<Geometry, kOrdered>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float4*>(table),
          static_cast<const int*>(occupancy),
          static_cast<const int*>(neighbors), geometry,
          static_cast<unsigned long long*>(out), n_cells, n_nbr, capacity,
          n_bins, inv_dr, dr2_hi, dr2_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `table` is the
// (n_frames, n_cells * capacity, 4) float32 slot table (xyz, atom id),
// `occupancy` (n_frames, n_cells) int32, `neighbors` (n_cells, n_nbr) int32
// neighbour table with the home cell in column 0 -- a half-shell table, or
// with `ordered` != 0 a deduped full table -- `boxes` (n_frames, 3)
// float32, `out` (n_frames, n_bins) 64-bit counts, zeroed by the caller.
// Returns cudaGetLastError().
extern "C" int cell_pair_histogram_launch(
    const void* table, const void* occupancy, const void* neighbors,
    const void* boxes, void* out, int n_frames, int n_cells, int n_nbr,
    int capacity, int n_bins, int ordered, float inv_dr, float dr2_hi,
    float dr2_lo, void* stream) {
  const OrthoBlock geometry{static_cast<const float*>(boxes)};
  if (ordered) {
    return launch<true>(table, occupancy, neighbors, geometry, out, n_frames,
                        n_cells, n_nbr, capacity, n_bins, inv_dr, dr2_hi,
                        dr2_lo, stream);
  }
  return launch<false>(table, occupancy, neighbors, geometry, out, n_frames,
                       n_cells, n_nbr, capacity, n_bins, inv_dr, dr2_hi,
                       dr2_lo, stream);
}

// The triclinic sweep: as cell_pair_histogram_launch over the 14-entry
// half-shell table, with the slot table of the fractionally folded atoms,
// `images` (n_cells, n_nbr) int32 rows of the shift table for the table's
// entries, and `shift_hi`, `shift_lo` (n_frames, 27, 3) float32, each
// frame's 27 lattice translations as double-floats, in place of `boxes`.
extern "C" int triclinic_cell_pair_histogram_launch(
    const void* table, const void* occupancy, const void* neighbors,
    const void* images, const void* shift_hi, const void* shift_lo,
    void* out, int n_frames, int n_cells, int n_nbr, int capacity,
    int n_bins, float inv_dr, float dr2_hi, float dr2_lo, void* stream) {
  const TriclinicBlock geometry{static_cast<const int*>(images),
                                static_cast<const float*>(shift_hi),
                                static_cast<const float*>(shift_lo), n_nbr};
  return launch<false>(table, occupancy, neighbors, geometry, out, n_frames,
                       n_cells, n_nbr, capacity, n_bins, inv_dr, dr2_hi,
                       dr2_lo, stream);
}

// The tri_pp sweep: ordered, over the deduped full table of the folded
// atoms' grid, with `boxes` (n_frames, 18) float32: each frame's box matrix
// and then its float32 inverse, both row-major.
extern "C" int tri_pp_cell_pair_histogram_launch(
    const void* table, const void* occupancy, const void* neighbors,
    const void* boxes, void* out, int n_frames, int n_cells, int n_nbr,
    int capacity, int n_bins, float inv_dr, float dr2_hi, float dr2_lo,
    void* stream) {
  return launch<true>(table, occupancy, neighbors,
                      Tri27Block{static_cast<const float*>(boxes)}, out,
                      n_frames, n_cells, n_nbr, capacity, n_bins, inv_dr,
                      dr2_hi, dr2_lo, stream);
}
