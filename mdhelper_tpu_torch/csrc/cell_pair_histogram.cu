// Cell-list pair-distance histogram, half-shell, orthorhombic, exact.
//
// Replaces the TPU kernel mdhelper_tpu/ops/pallas_cell_histogram.py::_kernel
// (launched from cell_pair_histogram_pallas) in the mode the RDF main path
// uses: half-shell 14-entry neighbor table, orthorhombic box, all three
// axes, exact double-float binning (_bin_exact + _exact_index_from_d2 with
// the "zero" boundary constants), no exclusion-id rows.
//
// What it computes.  For each frame, home cell c and entry nb of c's
// half-shell row (entry 0 is c itself), every slot pair (i, j) with
// i < occ[c], j < occ[nbr] -- and i < j inside the home block -- gets the
// exact minimum-image d^2 in double-float, a float32-estimated bin with a
// +-1 correction against the exact (k*dr)^2 boundaries, and one count when
// the bin is below n_bins.  The wrapper doubles the counts (each unordered
// pair was visited once).
//
// What bounds it on the card: pair math, not bytes.  At the main path's
// plan (100k atoms, 8x8x8 cells, capacity 256) a frame sweeps about
// 470M padded slot pairs, each some 150 float32 operations of double-float
// arithmetic, against about 8 MB of slot table read per frame.
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
//
// The pair-binning math (exact d^2, estimate, +-1 boundary correction and
// its precision traps) lives in cell_bin.cuh, shared with the cross kernel.

#include <cuda_runtime.h>

#include "cell_bin.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cell_pair_histogram_kernel(const float4* __restrict__ table,
                           const int* __restrict__ occupancy,
                           const int* __restrict__ neighbors,
                           const float* __restrict__ boxes,
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
  const float box[3] = {boxes[3 * frame], boxes[3 * frame + 1],
                        boxes[3 * frame + 2]};

  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0u;
  for (int s = threadIdx.x; s < oi; s += blockDim.x)
    si[s] = frame_table[static_cast<long long>(home) * capacity + s];
  for (int s = threadIdx.x; s < oj; s += blockDim.x)
    sj[s] = frame_table[static_cast<long long>(other) * capacity + s];
  __syncthreads();

  const int n_pairs = oi * oj;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int i = p / oj;
    const int j = p - i * oj;
    // Home block: strict upper slot triangle (drops identical atoms too).
    if (self_block && i >= j) continue;
    const int idx = cellbin::exact_bin(si[i], sj[j], box, n_bins, inv_dr,
                                       dr2_hi, dr2_lo);
    if (idx < n_bins) atomicAdd(&hist[idx], 1u);
  }
  __syncthreads();

  unsigned long long* frame_out = out + static_cast<long long>(frame) * n_bins;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const unsigned int h = hist[b];
    if (h) atomicAdd(&frame_out[b], static_cast<unsigned long long>(h));
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `table` is the
// (n_frames, n_cells * capacity, 4) float32 slot table (xyz, atom id),
// `occupancy` (n_frames, n_cells) int32, `neighbors` (n_cells, n_nbr) int32
// half-shell table, `boxes` (n_frames, 3) float32, `out` (n_frames, n_bins)
// 64-bit counts, zeroed by the caller.  Returns cudaGetLastError().
extern "C" int cell_pair_histogram_launch(
    const void* table, const void* occupancy, const void* neighbors,
    const void* boxes, void* out, int n_frames, int n_cells, int n_nbr,
    int capacity, int n_bins, float inv_dr, float dr2_hi, float dr2_lo,
    void* stream) {
  const size_t smem = 2 * sizeof(float4) * static_cast<size_t>(capacity) +
                      sizeof(unsigned int) * static_cast<size_t>(n_bins);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cell_pair_histogram_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>(n_cells * n_nbr),
                  static_cast<unsigned int>(n_frames));
  cell_pair_histogram_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(occupancy),
      static_cast<const int*>(neighbors), static_cast<const float*>(boxes),
      static_cast<unsigned long long*>(out), n_cells, n_nbr, capacity,
      n_bins, inv_dr, dr2_hi, dr2_lo);
  return static_cast<int>(cudaGetLastError());
}
