// The cell-list sweep that the self and the cross pair-histogram kernels
// share (cell_pair_histogram.cuh, cross_pair_histogram.cuh instantiate it):
// one thread block per work item (frame, home cell, tile of kRows home
// slots), walking the home cell's whole neighbour row through a ring of
// neighbour-slot tiles in shared memory.
//
// The work item.  Its home slots i0 .. i0 + kRows (those below the home
// cell's occupancy; a tile past it returns at once, before any barrier) are
// staged once, with the asymmetric tiles' second ids beside them.  Then the
// neighbour row's entries are cut into tiles of kTile occupied slots (empty
// neighbours give none) and streamed through a ring of kStages stages:
// thread 0 starts a 1-D bulk copy (cp.async.bulk, the TMA's linear form) of
// a tile -- kTile float4 slots, and for an asymmetric tile exclusion the
// tile's 4-byte second ids, rounded up to 16 bytes (inside the capacity row:
// capacities are multiples of 32) -- onto the stage's mbarrier, which counts
// the bytes in.  Every thread waits on that barrier's phase, bins the tile,
// and after a block barrier thread 0 refills the stage with the tile
// kStages ahead, so kStages - 1 copies are in flight while one tile is
// binned.  Each warp owns the home rows r = warp, warp + n_warps, ...: it
// reads row r once a tile (a shared-memory broadcast into registers) and its
// lanes walk the tile's slots j.  No integer division a pair.  In the home
// block of a half-shell sweep (entry 0) a row's lanes start at slot i + 1,
// so the strict upper triangle fills them and none idles on i >= j.
//
// The row test.  Under an exact binning policy each warp first takes the
// bounding box of the tile's slots (a warp reduction) and skips every home
// row whose periodic distance to that box, less the screen's eps, lies
// beyond the last bin boundary (Image::row_reaches): on a reach-1 grid of
// cells about r_max wide, most rows against a corner or edge neighbour.
//
// The screened pairs.  Under an exact binning policy each lane first runs
// the float32 screen of cell_bin.cuh on its pair; only the pairs near or
// inside r_max (about a tenth on reach-1 grids) need the double-float d^2.
// Were each lane to go on with its own pair, nearly every warp would hold
// one such pair and run the exact path with the rest of its lanes idle, so
// the warp queues its passing pairs in shared memory (a ballot gives each
// its place) and bins them 32 at a time, every lane busy; what is left is
// binned before the stage is released.  Fast policies bin directly.
//
// Counts.  Each warp adds into its own copy of the uint32 histogram in
// shared memory (n_copies copies chosen at launch from n_bins: 8 for the
// usual few hundred bins, fewer for wider histograms, none for one that does
// not fit beside the ring, which then counts straight into the global
// 64-bit counts); the copies are summed and flushed once a work item with at
// most n_bins 64-bit global atomics -- once per (cell, i-tile) instead of
// once per (cell, neighbour entry).  A work item counts at most kRows times
// the slots of its distinct neighbour cells, times a weight of at most 2:
// under 2^31 for groups under 2^24 atoms, so uint32 cannot overflow.
//
// Loops stride over blockDim (warps = ceil(blockDim / 32), lanes = min(32,
// blockDim)), so a block of any width covers its work item: the CPU
// rehearsal in scripts/check_kernel_modes.py runs one thread a block, with
// the copies done at once and the waits empty (the host branch of the ring
// helpers below).
#pragma once

#include <cuda_runtime.h>

#include "cell_bin.cuh"

namespace cellsweep {
namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // home slots of a work item, at most
constexpr int kTile = 256;     // neighbour slots of a ring stage
constexpr int kStages = 3;
constexpr int kMaxCopies = kThreads / 32;  // one a warp
constexpr int kQueue = 64;                 // screened pairs a warp queues
static_assert(kRows <= 256 && kTile <= 256,
              "a queue key holds a row and a slot in a byte each");

// Shared memory of a block besides the histogram copies: the barriers, the
// ring and the home rows (each with 4-byte second ids beside it), and the
// warps' queues (a key and an aux word a pair).
constexpr size_t kFixedBytes =
    32 + (kStages * kTile + kRows) * 20 + kMaxCopies * kQueue * 8;

// Warp primitives; the host branch is the CPU rehearsal's one-lane warp.
__device__ __forceinline__ unsigned warp_ballot(bool p) {
#if defined(__CUDA_ARCH__)
  return __ballot_sync(0xffffffffu, p);
#else
  return p ? 1u : 0u;
#endif
}

__device__ __forceinline__ void warp_sync() {
#if defined(__CUDA_ARCH__)
  __syncwarp();
#endif
}

__device__ __forceinline__ float warp_min(float x, int lanes) {
  for (int step = lanes / 2; step > 0; step /= 2) {
#if defined(__CUDA_ARCH__)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, step));
#endif
  }
  return x;
}

__device__ __forceinline__ float warp_max(float x, int lanes) {
  for (int step = lanes / 2; step > 0; step /= 2) {
#if defined(__CUDA_ARCH__)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, step));
#endif
  }
  return x;
}

__device__ __forceinline__ int bit_count(unsigned x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The ring's three primitives: a stage's barrier made ready for one arrival,
// a copy that the barrier counts in, and the wait for a barrier's phase.
__device__ __forceinline__ void ring_init(unsigned long long* bar) {
#if defined(__CUDA_ARCH__)
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(addr)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#else
  *bar = 0;
#endif
}

// Thread 0: expect `bytes` on `bar` (one arrival), then copy the ranges
// (dst0, src0, size0) and, when size1 is not 0, (dst1, src1, size1): sizes
// multiples of 16, addresses 16-aligned.
__device__ __forceinline__ void ring_load(unsigned long long* bar,
                                          unsigned bytes, void* dst0,
                                          const void* src0, unsigned size0,
                                          void* dst1, const void* src1,
                                          unsigned size1) {
#if defined(__CUDA_ARCH__)
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  // The stage was last read through the generic proxy; order those reads
  // before the async proxy's writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(
          static_cast<unsigned>(__cvta_generic_to_shared(dst0))),
      "l"(src0), "r"(size0), "r"(b)
      : "memory");
  if (size1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(
            static_cast<unsigned>(__cvta_generic_to_shared(dst1))),
        "l"(src1), "r"(size1), "r"(b)
        : "memory");
  }
#else
  (void)bar;
  (void)bytes;
  unsigned char* d0 = static_cast<unsigned char*>(dst0);
  const unsigned char* s0 = static_cast<const unsigned char*>(src0);
  for (unsigned k = 0; k < size0; ++k) d0[k] = s0[k];
  unsigned char* d1 = static_cast<unsigned char*>(dst1);
  const unsigned char* s1 = static_cast<const unsigned char*>(src1);
  for (unsigned k = 0; k < size1; ++k) d1[k] = s1[k];
#endif
}

__device__ __forceinline__ void ring_wait(unsigned long long* bar,
                                          unsigned parity) {
#if defined(__CUDA_ARCH__)
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned ready = 0;
  while (!ready) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ready)
        : "r"(addr), "r"(parity)
        : "memory");
  }
#else
  (void)bar;
  (void)parity;
#endif
}

// The pairs a sweep counts, and with what weight.  `home` is entry 0 of the
// neighbour row (the home cell itself), i and j slot indices in their
// cells, a and c the slots (xyz, id), ai and cj their second ids (read only
// when side() is true).
//
// Cross: every (group-1, group-2) pair, minus equal exclusion ids when
// `exclude` is on.  No identical-atom mask: in a cross RDF of overlapping
// groups an atom in both groups meets itself at distance 0, in bin 0 (the
// JAX package's brute sweep does the same), or is dropped by its equal
// exclusion ids.
struct CrossPairs {
  int exclude;

  __device__ __forceinline__ bool side() const { return false; }
  __device__ __forceinline__ int first_j(bool, int) const { return 0; }
  __device__ __forceinline__ unsigned weight(bool, int, int, float4 a,
                                             float4 c, float, float) const {
    return exclude && a.w == c.w ? 0u : 1u;
  }
};

// No tile exclusion of the self sweep.
struct NoTiles {
  static constexpr bool kEnabled = false;
  int asym;
};

// A tile exclusion of the self sweep: ids i // e0 in column 3, and with
// `asym` the second ids i // e1 in the side table.
struct Tiles {
  static constexpr bool kEnabled = true;
  int asym;
};

// Self, half shell: the home block's strict upper slot triangle (which drops
// identical atoms), each unordered cell pair once (the wrapper doubles);
// a symmetric tile drops equal ids, an asymmetric one weights the unordered
// pair {a, c} with its ordered multiplicity [a // e0 != c // e1] + [c // e0
// != a // e1] (_asym_weights; 0, 1 or 2; not doubled).
template <class TileMask>
struct HalfShellPairs {
  TileMask tiles;

  __device__ __forceinline__ bool side() const {
    return TileMask::kEnabled && tiles.asym;
  }
  __device__ __forceinline__ int first_j(bool home, int i) const {
    return home ? i + 1 : 0;
  }
  __device__ __forceinline__ unsigned weight(bool, int, int, float4 a,
                                             float4 c, float ai,
                                             float cj) const {
    if constexpr (TileMask::kEnabled) {
      if (tiles.asym) {
        return static_cast<unsigned>(a.w != cj) +
               static_cast<unsigned>(c.w != ai);
      }
      return a.w != c.w ? 1u : 0u;
    }
    return 1u;
  }
};

// Self, ordered (the deduped full table, home cell in entry 0 only): every
// ordered pair once, identical atoms dropped by id -- by slot under a tile
// exclusion, whose ids are tiles -- and the tile mask i // e0 != j // e1.
template <class TileMask>
struct OrderedPairs {
  TileMask tiles;

  __device__ __forceinline__ bool side() const {
    return TileMask::kEnabled && tiles.asym;
  }
  __device__ __forceinline__ int first_j(bool, int) const { return 0; }
  __device__ __forceinline__ unsigned weight(bool home, int i, int j,
                                             float4 a, float4 c, float,
                                             float cj) const {
    if constexpr (TileMask::kEnabled) {
      if (home && i == j) return 0u;
      return a.w == (tiles.asym ? cj : c.w) ? 0u : 1u;
    }
    return home && a.w == c.w ? 0u : 1u;
  }
};

// A position in the work item's stream of neighbour tiles: entry `entry`
// of the row (n_nbr when done), the neighbour cell, its occupancy and the
// tile's first slot.
struct Cursor {
  int entry, other, oj, j0;
};

// What a work item reads besides its slots.
struct Sweep {
  const int* row;        // the home cell's neighbour row
  const int* occupancy;  // the neighbours' group's occupancy of the frame
  int n_nbr, capacity;

  // The next tile: the next kTile slots of this neighbour, or the first of
  // the next non-empty one.
  __device__ __forceinline__ void advance(Cursor& cur) const {
    cur.j0 += kTile;
    while (cur.j0 >= cur.oj) {
      if (++cur.entry >= n_nbr) return;
      cur.other = row[cur.entry];
      cur.oj = min(occupancy[cur.other], capacity);
      cur.j0 = 0;
    }
  }

  __device__ __forceinline__ Cursor first() const {
    Cursor cur{-1, 0, 0, 0};
    advance(cur);
    return cur;
  }
};

// Sweep of one work item; `table1`/`occupancy1`/`side1` are the home
// group's (frame-major (n_frames, n_cells * capacity1) slots), the `2`s
// the neighbours' (the same arrays for a self sweep).
template <class Geometry, class Bins, class Pairs>
__global__ void __launch_bounds__(kThreads)
cell_sweep_kernel(const float4* __restrict__ table1,
                  const int* __restrict__ occupancy1,
                  const float* __restrict__ side1,
                  const float4* __restrict__ table2,
                  const int* __restrict__ occupancy2,
                  const float* __restrict__ side2,
                  const int* __restrict__ neighbors, Geometry geometry,
                  unsigned long long* __restrict__ out, int n_cells,
                  int n_nbr, int capacity1, int capacity2, int row_tiles,
                  int n_bins, int n_copies, Bins bins, Pairs pairs) {
  extern __shared__ unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  float4* ring = reinterpret_cast<float4*>(smem + 32);
  float4* rows = ring + kStages * kTile;
  float* ring_side = reinterpret_cast<float*>(rows + kRows);
  float* row_side = ring_side + kStages * kTile;
  unsigned int* queues = reinterpret_cast<unsigned int*>(row_side + kRows);
  unsigned int* hist = queues + 2 * kQueue * kMaxCopies;

  const int frame = blockIdx.y;
  const int home = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x - home * row_tiles) * kRows;
  const long long cells = static_cast<long long>(frame) * n_cells;
  const int ni = min(min(occupancy1[cells + home], capacity1) - i0, kRows);
  // Uniform across the block, and before any barrier: a tile past the
  // home cell's occupancy has nothing to count.
  if (ni <= 0) return;

  const int tid = threadIdx.x;
  const int lanes = min(static_cast<int>(blockDim.x), 32);
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_warps = (static_cast<int>(blockDim.x) + 31) / 32;
  const bool side = pairs.side();
  const Sweep sweep{neighbors + static_cast<long long>(home) * n_nbr,
                    occupancy2 + cells, n_nbr, capacity2};
  const float4* slots2 = table2 + cells * capacity2;
  const float* sides2 = side ? side2 + cells * capacity2 : nullptr;
  const auto binner = bins.prepared(n_bins);
  unsigned long long* frame_out = out + static_cast<long long>(frame) * n_bins;

  for (int b = tid; b < n_copies * n_bins; b += blockDim.x) hist[b] = 0u;
  const long long home_slot = (cells + home) * capacity1 + i0;
  for (int s = tid; s < ni; s += blockDim.x) {
    rows[s] = table1[home_slot + s];
    if (side) row_side[s] = side1[home_slot + s];
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) ring_init(&bars[s]);
  }
  __syncthreads();

  // Thread 0 starts the copy of the tile at `cur` into `stage`.
  auto load = [&](const Cursor& cur, int stage) {
    const int nj = min(kTile, cur.oj - cur.j0);
    const long long slot = static_cast<long long>(cur.other) * capacity2 +
                           cur.j0;
    const unsigned size0 = 16u * nj;
    const unsigned size1 = side ? 16u * ((nj + 3) / 4) : 0u;
    ring_load(&bars[stage], size0 + size1, ring + stage * kTile,
              slots2 + slot, size0, ring_side + stage * kTile,
              side ? sides2 + slot : nullptr, size1);
  };
  Cursor ahead = sweep.first();
  for (int s = 0; s < kStages && ahead.entry < n_nbr; ++s) {
    if (tid == 0) load(ahead, s);
    sweep.advance(ahead);
  }

  auto image = geometry.at(frame, home, 0);
  int image_entry = 0;
  int stage = 0;
  unsigned parity = 0;
  for (Cursor cur = sweep.first(); cur.entry < n_nbr; sweep.advance(cur)) {
    if constexpr (Geometry::kPerEntry) {
      if (cur.entry != image_entry) {
        image = geometry.at(frame, home, cur.entry);
        image_entry = cur.entry;
      }
    }
    const int nj = min(kTile, cur.oj - cur.j0);
    const bool home_block = cur.entry == 0;
    const float4* tile = ring + stage * kTile;
    const float* tile_side = ring_side + stage * kTile;
    unsigned int* counts =
        n_copies ? hist + (warp % n_copies) * n_bins : nullptr;
    unsigned int* queue_key = queues + warp * 2 * kQueue;
    unsigned int* queue_aux = queue_key + kQueue;
    ring_wait(&bars[stage], parity);
    auto count = [&](int idx, unsigned w) {
      if (idx >= n_bins) return;
      if (counts) {
        atomicAdd(&counts[idx], w);
      } else {
        atomicAdd(&frame_out[idx], static_cast<unsigned long long>(w));
      }
    };
    if constexpr (Bins::kScreened) {
      // Each lane screens one pair; the warp queues the pairs that pass
      // (key: weight, row, slot; aux: what the screen hands the exact
      // step) and bins them a full warp at a time.
      auto drain = [&](int k) {
        const unsigned key = queue_key[k];
        const int r = (key >> 8) & 0xff;
        count(binner.index(image, rows[r], tile[key & 0xff], queue_aux[k],
                           n_bins),
              key >> 16);
      };
      // The tile's bounding box, for the rows' test.
      float lo[3] = {INFINITY, INFINITY, INFINITY};
      float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
      for (int j = lane; j < nj; j += lanes) {
        const float4 c = tile[j];
        const float pc[3] = {c.x, c.y, c.z};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          lo[k] = fminf(lo[k], pc[k]);
          hi[k] = fmaxf(hi[k], pc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = warp_min(lo[k], lanes);
        hi[k] = warp_max(hi[k], lanes);
      }
      int queued = 0;
      for (int r = warp; r < ni; r += n_warps) {
        const int i = i0 + r;
        const float4 a = rows[r];
        // A row no pair of the tile can reach skips it (warp-uniform).
        if (!image.row_reaches(a, lo, hi, binner.cut)) continue;
        const float ai = side ? row_side[r] : 0.0f;
        const int start = max(pairs.first_j(home_block, i) - cur.j0, 0);
        for (int jb = start; jb < nj; jb += lanes) {
          const int j = jb + lane;
          bool pass = false;
          unsigned key = 0u, aux = 0u;
          if (j < nj) {
            const float4 c = tile[j];
            const unsigned w = pairs.weight(home_block, i, cur.j0 + j, a, c,
                                            ai, side ? tile_side[j] : 0.0f);
            pass = w && binner.screen(image, a, c, aux);
            key = (w << 16) | (static_cast<unsigned>(r) << 8) |
                  static_cast<unsigned>(j);
          }
          const unsigned vote = warp_ballot(pass);
          if (pass) {
            const int k = queued + bit_count(vote & ((1u << lane) - 1u));
            queue_key[k] = key;
            queue_aux[k] = aux;
          }
          queued += bit_count(vote);
          if (queued >= lanes) {
            warp_sync();
            drain(lane);
            queued -= lanes;
            unsigned rest_key = 0u, rest_aux = 0u;
            if (lane < queued) {
              rest_key = queue_key[lanes + lane];
              rest_aux = queue_aux[lanes + lane];
            }
            warp_sync();
            if (lane < queued) {
              queue_key[lane] = rest_key;
              queue_aux[lane] = rest_aux;
            }
            warp_sync();
          }
        }
      }
      warp_sync();
      if (lane < queued) drain(lane);
    } else {
      for (int r = warp; r < ni; r += n_warps) {
        const int i = i0 + r;
        const float4 a = rows[r];
        const float ai = side ? row_side[r] : 0.0f;
        const int start = max(pairs.first_j(home_block, i) - cur.j0, 0);
        for (int j = start + lane; j < nj; j += lanes) {
          const float4 c = tile[j];
          const unsigned w = pairs.weight(home_block, i, cur.j0 + j, a, c,
                                          ai, side ? tile_side[j] : 0.0f);
          if (w) count(binner.index(image, a, c, n_bins), w);
        }
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (ahead.entry < n_nbr) {
      if (tid == 0) load(ahead, stage);
      sweep.advance(ahead);
    }
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1u;
    }
  }

  for (int b = tid; b < n_bins && n_copies; b += blockDim.x) {
    unsigned int h = 0u;
    for (int k = 0; k < n_copies; ++k) h += hist[k * n_bins + b];
    if (h) atomicAdd(&frame_out[b], static_cast<unsigned long long>(h));
  }
}

// What every launch takes besides its geometry, binning and pairs.
struct SweepArgs {
  const void* table1;
  const void* occupancy1;
  const void* side1;
  const void* table2;
  const void* occupancy2;
  const void* side2;
  const void* neighbors;
  void* out;
  int n_frames, n_cells, n_nbr, capacity1, capacity2, n_bins;
  void* stream;
};

// Histogram copies for n_bins: one a warp while they take at most 32 KB,
// fewer for wider histograms, and none when one copy does not fit beside
// the ring in the 227 KB a block may opt in to.
inline int histogram_copies(int n_bins) {
  const size_t bytes = sizeof(unsigned int) * static_cast<size_t>(n_bins);
  if (kFixedBytes + bytes > 232448) return 0;
  const size_t fit = 32768 / bytes;
  return static_cast<int>(fit < 1 ? 1 : fit > kMaxCopies ? kMaxCopies : fit);
}

template <class Geometry, class Bins, class Pairs>
int launch_sweep(const SweepArgs& a, Geometry geometry, Bins bins,
                 Pairs pairs) {
  const int copies = histogram_copies(a.n_bins);
  const size_t smem =
      kFixedBytes + sizeof(unsigned int) * static_cast<size_t>(copies) *
                        static_cast<size_t>(a.n_bins);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cell_sweep_kernel<Geometry, Bins, Pairs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int row_tiles = (a.capacity1 + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned int>(a.n_cells * row_tiles),
                  static_cast<unsigned int>(a.n_frames));
  cell_sweep_kernel<Geometry, Bins, Pairs>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const float4*>(a.table1),
          static_cast<const int*>(a.occupancy1),
          static_cast<const float*>(a.side1),
          static_cast<const float4*>(a.table2),
          static_cast<const int*>(a.occupancy2),
          static_cast<const float*>(a.side2),
          static_cast<const int*>(a.neighbors), geometry,
          static_cast<unsigned long long*>(a.out), a.n_cells, a.n_nbr,
          a.capacity1, a.capacity2, row_tiles, a.n_bins, copies, bins, pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cellsweep
