// Factorized grid trig sums of B frames: the factor route of S(q) and of
// the ISF's coherent sums, launched from factor_trig_sums in
// mdhelper_tpu_torch/ops/factor_scattering.py.
//
// It replaces no TPU kernel.  The JAX package's factor route
// (mdhelper_tpu/ops/factor_scattering.py) has no Pallas kernel: it builds
// the axis tables and leaves the four float32 products to XLA at
// Precision.HIGHEST.  The port's plain version does the same in eager
// torch (about 275 launches an atom chunk, four chunks a frame at 100k
// atoms on the 24^3 grid, and (Kx Ky, chunk) intermediates of 67 MB in
// device memory), which left the host launch-bound; this kernel does a
// whole chunk of frames in one launch and one ordered reduction.
//
// What it computes.  For each frame b and grid point (nx, ny, nz) < K,
//   S[b, nx, ny, nz] = sum_j w_j E_x[nx, j] E_y[ny, j] E_z[nz, j],
//   E_a[n, j] = exp(2 pi i n r_ja / L_a),
// as float32 cos (real) and sin (imaginary) sums, written in the caller's
// wavevector order through flat_idx.  The axis tables are the plain
// version's _axis_tables, operation for operation:
//   fast   u = x / L, t = n u, theta = 2pi_hi (t - rint(t)), then cos and
//          sin of theta;
//   exact  u = x / L as a pair (u_hi = x / L, u_lo = ((x - p_hi) - p_lo) / L
//          with p = u_hi L formed error-free), t = n u_hi formed error-free
//          with t_lo += n u_lo, the turns m = rint(t_hi) taken off with
//          df_sub, the product by 2pi_hi formed error-free with its error
//          terms theta_lo = (b + v_hi 2pi_lo) + v_lo 2pi_hi, then cos and sin
//          of the high word and the first-order correction cos - theta_lo
//          sin, sin + theta_lo cos.
// Each error-free product is exact_prod (doublefloat.cuh: one fused
// multiply-add), which gives Dekker's two_prod's error term whenever the
// product is zero or at least 2^-101 and both factors are below 2^115
// (the note of trig_sums.cu): here reduced coordinates, box lengths of
// 1-10^4 A, turns n < 2^24 and reduced phases below 1/2, so the tables
// are the plain version's bits on the card (the precise sincosf, no
// __sinf/__cosf, no fast math, --fmad=false and every product and sum
// spelled with the round-to-nearest intrinsics).  Weights multiply the z
// table, as the plain version multiplies cz and sz.  The sums are not the
// plain version's bits: it adds in a float32 matmul's order, this kernel
// in the order below.
//
// The sum over atoms.  A block sums its slice of split_atoms atoms stage
// by stage: each stage's terms (stage_atoms, at most 64) into fresh float32
// registers, each stage's sums then into the slice's float32 sums, which
// it writes to a float32 workspace (the slice's sums are float32: a wider
// store would hold the same values); factor_sums_reduce adds the slices in
// slice order in float64 and rounds once to float32.  A float32 running
// sum of m terms of unit size errs by about 2^-25 m (a random walk of
// roundings of a sum of size sqrt(m)), so the two levels err by about
// 2^-25 sqrt(N) (sqrt(stage) + sqrt(split / stage)) over N atoms against
// 2^-25 sqrt(N split) for one float32 sum a slice; the plain version's
// float32 matmuls over atom chunks of up to 29k atoms, added chunk to
// chunk in float32, sit between.  Read on the card at 100k atoms x 8
// frames on 24^3 (exact, slices of 2,048): 0.9e-6 of the mean amplitude
// off a float64 oracle, against 1.6e-6 for the plain version and 4.2e-6
// for one level.  No atomics anywhere: two launches on the same input
// give the same bits.
//
// What bounds it on the card: float32 FMA issue.  The contraction needs
// 8 Kx Ky Kz + 6 Kx Ky float32 operations an atom (a complex multiply-add
// is four FMAs, an FMA counts two; cxy and sxy are a multiply and an FMA
// each), 1.14e10 a frame at 100k atoms on 24^3, 0.170 ms at 67 TFLOP/s,
// against 1.2 MB of positions and 0.1 MB of sums.  The design keeps every
// intermediate on chip and makes the FMA the instruction the SM issues:
// - A thread owns a register tile of kR (ny) x kC (nz) complex sums of one
//   nx: an atom costs it one float2 load of (cos, sin)_x, two float4 loads
//   of its kR (cos, sin)_y, four float4 loads of its kC (cos, sin)_z from
//   shared memory, 4 kR instructions for cxy and sxy, and 4 kR kC = 128
//   FMAs: 144 FMA-pipe instructions against 7 shared loads.  The y and z
//   groups of a table row are padded (kYStride, kZStride) so that the
//   groups a warp reads lie in different banks.
// - A block owns a box of tx nx values x tyg y groups x tzg z groups (at
//   most kMaxThreads threads, one tile each), one slice of atoms and one
//   frame, and builds its slice's tables stage by stage (stage_atoms
//   atoms: the reduced coordinates, then every (atom, table row) entry,
//   then the contraction), only for the nx, ny and nz its box holds.  At
//   24^3 a frame is two blocks of 216 tiles, 12 + 24 + 24 table rows an
//   atom (about 60 instructions each, sincosf's included) against 144 x
//   216 contraction instructions: the tables cost about 12 % more.
// - 128 accumulators a thread (the stage's and the slice's), 182
//   registers: one block an SM (__launch_bounds__(kMaxThreads, 1)).  One
//   level, at 120 registers and two blocks an SM, ran 13 % faster at
//   slices of 2,048 atoms but erred 4.6 times as much; short slices bring
//   its error down only through more partial sums to write and read
//   (0.495 ms a frame at 192 atoms, against 0.457 with two levels; both
//   read with float64 partial sums).
// Read at 8 frames of 100k atoms on 24^3, exact: 0.457-0.467 ms a frame,
// 36-37 % of the bound (NVIDIA H100 80GB HBM3, 700 W).
// Tensor cores are left out: a TF32 product keeps about three digits, and
// the sums must hold six.  The tile sizes the wrapper picks follow from K and
// n: the box from K, the stage from the box's shared memory, the slice
// from the blocks that fill the card at 8 frames a launch, never from the
// frames launched together (so a frame's sums are the same bits in any
// chunk), within the partial sums' byte budget (past it the wrapper
// launches a call's frames in groups, and past that gives each slice more
// atoms).

#include <cuda_runtime.h>

#include "doublefloat.cuh"

namespace {

using dfloat::df;

constexpr int kR = 4;                  // ny rows a thread
constexpr int kC = 8;                  // nz columns a thread
constexpr int kMaxThreads = 256;       // threads (tiles) a block at most
constexpr int kYStride = 2 * kR + 4;   // floats a y group of a table row
constexpr int kZStride = 2 * kC + 4;   // floats a z group of a table row
constexpr int kReduce = 256;           // sums a block of the reduction

// The reduced coordinate of x on an axis of length `length`: u[0] = x / L
// and, exact, its low word u[1], as _axis_tables forms them.
template <bool kExact>
__device__ __forceinline__ void reduced_coordinate(float x, float length,
                                                   float* u) {
  const float hi = __fdiv_rn(x, length);
  u[0] = hi;
  if constexpr (kExact) {
    const df p = dfloat::exact_prod(hi, length);
    u[1] = __fdiv_rn(__fsub_rn(__fsub_rn(x, p.hi), p.lo), length);
  } else {
    u[1] = 0.0f;
  }
}

// One table entry, cos and sin of 2 pi n u, as _axis_tables forms it.
template <bool kExact>
__device__ __forceinline__ void axis_entry(float n, const float* u,
                                           float two_pi_hi, float two_pi_lo,
                                           float* c, float* s) {
  if constexpr (kExact) {
    df t = dfloat::exact_prod(n, u[0]);
    t.lo = __fadd_rn(t.lo, __fmul_rn(n, u[1]));
    // Rounding trap: torch.round rounds half to even, as rintf does.
    const float m = rintf(t.hi);
    const df v = dfloat::df_sub(t, {m, 0.0f});
    const df a = dfloat::exact_prod(v.hi, two_pi_hi);
    const float theta_lo = __fadd_rn(
        __fadd_rn(a.lo, __fmul_rn(v.hi, two_pi_lo)),
        __fmul_rn(v.lo, two_pi_hi));
    float sin_a, cos_a;
    sincosf(a.hi, &sin_a, &cos_a);
    *c = __fsub_rn(cos_a, __fmul_rn(theta_lo, sin_a));
    *s = __fadd_rn(sin_a, __fmul_rn(theta_lo, cos_a));
  } else {
    const float t = __fmul_rn(n, u[0]);
    sincosf(__fmul_rn(two_pi_hi, __fsub_rn(t, rintf(t))), s, c);
  }
}

template <bool kExact, bool kWeights>
__global__ void __launch_bounds__(kMaxThreads, 1)
factor_sums_kernel(const float* __restrict__ positions,
                   const float* __restrict__ weights,
                   float* __restrict__ partial, int n_frames, int n_atoms,
                   int kx, int ky, int kz, int tx, int tyg, int tzg,
                   int tiles_y, int tiles_z, int threads, int split_atoms,
                   int stage_atoms, float lx, float ly, float lz,
                   float two_pi_hi, float two_pi_lo) {
  extern __shared__ unsigned char smem[];
  const int gy = (ky + kR - 1) / kR;
  const int gz = (kz + kC - 1) / kC;
  const int tile_z = blockIdx.x % tiles_z;
  const int tile_y = (blockIdx.x / tiles_z) % tiles_y;
  const int tile_x = blockIdx.x / (tiles_z * tiles_y);
  const int x0 = tile_x * tx;
  const int yg0 = tile_y * tyg;
  const int zg0 = tile_z * tzg;
  const int slice = blockIdx.y;
  const int frame = blockIdx.z;
  const int a_begin = slice * split_atoms;
  const int a_end = min(n_atoms, a_begin + split_atoms);
  const float* pos = positions + static_cast<long long>(frame) * n_atoms * 3;
  // The stage's tables, each row an atom: y groups, z groups, x values
  // (cos, sin pairs), then the atoms' reduced coordinates (u_hi, u_lo a
  // axis).  Every region starts on 16 bytes.
  float* s_y = reinterpret_cast<float*>(smem);
  float* s_z = s_y + stage_atoms * tyg * kYStride;
  float* s_x = s_z + stage_atoms * tzg * kZStride;
  float* s_u = s_x + stage_atoms * tx * 2;
  const int y_rows = tyg * kR;
  const int rows = tx + y_rows + tzg * kC;  // table rows an atom
  const int items = tx * tyg * tzg;
  const long long n_grid = static_cast<long long>(kx) * ky * kz;
  // partial is (n_slices, n_frames, 2, n_grid): this slice's cos, then sin.
  float* out = partial + (static_cast<long long>(slice) * n_frames + frame) *
                            2 * n_grid;
  // The table entries a thread builds, walked as (atom, row) pairs.
  const int step_a = blockDim.x / rows;
  const int step_row = blockDim.x - step_a * rows;

  // One pass on the card (blockDim.x == threads); the rehearsal's single
  // thread takes every pass.
  for (int t = threadIdx.x; t < threads; t += blockDim.x) {
    const int ix = t / (tyg * tzg);
    const int iyg = (t / tzg) % tyg;
    const int izg = t % tzg;
    const bool active = t < items && x0 + ix < kx && yg0 + iyg < gy &&
                        zg0 + izg < gz;
    float re[kR][kC], im[kR][kC];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        re[r][c] = 0.0f;
        im[r][c] = 0.0f;
      }
    }
    for (int base = a_begin; base < a_end; base += stage_atoms) {
      const int count = min(stage_atoms, a_end - base);
      __syncthreads();  // the previous stage's tables are read
      for (int e = threadIdx.x; e < 3 * count; e += blockDim.x) {
        const int a = e / 3;
        const int axis = e - 3 * a;
        reduced_coordinate<kExact>(
            pos[static_cast<long long>(base + a) * 3 + axis],
            axis == 0 ? lx : axis == 1 ? ly : lz, s_u + 2 * e);
      }
      __syncthreads();
      int a = threadIdx.x / rows;
      int row = threadIdx.x - a * rows;
      while (a < count) {
        int axis, n;
        float* dst;
        if (row < tx) {
          axis = 0;
          n = x0 + row;
          dst = s_x + 2 * (a * tx + row);
        } else if (row < tx + y_rows) {
          const int r = row - tx;
          axis = 1;
          n = yg0 * kR + r;
          dst = s_y + (a * tyg + r / kR) * kYStride + 2 * (r % kR);
        } else {
          const int r = row - tx - y_rows;
          axis = 2;
          n = zg0 * kC + r;
          dst = s_z + (a * tzg + r / kC) * kZStride + 2 * (r % kC);
        }
        // Rows past K (the box's ragged edge) are tabled like the others
        // and summed by no written tile.
        float c, s;
        axis_entry<kExact>(static_cast<float>(n), s_u + 2 * (3 * a + axis),
                           two_pi_hi, two_pi_lo, &c, &s);
        if (kWeights && axis == 2) {
          const float w = weights[base + a];
          c = __fmul_rn(c, w);
          s = __fmul_rn(s, w);
        }
        dst[0] = c;
        dst[1] = s;
        a += step_a;
        row += step_row;
        if (row >= rows) {
          row -= rows;
          ++a;
        }
      }
      __syncthreads();
      if (!active) continue;
      // The stage's sums, added to the slice's once the stage is done.
      float st_re[kR][kC], st_im[kR][kC];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          st_re[r][c] = 0.0f;
          st_im[r][c] = 0.0f;
        }
      }
      for (int j = 0; j < count; ++j) {
        const float2 xv = reinterpret_cast<const float2*>(s_x)[j * tx + ix];
        const float4* yp = reinterpret_cast<const float4*>(
            s_y + (j * tyg + iyg) * kYStride);
        float cxy[kR], sxy[kR];
#pragma unroll
        for (int h = 0; h < kR / 2; ++h) {
          const float4 yv = yp[h];  // (cos, sin) of rows 2h and 2h + 1
          cxy[2 * h] = __fmaf_rn(xv.x, yv.x, -__fmul_rn(xv.y, yv.y));
          sxy[2 * h] = __fmaf_rn(xv.y, yv.x, __fmul_rn(xv.x, yv.y));
          cxy[2 * h + 1] = __fmaf_rn(xv.x, yv.z, -__fmul_rn(xv.y, yv.w));
          sxy[2 * h + 1] = __fmaf_rn(xv.y, yv.z, __fmul_rn(xv.x, yv.w));
        }
        const float4* zp = reinterpret_cast<const float4*>(
            s_z + (j * tzg + izg) * kZStride);
#pragma unroll
        for (int h = 0; h < kC / 2; ++h) {
          const float4 zv = zp[h];  // (cos, sin) of columns 2h and 2h + 1
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            float* sr = st_re[r];
            float* si = st_im[r];
            sr[2 * h] = __fmaf_rn(cxy[r], zv.x, sr[2 * h]);
            sr[2 * h] = __fmaf_rn(-sxy[r], zv.y, sr[2 * h]);
            si[2 * h] = __fmaf_rn(cxy[r], zv.y, si[2 * h]);
            si[2 * h] = __fmaf_rn(sxy[r], zv.x, si[2 * h]);
            sr[2 * h + 1] = __fmaf_rn(cxy[r], zv.z, sr[2 * h + 1]);
            sr[2 * h + 1] = __fmaf_rn(-sxy[r], zv.w, sr[2 * h + 1]);
            si[2 * h + 1] = __fmaf_rn(cxy[r], zv.w, si[2 * h + 1]);
            si[2 * h + 1] = __fmaf_rn(sxy[r], zv.z, si[2 * h + 1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          re[r][c] = __fadd_rn(re[r][c], st_re[r][c]);
          im[r][c] = __fadd_rn(im[r][c], st_im[r][c]);
        }
      }
    }
    if (!active) continue;
    const long long x = x0 + ix;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int y = (yg0 + iyg) * kR + r;
      if (y >= ky) continue;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int z = (zg0 + izg) * kC + c;
        if (z >= kz) continue;
        const long long g = (x * ky + y) * kz + z;
        out[g] = re[r][c];
        out[n_grid + g] = im[r][c];
      }
    }
  }
}

// out[b, q] = the sum over slices, in slice order, of the partial sums at
// grid point flat_idx[q] (q itself without flat_idx), rounded once to
// float32; NaN for an index outside the grid.
__global__ void __launch_bounds__(kReduce)
factor_sums_reduce(const float* __restrict__ partial,
                   const long long* __restrict__ flat_idx,
                   float* __restrict__ cos_out, float* __restrict__ sin_out,
                   int n_frames, int n_q, long long n_grid, int n_slices) {
  const long long total = static_cast<long long>(n_frames) * n_q;
  for (int t = threadIdx.x; t < kReduce; t += blockDim.x) {
    const long long i = static_cast<long long>(blockIdx.x) * kReduce + t;
    if (i >= total) continue;
    const long long frame = i / n_q;
    const long long q = i - frame * n_q;
    const long long g = flat_idx ? flat_idx[q] : q;
    if (g < 0 || g >= n_grid) {
      cos_out[i] = sin_out[i] = nanf("");
      continue;
    }
    double c = 0.0, s = 0.0;
    for (int k = 0; k < n_slices; ++k) {
      const float* part =
          partial + (static_cast<long long>(k) * n_frames + frame) * 2 *
                        n_grid;
      c += static_cast<double>(part[g]);
      s += static_cast<double>(part[n_grid + g]);
    }
    cos_out[i] = static_cast<float>(c);
    sin_out[i] = static_cast<float>(s);
  }
}

template <bool kExact, bool kWeights>
int launch(const void* positions, const void* weights, void* partial,
           int n_frames, int n_atoms, int kx, int ky, int kz, int tx, int tyg,
           int tzg, int tiles, int tiles_y, int tiles_z, int threads,
           int split_atoms, int n_slices, int stage_atoms, float lx, float ly,
           float lz, float two_pi_hi, float two_pi_lo, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(stage_atoms) *
      (tyg * kYStride + tzg * kZStride + 2 * tx + 6) * sizeof(float);
  const dim3 grid(static_cast<unsigned int>(tiles),
                  static_cast<unsigned int>(n_slices),
                  static_cast<unsigned int>(n_frames));
  factor_sums_kernel<kExact, kWeights><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(positions),
      static_cast<const float*>(weights), static_cast<float*>(partial),
      n_frames, n_atoms, kx, ky, kz, tx, tyg, tzg, tiles_y, tiles_z, threads,
      split_atoms, stage_atoms, lx, ly, lz, two_pi_hi, two_pi_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `positions` is
// (n_frames, n_atoms, 3) float32, `weights` (n_atoms,) float32 (or null: no
// multiplication), `flat_idx` (n_q,) int64 grid indices below kx ky kz (or
// null: n_q is kx ky kz, in grid order), `partial` a float32 scratch of
// (ceil(n_atoms / split_atoms), n_frames, 2, kx ky kz), `cos_out` and
// `sin_out` (n_frames, n_q) float32.  The box of a block is tx x tyg x tzg
// tiles (at most 256, `threads` rounded up to a warp) and the grid holds
// `tiles` = tiles_x tiles_y tiles_z boxes; `split_atoms` is a multiple of
// `stage_atoms`, whose tables take at most 48 KB of shared memory; `lx`,
// `ly`, `lz` the box lengths, `two_pi_hi`, `two_pi_lo` the double-float
// 2 pi.  n_frames, n_atoms and every extent are at least 1.  Returns
// cudaGetLastError() after each launch, the first that fails.
extern "C" int factor_sums_launch(
    const void* positions, const void* weights, const void* flat_idx,
    void* partial, void* cos_out, void* sin_out, int n_frames, int n_atoms,
    int kx, int ky, int kz, int n_q, int tx, int tyg, int tzg, int tiles_y,
    int tiles_z, int tiles, int threads, int split_atoms, int stage_atoms,
    int exact, float lx, float ly, float lz, float two_pi_hi,
    float two_pi_lo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_slices = (n_atoms + split_atoms - 1) / split_atoms;
  int status;
  if (exact && weights) {
    status = launch<true, true>(positions, weights, partial, n_frames,
                                n_atoms, kx, ky, kz, tx, tyg, tzg, tiles,
                                tiles_y, tiles_z, threads, split_atoms,
                                n_slices, stage_atoms, lx, ly, lz, two_pi_hi,
                                two_pi_lo, s);
  } else if (exact) {
    status = launch<true, false>(positions, weights, partial, n_frames,
                                 n_atoms, kx, ky, kz, tx, tyg, tzg, tiles,
                                 tiles_y, tiles_z, threads, split_atoms,
                                 n_slices, stage_atoms, lx, ly, lz,
                                 two_pi_hi, two_pi_lo, s);
  } else if (weights) {
    status = launch<false, true>(positions, weights, partial, n_frames,
                                 n_atoms, kx, ky, kz, tx, tyg, tzg, tiles,
                                 tiles_y, tiles_z, threads, split_atoms,
                                 n_slices, stage_atoms, lx, ly, lz,
                                 two_pi_hi, two_pi_lo, s);
  } else {
    status = launch<false, false>(positions, weights, partial, n_frames,
                                  n_atoms, kx, ky, kz, tx, tyg, tzg, tiles,
                                  tiles_y, tiles_z, threads, split_atoms,
                                  n_slices, stage_atoms, lx, ly, lz,
                                  two_pi_hi, two_pi_lo, s);
  }
  if (status != 0) return status;
  const long long n_grid = static_cast<long long>(kx) * ky * kz;
  const long long total = static_cast<long long>(n_frames) * n_q;
  const dim3 grid(static_cast<unsigned int>((total + kReduce - 1) / kReduce),
                  1, 1);
  factor_sums_reduce<<<grid, kReduce, 0, s>>>(
      static_cast<const float*>(partial),
      static_cast<const long long*>(flat_idx), static_cast<float*>(cos_out),
      static_cast<float*>(sin_out), n_frames, n_q, n_grid, n_slices);
  return static_cast<int>(cudaGetLastError());
}
