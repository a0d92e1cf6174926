// Per-wavevector trig sums of B frames: the port of _trig_kernel, launched
// from trig_sums in mdhelper_tpu/ops/pallas_kernels.py.
//
// What it computes.  For each frame b and wavevector q,
//   cos_out[b, q] = sum_j w_j cos(q . r_bj),  sin_out[b, q] = sum_j w_j sin(..)
// in one of two precisions:
//   fast   the float32 phase q_x x + q_y y + q_z z, left to right with no
//          FMA (the Pallas body's order), then cos and sin;
//   exact  the arithmetic of the plain version's _exact_phases
//          (ops/scattering.py) operation for operation: each component
//          q_k r_k formed error-free (two_prod; with the low words of
//          float64 wavevectors, t.lo += qlo_k r_k), summed with df_add,
//          reduced by rint(hi / 2pi_hi) turns of the double-float 2 pi
//          through df_sub; then cos(hi), sin(hi) and the first-order
//          correction cos = cos_hi - lo sin_hi, sin = sin_hi + lo cos_hi.
//          Splitting each factor once (the wavevector by its thread, the
//          coordinate by the thread that stages it) and multiplying with
//          two_prod_split is two_prod's arithmetic with its splits hoisted,
//          so every rounding is the plain version's.
// Weights (zero on padding) multiply each term; without weights nothing is
// multiplied (the JAX kernel multiplies by 1).  Trig is the precise
// sincosf: no __sinf/__cosf and no --use_fast_math (fast-mode phases reach
// hundreds of radians, where the approximations lose every digit); the
// library is built with --fmad=false and every product and sum is spelled
// with the round-to-nearest intrinsics, so nothing is contracted.
//
// The sum over atoms.  At 100k atoms a sum of magnitude about sqrt(N) ~ 316
// is built from 10^5 terms of magnitude 1; a float32 running sum loses about
// 1e-5 to 1e-4 of it, the S(q) tolerance at low q.  So each thread adds its
// terms into float64 accumulators (two conversions and two float64 adds a
// term, cheap beside the exact term's ~120 float32 operations), each block
// covers a fixed slice of split_atoms atoms and writes its float64 partial
// sums, and a second kernel adds the slices' partials in slice order and
// rounds once to float32.  No atomics anywhere: two launches on the same
// input give the same bits.  What the float64 sum cannot remove is the
// terms' own error: float32 cosf and sinf round with a mean that is not zero
// over uniform phases (about 1e-9 a term on an H100), so the exact sums'
// error grows as N while the S(q) tolerance grows as sqrt(N).
//
// What bounds it on the card: operations.  One (q, atom) term, counted from
// this source as csrc/cell_bin.cuh counts (float32 adds, subtractions,
// multiplications, divisions, rint; the float64 adds and conversions count
// one each; work done once per staged atom or per wavevector is not counted
// a term), with sincosf counted as below:
//   exact  3 two_prod_split 27 + 3 low-word products 6 (with float64
//          wavevectors) + 2 df_add 28 + division and rint 2 + split of the
//          turns 4 + two_prod_split 9 + low part 2 + df_sub 14 + sincosf +
//          correction 4 + weights 2 + accumulation 4 = 102 + sincosf
//          (94 without low words and without weights);
//   fast   3 mul + 2 add 5 + sincosf + weights 2 + accumulation 4 = 11 +
//          sincosf (9 without weights).
// sincosf counts 20: the float instructions on its path for arguments under
// 105615 in the SASS of sm_90a (scripts/sincos_sass.py: the multiply by
// 2/pi, the range compare, two conversions, three FFMAs of the Cody-Waite
// reduction, the square, eight FFMAs of the two polynomials, four selects);
// the Payne-Hanek path of larger arguments never runs here.  The bytes
// (positions read once, the sums written once) are negligible: at the
// smoke's 100k atoms x 13,824 float64 wavevectors x 2 frames, 2.8e9 terms of
// 120 (exact) or 29 (fast) operations against 2.5 MB.
//
// This first design: one thread per wavevector of a 128-wavevector tile, a
// block per (tile, atom slice of split_atoms, frame); the block stages 256
// atoms at a time in shared memory (coordinates, weight and, in exact mode,
// their Dekker splits), and every thread of a warp reads the same atom (a
// broadcast).  Its float64 accumulators live in shared memory between
// staging steps, so a block of any width (one thread, as the CPU rehearsal
// in scripts/check_kernel_modes.py runs it) covers its tile.  Tensor cores
// (the q . r product as a wgmma) and TMA staging are later work.

#include <cuda_runtime.h>

#include "doublefloat.cuh"

namespace {

using dfloat::df;

constexpr int kQ = 128;      // wavevectors a block (one a thread on the card)
constexpr int kStage = 256;  // atoms staged in shared memory a step
constexpr int kReduce = 256;  // sums a block of the reduction

template <bool kExact, bool kLo, bool kWeights>
__global__ void __launch_bounds__(kQ)
trig_sums_kernel(const float* __restrict__ positions,
                 const float* __restrict__ qs,
                 const float* __restrict__ qs_lo,
                 const float* __restrict__ weights,
                 double* __restrict__ partial, int n_frames, int n_atoms,
                 int n_q, int split_atoms, float two_pi_hi,
                 float two_pi_lo) {
  extern __shared__ unsigned char smem[];
  double* acc = reinterpret_cast<double*>(smem);           // [2][kQ]
  float4* s_pos = reinterpret_cast<float4*>(acc + 2 * kQ);  // x, y, z, w
  float4* s_xy = s_pos + kStage;  // splits of x and y: hi, lo, hi, lo
  float4* s_z = s_xy + kStage;    // split of z: hi, lo

  const int q0 = blockIdx.x * kQ;
  const int slice = blockIdx.y;
  const int frame = blockIdx.z;
  const int a_begin = slice * split_atoms;
  const int a_end = min(n_atoms, a_begin + split_atoms);
  const float* pos = positions + static_cast<long long>(frame) * n_atoms * 3;
  const df pi_split = dfloat::split(two_pi_hi);

  for (int t = threadIdx.x; t < 2 * kQ; t += blockDim.x) acc[t] = 0.0;
  for (int base = a_begin; base < a_end; base += kStage) {
    const int count = min(kStage, a_end - base);
    __syncthreads();  // the previous step's atoms are read
    for (int s = threadIdx.x; s < count; s += blockDim.x) {
      const float* p = pos + static_cast<long long>(base + s) * 3;
      const float w = kWeights ? weights[base + s] : 1.0f;
      s_pos[s] = {p[0], p[1], p[2], w};
      if constexpr (kExact) {
        const df sx = dfloat::split(p[0]);
        const df sy = dfloat::split(p[1]);
        const df sz = dfloat::split(p[2]);
        s_xy[s] = {sx.hi, sx.lo, sy.hi, sy.lo};
        s_z[s] = {sz.hi, sz.lo, 0.0f, 0.0f};
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kQ; t += blockDim.x) {
      // Threads past the last wavevector compute the last one and write
      // nothing.
      const int q = min(q0 + t, n_q - 1);
      const float qx = qs[3 * q], qy = qs[3 * q + 1], qz = qs[3 * q + 2];
      float lx = 0.0f, ly = 0.0f, lz = 0.0f;
      if constexpr (kLo) {
        lx = qs_lo[3 * q];
        ly = qs_lo[3 * q + 1];
        lz = qs_lo[3 * q + 2];
      }
      const df qxs = dfloat::split(qx);
      const df qys = dfloat::split(qy);
      const df qzs = dfloat::split(qz);
      double c_acc = acc[t];
      double s_acc = acc[kQ + t];
      for (int s = 0; s < count; ++s) {
        const float4 p = s_pos[s];
        float c, sn;
        if constexpr (kExact) {
          const float4 xy = s_xy[s];
          const float4 z = s_z[s];
          df t0 = dfloat::two_prod_split(qx, qxs, p.x, {xy.x, xy.y});
          df t1 = dfloat::two_prod_split(qy, qys, p.y, {xy.z, xy.w});
          df t2 = dfloat::two_prod_split(qz, qzs, p.z, {z.x, z.y});
          if constexpr (kLo) {
            t0.lo = __fadd_rn(t0.lo, __fmul_rn(lx, p.x));
            t1.lo = __fadd_rn(t1.lo, __fmul_rn(ly, p.y));
            t2.lo = __fadd_rn(t2.lo, __fmul_rn(lz, p.z));
          }
          const df phase = dfloat::df_add(dfloat::df_add(t0, t1), t2);
          // Rounding trap: jnp.round / torch.round round half to even, as
          // rintf does; IEEE division, never the approximation.
          const float turns = rintf(__fdiv_rn(phase.hi, two_pi_hi));
          const df corr = dfloat::two_prod_split(
              turns, dfloat::split(turns), two_pi_hi, pi_split);
          const df r = dfloat::df_sub(
              phase, {corr.hi, __fadd_rn(corr.lo, __fmul_rn(turns, two_pi_lo))});
          float sin_hi, cos_hi;
          sincosf(r.hi, &sin_hi, &cos_hi);
          c = __fsub_rn(cos_hi, __fmul_rn(r.lo, sin_hi));
          sn = __fadd_rn(sin_hi, __fmul_rn(r.lo, cos_hi));
        } else {
          const float phase =
              __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                        __fmul_rn(qz, p.z));
          sincosf(phase, &sn, &c);
        }
        if constexpr (kWeights) {
          c = __fmul_rn(c, p.w);
          sn = __fmul_rn(sn, p.w);
        }
        c_acc += static_cast<double>(c);
        s_acc += static_cast<double>(sn);
      }
      acc[t] = c_acc;
      acc[kQ + t] = s_acc;
    }
  }
  __syncthreads();
  // partial is (n_slices, n_frames, 2, n_q): this slice's cos, then sin.
  double* out =
      partial + (static_cast<long long>(slice) * n_frames + frame) * 2 * n_q;
  for (int t = threadIdx.x; t < kQ; t += blockDim.x) {
    const int q = q0 + t;
    if (q < n_q) {
      out[q] = acc[t];
      out[n_q + q] = acc[kQ + t];
    }
  }
}

// out[b, q] = sum over slices, in slice order, rounded once to float32.
__global__ void __launch_bounds__(kReduce)
trig_sums_reduce(const double* __restrict__ partial,
                 float* __restrict__ cos_out, float* __restrict__ sin_out,
                 int n_frames, int n_q, int n_slices) {
  const long long total = static_cast<long long>(n_frames) * n_q;
  for (int t = threadIdx.x; t < kReduce; t += blockDim.x) {
    const long long i = static_cast<long long>(blockIdx.x) * kReduce + t;
    if (i >= total) continue;
    const long long frame = i / n_q;
    const long long q = i - frame * n_q;
    double c = 0.0, s = 0.0;
    for (int k = 0; k < n_slices; ++k) {
      const double* row = partial + (k * n_frames + frame) * 2 * n_q;
      c += row[q];
      s += row[n_q + q];
    }
    cos_out[i] = static_cast<float>(c);
    sin_out[i] = static_cast<float>(s);
  }
}

template <bool kExact, bool kLo, bool kWeights>
int launch(const void* positions, const void* qs, const void* qs_lo,
           const void* weights, void* partial, int n_frames, int n_atoms,
           int n_q, int split_atoms, int n_slices, float two_pi_hi,
           float two_pi_lo, cudaStream_t stream) {
  const size_t smem = 2 * kQ * sizeof(double) + 3 * kStage * sizeof(float4);
  const dim3 grid(static_cast<unsigned int>((n_q + kQ - 1) / kQ),
                  static_cast<unsigned int>(n_slices),
                  static_cast<unsigned int>(n_frames));
  trig_sums_kernel<kExact, kLo, kWeights><<<grid, kQ, smem, stream>>>(
      static_cast<const float*>(positions), static_cast<const float*>(qs),
      static_cast<const float*>(qs_lo), static_cast<const float*>(weights),
      static_cast<double*>(partial), n_frames, n_atoms, n_q, split_atoms,
      two_pi_hi, two_pi_lo);
  return static_cast<int>(cudaGetLastError());
}

template <bool kExact, bool kLo>
int launch_weights(const void* weights, const void* positions,
                   const void* qs, const void* qs_lo, void* partial,
                   int n_frames, int n_atoms, int n_q, int split_atoms,
                   int n_slices, float two_pi_hi, float two_pi_lo,
                   cudaStream_t stream) {
  if (weights) {
    return launch<kExact, kLo, true>(positions, qs, qs_lo, weights, partial,
                                     n_frames, n_atoms, n_q, split_atoms,
                                     n_slices, two_pi_hi, two_pi_lo, stream);
  }
  return launch<kExact, kLo, false>(positions, qs, qs_lo, weights, partial,
                                    n_frames, n_atoms, n_q, split_atoms,
                                    n_slices, two_pi_hi, two_pi_lo, stream);
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `positions` is
// (n_frames, n_atoms, 3) float32, `qs` (n_q, 3) float32 wavevectors and
// `qs_lo` their low words (or null; read in exact mode only), `weights`
// (n_atoms,) float32 (or null: no multiplication), `partial` a float64
// scratch of (ceil(n_atoms / split_atoms), n_frames, 2, n_q), and
// `cos_out`, `sin_out` (n_frames, n_q) float32.  `split_atoms` is a multiple
// of 256; `two_pi_hi`, `two_pi_lo` the double-float 2 pi.  n_atoms and n_q
// are at least 1.  Returns cudaGetLastError() of the first failing launch.
extern "C" int trig_sums_launch(const void* positions, const void* qs,
                                const void* qs_lo, const void* weights,
                                void* partial, void* cos_out, void* sin_out,
                                int n_frames, int n_atoms, int n_q,
                                int split_atoms, int exact, float two_pi_hi,
                                float two_pi_lo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_slices = (n_atoms + split_atoms - 1) / split_atoms;
  int status;
  if (!exact) {
    status = launch_weights<false, false>(
        weights, positions, qs, qs_lo, partial, n_frames, n_atoms, n_q,
        split_atoms, n_slices, two_pi_hi, two_pi_lo, s);
  } else if (qs_lo) {
    status = launch_weights<true, true>(
        weights, positions, qs, qs_lo, partial, n_frames, n_atoms, n_q,
        split_atoms, n_slices, two_pi_hi, two_pi_lo, s);
  } else {
    status = launch_weights<true, false>(
        weights, positions, qs, qs_lo, partial, n_frames, n_atoms, n_q,
        split_atoms, n_slices, two_pi_hi, two_pi_lo, s);
  }
  if (status != 0) return status;
  const long long total = static_cast<long long>(n_frames) * n_q;
  const dim3 grid(static_cast<unsigned int>((total + kReduce - 1) / kReduce),
                  1, 1);
  trig_sums_reduce<<<grid, kReduce, 0, s>>>(
      static_cast<const double*>(partial), static_cast<float*>(cos_out),
      static_cast<float*>(sin_out), n_frames, n_q, n_slices);
  return static_cast<int>(cudaGetLastError());
}
