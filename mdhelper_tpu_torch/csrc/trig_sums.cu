// Per-wavevector trig sums of B frames: the port of _trig_kernel, launched
// from trig_sums in mdhelper_tpu/ops/pallas_kernels.py.
//
// What it computes.  For each frame b and wavevector q,
//   cos_out[b, q] = sum_j w_j cos(q . r_bj),  sin_out[b, q] = sum_j w_j sin(..)
// in one of two precisions:
//   fast   the float32 phase fma(q_z, z, fma(q_y, y, q_x x)), then cos and
//          sin (the plain version takes a float32 matmul: the two differ by
//          float32 roundings of phases of hundreds of radians, well inside
//          the fast tolerance);
//   exact  the arithmetic of the plain version's _exact_phases
//          (ops/scattering.py): each component q_k r_k formed error-free
//          (exact_prod; with the low words of float64 wavevectors, t.lo +=
//          qlo_k r_k), summed with df_add, reduced by rint(hi / 2pi_hi)
//          turns of the double-float 2 pi through df_sub; then cos(hi),
//          sin(hi) and the first-order correction cos = cos_hi - lo sin_hi,
//          sin = sin_hi + lo cos_hi.  The reduced phases are the plain
//          version's bit for bit (below), so are the terms.
// Weights (zero on padding) multiply each term; without weights nothing is
// multiplied (the JAX kernel multiplies by 1).  Trig is the precise
// sincosf: no __sinf/__cosf and no --use_fast_math (fast-mode phases reach
// hundreds of radians, where the approximations lose every digit); the
// library is built with --fmad=false and every product and sum is spelled
// with the round-to-nearest intrinsics, so nothing is contracted.
//
// Why the exact phase keeps the plain version's bits.
// 1. The products.  exact_prod (doublefloat.cuh) gives Dekker's error term
//    whenever the product is zero or at least 2^-101 and both factors are
//    below 2^115.  Here the factors are wavevector components (|q| about
//    0.01-100 per A), coordinates (|r| below 10^4 A), and the turns
//    (integers below 2^24) times 2pi_hi: a non-zero product is at least
//    1e-2 * the smallest coordinate, so the proof holds unless a coordinate
//    or a wavevector component is non-zero and below about 1e-28 (a float
//    that no trajectory writes).  A zero factor gives +0 in both, with
//    either sign of zero (tests/test_torch_kernel_math.py holds the two on
//    these magnitudes, zeros of both signs included).
// 2. The turns without a division.  z = phase.hi / 2pi_hi (real), q =
//    fl(z) the plain version's quotient, y = fl(phase.hi * inv) with inv =
//    fl(1 / 2pi_hi): |q - z| <= u |z| and y = z (1 + d1)(1 + d2), |d1|,
//    |d2| <= u = 2^-24, so |y - q| <= (3u + u^2) |z| < 2^-22 |y|.  rint(y)
//    and rint(q) can differ only if a half-integer h lies between them
//    (ties included), and then the distance from y to its nearest
//    half-integer, 0.5 - |y - rint(y)|, is at most |y - q| < 2^-22 |y|.
//    So the kernel takes rint(y) unless 0.5 - |y - rint(y)| <= 2^-20 |y|
//    (a margin of 4 for the roundings of that test: y - rint(y) is exact,
//    0.5 - |d| is exact where it can be that small, the product by 2^-20
//    is exact), and then the IEEE division, as the plain version does.
//    About one term in 2^18 / |y| takes it; the turns are the same floats,
//    sign of zero included (y and q have the sign of phase.hi).
//    tests/test_torch_kernel_math.py checks the rule on +-8 ulps of every
//    half-integer multiple of 2pi_hi up to 10^4 rad.
//
// The sum over atoms.  At 100k atoms a sum of magnitude about sqrt(N) ~ 316
// is built from 10^5 terms of magnitude 1; a float32 running sum loses about
// 1e-5 to 1e-4 of it, the S(q) tolerance at low q.  Each thread sums the
// terms of one staging step (256 atoms) in float32 and folds that partial
// into float64 accumulators once a step (two conversions and two float64
// adds a step, none a term):
//   exact  a compensated pair: s, e = two_sum(s, t) and c += e (Ogita, Rump
//          and Oishi's Sum2), so s + c is the step's exact sum but for the
//          roundings of c, at most about (n u)^2 sum |t| over n = 256 terms
//          and in practice (random signs) below 1e-12 of a unit term; the
//          fold adds s, then c.  Over 10^5 atoms the sum's error stays near
//          1e-10, far below half a float32 ulp of sums of order 1-1000, so
//          the float32 result is the correctly rounded sum, as the plain
//          version's float64 sum is, save for sums within about 1e-10 of a
//          rounding boundary (tests/test_torch_kernel_math.py models the
//          accumulation in numpy and matches math.fsum rounded to float32
//          on every sum of the test);
//   fast   a plain float32 running sum a step: about u sqrt(n) |s| a step,
//          some 1e-4 in all over 10^5 atoms, under 1e-6 of the mean
//          amplitude (about 280) against the fast tolerance of 1e-4 of it.
// Each block covers a fixed slice of split_atoms atoms and writes its
// float64 partial sums; a second kernel adds the slices' partials in slice
// order and rounds once to float32.  No atomics anywhere: two launches on
// the same input give the same bits.  What the float64 fold cannot remove
// is the terms' own error: float32 cosf and sinf round with a mean that is
// not zero over uniform phases (about 1e-9 a term on an H100), so the exact
// sums' error grows as N while the S(q) tolerance grows as sqrt(N).
//
// What bounds it on the card: operations.  One (q, atom) term, counted from
// this source (float32 adds, subtractions, multiplications, rint, compares;
// an FMA counts two, as the 67 TFLOP/s peak counts it; work done once a
// staging step, a staged atom or a wavevector is not counted a term):
//   exact  3 exact_prod 9 + 3 low-word products 6 (with float64
//          wavevectors) + 2 df_add 28 + the turns 6 (mul, rint, the tie
//          test: 2 sub, mul, compare) + exact_prod of the turns 3 + low part
//          2 + df_sub 14 + sincosf + correction 4 + weights 2 + accumulation
//          14 (2 x (two_sum 6 + add)) = 88 + sincosf issued (80 without low
//          words and without weights);
//   fast   mul + 2 FMA 5 + sincosf + weights 2 + accumulation 2 = 9 +
//          sincosf (7 without weights).
// The bound counts what the function needs, not this design's overhead:
// the turns as a mul and a rint (2, not 6) and the exact sum as 4 a term
// (two adds into a wider sum, as the first count's float64 fold; not the
// compensated pair's 14), so exact 74 + sincosf (66 without low words and
// without weights), fast as issued.
// sincosf counts 31: the 20 float instructions on its path for arguments
// under 105615 in the SASS of sm_90a, 11 of them FFMAs
// (scripts/sincos_sass.py: the multiply by 2/pi, the range compare, two
// conversions, three FFMAs of the Cody-Waite reduction, the square, eight
// FFMAs of the two polynomials, four selects); the Payne-Hanek path of
// larger arguments never runs here.  The bytes (positions read once, the
// sums written once) are negligible: at the smoke's 100k atoms x 13,824
// float64 wavevectors x 2 frames, 2.8e9 terms of 103 (exact) or 38 (fast)
// operations against 2.5 MB.  The first design counted 120 and 29 (an FMA
// as one, sincosf 20, a float64 add or conversion one) and took about 176
// and 51 issue slots a term (7.240 and 2.145 ms a frame on an NVIDIA H100
// 80GB HBM3 at 700 W): a float64 conversion and add per term and sum
// (conversions run at 16 a clock an SM against 128 float32 adds), Dekker
// products of split factors, and an IEEE division subroutine a term.
//
// This second design: a block of 128 threads per 256-wavevector tile, each
// thread two wavevectors (q0 + t and q0 + 128 + t: a warp's loads stay
// contiguous), so one broadcast shared load of a staged atom (x, y, z, w:
// one float4) feeds two terms; a block per (tile, atom slice of
// split_atoms, frame), staging 256 atoms a step.  The float64 accumulators
// stay in registers across staging steps (ptxas: 48-56 registers, no
// spills; the 32-byte stack frame is sincosf's Payne-Hanek buffer, as in
// the first design): each thread's whole sweep sits inside one pass of a
// loop over the block's threads that runs once on the card (blockDim.x ==
// 128) and once per thread in the CPU rehearsal of
// scripts/check_kernel_modes.py (one thread a block, which stages each step
// again for every thread).  Two wavevectors a thread and the wrapper's
// slices of 2,048 atoms ran a few per cent faster on the card than one or
// four wavevectors and slices of 1,024 or 4,096 atoms; to retune, edit kQT
// or _TRIG_SLICE_ATOMS and rerun scripts/compare_op_designs.py, which times
// the tree beside the first design.  The second kernel, which adds
// the slices' float64 partials in order, stays: at 100k atoms it reads
// 49 x 2 frames x 2 x 13,824 partials (21.7 MB, under 0.01 ms at the
// memory rate) against some 11 ms a launch, and it keeps the sums free of
// atomics.  Tensor cores (the q . r product as a wgmma) and TMA staging are
// left out: the exact phase needs the error-free float32 products, and a
// staging step is 256 float4 loads against 512 terms of about 130 issued
// instructions a thread (sm_90a SASS of the exact loop, the double-float
// adds alone 61 a term).

#include <cuda_runtime.h>

#include "doublefloat.cuh"

namespace {

using dfloat::df;

constexpr int kThreads = 128;          // threads a block
constexpr int kQT = 2;                 // wavevectors a thread
constexpr int kQ = kThreads * kQT;     // wavevectors a block
constexpr int kStage = 256;            // atoms staged in shared memory a step
constexpr int kReduce = 256;           // sums a block of the reduction
// 2^-20: the tie test's margin (the note: |y - q| < 2^-22 |y|).
constexpr float kTieMargin = 9.5367431640625e-07f;

// The range-reduced exact phase of one term, as _exact_phases: the turns
// rint(fl(hi / 2pi_hi)) from the product by inv = fl(1 / 2pi_hi), with the
// IEEE division only where the product lies near a half-integer.
template <bool kLo>
__device__ __forceinline__ df exact_phase(float qx, float qy, float qz,
                                          float lx, float ly, float lz,
                                          float4 p, float two_pi_hi,
                                          float two_pi_lo, float inv) {
  df t0 = dfloat::exact_prod(qx, p.x);
  df t1 = dfloat::exact_prod(qy, p.y);
  df t2 = dfloat::exact_prod(qz, p.z);
  if constexpr (kLo) {
    t0.lo = __fadd_rn(t0.lo, __fmul_rn(lx, p.x));
    t1.lo = __fadd_rn(t1.lo, __fmul_rn(ly, p.y));
    t2.lo = __fadd_rn(t2.lo, __fmul_rn(lz, p.z));
  }
  const df phase = dfloat::df_add(dfloat::df_add(t0, t1), t2);
  // Rounding trap: jnp.round / torch.round round half to even, as rintf
  // does.
  const float y = __fmul_rn(phase.hi, inv);
  float turns = rintf(y);
  if (__fsub_rn(0.5f, fabsf(__fsub_rn(y, turns))) <=
      __fmul_rn(fabsf(y), kTieMargin)) {
    turns = rintf(__fdiv_rn(phase.hi, two_pi_hi));
  }
  const df corr = dfloat::exact_prod(turns, two_pi_hi);
  return dfloat::df_sub(
      phase, {corr.hi, __fadd_rn(corr.lo, __fmul_rn(turns, two_pi_lo))});
}

template <bool kExact, bool kLo, bool kWeights>
__global__ void __launch_bounds__(kThreads)
trig_sums_kernel(const float* __restrict__ positions,
                 const float* __restrict__ qs,
                 const float* __restrict__ qs_lo,
                 const float* __restrict__ weights,
                 double* __restrict__ partial, int n_frames, int n_atoms,
                 int n_q, int split_atoms, float two_pi_hi,
                 float two_pi_lo) {
  extern __shared__ unsigned char smem[];
  float4* s_pos = reinterpret_cast<float4*>(smem);  // x, y, z, w

  const int q0 = blockIdx.x * kQ;
  const int slice = blockIdx.y;
  const int frame = blockIdx.z;
  const int a_begin = slice * split_atoms;
  const int a_end = min(n_atoms, a_begin + split_atoms);
  const float* pos = positions + static_cast<long long>(frame) * n_atoms * 3;
  const float inv = __fdiv_rn(1.0f, two_pi_hi);
  // partial is (n_slices, n_frames, 2, n_q): this slice's cos, then sin.
  double* out =
      partial + (static_cast<long long>(slice) * n_frames + frame) * 2 * n_q;

  // One pass on the card (blockDim.x == kThreads); the rehearsal's single
  // thread takes every pass.
  for (int t = threadIdx.x; t < kThreads; t += blockDim.x) {
    float qx[kQT], qy[kQT], qz[kQT], lx[kQT], ly[kQT], lz[kQT];
    double c_acc[kQT], s_acc[kQT];
#pragma unroll
    for (int k = 0; k < kQT; ++k) {
      // Threads past the last wavevector compute the last one and write
      // nothing.
      const int q = min(q0 + t + k * kThreads, n_q - 1);
      qx[k] = qs[3 * q];
      qy[k] = qs[3 * q + 1];
      qz[k] = qs[3 * q + 2];
      lx[k] = kLo ? qs_lo[3 * q] : 0.0f;
      ly[k] = kLo ? qs_lo[3 * q + 1] : 0.0f;
      lz[k] = kLo ? qs_lo[3 * q + 2] : 0.0f;
      c_acc[k] = 0.0;
      s_acc[k] = 0.0;
    }
    for (int base = a_begin; base < a_end; base += kStage) {
      const int count = min(kStage, a_end - base);
      __syncthreads();  // the previous step's atoms are read
      for (int s = threadIdx.x; s < count; s += blockDim.x) {
        const float* p = pos + static_cast<long long>(base + s) * 3;
        s_pos[s] = {p[0], p[1], p[2], kWeights ? weights[base + s] : 1.0f};
      }
      __syncthreads();
      // This step's float32 sums and, exact, their compensations.
      float c_sum[kQT], s_sum[kQT], c_comp[kQT], s_comp[kQT];
#pragma unroll
      for (int k = 0; k < kQT; ++k) {
        c_sum[k] = s_sum[k] = c_comp[k] = s_comp[k] = 0.0f;
      }
      for (int s = 0; s < count; ++s) {
        const float4 p = s_pos[s];
#pragma unroll
        for (int k = 0; k < kQT; ++k) {
          float c, sn;
          if constexpr (kExact) {
            const df r = exact_phase<kLo>(qx[k], qy[k], qz[k], lx[k], ly[k],
                                          lz[k], p, two_pi_hi, two_pi_lo,
                                          inv);
            float sin_hi, cos_hi;
            sincosf(r.hi, &sin_hi, &cos_hi);
            c = __fsub_rn(cos_hi, __fmul_rn(r.lo, sin_hi));
            sn = __fadd_rn(sin_hi, __fmul_rn(r.lo, cos_hi));
          } else {
            const float phase = __fmaf_rn(
                qz[k], p.z, __fmaf_rn(qy[k], p.y, __fmul_rn(qx[k], p.x)));
            sincosf(phase, &sn, &c);
          }
          if constexpr (kWeights) {
            c = __fmul_rn(c, p.w);
            sn = __fmul_rn(sn, p.w);
          }
          if constexpr (kExact) {
            const df cs = dfloat::two_sum(c_sum[k], c);
            const df ss = dfloat::two_sum(s_sum[k], sn);
            c_sum[k] = cs.hi;
            s_sum[k] = ss.hi;
            c_comp[k] = __fadd_rn(c_comp[k], cs.lo);
            s_comp[k] = __fadd_rn(s_comp[k], ss.lo);
          } else {
            c_sum[k] = __fadd_rn(c_sum[k], c);
            s_sum[k] = __fadd_rn(s_sum[k], sn);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kQT; ++k) {
        c_acc[k] += static_cast<double>(c_sum[k]);
        s_acc[k] += static_cast<double>(s_sum[k]);
        if constexpr (kExact) {
          c_acc[k] += static_cast<double>(c_comp[k]);
          s_acc[k] += static_cast<double>(s_comp[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kQT; ++k) {
      const int q = q0 + t + k * kThreads;
      if (q < n_q) {
        out[q] = c_acc[k];
        out[n_q + q] = s_acc[k];
      }
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
  const size_t smem = kStage * sizeof(float4);
  const dim3 grid(static_cast<unsigned int>((n_q + kQ - 1) / kQ),
                  static_cast<unsigned int>(n_slices),
                  static_cast<unsigned int>(n_frames));
  trig_sums_kernel<kExact, kLo, kWeights><<<grid, kThreads, smem, stream>>>(
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
