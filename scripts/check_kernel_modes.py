"""Hold every mode of the port's kernels against its plain version.

Usage::

    python scripts/check_kernel_modes.py [--device cpu|cuda] [--seed N]

Every entry point of ``mdhelper_tpu_torch/csrc``, in every binning policy
(bins from 0 or from r_min, exact or fast), sweep (half shell, ordered,
2-D, per-block triclinic, tri_pp) and exclusion (none, symmetric and
asymmetric tiles, cross ids), is compared with its plain-torch version as
integers on small random inputs and on the bin-edge straddle fixtures;
so is the brute-force pair histogram (``csrc/pair_histogram.cu``) with
and without exclusions (asymmetric ones in both orders), also on
positions outside the box, at the edges of its 512-atom tiles and with
the widest histogram its shared memory holds.  The trig sums
(``csrc/trig_sums.cu``), fast and exact, with and without weights and
low words, are held with their plain version against a float64 oracle
within the tolerances of ``tests/test_pallas.py`` (1e-4 and 1e-6 of the
mean amplitude), and on the card the exact sums equal the plain
version's bit for bit; so are the factor sums (``csrc/factor_sums.cu``)
on ragged grids, unwrapped coordinates and a permuted wavevector order,
without the bit-for-bit test (they add in another order).  One line a
case, and a non-zero exit when any fails.

``--device cuda`` runs the kernels on the card (the nvcc build).  The
default, ``--device cpu``, runs the same CUDA sources on the CPU: they are
compiled with the host C++ compiler (``g++ -std=c++17 -O2
-ffp-contract=off``) against a small stand-in for the CUDA runtime
written out below -- the CUDA keywords vanish, the round-to-nearest
intrinsics become plain float operations (IEEE single precision, no
contraction), and a launch runs every block of the grid in turn with one
thread (``blockDim.x == 1``), so each block's strided loops cover all of
its work and ``__syncthreads`` has nothing to wait for -- and the
wrappers of ``ops/cuda_cell_histogram.py`` launch that library on CPU
tensors.  A rehearsal of the arithmetic without a card: whether nvcc
accepts the sources, and the card's results, come from a run on the GPU.
"""

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mdhelper_tpu_torch.algorithm.topology import (  # noqa: E402
    triclinic_matrices,
)
from mdhelper_tpu_torch.ops import _build  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mdhelper_tpu_torch.ops import factor_scattering as fs  # noqa: E402
from mdhelper_tpu_torch.testing import (  # noqa: E402
    edge_straddle_positions,
    edge_straddle_triclinic_positions,
)

#: the stand-in for cuda_runtime.h.
RUNTIME = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_index { unsigned x, y, z; };
inline emu_index threadIdx{0, 0, 0}, blockIdx{0, 0, 0};
inline dim3 blockDim{1, 1, 1};
typedef int cudaError_t;
const int cudaSuccess = 0;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> int cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline void __syncthreads() {}
template <class T> T atomicAdd(T* p, T v) { T o = *p; *p += v; return o; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
using std::min;
using std::max;
inline std::vector<unsigned char> emu_shared;
template <class F> void emu_launch(dim3 grid, size_t smem, F&& body) {
  emu_shared.assign(smem, 0);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        body();
      }
}
"""

#: a kernel launch ``name<...><<<grid, threads, smem, stream>>>(args);``.
_LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<\s*([^,]+),[^,]+,\s*"
                     r"([^,]+),.*?>>>\s*\((.*?)\);", re.S)


def _translate(text):
    """A CUDA source as host C++: the shared array becomes the emulated
    block's buffer, each launch a call of the kernel for every block."""

    text = text.replace("extern __shared__ unsigned char smem[];",
                        "unsigned char* smem = emu_shared.data();")
    return _LAUNCH.sub(
        lambda m: (f"emu_launch({m.group(2)}, {m.group(3)}, [&]() "
                   f"{{ {m.group(1)}({m.group(4)}); }});"),
        text,
    )


def build(out_dir):
    """Compile and link csrc/*.cu for the host; returns the ctypes
    library with the entry points' argument types."""

    out_dir = Path(out_dir)
    (out_dir / "cuda_runtime.h").write_text(RUNTIME)
    sources = []
    for path in sorted((ROOT / "mdhelper_tpu_torch" / "csrc").iterdir()):
        target = out_dir / (path.stem + (".cpp" if path.suffix == ".cu"
                                         else path.suffix))
        target.write_text(_translate(path.read_text()))
        if path.suffix == ".cu":
            sources.append(str(target))
    lib_path = out_dir / "libemulated.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
         "-I", str(out_dir), "-o", str(lib_path), *sources],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _emulated_launch(lib):
    def launch(entry, device, *args):
        del device
        # `args` keeps the tensors made for the call alive through it.
        values = [a.data_ptr() if isinstance(a, torch.Tensor)
                  else float(a) if isinstance(a, np.floating) else a
                  for a in args]
        _build.check(getattr(lib, entry)(*values, None), entry)
    return launch


def cases(rng, device):
    """(name, kernel function, plain function, positional arguments,
    keyword arguments) of every mode, the positions on `device`."""

    def tensor(array):
        return torch.from_numpy(array.astype(np.float32)).to(device)

    cube = 16.0
    pos = tensor(rng.random((2, 400, 3)) * cube)
    straddle = tensor(edge_straddle_positions(rng, cube))[None]
    h = triclinic_matrices(np.array([18.0] * 3 + [60.0, 60.0, 90.0]))
    h32 = h.astype(np.float32)
    tri = tensor((0.02 + 0.96 * rng.random((2, 400, 3))) @ h)
    tri_straddle = tensor(edge_straddle_triclinic_positions(rng, h32))[None]
    slab = tensor(rng.random((2, 500, 3)) * np.float32([20.0, 20.0, 4.0]))
    out = []
    for precision in ("exact", "fast"):
        for r_min in (0.0, 1.25):
            binning = dict(precision=precision, r_min=r_min, n_bins=19)
            tag = f"{precision}, r_min {r_min}"
            for ex in (None, (3, 3), (2, 3)):
                for grid, p in (((3, 3, 3), pos), ((5, 5, 5), pos),
                                ((1, 2, 6), pos), ((3, 3, 3), straddle)):
                    plan = cch.grid_plan(p.shape[1], (cube,) * 3, 5.0, grid)
                    out.append((f"self {grid} {ex} {tag}", "_self_kernel",
                                "_self_reference", (p, (cube,) * 3, 5.0,
                                grid, plan["capacity"]),
                                dict(triclinic=False, reach=plan["reach"],
                                     exclusion=ex, **binning)))
                for grid, p in (((3, 3, 3), tri), ((1, 2, 4), tri),
                                ((3, 3, 3), tri_straddle)):
                    plan = cch.grid_plan(p.shape[1],
                                         cch.triclinic_perpendicular_widths(
                                             h32), 4.0, grid)
                    out.append((f"triclinic self {grid} {ex} {tag}",
                                "_self_kernel", "_self_reference",
                                (p, h32, 4.0, grid, plan["capacity"]),
                                dict(triclinic=True, reach=plan["reach"],
                                     exclusion=ex, **binning)))
                for grid in ((4, 4), (2, 5)):
                    plan = cch.grid_plan(500, (20.0, 20.0), 5.0, grid)
                    out.append((f"2-D self {grid} {ex} {tag}",
                                "_self_kernel", "_self_reference",
                                (slab, (20.0, 20.0, 4.0), 5.0, grid,
                                 plan["capacity"]),
                                dict(triclinic=False, reach=plan["reach"],
                                     exclusion=ex, axes=(0, 1),
                                     **binning)))
            for ex in (None, (2, 3)):
                for grid, (a, b), box, r, kw in (
                    ((3, 3, 3), (pos[:, :200], pos[:, 200:]), (cube,) * 3,
                     5.0, {}),
                    ((2, 5, 6), (pos[:, :200], pos[:, 200:]), (cube,) * 3,
                     5.0, {}),
                    ((3, 3, 3), (tri[:, :200], tri[:, 200:]), h32, 4.0,
                     dict(triclinic=True)),
                    ((1, 2, 4), (tri[:, :200], tri[:, 200:]), h32, 4.0,
                     dict(triclinic=True)),
                    ((4, 4), (slab[:, :250], slab[:, 250:]),
                     (20.0, 20.0, 4.0), 5.0, dict(axes=(0, 1))),
                ):
                    extents = (cch.triclinic_perpendicular_widths(h32)
                               if kw.get("triclinic") else
                               np.asarray(box, float)[:len(grid)])
                    plan = cch.grid_plan(a.shape[1], extents, r, grid,
                                         n_atoms2=b.shape[1])
                    out.append((f"cross {grid} {ex} {kw} {tag}",
                                "_cross_kernel", "_cross_reference",
                                (a.contiguous(), b.contiguous(), box, r,
                                 grid, plan["capacity"], plan["capacity2"]),
                                dict(exclusion=ex, reach=plan["reach"],
                                     triclinic=kw.get("triclinic", False),
                                     axes=kw.get("axes"), **binning)))
    return out


def op_cases(rng, device):
    """(name, kernel call, plain call, check) of the trig sums and the
    brute-force pair histogram; `check(kernel_out, plain_out)` returns
    whether the case passes."""

    def tensor(array, dtype=np.float32):
        return torch.from_numpy(np.asarray(array, dtype)).to(device)

    def trig_check(pos, qs, w, precision, bits=True, rtol=0.0):
        phases = np.asarray(qs, np.float64) @ pos.astype(np.float64).transpose(
            0, 2, 1)
        w64 = 1.0 if w is None else w.astype(np.float64)
        oc = (np.cos(phases) * w64).sum(-1)
        osn = (np.sin(phases) * w64).sum(-1)
        tol = (1e-6 if precision == "exact" else 1e-4) * np.hypot(
            oc, osn).mean()

        def check(k, p):
            # On the card the exact sums are the plain version's bits (with
            # `bits`); the CPU stand-in takes the host's sincosf, which
            # rounds otherwise than torch's cos and sin there.
            same = (not bits or precision != "exact" or device == "cpu"
                    or all(torch.equal(a, b) for a, b in zip(k, p)))
            return same and all(
                (np.abs(out[i].cpu().numpy() - ref)
                 <= tol + rtol * np.abs(ref)).all()
                for out in (k, p) for i, ref in ((0, oc), (1, osn)))
        return check

    def factor_check(pos, w, k, lengths, flat, precision):
        # Not the plain version's bits (the sums add in another order).
        # The grid holds q = 0, whose sum of weights does not cancel: its
        # float32 rounding scales with the sum, hence the rtol.
        grids = [2 * np.pi * np.arange(n) / length
                 for n, length in zip(k, lengths)]
        qs = np.stack(np.meshgrid(*grids, indexing="ij"), -1).reshape(
            -1, 3)[flat]
        return trig_check(pos, qs, w, precision, bits=False, rtol=1e-6)

    out = []
    box = 24.0
    # The float64 wavevectors in a 500 A box: phases of thousands of
    # radians, where dropping the low words misses the exact tolerance
    # (and float32 phases miss the fast one by design: exact only).
    for n, n_q, weighted, wide, length in ((700, 300, False, False, box),
                                           (333, 77, True, False, box),
                                           (500, 64, False, True, 500.0)):
        pos = (rng.random((2, n, 3)) * length).astype(np.float32)
        qs = rng.random((n_q, 3)) * 4
        if not wide:
            qs = qs.astype(np.float32)
        w = (rng.random(n) < 0.5).astype(np.float32) if weighted else None
        for precision in ("exact",) if wide else ("fast", "exact"):
            args = (tensor(qs, qs.dtype), tensor(pos),
                    None if w is None else tensor(w))
            out.append((
                f"trig_sums {n} atoms x {n_q} q weights {weighted} "
                f"float64 q {wide} {precision}",
                lambda a=args, pr=precision: ck._trig_sums_kernel(
                    *a, pr, None),
                lambda a=args, pr=precision: ck.trig_sums_reference(
                    *a, precision=pr),
                trig_check(pos, qs, w, precision)))
    # The factor sums (csrc/factor_sums.cu) on ragged grids, unwrapped
    # coordinates, with and without weights, in the caller's order.
    for k, n, lengths in (((5, 7, 3), 300, (20.0, 17.5, 23.0)),
                          ((40, 1, 1), 200, (20.0, 17.5, 23.0)),
                          ((3, 9, 17), 130, (10.0, 11.0, 12.0))):
        pos = (rng.random((2, n, 3)) * lengths).astype(np.float32)
        pos[:, ::3] += np.float32([3, -2, 5]) * np.float32(lengths)
        flat = rng.permutation(k[0] * k[1] * k[2])
        for weighted in (False, True):
            w = rng.random(n).astype(np.float32) if weighted else None
            args = (tensor(pos), None if w is None else tensor(w))
            for precision in ("fast", "exact"):
                out.append((
                    f"factor_sums {n} atoms on {k} weights {weighted} "
                    f"{precision}",
                    lambda a=args, k=k, b=lengths, pr=precision, f=flat:
                    fs._factor_sums_kernel(*a, k, b, pr, f),
                    lambda a=args, k=k, b=lengths, pr=precision, f=flat:
                    fs.factor_trig_sums_reference(*a, k=k, box=b,
                                                  precision=pr, flat_idx=f),
                    factor_check(pos, w, k, lengths, flat, precision)))
    pos = tensor(rng.random((900, 3)) * box)
    straddle = tensor(edge_straddle_positions(rng, 16.0))
    # Unwrapped: up to two boxes outside [0, L) on each axis.
    loose = tensor((rng.random((700, 3)) * 5 - 2) * box)
    # The tile edges (1, a tile less one, one tile, one more, a multiple of
    # neither, two tiles and one), and the widest histogram beside the tile.
    edges = [(tensor(rng.random((n, 3)) * 8.0), 8.0, 3.5, 40)
             for n in (1, 511, 512, 513, 1000, 1025)]
    widest = (cch._SMEM_BYTES - ck._HIST_TILE * ck._HIST_SLOT_BYTES - 4) // 4
    for p, b, r_max, n_bins, exclusions in (
            [(pos, box, 7.0, 150, (None, (1, 1), (4, 4), (2, 3), (3, 2))),
             (straddle, 16.0, 4.0, 16, (None, (1, 1), (4, 4), (2, 3))),
             (loose, box, 7.0, 150, (None, (1, 1), (4, 4), (2, 3))),
             (pos[:600], box, 7.0, widest, (None, (2, 3)))]
            + [(*e, (None, (2, 3), (3, 2))) for e in edges]):
        for ex in exclusions:
            args = (p, (b,) * 3, r_max, n_bins)
            out.append((
                f"pair_histogram {p.shape[0]} atoms {n_bins} bins {ex}",
                lambda a=args, e=ex: ck._pair_histogram_kernel(*a, e),
                lambda a=args, e=ex: ck.pair_histogram_reference(
                    *a, exclusion=e),
                torch.equal))
    return out


#: the template arguments of a cell-sweep kernel, in its mangled name.
_PARTS = ("OrthoBlockILi3E", "OrthoBlockILi2E", "TriclinicBlock",
          "Tri27Block", "ZeroExact", "OffsetExact", "ZeroFast", "OffsetFast",
          "HalfShellPairs", "OrderedPairs", "CrossPairs", "NoTiles", "Tiles")


def sweep_resources(log, n_bins=200):
    """One line a cell-sweep instantiation from ptxas's report in the
    build log: its registers, stack and spills, and the blocks an H100 SM
    holds at `n_bins` bins (2,048 threads, 65,536 registers allocated
    256 a warp, 228 KB of shared memory with 1 KB a block reserved; the
    block's shared memory from csrc/cell_sweep.cuh: 20,768 bytes and 8
    histogram copies)."""

    smem = 20_768 + 8 * 4 * n_bins
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if "cell_sweep_kernel" in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            stack = m.groups()
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs = int(m.group(1))
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(8, 65_536 // (8 * per_warp), 233_472 // (smem + 1024))
            parts = [p for p in _PARTS if p in name]
            if "NoTiles" in parts:
                parts.remove("Tiles")
            out.append(f"  {' '.join(parts)}: {regs} registers, stack "
                       f"{stack[0]} B, spills {stack[1]}/{stack[2]} B; "
                       f"{blocks} blocks ({8 * blocks} warps) an SM at "
                       f"{n_bins} bins")
            name = None
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        if args.device == "cpu":
            cch._launch = ck._launch = _emulated_launch(build(tmp))
        failed = 0
        for name, kernel, plain, pos_args, kwargs in cases(
                np.random.default_rng(args.seed), args.device):
            n_bins = kwargs.pop("n_bins")
            if kernel == "_self_kernel":
                call = pos_args[:5] + (n_bins,)
            else:
                call = pos_args[:7] + (n_bins,)
            k = getattr(cch, kernel)(*call, **kwargs)
            p = getattr(cch, plain)(*call, **kwargs)
            same = all(torch.equal(x, y) for x, y in zip(k, p))
            failed += not same
            print(f"{'ok  ' if same else 'FAIL'} {name}: "
                  f"{int(p[0].sum())} pairs")
        for name, kernel, plain, check in op_cases(
                np.random.default_rng(args.seed), args.device):
            same = bool(check(kernel(), plain()))
            failed += not same
            print(f"{'ok  ' if same else 'FAIL'} {name}")
    if args.device == "cuda":
        info = _build.build_info()
        print(f"nvcc build {info['seconds']:.1f} s: {info['path']}")
        for line in sweep_resources(info["log"]):
            print(line)
    print(f"{failed} failed")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
