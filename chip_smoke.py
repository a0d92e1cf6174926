"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mdhelper_tpu_torch/csrc`` with
nvcc (one process per source, in parallel) and holds each kernel
against its plain-torch version on the card: the self kernel at the
fused path's shape, the cross kernel at the cross-RDF and Van Hove
shapes, both at 400k atoms (where the JAX package runs its streaming
kernels), and both on the bin-edge straddle fixtures and the (2, 3)
molecule-exclusion fixture against float64 oracles; then the same for
the triclinic self and cross kernels in a GROMACS rhombic dodecahedron
(100k atoms, 50k x 50k, 100k x 100k with exclusion (1, 1), 400k atoms,
the triclinic straddle fixture against a float64 27-image oracle, and a
shrunk c-vector that both must NaN-poison).  Then it drives six paths
through ``mdhelper_tpu_torch.analysis.multi.run_together`` at 100k
atoms, each with the launch counts set to 0 just before it and read
just after: the fused RDF + S(q) + MSD pass, the cross RDF of two 50k
groups, the Van Hove function over a 64-frame ring with 21 log lags,
and, in the dodecahedron, the self RDF, the cross RDF and the Van Hove
function; and it checks their results.  Then boxes under 3 cutoffs:
the generalized half-shell, ordered and cross kernels and the per-pair
27-image (tri_pp) self and cross kernels against their plain versions
on explicit plans, on the straddle fixtures (against float64 oracles)
and on shrunk frames (NaN); tri_pp and reach-2 kernels against the
per-block and reach-1 ones at 100k atoms; and seven paths at the
classes' defaults (self and cross RDF and Van Hove in a 50k-atom cube
of 39.685 A, the ordered self RDF of 5,000 atoms, and in rhombic
dodecahedra the tri_pp self and cross RDF of 50k atoms and Van Hove of
5,000), launch counts read by sweep mode.  Then slice 6: the trig-sums
kernel against its plain version and a float64 oracle at the direct
path's width (2 frames of 100k atoms x the 24^3 grid's 13,824 float64
wavevectors, fast and exact, and with 0/1 weights on the tiles' tails),
the direct S(q) path (run() at 100k atoms, 8 + 32 frames, against the
factor method), the split of the grid and 4 x 8 surface points under
method="auto", the partial rows of the even and odd atoms and the fast
phases (8 + 8 frames each), and the brute-force pair histogram through
its op at 100k atoms (exclusions (1, 1), None, (4, 4) and (2, 3), and
the straddle fixture) against its plain version and the fast self cell
kernel; the exact trig sums must equal their plain version bit for bit.
Then the cross RDF of two overlapping groups, and slice 10: the fast
trig sums on 8 and on 64 (the lag launch of a full ring) displacement
frames in +-L against their plain version and a float64 oracle, and the
IntermediateScatteringFunction at the JAX package's isf bench width
(100k atoms, the 24^3 grid, a 64-frame ring, incoherent, exact, 8 + 96
frames of a random walk): the direct route with its 13 coherent and 104
lag launches counted, F_s(q, 0) == 1, F(q, 0) against the direct S(q)
and four lags on 16 wavevectors against a numpy float64 oracle; the
default factorized route against it; the coherent time FFT against the
ring; the log grid's rows against the dense rows bit for bit; and the
sum rule of the dynamic structure factor.  Then slice 11, the grouped
main path on bench.py's water topology at the fused path's width (33,333
3-site waters, 99,999 atoms, with O-H bonds): the bonded unwrap_edge of
the first frame on the host (timed), run_together of the RDF, S(q) and
Onsager MSD of the residues' centers of mass over 8 + 32 frames (launches
counted, the last chunk profiled), the centers of a chunk on the card
against a numpy float32 fixed-order reduction bit for bit, the self cell
kernel and the exact trig sums on those centers against their plain
versions, the factor S(q) of the centers against the direct route; the
mixed cross RDF of centers against atoms (one chunk, the cross kernel
against its plain version), and the Van Hove function and the ISF of the
centers (their MSD against a float64 oracle, F_s(q, 0) == 1, F(q, 0)
against the direct S(q)).  Then slice 12, the units path on bench.py's
conductivity system at the fused width (100k ions of charges +1 and -1
on a random walk of known D): run_together of the cation-anion RDF, the
partial S(q) and the centered, unwrapped Onsager over 8 + 32 frames
(cross launches counted, clocked through every post-hoc method of the
three classes, then profiled), D_i against the walk's, the
Nernst-Einstein conductivity against the CODATA formula from the run's
own D_i, kappa == kappa_NE for one ion, the cross kernel on the path's
plan against its plain version, radial_histogram on the card against a
float64 histogram, and msd_shift of the stored positions against the FFT
MSDs.  Then slice 13, the main path from files: the fused trajectory
written with the port's writers as a GRO topology (atoms named A and B)
with an XTC and a DCD, opened with Universe.from_files; run_together of
the RDF, S(q) and Onsager on select_atoms("all") (self launches counted)
and one chunk of the cross RDF of "name A" and "name B" (cross launches
counted), each against the same analyses over an ArrayReader of the
reader's own decoded float32 frames (counts equal, S(q) and the MSDs
within their gates, bit-equality reported); the DCD's frames bit-equal
to the arrays written, the XTC's within half its precision step, the
native XTC codec loaded; frames/s from the ArrayReader, the DCD and the
XTC with the prefetch on and off, the host's decode time a chunk, the
device's busy share, and both kernels on the paths' plans against their
plain versions.  Then slice 14, density profiles and electrostatics
(no kernel of the kernels line launches there): bench.py's config-4
path, the z density profiles of the electrolyte's 50k cations and 50k
anions (200 bins, 8 + 32 frames, the z column streamed alone) and the
Poisson potential, against numpy float32 histograms on the JAX
package's float32 edges, with its busy share and the same path
streaming all three columns in turns; the dipole-fluctuation
permittivity and dielectric spectrum of 33,333 SPC/E waters
(DipoleMoment with unwrap) against a float64 sum; and one chunk each of
the radial profiles (spherical, cylindrical, about a center of mass)
and the 192^2 and 64^3 density maps against numpy oracles.  Then slice
15, bench.py's config 5: run_together of Gyradius, EndToEndVector and
RouseModes(n_modes=8) on 2,000 chains of 50 monomers (100k atoms) over
8 + 48 frames, with its busy share and float64 oracles; the single-chain
S(q) of the same chains through the trig-sums kernel (exact, float32
wavevectors, blocks of chain-frames on one workspace), its launches
counted, one block against the plain version and a float64 oracle, and
100 chains against a float64 oracle; PersistenceLength and
MeanSquareInternalDistance against float64 oracles, in the cube and in
a triclinic cell; and the thermodynamics functions on seeded series with
closed-form answers (a LAMMPS log read without pandas).  Then slice
16's mesh S(q), aggregates and order paths, and slice 17: the velocity
analyses on the electrolyte with AR(1) Maxwell-Boltzmann velocities and
a Couette profile (VACF against a float64 FFT oracle and 3kT/m, the
Green-Kubo conductivity against the port's CPU run, FlowProfile's shear
rate and temperatures, also from a TRR, slab and shell survival and the
overlap function against the CPU run), and the Willard-Chandler
interfaces and intrinsic profiles of a 20,000-site water slab (the first
chunk against the CPU run; the deposit's and smoothing's ms a frame);
and slice 18: RMSD, RMSF, PCA, TICA and native contacts on a
4,800-atom protein in 95,000 solvent atoms (rotations against the
imposed ones, RMSD and RMSF against a float64 Kabsch oracle, the imposed
collective modes recovered, the rest against the port's CPU run) and
the bond-length, angle and dihedral distributions of config 5's melt in
the cube and a triclinic cell (lengths against a float64 oracle as
integers); no kernel of the kernels line launches there.  Every check
raises on failure, so any failed phase exits non-zero.  The last lines of
standard output are the card's name and power limit, a JSON line of
per-kernel measurements (each beside its bound: the larger of the
float32 operations of the pairs binned, or of the trig terms summed,
over the card's float32 peak and the bytes read and written once over
its memory rate), and ``{"ok": true, "device":
{...}}``.

Imports neither JAX nor the JAX package.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

N_ATOMS = 100_000
BOX = float(N_ATOMS / 0.8) ** (1 / 3)  # LJ-liquid density 0.8: 50.0
R_MAX, N_BINS = 6.0, 200
N_QPTS = 24
CHUNK, N_FRAMES = 8, 8 + 32
# The new paths' depths (bench.py: one warm-up chunk + N_FRAMES), and
# the Van Hove ring and lag grid.
RDF_FRAMES, VH_FRAMES, VH_LAGS = 8 + 48, 8 + 96, 64
# Where the JAX package streams both cell sweeps (tables over 12 MB).
STREAM_ATOMS = 400_000
SEED = 2026
# The triclinic slice: GROMACS xy-square rhombic dodecahedra (editconf -bt
# dodecahedron) of 125,000 A^3 at 100k atoms, the density above, and of
# four times that at 400k; the triclinic paths' depths (Van Hove cut).
DODECA_A, DODECA_STREAM_A = 56.12, 89.09
TRI_RDF_FRAMES, TRI_VH_FRAMES = 8 + 48, 8 + 32

# Slice 4: boxes under 3 cutoffs at the classes' defaults (201 bins on
# [0, 15]).  A 50k-atom cube (2.65 cutoffs) and a 50k-atom xy-square
# rhombic dodecahedron (perpendicular widths 36.37, 36.37, 31.49) at the
# density above; the 5,000-atom cube of the ordered sweep (r_max 8) and
# the 5,000-atom dodecahedron of the tri_pp kernel checks and Van Hove
# (r_max 6); the paths' depths (the tri_pp RDF paths cut to 8 + 16).
GEN_ATOMS, SMALL_ATOMS = 50_000, 5_000
GEN_R, GEN_BINS, ORDERED_R, TRI_PP_R = 15.0, 201, 8.0, 6.0
GEN_DODECA_A, TRI_PP_A = 44.54, 20.67
GEN_RDF_FRAMES, GEN_VH_FRAMES = 8 + 48, 8 + 32
SMALL_RDF_FRAMES, TRI_PP_RDF_FRAMES, TRI_PP_VH_FRAMES = 8 + 16, 8 + 16, 8 + 32

# Slice 5: the self tiles of a 3-site water model (3, 3) and an
# asymmetric (2, 3), bins from r_min > 0 and the 2-D (drop_axis) RDF of a
# 100k-atom film of 100 x 100 x 12.5 A (density 0.8), each through its
# paths (the water and offset paths 8 + 32 frames, the film 8 + 16).
WATER_TILES = ((3, 3), (2, 3))
OFFSET_RANGE, VH_OFFSET_RANGE = (2.0, 6.0), (1.0, 6.0)
FILM = (100.0, 100.0, 12.5)
FILM_FRAMES = 8 + 16
#: the JAX package's 2-D grids for the film's self and cross RDF
#: (pallas_cell_plan_search over the two kept lengths, r_max 15).
FILM_JAX_GRIDS = ((13, 19), (13, 13))

#: float32 operations of one pair (counted in csrc/cell_bin.cuh) under
#: each displacement policy -- per-pair orthorhombic image (3 or 2 axes),
#: one lattice translation per block, the per-pair 27-candidate search:
#: exact binning screens a pair (``screen``) and forms the double-float
#: d^2 (``exact``; tri_pp: one kept candidate) of one that passes; fast
#: binning forms the float32 d^2 (``fast``).  The bin tails
#: (:data:`TAIL_OPS`) come on top for the pairs binned.
OPS_PER_PAIR = {
    "ortho": {"screen": 23, "exact": 133, "fast": 23},
    "ortho2": {"screen": 16, "exact": 84, "fast": 15},
    "shift": {"screen": 18, "exact": 121, "fast": 11},
    "tri27": {"screen": 208, "exact": 36 + 163, "fast": 506},
}
#: the tails of the binning policies: exact and fast, from 0 and from
#: r_min.
TAIL_OPS = {"exact": (49, 98), "fast": (4, 7)}
#: the first design's count a pair (no screen, every pair exact), kept
#: for its bound beside the new one.
FIRST_DESIGN_OPS = {
    "ortho": {"exact": (254, 317), "fast": (24, 27)},
    "ortho2": {"exact": (191, 254), "fast": (17, 20)},
    "shift": {"exact": (245, 308), "fast": (15, 18)},
    "tri27": {"exact": (7186, 7249), "fast": (510, 513)},
}
#: the policy of each sweep mode (cuda_cell_histogram._sweep_mode).
POLICY = {"reach1": "ortho", "general": "ortho", "ordered": "ortho",
          "block": "shift", "tri_pp": "tri27"}
#: one H100 SXM's published peaks (NVIDIA's data sheet): float32 outside
#: the tensor cores, and HBM3 bytes/s.
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


def check(condition, what):
    if not condition:
        raise AssertionError(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over `reps` calls."""

    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pair_ops(pairs, counted, mode, n_axes=3, r_min=0.0, precision="exact"):
    """float32 operations of a sweep in `mode` (on a 2-D grid with
    ``n_axes=2``) that visits `pairs` slot pairs and bins `counted` of
    them in range: the least the function needs, each pair in range
    screened and binned exactly (or its float32 d^2 and tail), the pairs
    out of range counting nothing (the kernels rule most of them out by
    the row test and the screen, at a cost left out here); and the first
    design's count, every visited pair at its full cost."""

    policy = "ortho2" if n_axes == 2 else POLICY[mode]
    ops = OPS_PER_PAIR[policy]
    tail = TAIL_OPS[precision][int(r_min > 0.0)]
    if precision == "fast":
        new = counted * (ops["fast"] + tail)
    else:
        new = counted * (ops["screen"] + ops["exact"] + tail)
    first = pairs * FIRST_DESIGN_OPS[policy][precision][int(r_min > 0.0)]
    return new, first


def bound(pairs, n_bytes, mode, n_frames, counted=0, cross=False,
          **binning):
    """The least time a frame could take on the card for a kernel's
    work (``bound_ms``, and ``bound_by``, the larger term): the float32
    operations of :func:`pair_ops` for `pairs` visited slot pairs of
    which `counted` are binned in range, over the float32 peak, against
    `n_bytes` (the slot tables read once and the counts written once)
    over the memory rate, both over `n_frames`; ``first_design_bound_ms``
    is the same with the first design's count.  The peak counts an FMA
    as two operations; these kernels issue mostly unfused operations
    (built with --fmad=false), at most half of it.  No single PyTorch call
    computes a binned cell-list pair histogram, so ``library_ms`` is
    None.  ``rebound(counted)`` recounts with the pairs a run counted
    (:func:`counted_pairs`, which halves a half-shell self sweep's counts
    and never a `cross` sweep's)."""

    new_ops, first_ops = pair_ops(pairs, counted, mode, **binning)
    ops_ms = new_ops / PEAK_F32 * 1e3 / n_frames
    bytes_ms = n_bytes / PEAK_BYTES * 1e3 / n_frames
    return {
        "mode": mode,
        "cross": cross,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "first_design_bound_ms": max(first_ops / PEAK_F32 * 1e3 / n_frames,
                                     bytes_ms),
        "library_ms": None,
        "pairs_per_frame": pairs / n_frames,
        "counted_per_frame": counted / n_frames,
        "rebound": lambda c: bound(pairs, n_bytes, mode, n_frames, c,
                                   cross, **binning),
    }


def timed_call(fn):
    """``fn()`` and its device milliseconds."""

    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def recorded_launch(kernel):
    """``kernel()`` and a no-argument call that repeats its cell-kernel
    launch alone (the wrapper's slot tables already built; the counts
    keep adding up), or None when it launched no cell kernel."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    calls = []
    launch = cch._launch

    def recording(*args):
        calls.append(args)
        return launch(*args)

    cch._launch = recording
    try:
        out = kernel()
    finally:
        cch._launch = launch
    return out, (lambda: launch(*calls[-1])) if calls else None


def kernel_vs_plain(kernel, plain, n_frames, what, work, plain_runs=2):
    """Run a kernel wrapper and its plain version on the same inputs
    (each a no-argument call returning ``(counts, *occupancies)``),
    check that every output is equal as integers, then time them in
    turns -- plain (the checked call), kernel, kernel, plain -- in ms
    per frame, beside the bound of `work` (:func:`bound`).  With
    ``plain_runs=1`` the plain version runs only once, for the check,
    which is also its time (where it takes tens of seconds)."""

    import torch

    k_out, replay = recorded_launch(kernel)
    p_out, first_plain_ms = timed_call(plain)
    check(bool(torch.isfinite(k_out[0]).all()), f"{what}: counts not finite")
    for k, p in zip(k_out, p_out):
        check(torch.equal(k, p), f"{what}: kernel differs from plain")
    max_abs_err = float((k_out[0] - p_out[0]).abs().max())
    del p_out
    if "rebound" in work:
        work = work["rebound"](counted_pairs(k_out[0], work))
    plain_ms = [first_plain_ms]
    kernel_ms = [time_ms(kernel, 5) for _ in range(2)]
    plain_ms += [time_ms(plain, 1) for _ in range(plain_runs - 1)]
    out = {
        "max_abs_err": max_abs_err,
        "ms": float(np.mean(kernel_ms)) / n_frames,
        "plain_ms": float(np.mean(plain_ms)) / n_frames,
        **work,
    }
    if replay is not None:
        out["launch_ms"] = time_ms(replay, 5) / n_frames
    launch_text = (f", the launch alone {out['launch_ms']:.3f} ms"
                   if "launch_ms" in out else "")
    print(f"{what}: {int(k_out[0].sum())} pairs in range over "
          f"{n_frames} frame(s), kernel == plain; per frame kernel "
          f"{out['ms']:.3f} ms{launch_text} (runs "
          f"{[round(x / n_frames, 3) for x in kernel_ms]}), plain torch "
          f"{out['plain_ms']:.3f} ms (runs "
          f"{[round(x / n_frames, 3) for x in plain_ms]}); "
          f"{out['pairs_per_frame']:.0f} slot pairs binned a frame, bound "
          f"{out['bound_ms']:.3f} ms by {out['bound_by']} "
          f"({100 * out['bound_ms'] / out['ms']:.1f} % of the kernel's "
          f"time; {out['first_design_bound_ms']:.3f} ms by the first "
          "design's count)")
    return out, k_out


def counted_pairs(counts, work):
    """Slot pairs a sweep of `work` (:func:`bound`) binned in range, from
    its counts: a half-shell self sweep visits each unordered pair once
    and doubles it (an asymmetric tile's weights count about as much); a
    cross sweep and an ordered self sweep count each pair they bin once."""

    total = float(counts[counts.isfinite().all(dim=1)].sum())
    half_shell = (not work["cross"]
                  and work["mode"] in ("reach1", "general", "block"))
    return total / 2 if half_shell else total


def cube(n_atoms):
    """Box parameters of the cube that holds `n_atoms` at density 0.8."""

    side = float(n_atoms / 0.8) ** (1 / 3)
    return np.array([side] * 3 + [90.0] * 3)


def dodecahedron(a):
    """Box parameters of a GROMACS xy-square rhombic dodecahedron of
    side `a` (angles 60, 60, 90 degrees; volume a^3 / sqrt(2))."""

    return np.array([a, a, a, 60.0, 60.0, 90.0])


def uniform_frames(rng, device, n_frames, n_atoms, dims6):
    """`n_frames` frames of `n_atoms` uniform float32 atoms in the box
    `dims6`, and the box as the kernels take it: ``(3,)`` lengths, or
    the float32 ``(3, 3)`` matrix of a triclinic box (atoms at uniform
    fractional coordinates)."""

    import torch

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices

    shape = (n_frames, n_atoms, 3)
    if np.allclose(dims6[3:], 90.0):
        box = tuple(float(x) for x in dims6[:3])
        pos = (rng.random(shape) * dims6[:3]).astype(np.float32)
    else:
        h64 = triclinic_matrices(dims6)
        box = h64.astype(np.float32)
        pos = (rng.random(shape) @ h64).astype(np.float32)
    return torch.from_numpy(pos).to(device), box


def plan_extents(box):
    """What a cell plan spans: the box lengths, or the perpendicular
    widths of a float32 box matrix."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    if np.ndim(box) == 2:
        return cch.triclinic_perpendicular_widths(box).astype(np.float64)
    return np.asarray(box, np.float64)


def plan_text(plan, mode):
    reach = plan["reach"]
    return (f"plan {plan['n_cells_dim']}"
            + (f" reach {reach}" if any(m != 1 for m in reach) else "")
            + f" ({mode})")


def sweep_calls(frames1, frames2, box, plan, r_max, n_bins, exclusion=None,
                r_min=0.0, precision="exact", axes=None):
    """The kernel wrapper and its plain version on `plan`, each a
    no-argument call returning ``(counts, *occupancies)``: the self sweep
    of the (B, N, 3) device frames `frames1` when `frames2` is None, else
    the cross sweep of the two groups (triclinic for a box matrix), with
    the exclusion, binning and 2-D ``axes`` options given; with the bound
    of its work (:func:`bound`) and the plan's text."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    triclinic = np.ndim(box) == 2
    cross = frames2 is not None
    groups = (frames1, frames2) if cross else (frames1,)
    n_frames = frames1.shape[0]
    dims3, reach3, _ = cch._grid3(plan["n_cells_dim"], plan["reach"], axes,
                                  triclinic)
    mode = cch._sweep_mode(dims3, reach3, triclinic, cross=cross)
    args = dict(box=box, r_max=r_max, n_cells_dim=plan["n_cells_dim"],
                reach=plan["reach"], n_bins=n_bins, r_min=r_min,
                precision=precision)
    if axes is not None:
        args["axes"] = axes
    slot_bytes = cch._SLOT_BYTES
    if cross:
        kernel, plain = (
            (cch.triclinic_cross_pair_histogram,
             cch.triclinic_cross_pair_histogram_reference) if triclinic
            else (cch.cross_pair_histogram,
                  cch.cross_pair_histogram_reference)
        )
        args.update(capacity1=plan["capacity"], capacity2=plan["capacity2"],
                    exclusion=exclusion)
        slots = plan["capacity"] + plan["capacity2"]
        text = f"capacities {plan['capacity']}/{plan['capacity2']}"
    else:
        kernel, plain = (
            (cch.triclinic_cell_pair_histogram,
             cch.triclinic_cell_pair_histogram_reference) if triclinic
            else (cch.cell_pair_histogram, cch.cell_pair_histogram_reference)
        )
        args.update(capacity=plan["capacity"], exclusion=exclusion)
        slots = plan["capacity"]
        text = f"capacity {plan['capacity']}"
        if exclusion is not None and exclusion[0] != exclusion[1]:
            slot_bytes = cch._ASYM_SLOT_BYTES
    pairs = cch.swept_pairs(*groups, box=box, n_cells_dim=plan["n_cells_dim"],
                            triclinic=triclinic, reach=plan["reach"],
                            axes=axes)
    n_bytes = n_frames * (slot_bytes * plan["n_cells"] * slots
                          + 4 * len(groups) * plan["n_cells"] + 8 * n_bins)
    options = [f"exclusion {exclusion}" if exclusion else "",
               f"r_min {r_min}" if r_min else "",
               "fast" if precision == "fast" else "",
               f"axes {axes}" if axes else ""]
    return (lambda: kernel(*groups, **args), lambda: plain(*groups, **args),
            bound(pairs, n_bytes, mode, n_frames, cross=cross,
                  n_axes=len(plan["n_cells_dim"]), r_min=r_min,
                  precision=precision),
            " ".join([plan_text(plan, mode), text, *filter(None, options)]))


def check_capacity(k_out, plan):
    """Every cell of a kernel's output fits its plan's capacities."""

    caps = (plan["capacity"], plan.get("capacity2"))
    for occ, cap in zip(k_out[1:], caps):
        check(int(occ.max()) <= cap, "capacity overflow")


def planned(n_atoms, box, r_max, n_atoms2=None, exclusion=None, axes=None):
    """The planner's plan for a sweep, as the analyses make it: over the
    kept axes of a 2-D grid, with the wider slots' ceiling for an
    asymmetric self tile."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    extents = plan_extents(box)
    if axes is not None:
        extents = extents[list(axes)]
    asym = (n_atoms2 is None and exclusion is not None
            and exclusion[0] != exclusion[1])
    return cch.cell_plan_search(
        n_atoms, extents, r_max, n_atoms2=n_atoms2,
        slot_bytes=cch._ASYM_SLOT_BYTES if asym else cch._SLOT_BYTES)


def self_kernel_vs_plain(frames, box, what, plan=None, r_max=R_MAX,
                         n_bins=N_BINS, plain_runs=2, **options):
    """The self kernel (triclinic for a box matrix) against its plain
    version on the (B, N, 3) device frames, on `plan` (by default the
    planner's), with the sweep `options` of :func:`sweep_calls`."""

    plan = plan or planned(frames.shape[1], box, r_max,
                           exclusion=options.get("exclusion"),
                           axes=options.get("axes"))
    kernel, plain, work, text = sweep_calls(frames, None, box, plan, r_max,
                                            n_bins, **options)
    out, k_out = kernel_vs_plain(kernel, plain, frames.shape[0],
                                 f"{what}, {text}", work,
                                 plain_runs=plain_runs)
    check_capacity(k_out, plan)
    return {**out, "plan": plan}


def cross_kernel_vs_plain(frames1, frames2, box, what, exclusion=None,
                          plan=None, r_max=R_MAX, n_bins=N_BINS,
                          plain_runs=2, **options):
    """The cross kernel (triclinic for a box matrix) against its plain
    version on the given (B, N1, 3) and (B, N2, 3) device frames, on
    `plan` (by default the planner's), with the sweep `options` of
    :func:`sweep_calls`."""

    plan = plan or planned(frames1.shape[1], box, r_max,
                           n_atoms2=frames2.shape[1],
                           axes=options.get("axes"))
    kernel, plain, work, text = sweep_calls(frames1, frames2, box, plan,
                                            r_max, n_bins, exclusion,
                                            **options)
    out, k_out = kernel_vs_plain(kernel, plain, frames1.shape[0],
                                 f"{what}, {text}", work,
                                 plain_runs=plain_runs)
    check_capacity(k_out, plan)
    return {**out, "plan": plan}


def phase_kernels(device, rng):
    """Self kernel vs plain version at the main path's shape and on the
    edge-straddle fixture."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.testing import (
        edge_straddle_positions,
        f64_pair_histogram,
    )

    frames, box = uniform_frames(rng, device, 2, N_ATOMS, cube(N_ATOMS))
    timing = self_kernel_vs_plain(frames, box, f"self kernel, {N_ATOMS} atoms")

    box_s, r_s, bins_s = 16.0, 4.0, 16
    fixture = edge_straddle_positions(rng, box_s)
    plan_s = cch.cell_plan_search(len(fixture), [box_s] * 3, r_s)
    args_s = dict(box=(box_s,) * 3, r_max=r_s,
                  n_cells_dim=plan_s["n_cells_dim"],
                  capacity=plan_s["capacity"], n_bins=bins_s)
    fx = torch.from_numpy(fixture).to(device)
    k_s, _ = cch.cell_pair_histogram(fx, **args_s)
    p_s, _ = cch.cell_pair_histogram_reference(fx, **args_s)
    torch.cuda.synchronize()
    check(torch.equal(k_s, p_s), "straddle fixture: kernel != plain")
    check(np.array_equal(k_s[0].cpu().numpy().astype(np.int64),
                         f64_pair_histogram(fixture, box_s, r_s, bins_s)),
          "straddle fixture: kernel != float64 oracle")
    print("edge-straddle fixture: kernel == plain == float64 oracle")
    return timing


def phase_cross_kernels(device, rng):
    """Cross kernel vs plain version at the two new paths' shapes, on
    the (2, 3) molecule-exclusion fixture and on the cross straddle
    fixture (both also against the float64 oracle)."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.testing import (
        edge_straddle_cross_positions,
        f64_cross_histogram,
    )

    def uniform(n_frames, n_atoms, box):
        return torch.from_numpy(
            (rng.random((n_frames, n_atoms, 3)) * box).astype(np.float32)
        ).to(device)

    frames = uniform(2, N_ATOMS, BOX)
    timing = {
        "rdf": cross_kernel_vs_plain(
            frames[:, 0::2].contiguous(), frames[:, 1::2].contiguous(),
            (BOX,) * 3,
            f"cross kernel, cross-RDF shape {N_ATOMS // 2} x "
            f"{N_ATOMS // 2}",
        ),
        # Two different frames of the same atoms, as the Van Hove
        # distinct part compares them.
        "vanhove": cross_kernel_vs_plain(
            frames[:1], frames[1:], (BOX,) * 3,
            f"cross kernel, Van Hove shape {N_ATOMS} x {N_ATOMS}, "
            "exclusion (1, 1)", exclusion=(1, 1),
        ),
    }

    fixtures = {
        "molecule-exclusion (2, 3) fixture": (
            uniform(1, 600, 16.0)[0], uniform(1, 900, 16.0)[0],
            16.0, 3.5, 96, (2, 3),
        ),
        "cross straddle fixture": (
            *(torch.from_numpy(p).to(device)
              for p in edge_straddle_cross_positions(rng, 16.0)),
            16.0, 4.0, 16, None,
        ),
    }
    for what, (p1, p2, box, r_max, n_bins, ex) in fixtures.items():
        plan = cch.cell_plan_search(len(p1), [box] * 3, r_max,
                                    n_atoms2=len(p2))
        args = dict(box=(box,) * 3, r_max=r_max,
                    n_cells_dim=plan["n_cells_dim"],
                    capacity1=plan["capacity"],
                    capacity2=plan["capacity2"], n_bins=n_bins,
                    exclusion=ex)
        k, _, _ = cch.cross_pair_histogram(p1, p2, **args)
        p, _, _ = cch.cross_pair_histogram_reference(p1, p2, **args)
        torch.cuda.synchronize()
        check(torch.equal(k, p), f"{what}: kernel != plain")
        oracle = f64_cross_histogram(p1.cpu().numpy(), p2.cpu().numpy(),
                                     box, r_max, n_bins, ex)
        check(np.array_equal(k[0].cpu().numpy().astype(np.int64), oracle),
              f"{what}: kernel != float64 oracle")
        print(f"{what}: kernel == plain == float64 oracle "
              f"({int(oracle.sum())} pairs)")
    return timing


def phase_stream_sizes(device, rng):
    """Both kernels against their plain versions at 400k atoms, where
    the JAX package's plans exceed its 12 MB resident-table budget and
    run its streaming kernels."""

    import torch

    n = STREAM_ATOMS
    box = float(n / 0.8) ** (1 / 3)
    frames = torch.from_numpy(
        (rng.random((1, n, 3)) * box).astype(np.float32)
    ).to(device)
    self_frames, self_box = uniform_frames(rng, device, 1, n, cube(n))
    return {
        "self": self_kernel_vs_plain(self_frames, self_box,
                                     f"self kernel, {n} atoms"),
        "cross": cross_kernel_vs_plain(
            frames[:, 0::2].contiguous(), frames[:, 1::2].contiguous(),
            (box,) * 3, f"cross kernel, {n // 2} x {n // 2}",
        ),
    }


def direct_msd(pos):
    """float64 direct-lag MSD of (T, N, 3) positions, averaged over
    origins and particles."""

    t = pos.shape[0]
    return np.array([
        ((pos[m:] - pos[:t - m]) ** 2).sum(-1).mean() for m in range(t)
    ])


def slice_universe(rng, n_frames=N_FRAMES):
    """A path's trajectory: `n_frames` uncorrelated frames of N_ATOMS
    uniform float32 atoms in the cubic box, as an in-memory universe."""

    from mdhelper_tpu_torch.core.universe import Universe

    traj = rng.random((n_frames, N_ATOMS, 3), dtype=np.float32) * np.float32(
        BOX
    )
    return traj, Universe.from_arrays(
        traj, np.array([BOX] * 3 + [90.0] * 3), dt=1.0
    )


def slice_analyses(u, device, parts=("rdf", "sq", "msd"), group=None,
                   sq_method="factor"):
    """The main path's analyses (those named in `parts`, in that
    order) of `group` (default ``u.atoms``), with the benchmark's
    settings (the S(q) by `sq_method`) and CHUNK-frame chunks."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        StructureFactor,
    )
    from mdhelper_tpu_torch.analysis.transport import Onsager

    group = u.atoms if group is None else group
    make = {
        "rdf": lambda: RadialDistributionFunction(
            group, n_bins=N_BINS, range=(0.0, R_MAX), exclusion=(1, 1),
            verbose=False, device=device,
        ),
        "sq": lambda: StructureFactor(
            group, n_points=N_QPTS, sort=False, unique=False,
            method=sq_method, precision="exact", verbose=False,
            device=device,
        ),
        "msd": lambda: Onsager(group, unwrap=True, verbose=False,
                               device=device),
    }
    analyses = [make[p]() for p in parts]
    for a in analyses:
        a._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    return analyses


def path_analysis(u, device, path):
    """The analysis of one of slice 2's paths with the bench's
    settings and CHUNK-frame chunks: ``"cross_rdf"`` (bench.py's cross
    phase) or ``"vanhove"`` (its vanhove phase)."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        VanHoveFunction,
    )

    if path == "cross_rdf":
        analysis = RadialDistributionFunction(
            u.atoms[0::2], u.atoms[1::2], n_bins=N_BINS,
            range=(0.0, R_MAX), verbose=False, device=device,
        )
    else:
        analysis = VanHoveFunction(
            u.atoms, n_bins=N_BINS, range=(0.0, R_MAX), n_lags=VH_LAGS,
            lags="log", verbose=False, device=device,
        )
    analysis._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    return analysis


def run_timed(analyses, n_frames=N_FRAMES):
    """``run_together(analyses)`` over `n_frames` frames; returns
    frames/s clocked from the end of the first chunk to the end of the
    conclusions."""

    import torch

    from mdhelper_tpu_torch.analysis.multi import run_together

    marks = []

    def on_chunk(batch):
        if not marks:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    run_together(analyses, on_chunk=on_chunk)
    return (n_frames - CHUNK) / (time.perf_counter() - marks[0])


def phase_slice(device, rng):
    """The main path: run_together([RDF, S(q), Onsager]) at 100k atoms."""

    import torch

    from mdhelper_tpu_torch.algorithm.correlation import msd_fft
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    traj, u = slice_universe(rng)
    analyses = slice_analyses(u, device)
    cch.cell_pair_histogram.launches = 0
    fps = run_timed(analyses)
    launches = cch.cell_pair_histogram.launches
    n_chunks = -(-N_FRAMES // CHUNK)
    check(launches == n_chunks,
          f"{launches} kernel launches for {n_chunks} chunks")
    rdf, sf, ons = analyses

    g = rdf.results.rdf
    check(np.all(np.isfinite(g)) and g.shape == (N_BINS,), "g(r) shape")
    check(np.all(np.abs(g[-20:] - 1.0) < 0.02),
          f"g(r) tail off 1: {g[-20:]}")

    ssf = sf.results.ssf
    q = sf.results.wavenumbers
    check(ssf.shape == (1, len(q)) and np.all(np.isfinite(ssf)),
          "S(q) shape")
    pick = np.random.default_rng(SEED).choice(len(q), 64, replace=False)
    qs = sf._wavevectors[pick]
    ref = np.zeros(64)
    for f in range(N_FRAMES):
        phase = qs @ traj[f].astype(np.float64).T
        ref += np.cos(phase).sum(1) ** 2 + np.sin(phase).sum(1) ** 2
    ref /= N_FRAMES * N_ATOMS
    check(np.allclose(ssf[0, pick], ref, rtol=1e-4, atol=1e-5),
          "S(q) differs from the float64 direct sum")

    msd_self = ons.results.msd_self
    check(msd_self.shape == (1, 1, N_FRAMES)
          and np.all(np.isfinite(msd_self)), "MSD shape")
    check(abs(msd_self[0, 0, 0]) <= 1e-9 * np.abs(msd_self).max(),
          f"MSD at lag 0 is {msd_self[0, 0, 0]}")
    sub = ons._positions[:, :1000]
    fft_msd = msd_fft(torch.from_numpy(sub).to(device), axis=0,
                      average=True).cpu().numpy()
    direct = direct_msd(sub)
    check(np.allclose(fft_msd, direct, rtol=1e-8,
                      atol=1e-8 * np.abs(direct).max()),
          "msd_fft differs from the direct-lag MSD")
    print(f"slice: {N_ATOMS} atoms, {N_FRAMES} frames in chunks of "
          f"{CHUNK}, {len(q)} wavevectors; g(r) tail mean "
          f"{g[-20:].mean():.5f}; S(q) 64-point max rel err "
          f"{np.max(np.abs(ssf[0, pick] - ref) / ref):.3e}; "
          f"msd_self(last lag) {msd_self[0, 0, -1]:.4f}")
    return launches, fps


def phase_cross_rdf(device, rng):
    """The cross-RDF path: run_together([RDF(u.atoms[0::2],
    u.atoms[1::2])]) at 100k atoms, the bench's cross phase uncut."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    _, u = slice_universe(rng, RDF_FRAMES)
    rdf = path_analysis(u, device, "cross_rdf")
    cch.cross_pair_histogram.launches = 0
    fps = run_timed([rdf], RDF_FRAMES)
    launches = cch.cross_pair_histogram.launches
    n_chunks = -(-RDF_FRAMES // CHUNK)
    check(launches == n_chunks,
          f"{launches} cross kernel launches for {n_chunks} chunks")
    g = rdf.results.rdf
    check(np.all(np.isfinite(g)) and g.shape == (N_BINS,), "g(r) shape")
    check(np.all(np.abs(g[-20:] - 1.0) < 0.02),
          f"cross g(r) tail off 1: {g[-20:]}")
    print(f"cross RDF: {N_ATOMS // 2} x {N_ATOMS // 2} atoms, "
          f"{RDF_FRAMES} frames in chunks of {CHUNK}, {launches} launches; "
          f"g(r) tail mean {g[-20:].mean():.5f}")
    return launches, fps


def phase_vanhove(device, rng):
    """The Van Hove path: run_together([VanHoveFunction(u.atoms,
    n_lags=64, lags="log")]) at 100k atoms, the bench's vanhove phase
    uncut, on uncorrelated uniform frames."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    traj, u = slice_universe(rng, VH_FRAMES)
    vh = path_analysis(u, device, "vanhove")
    cch.cross_pair_histogram.launches = 0
    fps = run_timed([vh], VH_FRAMES)
    launches = cch.cross_pair_histogram.launches
    lags = np.rint(vh.results.times).astype(int)  # dt = 1, step 1
    sweeps = int(sum(np.sum(lags <= f) for f in range(VH_FRAMES)))
    # One launch a frame over all of its lags; lag 0 serves every frame.
    check(launches == VH_FRAMES,
          f"{launches} cross kernel launches for {VH_FRAMES} frames")
    check(len(lags) == 21, f"{len(lags)} lags, not 21")

    # Lag 0: every unordered pair in both orders, with the same d^2, so
    # the distinct counts equal the self kernel's ordered-pair counts.
    plan = cch.cell_plan_search(N_ATOMS, [BOX] * 3, R_MAX)
    self_counts = torch.zeros(N_BINS, dtype=torch.float64, device=device)
    box = torch.full((3,), BOX, dtype=torch.float32, device=device)
    for lo in range(0, VH_FRAMES, CHUNK):
        pos = torch.from_numpy(traj[lo:lo + CHUNK]).to(device)
        pos = pos - box * torch.floor(pos / box)  # the path's wrap
        counts, _ = cch.cell_pair_histogram(
            pos, box=box, r_max=R_MAX, n_cells_dim=plan["n_cells_dim"],
            capacity=plan["capacity"], n_bins=N_BINS,
        )
        self_counts += counts.sum(dim=0)
    distinct = vh.results.counts_distinct
    check(np.array_equal(distinct[0],
                         self_counts.cpu().numpy().astype(np.int64)),
          "lag-0 distinct counts != self kernel counts")

    counts_self = vh.results.counts_self
    check(counts_self[0, 0] == N_ATOMS * VH_FRAMES
          and counts_self[0, 1:].sum() == 0,
          "lag-0 self counts not all in bin 0")
    # Uncorrelated uniform frames: each minimum-image component is
    # uniform on [-L/2, L/2], so <r^2> = 3 L^2 / 12.
    msd = vh.results.msd
    check(msd[0] == 0 and np.all(np.abs(msd[1:] / (BOX**2 / 4) - 1) < 0.01),
          f"msd off L^2/4: {msd}")
    gd = vh.results.gd
    check(np.all(np.isfinite(gd)) and np.all(np.abs(gd[:, -20:] - 1) < 0.02),
          "distinct g(r, t) tail off 1")
    # The longest lag's self counts against float64 numpy, every origin.
    lag = int(lags[-1])
    ref = np.zeros(N_BINS, dtype=np.int64)
    for t in range(VH_FRAMES - lag):
        d = traj[t + lag].astype(np.float64) - traj[t].astype(np.float64)
        d -= BOX * np.round(d / BOX)
        ref += np.histogram(np.sqrt((d**2).sum(-1)), bins=N_BINS,
                            range=(0.0, R_MAX))[0]
    check(np.array_equal(counts_self[-1], ref),
          f"lag-{lag} self counts != float64 numpy")
    print(f"Van Hove: {N_ATOMS} atoms, {VH_FRAMES} frames in chunks of "
          f"{CHUNK}, {len(lags)} lags (ring {VH_LAGS}), {sweeps} distinct "
          f"sweeps in {launches} launches; lag-0 distinct == self kernel; "
          f"msd/(L^2/4) in [{msd[1:].min() / (BOX**2 / 4):.5f}, "
          f"{msd[1:].max() / (BOX**2 / 4):.5f}]; lag-{lag} self counts == "
          "float64 numpy")
    return launches, fps


def reset_launches():
    """Set every kernel wrapper's launch counts (in all, by sweep mode
    and by option) to 0."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    for kernel in (cch.cell_pair_histogram, cch.cross_pair_histogram,
                   cch.triclinic_cell_pair_histogram,
                   cch.triclinic_cross_pair_histogram):
        kernel.launches = 0
        for counts in (kernel.mode_launches, kernel.option_launches):
            for key in counts:
                counts[key] = 0


def phase_triclinic_kernels(device, rng):
    """The triclinic kernels vs their plain versions in the rhombic
    dodecahedron at the triclinic paths' shapes and at 400k atoms
    (where the JAX package runs its triclinic streaming kernels); on
    the triclinic straddle fixture, where both also equal a float64
    27-image oracle; and with a shrunk c-vector, where both poison."""

    import torch

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.testing import (
        edge_straddle_triclinic_positions,
        f64_triclinic_pair_histogram,
    )

    frames, box = uniform_frames(rng, device, 2, N_ATOMS,
                                 dodecahedron(DODECA_A))
    timing = {
        "self": self_kernel_vs_plain(
            frames, box, f"triclinic self kernel, {N_ATOMS} atoms"),
        "rdf": cross_kernel_vs_plain(
            frames[:, 0::2].contiguous(), frames[:, 1::2].contiguous(), box,
            f"triclinic cross kernel, cross-RDF shape {N_ATOMS // 2} x "
            f"{N_ATOMS // 2}"),
        "vanhove": cross_kernel_vs_plain(
            frames[:1], frames[1:], box,
            f"triclinic cross kernel, Van Hove shape {N_ATOMS} x {N_ATOMS},"
            " exclusion (1, 1)", exclusion=(1, 1)),
    }
    del frames
    big, big_box = uniform_frames(rng, device, 1, STREAM_ATOMS,
                                  dodecahedron(DODECA_STREAM_A))
    timing["self_stream"] = self_kernel_vs_plain(
        big, big_box, f"triclinic self kernel, {STREAM_ATOMS} atoms")
    timing["cross_stream"] = cross_kernel_vs_plain(
        big[:, 0::2].contiguous(), big[:, 1::2].contiguous(), big_box,
        f"triclinic cross kernel, {STREAM_ATOMS // 2} x "
        f"{STREAM_ATOMS // 2}")
    del big

    small = triclinic_matrices(dodecahedron(18.0)).astype(np.float32)
    fixture = edge_straddle_triclinic_positions(rng, small)
    r_s, bins_s = 4.0, 16
    grid = dict(r_max=r_s, n_bins=bins_s)
    widths = plan_extents(small)
    plan = cch.cell_plan_search(len(fixture), widths, r_s)
    fx = torch.from_numpy(fixture).to(device)
    self_args = dict(n_cells_dim=plan["n_cells_dim"],
                     capacity=plan["capacity"], **grid)
    k, _ = cch.triclinic_cell_pair_histogram(fx, box=small, **self_args)
    p, _ = cch.triclinic_cell_pair_histogram_reference(fx, box=small,
                                                       **self_args)
    oracle = f64_triclinic_pair_histogram(fixture, fixture, small, r_s,
                                          bins_s, exclusion=(1, 1))
    a, b = fx[:300], fx[300:]
    cplan = cch.cell_plan_search(300, widths, r_s, n_atoms2=90)
    cross_args = dict(n_cells_dim=cplan["n_cells_dim"],
                      capacity1=cplan["capacity"],
                      capacity2=cplan["capacity2"], **grid)
    ck, _, _ = cch.triclinic_cross_pair_histogram(a, b, box=small,
                                                  **cross_args)
    cp, _, _ = cch.triclinic_cross_pair_histogram_reference(a, b, box=small,
                                                            **cross_args)
    cross_oracle = f64_triclinic_pair_histogram(fixture[:300],
                                                fixture[300:], small, r_s,
                                                bins_s)
    torch.cuda.synchronize()
    for what, kern, plain, orc in (("self", k, p, oracle),
                                   ("cross", ck, cp, cross_oracle)):
        check(torch.equal(kern, plain),
              f"triclinic straddle fixture, {what}: kernel != plain")
        check(np.array_equal(kern[0].cpu().numpy().astype(np.int64), orc),
              f"triclinic straddle fixture, {what}: kernel != float64 "
              "27-image oracle")
    print("triclinic edge-straddle fixture: kernel == plain == float64 "
          f"27-image oracle (self {int(oracle.sum())}, cross "
          f"{int(cross_oracle.sum())} pairs)")

    shrunk = small.copy()
    shrunk[2] *= np.float32(0.5)  # c-vector's width under 3 * r_max
    bad_self, _ = cch.triclinic_cell_pair_histogram(fx, box=shrunk,
                                                    **self_args)
    bad_cross, _, _ = cch.triclinic_cross_pair_histogram(a, b, box=shrunk,
                                                         **cross_args)
    check(bool(torch.isnan(bad_self).all() and torch.isnan(bad_cross).all()),
          "shrunk c-vector: the triclinic kernels did not NaN-poison")
    print("shrunk c-vector: both triclinic kernels NaN-poison")
    return timing


def triclinic_universe(rng, n_frames):
    """`n_frames` uncorrelated frames of N_ATOMS atoms at uniform
    fractional coordinates in the 100k-atom rhombic dodecahedron, as an
    in-memory universe; also returns the float32 box matrix."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.core.universe import Universe

    dims6 = dodecahedron(DODECA_A)
    h64 = triclinic_matrices(dims6)
    traj = (rng.random((n_frames, N_ATOMS, 3)) @ h64).astype(np.float32)
    return traj, Universe.from_arrays(traj, dims6, dt=1.0), h64.astype(
        np.float32)


def phase_triclinic_rdf(device, rng):
    """The triclinic RDF paths: run_together([RDF(u.atoms,
    exclusion=(1, 1))]) and run_together([RDF(u.atoms[0::2],
    u.atoms[1::2])]) at 100k atoms in the rhombic dodecahedron, 8 + 48
    frames each."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
    )
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    _, u, _ = triclinic_universe(rng, TRI_RDF_FRAMES)
    n_chunks = -(-TRI_RDF_FRAMES // CHUNK)
    out = {}
    for path, groups, exclusion, kernel in (
        ("self", (u.atoms,), (1, 1), cch.triclinic_cell_pair_histogram),
        ("cross", (u.atoms[0::2], u.atoms[1::2]), None,
         cch.triclinic_cross_pair_histogram),
    ):
        rdf = RadialDistributionFunction(
            *groups, n_bins=N_BINS, range=(0.0, R_MAX), exclusion=exclusion,
            verbose=False, device=device,
        )
        rdf._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
        check(rdf._triclinic, "the dodecahedron was not taken as triclinic")
        reset_launches()
        fps = run_timed([rdf], TRI_RDF_FRAMES)
        launches = kernel.launches
        check(launches == n_chunks,
              f"{launches} triclinic {path} kernel launches for {n_chunks} "
              "chunks")
        g = rdf.results.rdf
        check(np.all(np.isfinite(g)) and g.shape == (N_BINS,), "g(r) shape")
        check(np.all(np.abs(g[-20:] - 1.0) < 0.02),
              f"triclinic {path} g(r) tail off 1: {g[-20:]}")
        plan = rdf._searched_cell_plan()
        print(f"triclinic {path} RDF: {N_ATOMS} atoms, plan "
              f"{plan['n_cells_dim']}, {TRI_RDF_FRAMES} frames in chunks of "
              f"{CHUNK}, {launches} launches; g(r) tail mean "
              f"{g[-20:].mean():.5f}")
        out[path] = (launches, fps)
    return out


def phase_triclinic_vanhove(device, rng):
    """The triclinic Van Hove path: run_together([VanHoveFunction(
    u.atoms, n_lags=64, lags="log")]) at 100k atoms in the rhombic
    dodecahedron, depth cut to 8 + 32 frames (19 lags, a 40-frame
    ring), with the orthorhombic path's checks."""

    import torch

    from mdhelper_tpu_torch.analysis.structure import VanHoveFunction
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.testing import f64_triclinic_distances

    traj, u, box = triclinic_universe(rng, TRI_VH_FRAMES)
    vh = VanHoveFunction(u.atoms, n_bins=N_BINS, range=(0.0, R_MAX),
                         n_lags=VH_LAGS, lags="log", verbose=False,
                         device=device)
    vh._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    reset_launches()
    fps = run_timed([vh], TRI_VH_FRAMES)
    launches = cch.triclinic_cross_pair_histogram.launches
    lags = np.rint(vh.results.times).astype(int)  # dt = 1, step 1
    sweeps = int(sum(np.sum(lags <= f) for f in range(TRI_VH_FRAMES)))
    check(launches == TRI_VH_FRAMES,
          f"{launches} triclinic cross kernel launches for {TRI_VH_FRAMES} "
          "frames")
    check(len(lags) == 19, f"{len(lags)} lags, not 19")

    # Lag 0: each pair in both orders, their block translations opposite,
    # so the distinct counts equal the triclinic self kernel's.
    plan = cch.cell_plan_search(N_ATOMS, plan_extents(box), R_MAX)
    self_counts = torch.zeros(N_BINS, dtype=torch.float64, device=device)
    for lo in range(0, TRI_VH_FRAMES, CHUNK):
        counts, _ = cch.triclinic_cell_pair_histogram(
            torch.from_numpy(traj[lo:lo + CHUNK]).to(device), box=box,
            r_max=R_MAX, n_cells_dim=plan["n_cells_dim"],
            capacity=plan["capacity"], n_bins=N_BINS,
        )
        self_counts += counts.sum(dim=0)
    check(np.array_equal(vh.results.counts_distinct[0],
                         self_counts.cpu().numpy().astype(np.int64)),
          "triclinic lag-0 distinct counts != triclinic self kernel counts")

    counts_self = vh.results.counts_self
    check(counts_self[0, 0] == N_ATOMS * TRI_VH_FRAMES
          and counts_self[0, 1:].sum() == 0,
          "triclinic lag-0 self counts not all in bin 0")
    gd = vh.results.gd
    check(np.all(np.isfinite(gd)) and np.all(np.abs(gd[:, -20:] - 1) < 0.02),
          "triclinic distinct g(r, t) tail off 1")
    # The longest lag's self counts and MSD against float64 numpy over
    # the 27 images, every origin.
    lag = int(lags[-1])
    ref = np.zeros(N_BINS, dtype=np.int64)
    r2 = 0.0
    for t in range(TRI_VH_FRAMES - lag):
        dist = f64_triclinic_distances(traj[t + lag], traj[t], box)
        ref += np.histogram(dist, bins=N_BINS, range=(0.0, R_MAX))[0]
        r2 += (dist**2).sum()
    check(np.array_equal(counts_self[-1], ref),
          f"triclinic lag-{lag} self counts != float64 numpy")
    msd_ref = r2 / ((TRI_VH_FRAMES - lag) * N_ATOMS)
    check(abs(vh.results.msd[-1] / msd_ref - 1) < 1e-5,
          f"triclinic lag-{lag} msd {vh.results.msd[-1]} != {msd_ref}")
    print(f"triclinic Van Hove: {N_ATOMS} atoms, {TRI_VH_FRAMES} frames in "
          f"chunks of {CHUNK}, {len(lags)} lags, {sweeps} distinct sweeps in "
          f"{launches} launches; lag-0 distinct == triclinic self kernel; "
          f"lag-{lag} self counts == float64 numpy, msd {msd_ref:.4f}")
    return launches, fps


def forced_plan(n_atoms, box, r_max, grid, mode, n_atoms2=None):
    """The generalized plan of `grid` (``grid_plan``), checked to run
    the sweep `mode`: the kernel checks take their plans from here, so
    they do not depend on the planner."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    plan = cch.grid_plan(n_atoms, plan_extents(box), r_max, grid,
                         n_atoms2=n_atoms2)
    got = cch._sweep_mode(grid, plan["reach"], np.ndim(box) == 2,
                          n_atoms2 is not None)
    check(got == mode, f"grid {grid} runs {got}, not {mode}")
    return plan


def straddle_and_poison(device, rng, triclinic):
    """The new modes on the bin-edge straddle fixtures in a box under 3
    cutoffs (a cube of 16, or the small dodecahedron, under r_max 6):
    kernel == plain == float64 oracle (27-image for tri_pp); then a
    frame whose box shrank below a grid with an axis the sweep does not
    span whole: kernel and plain both NaN there, equal elsewhere."""

    import torch

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.testing import (
        edge_straddle_cross_positions,
        edge_straddle_positions,
        edge_straddle_triclinic_positions,
        f64_cross_histogram,
        f64_pair_histogram,
        f64_triclinic_pair_histogram,
    )

    r_s, bins_s = 6.0, 24
    if triclinic:
        box = triclinic_matrices(dodecahedron(18.0)).astype(np.float32)
        fixture = edge_straddle_triclinic_positions(rng, box)
        self_kernel = (cch.triclinic_cell_pair_histogram,
                       cch.triclinic_cell_pair_histogram_reference)
        cross_kernel = (cch.triclinic_cross_pair_histogram,
                        cch.triclinic_cross_pair_histogram_reference)
        self_oracle = f64_triclinic_pair_histogram(fixture, fixture, box,
                                                   r_s, bins_s, (1, 1))
        a, b = fixture[:300], fixture[300:]
        cross_oracle = f64_triclinic_pair_histogram(a, b, box, r_s, bins_s)
        self_grids = [((2, 5, 6), "tri_pp")]
        cross_grid, cross_mode = (2, 5, 6), "tri_pp"
    else:
        box = (16.0,) * 3
        fixture = edge_straddle_positions(rng, 16.0)
        self_kernel = (cch.cell_pair_histogram,
                       cch.cell_pair_histogram_reference)
        cross_kernel = (cch.cross_pair_histogram,
                        cch.cross_pair_histogram_reference)
        self_oracle = f64_pair_histogram(fixture, 16.0, r_s, bins_s)
        a, b = edge_straddle_cross_positions(rng, 16.0)
        cross_oracle = f64_cross_histogram(a, b, 16.0, r_s, bins_s)
        self_grids = [((5, 5, 5), "general"), ((1, 2, 6), "ordered")]
        cross_grid, cross_mode = (2, 5, 6), "general"
    fx = torch.from_numpy(fixture).to(device)
    results = []
    for grid, mode in self_grids:
        plan = forced_plan(len(fixture), box, r_s, grid, mode)
        args = dict(box=box, r_max=r_s, n_cells_dim=grid,
                    reach=plan["reach"], capacity=plan["capacity"],
                    n_bins=bins_s)
        results.append((f"self {mode}", self_kernel[0](fx, **args),
                        self_kernel[1](fx, **args), self_oracle))
    plan = forced_plan(len(a), box, r_s, cross_grid, cross_mode,
                       n_atoms2=len(b))
    args = dict(box=box, r_max=r_s, n_cells_dim=cross_grid,
                reach=plan["reach"], capacity1=plan["capacity"],
                capacity2=plan["capacity2"], n_bins=bins_s)
    fa = torch.from_numpy(a).to(device)
    fb = torch.from_numpy(b).to(device)
    results.append((f"cross {cross_mode}", cross_kernel[0](fa, fb, **args),
                    cross_kernel[1](fa, fb, **args), cross_oracle))
    torch.cuda.synchronize()
    for what, kern, plain, oracle in results:
        check(torch.equal(kern[0], plain[0]),
              f"straddle fixture, {what}: kernel != plain")
        check(np.array_equal(kern[0][0].cpu().numpy().astype(np.int64),
                             oracle),
              f"straddle fixture, {what}: kernel != float64 oracle")
    print(f"{'triclinic ' if triclinic else ''}straddle fixture under 3 "
          f"cutoffs: {', '.join(r[0] for r in results)} kernels == plain "
          "== float64 oracle "
          f"(self {int(self_oracle.sum())}, cross {int(cross_oracle.sum())} "
          "pairs)")

    # Shrunk frames: a half-shell grid of reach 2 along z and an ordered
    # grid in boxes shrunk to 0.7, or a tri_pp grid of 4 cells along c
    # with the c-vector halved; both sweeps of each must poison frame 1
    # only.
    n = 3000
    if triclinic:
        good = triclinic_matrices(dodecahedron(18.0)).astype(np.float32)
        bad = good.copy()
        bad[2] *= np.float32(0.5)
        boxes = np.stack([good, bad])
        frac = rng.random((2, n, 3))
        pos = np.stack([frac[f] @ boxes[f].astype(np.float64)
                        for f in range(2)]).astype(np.float32)
        cases = [(boxes, pos, 3.0, (1, 1, 4), "tri_pp", good)]
    else:
        cases = []
        for lengths, r_p, grid, mode in (((40.0,) * 3, 6.0, (3, 3, 10),
                                          "general"),
                                         ((16.0, 16.0, 40.0), 6.0,
                                          (1, 2, 10), "ordered")):
            good = np.float32(lengths)
            boxes = np.stack([good, good * np.float32(0.7)])
            pos = (rng.random((2, n, 3)) * boxes[:, None]).astype(np.float32)
            cases.append((boxes, pos, r_p, grid, mode, good))
    for boxes, pos, r_p, grid, mode, good in cases:
        plan = forced_plan(n, good, r_p, grid, mode)
        f = torch.from_numpy(pos).to(device)
        grid_args = dict(box=torch.from_numpy(boxes), r_max=r_p,
                         n_cells_dim=grid, reach=plan["reach"], n_bins=64)
        outs = [
            (self_kernel[0](f, capacity=plan["capacity"], **grid_args),
             self_kernel[1](f, capacity=plan["capacity"], **grid_args)),
            (cross_kernel[0](f, f.flip(1), capacity1=plan["capacity"],
                             capacity2=plan["capacity"], exclusion=(1, 1),
                             **grid_args),
             cross_kernel[1](f, f.flip(1), capacity1=plan["capacity"],
                             capacity2=plan["capacity"], exclusion=(1, 1),
                             **grid_args)),
        ]
        torch.cuda.synchronize()
        for kern, plain in outs:
            check(bool(torch.isnan(kern[0][1]).all()
                       and torch.isnan(plain[0][1]).all()),
                  f"shrunk frame, {mode} grid {grid}: not NaN-poisoned")
            check(torch.equal(kern[0][0], plain[0][0])
                  and kern[0][0].sum() > 0,
                  f"shrunk frame, {mode} grid {grid}: frame 0 differs")
        print(f"shrunk frame, {mode} grid {grid}: self and cross kernels "
              "and plain versions NaN-poison it, equal on the other frame")


def check_planner_constants():
    """The card's SM count and opt-in shared memory a block beside the
    planner's constants (its SM-fill term and launch limit)."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    props = torch.cuda.get_device_properties(0)
    smem = getattr(props, "shared_memory_per_block_optin", None)
    print(f"card: {props.multi_processor_count} SMs (planner assumes "
          f"{cch._N_SMS}), opt-in shared memory a block {smem} B "
          f"(planner and launch limit {cch._SMEM_BYTES})")
    if smem is not None:
        check(smem == cch._SMEM_BYTES, "opt-in shared memory differs from "
              "the wrappers' launch limit")


def planner_variants(n_atoms, extents, r_max, n_atoms2=None):
    """The planner's plan, and the plan it picks with its SM-fill floor
    ``_FILL_BLOCKS`` set to 0: what that GPU cost term changes."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    def search():
        return cch.cell_plan_search(n_atoms, extents, r_max,
                                    n_atoms2=n_atoms2)

    plans = {"planner": search()}
    kept = cch._FILL_BLOCKS
    cch._FILL_BLOCKS = 0
    try:
        plans["no SM-fill term"] = search()
    finally:
        cch._FILL_BLOCKS = kept
    return plans


def kernel_timed(kernel, n_frames, what, work):
    """A kernel wrapper alone (no plain version), in ms a frame beside the
    bound of `work`."""

    import torch

    k_out = kernel()
    check(bool(torch.isfinite(k_out[0]).all()), f"{what}: counts not finite")
    work = work["rebound"](counted_pairs(k_out[0], work))
    kernel_ms = [time_ms(kernel, 3) for _ in range(2)]
    out = {"ms": float(np.mean(kernel_ms)) / n_frames, **work}
    print(f"{what}: {int(k_out[0].sum())} pairs in range over "
          f"{n_frames} frame(s); per frame kernel {out['ms']:.3f} ms (runs "
          f"{[round(x / n_frames, 3) for x in kernel_ms]}); "
          f"{out['pairs_per_frame']:.0f} slot pairs binned a frame, bound "
          f"{out['bound_ms']:.3f} ms by {out['bound_by']}")
    return out, k_out


def plans_compared(frames1, frames2, box, r_max, what, jax_grid,
                   exclusion=None, with_plain=True):
    """One small-box shape's kernel (self when `frames2` is None, else
    cross) on the plan its path runs -- the planner's -- and, as extra
    cases, on the JAX package's grid `jax_grid` and on the planner's
    pick without its SM-fill term; every plan's kernel timed
    and its counts equal as integers.  With `with_plain`, the planner's
    and the JAX grid's kernels are held against their plain versions;
    without it (where the plain version would take minutes) the
    planner's kernel is held against the kernel on the JAX grid.
    Returns the planner plan's timing (its kernels-line row) and its
    plan."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    n_frames, n1 = frames1.shape[:2]
    n2 = None if frames2 is None else frames2.shape[1]
    extents = plan_extents(box)
    plans = planner_variants(n1, extents, r_max, n2)
    plans["JAX package's"] = cch.grid_plan(n1, extents, r_max, jax_grid,
                                           n_atoms2=n2)
    order = ("planner", "JAX package's", "no SM-fill term")
    timings, seen, want = {}, {}, None
    for name in order:
        plan = plans[name]
        grid = plan["n_cells_dim"]
        if grid in seen:
            timings[name] = timings[seen[grid]]
            continue
        seen[grid] = name
        kernel, plain, work, text = sweep_calls(
            frames1, frames2, box, plan, r_max, GEN_BINS, exclusion)
        label = f"{what}, {name} plan, {text}"
        if with_plain and name in ("planner", "JAX package's"):
            out, k_out = kernel_vs_plain(
                kernel, plain, n_frames, label, work,
                plain_runs=2 if name == "planner" else 1)
        else:
            out, k_out = kernel_timed(kernel, n_frames, label, work)
        check_capacity(k_out, plan)
        if want is None:
            want = k_out[0]
        else:
            check(torch.equal(k_out[0], want),
                  f"{label}: counts differ from the planner plan's")
            print(f"{label}: counts == the planner plan's")
            if not with_plain and name == "JAX package's":
                timings["planner"]["max_abs_err"] = float(
                    (k_out[0] - want).abs().max())
        timings[name] = out
        del k_out
    print(f"{what}, kernel ms a frame by plan: " + "; ".join(
        f"{name} {plans[name]['n_cells_dim']} {timings[name]['ms']:.3f}"
        for name in order))
    return timings["planner"], plans["planner"]


def phase_generalized_kernels(device, rng):
    """The generalized orthorhombic kernels vs their plain versions at
    the shapes of the small-box paths, each on the plan its path runs
    (the planner's) and, as extra cases, on the JAX package's choice and
    the planner's pick without its SM-fill term (:func:`plans_compared`):
    the half-shell self sweep of reach 2 in the 50k-atom cube, the cross
    sweep at the cross-RDF and Van Hove shapes there, and the ordered
    self sweep in the 5,000-atom cube; then the straddle fixtures and
    shrunk frames."""

    frames, box = uniform_frames(rng, device, 2, GEN_ATOMS, cube(GEN_ATOMS))
    timing = {
        "general": plans_compared(
            frames[:1], None, box, GEN_R,
            f"generalized self kernel, {GEN_ATOMS} atoms", (5, 5, 5)),
        "cross": plans_compared(
            frames[:1, 0::2].contiguous(), frames[:1, 1::2].contiguous(),
            box, GEN_R, f"generalized cross kernel, {GEN_ATOMS // 2} x "
            f"{GEN_ATOMS // 2}", (2, 5, 6)),
        "vanhove": plans_compared(
            frames[:1], frames[1:], box, GEN_R,
            f"generalized cross kernel, Van Hove shape {GEN_ATOMS} x "
            f"{GEN_ATOMS}, exclusion (1, 1)", (2, 6, 10), exclusion=(1, 1)),
    }
    del frames
    small, small_box = uniform_frames(rng, device, 2, SMALL_ATOMS,
                                      cube(SMALL_ATOMS))
    timing["ordered"] = plans_compared(
        small, None, small_box, ORDERED_R,
        f"ordered self kernel, {SMALL_ATOMS} atoms", (1, 2, 6))
    straddle_and_poison(device, rng, triclinic=False)
    return timing


def phase_tri_pp_kernels(device, rng):
    """The tri_pp kernels (:func:`plans_compared`).  In the 5,000-atom
    dodecahedron under r_max 6 (widths 2.4-2.8 cutoffs), against their
    plain versions: cross 5,000 x 5,000 with exclusion (1, 1) (the Van
    Hove path's shape), self, and cross 2,500 x 2,500 (the plain times
    of the 50k rows below).  In the 50k-atom dodecahedron under r_max 15,
    the self and the 25,000 x 25,000 cross RDF paths' shapes, where the
    plain version would take minutes a frame: each on its path's plan
    against the kernel on the JAX package's grid.  Then the straddle
    fixtures against the float64 27-image oracle and a halved
    c-vector."""

    frames, box = uniform_frames(rng, device, 2, SMALL_ATOMS,
                                 dodecahedron(TRI_PP_A))
    half = SMALL_ATOMS // 2
    timing = {
        "vanhove": plans_compared(
            frames[:1], frames[1:], box, TRI_PP_R,
            f"tri_pp cross kernel, Van Hove shape {SMALL_ATOMS} x "
            f"{SMALL_ATOMS}, exclusion (1, 1)", (2, 5, 6), exclusion=(1, 1)),
        "self_small": plans_compared(
            frames[:1], None, box, TRI_PP_R,
            f"tri_pp self kernel, {SMALL_ATOMS} atoms", (2, 5, 6)),
        "cross_small": plans_compared(
            frames[:1, 0::2].contiguous(), frames[:1, 1::2].contiguous(),
            box, TRI_PP_R, f"tri_pp cross kernel, {half} x {half}",
            (2, 3, 5)),
    }
    del frames
    # Their own generator: the draws of the phases after this one stay
    # what they were before these shapes were added.
    frames, box = uniform_frames(np.random.default_rng(SEED + 3), device, 1,
                                 GEN_ATOMS, dodecahedron(GEN_DODECA_A))
    timing["self"] = plans_compared(
        frames, None, box, GEN_R, f"tri_pp self kernel, {GEN_ATOMS} atoms",
        (6, 9, 11), with_plain=False)
    timing["cross"] = plans_compared(
        frames[:, 0::2].contiguous(), frames[:, 1::2].contiguous(), box,
        GEN_R, f"tri_pp cross kernel, {GEN_ATOMS // 2} x {GEN_ATOMS // 2}",
        (6, 7, 7), with_plain=False)
    del frames
    straddle_and_poison(device, rng, triclinic=True)
    return timing


def phase_full_size_cross_checks(device, rng):
    """At 100k atoms, no plain version: in the dodecahedron the tri_pp
    self and cross kernels forced onto the planner's reach-1 grid equal
    the per-block kernels as integers; in the cube a generalized reach-2
    grid equals the planner's reach-1 grid, self and cross."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    frames, box = uniform_frames(rng, device, 2, N_ATOMS,
                                 dodecahedron(DODECA_A))
    plan = cch.cell_plan_search(N_ATOMS, plan_extents(box), R_MAX)
    check(not cch.plan_is_tri_pp(plan, True), "expected a per-block grid")
    grid = dict(r_max=R_MAX, n_cells_dim=plan["n_cells_dim"], n_bins=N_BINS)
    block, _ = cch._self_kernel(frames, box, capacity=plan["capacity"],
                                triclinic=True, **grid)
    per_pair, _ = cch._self_kernel(frames, box, capacity=plan["capacity"],
                                   triclinic=True, mode="tri_pp", **grid)
    g1, g2 = frames[:, 0::2].contiguous(), frames[:, 1::2].contiguous()
    cplan = cch.cell_plan_search(N_ATOMS // 2, plan_extents(box), R_MAX,
                                 n_atoms2=N_ATOMS // 2)
    cgrid = dict(r_max=R_MAX, n_cells_dim=cplan["n_cells_dim"],
                 n_bins=N_BINS, capacity1=cplan["capacity"],
                 capacity2=cplan["capacity2"], exclusion=None,
                 triclinic=True)
    cross_block = cch._cross_kernel(g1, g2, box, **cgrid)
    cross_pp = cch._cross_kernel(g1, g2, box, mode="tri_pp", **cgrid)
    torch.cuda.synchronize()
    check(torch.equal(block, per_pair) and bool(torch.isfinite(block).all()),
          "tri_pp self kernel != per-block self kernel at 100k atoms")
    check(torch.equal(cross_block[0], cross_pp[0]),
          "tri_pp cross kernel != per-block cross kernel at 50k x 50k")
    print(f"dodecahedron, {N_ATOMS} atoms: tri_pp self and cross kernels "
          f"on the reach-1 grids {plan['n_cells_dim']} and "
          f"{cplan['n_cells_dim']} == per-block kernels "
          f"({int(block.sum())} and {int(cross_block[0].sum())} pairs)")
    del frames, g1, g2

    frames, box = uniform_frames(rng, device, 2, N_ATOMS, cube(N_ATOMS))
    out = []
    for grid in (None, (16, 16, 16)):
        plan = (cch.cell_plan_search(N_ATOMS, plan_extents(box), R_MAX)
                if grid is None else
                forced_plan(N_ATOMS, box, R_MAX, grid, "general"))
        cplan = (cch.cell_plan_search(N_ATOMS // 2, plan_extents(box), R_MAX,
                                      n_atoms2=N_ATOMS // 2)
                 if grid is None else
                 forced_plan(N_ATOMS // 2, box, R_MAX, grid, "general",
                             n_atoms2=N_ATOMS // 2))
        self_counts, _ = cch.cell_pair_histogram(
            frames, box=box, r_max=R_MAX, n_cells_dim=plan["n_cells_dim"],
            reach=plan["reach"], capacity=plan["capacity"], n_bins=N_BINS)
        cross_counts, _, _ = cch.cross_pair_histogram(
            frames[:, 0::2].contiguous(), frames[:, 1::2].contiguous(),
            box=box, r_max=R_MAX, n_cells_dim=cplan["n_cells_dim"],
            reach=cplan["reach"], capacity1=cplan["capacity"],
            capacity2=cplan["capacity2"], n_bins=N_BINS)
        out.append((plan, self_counts, cross_counts))
    torch.cuda.synchronize()
    (p1, s1, c1), (p2, s2, c2) = out
    check(torch.equal(s1, s2) and torch.equal(c1, c2)
          and bool(torch.isfinite(s1).all()),
          "generalized reach-2 kernels != reach-1 kernels at 100k atoms")
    print(f"cube, {N_ATOMS} atoms: generalized reach-{p2['reach'][0]} grid "
          f"{p2['n_cells_dim']} == reach-1 grid {p1['n_cells_dim']}, self "
          f"and {N_ATOMS // 2} x {N_ATOMS // 2} cross "
          f"({int(s1.sum())} and {int(c1.sum())} pairs)")


def small_box_universe(rng, n_atoms, dims6, n_frames):
    """`n_frames` uncorrelated frames of `n_atoms` uniform float32 atoms
    (at uniform fractional coordinates in a triclinic box), as an
    in-memory universe; also returns the trajectory and the kernels'
    box (lengths, or the float32 matrix)."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.core.universe import Universe

    frac = rng.random((n_frames, n_atoms, 3), dtype=np.float32)
    if np.allclose(dims6[3:], 90.0):
        traj = frac * np.float32(dims6[:3])
        box = tuple(float(x) for x in dims6[:3])
    else:
        h64 = triclinic_matrices(dims6)
        traj = (frac.astype(np.float64) @ h64).astype(np.float32)
        box = h64.astype(np.float32)
    return traj, Universe.from_arrays(traj, dims6, dt=1.0), box


def run_rdf_path(u, groups, r_max, n_frames, kernel, mode, what, device):
    """run_together([RDF(*groups)]) at the classes' defaults but for
    `r_max`, launch counts set to 0 just before and read just after:
    every chunk must launch `kernel` in sweep `mode`; the g(r) tail
    within 0.02 of 1.  Returns (launches, frames/s, the path's plan)."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
    )

    n_atoms = u.atoms.n_atoms
    rdf = RadialDistributionFunction(*groups, n_bins=GEN_BINS,
                                     range=(0.0, r_max), verbose=False,
                                     device=device)
    rdf._chunk_bytes = CHUNK * n_atoms * 3 * 4
    reset_launches()
    fps = run_timed([rdf], n_frames)
    launches = kernel.mode_launches[mode]
    n_chunks = -(-n_frames // CHUNK)
    check(launches == n_chunks == kernel.launches,
          f"{what}: {launches} {mode} launches ({kernel.launches} in all) "
          f"for {n_chunks} chunks")
    g = rdf.results.rdf
    check(np.all(np.isfinite(g)) and g.shape == (GEN_BINS,), "g(r) shape")
    check(np.all(np.abs(g[-20:] - 1.0) < 0.02),
          f"{what} g(r) tail off 1: {g[-20:]}")
    plan = rdf._searched_cell_plan()
    print(f"{what}: {n_atoms} atoms, plan {plan['n_cells_dim']} reach "
          f"{plan['reach']} capacity {plan['capacity']}, {n_frames} frames "
          f"in chunks of "
          f"{CHUNK}, {launches} launches; g(r) tail mean "
          f"{g[-20:].mean():.5f}; {fps:.3f} frames/s (information, not a "
          "claim)")
    return launches, fps, plan


def phase_small_box_rdf(device, rng):
    """The small-box RDF paths, 201 bins on [0, r_max]: in the 50k-atom
    cube (r_max 15, 2.65 cutoffs) the self RDF (generalized half shell)
    and the cross RDF of atoms[0::2] and atoms[1::2] (generalized cross),
    8 + 48 frames; in the 5,000-atom cube under r_max 8 the self RDF
    (ordered sweep), 8 + 16 frames; in the 50k-atom dodecahedron (r_max
    15) the self and cross RDF (tri_pp), 8 + 16 frames."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    out = {}
    _, u, _ = small_box_universe(rng, GEN_ATOMS, cube(GEN_ATOMS),
                                 GEN_RDF_FRAMES)
    out["general"] = run_rdf_path(
        u, (u.atoms,), GEN_R, GEN_RDF_FRAMES, cch.cell_pair_histogram,
        "general", "small-box self RDF", device)
    out["cross"] = run_rdf_path(
        u, (u.atoms[0::2], u.atoms[1::2]), GEN_R, GEN_RDF_FRAMES,
        cch.cross_pair_histogram, "general", "small-box cross RDF", device)
    _, u, _ = small_box_universe(rng, SMALL_ATOMS, cube(SMALL_ATOMS),
                                 SMALL_RDF_FRAMES)
    out["ordered"] = run_rdf_path(
        u, (u.atoms,), ORDERED_R, SMALL_RDF_FRAMES, cch.cell_pair_histogram,
        "ordered", "ordered self RDF", device)
    _, u, _ = small_box_universe(rng, GEN_ATOMS, dodecahedron(GEN_DODECA_A),
                                 TRI_PP_RDF_FRAMES)
    out["tri_pp_self"] = run_rdf_path(
        u, (u.atoms,), GEN_R, TRI_PP_RDF_FRAMES,
        cch.triclinic_cell_pair_histogram, "tri_pp", "tri_pp self RDF",
        device)
    out["tri_pp_cross"] = run_rdf_path(
        u, (u.atoms[0::2], u.atoms[1::2]), GEN_R, TRI_PP_RDF_FRAMES,
        cch.triclinic_cross_pair_histogram, "tri_pp", "tri_pp cross RDF",
        device)
    return out


def run_vanhove_path(device, traj, u, box, r_max, n_frames, cross_kernel,
                     self_kernel, mode, what):
    """run_together([VanHoveFunction(u.atoms, n_lags=64, lags="log")])
    at the classes' defaults but for `r_max`, on uncorrelated frames,
    with the Van Hove paths' checks: one `cross_kernel` launch a frame
    in sweep `mode`; 19 lags; the lag-0 distinct counts equal the self
    kernel's (`self_kernel` on the planner's self plan); the lag-0 self
    counts all in bin 0; each lag's distinct g(r, t) tail (the mean of
    its last 20 bins) within 0.02 of 1; the longest lag's self counts
    equal to float64 numpy over the minimum image (27 images in a
    triclinic box).  Returns (launches, frames/s, the path's plan)."""

    import torch

    from mdhelper_tpu_torch.analysis.structure import VanHoveFunction
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.testing import f64_triclinic_distances

    n_atoms = u.atoms.n_atoms
    triclinic = np.ndim(box) == 2
    vh = VanHoveFunction(u.atoms, n_bins=GEN_BINS, range=(0.0, r_max),
                         n_lags=VH_LAGS, lags="log", verbose=False,
                         device=device)
    vh._chunk_bytes = CHUNK * n_atoms * 3 * 4
    reset_launches()
    fps = run_timed([vh], n_frames)
    launches = cross_kernel.mode_launches[mode]
    lags = np.rint(vh.results.times).astype(int)  # dt = 1, step 1
    sweeps = int(sum(np.sum(lags <= f) for f in range(n_frames)))
    check(launches == n_frames == cross_kernel.launches,
          f"{what}: {launches} {mode} launches ({cross_kernel.launches} in "
          f"all) for {n_frames} frames")
    check(len(lags) == 19, f"{what}: {len(lags)} lags, not 19")

    plan = cch.cell_plan_search(n_atoms, plan_extents(box), r_max)
    self_counts = torch.zeros(GEN_BINS, dtype=torch.float64, device=device)
    for lo in range(0, n_frames, CHUNK):
        pos = torch.from_numpy(traj[lo:lo + CHUNK]).to(device)
        if not triclinic:
            lengths = torch.tensor(box, dtype=torch.float32, device=device)
            pos = pos - lengths * torch.floor(pos / lengths)  # the path's
        counts, _ = self_kernel(
            pos, box=box, r_max=r_max, n_cells_dim=plan["n_cells_dim"],
            reach=plan["reach"], capacity=plan["capacity"], n_bins=GEN_BINS)
        self_counts += counts.sum(dim=0)
    check(np.array_equal(vh.results.counts_distinct[0],
                         self_counts.cpu().numpy().astype(np.int64)),
          f"{what}: lag-0 distinct counts != self kernel counts")
    counts_self = vh.results.counts_self
    check(counts_self[0, 0] == n_atoms * n_frames
          and counts_self[0, 1:].sum() == 0,
          f"{what}: lag-0 self counts not all in bin 0")
    gd = vh.results.gd
    # A per-lag tail mean: the longest lags of the 5,000-atom path have
    # one origin, where single bins scatter by about half a percent.
    tail = gd[:, -20:].mean(axis=1)
    check(np.all(np.isfinite(gd)) and np.all(np.abs(tail - 1) < 0.02),
          f"{what}: distinct g(r, t) tail off 1: {tail}")
    lag = int(lags[-1])
    ref = np.zeros(GEN_BINS, dtype=np.int64)
    for t in range(n_frames - lag):
        if triclinic:
            dist = f64_triclinic_distances(traj[t + lag], traj[t], box)
        else:
            lengths = np.asarray(box, np.float64)
            d = traj[t + lag].astype(np.float64) - traj[t].astype(np.float64)
            d -= lengths * np.round(d / lengths)
            dist = np.sqrt((d**2).sum(-1))
        ref += np.histogram(dist, bins=GEN_BINS, range=(0.0, r_max))[0]
    check(np.array_equal(counts_self[-1], ref),
          f"{what}: lag-{lag} self counts != float64 numpy")
    plan = vh._searched_cell_plan()
    print(f"{what}: {n_atoms} atoms, plan {plan['n_cells_dim']} reach "
          f"{plan['reach']} capacity {plan['capacity']}, {n_frames} frames "
          f"in chunks of {CHUNK}, {len(lags)} lags, {sweeps} distinct sweeps "
          f"in {launches} launches; lag-0 distinct == self kernel; lag-{lag} "
          f"self counts == float64 numpy; {fps:.3f} frames/s (information, "
          "not a claim)")
    return launches, fps, plan


def phase_small_box_vanhove(device, rng):
    """The small-box Van Hove paths: the 50k-atom cube under r_max 15
    (generalized cross sweep), 8 + 32 frames, and the 5,000-atom
    dodecahedron under r_max 6 (tri_pp), 8 + 32 frames."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    traj, u, box = small_box_universe(rng, GEN_ATOMS, cube(GEN_ATOMS),
                                      GEN_VH_FRAMES)
    out = {"general": run_vanhove_path(
        device, traj, u, box, GEN_R, GEN_VH_FRAMES, cch.cross_pair_histogram,
        cch.cell_pair_histogram, "general", "small-box Van Hove")}
    del traj, u
    traj, u, box = small_box_universe(rng, SMALL_ATOMS,
                                      dodecahedron(TRI_PP_A),
                                      TRI_PP_VH_FRAMES)
    out["tri_pp"] = run_vanhove_path(
        device, traj, u, box, TRI_PP_R, TRI_PP_VH_FRAMES,
        cch.triclinic_cross_pair_histogram,
        cch.triclinic_cell_pair_histogram, "tri_pp", "tri_pp Van Hove")
    return out


def film_frames(rng, device, n_frames):
    """`n_frames` uniform float32 frames of N_ATOMS atoms in the film
    (100 x 100 x 12.5 A, density 0.8), and its lengths."""

    import torch

    pos = (rng.random((n_frames, N_ATOMS, 3)) * np.float32(FILM)).astype(
        np.float32)
    return torch.from_numpy(pos).to(device), FILM


def phase_mode_kernels(device, rng):
    """Slice 5's kernel modes against their plain versions, each on the
    plan its path runs (the planner's): the water path's (3, 3) and
    (2, 3) tiles and the offset paths' bins from 2 A at 100k atoms in the
    cube, the tiles and offset bins on the ordered 5,000-atom cube (r 8),
    the per-block 100k dodecahedron and the tri_pp 5,000-atom
    dodecahedron (r 6), the film paths' 2-D self and cross sweeps, and
    fast binning of both kernels on every geometry against the plain
    fast versions.  Returns each row's timing by name."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    out = {}
    cube_frames, cube_box = uniform_frames(rng, device, 1, N_ATOMS,
                                           cube(N_ATOMS))
    halves = (cube_frames[:, 0::2].contiguous(),
              cube_frames[:, 1::2].contiguous())
    for ex in WATER_TILES:
        out[f"tiles {ex}"] = self_kernel_vs_plain(
            cube_frames, cube_box, f"self kernel, {N_ATOMS} atoms, water "
            "path", r_max=R_MAX, n_bins=N_BINS, exclusion=ex, plain_runs=1)
    out["offset self"] = self_kernel_vs_plain(
        cube_frames, cube_box, f"self kernel, {N_ATOMS} atoms, offset path",
        r_max=R_MAX, n_bins=N_BINS, r_min=OFFSET_RANGE[0], plain_runs=1)
    out["offset cross"] = cross_kernel_vs_plain(
        *halves, cube_box, f"cross kernel, {N_ATOMS // 2} x "
        f"{N_ATOMS // 2}, offset path", r_max=R_MAX, n_bins=N_BINS,
        r_min=OFFSET_RANGE[0], plain_runs=1)
    out["fast ortho"] = self_kernel_vs_plain(
        cube_frames, cube_box, f"self kernel, {N_ATOMS} atoms",
        r_max=R_MAX, n_bins=N_BINS, precision="fast", plain_runs=1)
    out["fast ortho cross"] = cross_kernel_vs_plain(
        *halves, cube_box, f"cross kernel, {N_ATOMS // 2} x {N_ATOMS // 2}",
        r_max=R_MAX, n_bins=N_BINS, precision="fast", plain_runs=1)
    del cube_frames, halves

    small, small_box = uniform_frames(rng, device, 1, SMALL_ATOMS,
                                      cube(SMALL_ATOMS))
    for ex in WATER_TILES:
        out[f"ordered tiles {ex}"] = self_kernel_vs_plain(
            small, small_box, f"ordered self kernel, {SMALL_ATOMS} atoms",
            r_max=ORDERED_R, n_bins=GEN_BINS, exclusion=ex, plain_runs=1)
    out["ordered offset"] = self_kernel_vs_plain(
        small, small_box, f"ordered self kernel, {SMALL_ATOMS} atoms",
        r_max=ORDERED_R, n_bins=GEN_BINS, r_min=OFFSET_RANGE[0],
        plain_runs=1)

    dodeca, dodeca_box = uniform_frames(rng, device, 1, N_ATOMS,
                                        dodecahedron(DODECA_A))
    for ex in WATER_TILES:
        out[f"block tiles {ex}"] = self_kernel_vs_plain(
            dodeca, dodeca_box, f"triclinic self kernel, {N_ATOMS} atoms",
            r_max=R_MAX, n_bins=N_BINS, exclusion=ex, plain_runs=1)
    out["block offset"] = self_kernel_vs_plain(
        dodeca, dodeca_box, f"triclinic self kernel, {N_ATOMS} atoms",
        r_max=R_MAX, n_bins=N_BINS, r_min=OFFSET_RANGE[0], plain_runs=1)
    out["fast block"] = self_kernel_vs_plain(
        dodeca, dodeca_box, f"triclinic self kernel, {N_ATOMS} atoms",
        r_max=R_MAX, n_bins=N_BINS, precision="fast", plain_runs=1)
    out["fast block cross"] = cross_kernel_vs_plain(
        dodeca[:, 0::2].contiguous(), dodeca[:, 1::2].contiguous(),
        dodeca_box, f"triclinic cross kernel, {N_ATOMS // 2} x "
        f"{N_ATOMS // 2}", r_max=R_MAX, n_bins=N_BINS, precision="fast",
        plain_runs=1)
    del dodeca

    tri_pp, tri_pp_box = uniform_frames(rng, device, 1, SMALL_ATOMS,
                                        dodecahedron(TRI_PP_A))
    for ex in WATER_TILES:
        out[f"tri_pp tiles {ex}"] = self_kernel_vs_plain(
            tri_pp, tri_pp_box, f"tri_pp self kernel, {SMALL_ATOMS} atoms",
            r_max=TRI_PP_R, n_bins=GEN_BINS, exclusion=ex, plain_runs=1)
    out["tri_pp offset"] = self_kernel_vs_plain(
        tri_pp, tri_pp_box, f"tri_pp self kernel, {SMALL_ATOMS} atoms",
        r_max=TRI_PP_R, n_bins=GEN_BINS, r_min=OFFSET_RANGE[0],
        plain_runs=1)
    out["fast tri_pp"] = self_kernel_vs_plain(
        tri_pp, tri_pp_box, f"tri_pp self kernel, {SMALL_ATOMS} atoms",
        r_max=TRI_PP_R, n_bins=GEN_BINS, precision="fast", plain_runs=1)
    out["fast tri_pp cross"] = cross_kernel_vs_plain(
        tri_pp[:, 0::2].contiguous(), tri_pp[:, 1::2].contiguous(),
        tri_pp_box, f"tri_pp cross kernel, {SMALL_ATOMS // 2} x "
        f"{SMALL_ATOMS // 2}", r_max=TRI_PP_R, n_bins=GEN_BINS,
        precision="fast", plain_runs=1)
    del tri_pp

    film, film_box = film_frames(rng, device, 1)
    axes = (0, 1)
    out["2d self"] = self_kernel_vs_plain(
        film, film_box, f"2-D self kernel, {N_ATOMS} atoms, film path",
        r_max=GEN_R, n_bins=GEN_BINS, axes=axes, plain_runs=1)
    out["2d cross"] = cross_kernel_vs_plain(
        film[:, 0::2].contiguous(), film[:, 1::2].contiguous(), film_box,
        f"2-D cross kernel, {N_ATOMS // 2} x {N_ATOMS // 2}, film path",
        r_max=GEN_R, n_bins=GEN_BINS, axes=axes, plain_runs=1)
    out["fast 2d"] = self_kernel_vs_plain(
        film, film_box, f"2-D self kernel, {N_ATOMS} atoms",
        r_max=GEN_R, n_bins=GEN_BINS, axes=axes, precision="fast",
        plain_runs=1)
    out["fast 2d cross"] = cross_kernel_vs_plain(
        film[:, 0::2].contiguous(), film[:, 1::2].contiguous(), film_box,
        f"2-D cross kernel, {N_ATOMS // 2} x {N_ATOMS // 2}", r_max=GEN_R,
        n_bins=GEN_BINS, axes=axes, precision="fast", plain_runs=1)
    # The film's reach-1 plans beside the JAX package's 2-D grids (its
    # 512-lane capacity cap sends it to the generalized space) and the
    # planner's own best generalized grid, which it does not consider
    # while a reach-1 plan fits: the kernel timed on each, counts equal.
    for name, groups, jax_grid in (
            ("2d self", (film, None), FILM_JAX_GRIDS[0]),
            ("2d cross", (film[:, 0::2].contiguous(),
                          film[:, 1::2].contiguous()), FILM_JAX_GRIDS[1])):
        n2 = groups[1].shape[1] if groups[1] is not None else None
        floors = np.floor(np.asarray(FILM[:2]) / GEN_R).astype(int)
        extra = {
            "JAX package's": cch.grid_plan(groups[0].shape[1], FILM[:2],
                                           GEN_R, jax_grid, n_atoms2=n2),
            "generalized": cch._general_plan(
                groups[0].shape[1], np.asarray(FILM[:2]), GEN_R, floors, n2,
                4.0, cch._MAX_CAPACITY),
        }
        planner = sweep_calls(*groups, film_box, out[name]["plan"], GEN_R,
                              GEN_BINS, axes=axes)[0]()
        line = (f"{name}, kernel ms a frame by plan: planner "
                f"{out[name]['plan']['n_cells_dim']} reach "
                f"{out[name]['plan']['reach']} {out[name]['ms']:.3f}")
        for label, plan in extra.items():
            kernel, _, work, text = sweep_calls(*groups, film_box, plan,
                                                GEN_R, GEN_BINS, axes=axes)
            timing, k_out = kernel_timed(kernel, 1, f"{name} kernel, "
                                         f"{label} grid, {text}", work)
            check_capacity(k_out, plan)
            check(torch.equal(k_out[0], planner[0]),
                  f"{name}: the {label} grid's counts differ from the "
                  "planner plan's")
            line += (f"; {label} {plan['n_cells_dim']} reach "
                     f"{plan['reach']} {timing['ms']:.3f}")
            out[name][f"{label} ms"] = timing["ms"]
        print(line + "; counts equal")
    return out


def phase_mode_fixtures(device, rng):
    """The new conventions on straddle fixtures, kernel == plain ==
    float64 oracle: bins whose first edge (r_min) or closed last edge
    (r_max) is the fixture's 1.25, a 2-D grid whose in-plane edge it is
    (the dropped coordinates redrawn), the tiles, and the same in the
    small dodecahedron (27-image oracle); then frames whose box shrank
    below an offset, a 2-D and an asymmetric-tile grid: NaN, kernel and
    plain alike."""

    import torch

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.testing import (
        edge_straddle_positions,
        edge_straddle_triclinic_positions,
        f64_histogram,
        f64_triclinic_distances,
    )

    cases = (
        # (geometry, grid, (r_min, r_max, n_bins), exclusion, cross)
        ("cube", (3, 3, 3), (1.25, 6.0, 19), None, False),
        ("cube", (5, 5, 5), (0.5, 1.25, 12), (2, 3), False),
        ("cube", (1, 2, 6), (1.25, 6.0, 19), (3, 3), False),
        ("cube", (2, 5, 6), (0.5, 1.25, 12), (2, 3), True),
        ("slab", (4, 4), (0.0, 4.0, 16), (2, 3), False),
        ("slab", (2, 9), (1.25, 6.0, 19), None, False),
        ("slab", (5, 5), (0.5, 1.25, 12), None, True),
        ("tri", (3, 3, 3), (1.25, 4.0, 11), (2, 3), False),
        ("tri", (1, 2, 4), (0.5, 1.25, 12), (3, 3), False),
        ("tri", (3, 3, 3), (1.25, 4.0, 11), None, True),
        ("tri", (1, 2, 4), (0.5, 1.25, 12), (2, 3), True),
    )
    h = triclinic_matrices(dodecahedron(18.0)).astype(np.float32)
    for geometry, grid, (r_min, r_max, n_bins), ex, cross in cases:
        if geometry == "tri":
            pos, box = edge_straddle_triclinic_positions(rng, h), h
        else:
            pos = edge_straddle_positions(rng, 16.0)
            box = np.float32([16.0, 16.0, 4.0 if geometry == "slab"
                              else 16.0])
            pos[:, 2] = (rng.random(len(pos)) * box[2]).astype(np.float32)
        axes = (0, 1) if len(grid) == 2 else None
        groups = (pos[:300], pos[300:]) if cross else (pos,)
        extents = plan_extents(box)[:len(grid)]
        plan = cch.grid_plan(len(groups[0]), extents, r_max, grid,
                             n_atoms2=len(groups[-1]) if cross else None)
        frames = [torch.from_numpy(g).to(device)[None] for g in groups]
        kernel, plain, _, text = sweep_calls(
            frames[0], frames[1] if cross else None, box, plan, r_max,
            n_bins, ex, r_min=r_min, axes=axes)
        k_out, p_out = kernel(), plain()
        torch.cuda.synchronize()
        edges = np.linspace(r_min, r_max, n_bins + 1)
        mask = ex if cross else (1, 1) if ex is None else ex
        if geometry == "tri":
            dist = f64_triclinic_distances(groups[0][:, None],
                                           groups[-1][None], box)
            if mask is not None:
                i = np.arange(len(groups[0]))[:, None]
                j = np.arange(len(groups[-1]))[None, :]
                dist[i // mask[0] == j // mask[1]] = np.inf
            oracle = np.histogram(dist, bins=edges)[0]
        else:
            oracle = f64_histogram(groups[0], groups[-1], box, edges,
                                   axes=axes or (0, 1, 2), exclusion=mask)
        for k, p in zip(k_out, p_out):
            check(torch.equal(k, p), f"straddle {text}: kernel != plain")
        check(np.array_equal(k_out[0][0].cpu().numpy().astype(np.int64),
                             oracle), f"straddle {text}: != float64 oracle")
        print(f"straddle fixture, {geometry} {text}, bins [{r_min}, "
              f"{r_max}]: kernel == plain == float64 oracle "
              f"({int(oracle.sum())} pairs)")

    # Shrunk frames: the second frame's box at 0.7 of the first's.
    n = 3000
    for grid, r_p, ex, r_min, axes in (((3, 3, 10), 6.0, (2, 3), 0.0, None),
                                       ((3, 3, 10), 6.0, None, 2.0, None),
                                       ((3, 10), 6.0, (3, 3), 1.0, (0, 2))):
        good = np.float32((40.0,) * 3)
        boxes = np.stack([good, good * np.float32(0.7)])
        pos = (rng.random((2, n, 3)) * boxes[:, None]).astype(np.float32)
        plan = cch.grid_plan(n, good[list(axes or (0, 1, 2))], r_p, grid)
        frames = torch.from_numpy(pos).to(device)
        args = dict(box=torch.from_numpy(boxes), r_max=r_p, r_min=r_min,
                    n_cells_dim=grid, reach=plan["reach"], n_bins=64,
                    capacity=plan["capacity"], exclusion=ex, axes=axes)
        k_out = cch.cell_pair_histogram(frames, **args)
        p_out = cch.cell_pair_histogram_reference(frames, **args)
        torch.cuda.synchronize()
        text = f"grid {grid} exclusion {ex} r_min {r_min} axes {axes}"
        check(bool(torch.isnan(k_out[0][1]).all()
                   and torch.isnan(p_out[0][1]).all()),
              f"shrunk frame, {text}: not NaN-poisoned")
        check(torch.equal(k_out[0][0], p_out[0][0]) and k_out[0][0].sum() > 0,
              f"shrunk frame, {text}: frame 0 differs")
        print(f"shrunk frame, {text}: kernel and plain version NaN-poison "
              "it, equal on the other frame")


def run_option_path(analysis, n_frames, kernel, option, per, what):
    """run_together([analysis]) with the launch counts set to 0 just
    before and read just after: `kernel` must launch once a chunk (or,
    with ``per="frame"``, once a frame), each launch with `option`
    (:data:`cuda_cell_histogram._OPTIONS`).  Returns (launches,
    frames/s)."""

    n_chunks = -(-n_frames // CHUNK)
    want = n_frames if per == "frame" else n_chunks
    reset_launches()
    fps = run_timed([analysis], n_frames)
    check(kernel.launches == want == kernel.option_launches[option],
          f"{what}: {kernel.launches} launches, "
          f"{kernel.option_launches[option]} with {option}, for {want} "
          f"{per}s")
    print(f"{what}: {n_frames} frames in chunks of {CHUNK}, "
          f"{kernel.launches} launches, all with {option}; {fps:.3f} "
          "frames/s (information, not a claim)")
    return kernel.launches, fps


def tail_check(g, what, n_bins):
    check(np.all(np.isfinite(g)) and g.shape[-1] == n_bins, f"{what}: shape")
    tail = g[..., -20:].mean(axis=-1)
    check(np.all(np.abs(tail - 1.0) < 0.02), f"{what}: g tail off 1: {tail}")
    return float(np.mean(tail))


def phase_water_paths(device, rng):
    """The water-like liquid: the 100k-atom cube's self RDF with the
    (3, 3) tiles of a 3-site water model and an asymmetric (2, 3), 200
    bins on [0, 6], 8 + 32 frames each; g(r) tails at 1 under the
    ``n2 - e1`` normalization.  Returns (launches, frames/s, plan) by
    tile."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
    )
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    _, u = slice_universe(rng, N_FRAMES)
    out = {}
    for ex in WATER_TILES:
        rdf = RadialDistributionFunction(u.atoms, n_bins=N_BINS,
                                         range=(0.0, R_MAX), exclusion=ex,
                                         verbose=False, device=device)
        rdf._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
        option = "tiles" if ex[0] == ex[1] else "asym"
        launches, fps = run_option_path(rdf, N_FRAMES,
                                        cch.cell_pair_histogram, option,
                                        "chunk", f"water self RDF {ex}")
        mean = tail_check(rdf.results.rdf, f"water self RDF {ex}", N_BINS)
        plan = rdf._searched_cell_plan()
        print(f"water self RDF {ex}: plan {plan['n_cells_dim']} capacity "
              f"{plan['capacity']}, g(r) tail mean {mean:.5f}")
        out[ex] = (launches, fps, plan)
    return out


def phase_offset_paths(device, rng):
    """Bins from r_min > 0 in the 100k-atom cube: the self RDF and the
    cross RDF of atoms[0::2] and atoms[1::2] on [2, 6] (200 bins, 8 + 32
    frames), and VanHoveFunction(n_lags=64, lags="log", range=(1, 6))
    (8 + 32 frames): g(r) tails at 1, the lag-0 self counts all out of
    range, the lag-0 distinct counts equal to the self kernel's on
    [1, 6], the longest lag's self counts equal to float64 numpy on the
    offset edges.  Returns (launches, frames/s, plan) by path."""

    import torch

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        VanHoveFunction,
    )
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    traj, u = slice_universe(rng, N_FRAMES)
    out = {}
    for path, groups, kernel in (
        ("self", (u.atoms,), cch.cell_pair_histogram),
        ("cross", (u.atoms[0::2], u.atoms[1::2]), cch.cross_pair_histogram),
    ):
        rdf = RadialDistributionFunction(*groups, n_bins=N_BINS,
                                         range=OFFSET_RANGE, verbose=False,
                                         device=device)
        rdf._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
        launches, fps = run_option_path(rdf, N_FRAMES, kernel, "offset",
                                        "chunk", f"offset {path} RDF")
        mean = tail_check(rdf.results.rdf, f"offset {path} RDF", N_BINS)
        plan = rdf._searched_cell_plan()
        print(f"offset {path} RDF on {OFFSET_RANGE}: plan "
              f"{plan['n_cells_dim']}, g(r) tail mean {mean:.5f}")
        out[path] = (launches, fps, plan)

    vh = VanHoveFunction(u.atoms, n_bins=N_BINS, range=VH_OFFSET_RANGE,
                         n_lags=VH_LAGS, lags="log", verbose=False,
                         device=device)
    vh._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    launches, fps = run_option_path(vh, N_FRAMES, cch.cross_pair_histogram,
                                    "offset", "frame", "offset Van Hove")
    lags = np.rint(vh.results.times).astype(int)
    counts_self = vh.results.counts_self
    check(counts_self[0].sum() == 0,
          "offset Van Hove: lag-0 displacements inside [1, 6]")
    plan = cch.cell_plan_search(N_ATOMS, [BOX] * 3, VH_OFFSET_RANGE[1])
    box = torch.full((3,), BOX, dtype=torch.float32, device=device)
    self_counts = torch.zeros(N_BINS, dtype=torch.float64, device=device)
    for lo in range(0, N_FRAMES, CHUNK):
        pos = torch.from_numpy(traj[lo:lo + CHUNK]).to(device)
        pos = pos - box * torch.floor(pos / box)  # the path's wrap
        counts, _ = cch.cell_pair_histogram(
            pos, box=box, r_max=VH_OFFSET_RANGE[1],
            r_min=VH_OFFSET_RANGE[0], n_cells_dim=plan["n_cells_dim"],
            capacity=plan["capacity"], n_bins=N_BINS)
        self_counts += counts.sum(dim=0)
    check(np.array_equal(vh.results.counts_distinct[0],
                         self_counts.cpu().numpy().astype(np.int64)),
          "offset Van Hove: lag-0 distinct counts != self kernel counts")
    lag = int(lags[-1])
    edges = np.linspace(*VH_OFFSET_RANGE, N_BINS + 1)
    ref = np.zeros(N_BINS, dtype=np.int64)
    for t in range(N_FRAMES - lag):
        d = traj[t + lag].astype(np.float64) - traj[t].astype(np.float64)
        d -= BOX * np.round(d / BOX)
        ref += np.histogram(np.sqrt((d**2).sum(-1)), bins=edges)[0]
    check(np.array_equal(counts_self[-1], ref),
          f"offset Van Hove: lag-{lag} self counts != float64 numpy")
    gd = vh.results.gd
    tail = gd[:, -20:].mean(axis=1)
    check(np.all(np.isfinite(gd)) and np.all(np.abs(tail - 1) < 0.02),
          f"offset Van Hove: distinct g(r, t) tail off 1: {tail}")
    print(f"offset Van Hove on {VH_OFFSET_RANGE}: {len(lags)} lags; lag-0 "
          "self counts all below r_min; lag-0 distinct == self kernel; "
          f"lag-{lag} self counts == float64 numpy")
    out["vanhove"] = (launches, fps, vh._searched_cell_plan())
    return out


def phase_film_paths(device, rng):
    """The 2-D film: a 100k-atom slab of 100 x 100 x 12.5 A, the in-plane
    self RDF and cross RDF of its halves with drop_axis="z" at the
    classes' defaults (201 bins on [0, 15]), 8 + 16 frames: g(r) tails
    at 1 under the area and ring normalization.  The plan each path runs
    is printed beside the JAX package's 2-D grid.  Returns (launches,
    frames/s, plan) by path."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
    )
    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    traj = (rng.random((FILM_FRAMES, N_ATOMS, 3), dtype=np.float32)
            * np.float32(FILM))
    u = Universe.from_arrays(traj, np.array([*FILM, 90.0, 90.0, 90.0]),
                             dt=1.0)
    out = {}
    for path, groups, kernel in (
        ("self", (u.atoms,), cch.cell_pair_histogram),
        ("cross", (u.atoms[0::2], u.atoms[1::2]), cch.cross_pair_histogram),
    ):
        # The classes' defaults: 201 bins on [0, 15].
        rdf = RadialDistributionFunction(*groups, n_bins=GEN_BINS,
                                         range=(0.0, GEN_R), drop_axis="z",
                                         verbose=False, device=device)
        rdf._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
        launches, fps = run_option_path(rdf, FILM_FRAMES, kernel, "2d",
                                        "chunk", f"film {path} RDF")
        mean = tail_check(rdf.results.rdf, f"film {path} RDF", GEN_BINS)
        plan = rdf._searched_cell_plan()
        blocks = plan["n_cells"] * (5 if path == "self" else 9)
        print(f"film {path} RDF: plan {plan['n_cells_dim']} reach "
              f"{plan['reach']} capacity {plan['capacity']} ({blocks} "
              "blocks a frame; the JAX package plans its 512-lane-capped "
              "generalized 2-D grid); g(r) tail mean "
              f"{mean:.5f}")
        out[path] = (launches, fps, plan)
    return out


#: the shapes of the mode checks that no main path runs, each driven by
#: short self-RDF paths (8 + 8 frames): (name, atoms, box, r_max, bins).
MODE_SHAPES = (
    ("ordered", SMALL_ATOMS, "cube", ORDERED_R, GEN_BINS),
    ("block", N_ATOMS, "dodeca", R_MAX, N_BINS),
    ("tri_pp", SMALL_ATOMS, "tri_pp", TRI_PP_R, GEN_BINS),
)
SHAPE_FRAMES = 8 + 8


def shape_universe(rng, name, n_atoms, n_frames):
    box = {"cube": cube(n_atoms), "dodeca": dodecahedron(DODECA_A),
           "tri_pp": dodecahedron(TRI_PP_A)}[name]
    return small_box_universe(rng, n_atoms, box, n_frames)


def phase_mode_shape_paths(device, rng):
    """The self RDF with the (3, 3) and (2, 3) tiles and on [2, r_max] in
    the ordered 5,000-atom cube, the per-block 100k dodecahedron and the
    tri_pp 5,000-atom dodecahedron, 8 + 8 frames each: every chunk
    launches the kernel with the option, and the g(r) tail stays at 1.
    Returns (launches, frames/s, plan) by (shape, option)."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
    )
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    out = {}
    for name, n_atoms, box_name, r_max, n_bins in MODE_SHAPES:
        _, u, box = shape_universe(rng, box_name, n_atoms, SHAPE_FRAMES)
        kernel = (cch.triclinic_cell_pair_histogram if np.ndim(box) == 2
                  else cch.cell_pair_histogram)
        for option, kwargs in (("tiles", dict(exclusion=(3, 3))),
                               ("asym", dict(exclusion=(2, 3))),
                               ("offset", dict(range=(2.0, r_max)))):
            kwargs.setdefault("range", (0.0, r_max))
            rdf = RadialDistributionFunction(u.atoms, n_bins=n_bins,
                                             verbose=False, device=device,
                                             **kwargs)
            rdf._chunk_bytes = CHUNK * n_atoms * 3 * 4
            what = f"{name} self RDF {kwargs}"
            launches, fps = run_option_path(rdf, SHAPE_FRAMES, kernel,
                                            option, "chunk", what)
            tail_check(rdf.results.rdf, what, n_bins)
            out[name, option] = (launches, fps, rdf._searched_cell_plan())
    return out


def phase_fast_op_path(device, rng):
    """Fast binning, which no analysis reaches (the JAX package's op
    default): the public kernel wrappers called with precision="fast"
    on 8 + 8 frames in chunks -- the self sweep, and the cross sweep of
    the even and odd atoms, in the 100k cube, the 2-D film and the 100k
    dodecahedron, and the tri_pp 5,000-atom dodecahedron -- with the
    launch counts set to 0 just before and read just after; each fast
    count within 0.1 % of the exact one's total.  Returns (launches,
    plan) by (geometry, "self" or "cross")."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    out = {}
    shapes = (("ortho", N_ATOMS, cube(N_ATOMS), R_MAX, N_BINS, None),
              ("2d", N_ATOMS, np.array([*FILM, 90.0, 90.0, 90.0]), GEN_R,
               GEN_BINS, (0, 1)),
              ("block", N_ATOMS, dodecahedron(DODECA_A), R_MAX, N_BINS,
               None),
              ("tri_pp", SMALL_ATOMS, dodecahedron(TRI_PP_A), TRI_PP_R,
               GEN_BINS, None))
    n_chunks = -(-SHAPE_FRAMES // CHUNK)
    for name, n_atoms, dims6, r_max, n_bins, axes in shapes:
        frames, box = uniform_frames(rng, device, SHAPE_FRAMES, n_atoms,
                                     dims6)
        triclinic = np.ndim(box) == 2
        for sweep in ("self", "cross"):
            args = dict(box=box, r_max=r_max, n_bins=n_bins)
            if axes is not None:
                args["axes"] = axes
            if sweep == "self":
                groups = (frames,)
                plan = planned(n_atoms, box, r_max, axes=axes)
                kernel = (cch.triclinic_cell_pair_histogram if triclinic
                          else cch.cell_pair_histogram)
                args["capacity"] = plan["capacity"]
            else:
                groups = (frames[:, 0::2].contiguous(),
                          frames[:, 1::2].contiguous())
                plan = planned(groups[0].shape[1], box, r_max,
                               n_atoms2=groups[1].shape[1], axes=axes)
                kernel = (cch.triclinic_cross_pair_histogram if triclinic
                          else cch.cross_pair_histogram)
                args.update(capacity1=plan["capacity"],
                            capacity2=plan["capacity2"])
            args.update(n_cells_dim=plan["n_cells_dim"], reach=plan["reach"])
            totals = {}
            for precision in ("exact", "fast"):
                reset_launches()
                total = 0.0
                for lo in range(0, SHAPE_FRAMES, CHUNK):
                    counts = kernel(*(g[lo:lo + CHUNK] for g in groups),
                                    precision=precision, **args)[0]
                    total += float(counts.sum())
                torch.cuda.synchronize()
                totals[precision] = total
            what = f"fast op path, {name} {sweep}"
            check(kernel.launches == n_chunks
                  == kernel.option_launches["fast"],
                  f"{what}: {kernel.launches} launches for {n_chunks} "
                  "chunks")
            check(abs(totals["fast"] / totals["exact"] - 1) < 1e-3,
                  f"{what}: {totals}")
            print(f"{what}: {n_chunks} launches with fast binning; pairs "
                  f"in range fast / exact "
                  f"{totals['fast'] / totals['exact']:.7f}")
            out[name, sweep] = (kernel.launches, plan)
        del frames
    return out


# Slice 6: the direct S(q) method (bench.py's sq class phase with
# MDTPU_BENCH_SQ=direct: 100k atoms, the 24^3 grid, exact, 8 + 32 frames)
# through the trig-sums kernel, and the brute-force pair histogram.  The
# short paths (the split of a grid with 4 x 8 surface points, the partial
# rows, fast phases) run 8 + 8 frames.
SQ_SHORT_FRAMES = 8 + 8
SURFACES, SURFACE_POINTS = 4, 8
ORACLE_QS = 512
#: float instructions of sincosf's path for arguments under 105615 in the
#: SASS of sm_90a (scripts/sincos_sass.py), and its operations with each
#: of its 11 FFMAs counted twice, as the float32 peak counts an FMA.
SINCOSF_OPS, SINCOSF_FLOPS = 20, 31


def trig_ops(precision, lo, weights):
    """float32 operations that one (wavevector, atom) term of the trig sums
    needs (counted in csrc/trig_sums.cu, an FMA as two; the turns a
    multiply and a rint, the exact sum 4 a term): exact 66, with 6 more
    for the low words of float64 wavevectors; fast 7; 2 more with
    weights; plus sincosf's 31.  Also the first design's count (an FMA as
    one, sincosf 20): exact 94 + 6, fast 9, 2 more with weights."""

    new = 66 + 6 * int(lo) if precision == "exact" else 7
    first = 94 + 6 * int(lo) if precision == "exact" else 9
    return (new + 2 * int(weights) + SINCOSF_FLOPS,
            first + 2 * int(weights) + SINCOSF_OPS)


def trig_bound(n_frames, n_atoms, n_q, precision, lo, weights):
    """``bound_ms`` and ``bound_by`` a frame of one trig-sums launch over
    `n_frames` frames: the terms' operations over the float32 peak against
    the positions, wavevectors, weights and sums read or written once over
    the memory rate; ``first_design_bound_ms`` with the first design's
    count."""

    terms = n_atoms * n_q
    new, first = trig_ops(precision, lo, weights)
    ops_ms = terms * new / PEAK_F32 * 1e3
    n_bytes = (12 * n_frames * n_atoms + 12 * n_q * (1 + int(lo))
               + 4 * n_atoms * int(weights) + 8 * n_frames * n_q)
    bytes_ms = n_bytes / PEAK_BYTES * 1e3 / n_frames
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "first_design_bound_ms": max(terms * first / PEAK_F32 * 1e3,
                                     bytes_ms),
        "library_ms": None,
        "terms_per_frame": terms,
    }


def trig_vs_plain(q, pos, w, precision, what, pick, workspace=None):
    """The trig-sums kernel against its plain version on frames `pos`:
    each result, kernel and plain, held against a float64 oracle on the
    card on the wavevectors `pick` within the tolerances of
    tests/test_pallas.py (1e-4 of the mean amplitude fast, 1e-6 exact), the
    kernel against the plain version on every wavevector within the same
    (exact: bit for bit), two launches the same bits; then both timed, in
    ms a frame beside :func:`trig_bound`.  The kernel's launches take
    `workspace` when one is given."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    kernel = lambda: ck.trig_sums(q, pos, w,  # noqa: E731
                                  precision=precision, workspace=workspace)
    plain = lambda: ck.trig_sums_reference(q, pos, w,  # noqa: E731
                                           precision=precision)
    k_out = kernel()
    again = kernel()
    p_out, first_plain_ms = timed_call(plain)
    check(all(torch.equal(a, b) for a, b in zip(k_out, again)),
          f"{what}: two launches differ")
    # float64 oracle on the card, on the subset.
    idx = pick[pick < len(q)]
    sub = q[idx].double()
    w64 = 1.0 if w is None else w.double()
    oracle = []
    for f in range(pos.shape[0]):
        phases = sub @ pos[f].double().T
        oracle.append(((torch.cos(phases) * w64).sum(-1),
                       (torch.sin(phases) * w64).sum(-1)))
        del phases
    oc = torch.stack([o[0] for o in oracle])
    osn = torch.stack([o[1] for o in oracle])
    amp = float(torch.hypot(oc, osn).mean())
    tol = (1e-6 if precision == "exact" else 1e-4) * amp
    errs = {}
    for name, out in (("kernel", k_out), ("plain", p_out)):
        errs[name] = max(
            float((out[0][:, idx].double() - oc).abs().max()),
            float((out[1][:, idx].double() - osn).abs().max()))
        check(errs[name] <= tol,
              f"{what}: {name} off the float64 oracle by "
              f"{errs[name]:.3e} > {tol:.3e}")
    max_abs_err = max(float((k_out[i] - p_out[i]).abs().max())
                      for i in range(2))
    check(max_abs_err <= tol,
          f"{what}: kernel differs from plain by {max_abs_err:.3e}")
    check(precision != "exact" or max_abs_err == 0.0,
          f"{what}: the exact sums differ from plain by {max_abs_err:.3e}")
    n_frames = pos.shape[0]
    kernel_ms = [time_ms(kernel, 3) / n_frames for _ in range(2)]
    plain_ms = [first_plain_ms / n_frames, time_ms(plain, 1) / n_frames]
    out = {
        "mode": precision, "max_abs_err": max_abs_err,
        "oracle_err": errs, "tolerance": tol,
        "ms": float(np.mean(kernel_ms)),
        "plain_ms": float(np.mean(plain_ms)),
        **trig_bound(pos.shape[0], pos.shape[1], len(q), precision,
                     lo=precision == "exact" and q.dtype == torch.float64,
                     weights=w is not None),
    }
    print(f"{what}: max |kernel - float64| {errs['kernel']:.3e}, "
          f"|plain - float64| {errs['plain']:.3e} (tolerance "
          f"{tol:.3e}, mean amplitude {amp:.3f}); |kernel - plain| "
          f"{max_abs_err:.3e}; two launches equal; per frame kernel "
          f"{out['ms']:.3f} ms (runs {[round(x, 3) for x in kernel_ms]}),"
          f" plain torch {out['plain_ms']:.3f} ms (runs "
          f"{[round(x, 3) for x in plain_ms]}); bound "
          f"{out['bound_ms']:.3f} ms by {out['bound_by']} "
          f"({100 * out['bound_ms'] / out['ms']:.1f} % of the kernel's "
          f"time; the first design's count "
          f"{out['first_design_bound_ms']:.3f} ms)")
    return out


def phase_trig_kernels(device, rng):
    """The trig-sums kernel against its plain version at the direct path's
    width: 2 frames of 100k atoms in one launch, the 24^3 grid as float64
    wavevectors (split hi + lo), fast and exact; then with 0/1 weights on
    99,999 atoms and 13,823 wavevectors (the tiles' tails).  Each result,
    kernel and plain, is held against a float64 oracle on the card on a
    512-wavevector subset within the tolerances of tests/test_pallas.py
    (1e-4 of the mean amplitude fast, 1e-6 exact), and the kernel against
    the plain version on every wavevector within the same; a second launch
    gives the same bits."""

    import torch

    from mdhelper_tpu_torch.analysis.structure import _wavevector_grid

    frames, _ = uniform_frames(rng, device, 2, N_ATOMS, cube(N_ATOMS))
    qs = torch.from_numpy(_wavevector_grid([BOX] * 3, N_QPTS)).to(device)
    pick = torch.from_numpy(np.sort(np.random.default_rng(SEED).choice(
        len(qs), ORACLE_QS, replace=False))).to(device)
    timing = {}
    cases = [(p, frames, qs, None) for p in ("exact", "fast")]
    weights = torch.from_numpy(
        (rng.random(N_ATOMS - 1) < 0.7).astype(np.float32)).to(device)
    cases += [(p, frames[:, :-1].contiguous(), qs[:-1], weights)
              for p in ("exact", "fast")]
    for precision, pos, q, w in cases:
        what = (f"trig sums {precision}, {pos.shape[0]} x {pos.shape[1]} "
                f"atoms x {len(q)} float64 wavevectors"
                + (", 0/1 weights" if w is not None else ""))
        timing[precision, w is not None] = trig_vs_plain(
            q, pos, w, precision, what, pick)

    # The torch fast formulation (several calls: matmul, cos, sin, sums,
    # by wavevector tiles as the plain version takes them).
    q32 = qs.to(torch.float32)

    def torch_fast():
        for p in frames:
            for lo in range(0, len(q32), 2048):
                phases = q32[lo:lo + 2048] @ p.T
                torch.cos(phases).sum(-1)
                torch.sin(phases).sum(-1)

    torch_ms = time_ms(torch_fast, 2) / frames.shape[0]
    print(f"torch fast formulation (several calls: matmul + cos + sin + "
          f"sum), {N_ATOMS} atoms x {len(qs)} wavevectors: {torch_ms:.3f} "
          f"ms a frame; the fast kernel {timing['fast', False]['ms']:.3f} "
          "ms a frame")
    timing["torch_fast_ms"] = torch_ms
    return timing


def sq_analysis(u, device, **kwargs):
    """A StructureFactor over `u` with the direct path's settings
    (overridden by `kwargs`) and CHUNK-frame chunks."""

    from mdhelper_tpu_torch.analysis.structure import StructureFactor

    options = dict(n_points=N_QPTS, sort=False, unique=False,
                   method="direct", precision="exact", verbose=False,
                   device=device)
    options.update(kwargs)
    groups = options.pop("groups", u.atoms)
    analysis = StructureFactor(groups, **options)
    analysis._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    return analysis


def run_sq_path(analysis, n_frames):
    """Run one S(q) path with the trig-sums launch count set to 0 just
    before it; returns (launches, frames/s)."""

    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    ck.trig_sums.launches = 0
    fps = run_timed([analysis], n_frames)
    return ck.trig_sums.launches, fps


def check_ssf(ssf, ref, what):
    """S(q) within the gate (rtol 1e-4, atol 1e-5) of `ref`."""

    check(np.all(np.isfinite(ssf)) and ssf.shape == ref.shape,
          f"{what}: S(q) shape or values")
    dev = np.abs(ssf - ref) - 1e-4 * np.abs(ref)
    check(np.allclose(ssf, ref, rtol=1e-4, atol=1e-5),
          f"{what}: off the reference by {dev.max():.3e} beyond rtol")
    return float(np.max(np.abs(ssf - ref) / np.maximum(np.abs(ref), 1e-12)))


def phase_direct_sq(device, rng):
    """The direct S(q) path at 100k atoms: StructureFactor(method="direct",
    precision="exact") over the 24^3 grid through run() on 8 + 32 frames
    (one trig-sums launch a chunk), held against method="factor" on the
    same trajectory; then, on 8 + 8 frames, method="auto" with 4 x 8
    surface points (split: lattice factorized, extras direct) against the
    direct method, the partial rows of the even and odd atoms against the
    total, and the fast phases."""

    traj, u = slice_universe(rng, N_FRAMES)
    sf = sq_analysis(u, device)
    launches, fps = run_sq_path(sf, N_FRAMES)
    n_chunks = -(-N_FRAMES // CHUNK)
    check(launches == n_chunks,
          f"{launches} trig-sums launches for {n_chunks} chunks")
    check(sf._factor is None, "the direct path took the factor route")
    factor = sq_analysis(u, device, method="factor")
    factor_launches, factor_fps = run_sq_path(factor, N_FRAMES)
    check(factor_launches == 0, "the factor method launched the trig sums")
    rel = check_ssf(sf.results.ssf, factor.results.ssf,
                    "direct S(q) against method='factor'")
    print(f"direct S(q): {N_ATOMS} atoms, {N_FRAMES} frames in chunks of "
          f"{CHUNK}, {len(sf.results.wavenumbers)} wavevectors, "
          f"{launches} trig-sums launches; max relative deviation from "
          f"the factor method {rel:.3e} (gate rtol 1e-4, atol 1e-5)")
    out = {"direct": (launches, fps), "factor_fps": factor_fps}

    _, u = slice_universe(rng, SQ_SHORT_FRAMES)
    auto = sq_analysis(u, device, method="auto", n_surfaces=SURFACES,
                       n_surface_points=SURFACE_POINTS)
    auto_launches, auto_fps = run_sq_path(auto, SQ_SHORT_FRAMES)
    split = auto._factor_split
    check(auto._factor is not None and split is not None
          and len(split["qs_rest"]) == SURFACES * SURFACE_POINTS,
          "method='auto' did not split the grid and the surface points")
    check(auto_launches == SQ_SHORT_FRAMES // CHUNK,
          f"{auto_launches} trig-sums launches on the split path")
    direct = sq_analysis(u, device, n_surfaces=SURFACES,
                         n_surface_points=SURFACE_POINTS)
    direct_launches, direct_fps = run_sq_path(direct, SQ_SHORT_FRAMES)
    rel_auto = check_ssf(auto.results.ssf, direct.results.ssf,
                         "split S(q) against the direct method")
    partial = sq_analysis(u, device, mode="partial",
                          groups=[u.atoms[0::2], u.atoms[1::2]],
                          n_surfaces=SURFACES,
                          n_surface_points=SURFACE_POINTS)
    partial_launches, partial_fps = run_sq_path(partial, SQ_SHORT_FRAMES)
    check(partial.results.ssf.shape[0] == 3
          and partial_launches == 2 * SQ_SHORT_FRAMES // CHUNK,
          f"partial rows {partial.results.ssf.shape}, {partial_launches} "
          "launches")
    rel_partial = check_ssf(partial.results.ssf.sum(axis=0, keepdims=True),
                            direct.results.ssf,
                            "partial rows recombined against the total")
    fast = sq_analysis(u, device, precision="fast", n_surfaces=SURFACES,
                       n_surface_points=SURFACE_POINTS)
    fast_launches, fast_fps = run_sq_path(fast, SQ_SHORT_FRAMES)
    check(fast_launches == SQ_SHORT_FRAMES // CHUNK
          and np.all(np.isfinite(fast.results.ssf)),
          f"{fast_launches} launches on the fast path")
    rel_fast = float(np.max(np.abs(fast.results.ssf - direct.results.ssf)
                            / direct.results.ssf))
    n_q = len(direct.results.wavenumbers)
    print(f"split S(q) (auto, {n_q - SURFACES * SURFACE_POINTS} lattice + "
          f"{SURFACES * SURFACE_POINTS} surface wavevectors): "
          f"{auto_launches} launches, max relative deviation from the "
          f"direct method {rel_auto:.3e}; partial rows of the even and odd "
          f"atoms: {partial_launches} launches, recombined max relative "
          f"deviation {rel_partial:.3e}; fast phases: {fast_launches} "
          f"launches, max relative deviation from exact {rel_fast:.3e} "
          "(information)")
    out.update({"auto": (auto_launches, auto_fps),
                "direct_short": (direct_launches, direct_fps),
                "partial": (partial_launches, partial_fps),
                "fast": (fast_launches, fast_fps)})
    return out


def phase_pair_histogram(device, rng):
    """The brute-force pair histogram through its op at 100k atoms in the
    50 A cube (r_max 6, 200 bins, 1 frame) with exclusion (1, 1), None,
    (4, 4) and the asymmetric (2, 3), on the straddle fixture, and on 20k
    of the atoms moved up to two boxes out of [0, L) on each axis (None
    and (1, 1); the wrapper does not wrap), launch count set to 0 just
    before and read just after; each result equal to the plain version as
    integers, (1, 1) also to the self cell kernel's fast counts, and None
    with exactly N more pairs in bin 0; then kernel and plain timed."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.ops import cuda_kernels as ck
    from mdhelper_tpu_torch.testing import edge_straddle_positions

    frames, box = uniform_frames(rng, device, 1, N_ATOMS, cube(N_ATOMS))
    pos = frames[0]
    straddle = torch.from_numpy(edge_straddle_positions(rng, 16.0)).to(device)
    inputs = [(pos, box, R_MAX, N_BINS, ex) for ex in
              ((1, 1), None, (4, 4), (2, 3))]
    inputs += [(straddle, (16.0,) * 3, 4.0, 16, ex) for ex in
               ((1, 1), None, (4, 4))]
    n_loose = min(20_000, N_ATOMS)
    shifts = torch.randint(-2, 3, (n_loose, 3), device=device,
                           generator=torch.Generator(device).manual_seed(SEED))
    loose = pos[:n_loose] + shifts.float() * torch.tensor(box, device=device)
    inputs += [(loose, box, R_MAX, N_BINS, ex) for ex in ((1, 1), None)]
    ck.pair_histogram.launches = 0
    counts = [ck.pair_histogram(p, b, r, n, exclusion=ex)
              for p, b, r, n, ex in inputs]
    torch.cuda.synchronize()
    launches = ck.pair_histogram.launches
    check(launches == len(inputs),
          f"{launches} pair-histogram launches for {len(inputs)} calls")
    for (p, b, r, n, ex), k in zip(inputs, counts):
        plain = ck.pair_histogram_reference(p, b, r, n, exclusion=ex)
        check(torch.equal(k, plain),
              f"pair histogram {p.shape[0]} atoms, exclusion {ex}: kernel "
              "!= plain")
    for lo in (0, 4):
        p, b, r, n, _ = inputs[lo]
        plan = cch.cell_plan_search(p.shape[0], [b[0]] * 3, r)
        cell, _ = cch.cell_pair_histogram(
            p[None], box=b, r_max=r, n_cells_dim=plan["n_cells_dim"],
            capacity=plan["capacity"], n_bins=n, precision="fast")
        check(torch.equal(counts[lo], cell[0].to(torch.int64)),
              f"pair histogram {p.shape[0]} atoms, (1, 1): != the fast self "
              "cell kernel")
        gained = counts[lo + 1] - counts[lo]
        check(int(gained[0]) == p.shape[0] and int(gained[1:].abs().sum())
              == 0, "exclusion None: bin 0 did not gain exactly N")
    print(f"pair histogram: {N_ATOMS} atoms, r_max {R_MAX:g}, {N_BINS} "
          f"bins, largest bin {int(counts[0].max())}; exclusion (1, 1) == "
          "plain == the fast self cell kernel as integers; None == plain, "
          f"bin 0 + {N_ATOMS}; (4, 4) == plain; (2, 3) == plain; the same "
          "on the straddle fixture; unwrapped positions == plain; "
          f"{launches} launches")

    kernel = lambda: ck.pair_histogram(pos, box, R_MAX, N_BINS,  # noqa: E731
                                       exclusion=(1, 1))
    plain = lambda: ck.pair_histogram_reference(  # noqa: E731
        pos, box, R_MAX, N_BINS, exclusion=(1, 1))
    plain_ms = [timed_call(plain)[1]]
    kernel_ms = [time_ms(kernel, 3) for _ in range(2)]
    plain_ms.append(timed_call(plain)[1])
    timing = {"mode": "brute", "max_abs_err": 0.0,
              "ms": float(np.mean(kernel_ms)),
              "plain_ms": float(np.mean(plain_ms)),
              **brute_bound(N_ATOMS, N_BINS, int(counts[0].sum()))}
    print(f"pair histogram kernel {timing['ms']:.3f} ms (runs "
          f"{[round(x, 3) for x in kernel_ms]}), plain torch "
          f"{timing['plain_ms']:.3f} ms (runs "
          f"{[round(x, 3) for x in plain_ms]}); "
          f"{timing['pairs_per_frame']} unordered pairs, "
          f"{timing['counted_per_frame']} ordered pairs in range, bound "
          f"{timing['bound_ms']:.3f} ms by {timing['bound_by']} "
          f"({100 * timing['bound_ms'] / timing['ms']:.1f} % of the "
          f"kernel's time; the first design's count "
          f"{timing['first_design_bound_ms']:.3f} ms)")
    return launches, timing


#: float32 operations of the brute pair histogram (counted in
#: csrc/pair_histogram.cu): every unordered pair its fast d^2 and the
#: cut's compare, the pairs in range the tail (sqrt, multiply,
#: conversion); the first design paid the fast d^2 and the ZeroFast tail
#: on every ordered pair.
BRUTE_PAIR_OPS, BRUTE_TAIL_OPS = OPS_PER_PAIR["ortho"]["fast"] + 1, 3


def brute_bound(n_atoms, n_bins, counted):
    """``bound_ms`` of the brute pair histogram over `n_atoms` atoms of
    which `counted` ordered pairs (i != j) lie in range: the least work,
    each unordered pair's d^2 and cut once and each unordered pair in
    range its tail, over the float32 peak, against the positions read and
    the counts written once; ``first_design_bound_ms`` with every ordered
    pair at the first design's 27."""

    pairs = n_atoms * (n_atoms - 1) // 2
    ops = pairs * BRUTE_PAIR_OPS + counted // 2 * BRUTE_TAIL_OPS
    first = n_atoms * (n_atoms - 1) * (OPS_PER_PAIR["ortho"]["fast"]
                                       + TAIL_OPS["fast"][0])
    ops_ms = ops / PEAK_F32 * 1e3
    bytes_ms = (12 * n_atoms + 8 * n_bins) / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "first_design_bound_ms": max(first / PEAK_F32 * 1e3, bytes_ms),
            "library_ms": None, "pairs_per_frame": pairs,
            "counted_per_frame": counted}


#: slice 7: frames of the cross RDF of overlapping groups, one chunk.
OVERLAP_FRAMES = CHUNK


def phase_overlap(device, rng):
    """The cross RDF of two overlapping groups at 100k atoms: the cross
    kernel against its plain version on one frame of the planner's plan
    (equal as integers; every shared atom in bin 0), then the path
    through run_together on 8 frames, launch count set to 0 just before
    and read just after; bin 0 holds at least the shared atoms of every
    frame and the g(r) tail is near 1."""

    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
    )
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    # [0, 2N/3) and [N/3, N): a third of the atoms in both groups.
    end1, start2 = 2 * N_ATOMS // 3, N_ATOMS // 3
    shared = end1 - start2
    _, u = slice_universe(rng, OVERLAP_FRAMES)
    frames, box = uniform_frames(rng, device, 1, N_ATOMS, cube(N_ATOMS))
    out = cross_kernel_vs_plain(frames[:, :end1].contiguous(),
                                frames[:, start2:].contiguous(), box,
                                "overlapping groups, cross kernel",
                                plain_runs=1)
    del out
    rdf = RadialDistributionFunction(
        u.atoms[:end1], u.atoms[start2:], n_bins=N_BINS, range=(0.0, R_MAX),
        verbose=False, device=device)
    rdf._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    cch.cross_pair_histogram.launches = 0
    run_together([rdf])
    launches = cch.cross_pair_histogram.launches
    check(launches >= 1, "overlapping groups: the cross kernel never ran")
    counts, g = rdf.results.counts, rdf.results.rdf
    check(counts[0] >= shared * OVERLAP_FRAMES,
          f"overlapping groups: bin 0 holds {counts[0]}, fewer than the "
          f"{shared} shared atoms a frame")
    check(np.all(np.isfinite(g)) and np.all(np.abs(g[-20:] - 1.0) < 0.02),
          f"overlapping groups: g(r) tail off 1: {g[-20:]}")
    print(f"overlapping groups [0, {end1}) x [{start2}, {N_ATOMS}): kernel "
          f"== plain; {OVERLAP_FRAMES} frames, {launches} launch(es), bin 0 "
          f"{int(counts[0])} (>= {shared} a frame), g(r) tail mean "
          f"{g[-20:].mean():.5f}")
    return launches


# Slice 10: the intermediate scattering function at the width of bench.py's
# isf phases (100k atoms, the 24^3 grid, a 64-frame ring, incoherent, exact,
# 8 + 96 frames in chunks of 8) on a random walk of ISF_STEP A a frame and
# axis (F_s(q, 63 frames) from about 0.9 to 0.14 over the grid), so that the
# ring correlates frames that are correlated.  The float64 oracle takes 16
# wavevectors and four lags; the kernel check 8 displacement frames a launch.
ISF_FRAMES, ISF_LAGS, ISF_STEP = 8 + 96, 64, 0.05
ISF_ORACLE_QS, ISF_ORACLE_LAGS = 16, (0, 1, 8, 63)
ISF_KERNEL_FRAMES = 8
#: frames at the end of a run that run under torch.profiler (the ring full).
ISF_PROFILED_FRAMES = CHUNK


def busy_us(events):
    """Length of the union of ``[start, end)`` intervals, in us."""

    total, reach = 0.0, -np.inf
    for start, end in sorted(events):
        if end <= reach:
            continue
        total += end - max(start, reach)
        reach = end
    return total


def isf_universe(rng, n_frames):
    """A random walk of N_ATOMS atoms from uniform positions in the cubic
    box, normal steps of ISF_STEP A a frame and axis, wrapped into the box
    as float32, as an in-memory universe (1 ps a frame)."""

    from mdhelper_tpu_torch.core.universe import Universe

    steps = rng.normal(0.0, ISF_STEP, (n_frames, N_ATOMS, 3))
    steps[0] = rng.random((N_ATOMS, 3)) * BOX
    traj = np.mod(np.cumsum(steps, axis=0), BOX).astype(np.float32)
    del steps
    return traj, Universe.from_arrays(
        traj, np.array([BOX] * 3 + [90.0] * 3), dt=1.0
    )


def isf_analysis(u, device, **kwargs):
    """An IntermediateScatteringFunction over `u` with the isf phase's
    settings (overridden by `kwargs`) and CHUNK-frame chunks."""

    from mdhelper_tpu_torch.analysis.structure import (
        IntermediateScatteringFunction,
    )

    options = dict(n_points=N_QPTS, sort=False, unique=False,
                   n_lags=ISF_LAGS, incoherent=True, precision="exact",
                   method="direct", verbose=False, device=device)
    options.update(kwargs)
    analysis = IntermediateScatteringFunction(u.atoms, **options)
    analysis._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    return analysis


def run_profiled(analyses, n_frames, profiled=0, runner=None, remake=None,
                 chunk=CHUNK):
    """``run_together(analyses)`` over `n_frames` frames, clocked from the
    end of the first chunk to the end of the conclusions.  With `profiled`
    frames the clock stops one chunk plus `profiled` frames before the
    end instead: that chunk warms the profiler up (``prepare_trace``,
    which turns CUPTI's activity records on), and the last `profiled`
    frames run under torch.profiler for the device's busy share of their
    wall time (to the end of the last chunk: the conclusions stay out).
    A profiler started cold at the window (``start()``) drops the device
    records of the window's first kernels in about half of the windows;
    warmed a chunk ahead it keeps them, but now and then it still drops a
    whole window's device records while it keeps the host's launch calls
    (``scripts/profiler_warmup.py``).  With `remake`, a no-argument call
    that makes the analyses anew, such a run goes again on new analyses
    (put into the list `analyses`), three runs at most; a trace with no
    launch call fails at once (the path ran off the card), as does a
    trace with no device record when no run is left.  The runs taken are
    in ``run_profiled.runs``.  `runner` takes run_together's place
    (``runner(analyses, on_chunk=...)``).  `chunk` is the frames of the
    analyses' chunks.  Returns ``(frames/s, busy share or None, device
    activities a profiled frame or None)``."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mdhelper_tpu_torch.analysis.multi import run_together

    warm_at, start_at = n_frames - profiled - chunk, n_frames - profiled
    check(not profiled or warm_at > chunk,
          f"{n_frames} frames leave no timed chunk before the profiler's "
          f"warm-up chunk and its {profiled} frames")
    for run in range(1, 4 if remake is not None and profiled else 2):
        if run > 1:
            analyses[:] = remake()
        run_profiled.runs = run
        prof = profile(activities=[ProfilerActivity.CUDA])
        marks, seen = {}, [0]

        def mark(name):
            torch.cuda.synchronize()
            marks[name] = time.perf_counter()

        def on_chunk(batch):
            seen[0] += batch.n_real
            if "first" not in marks:
                mark("first")
            elif profiled and seen[0] == warm_at:
                mark("warm")
                prof.prepare_trace()
            elif profiled and seen[0] == start_at:
                # The profiler's start-up stays out of the profiled wall.
                torch.cuda.synchronize()
                prof.start_trace()
                mark("start")
            elif profiled and seen[0] == n_frames:
                mark("end")
                prof.stop()

        (runner or run_together)(analyses, on_chunk=on_chunk)
        torch.cuda.synchronize()
        end = time.perf_counter()
        if not profiled:
            return (n_frames - chunk) / (end - marks["first"]), None, None
        events = prof.events()
        on_device = [(e.time_range.start, e.time_range.end)
                     for e in events if e.device_type == DeviceType.CUDA]
        if on_device:
            break
        launches = sum("Launch" in e.name for e in events)
        check(launches, "the profiler saw no kernel launch and no device "
              "activity: the path ran off the card")
        print(f"the profiler kept {launches} launch calls but no device "
              f"record of run {run} of the path's window")
    check(on_device, "the profiler saw no device activity")
    busy = busy_us(on_device) / ((marks["end"] - marks["start"]) * 1e6)
    fps = (warm_at - chunk) / (marks["warm"] - marks["first"])
    return fps, busy, len(on_device) / profiled


run_profiled.runs = 0


def run_isf_path(analysis, n_frames, profiled=0):
    """Run one ISF path through :func:`run_profiled` with the trig-sums
    launch counts set to 0 just before it and read just after, its
    launches split by precision as the wrapper counts them (exact: the
    coherent sums, fast: the displacement sums) and checked against the
    calls that the analysis made by precision.  Returns ``(launches,
    launches by precision, frames/s, busy share or None, device activities
    a profiled frame or None)``."""

    from mdhelper_tpu_torch.analysis import structure
    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    calls = {"exact": 0, "fast": 0}
    wrapped = structure.trig_sums

    def tally(qs, positions, *args, precision="fast", **kwargs):
        calls[precision] += 1
        return wrapped(qs, positions, *args, precision=precision, **kwargs)

    structure.trig_sums = tally
    ck.trig_sums.launches = 0
    by_precision = ck.trig_sums.launches_by_precision
    by_precision.update(exact=0, fast=0)
    try:
        fps, busy, activities = run_profiled([analysis], n_frames, profiled)
    finally:
        structure.trig_sums = wrapped
    launches, by_precision = ck.trig_sums.launches, dict(by_precision)
    check(by_precision == calls
          and launches == by_precision["exact"] + by_precision["fast"],
          f"trig-sums launches {launches} ({by_precision} by precision) "
          f"against the analysis's calls {calls}")
    return launches, by_precision, fps, busy, activities


def isf_oracle(traj, qs, lags):
    """float64 F(q, t) and F_s(q, t) of the float32 frames `traj` at the
    wavevectors `qs` and `lags`, over every window origin, with the sums'
    mean and largest amplitudes (|rho|, over every frame) and the self
    sums' mean amplitude a lag (|sum_j cos q . dr_j| over the origins)."""

    n_t, n = traj.shape[:2]
    cos = np.empty((n_t, n, len(qs)))
    sin = np.empty_like(cos)
    for f in range(n_t):
        phases = traj[f].astype(np.float64) @ qs.T
        np.cos(phases, out=cos[f])
        np.sin(phases, out=sin[f])
    rho = cos.sum(axis=1) + 1j * sin.sum(axis=1)  # (T, K)
    cisf, iisf, self_amp = [], [], []
    for lag in lags:
        m = n_t - lag
        cisf.append((rho[lag:] * rho[:m].conj()).real.sum(axis=0) / (n * m))
        # sum_j cos(q . (r_j(t0 + lag) - r_j(t0))), one row an origin.
        d = np.stack([np.einsum("nk,nk->k", cos[f + lag], cos[f])
                      + np.einsum("nk,nk->k", sin[f + lag], sin[f])
                      for f in range(m)])
        iisf.append(d.sum(axis=0) / (n * m))
        self_amp.append(np.abs(d).mean())
    return (np.array(cisf), np.array(iisf), np.abs(rho).mean(),
            np.abs(rho).max(), np.array(self_amp))


def check_isf_oracle(isf, traj, rng):
    """The ISF's cisf and iisf at ISF_ORACLE_LAGS on ISF_ORACLE_QS random
    wavevectors (not q = 0) against :func:`isf_oracle`.  Each per-frame sum
    may be off its float64 value by the trig phase's tolerance (1e-6 of the
    sums' mean amplitude exact, 1e-4 fast); carried through the products
    (plus their float32 rounding, 2^-22 of the largest |rho|^2) and the
    normalization by N."""

    qs_all = isf._wavevectors
    pick = np.sort(rng.choice(np.arange(1, len(qs_all)), ISF_ORACLE_QS,
                              replace=False))
    rows = [int(np.flatnonzero(isf._lag_values == lag)[0])
            for lag in ISF_ORACLE_LAGS]
    cisf, iisf, amp, top, self_amp = isf_oracle(traj, qs_all[pick],
                                                ISF_ORACLE_LAGS)
    eps = 1e-6 * amp
    tol_c = (eps * (2 * top + eps) + 2.0**-22 * top**2) / N_ATOMS
    tol_i = 1e-4 * self_amp[:, None] / N_ATOMS
    err_c = np.abs(isf.results.cisf[rows, 0][:, pick] - cisf)
    err_i = np.abs(isf.results.iisf[rows, 0][:, pick] - iisf)
    check(err_c.max() <= tol_c,
          f"cisf off the float64 oracle by {err_c.max():.3e} > {tol_c:.3e}")
    check(np.all(err_i <= tol_i),
          f"iisf off the float64 oracle by {err_i.max():.3e} (tolerances "
          f"{tol_i[:, 0]})")
    print(f"isf vs float64 oracle ({ISF_ORACLE_QS} wavevectors, lags "
          f"{ISF_ORACLE_LAGS}): max |cisf - oracle| {err_c.max():.3e} "
          f"(tolerance {tol_c:.3e}; mean |rho| {amp:.1f}, largest "
          f"{top:.1f}); max |iisf - oracle| by lag "
          f"{[float(f'{e:.3e}') for e in err_i.max(axis=1)]} (tolerances "
          f"{[float(f'{t:.3e}') for t in tol_i[:, 0]]}); oracle F_s "
          f"{[float(f'{v:.4f}') for v in iisf.mean(axis=1)]} (mean over "
          "the wavevectors)")
    return float(err_c.max()), float(err_i.max())


def phase_isf_kernel(device, rng):
    """The trig-sums kernel against its plain version at the incoherent
    ISF's shapes, as :func:`phase_trig_kernels` holds its shapes:
    ISF_KERNEL_FRAMES and then ISF_LAGS (the lag launch of a full ring, on
    a workspace of :func:`trig_workspace`) displacement frames of 100k
    atoms in +-L (differences of uniform frames) x the 24^3 grid, fast.
    Returns the timings of the two shapes."""

    import torch

    from mdhelper_tpu_torch.analysis.structure import _wavevector_grid
    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    a, _ = uniform_frames(rng, device, ISF_LAGS, N_ATOMS, cube(N_ATOMS))
    b, _ = uniform_frames(rng, device, ISF_LAGS, N_ATOMS, cube(N_ATOMS))
    delta = a - b
    del a, b
    qs = torch.from_numpy(_wavevector_grid([BOX] * 3, N_QPTS)).to(device)
    pick = torch.from_numpy(np.sort(np.random.default_rng(SEED).choice(
        len(qs), ORACLE_QS, replace=False))).to(device)
    what = (f"displacement frames in +-L x {N_ATOMS} atoms x {len(qs)} "
            "wavevectors")
    timing = {ISF_KERNEL_FRAMES: trig_vs_plain(
        qs, delta[:ISF_KERNEL_FRAMES], None, "fast",
        f"trig sums fast, {ISF_KERNEL_FRAMES} {what}", pick)}
    workspace = ck.trig_workspace(ISF_LAGS, N_ATOMS, len(qs), device)
    lag = timing[ISF_LAGS] = trig_vs_plain(
        qs, delta, None, "fast",
        f"trig sums fast, {ISF_LAGS} {what} (the lag launch of a full "
        "ring)", pick, workspace)
    print(f"lag launch of a full ring, {ISF_LAGS} displacement frames: "
          f"{ISF_LAGS * lag['ms']:.3f} ms a launch, bound "
          f"{ISF_LAGS * lag['bound_ms']:.3f} ms by {lag['bound_by']} "
          f"({100 * lag['bound_ms'] / lag['ms']:.1f} %); workspace "
          f"{workspace.numel() * 8 / 2**30:.3f} GiB")
    return timing


def phase_isf(device, rng, card):
    """The ISF paths at 100k atoms on one random walk of ISF_FRAMES frames:
    the direct route at full width (exact coherent sums, one launch a
    chunk; fast displacement sums of every resident lag, one launch a
    frame), its lag-0 F(q, 0) against the direct S(q) and F_s(q, 0) == 1,
    cisf and iisf against a float64 oracle; the default route (factorized
    sums in torch, no kernel) against it; the coherent time FFT against
    the coherent lag ring; the log lag grid's rows against the dense
    rows, bit for bit; and the sum rule of the dynamic structure factor.
    The direct and default routes' last ISF_PROFILED_FRAMES frames run
    under torch.profiler."""

    steps = [("trajectory", time.perf_counter())]
    traj, u = isf_universe(rng, ISF_FRAMES)
    n_chunks = -(-ISF_FRAMES // CHUNK)
    out = {}
    steps.append(("direct route", time.perf_counter()))

    dense = isf_analysis(u, device)
    launches, split, fps, busy, activities = run_isf_path(
        dense, ISF_FRAMES, ISF_PROFILED_FRAMES)
    check(dense._factor is None, "the direct ISF took the factor route")
    check(split["exact"] == n_chunks and split["fast"] == ISF_FRAMES
          and launches == n_chunks + ISF_FRAMES,
          f"direct ISF: {launches} trig-sums launches, {split} split; "
          f"expected {n_chunks} exact and {ISF_FRAMES} fast")
    cisf, iisf = dense.results.cisf, dense.results.iisf
    n_q = cisf.shape[-1]
    check(cisf.shape == (ISF_LAGS, 1, n_q) and iisf.shape == cisf.shape
          and np.all(np.isfinite(cisf)) and np.all(np.isfinite(iisf)),
          f"direct ISF: shapes {cisf.shape}, {iisf.shape} or values")
    check(np.all(iisf[0] == 1.0),
          f"F_s(q, 0) off 1 by {np.abs(iisf[0] - 1).max():.3e}")
    print(f"isf, direct: {N_ATOMS} atoms, {ISF_FRAMES} frames in chunks of "
          f"{CHUNK}, {n_q} wavevectors, {ISF_LAGS} lags, incoherent, exact; "
          f"{split['exact']} coherent (exact) and {split['fast']} lag (fast) "
          f"trig-sums launches ({launches} counted); F_s(q, 0) == 1; "
          f"{fps:.3f} frames/s on {card}, device busy {100 * busy:.1f} % of "
          f"the last {ISF_PROFILED_FRAMES} frames' wall time (profiler on; "
          f"{activities:.0f} device activities a frame)")
    out["direct"] = (launches, split, fps, busy)

    steps.append(("S(q)", time.perf_counter()))
    sf = sq_analysis(u, device)
    run_sq_path(sf, ISF_FRAMES)
    rel = check_ssf(cisf[0], sf.results.ssf, "ISF F(q, 0) against the "
                    "direct S(q)")
    steps.append(("float64 oracle", time.perf_counter()))
    err_c, err_i = check_isf_oracle(dense, traj, rng)
    print(f"isf F(q, 0) vs StructureFactor(method='direct') over the same "
          f"frames: max relative deviation {rel:.3e} (gate rtol 1e-4, atol "
          "1e-5)")

    steps.append(("default route", time.perf_counter()))
    auto = isf_analysis(u, device, method="auto")
    a_launches, _, a_fps, a_busy, a_activities = run_isf_path(
        auto, ISF_FRAMES, ISF_PROFILED_FRAMES)
    check(auto._factor is not None and auto._factor_split is None
          and a_launches == 0,
          f"default ISF: factor plan {auto._factor is not None}, "
          f"{a_launches} trig-sums launches")
    rel_c = check_ssf(auto.results.cisf, cisf, "default-route cisf against "
                      "the direct route")
    rel_i = check_ssf(auto.results.iisf, iisf, "default-route iisf against "
                      "the direct route")
    print(f"isf, default route (method='auto': factorized sums in torch, no "
          f"kernel): {a_fps:.3f} frames/s on {card}, device busy "
          f"{100 * a_busy:.1f} % of the last {ISF_PROFILED_FRAMES} frames' "
          f"wall time (profiler on; {a_activities:.0f} device activities a "
          "frame); max relative deviation from the direct "
          f"route: cisf {rel_c:.3e}, iisf {rel_i:.3e}")
    out["auto"] = (a_fps, a_busy)
    del auto

    steps.append(("time FFT and ring", time.perf_counter()))
    coh = {}
    for name, fft in (("isf_coh", None), ("isf_coh_ring", False)):
        analysis = isf_analysis(u, device, incoherent=False, fft=fft)
        c_launches, c_split, c_fps, _, _ = run_isf_path(analysis,
                                                        ISF_FRAMES)
        check(analysis._time_fft == (fft is None)
              and c_launches == c_split["exact"] == n_chunks,
              f"{name}: {c_launches} launches, {c_split}")
        coh[name] = (analysis.results.cisf, c_fps)
    rel_coh = check_ssf(coh["isf_coh"][0], coh["isf_coh_ring"][0],
                        "time-FFT F(q, t) against the lag ring")
    check(np.array_equal(coh["isf_coh_ring"][0], cisf),
          "the coherent ring's F(q, t) differs from the incoherent run's")
    print(f"isf_coh (time FFT) {coh['isf_coh'][1]:.3f} and isf_coh_ring "
          f"{coh['isf_coh_ring'][1]:.3f} frames/s on {card}; {n_chunks} "
          f"launches each; max relative deviation {rel_coh:.3e}")
    out["coh"] = (coh["isf_coh"][1], coh["isf_coh_ring"][1])

    steps.append(("log grid", time.perf_counter()))
    log = isf_analysis(u, device, lags="log")
    l_launches, l_split, l_fps, _, _ = run_isf_path(log, ISF_FRAMES)
    lags = log._lag_values
    check(l_split["fast"] == ISF_FRAMES and l_split["exact"] == n_chunks,
          f"isf_log: {l_split}")
    check(np.array_equal(log.results.cisf, cisf[lags])
          and np.array_equal(log.results.iisf, iisf[lags]),
          "isf_log: rows differ from the dense rows at the same lags")
    print(f"isf_log: {len(lags)} lags {lags.tolist()}, {l_launches} launches, "
          f"{l_fps:.3f} frames/s on {card}; rows equal the dense rows bit for "
          "bit")
    out["log"] = (l_launches, l_fps)

    steps.append(("dynamic structure factor", time.perf_counter()))
    dense.calculate_dynamic_structure_factor()
    omega = dense.results.angular_frequencies
    worst = 0.0
    for key, ref in (("dsf", cisf), ("idsf", iisf)):
        s = dense.results[key]
        period = s[0] + 2 * s[1:(ISF_LAGS + 1) // 2].sum(axis=0)
        if ISF_LAGS % 2 == 0:
            period = period + s[ISF_LAGS // 2]
        dev = np.abs(period * omega[1] - ref[0]) / np.abs(ref[0])
        check(dev.max() <= 1e-10, f"{key}: sum rule off by {dev.max():.3e}")
        worst = max(worst, float(dev.max()))
    print(f"dynamic structure factor: {len(omega)} frequencies; sum over one "
          f"period of S(q, w) dw against F(q, 0): max relative deviation "
          f"{worst:.3e} (dsf and idsf; tolerance 1e-10, the trapezoid sum's "
          "exact discrete identity)")
    out["oracle"] = (err_c, err_i)
    steps.append(("", time.perf_counter()))
    print("isf phase steps: " + ", ".join(
        f"{name} {t1 - t0:.1f} s"
        for (name, t0), (_, t1) in zip(steps, steps[1:])))
    return out


# Slice 11: the grouped main path -- the RDF, S(q) and Onsager MSD of
# residue centers of mass, fused -- on bench.py's water topology at the
# fused path's width: 33,333 3-site waters (99,999 atoms) in the 50 A cube,
# 8 + 32 frames, each molecule a rigid random walker of WATER_STEP A a frame
# and axis.  Beside it the mixed cross RDF of centers against atoms on one
# chunk, the Van Hove function of centers (8 + 24 frames, a 16-frame ring)
# and the ISF of centers (direct route, 8 + 8 frames, an 8-frame ring).
WATER_MOL = N_ATOMS // 3
WATER_STEP = 0.3
WATER_VH_FRAMES, WATER_VH_LAGS = 8 + 24, 16
WATER_ISF_FRAMES, WATER_ISF_LAGS = 8 + 8, 8


def water_universe(rng, n_frames):
    """WATER_MOL waters in the cubic box (``testing.water_system``) as an
    in-memory universe with their masses, residues and O-H bonds."""

    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.testing import water_system

    frames, topology = water_system(rng, WATER_MOL, BOX, n_frames,
                                    step=WATER_STEP)
    return frames, Universe.from_arrays(
        frames, np.array([BOX] * 3 + [90.0] * 3), dt=1.0, **topology)


def numpy_water_coms(frames, masses):
    """float32 centers of mass of consecutive 3-atom molecules in numpy:
    each atom's position times its float32 mass, summed in atom order
    from 0, over the masses summed the same way."""

    m = masses.astype(np.float32)
    weighted = frames * m[None, :, None]
    total = np.zeros(weighted[:, 0::3].shape, dtype=np.float32)
    mass = np.zeros(len(m) // 3, dtype=np.float32)
    for k in range(3):
        total = total + weighted[:, k::3]
        mass = mass + m[k::3]
    return total / mass[None, :, None]


def water_msd_check(msd, lags, what):
    """A center's mean-squared displacement after `lags` frames is
    3 WATER_STEP^2 lags (the intramolecular jitter moves a center by about
    1 % of one step); within 3 %.  Returns the largest relative
    deviation."""

    dev = np.abs(msd[1:] / (3 * WATER_STEP**2 * lags[1:]) - 1)
    check(np.all(np.isfinite(msd)) and abs(msd[0]) < 1e-6 * msd.max()
          and dev.max() < 0.03, f"{what}: MSD off 3 step^2 t by {dev.max()}")
    return float(dev.max())


def phase_groupings(device, rng, card):
    """The grouped main path on WATER_MOL waters: the bonded unwrap of the
    first frame on the host (timed; the molecules that straddle the box
    come out whole); run_together([RDF, S(q), Onsager], groupings=
    "residues") over 8 + 32 frames with the self cell kernel's launches
    counted and the last chunk under torch.profiler; the centers of mass
    of a chunk on the card against a numpy float32 fixed-order reduction,
    bit for bit; the self cell kernel on those centers against its plain
    version on the path's plan, and the trig-sums kernel (exact) against
    its plain version and a float64 oracle; the g(r) tail, the MSD of the
    centers, and S(q) against the direct route's over the same frames.
    Then the mixed cross RDF (one chunk, the cross kernel held against its
    plain version), the Van Hove function and the ISF of the centers."""

    import torch

    from mdhelper_tpu_torch.algorithm.topology import unwrap_edge
    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        StructureFactor,
        VanHoveFunction,
        _com_reducer,
        _wavevector_grid,
    )
    from mdhelper_tpu_torch.analysis.transport import Onsager
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    steps = [("trajectory", time.perf_counter())]
    frames, u = water_universe(rng, N_FRAMES)
    n_atoms = 3 * WATER_MOL
    n_chunks = -(-N_FRAMES // CHUNK)
    box = (BOX,) * 3
    out = {}

    steps.append(("bonded unwrap", time.perf_counter()))
    started = time.perf_counter()
    whole = unwrap_edge(group=u.atoms)
    out["unwrap_s"] = time.perf_counter() - started
    first = frames[0].astype(np.float64)
    arms = [first[k::3] - first[0::3] for k in (1, 2)]
    straddling = int(np.sum(np.any(np.abs(np.concatenate(arms, axis=1))
                                   > BOX / 2, axis=1)))
    longest = max(float(np.linalg.norm(whole[k::3] - whole[0::3],
                                       axis=1).max()) for k in (1, 2))
    check(straddling > 0 and longest < 1.2,
          f"bonded unwrap: {straddling} straddling molecules, longest O-H "
          f"{longest:.3f} A after the unwrap")
    print(f"bonded unwrap_edge of {WATER_MOL} waters ({n_atoms} atoms, "
          f"{straddling} straddling the box in frame 0) on the host: "
          f"{out['unwrap_s']:.3f} s; longest O-H after it {longest:.3f} A")

    steps.append(("grouped fused path", time.perf_counter()))
    common = dict(verbose=False, device=device)
    analyses = [
        RadialDistributionFunction(u.atoms, n_bins=N_BINS,
                                   range=(0.0, R_MAX), exclusion=(1, 1),
                                   groupings="residues", **common),
        StructureFactor(u.atoms, groupings="residues", n_points=N_QPTS,
                        sort=False, unique=False, method="factor",
                        precision="exact", **common),
        Onsager(u.atoms, groupings="residues", unwrap=True, **common),
    ]
    for a in analyses:
        a._chunk_bytes = CHUNK * n_atoms * 3 * 4
    reset_launches()
    fps, busy, activities = run_profiled(analyses, N_FRAMES, CHUNK)
    launches = cch.cell_pair_histogram.launches
    check(launches == n_chunks,
          f"grouped path: {launches} self kernel launches for {n_chunks} "
          "chunks")
    rdf, sf, ons = analyses
    check(rdf._n1 == sf._N == ons._N == WATER_MOL,
          f"entities {rdf._n1}, {sf._N}, {ons._N}, not {WATER_MOL}")
    g = rdf.results.rdf
    check(g.shape == (N_BINS,) and np.all(np.isfinite(g))
          and np.all(np.abs(g[-20:] - 1.0) < 0.02),
          f"grouped g(r) tail off 1: {g[-20:]}")
    msd = 6 * ons.results.msd_self[0, 0]
    msd_dev = water_msd_check(msd[:N_FRAMES // 2],
                              np.arange(N_FRAMES // 2), "grouped Onsager")
    print(f"grouped fused path (RDF + S(q) + MSD of residue centers): "
          f"{WATER_MOL} waters, {N_FRAMES} frames in chunks of {CHUNK}, "
          f"{launches} self kernel launches; g(r) tail mean "
          f"{g[-20:].mean():.5f}; center MSD within {100 * msd_dev:.2f} % "
          f"of 3 step^2 t; {fps:.3f} frames/s on {card}, device busy "
          f"{100 * busy:.1f} % of the last {CHUNK} frames' wall time "
          f"(profiler on; {activities:.0f} device activities a frame)")
    out.update(launches=launches, fps=fps, busy=busy)

    steps.append(("centers and kernels", time.perf_counter()))
    reduce, _ = _com_reducer(u.atoms, "residues", device)
    atoms = torch.from_numpy(frames[:CHUNK]).to(device)
    coms = reduce(atoms)
    expected = numpy_water_coms(frames[:CHUNK], u.atoms.masses)
    check(np.array_equal(coms.cpu().numpy().view(np.int32),
                         expected.view(np.int32)),
          "centers of mass on the card differ from the numpy fixed-order "
          "reduction")
    check(float(coms.min()) >= 0.0 and float(coms.max()) <= BOX,
          "a center of mass left [0, L]")
    print(f"centers of mass of {CHUNK} frames on the card == numpy float32 "
          "fixed-order reduction, bit for bit")
    out["self"] = self_kernel_vs_plain(
        coms, box, f"self kernel, {WATER_MOL} water centers, exclusion "
        "(1, 1) (grouped fused path)", plan=rdf._searched_cell_plan(),
        exclusion=(1, 1))
    qs = torch.from_numpy(_wavevector_grid([BOX] * 3, N_QPTS)).to(device)
    pick = torch.from_numpy(np.sort(np.random.default_rng(SEED).choice(
        len(qs), ORACLE_QS, replace=False))).to(device)
    out["trig"] = trig_vs_plain(
        qs, coms[:2].contiguous(), None, "exact",
        f"trig sums exact, 2 x {WATER_MOL} water centers x {len(qs)} "
        "float64 wavevectors", pick)

    steps.append(("direct S(q)", time.perf_counter()))
    direct = sq_analysis(u, device, groupings="residues")
    out["direct_launches"], direct_fps = run_sq_path(direct, N_FRAMES)
    check(out["direct_launches"] == n_chunks,
          f"direct S(q) of centers: {out['direct_launches']} launches")
    rel = check_ssf(sf.results.ssf, direct.results.ssf,
                    "grouped factor S(q) against the direct route")
    print(f"grouped S(q), factor route vs the direct route through the "
          f"trig-sums kernel ({out['direct_launches']} launches, "
          f"{direct_fps:.3f} frames/s): max relative deviation {rel:.3e} "
          "(gate rtol 1e-4, atol 1e-5)")

    steps.append(("mixed cross RDF", time.perf_counter()))
    mixed = RadialDistributionFunction(
        u.atoms, u.atoms, n_bins=N_BINS, range=(0.0, R_MAX),
        groupings=("residues", "atoms"), **common)
    mixed._chunk_bytes = CHUNK * n_atoms * 3 * 4
    reset_launches()
    # run(), which re-plans after a capacity overflow: the atoms of
    # molecules fill cells less evenly than the planner's Poisson model.
    mixed.run(stop=CHUNK)
    out["cross_launches"] = cch.cross_pair_histogram.launches
    retries = getattr(mixed, "_capacity_retries", 0)
    gm = mixed.results.rdf
    check(out["cross_launches"] == 1 + retries and np.all(np.isfinite(gm))
          and np.all(np.abs(gm[-20:] - 1.0) < 0.02),
          f"mixed RDF: {out['cross_launches']} cross launches, tail "
          f"{gm[-20:]}")
    out["cross"] = cross_kernel_vs_plain(
        coms[:2].contiguous(), atoms[:2].contiguous(), box,
        f"cross kernel, {WATER_MOL} centers x {n_atoms} atoms "
        "(mixed-grouping RDF path)", plan=mixed._searched_cell_plan(),
        plain_runs=1)
    print(f"mixed RDF (residues x atoms): {CHUNK} frames, "
          f"{out['cross_launches']} cross launch(es), {retries} re-plan(s) "
          f"after a capacity overflow (capacity_sigmas "
          f"{mixed._capacity_sigmas:g}); g(r) tail mean {gm[-20:].mean():.5f}")

    steps.append(("Van Hove", time.perf_counter()))
    vh_frames, u_vh = water_universe(rng, WATER_VH_FRAMES)
    vh = VanHoveFunction(u_vh.atoms, n_bins=N_BINS, range=(0.0, R_MAX),
                         grouping="residues", n_lags=WATER_VH_LAGS,
                         **common)
    vh._chunk_bytes = CHUNK * n_atoms * 3 * 4
    reset_launches()
    vh_fps, _, _ = run_profiled([vh], WATER_VH_FRAMES)
    out["vh_launches"] = cch.cross_pair_histogram.launches
    check(out["vh_launches"] == WATER_VH_FRAMES,
          f"Van Hove of centers: {out['vh_launches']} launches for "
          f"{WATER_VH_FRAMES} frames")
    counts_self = vh.results.counts_self
    check(counts_self[0, 0] == WATER_MOL * WATER_VH_FRAMES
          and counts_self[0, 1:].sum() == 0,
          "Van Hove of centers: lag-0 self counts not all in bin 0")
    # The centers of molecules that straddle the box jump as their atoms
    # wrap (the JAX package's centers of wrapped coordinates), so the
    # MSD is held against a float64 minimum-image MSD of the same centers.
    centers = numpy_water_coms(vh_frames, u_vh.atoms.masses).astype(
        np.float64)
    ref = np.zeros(WATER_VH_LAGS)
    for lag in range(1, WATER_VH_LAGS):
        d = centers[lag:] - centers[:-lag]
        d -= BOX * np.round(d / BOX)
        ref[lag] = (d**2).sum(-1).mean()
    vh_dev = float(np.max(np.abs(vh.results.msd[1:] - ref[1:]) / ref[1:]))
    check(vh.results.msd[0] == 0 and vh_dev < 1e-5,
          f"Van Hove of centers: MSD off the float64 oracle by {vh_dev:.3e}")
    gd = vh.results.gd
    check(np.all(np.isfinite(gd)) and np.all(np.abs(gd[:, -20:] - 1) < 0.02),
          "Van Hove of centers: distinct g(r, t) tail off 1")
    print(f"Van Hove of centers: {WATER_VH_FRAMES} frames, "
          f"{WATER_VH_LAGS} lags, {out['vh_launches']} cross launches; MSD "
          f"within {vh_dev:.3e} of a float64 numpy MSD of the centers; "
          f"{vh_fps:.3f} frames/s on {card}")

    steps.append(("ISF", time.perf_counter()))
    _, u_isf = water_universe(rng, WATER_ISF_FRAMES)
    isf = isf_analysis(u_isf, device, groupings="residues",
                       n_lags=WATER_ISF_LAGS)
    isf_launches, split, isf_fps, _, _ = run_isf_path(isf, WATER_ISF_FRAMES)
    isf_chunks = WATER_ISF_FRAMES // CHUNK
    check(split == {"exact": isf_chunks, "fast": WATER_ISF_FRAMES},
          f"ISF of centers: launches {split}")
    cisf, iisf = isf.results.cisf, isf.results.iisf
    check(np.all(np.isfinite(cisf)) and np.all(iisf[0] == 1.0),
          "ISF of centers: values, or F_s(q, 0) off 1")
    sf_isf = sq_analysis(u_isf, device, groupings="residues")
    run_sq_path(sf_isf, WATER_ISF_FRAMES)
    rel_isf = check_ssf(cisf[0], sf_isf.results.ssf,
                        "ISF of centers F(q, 0) against the direct S(q)")
    print(f"ISF of centers (direct route): {WATER_ISF_FRAMES} frames, "
          f"{WATER_ISF_LAGS} lags, {split['exact']} exact and {split['fast']}"
          f" fast trig-sums launches; F_s(q, 0) == 1; F(q, 0) vs the direct "
          f"S(q): max relative deviation {rel_isf:.3e}; {isf_fps:.3f} "
          f"frames/s on {card}")
    out["isf_launches"] = isf_launches
    steps.append(("", time.perf_counter()))
    print("groupings phase steps: " + ", ".join(
        f"{name} {t1 - t0:.1f} s"
        for (name, t0), (_, t1) in zip(steps, steps[1:])))
    return out


ELECTRO_STEP = 0.3
#: CODATA 2018: e (C), N_A (1/mol), R (kJ/(mol K)).
E_CHARGE, AVOGADRO, GAS_R = 1.602176634e-19, 6.02214076e23, 8.314462618e-3
#: ions of the one frame that radial_histogram sweeps against its oracle.
HIST_IONS = 2_000


def electrolyte_universe(rng, n_frames):
    """bench.py's conductivity system at the fused width: N_ATOMS ions
    (charges +1 and -1 alternating, as bench.py tiles them; masses 1) in
    the cubic box, each an independent random walker of normal steps of
    ELECTRO_STEP A a frame and axis from uniform positions, wrapped into
    the box as float32 (1 ps a frame, so D = ELECTRO_STEP^2 / 2 =
    0.045 A^2/ps)."""

    from mdhelper_tpu_torch.core.universe import Universe

    steps = rng.normal(0.0, ELECTRO_STEP, (n_frames, N_ATOMS, 3))
    steps[0] = rng.random((N_ATOMS, 3)) * BOX
    traj = np.mod(np.cumsum(steps, axis=0), BOX).astype(np.float32)
    del steps
    return traj, Universe.from_arrays(
        traj, np.array([BOX] * 3 + [90.0] * 3), dt=1.0,
        charges=np.tile([1.0, -1.0], N_ATOMS // 2))


def electrolyte_path(u, device):
    """The electrolyte path's analyses: the cation-anion RDF, the partial
    S(q) of the two species on the 24^3 grid (the factorized route) and
    the centered, unwrapped Onsager of the two species at 300 K, in
    CHUNK-frame chunks."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        StructureFactor,
    )
    from mdhelper_tpu_torch.analysis.transport import Onsager

    common = dict(verbose=False, device=device)
    cations, anions = u.atoms[0::2], u.atoms[1::2]
    analyses = [
        RadialDistributionFunction(cations, anions, n_bins=N_BINS,
                                   range=(0.0, R_MAX), **common),
        StructureFactor([cations, anions], mode="partial", n_points=N_QPTS,
                        **common),
        Onsager([cations, anions], temperature=300, unwrap=True,
                center=True, **common),
    ]
    for a in analyses:
        a._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    return analyses


def electrolyte_posthoc(rdf, sq, ons):
    """Every post-hoc method of the path; returns the screening length,
    or the fit's refusal when S_ZZ shows no q^2 suppression."""

    import warnings

    rho = (N_ATOMS // 2) / BOX**3
    with warnings.catch_warnings():
        # A flat g(r) has shallow noise minima ("No local minima found"
        # when none passes the threshold).
        warnings.simplefilter("ignore")
        rdf.calculate_coordination_numbers(rho)
    rdf.calculate_pmf(300)
    rdf.calculate_structure_factor(rho, 0.5, 0.5)
    sq.calculate_weighted_sum([1.0, 1.0])
    sq.calculate_charge_structure_factor()
    try:
        screening = sq.calculate_screening_length()
    except ValueError as exc:
        # Uncorrelated walkers are not screened: S_ZZ is flat at low q.
        check("no q^2 suppression" in str(exc), f"screening fit: {exc}")
        screening = None
    ons.calculate_transport_coefficients()
    ons.calculate_conductivity()
    ons.calculate_nernst_einstein_conductivity()
    ons.calculate_ionicity()
    ons.calculate_electrophoretic_mobility()
    ons.calculate_transference_number()
    return screening


def phase_electrolyte(device, rng, card):
    """The electrolyte path on a 100k-ion 1:1 electrolyte (bench.py's
    conductivity system, electrolyte_universe): run_together([cation-anion
    RDF, partial S(q), Onsager(unwrap, center)]) over 8 + 32 frames with
    the cross kernel's launches counted, then every post-hoc method of the
    three classes (units, coordination numbers, PMF, S(q) from g(r),
    weighted and charge S(q), screening length, transport coefficients,
    conductivity, Nernst-Einstein, ionicity, mobility, transference),
    clocked as bench.py's config phases clock it (from the end of the
    first chunk through the conclusions and the post-hoc methods); the
    same path again with its last chunk under torch.profiler for the
    device's busy share.  Checks: the g(r) tail, each D_i within 3 % of
    the walk's, kappa_NE against the CODATA hand formula from the run's
    own D_i, kappa == kappa_NE for one ion, the cross kernel on the
    path's plan against its plain version, radial_histogram on the card
    against a numpy float64 histogram, and msd_shift of the stored
    positions against the FFT MSDs."""

    import torch

    from mdhelper_tpu_torch.algorithm.correlation import msd_shift
    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.analysis.structure import radial_histogram
    from mdhelper_tpu_torch.analysis.transport import Onsager
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.testing import f64_cross_histogram

    steps = [("trajectory", time.perf_counter())]
    traj, u = electrolyte_universe(rng, N_FRAMES)
    n_chunks = -(-N_FRAMES // CHUNK)
    box = (BOX,) * 3
    out = {}

    steps.append(("timed path", time.perf_counter()))
    analyses = electrolyte_path(u, device)
    marks = []

    def on_chunk(batch):
        if not marks:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

    reset_launches()
    run_together(analyses, on_chunk=on_chunk)
    out["launches"] = cch.cross_pair_histogram.launches
    concluded = time.perf_counter()
    screening = electrolyte_posthoc(*analyses)
    done = time.perf_counter()
    out["posthoc_s"] = done - concluded
    out["fps"] = (N_FRAMES - CHUNK) / (done - marks[0])
    check(out["launches"] == n_chunks,
          f"electrolyte path: {out['launches']} cross kernel launches for "
          f"{n_chunks} chunks")
    rdf, sq, ons = analyses
    g = rdf.results.rdf
    check(g.shape == (N_BINS,) and np.all(np.isfinite(g))
          and np.all(np.abs(g[-20:] - 1.0) < 0.02),
          f"cation-anion g(r) tail off 1: {g[-20:]}")
    walk_d = ELECTRO_STEP**2 / 2
    D = ons.results.D_i[0]
    dev = np.abs(D / walk_d - 1)
    check(np.all(np.isfinite(D)) and dev.max() < 0.03,
          f"D_i {D} off the walk's {walk_d} by {dev.max():.3%}")
    kappa_ne = float(ons.results.ne_conductivities[0])
    hand = (E_CHARGE**2 * AVOGADRO * (N_ATOMS // 2) * D.sum()
            / (BOX**3 * GAS_R * 300))
    check(abs(kappa_ne / hand - 1) < 1e-10,
          f"kappa_NE {kappa_ne} differs from the CODATA hand formula {hand}")
    szz = sq.results.charge_ssf
    check(np.all(np.isfinite(szz)) and abs(np.mean(szz[1:]) - 1) < 0.05,
          f"S_ZZ of uncorrelated ions not about <z^2> = 1: "
          f"mean {np.mean(szz[1:])}")
    units = ons.results.units
    check(str(units["results.conductivities"])
          == "coulomb ** 2 / kilojoule / angstrom / picosecond"
          and str(units["results.D_i"]) == "angstrom ** 2 / picosecond",
          f"Onsager units {units}")
    kappa = float(ons.results.conductivities[0])
    screening_text = ("not resolved (no q^2 suppression)" if screening is None
                      else f"{screening:.4f} A")
    out.update(D=D, kappa=kappa, kappa_ne=kappa_ne,
               ionicity=float(ons.results.ionicity[0]))
    print(f"electrolyte path (cation-anion RDF + partial S(q) + centered "
          f"Onsager, then every post-hoc method): {N_ATOMS} ions, "
          f"{N_FRAMES} frames in chunks of {CHUNK}, {out['launches']} cross "
          f"kernel launches; {out['fps']:.3f} frames/s on {card} from the "
          f"end of the first chunk through the post-hoc methods, which took "
          f"{out['posthoc_s']:.3f} s on the host; g(r) tail mean "
          f"{g[-20:].mean():.5f}; mean S_ZZ {np.mean(szz[1:]):.4f}; "
          f"screening length {screening_text}")
    print(f"electrolyte transport (log-log fits, slope 1): D_i {D[0]:.6f} "
          f"and {D[1]:.6f} A^2/ps (walk {walk_d}), within "
          f"{100 * dev.max():.2f} %; kappa {kappa:.6e}, kappa_NE "
          f"{kappa_ne:.6e} C^2/(kJ A ps) (CODATA hand formula {hand:.6e}); "
          f"ionicity {out['ionicity']:.6f}; transference numbers "
          f"{ons.results.transference_numbers[0]}")
    ons.calculate_transport_coefficients(scale="linear")
    ons.calculate_ionicity()
    print(f"electrolyte transport (linear fits): kappa "
          f"{ons.results.conductivities[0]:.6e}, kappa_NE "
          f"{ons.results.ne_conductivities[0]:.6e}, ionicity "
          f"{ons.results.ionicity[0]:.6f}")

    steps.append(("profiled path", time.perf_counter()))
    _, out["busy"], activities = run_profiled(electrolyte_path(u, device),
                                              N_FRAMES, CHUNK)
    print(f"electrolyte path: device busy {100 * out['busy']:.1f} % of the "
          f"last {CHUNK} frames' wall time (profiler on; {activities:.0f} "
          "device activities a frame)")

    steps.append(("single ion", time.perf_counter()))
    one = Onsager(u.atoms[:1], unwrap=True, charges=[1.0], verbose=False,
                  device=device)
    one._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    run_together([one])
    one.calculate_transport_coefficients(scale="linear")
    one.calculate_ionicity()
    gap = abs(one.results.conductivities[0]
              / one.results.ne_conductivities[0] - 1)
    check(gap < 1e-10, f"one ion: kappa / kappa_NE - 1 = {gap}")
    print(f"one ion: kappa {one.results.conductivities[0]:.6e} == kappa_NE "
          f"{one.results.ne_conductivities[0]:.6e} (relative gap {gap:.1e})")

    steps.append(("cross kernel", time.perf_counter()))
    frames = torch.from_numpy(traj[:2]).to(device)
    out["cross"] = cross_kernel_vs_plain(
        frames[:, 0::2].contiguous(), frames[:, 1::2].contiguous(), box,
        f"cross kernel, {N_ATOMS // 2} cations x {N_ATOMS // 2} anions "
        "(electrolyte path)", plan=rdf._searched_cell_plan(), plain_runs=1)

    steps.append(("radial_histogram", time.perf_counter()))
    pos = traj[N_FRAMES // 2, :HIST_IONS]
    counts = radial_histogram(pos, pos, N_BINS, (0.0, R_MAX), box,
                              exclusion=(1, 1), device=device)
    oracle = f64_cross_histogram(pos, pos, BOX, R_MAX, N_BINS, (1, 1))
    check(np.array_equal(counts, oracle) and counts.sum() > 0,
          "radial_histogram on the card differs from the float64 oracle")
    print(f"radial_histogram of {HIST_IONS} ions, one frame, on the card: "
          f"{int(counts.sum())} pairs == float64 numpy histogram")

    steps.append(("msd_shift", time.perf_counter()))
    started = time.perf_counter()
    worst = 0.0
    for i in range(2):
        positions = ons._positions[:, ons._entity_slices[i]][None]
        shift = msd_shift(positions, axis=1, average=True) / 6
        ref = ons.results.msd_self[i]
        worst = max(worst, float(np.max(np.abs(shift - ref))
                                 / np.abs(ref).max()))
    out["shift_s"] = time.perf_counter() - started
    check(worst < 1e-8, f"msd_shift vs the FFT MSDs: {worst}")
    print(f"msd_shift (direct windows, numpy on the host) of both species' "
          f"{N_ATOMS // 2} centered ions x {N_FRAMES} frames: "
          f"{out['shift_s']:.2f} s, within {worst:.1e} of the FFT MSDs' "
          "largest value")
    steps.append(("", time.perf_counter()))
    print("electrolyte phase steps: " + ", ".join(
        f"{name} {t1 - t0:.1f} s"
        for (name, t0), (_, t1) in zip(steps, steps[1:])))
    return out


# Slice 13: the main path from files.  The fused path's trajectory
# (slice_universe's data, 8 + 32 frames of 100k atoms) written with the
# port's writers -- a GRO topology of atoms named A and B alternately, an
# XTC (bench.py's precision, 0.001 nm) and a DCD -- and read back through
# Universe.from_files and select_atoms.
XTC_PRECISION = 1000.0


def decoded_universe(u):
    """An in-memory universe over `u`'s reader's own frames, decoded and
    cast to float32 as the stream casts them, with `u`'s names, times and
    boxes."""

    from mdhelper_tpu_torch.core.trajectory import ArrayReader
    from mdhelper_tpu_torch.core.universe import Topology, Universe

    reader = u.trajectory
    pos, dims = reader.read_frames(np.arange(reader.n_frames))
    return Universe(
        Topology(u.atoms.n_atoms, names=u.atoms.names),
        ArrayReader(pos.astype(np.float32), dims, dt=reader.dt,
                    times=reader.times),
    )


def files_path(u, device, prefetch, sigmas=4.0):
    """The main path's analyses of ``u.select_atoms("all")``, the stream
    prefetched one chunk deep or not, the RDF's cell plan `sigmas` wide."""

    analyses = slice_analyses(u, device, group=u.select_atoms("all"))
    analyses[0]._capacity_sigmas = sigmas
    for a in analyses:
        a._prefetch_batches = prefetch
    return analyses


def replanned(make, run, what, replans, sigmas, data):
    """``run(make(s))`` with the cell plans ``s = sigmas[data]`` wide (the
    default 4 for data not seen yet), re-planned 2 sigmas wider after a
    cell overflows its plan, twice at most, as an analysis's ``run()``
    re-plans (``run_together`` raises instead: ROADMAP Queue 3, item 1).
    The width found is kept in `sigmas` for the next run over the same
    `data`; each re-plan is noted in `replans`.  Returns ``(analyses,
    run's value)``."""

    from mdhelper_tpu_torch.ops.cuda_cell_histogram import (
        CellCapacityOverflow,
    )

    while True:
        s = sigmas.setdefault(data, 4.0)
        analyses = make(s)
        try:
            return analyses, run(analyses)
        except CellCapacityOverflow as err:
            check(s < 8.0, f"{what}: {err}")
            replans.append(f"{what}: {str(err).split(':')[0]} at {s:g} "
                           f"sigmas, re-planned at {s + 2:g}")
            sigmas[data] = s + 2.0


def same_fused(run, ref, what):
    """Check a fused run against another over the same float32 frames:
    RDF counts equal as integers, S(q) within the S(q) gate, the MSDs
    within rtol 1e-8; returns whether S(q) and the MSDs are bit-equal."""

    (rdf, sf, ons), (rdf_r, sf_r, ons_r) = run, ref
    check(rdf.results.counts.sum() > 0 and np.array_equal(
        rdf.results.counts, rdf_r.results.counts),
        f"{what}: RDF counts differ")
    check(np.allclose(sf.results.ssf, sf_r.results.ssf, rtol=1e-4,
                      atol=1e-5), f"{what}: S(q) outside the gate")
    bits = np.array_equal(sf.results.ssf, sf_r.results.ssf)
    for key in ("msd_self", "msd_cross"):
        a, b = ons.results[key], ons_r.results[key]
        check(np.allclose(a, b, rtol=1e-8, atol=1e-9 * np.abs(b).max()),
              f"{what}: {key} outside rtol 1e-8")
        bits = bits and np.array_equal(a, b)
    return bits


def phase_files(device, rng, card):
    """The main path from files: the fused trajectory written as GRO +
    XTC and GRO + DCD, ``Universe.from_files``, run_together([RDF, S(q),
    Onsager]) on ``select_atoms("all")`` with the self kernel's launches
    counted (the XTC run, prefetch on), one chunk of the cross RDF of
    ``name A`` and ``name B`` with the cross kernel's, each against the
    same analyses over an ArrayReader of the reader's own decoded float32
    frames; the DCD's frames bit-equal to the float32 arrays written, the
    XTC's within half its precision step, the native codec loaded; the
    fused path's frames/s from the ArrayReader, the DCD and the XTC with
    the prefetch on and off, the host's decode time a chunk, the device's
    busy share (XTC, prefetch on), and both kernels on the path's plans
    against their plain versions."""

    import tempfile

    import torch

    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
    )
    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.io import _xtc_native, dcd, structure_writers, xtc
    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    started = time.perf_counter()
    check(_xtc_native.load() is not None,
          "the native XTC codec did not load (no C++ compiler?)")
    traj, _ = slice_universe(rng, N_FRAMES)
    dims = np.array([BOX] * 3 + [90.0] * 3)
    names = np.where(np.arange(N_ATOMS) % 2 == 0, "A", "B")
    n_chunks = -(-N_FRAMES // CHUNK)
    out, fps = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: os.path.join(tmp, name)
                 for name in ("top.gro", "traj.xtc", "traj.dcd")}
        written = time.perf_counter()
        structure_writers.write_gro(paths["top.gro"], traj[0], names=names,
                                    dimensions=dims)
        xtc.write_xtc(paths["traj.xtc"], traj / np.float32(10.0),
                      np.tile(np.eye(3) * BOX / 10, (N_FRAMES, 1, 1)),
                      precision=XTC_PRECISION)
        dcd.write_dcd(paths["traj.dcd"], traj, np.tile(dims, (N_FRAMES, 1)))
        written = time.perf_counter() - written
        sizes = {k: os.path.getsize(v) / 2**20 for k, v in paths.items()}
        universes = {fmt: Universe.from_files(paths["top.gro"],
                                              paths[f"traj.{fmt}"])
                     for fmt in ("xtc", "dcd")}

        # The native codec decodes a frame as the Python codec would.
        raw = xtc.XTCFile(paths["traj.xtc"])
        payload = bytes(raw._data[raw._offsets[0] + 56:raw._offsets[1]])
        native = _xtc_native.native_decompress(payload, N_ATOMS)
        check(native is not None and np.array_equal(
            native[0], raw.read_frame(0)[0]),
            "the native XTC codec did not decode the first frame")
        raw.close()

        # Host decode, a chunk at a time, as the stream reads it.
        decode_ms = {}
        for fmt, u in universes.items():
            times = []
            for lo in range(0, N_FRAMES, CHUNK):
                t0 = time.perf_counter()
                u.trajectory.read_frames(np.arange(lo, lo + CHUNK))
                times.append(1e3 * (time.perf_counter() - t0))
            decode_ms[fmt] = times
        arrays = {fmt: decoded_universe(u) for fmt, u in universes.items()}
        pos_dcd = arrays["dcd"].trajectory._positions
        check(np.array_equal(pos_dcd, traj),
              "DCD positions differ from the float32 arrays written")
        pos_xtc = arrays["xtc"].trajectory._positions
        xtc_err = float(np.abs(pos_xtc.astype(np.float64) - traj).max())
        half_step = 0.5 * 10.0 / XTC_PRECISION
        check(xtc_err <= half_step + 4 * float(np.spacing(np.float32(BOX))),
              f"XTC positions off by {xtc_err} A (half step {half_step})")

        # The path from the XTC with the launches counted, then each route
        # with the prefetch on and off; each file run against the run over
        # its reader's own decoded frames.
        replans, sigmas = [], {}

        def counted(analyses):
            reset_launches()
            return run_timed(analyses)

        # The first run (the launches counted) also warms what the timed
        # runs find made: cuFFT plans, cuBLAS handles, allocator pools.
        _, warm_fps = replanned(
            lambda s: files_path(universes["xtc"], device, True, s), counted,
            "xtc, prefetch on", replans, sigmas, "xtc")
        out["launches"] = cch.cell_pair_histogram.launches
        check(out["launches"] == n_chunks,
              f"files path: {out['launches']} kernel launches for "
              f"{n_chunks} chunks")
        # Each route with the prefetch on and off, in turns (ABCDEF then
        # FEDCBA, so each keeps its mean position in the order).
        sources = {"xtc": universes["xtc"], "dcd": universes["dcd"],
                   "array": arrays["xtc"], "dcd array": arrays["dcd"]}
        order = [(route, prefetch) for route in ("array", "dcd", "xtc")
                 for prefetch in (True, False)]
        runs, fps = {}, {key: [] for key in order}
        for key in order + order[::-1] + [("dcd array", True)]:
            route, prefetch = key
            runs[key], value = replanned(
                lambda s: files_path(sources[route], device, prefetch, s),
                run_timed, f"{route}, prefetch {'on' if prefetch else 'off'}",
                replans, sigmas, route.split()[0].replace("array", "xtc"))
            fps.setdefault(key, []).append(value)
        bits = {}
        for fmt, array in (("xtc", "array"), ("dcd", "dcd array")):
            bits[fmt] = same_fused(runs[fmt, True], runs[array, True],
                                   f"{fmt} vs its decoded frames")
            bits[fmt, "off"] = same_fused(runs[fmt, False], runs[fmt, True],
                                          f"{fmt}, prefetch off vs on")
        rdf, _, _ = runs["xtc", True]
        g = rdf.results.rdf
        check(np.all(np.abs(g[-20:] - 1.0) < 0.02),
              f"files path g(r) tail off 1: {g[-20:]}")

        # One chunk of the cross RDF of two selections.
        u = universes["xtc"]
        cross = {}

        def cross_rdf(uu, sigmas):
            rdf = RadialDistributionFunction(
                uu.select_atoms("name A"), uu.select_atoms("name B"),
                n_bins=N_BINS, range=(0.0, R_MAX),
                capacity_sigmas=sigmas, verbose=False, device=device)
            rdf._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
            return rdf

        def one_chunk(rdf):
            reset_launches()
            run_together([rdf], stop=CHUNK)
            return cch.cross_pair_histogram.launches

        for route, uu in (("xtc", u), ("array", arrays["xtc"])):
            cross[route], launches = replanned(
                lambda s: cross_rdf(uu, s), one_chunk,
                f"{route} cross RDF", replans, sigmas, "cross")
            if route == "xtc":
                out["cross_launches"] = launches
        check(out["cross_launches"] == 1,
              f"files cross RDF: {out['cross_launches']} launches")
        check(cross["xtc"].results.counts.sum() > 0 and np.array_equal(
            cross["xtc"].results.counts, cross["array"].results.counts),
            "files cross RDF: counts differ from the decoded frames'")

        # The device's busy share, the last chunk under the profiler.
        _, (_, out["busy"], activities) = replanned(
            lambda s: files_path(u, device, True, s),
            lambda a: run_profiled(a, N_FRAMES, CHUNK),
            "xtc, profiled", replans, sigmas, "xtc")

        # Both kernels on the paths' plans against their plain versions.
        frames = torch.from_numpy(pos_xtc[:2]).to(device)
        out["self"] = self_kernel_vs_plain(
            frames, (BOX,) * 3, f"self kernel, {N_ATOMS} atoms from the XTC "
            "(files path)", plan=rdf._searched_cell_plan())
        a_ix = u.select_atoms("name A").ix
        b_ix = u.select_atoms("name B").ix
        out["cross"] = cross_kernel_vs_plain(
            frames[:, a_ix].contiguous(), frames[:, b_ix].contiguous(),
            (BOX,) * 3, f"cross kernel, name A x name B, {len(a_ix)} x "
            f"{len(b_ix)} from the XTC (files cross RDF)",
            plan=cross["xtc"]._searched_cell_plan())
        del universes, arrays, runs

    out["seconds"] = time.perf_counter() - started
    print(f"files: wrote {N_ATOMS} atoms x {N_FRAMES} frames with the port's "
          f"writers in {written:.2f} s (GRO {sizes['top.gro']:.1f} MiB, XTC "
          f"{sizes['traj.xtc']:.1f} MiB, DCD {sizes['traj.dcd']:.1f} MiB); "
          f"native XTC codec loaded; DCD frames == the float32 arrays "
          f"written; XTC frames within {xtc_err:.6f} A of them (half step "
          f"{half_step:g} A)")
    print(f"files: host decode a {CHUNK}-frame chunk: XTC "
          f"{np.mean(decode_ms['xtc']):.2f} ms (runs "
          f"{[round(x, 2) for x in decode_ms['xtc']]}), DCD "
          f"{np.mean(decode_ms['dcd']):.2f} ms (runs "
          f"{[round(x, 2) for x in decode_ms['dcd']]}), on {os.cpu_count()} "
          "host cores")
    for fmt in ("xtc", "dcd"):
        print(f"files: {fmt} fused path vs its reader's decoded float32 "
              f"frames in an ArrayReader: counts equal; S(q) and the MSDs "
              f"{'bit-equal' if bits[fmt] else 'within the gates, not bit-equal'}"
              f"; prefetch off vs on "
              f"{'bit-equal' if bits[fmt, 'off'] else 'within the gates'}")
    print(f"files: cross RDF of name A x name B, one chunk: "
          f"{out['cross_launches']} cross launch(es), counts == the decoded "
          f"frames'; fused path from the XTC: {out['launches']} self "
          f"launches, device busy {100 * out['busy']:.1f} % of the last "
          f"{CHUNK} frames' wall time ({activities:.0f} device activities a "
          "frame)")
    print(f"files: first run (XTC, prefetch on, launches counted, warm-up): "
          f"{warm_fps:.3f} frames/s")
    for route, text in (("array", "an ArrayReader of the XTC's frames"),
                        ("dcd", "the DCD"), ("xtc", "the XTC")):
        on, off = fps[route, True], fps[route, False]
        print(f"files: fused path from {text}: {np.mean(on):.3f} frames/s "
              f"with the prefetch (runs {[round(x, 3) for x in on]}), "
              f"{np.mean(off):.3f} without (runs "
              f"{[round(x, 3) for x in off]}), in turns, on {card} "
              "(information, not a claim)")
    out["fps"] = {f"{route} {'on' if p else 'off'}": float(np.mean(v))
                  for (route, p), v in fps.items()}
    print("files: cell plans re-planned after an overflow: "
          + ("; ".join(replans) if replans else "none"))
    print(f"the files phase took {out['seconds']:.1f} s")
    return out


# Slice 14: density profiles and electrostatics.  bench.py's config-4
# phase: the z density profiles of the 100k-ion electrolyte's cations and
# anions (200 bins) and the Poisson potential across the cell; the
# dipole-fluctuation permittivity of WATER_MOL SPC/E waters; one chunk
# each of the radial profiles, a center-of-mass center and the 2-D and
# 3-D density maps.
PROFILE_BINS = 200
PROFILE_TURNS, PROFILE_TURN_FRAMES = 4, 128
MAP2D_BINS, MAP3D_BINS = 192, 64
RADIAL_CENTER_ATOMS = 16


def kernel_launch_counts():
    """Every kernel wrapper's launch count, by kernel."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.ops import cuda_kernels

    kernels = (cch.cell_pair_histogram, cch.cross_pair_histogram,
               cch.triclinic_cell_pair_histogram,
               cch.triclinic_cross_pair_histogram, cuda_kernels.trig_sums,
               cuda_kernels.pair_histogram)
    return {k.__name__: k.launches for k in kernels}


def numpy_wrap(x, length):
    """float32 ``x - floor(x / L) * L`` with the product and the
    difference rounded once, as the port's ``wrap_positions``."""

    from mdhelper_tpu_torch.testing import fma32

    length = np.float32(length)
    return fma32(-np.floor(x / length), length, x)


def f32_group_com(pos, masses):
    """float32 centers of mass ``(B, 3)`` of ``pos`` ``(B, K, 3)``: the
    weighted float32 positions summed atom by atom from 0, over the
    masses summed so (the port's segment reduction)."""

    m = masses.astype(np.float32)
    total = np.zeros((len(pos), 3), np.float32)
    mass = np.float32(0)
    for k in range(pos.shape[1]):
        total = total + pos[:, k] * m[k]
        mass = mass + m[k]
    return total / mass


def f64_radial_counts(pos, centers, box, edges, drop_axis=None):
    """float64 histogram of the minimum-image distances of float32 `pos`
    ``(B, N, 3)`` from float32 `centers` ``(B, 3)`` in the cube `box`,
    with `drop_axis` left out (cylindrical)."""

    counts = np.zeros(len(edges) - 1, np.int64)
    for b in range(len(pos)):
        d = pos[b].astype(np.float64) - centers[b].astype(np.float64)
        d -= box * np.round(d / box)
        if drop_axis is not None:
            d[:, drop_axis] = 0.0
        counts += np.histogram(np.sqrt((d * d).sum(-1)), bins=edges)[0]
    return counts


def run_alone(analyses, on_chunk=None, frames=None):
    """``run()`` of the one analysis in `analyses` (its own stream, which
    carries only its coordinate columns), calling ``on_chunk(batch)``
    after each chunk's update as run_together does."""

    (analysis,) = analyses
    if on_chunk is not None:
        batched = analysis._batched_update

        def hooked(carry, batch):
            carry = batched(carry, batch)
            on_chunk(batch)
            return carry

        analysis._batched_update = hooked
    analysis.run(frames=frames)
    return analyses


def profile_analysis(groups, device, columns=True):
    """bench.py's config-4 DensityProfile (z, PROFILE_BINS bins) in chunks
    of CHUNK frames; with ``columns=False`` it streams all three
    coordinates and takes z on the device (``_coord_axes`` off)."""

    from mdhelper_tpu_torch.analysis.profile import DensityProfile

    class AllColumns(DensityProfile):
        def _prepare(self):
            super()._prepare()
            axes, self._coord_axes = self._coord_axes, None
            update = self._update
            self._update = lambda carry, positions, dimensions, mask: update(
                carry, positions[:, :, axes], dimensions, mask)

    cls = DensityProfile if columns else AllColumns
    a = cls(groups, axes="z", n_bins=PROFILE_BINS, verbose=False,
            device=device)
    a._chunk_bytes = CHUNK * N_ATOMS * (1 if columns else 3) * 4
    return a


def phase_profiles(device, rng, card):
    """Slice 14 on the card.  bench.py's config-4 path: DensityProfile of
    the cations and anions of the 100k-ion electrolyte (electrolyte_universe,
    select_atoms by charge) along z, 200 bins, over 8 + 32 frames, then
    calculate_potential_profile(dielectric=78, axis="z"), clocked from
    the end of the first chunk through the conclusion and the potential;
    the device's busy share (run_profiled); the host-to-device bytes a
    chunk; the path with the z column sliced on the device instead
    (``_coord_axes`` off) in turns with the default after a warm-up run.
    Checks: the counts equal numpy histograms of the same float32 wrapped
    z against the float32 edges, the densities average to N/V, the
    potential is finite.  The permittivity path: DipoleMoment(unwrap=True)
    of WATER_MOL SPC/E waters over 8 + 32 frames, the relative
    permittivity at 300 K and the dielectric spectrum; the dipoles against
    a float64 numpy sum of the numpy-unwrapped float32 positions.  One
    chunk each of RadialDensityProfile (spherical about the box center,
    cylindrical about z through it, spherical about the center of mass of
    RADIAL_CENTER_ATOMS ions), DensityMap2D (192^2) and DensityMap3D
    (64^3), each against a numpy oracle on the same edges.  No kernel of
    the kernels line launches in this phase."""

    import warnings

    import torch

    from mdhelper_tpu_torch.algorithm.topology import unwrap_edge
    from mdhelper_tpu_torch.analysis.electrostatics import (
        DipoleMoment,
        calculate_dielectric_spectrum,
    )
    from mdhelper_tpu_torch.analysis.profile import (
        DensityMap2D,
        DensityMap3D,
        RadialDensityProfile,
    )
    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.ops.profiles import linspace_edges_f32
    from mdhelper_tpu_torch.testing import water_system

    started = time.perf_counter()
    steps = [("trajectory", time.perf_counter())]
    traj, u = electrolyte_universe(rng, N_FRAMES)
    groups = [u.select_atoms("charge > 0"), u.select_atoms("charge < 0")]
    volume = BOX**3
    out = {}
    launches_before = kernel_launch_counts()

    def timed(analysis, posthoc=None, frames=None):
        """``analysis.run()`` over `frames` (default: all N_FRAMES), clocked
        from the end of the first chunk through the conclusion and
        `posthoc`: frames/s."""

        marks = []
        n_frames = N_FRAMES if frames is None else len(frames)

        def on_chunk(batch):
            if not marks:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                marks.append(batch.n_real)

        run_alone([analysis], on_chunk=on_chunk, frames=frames)
        if posthoc is not None:
            posthoc(analysis)
        torch.cuda.synchronize()
        return (n_frames - marks[1]) / (time.perf_counter() - marks[0])

    def potential(a):
        # bench.py's call: sigma_q from the plateau of the integrated
        # charge density (which warns that it does so).
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a.calculate_potential_profile(dielectric=78.0, axis="z")

    steps.append(("config-4 path", time.perf_counter()))
    profile = profile_analysis(groups, device)
    out["fps"] = timed(profile, potential)
    edges = linspace_edges_f32(BOX, PROFILE_BINS)
    denom = PROFILE_BINS / volume / N_FRAMES
    for g, group in enumerate(groups):
        z = numpy_wrap(traj[:, group.ix, 2], BOX)
        oracle = np.histogram(z, bins=edges)[0]
        dens = profile.results.number_densities[0][g]
        check(np.array_equal(np.round(dens / denom), oracle)
              and np.array_equal(dens, oracle * denom),
              f"config-4 profile of group {g}: counts differ from numpy's "
              "float32 histogram")
        mean = dens.mean()
        check(abs(mean / (group.n_atoms / volume) - 1) < 1e-12,
              f"config-4 profile of group {g} averages to {mean}, not N/V")
    psi = profile.results.potentials[0]
    check(psi.shape == (PROFILE_BINS,) and np.all(np.isfinite(psi)),
          "config-4 potential not finite")
    rho_q = profile.results.charge_densities[0]
    print(f"config-4 path (DensityProfile z, {PROFILE_BINS} bins, of "
          f"{N_ATOMS // 2} cations and {N_ATOMS // 2} anions, then the "
          f"Poisson potential): {out['fps']:.3f} frames/s on {card} from the "
          f"end of the first chunk through the potential; counts == numpy "
          f"float32 histograms; |rho_q| <= {np.abs(rho_q).max():.3e} e/A^3, "
          f"potential in [{psi.min():.4f}, {psi.max():.4f}] V")

    steps.append(("config-4 profiled", time.perf_counter()))
    _, out["busy"], activities = run_profiled(
        [profile_analysis(groups, device)], N_FRAMES, CHUNK, run_alone,
        remake=lambda: [profile_analysis(groups, device)])
    print(f"config-4 path: device busy {100 * out['busy']:.1f} % of the last "
          f"{CHUNK} frames' wall time (profiler on; {activities:.0f} device "
          f"activities a frame; profiled run {run_profiled.runs})")

    steps.append(("columns in turns", time.perf_counter()))
    # 8 + 128 frames (the trajectory's frames over again) a run: the runs
    # of 8 + 32 frames take a few ms, within the host's jitter.
    frames = np.arange(CHUNK + PROFILE_TURN_FRAMES) % N_FRAMES
    fps = {True: [], False: []}
    for columns in (True, False):
        timed(profile_analysis(groups, device, columns), frames=frames)
    for turn in range(PROFILE_TURNS):
        for columns in ((True, False) if turn % 2 == 0 else (False, True)):
            fps[columns].append(timed(
                profile_analysis(groups, device, columns), frames=frames))
    out["fps_columns"] = {k: float(np.mean(v)) for k, v in fps.items()}
    print(f"config-4 path over 8 + {PROFILE_TURN_FRAMES} frames, "
          f"{PROFILE_TURNS} turns (order alternating) after a warm-up of "
          f"each: z column only {out['fps_columns'][True]:.3f} frames/s "
          f"({CHUNK * N_ATOMS * 4} H2D bytes a chunk), all three columns "
          f"{out['fps_columns'][False]:.3f} frames/s "
          f"({CHUNK * N_ATOMS * 12} H2D bytes a chunk); z only / all each "
          "turn " + ", ".join(f"{a:.1f}/{b:.1f}" for a, b in zip(
              fps[True], fps[False])))

    steps.append(("permittivity path", time.perf_counter()))
    frames, topology = water_system(rng, WATER_MOL, BOX, N_FRAMES,
                                    step=WATER_STEP, charges=True)
    waters = Universe.from_arrays(
        frames, np.array([BOX] * 3 + [90.0] * 3), dt=1.0, **topology)
    dipole = DipoleMoment(waters.atoms, unwrap=True, verbose=False,
                          device=device)
    dipole._chunk_bytes = CHUNK * N_ATOMS * 3 * 4

    def permittivity(a):
        a.calculate_relative_permittivity(300)
        out["spectrum"] = calculate_dielectric_spectrum(
            a.results.dipoles[:, 0], 300, a.results.volumes.mean(), 1.0,
            device=device)

    out["dipole_fps"] = timed(dipole, permittivity)
    waters.trajectory[0]
    prev = unwrap_edge(group=waters.atoms).astype(np.float32)
    box32 = np.float32(BOX)
    images = np.zeros(prev.shape, np.int32)
    q = np.asarray(topology["charges"], np.float64)
    oracle = np.empty((N_FRAMES, 3))
    for t in range(N_FRAMES):
        delta = frames[t] - prev
        images -= np.where(np.abs(delta) >= box32 / np.float32(2),
                           np.sign(delta), 0).astype(np.int32)
        prev = frames[t]
        unwrapped = frames[t] + images.astype(np.float32) * box32
        oracle[t] = (q[:, None] * unwrapped.astype(np.float64)).sum(0)
    err = np.abs(dipole.results.dipoles[:, 0] - oracle).max()
    scale = (np.abs(q) * 2 * BOX).sum()
    check(err <= 1e-12 * scale,
          f"dipoles differ from the float64 numpy sum by {err}")
    eps = dipole.results.dielectric
    spectrum = out["spectrum"]
    check(np.isfinite(eps) and eps > 1.0
          and np.all(np.isfinite(spectrum.epsilon)),
          f"permittivity {eps} or its spectrum not finite")
    print(f"permittivity path (DipoleMoment unwrap=True of {WATER_MOL} SPC/E "
          f"waters, then the permittivity and the dielectric spectrum): "
          f"{out['dipole_fps']:.3f} frames/s on {card} from the end of the "
          f"first chunk through both; dipoles within {err:.2e} e A of the "
          f"float64 numpy sum; eps_r {eps:.4f} (uncorrelated walkers: "
          f"information only), delta_eps {spectrum.delta_epsilon:.4f}")

    steps.append(("radial and maps", time.perf_counter()))
    chunk = traj[:CHUNK]
    box = np.float32(BOX).astype(np.float64)
    middle = np.full(3, BOX / 2)
    small = u.atoms[:RADIAL_CENTER_ATOMS]
    radial_cases = (
        ("spherical about the box center", middle, {}, None),
        ("cylindrical about z", middle, dict(geometry="cylindrical"), 2),
        (f"spherical about the center of mass of {RADIAL_CENTER_ATOMS} "
         "ions", small, {}, None),
    )
    for what, center, kwargs, drop in radial_cases:
        a = RadialDensityProfile(groups, center, verbose=False,
                                 device=device, **kwargs)
        a.run(stop=CHUNK)
        if hasattr(center, "universe"):
            centers = f32_group_com(chunk[:, center.ix], center.masses)
        else:
            centers = np.broadcast_to(center.astype(np.float32), (CHUNK, 3))
        for g, group in enumerate(groups):
            oracle = f64_radial_counts(chunk[:, group.ix], centers, box,
                                       a.results.edges, drop)
            check(np.array_equal(a.results.counts[g], oracle)
                  and oracle.sum() > 0,
                  f"RadialDensityProfile {what}, group {g}: counts differ "
                  "from the float64 oracle")
        print(f"RadialDensityProfile {what}, one chunk of {CHUNK} frames: "
              f"{int(a.results.counts.sum())} counts == float64 oracle")

    with warnings.catch_warnings():
        # Atoms of both charges: no charge map, which the maps say.
        warnings.simplefilter("ignore")
        plane = DensityMap2D(u.atoms, n_bins=MAP2D_BINS, verbose=False,
                             device=device)
        voxels = DensityMap3D(u.atoms, n_bins=MAP3D_BINS, verbose=False,
                              device=device)
    plane.run(stop=CHUNK)
    e = np.linspace(0.0, BOX, MAP2D_BINS + 1).astype(np.float32)
    xy = numpy_wrap(chunk[..., :2], BOX).reshape(-1, 2)
    oracle = np.histogram2d(xy[:, 0], xy[:, 1], bins=[e, e])[0]
    check(np.array_equal(plane.results.counts[0], oracle),
          "DensityMap2D differs from numpy's histogram2d")
    voxels.run(stop=CHUNK)
    e = np.linspace(0.0, BOX, MAP3D_BINS + 1).astype(np.float32)
    xyz = numpy_wrap(chunk, BOX).reshape(-1, 3)
    oracle = np.histogramdd(xyz, bins=[e, e, e])[0]
    check(np.array_equal(voxels.results.counts[0], oracle),
          "DensityMap3D differs from numpy's histogramdd")
    print(f"DensityMap2D ({MAP2D_BINS}^2) and DensityMap3D ({MAP3D_BINS}^3), "
          f"one chunk of {CHUNK} frames of {N_ATOMS} atoms: counts == numpy "
          "histogram2d / histogramdd")

    check(kernel_launch_counts() == launches_before,
          "a kernel of the kernels line launched in the profile phase")
    steps.append(("", time.perf_counter()))
    out["seconds"] = time.perf_counter() - started
    print("profiles phase steps: " + ", ".join(
        f"{name} {t1 - t0:.1f} s"
        for (name, t0), (_, t1) in zip(steps, steps[1:])))
    return out


# Slice 15: bench.py's config 5, 2,000 chains of 50 monomers (N_ATOMS atoms)
# in the fused path's cube over 8 + 48 frames, with the classes' counts
# given as bench.py gives them; the single-chain S(q) on the 24^3 grid, and
# the chains of its float64 oracle.
POLYMER_MONOMERS = 50
POLYMER_CHAINS = N_ATOMS // POLYMER_MONOMERS
POLYMER_FRAMES = 8 + 48
POLYMER_MODES = 8
#: the triclinic cell of the minimum-image classes' second run.
POLYMER_TRICLINIC = [BOX] * 3 + [80.0, 75.0, 70.0]
SCSF_ORACLE_CHAINS = 100
#: frames at which the trio's results are held to float64 oracles.
POLYMER_CHECK_FRAMES = (0, 27, POLYMER_FRAMES - 1)
EPS32 = float(np.finfo(np.float32).eps)


def polymer_universe(rng, n_frames):
    """Config 5's chains (testing.polymer_chains: bonds of about 1 A,
    stiffness 0.5, conformations relaxing as 0.95^t, heads drifting N(0,
    0.5) A a frame and axis from uniform starts) in the BOX cube, wrapped
    atom by atom: ``(float32 frames, float64 unwrapped, Universe)``, 1 ps a
    frame, no topology (the classes take the counts)."""

    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.testing import polymer_chains

    frames, unwrapped = polymer_chains(rng, POLYMER_CHAINS, POLYMER_MONOMERS,
                                       n_frames, BOX, stiffness=0.5,
                                       memory=0.95, drift=0.5)
    return frames, unwrapped, Universe.from_arrays(
        frames, [BOX] * 3 + [90.0] * 3, dt=1.0)


def polymer_triclinic_universe(unwrapped):
    """The unwrapped chains wrapped atom by atom into the triclinic cell
    POLYMER_TRICLINIC (float32 frames; the minimum-image bonds are the
    chains' own, as in the cube)."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.core.universe import Universe

    h = triclinic_matrices(np.array([POLYMER_TRICLINIC], np.float64))[0]
    frac = unwrapped @ np.linalg.inv(h)
    frames = ((frac - np.floor(frac)) @ h).astype(np.float32)
    return Universe.from_arrays(frames, POLYMER_TRICLINIC, dt=1.0)


def polymer_analysis(cls, group, device, n_chains=None, **kwargs):
    """A polymer analysis of `group` (`n_chains` chains, default
    POLYMER_CHAINS, of POLYMER_MONOMERS; counts given) on `device` in
    CHUNK-frame chunks."""

    a = cls(group, n_chains=n_chains or POLYMER_CHAINS,
            n_monomers=POLYMER_MONOMERS,
            verbose=False, device=device, **kwargs)
    a._chunk_bytes = CHUNK * group.n_atoms * 3 * 4
    return a


def numpy_unwrap32(frames, seed, box):
    """The image-count unwrap of float32 `frames` ``(T, N, 3)`` in numpy
    with the port's float32 operations (a step of half a box or more is a
    crossing), from the previous positions `seed` and zero counts."""

    box = np.float32(box)
    half = box / np.float32(2)
    images = np.zeros(frames.shape[1:], np.int32)
    prev = seed.astype(np.float32)
    out = np.empty_like(frames)
    for t, pos in enumerate(frames):
        delta = pos - prev
        images -= np.where(np.abs(delta) >= half,
                           np.sign(delta).astype(np.int32), 0)
        out[t] = pos + images.astype(np.float32) * box
        prev = pos
    return out


def scsf_oracle(frames, qs32, n_chains, device):
    """float64 single-chain S(q) (before the wavenumber average) of
    float32 `frames` ``(T, n_chains * POLYMER_MONOMERS, 3)`` on the float32
    wavevectors `qs32`, on the card, 25 chains at a time."""

    import torch

    q = torch.from_numpy(qs32.astype(np.float64)).to(device)
    raw = torch.zeros(len(q), dtype=torch.float64, device=device)
    for frame in frames:
        pos = torch.from_numpy(frame).to(device).double().reshape(
            n_chains, POLYMER_MONOMERS, 3)
        for c0 in range(0, n_chains, 25):
            phases = torch.einsum("qd,cnd->cqn", q, pos[c0:c0 + 25])
            raw += (torch.cos(phases).sum(-1) ** 2
                    + torch.sin(phases).sum(-1) ** 2).sum(0)
            del phases
    return (raw / (n_chains * POLYMER_MONOMERS * len(frames))).cpu().numpy()


def scsf_kernel_vs_plain(qs, block, workspace, pick):
    """The trig-sums kernel against its plain version on one launch's
    block of chain-frames as the single-chain S(q) path gave it (float32
    wavevectors, exact): two launches the same bits; the kernel within
    one float32 ulp of POLYMER_MONOMERS (the largest sum) of the plain
    version (the exact sums of 50 float32 terms, each rounded once from
    float64 sums taken in other orders); both within 1e-6 of the mean
    amplitude of a float64 oracle on the wavevectors `pick`.  Times in
    ms a frame of POLYMER_CHAINS chains (the kernel twice 3 launches, the
    plain version its checked call), beside trig_bound."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    kernel = lambda: ck.trig_sums(qs, block, precision="exact",  # noqa: E731
                                  workspace=workspace)
    plain = lambda: ck.trig_sums_reference(qs, block,  # noqa: E731
                                           precision="exact")
    k_out, again = kernel(), kernel()
    check(all(torch.equal(a, b) for a, b in zip(k_out, again)),
          "single-chain trig sums: two launches differ")
    p_out, first_plain_ms = timed_call(plain)
    tol_plain = float(np.spacing(np.float32(POLYMER_MONOMERS)))
    max_abs_err = max(float((k - p).abs().max()) for k, p in zip(k_out, p_out))
    unequal = sum(int((k != p).sum()) for k, p in zip(k_out, p_out))
    check(max_abs_err <= tol_plain,
          f"single-chain trig sums: kernel differs from plain by "
          f"{max_abs_err:.3e} > {tol_plain:.3e}")
    sub = qs[pick].double()
    pos = block.double()
    phases = torch.einsum("qd,cnd->cqn", sub, pos)
    oc, osn = torch.cos(phases).sum(-1), torch.sin(phases).sum(-1)
    del phases
    amp = float(torch.hypot(oc, osn).mean())
    tol = 1e-6 * amp
    errs = {name: max(float((out[0][:, pick].double() - oc).abs().max()),
                      float((out[1][:, pick].double() - osn).abs().max()))
            for name, out in (("kernel", k_out), ("plain", p_out))}
    for name, err in errs.items():
        check(err <= tol, f"single-chain trig sums: {name} off the float64 "
              f"oracle by {err:.3e} > {tol:.3e}")
    n = block.shape[0]
    per_frame = POLYMER_CHAINS / n
    kernel_ms = [time_ms(kernel, 3) * per_frame for _ in range(2)]
    # The plain version takes seconds a block: its checked call is its time.
    plain_ms = [first_plain_ms * per_frame]
    bound = trig_bound(n, POLYMER_MONOMERS, len(qs), "exact", lo=False,
                       weights=False)
    out = {
        "mode": "exact", "max_abs_err": max_abs_err, "oracle_err": errs,
        "tolerance": tol,
        "ms": float(np.mean(kernel_ms)),
        "plain_ms": float(np.mean(plain_ms)),
        **bound,
        "bound_ms": bound["bound_ms"] * POLYMER_CHAINS,
        "first_design_bound_ms": (bound["first_design_bound_ms"]
                                  * POLYMER_CHAINS),
        "terms_per_frame": bound["terms_per_frame"] * POLYMER_CHAINS,
    }
    print(f"single-chain trig sums, {n} chain-frames of {POLYMER_MONOMERS} "
          f"monomers x {len(qs)} float32 wavevectors, exact: |kernel - "
          f"plain| {max_abs_err:.3e} (tolerance {tol_plain:.3e}; {unequal} "
          f"of {2 * n * len(qs)} sums not bit-equal), |kernel - float64| "
          f"{errs['kernel']:.3e}, |plain - float64| {errs['plain']:.3e} "
          f"(tolerance {tol:.3e}); two launches equal; per frame of "
          f"{POLYMER_CHAINS} chains kernel {out['ms']:.3f} ms (runs "
          f"{[round(x, 3) for x in kernel_ms]}), plain torch "
          f"{out['plain_ms']:.3f} ms (runs {[round(x, 3) for x in plain_ms]});"
          f" bound {out['bound_ms']:.3f} ms by {out['bound_by']} "
          f"({100 * out['bound_ms'] / out['ms']:.1f} % of the kernel's time)")
    return out


def phase_polymer(device, rng, card):
    """Slice 15 on the card: bench.py's config 5 at its width, 2,000 chains
    of 50 monomers (100,000 atoms) in the 50 A cube over 8 + 48 frames in
    chunks of 8.  The fused trio run_together([Gyradius, EndToEndVector,
    RouseModes(n_modes=8)]) with the classes' default unwrap (Rouse modes
    only) and the counts given: frames/s and, over the last chunk, the
    device's busy share; no kernel of the kernels line launches; the radii
    and the end-to-end vectors of three frames and the Rouse amplitudes of
    three frames against float64 numpy oracles, the end-to-end ACF against
    a direct float64 correlation.  SingleChainStructureFactor(n_points=24,
    unwrap=True) on the same chains: its trig-sums launches, all exact,
    counted from 0 just before and read just after (one a block of
    chain-frames), its ms a frame; the first launch's block held against
    the plain version and a float64 oracle and timed beside its bound; the
    class on 100 of the chains against a float64 oracle of the port's own
    float32 unwrap on the card.  PersistenceLength and
    MeanSquareInternalDistance (minimum-image bonds) timed and held to
    float64 oracles of the unwrapped chains, in the cube and with the
    chains wrapped into a triclinic cell.  The thermodynamics on seeded
    series with closed-form answers (FFTs on the card): a LAMMPS log parsed
    without pandas and its heat capacity, and the Green-Kubo and
    Einstein-Helfand integrals of an AR(1) flux."""

    import tempfile

    import torch
    from scipy.signal import lfilter

    from mdhelper_tpu_torch.analysis import polymer, thermodynamics
    from mdhelper_tpu_torch.analysis.structure import group_mean_last_axis
    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    started = time.perf_counter()
    steps = [("trajectory", time.perf_counter())]
    frames, unwrapped, u = polymer_universe(rng, POLYMER_FRAMES)
    out = {}
    launches_before = kernel_launch_counts()

    steps.append(("fused trio", time.perf_counter()))
    def make_trio():
        return [
            polymer_analysis(polymer.Gyradius, u.atoms, device),
            polymer_analysis(polymer.EndToEndVector, u.atoms, device),
            polymer_analysis(polymer.RouseModes, u.atoms, device,
                             n_modes=POLYMER_MODES),
        ]

    trio = make_trio()
    out["fps"], out["busy"], activities = run_profiled(
        trio, POLYMER_FRAMES, CHUNK, remake=make_trio)
    out["profiled_runs"] = run_profiled.runs
    check(kernel_launch_counts() == launches_before,
          "a kernel of the kernels line launched in the polymer trio")
    gyr, e2e, rouse = trio
    r_box = 4 * EPS32 * BOX
    shape = (POLYMER_CHAINS, POLYMER_MONOMERS, 3)
    errs = {"rg": 0.0, "rouse": 0.0}
    p = np.arange(1, POLYMER_MODES + 1)[:, None]
    mat = np.cos(p * np.pi * (np.arange(POLYMER_MONOMERS) + 0.5)
                 / POLYMER_MONOMERS) / POLYMER_MONOMERS
    r_max = float(np.abs(unwrapped).max()) + BOX
    for t in POLYMER_CHECK_FRAMES:
        chains = frames[t].astype(np.float64).reshape(shape)
        com = chains.mean(axis=1, keepdims=True)
        rg = np.sqrt(((chains - com) ** 2).sum(axis=(1, 2))
                     / POLYMER_MONOMERS).mean()
        errs["rg"] = max(errs["rg"], abs(gyr.results.gyradii[0, t] - rg))
        ends = frames[t].reshape(shape)[:, (0, -1)]
        check(np.array_equal(e2e._e2e[t], ends[:, 1] - ends[:, 0]),
              f"end-to-end vectors of frame {t} differ from numpy's float32")
        amps = np.einsum("pn,mnd->mpd", mat, unwrapped[t].reshape(shape))
        errs["rouse"] = max(errs["rouse"],
                            float(np.abs(rouse._amps[0][t] - amps).max()))
    check(errs["rg"] <= r_box, f"radii of gyration off the float64 oracle "
          f"by {errs['rg']:.3e} > {r_box:.3e}")
    check(errs["rouse"] <= 8 * EPS32 * r_max,
          f"Rouse amplitudes off the float64 oracle by {errs['rouse']:.3e} "
          f"> {8 * EPS32 * r_max:.3e}")
    unit = e2e._e2e / np.linalg.norm(e2e._e2e, axis=-1, keepdims=True)
    direct = np.array([(unit[m:] * unit[:POLYMER_FRAMES - m]).sum(-1).mean()
                       for m in range(POLYMER_FRAMES)])
    acf_err = float(np.abs(e2e.results.acf[0, 0] - direct).max())
    check(acf_err <= 1e-10, f"end-to-end ACF off a direct float64 "
          f"correlation by {acf_err:.3e}")
    check(np.all(np.isfinite(rouse.results.acf))
          and np.allclose(rouse.results.acf[..., 0], 1.0),
          "Rouse ACFs not finite or not 1 at lag 0")
    print(f"config-5 trio (Gyradius + EndToEndVector + RouseModes(n_modes="
          f"{POLYMER_MODES}), {POLYMER_CHAINS} chains x {POLYMER_MONOMERS} "
          f"monomers, {POLYMER_FRAMES} frames): {out['fps']:.3f} frames/s on "
          f"{card}; device busy {100 * out['busy']:.1f} % of the last "
          f"{CHUNK} frames ({activities:.0f} device activities a frame; "
          f"profiled run {out['profiled_runs']}); R_g off float64 by {errs['rg']:.3e} A, Rouse amplitudes by "
          f"{errs['rouse']:.3e} A, e2e vectors == numpy float32, ACF off a "
          f"direct float64 correlation by {acf_err:.3e}")

    steps.append(("single-chain S(q)", time.perf_counter()))
    scsf = polymer_analysis(polymer.SingleChainStructureFactor, u.atoms,
                            device, n_points=N_QPTS, unwrap=True)
    recorded = []
    wrapped = polymer.trig_sums

    def recording(qs, positions, *args, **kwargs):
        if not recorded:
            recorded.append((qs, positions.clone(), kwargs["workspace"]))
        return wrapped(qs, positions, *args, **kwargs)

    polymer.trig_sums = recording
    ck.trig_sums.launches = 0
    ck.trig_sums.launches_by_precision.update(exact=0, fast=0)
    try:
        scsf_fps, _, _ = run_profiled([scsf], POLYMER_FRAMES)
    finally:
        polymer.trig_sums = wrapped
    launches = dict(ck.trig_sums.launches_by_precision)
    qs, block, workspace = recorded[0]
    n_block = block.shape[0]
    per_chunk = -(-CHUNK * POLYMER_CHAINS // n_block)
    expected = per_chunk * (POLYMER_FRAMES // CHUNK)
    check(launches == {"exact": expected, "fast": 0}
          and ck.trig_sums.launches == expected,
          f"single-chain S(q): trig-sums launches {launches}, expected "
          f"{expected} exact ({per_chunk} a chunk of {CHUNK} frames)")
    check(qs.dtype == torch.float32 and workspace is not None,
          "single-chain S(q) launched without float32 wavevectors or its "
          "workspace")
    out["scsf_launches"] = expected
    out["scsf_ms"] = 1e3 / scsf_fps
    check(np.all(np.isfinite(scsf.results.scsf))
          and abs(scsf.results.scsf[0] - POLYMER_MONOMERS) < 1e-3,
          f"single-chain S(q) not finite or S(0) = {scsf.results.scsf[0]} "
          f"!= {POLYMER_MONOMERS}")
    print(f"single-chain S(q) ({POLYMER_CHAINS} chains x {POLYMER_MONOMERS} "
          f"monomers, {len(qs)} float32 wavevectors, unwrap): "
          f"{scsf_fps:.3f} frames/s ({out['scsf_ms']:.3f} ms a frame) on "
          f"{card}; {expected} exact trig-sums launches of up to {n_block} "
          f"chain-frames on one workspace of "
          f"{scsf._workspace_bytes / 2**20:.0f} MiB; S(0) = N_p")
    pick = torch.from_numpy(np.sort(np.random.default_rng(SEED).choice(
        len(qs), ORACLE_QS, replace=False))).to(device)
    out["trig"] = scsf_kernel_vs_plain(qs, block, workspace, pick)
    del block, recorded

    steps.append(("S(q) oracle", time.perf_counter()))
    n_sub = SCSF_ORACLE_CHAINS * POLYMER_MONOMERS
    sub = polymer_analysis(polymer.SingleChainStructureFactor,
                           u.atoms[:n_sub], device,
                           n_chains=SCSF_ORACLE_CHAINS, n_points=N_QPTS,
                           unwrap=True)
    sub.run()
    u.trajectory[0]
    seed = sub._initial_unwrapped_monomers(0).reshape(-1, 3)
    positions = numpy_unwrap32(np.ascontiguousarray(frames[:, :n_sub]),
                               seed, BOX)
    raw = scsf_oracle(positions, sub._wavevectors.astype(np.float32),
                      SCSF_ORACLE_CHAINS, device)
    ref = group_mean_last_axis(raw, sub._q_group, len(sub.results.wavenumbers))
    scale = float(np.abs(ref).max())
    sq_err = float(np.abs(sub.results.scsf - ref).max())
    check(sq_err <= 1e-6 * scale, f"single-chain S(q) of "
          f"{SCSF_ORACLE_CHAINS} chains off the float64 oracle by "
          f"{sq_err:.3e} > {1e-6 * scale:.3e}")
    print(f"single-chain S(q) of {SCSF_ORACLE_CHAINS} chains, all frames: "
          f"off a float64 oracle of the same float32 unwrap by {sq_err:.3e} "
          f"(tolerance {1e-6 * scale:.3e})")

    steps.append(("persistence, internal distances", time.perf_counter()))
    x = torch.from_numpy(unwrapped).to(device).reshape(
        POLYMER_FRAMES, *shape)
    bonds = x[:, :, 1:] - x[:, :, :-1]
    lengths = bonds.norm(dim=-1)
    ub = bonds / lengths[..., None]
    n_b = POLYMER_MONOMERS - 1
    bond_acf = np.array([float((ub[:, :, s:] * ub[:, :, :n_b - s]).sum(-1)
                               .mean()) for s in range(n_b)])
    msid = np.array([float(((x[:, :, s:] - x[:, :, :-s]) ** 2).sum(-1)
                           .mean()) for s in range(1, POLYMER_MONOMERS)])
    mean_bond = float(lengths.mean())
    del x, bonds, lengths, ub
    errors = {}
    for box, universe in (("", u), ("_tri", polymer_triclinic_universe(
            unwrapped))):
        for cls, key in ((polymer.PersistenceLength, "pl_fps"),
                         (polymer.MeanSquareInternalDistance, "msid_fps")):
            a = polymer_analysis(cls, universe.atoms, device)
            out[key + box], _, _ = run_profiled([a], POLYMER_FRAMES)
            if key == "pl_fps":
                err = float(np.abs(a.results.bond_acf[0] - bond_acf).max())
                check(err <= 1e-5 and abs(a.results.bond_lengths[0]
                                          / mean_bond - 1) <= 1e-6,
                      f"persistence{box}: bond ACF off float64 by "
                      f"{err:.3e}, mean bond {a.results.bond_lengths[0]} "
                      f"vs {mean_bond}")
                a.calculate_persistence_length()
                lp = float(a.results.persistence_lengths[0])
            else:
                err = float(np.abs(a.results.msid[0] / msid - 1).max())
                check(err <= 1e-5, f"internal distances{box} off float64 "
                      f"by {err:.3e} (relative)")
            errors[key + box] = err
        del universe
    check(kernel_launch_counts() == {**launches_before, "trig_sums":
                                     kernel_launch_counts()["trig_sums"]},
          "a cell or pair kernel launched in the polymer phase")
    for box, name in (("", "orthorhombic"), ("_tri", "triclinic")):
        print(f"PersistenceLength: {out['pl_fps' + box]:.3f} frames/s, "
              f"MeanSquareInternalDistance: {out['msid_fps' + box]:.3f} "
              f"frames/s on {card} (minimum-image bonds, {name} box); bond "
              f"ACF off float64 by {errors['pl_fps' + box]:.3e}, l_p "
              f"{lp:.3f} A; MSID off float64 by "
              f"{errors['msid_fps' + box]:.3e} (relative)")

    steps.append(("thermodynamics", time.perf_counter()))
    # An AR(1) flux of unit variance and correlation a^k: its trapezoid
    # Green-Kubo integral is dt (1 + a) / (2 (1 - a)); a million samples
    # hold the estimates within about 2 % (5 % checked).
    trng = np.random.default_rng(SEED + 13)
    a, dt, n = 0.8, 0.002, 1_000_000
    flux = lfilter([np.sqrt(1 - a * a)], [1, -a], trng.normal(size=(n, 3)),
                   axis=0)
    integral = dt * (1 + a) / (2 * (1 - a))
    gk = thermodynamics.calculate_shear_viscosity(
        flux, 1.0, 1.0, dt, reduced=True, device=device)
    eh = thermodynamics.calculate_shear_viscosity(
        flux, 1.0, 1.0, dt, reduced=True, method="einstein",
        fit_interval=(0.0001, 0.0004), device=device)
    kappa = thermodynamics.calculate_thermal_conductivity(
        flux, 2.0, 1.5, dt, reduced=True, device=device)
    sigma = thermodynamics.calculate_ionic_conductivity(
        flux, 2.0, 1.5, dt, reduced=True, device=device)
    window = 60
    coefficients = {
        "Green-Kubo viscosity": (gk.running_viscosity[window], integral),
        "Einstein-Helfand viscosity": (eh.viscosity, integral),
        "thermal conductivity": (kappa.running_conductivity[window],
                                 2.0 / 1.5**2 * integral),
        "ionic conductivity": (sigma.running_conductivity[window],
                               integral / (2.0 * 1.5)),
    }
    for what, (value, expected_value) in coefficients.items():
        check(abs(value / expected_value - 1) < 0.05,
              f"{what} {value} against the AR(1) closed form "
              f"{expected_value}")
    energies = trng.normal(-1500.0, 4.0, 400)
    temps = trng.normal(300.0, 3.0, 400)
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "log.lammps")
        with open(log, "w") as f:
            f.write("LAMMPS\nrun 400\n   Step   Temp   TotEng   Press\n")
            for i, (t, e) in enumerate(zip(temps, energies)):
                f.write(f"{i:8d} {t:12.8g} {e:14.10g} {1.0:8.3f}\n")
            f.write("Loop time of 1.0 on 1 procs for 400 steps\n")
        cv = thermodynamics.ConstantVolumeHeatCapacity(log).run()
    written = np.array([float(f"{e:14.10g}") for e in energies])
    mean_t = np.array([float(f"{t:12.8g}") for t in temps]).mean()
    na, kb, kcal = 6.02214076e23, 1.380649e-23, 4184.0
    expected_cv = written.var() * kcal**2 / (na**2 * kb * mean_t**2) / kcal
    check(np.array_equal(cv.results.energies, written)
          and abs(cv.temperature / mean_t - 1) < 1e-12
          and abs(cv.results.heat_capacity / expected_cv - 1) < 1e-9,
          f"heat capacity {cv.results.heat_capacity} from the log against "
          f"{expected_cv}")
    print("thermodynamics (FFTs on the card): " + ", ".join(
        f"{what} {value:.6g} vs closed form {ref_value:.6g}"
        for what, (value, ref_value) in coefficients.items())
        + f"; a LAMMPS log parsed without pandas, C_V "
        f"{cv.results.heat_capacity:.6g} vs {expected_cv:.6g} kcal/K")

    steps.append(("", time.perf_counter()))
    out["seconds"] = time.perf_counter() - started
    print("polymer phase steps: " + ", ".join(
        f"{name} {t1 - t0:.1f} s"
        for (name, t0), (_, t1) in zip(steps, steps[1:])))
    return out

# Slice 16: the mesh S(q) route on the fused path, and bench.py's
# aggregates and order paths on 3,000 rigid 3-site waters (AGG_ATOMS) at
# 0.0334 molecules/A^3 (agg_box(): 44.78 A), in bench.py's 4-frame
# chunks.  MESH_FRAMES: 8 + 16 timed frames, the profiler's warm-up chunk
# and its profiled chunk.
MESH_FRAMES = 8 + 32
AGG_ATOMS, AGG_CHUNK = 9_000, 4
AGG_FRAMES, ORDER_FRAMES = AGG_CHUNK + 32, AGG_CHUNK + 16
# The JAX package's mesh-vs-direct S(q) gate (tests/test_mesh_scattering.py)
# and its float64-oracle bounds on the mesh sums, over sqrt(N).
MESH_RTOL, MESH_ATOL = 5e-4, 1e-5
MESH_MEDIAN_BOUND, MESH_MAX_BOUND = 1e-5, 1e-4
# Card against CPU on the aggregates' and order paths' first chunk: the
# float32 order tensors (sums of 3,000 outer products of unit vectors,
# divided by their count) within MESH_Q_ATOL, q_l, q_l-bar, Q_l and q_tet
# within ORDER_ATOL (sums of float32 harmonics over about 20 neighbours in
# another order, and CUDA's rsqrtf), w_l and w_l-bar within WL_ATOL (the
# cubic invariant over |q_lm|^3 amplifies that where q_l is small).
AGG_Q_ATOL, ORDER_ATOL, WL_ATOL = 1e-5, 1e-5, 1e-4


def agg_box():
    """bench.py's water-density box: 0.0334 molecules/A^3."""

    return float((AGG_ATOMS / 3 / 0.0334) ** (1 / 3))


def agg_universe(rng, n_frames, waters=True):
    """bench.py's make_water_frame geometry at AGG_ATOMS: O at uniform
    centers, two H at 0.96 A in random directions, wrapped into agg_box(),
    float32, 1 ps a frame; with `waters` the names O/H1/H2, one residue a
    molecule and the O-H bonds (bench.py's aggregates universe), else one
    atom type (its order universe)."""

    from mdhelper_tpu_torch.core.universe import Universe

    n_mol = AGG_ATOMS // 3
    box = agg_box()
    centers = rng.random((n_frames, n_mol, 3)) * box
    d1 = rng.standard_normal((n_frames, n_mol, 3))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = rng.standard_normal((n_frames, n_mol, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    traj = np.empty((n_frames, AGG_ATOMS, 3))
    traj[:, 0::3] = centers
    traj[:, 1::3] = centers + 0.96 * d1
    traj[:, 2::3] = centers + 0.96 * d2
    traj = (traj % box).astype(np.float32)
    dims = np.array([box] * 3 + [90.0] * 3)
    if not waters:
        return traj, Universe.from_arrays(
            traj, dims, dt=1.0, types=np.array(["A"] * AGG_ATOMS, object))
    mol = np.arange(n_mol)
    bonds = np.empty((2 * n_mol, 2), dtype=np.int64)
    bonds[0::2] = np.stack([3 * mol, 3 * mol + 1], axis=1)
    bonds[1::2] = np.stack([3 * mol, 3 * mol + 2], axis=1)
    return traj, Universe.from_arrays(
        traj, dims, dt=1.0, names=np.array(["O", "H1", "H2"] * n_mol, object),
        resindices=np.repeat(mol, 3), bonds=bonds)


def agg_chunked(analyses):
    """`analyses` with bench.py's AGG_CHUNK-frame chunks."""

    for a in analyses:
        a._chunk_bytes = AGG_CHUNK * AGG_ATOMS * 3 * 4
    return analyses


def first_chunk_pair(make, device):
    """``make(device)`` and ``make("cpu")`` run through run_together over
    the first AGG_CHUNK frames (the card's run and the port's CPU run)."""

    from mdhelper_tpu_torch.analysis.multi import run_together

    return [run_together(agg_chunked(make(where)), stop=AGG_CHUNK)
            for where in (device, "cpu")]


def phase_mesh(device, rng, card):
    """Slice 16's mesh route on the card: the fused path run_together([RDF,
    StructureFactor(method="mesh"), Onsager(unwrap=True)]) at its width
    (100k atoms, 50 A cube, 24^3 grid, 13,823 wavevectors, mesh 128, width
    10) over MESH_FRAMES, beside the same path with method="factor" on the
    same trajectory: both runs' frames/s and busy share, the cell kernel's
    launches counted from 0 (one a chunk) and no trig-sums launch; the mesh
    S(q) within the JAX package's mesh gate (rtol 5e-4, atol 1e-5) of the
    factor S(q); the gridding's ms a frame (CUDA events over a chunk of
    frames) beside the dense in-order chain's; one frame's mesh sums against
    the in-order sums and both against a float64 oracle of 512 wavevectors
    (the JAX test's bounds over sqrt(N))."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.ops import cuda_kernels as ck
    from mdhelper_tpu_torch.ops import mesh_scattering as ms

    started = time.perf_counter()
    traj, u = slice_universe(rng, MESH_FRAMES)
    n_chunks = -(-MESH_FRAMES // CHUNK)
    out = {}
    replans, sigmas = [], {}
    for method in ("mesh", "factor"):
        def make(s, method=method):
            analyses = slice_analyses(u, device, sq_method=method)
            analyses[0]._capacity_sigmas = s
            return analyses

        def run(analyses, make=make):
            cch.cell_pair_histogram.launches = 0
            ck.trig_sums.launches = 0
            s = analyses[0]._capacity_sigmas
            return run_profiled(analyses, MESH_FRAMES, CHUNK,
                                remake=lambda: make(s))

        # The RDF's 4-sigma cell plan can overflow on these frames, as
        # in phase_files (ROADMAP Queue 3, item 1): re-planned as run()
        # re-plans.
        analyses, (fps, busy, _) = replanned(
            make, run, f"{method} path", replans, sigmas, "mesh")
        runs = run_profiled.runs
        check(cch.cell_pair_histogram.launches == n_chunks * runs,
              f"{method} path: {cch.cell_pair_histogram.launches} cell "
              f"kernel launches for {n_chunks} chunks in {runs} runs")
        check(ck.trig_sums.launches == 0,
              f"{method} path launched the trig-sums kernel")
        ssf = analyses[1].results.ssf
        n_q = len(analyses[1].results.wavenumbers)
        check(ssf.shape == (1, n_q) and np.all(np.isfinite(ssf)),
              f"{method} S(q) shape or values")
        out[method] = {"fps": fps, "busy": busy, "ssf": ssf, "runs": runs}
    out["routes_s"] = time.perf_counter() - started
    mesh, factor = out["mesh"]["ssf"], out["factor"]["ssf"]
    out["dev"] = float(np.abs(mesh - factor).max())
    beyond = np.abs(mesh - factor) - MESH_RTOL * np.abs(factor)
    check(np.allclose(mesh, factor, rtol=MESH_RTOL, atol=MESH_ATOL),
          f"mesh S(q) off the factor S(q) by {beyond.max():.3e} beyond rtol "
          f"{MESH_RTOL} (atol {MESH_ATOL})")

    plan = ms.mesh_plan(N_QPTS, [BOX] * 3)
    options = dict(n_points=N_QPTS, mesh=plan["mesh"], width=plan["width"],
                   beta=plan["beta"], box=plan["box"], deconv=plan["deconv"])
    pos = torch.from_numpy(traj[:CHUNK]).to(device)
    out["grid_ms"] = time_ms(lambda: ms.mesh_trig_sums(pos, **options),
                             3) / CHUNK
    out["dense_ms"] = time_ms(
        lambda: ms.mesh_trig_sums_plain(pos[:1], **options), 2)
    c, s = (x.double().cpu().numpy().reshape(-1)
            for x in ms.mesh_trig_sums(pos[0], **options))
    cp, sp = (x.double().cpu().numpy().reshape(-1)
              for x in ms.mesh_trig_sums_plain(pos[0], **options))
    root_n = np.sqrt(N_ATOMS)
    out["vs_plain"] = float(np.hypot(c - cp, s - sp).max())
    check(out["vs_plain"] <= MESH_MAX_BOUND * root_n,
          f"mesh sums off the in-order sums by {out['vs_plain']:.3e}")
    k = np.arange(N_QPTS)
    grid = np.stack(np.meshgrid(k, k, k, indexing="ij"), -1).reshape(-1, 3)
    pick = np.concatenate(([0], np.random.default_rng(SEED).choice(
        np.arange(1, len(grid)), ORACLE_QS - 1, replace=False)))
    phase = (2 * np.pi * grid[pick] / BOX) @ traj[0].astype(np.float64).T
    oc, os_ = np.cos(phase).sum(1), np.sin(phase).sum(1)
    for what, (cc, ss) in (("scatter", (c, s)), ("in-order", (cp, sp))):
        err = np.hypot(cc[pick] - oc, ss[pick] - os_)[1:] / root_n
        check(np.median(err) < MESH_MEDIAN_BOUND and err.max()
              < MESH_MAX_BOUND, f"{what} mesh sums off the float64 oracle: "
              f"median {np.median(err):.3e}, max {err.max():.3e} (/sqrt N)")
        check(cc[0] == N_ATOMS and ss[0] == 0.0, f"{what} rho(0)")
        out[f"oracle_{what}"] = float(err.max())
    out["seconds"] = time.perf_counter() - started
    print(f"mesh path: mesh {out['mesh']['fps']:.3f} frames/s, busy "
          f"{100 * out['mesh']['busy']:.1f} % (profiled run "
          f"{out['mesh']['runs']}); factor {out['factor']['fps']:.3f} "
          f"frames/s, busy {100 * out['factor']['busy']:.1f} % (profiled run "
          f"{out['factor']['runs']}); mesh vs factor S(q) max deviation "
          f"{out['dev']:.3e} (gate rtol {MESH_RTOL}, atol {MESH_ATOL}); "
          f"gridding {out['grid_ms']:.3f} ms a frame (scatter, {CHUNK} frames "
          f"a call), dense chain {out['dense_ms']:.3f} ms; scatter vs "
          f"in-order sums {out['vs_plain']:.3e}, oracle max/sqrt(N) "
          f"{out['oracle_scatter']:.3e} / {out['oracle_in-order']:.3e}; "
          f"{'; '.join(replans) or 'no cell re-plan'}; "
          f"{out['seconds']:.1f} s ({out['routes_s']:.1f} s of them the "
          f"trajectory and both routes' runs) on {card}")
    return out


def phase_aggregates(device, rng, card):
    """bench.py's aggregates path on the card: run_together([
    ClusterSizeDistribution(u.atoms, 3.5, "residues"),
    HydrogenBondAnalysis(u, hydrogens_sel="name H*", acceptors_sel="name
    O*"), NematicOrderParameter(H1, H2)]) on AGG_ATOMS water atoms over
    AGG_FRAMES frames in AGG_CHUNK-frame chunks: frames/s and the busy share
    of the last chunk; no kernel of the kernels line launches.  The first
    chunk on the card against the port's CPU run: cluster counts, largest
    clusters, the size histogram, H-bond counts and occupancies equal, the
    order tensors within AGG_Q_ATOL; the full run's first chunk as the
    first-chunk run's."""

    from mdhelper_tpu_torch.analysis.cluster import ClusterSizeDistribution
    from mdhelper_tpu_torch.analysis.hbonds import HydrogenBondAnalysis
    from mdhelper_tpu_torch.analysis.orientation import NematicOrderParameter

    started = time.perf_counter()
    traj, u = agg_universe(rng, AGG_FRAMES)

    def make(where):
        return [
            ClusterSizeDistribution(u.atoms, 3.5, "residues", verbose=False,
                                    device=where),
            HydrogenBondAnalysis(u, hydrogens_sel="name H*",
                                 acceptors_sel="name O*", verbose=False,
                                 device=where),
            NematicOrderParameter(u.select_atoms("name H1"),
                                  u.select_atoms("name H2"), verbose=False,
                                  device=where),
        ]

    launches_before = kernel_launch_counts()
    trio = agg_chunked(make(device))
    out = {}
    out["fps"], out["busy"], out["activities"] = run_profiled(
        trio, AGG_FRAMES, AGG_CHUNK, chunk=AGG_CHUNK,
        remake=lambda: agg_chunked(make(device)))
    out["profiled_runs"] = run_profiled.runs
    check(kernel_launch_counts() == launches_before,
          "a kernel of the kernels line launched on the aggregates path")
    cl, hb, nem = trio
    check(cl.results.size_counts.sum() == cl.results.n_clusters.sum()
          and (cl.results.largest >= 1).all(), "cluster counts")
    check(np.all(np.isfinite(nem.results.Q))
          and np.abs(np.trace(nem.results.Q, axis1=1, axis2=2)).max() < 1e-5
          and (0 <= nem.results.P2).all() and (nem.results.P2 <= 1).all(),
          "order tensors: finite, traceless, 0 <= P2 <= 1")
    check(hb.results.counts.shape == (AGG_FRAMES,)
          and (hb.results.occupancies <= 1).all(), "H-bond counts")

    cpu_started = time.perf_counter()
    (c_cl, c_hb, c_nem), (h_cl, h_hb, h_nem) = first_chunk_pair(make, device)
    out["cpu_s"] = time.perf_counter() - cpu_started
    for what, a, b in (
            ("cluster counts", c_cl.results.n_clusters, h_cl.results.n_clusters),
            ("largest clusters", c_cl.results.largest, h_cl.results.largest),
            ("cluster size histogram", c_cl.results.size_counts,
             h_cl.results.size_counts),
            ("H-bond counts", c_hb.results.counts, h_hb.results.counts),
            ("H-bond occupancies", c_hb.results.occupancies,
             h_hb.results.occupancies),
            ("full run's first-chunk cluster counts",
             cl.results.n_clusters[:AGG_CHUNK], c_cl.results.n_clusters),
            ("full run's first-chunk H-bond counts",
             hb.results.counts[:AGG_CHUNK], c_hb.results.counts)):
        check(np.array_equal(a, b), f"aggregates, card vs CPU: {what} differ")
    out["q_err"] = float(np.abs(c_nem.results.Q - h_nem.results.Q).max())
    check(out["q_err"] <= AGG_Q_ATOL, f"order tensors, card vs CPU: "
          f"{out['q_err']:.3e} > {AGG_Q_ATOL}")
    out["seconds"] = time.perf_counter() - started
    print(f"aggregates path ({AGG_ATOMS} atoms, {AGG_ATOMS // 3} waters, box "
          f"{agg_box():.2f} A): {out['fps']:.3f} frames/s, busy "
          f"{100 * out['busy']:.1f} %, {out['activities']:.0f} device "
          f"activities a frame (profiled run {out['profiled_runs']}); "
          f"clusters a frame {cl.results.n_clusters.mean():.1f}, largest "
          f"{cl.results.largest.mean():.1f}; H-bonds a frame "
          f"{hb.results.mean_count:.1f}; P2 {nem.results.P2.mean():.4f}; "
          f"first chunk card == CPU (Q within {out['q_err']:.3e}; CPU run "
          f"{out['cpu_s']:.1f} s); {out['seconds']:.1f} s on {card}")
    return out


def phase_order(device, rng, card):
    """bench.py's order path on the card: SteinhardtOrderParameter(u.atoms,
    3.5, (4, 6), averaged=True, wl=True) and TetrahedralOrderParameter(
    u.atoms) through run_together on AGG_ATOMS atoms over ORDER_FRAMES
    frames in AGG_CHUNK-frame chunks: frames/s and the busy share of the
    last chunk; no kernel of the kernels line launches.  The first chunk on
    the card against the port's CPU run: neighbour counts equal, q_l, the
    averaged q_l, Q_l and q_tet within ORDER_ATOL, w_l within WL_ATOL."""

    from mdhelper_tpu_torch.analysis.steinhardt import (
        SteinhardtOrderParameter,
        TetrahedralOrderParameter,
    )

    started = time.perf_counter()
    traj, u = agg_universe(rng, ORDER_FRAMES, waters=False)
    store_s = [0.0]

    def make(where):
        return [
            SteinhardtOrderParameter(u.atoms, 3.5, (4, 6), averaged=True,
                                     wl=True, verbose=False, device=where),
            TetrahedralOrderParameter(u.atoms, verbose=False, device=where),
        ]

    def timed(analyses):
        """The Steinhardt store (the host's invariants) clocked into
        store_s."""

        st = analyses[0]
        store = st._store_chunk

        def clocked(extras, batch):
            t0 = time.perf_counter()
            store(extras, batch)
            store_s[0] += time.perf_counter() - t0

        st._store_chunk = clocked
        store_s[0] = 0.0
        return analyses

    launches_before = kernel_launch_counts()
    pair = timed(agg_chunked(make(device)))
    out = {}
    out["fps"], out["busy"], out["activities"] = run_profiled(
        pair, ORDER_FRAMES, AGG_CHUNK, chunk=AGG_CHUNK,
        remake=lambda: timed(agg_chunked(make(device))))
    out["profiled_runs"] = run_profiled.runs
    out["store_ms"] = 1e3 * store_s[0] / ORDER_FRAMES
    check(kernel_launch_counts() == launches_before,
          "a kernel of the kernels line launched on the order path")
    st, tet = pair
    for key in ("ql", "wl", "ql_avg", "wl_avg", "Ql"):
        check(np.all(np.isfinite(st.results[key])), f"Steinhardt {key}")
    check(np.all(np.isfinite(tet.results.q_tet))
          and (tet.results.q_tet <= 1 + 1e-6).all(), "q_tet")

    cpu_started = time.perf_counter()
    (c_st, c_tet), (h_st, h_tet) = first_chunk_pair(make, device)
    out["cpu_s"] = time.perf_counter() - cpu_started
    check(np.array_equal(c_st.results.n_neighbors, h_st.results.n_neighbors),
          "order, card vs CPU: neighbour counts differ")
    check(np.array_equal(st.results.n_neighbors[:AGG_CHUNK],
                         c_st.results.n_neighbors),
          "order: the full run's first-chunk neighbour counts differ")
    errs = {key: float(np.abs(c_st.results[key] - h_st.results[key]).max())
            for key in ("ql", "ql_avg", "Ql", "wl", "wl_avg")}
    errs["q_tet"] = float(np.abs(c_tet.results.q_tet
                                 - h_tet.results.q_tet).max())
    for key, err in errs.items():
        tol = WL_ATOL if key.startswith("wl") else ORDER_ATOL
        check(err <= tol, f"order, card vs CPU: {key} off by {err:.3e} > "
              f"{tol}")
    out["errs"] = errs
    out["seconds"] = time.perf_counter() - started
    print(f"order path ({AGG_ATOMS} atoms): {out['fps']:.3f} frames/s, busy "
          f"{100 * out['busy']:.1f} %, {out['activities']:.0f} device "
          f"activities a frame (profiled run {out['profiled_runs']}), the "
          f"host's invariants {out['store_ms']:.3f} ms a frame; "
          f"neighbours a particle {st.results.n_neighbors.mean():.2f}, "
          f"<q4> {st.results.ql_mean[:, 0].mean():.4f}, <q6> "
          f"{st.results.ql_mean[:, 1].mean():.4f}, <q_tet> "
          f"{tet.results.q_tet_mean.mean():.4f}; first chunk card == CPU "
          f"(neighbours equal; max deviations "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; CPU run {out['cpu_s']:.1f} s); {out['seconds']:.1f} s on "
          f"{card}")
    return out


VEL_FRAMES = 8 + 56
VEL_TEMPERATURE = 300.0
#: AR(1) coefficient of the thermal velocities a frame; the Couette rate.
VEL_RHO, SHEAR_RATE = 0.6, 0.1
#: Boltzmann's constant in u A^2 ps^-2 K^-1; the ions' masses (u).
K_B_AMU, ION_MASSES = 0.8314462618152, (22.98977, 35.453)
SHELL_IONS, SHELL_RADIUS, OVERLAP_A = 2_000, 3.5, 1.0
#: frames of the card's runs that the port's CPU run repeats (two chunks).
VEL_CHECK_FRAMES = 2 * CHUNK
#: the overlap ring's lags in the timed runs and in the card-vs-CPU runs:
#: fewer than the frames of each, so that the ring wraps around.
OVERLAP_LAGS, OVERLAP_CHECK_LAGS = 48, 12
FLOW_BINS = 100
#: the recovered shear rate and bin temperatures, relative to the imposed.
SHEAR_BOUND, TEMPERATURE_BOUND, VACF0_BOUND = 0.05, 0.03, 0.01


def velocity_universe(rng, n_frames):
    """phase_electrolyte's electrolyte (N_ATOMS ions of charges +1 and -1
    on a random walk of ELECTRO_STEP A a frame and axis in the BOX cube,
    wrapped as float32; Na and Cl masses) with velocities: a time-correlated
    Maxwell-Boltzmann process at VEL_TEMPERATURE (AR(1), coefficient
    VEL_RHO a frame) plus the Couette profile u_x = SHEAR_RATE (z - L/2)
    of each frame's wrapped z, float32, 0.5 ps a frame."""

    from mdhelper_tpu_torch.core.universe import Universe

    steps = rng.normal(0.0, ELECTRO_STEP, (n_frames, N_ATOMS, 3))
    steps[0] = rng.random((N_ATOMS, 3)) * BOX
    traj = np.mod(np.cumsum(steps, axis=0), BOX).astype(np.float32)
    del steps
    masses = np.tile(ION_MASSES, N_ATOMS // 2)
    sigma = np.sqrt(K_B_AMU * VEL_TEMPERATURE / masses)[:, None]
    thermal = sigma * rng.standard_normal((N_ATOMS, 3))
    vel = np.empty((n_frames, N_ATOMS, 3), np.float32)
    for t in range(n_frames):
        if t:
            thermal = (VEL_RHO * thermal + np.sqrt(1 - VEL_RHO**2) * sigma
                       * rng.standard_normal((N_ATOMS, 3)))
        vel[t] = thermal
        vel[t, :, 0] += SHEAR_RATE * (traj[t, :, 2] - BOX / 2)
    return traj, vel, Universe.from_arrays(
        traj, np.array([BOX] * 3 + [90.0] * 3), dt=0.5, velocities=vel,
        masses=masses, charges=np.tile([1.0, -1.0], N_ATOMS // 2))


def vacf_oracle(vel):
    """float64 entity-averaged velocity ACF of float32 `vel` (T, N, 3):
    numpy's zero-padded FFT, triangular normalization."""

    n_t = len(vel)
    spec = np.fft.rfft(vel.astype(np.float64), n=2 * n_t, axis=0)
    power = (spec.real**2 + spec.imag**2).sum(-1).mean(-1)
    return np.fft.irfft(power, n=2 * n_t)[:n_t] / np.arange(n_t, 0, -1)


def f32_flow_counts(traj, edges64):
    """int64 counts of float32 z coordinates wrapped as the port wraps them
    (numpy_wrap) against the float64 linspace edges rounded to float32,
    numpy.histogram's rules."""

    z = numpy_wrap(traj[..., 2], BOX).ravel()
    edges = edges64.astype(np.float32)
    n_bins = len(edges) - 1
    idx = np.searchsorted(edges, z, side="right") - 1
    idx[z == edges[-1]] = n_bins - 1
    ok = (z >= edges[0]) & (z <= edges[-1])
    return np.bincount(np.clip(idx, 0, n_bins - 1)[ok], minlength=n_bins)


def phase_velocities(device, rng, card):
    """Slice 17's velocity stream on the card, on the electrolyte with
    velocities (velocity_universe), in CHUNK-frame chunks, three fused
    passes through run_profiled (frames/s, busy share, device activities
    a frame): VelocityAutocorrelation and ElectricCurrentAutocorrelation
    (the velocity payload); SurvivalProbability in a slab and in the
    SHELL_RADIUS shell of SHELL_IONS anions around as many cations, and
    OverlapFunction with an OVERLAP_LAGS-lag ring (positions); FlowProfile
    (positions+velocities).  Checks: the VACF against a numpy float64 FFT
    oracle of the float32 velocities and VACF(0) against 3 kT <1/m> plus
    the Couette mean square; the conductivity against the port's CPU run;
    the shear rate and temperatures recovered, counts equal to numpy's on
    the same float32 edges; FlowProfile from a TRR written by the port's
    TRRWriter against the ArrayReader route over the reader's arrays
    (counts equal, velocities and temperatures within 1e-10 of their
    largest);
    the survival memberships and the overlap function (an
    OVERLAP_CHECK_LAGS-lag ring) over the first VEL_CHECK_FRAMES equal to
    the port's CPU run."""

    import tempfile

    from mdhelper_tpu_torch.analysis import dynamics, flow
    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.core.trajectory import TRRReader
    from mdhelper_tpu_torch.core.universe import Topology, Universe
    from mdhelper_tpu_torch.io.trr import write_trr

    started = time.perf_counter()
    traj, vel, u = velocity_universe(rng, VEL_FRAMES)
    out = {"data_s": time.perf_counter() - started}
    cations, anions = u.atoms[0::2], u.atoms[1::2]

    def chunked(analyses, width=3):
        for a in analyses:
            a._chunk_bytes = CHUNK * N_ATOMS * width * 4
        return analyses

    passes = {
        "velocities": lambda d: chunked([
            dynamics.VelocityAutocorrelation(u.atoms, verbose=False,
                                             device=d),
            dynamics.ElectricCurrentAutocorrelation(
                u.atoms, VEL_TEMPERATURE, verbose=False, device=d)]),
        "positions": lambda d: chunked([
            dynamics.SurvivalProbability(u.atoms, ("slab", "z", 10.0, 20.0),
                                         verbose=False, device=d),
            dynamics.SurvivalProbability(
                cations[:SHELL_IONS], ("shell", anions[:SHELL_IONS],
                                       SHELL_RADIUS), verbose=False, device=d),
            dynamics.OverlapFunction(u.atoms, OVERLAP_A, n_lags=OVERLAP_LAGS,
                                     verbose=False, device=d)]),
        # run_together streams all six payload columns
        "flow": lambda d: chunked([flow.FlowProfile(
            u.atoms, n_bins=FLOW_BINS, verbose=False, device=d)], width=6),
    }
    launches_before = kernel_launch_counts()
    runs = {}
    for name, make in passes.items():
        analyses = make(device)
        fps, busy, activities = run_profiled(
            analyses, VEL_FRAMES, CHUNK, remake=lambda make=make: make(device))
        runs[name] = analyses
        out[name] = {"fps": fps, "busy": busy, "activities": activities,
                     "runs": run_profiled.runs}
    check(kernel_launch_counts() == launches_before,
          "a kernel of the kernels line launched on the velocity paths")
    (vacf, current), (slab, shell, overlap), (prof,) = runs.values()

    oracle = vacf_oracle(vel)
    out["vacf_err"] = float(np.abs(vacf.results.vacf - oracle).max()
                            / oracle[0])
    check(out["vacf_err"] < 1e-10, f"VACF off the float64 FFT oracle by "
          f"{out['vacf_err']:.3e} of VACF(0)")
    masses = np.tile(ION_MASSES, N_ATOMS // 2)
    couette = SHEAR_RATE * (traj[..., 2].astype(np.float64) - BOX / 2)
    want = (3 * K_B_AMU * VEL_TEMPERATURE * np.mean(1 / masses)
            + np.mean(couette**2))
    out["vacf0"] = float(vacf.results.vacf[0] / want - 1)
    check(abs(out["vacf0"]) < VACF0_BOUND, f"VACF(0) off 3kT<1/m> + <u_x^2> "
          f"by {out['vacf0']:.3e}")
    check(np.all(np.isfinite(vacf.results.vdos)), "VDOS finite")

    cpu_started = time.perf_counter()
    (c_current,) = run_together(chunked([
        dynamics.ElectricCurrentAutocorrelation(
            u.atoms, VEL_TEMPERATURE, verbose=False, device="cpu")]))
    out["sigma_err"] = float(abs(current.results.conductivity
                                 / c_current.results.conductivity - 1))
    check(out["sigma_err"] < 1e-10, f"conductivity off the CPU run by "
          f"{out['sigma_err']:.3e}")

    out["shear"] = prof.calculate_shear_rate("x")
    check(abs(out["shear"] / SHEAR_RATE - 1) < SHEAR_BOUND,
          f"shear rate {out['shear']:.5f} against {SHEAR_RATE}")
    temperature = prof.results.temperature
    out["t_dev"] = float(np.abs(temperature / VEL_TEMPERATURE - 1).max())
    check(out["t_dev"] < TEMPERATURE_BOUND, f"bin temperatures off "
          f"{VEL_TEMPERATURE} K by up to {out['t_dev']:.3e}")
    check(np.array_equal(prof.results.counts,
                         f32_flow_counts(traj, prof._edges)),
          "flow counts differ from numpy's on the float32 edges")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "electrolyte.trr")
        frames = VEL_CHECK_FRAMES
        write_trr(path, traj[:frames] / 10.0, np.diag([BOX / 10.0] * 3),
                  velocities=vel[:frames] / 10.0, dt=0.5)
        reader = TRRReader(path)
        p, v, d = reader.read_frames_with_velocities(np.arange(frames))
        from_trr = Universe(Topology(N_ATOMS, masses=masses), reader)
        from_arrays = Universe.from_arrays(p, d, dt=0.5, velocities=v,
                                           masses=masses)
        a, b = (run_together(chunked([flow.FlowProfile(
            w.atoms, n_bins=FLOW_BINS, verbose=False, device=device)],
            width=6))[0] for w in (from_trr, from_arrays))
        check(np.array_equal(a.results.counts, b.results.counts),
              "FlowProfile from the TRR: counts differ from the ArrayReader "
              "route")
        # float64 bincounts on the card add in no fixed order, and a
        # bin's mean y or z velocity cancels sums ~1e4 times its size
        for key in ("velocity", "temperature"):
            err = np.abs(a.results[key] - b.results[key]).max()
            check(err <= 1e-10 * np.abs(b.results[key]).max(),
                  f"FlowProfile from the TRR: {key} off the ArrayReader "
                  f"route by {err:.3e}")

    def check_frames(where):
        return run_together(chunked([
            dynamics.SurvivalProbability(u.atoms, ("slab", "z", 10.0, 20.0),
                                         verbose=False, device=where),
            dynamics.SurvivalProbability(
                cations[:SHELL_IONS], ("shell", anions[:SHELL_IONS],
                                       SHELL_RADIUS), verbose=False,
                device=where),
            dynamics.OverlapFunction(u.atoms, OVERLAP_A,
                                     n_lags=OVERLAP_CHECK_LAGS,
                                     verbose=False, device=where)]),
            stop=VEL_CHECK_FRAMES)

    (k_slab, k_shell, k_overlap), (h_slab, h_shell, h_overlap) = (
        check_frames(device), check_frames("cpu"))
    out["cpu_s"] = time.perf_counter() - cpu_started
    for what, x, y in (
            ("slab memberships", k_slab._membership, h_slab._membership),
            ("shell memberships", k_shell._membership, h_shell._membership),
            ("full run's slab memberships",
             slab._membership[:VEL_CHECK_FRAMES], h_slab._membership),
            ("full run's shell memberships",
             shell._membership[:VEL_CHECK_FRAMES], h_shell._membership),
            ("overlap Q", k_overlap.results.Q, h_overlap.results.Q),
            ("overlap chi4", k_overlap.results.chi4, h_overlap.results.chi4)):
        check(np.array_equal(x, y), f"velocity phase, card vs CPU: {what} "
              "differ")
    q = overlap.results.Q
    check(len(q) == OVERLAP_LAGS and q[0] == 1.0 and q[1] < 1.0
          and np.all(np.isfinite(q)) and 0 <= q[-1] < 0.1,
          f"overlap Q: 1 at lag 0, below 0.1 at lag {OVERLAP_LAGS - 1}")
    check(0 < shell.results.n_in_zone.mean() < SHELL_IONS,
          "shell memberships")
    out["seconds"] = time.perf_counter() - started
    print("velocity phase passes: " + "; ".join(
        f"{name} {r['fps']:.3f} frames/s, busy {100 * r['busy']:.1f} %, "
        f"{r['activities']:.0f} device activities a frame (profiled run "
        f"{r['runs']})" for name, r in out.items()
        if isinstance(r, dict)))
    print(f"velocity phase ({N_ATOMS} ions, {VEL_FRAMES} frames): VACF vs "
          f"float64 FFT oracle {out['vacf_err']:.3e} of VACF(0), VACF(0) "
          f"{out['vacf0']:+.3e} off 3kT<1/m> + <u_x^2>; conductivity "
          f"{current.results.conductivity:.6g} S/m, vs CPU "
          f"{out['sigma_err']:.1e}"
          f"; shear rate {out['shear']:.5f} /ps (imposed {SHEAR_RATE}), bin "
          f"temperatures within {100 * out['t_dev']:.2f} % of "
          f"{VEL_TEMPERATURE:g} K; TRR route's counts == ArrayReader "
          "route's; survival "
          f"(slab {slab.results.n_in_zone.mean():.1f}, shell "
          f"{shell.results.n_in_zone.mean():.1f} a frame) and overlap (Q at "
          f"lag {OVERLAP_LAGS - 1} {q[-1]:.4f}; the {OVERLAP_CHECK_LAGS}-lag "
          f"ring) over {VEL_CHECK_FRAMES} frames == CPU (CPU "
          f"runs {out['cpu_s']:.1f} s); data {out['data_s']:.1f} s; "
          f"{out['seconds']:.1f} s on {card}")
    return out


IFACE_SITES, IFACE_IONS = 20_000, 300
IFACE_BOX = (100.0, 100.0, 180.0)
#: the default grid of that box: spacings at most xi / 2 = 1.2 A
IFACE_GRID = (128, 128, 256)
IFACE_FRAMES = 8 + 24
#: water-oxygen number density (A^-3), the surfaces' capillary amplitude.
IFACE_DENSITY, IFACE_AMPLITUDE = 0.0334, 0.8
#: card against the port's CPU run of the first chunk: fields within
#: IFACE_FIELD_RTOL of their maximum, levels within IFACE_LEVEL_RTOL,
#: heights within IFACE_HEIGHT_ATOL (A): float64 FFTs and sums on both,
#: each rounded once to float32, differ only at near-ties.
IFACE_FIELD_RTOL, IFACE_LEVEL_RTOL, IFACE_HEIGHT_ATOL = 2e-7, 1e-6, 1e-5
#: the run at the classes' default chunk streams the IFACE_FRAMES frames
#: IFACE_REPEAT times over (608 frames: a first chunk of 551, which its
#: grid passes take a few frames at a time); its device memory may grow by
#: the classes' _grid_bytes and IFACE_CHUNK_COPIES chunks of coordinates.
IFACE_REPEAT, IFACE_CHUNK_COPIES = 19, 16


def interface_universe(rng, n_frames):
    """A liquid slab of IFACE_SITES water oxygens at IFACE_DENSITY in the
    IFACE_BOX box (thickness IFACE_SITES / (density L_x L_y), centered in
    z), each surface corrugated by three capillary modes of amplitude
    IFACE_AMPLITUDE whose phases drift frame to frame, with IFACE_IONS Na+
    and Cl- dissolved in it; float32, 1 ps a frame."""

    lx, ly, lz = IFACE_BOX
    thick = IFACE_SITES / (IFACE_DENSITY * lx * ly)
    z_lo = lz / 2 - thick / 2
    modes = [(1, 0), (0, 1), (1, 1)]
    phases = rng.random((len(modes), 2)) * 2 * np.pi
    n = IFACE_SITES + IFACE_IONS
    traj = np.empty((n_frames, n, 3), np.float32)
    for t in range(n_frames):
        x = rng.random(n) * lx
        y = rng.random(n) * ly
        s = rng.random(n) * thick
        lower = sum(IFACE_AMPLITUDE * np.sin(2 * np.pi * (kx * x / lx + ky * y
                                                          / ly) + ph[0] + 0.2
                                             * t)
                    for (kx, ky), ph in zip(modes, phases))
        upper = sum(IFACE_AMPLITUDE * np.sin(2 * np.pi * (kx * x / lx + ky * y
                                                          / ly) + ph[1] - 0.2
                                             * t)
                    for (kx, ky), ph in zip(modes, phases))
        z = z_lo + lower + s * (thick + upper - lower) / thick
        traj[t] = np.stack((x, y, z), -1)
    return traj, slab_universe(traj)


def slab_universe(traj):
    """The Universe of interface_universe's sites over the frames
    `traj`."""

    from mdhelper_tpu_torch.core.universe import Universe

    ions = np.tile([1.0, -1.0], IFACE_IONS // 2)
    return Universe.from_arrays(
        traj, np.array(list(IFACE_BOX) + [90.0] * 3), dt=1.0,
        names=np.array(["OW"] * IFACE_SITES + ["NA", "CL"] * (IFACE_IONS // 2),
                       object),
        masses=np.concatenate([np.full(IFACE_SITES, 15.999),
                               np.tile(ION_MASSES, IFACE_IONS // 2)]),
        charges=np.concatenate([np.zeros(IFACE_SITES), ions]))


def phase_interface(device, rng, card):
    """Slice 17's interfaces on the card: run_together of
    WillardChandlerInterface (the defaults: xi 2.4 A, order 2, a (128, 128,
    256) grid) and IntrinsicDensityProfile of the oxygens, Na+ and Cl-
    (both sides, charge densities) on interface_universe over
    IFACE_FRAMES frames in CHUNK-frame chunks, through run_profiled
    (frames/s, busy share, device activities a frame); the capillary
    spectrum and surface tension; the deposit's and the smoothing's ms a
    frame (CUDA events over a chunk), and the transforms' in float64 (the
    port's) and in float32;
    the first chunk on the card against the port's CPU run: fields,
    levels and heights within IFACE_*_RTOL/ATOL, intrinsic counts equal,
    and the timed run's first-chunk levels and heights within the same
    bounds; the slab's mean heights within 2 A of its built edges and its
    intrinsic plateau within 5 % of IFACE_DENSITY; then both classes at
    their default _chunk_bytes over the frames IFACE_REPEAT times over,
    whose chunk holds more frames than a grid pass: the device memory it
    adds within _grid_bytes and IFACE_CHUNK_COPIES chunks of coordinates,
    every repeat's levels and heights within the bounds of the timed
    run's, the intrinsic counts IFACE_REPEAT times the timed run's."""

    import torch

    from mdhelper_tpu_torch.analysis import interface
    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.ops import profiles

    started = time.perf_counter()
    traj, u = interface_universe(rng, IFACE_FRAMES)
    out = {"data_s": time.perf_counter() - started}

    def make(where, universe=u, chunked=True):
        ox = universe.select_atoms("name OW")
        analyses = [
            interface.WillardChandlerInterface(ox, verbose=False,
                                               device=where),
            interface.IntrinsicDensityProfile(
                ox, [ox, universe.select_atoms("name NA"),
                     universe.select_atoms("name CL")], verbose=False,
                device=where),
        ]
        # run_together streams every atom of the universe
        for a in analyses:
            if chunked:
                a._chunk_bytes = CHUNK * universe.atoms.n_atoms * 3 * 4
        return analyses

    launches_before = kernel_launch_counts()
    pair = make(device)
    out["fps"], out["busy"], out["activities"] = run_profiled(
        pair, IFACE_FRAMES, CHUNK, remake=lambda: make(device))
    out["profiled_runs"] = run_profiled.runs
    check(kernel_launch_counts() == launches_before,
          "a kernel of the kernels line launched on the interface path")
    wc, idp = pair
    check(wc._n_cells == IFACE_GRID, f"grid {wc._n_cells}")
    check(np.isfinite(wc.results.heights).all(), "every column resolved")
    thick = IFACE_SITES / (IFACE_DENSITY * IFACE_BOX[0] * IFACE_BOX[1])
    edges = (IFACE_BOX[2] / 2 - thick / 2, IFACE_BOX[2] / 2 + thick / 2)
    mean = wc.results.mean_heights.mean(axis=1)
    check(np.all(np.abs(mean - np.asarray(edges)) < 2.0),
          f"mean heights {mean} against the slab's edges {edges}")
    wc.calculate_spectrum()
    wc.calculate_surface_tension(300.0)
    check(np.all(np.isfinite(wc.results.surface_tension)),
          "surface tension finite")
    # the oxygens' intrinsic density 10-40 A into the liquid
    inside = (idp.results.bins > 10.0) & (idp.results.bins < 40.0)
    plateau = idp.results.number_densities[0][inside].mean()
    check(abs(plateau / IFACE_DENSITY - 1) < 0.05,
          f"intrinsic plateau {plateau:.5f} against {IFACE_DENSITY}")

    pts = torch.from_numpy(traj[:CHUNK, :IFACE_SITES]).to(device)
    box = torch.tensor(IFACE_BOX, device=device)
    cells = wc._n_cells
    counts = profiles.grid_deposit_frames(pts, cells, box, 2)
    profiles.gaussian_smooth_periodic(counts, box, 2.4, 2)
    out["deposit_ms"] = time_ms(
        lambda: profiles.grid_deposit_frames(pts, cells, box, 2), 3) / CHUNK
    out["fft_ms"] = time_ms(
        lambda: profiles.gaussian_smooth_periodic(counts, box, 2.4, 2),
        3) / CHUNK
    # the transform pair alone, in the port's float64 and in float32
    for name, grid in (("pair64_ms", counts.double()), ("pair32_ms", counts)):
        def pair(grid=grid):
            return torch.fft.irfftn(torch.fft.rfftn(grid, dim=(1, 2, 3)),
                                    s=cells, dim=(1, 2, 3))
        pair()
        out[name] = time_ms(pair, 3) / CHUNK
    del counts, grid

    cpu_started = time.perf_counter()
    (k_wc, k_idp), (h_wc, h_idp) = (run_together(make(where), stop=CHUNK)
                                    for where in (device, "cpu"))
    out["cpu_s"] = time.perf_counter() - cpu_started
    field = h_wc.results.density_field
    out["field_err"] = float(np.abs(k_wc.results.density_field - field).max()
                             / field.max())
    out["level_err"] = float(np.abs(k_wc.results.levels
                                    / h_wc.results.levels - 1).max())
    out["height_err"] = float(np.abs(k_wc.results.heights
                                     - h_wc.results.heights).max())
    check(out["field_err"] <= IFACE_FIELD_RTOL, f"fields, card vs CPU: "
          f"{out['field_err']:.3e} of the maximum")
    check(out["level_err"] <= IFACE_LEVEL_RTOL, f"levels, card vs CPU: "
          f"{out['level_err']:.3e}")
    check(out["height_err"] <= IFACE_HEIGHT_ATOL, f"heights, card vs CPU: "
          f"{out['height_err']:.3e} A")
    check(np.array_equal(k_idp.results.counts, h_idp.results.counts),
          "intrinsic counts, card vs CPU, differ")
    out["timed_level_err"] = float(np.abs(wc.results.levels[:CHUNK]
                                          / h_wc.results.levels - 1).max())
    out["timed_height_err"] = float(np.abs(
        wc.results.heights[:, :CHUNK] - h_wc.results.heights).max())
    check(out["timed_level_err"] <= IFACE_LEVEL_RTOL, f"timed run's levels, "
          f"card vs CPU: {out['timed_level_err']:.3e}")
    check(out["timed_height_err"] <= IFACE_HEIGHT_ATOL, f"timed run's "
          f"heights, card vs CPU: {out['timed_height_err']:.3e} A")

    # The default chunk: hundreds of frames, grid passes of a few.
    long_u = slab_universe(np.tile(traj, (IFACE_REPEAT, 1, 1)))
    long_pair = make(device, long_u, chunked=False)
    chunk_frames = long_pair[0]._chunk_bytes // (long_u.atoms.n_atoms * 12)
    out["pass_frames"] = interface._grid_pass_frames(
        long_pair[0]._grid_bytes, cells, IFACE_SITES, 2)
    check(chunk_frames > out["pass_frames"], f"a default chunk of "
          f"{chunk_frames} frames fits one grid pass")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    long_started = time.perf_counter()
    l_wc, l_idp = run_together(long_pair)
    torch.cuda.synchronize()
    out["long_fps"] = (IFACE_REPEAT * IFACE_FRAMES
                       / (time.perf_counter() - long_started))
    out["long_peak"] = torch.cuda.max_memory_allocated(device) - base
    limit = (l_wc._grid_bytes
             + IFACE_CHUNK_COPIES * chunk_frames * long_u.atoms.n_atoms * 12)
    check(out["long_peak"] <= limit, f"the default-chunk run added "
          f"{out['long_peak'] / 2**30:.2f} GiB of device memory, more than "
          f"{limit / 2**30:.2f}")
    heights = l_wc.results.heights.reshape(2, IFACE_REPEAT, IFACE_FRAMES,
                                           *wc.results.heights.shape[2:])
    out["long_height_err"] = float(np.abs(
        heights - wc.results.heights[:, None]).max())
    out["long_level_err"] = float(np.abs(
        l_wc.results.levels.reshape(IFACE_REPEAT, IFACE_FRAMES)
        / wc.results.levels - 1).max())
    check(out["long_level_err"] <= IFACE_LEVEL_RTOL and out["long_height_err"]
          <= IFACE_HEIGHT_ATOL, f"default chunk against the timed run: "
          f"levels {out['long_level_err']:.3e}, heights "
          f"{out['long_height_err']:.3e} A")
    check(np.array_equal(l_idp.results.counts,
                         IFACE_REPEAT * idp.results.counts),
          "default chunk's intrinsic counts differ from the timed run's")
    out["seconds"] = time.perf_counter() - started
    print(f"interface phase ({IFACE_SITES} oxygens + {IFACE_IONS} ions, "
          f"{IFACE_BOX} A, grid {cells}): {out['fps']:.3f} frames/s, busy "
          f"{100 * out['busy']:.1f} %, {out['activities']:.0f} device "
          f"activities a frame (profiled run {out['profiled_runs']}); deposit "
          f"{out['deposit_ms']:.3f} ms and smoothing (float64 FFTs) "
          f"{out['fft_ms']:.3f} ms a frame, its transform pair "
          f"{out['pair64_ms']:.3f} ms (float32: {out['pair32_ms']:.3f}); "
          f"mean heights {mean[0]:.3f} / "
          f"{mean[1]:.3f} A (built {edges[0]:.3f} / {edges[1]:.3f}), width "
          f"{wc.results.interface_width.mean():.3f} A, surface tension "
          f"{wc.results.surface_tension.mean():.4g} kJ/mol/A^2, plateau "
          f"{plateau:.5f} /A^3; first chunk card vs CPU: fields "
          f"{out['field_err']:.2e}, levels {out['level_err']:.2e}, heights "
          f"{out['height_err']:.2e} A, intrinsic counts equal (CPU run "
          f"{out['cpu_s']:.1f} s), the timed run's levels "
          f"{out['timed_level_err']:.2e} and heights "
          f"{out['timed_height_err']:.2e} A; default chunk "
          f"({IFACE_REPEAT * IFACE_FRAMES} frames, {chunk_frames} a chunk, "
          f"{out['pass_frames']} a grid pass): {out['long_fps']:.3f} "
          "frames/s, "
          f"{out['long_peak'] / 2**30:.3f} GiB of device memory added, "
          f"levels {out['long_level_err']:.2e} and heights "
          f"{out['long_height_err']:.2e} A off the timed run's, counts "
          f"{IFACE_REPEAT} times its; data {out['data_s']:.1f} s; "
          f"{out['seconds']:.1f} s on {card}")
    return out


# Slice 18: molecules.  A solvated protein at the size users align: a
# compact chain of SUP_RESIDUES residues of SUP_PER_RESIDUE atoms (9 heavy
# atoms and 7 hydrogens, residue and atom names, so select_atoms finds the
# backbone and the heavy atoms) on a jittered lattice of protein density
# (0.1 atoms/A^3), in SUP_SOLVENT solvent atoms in the SUP_BOX cube; 8 + 56
# frames.  The protein moves as its reference structure under a random
# rigid rotation and translation a frame, with two collective modes on top
# (AR(1) amplitudes of correlation times SUP_MODE_TAUS frames and sample
# variances SUP_MODE_VARS A^2 over the backbone, free of rigid motion) and
# SUP_NOISE A rms of isotropic noise an atom.
SUP_RESIDUES, SUP_PER_RESIDUE = 300, 16
SUP_ATOMS = SUP_RESIDUES * SUP_PER_RESIDUE
SUP_SOLVENT, SUP_BOX = 95_000, 100.0
SUP_FRAMES = 8 + 56
SUP_NOISE = 0.3
SUP_MODE_TAUS, SUP_MODE_VARS = (10.0, 2.0), (400.0, 144.0)
SUP_RESNAMES = ("ALA", "GLY", "SER", "LEU", "VAL", "THR", "ASP", "LYS",
                "GLU", "PHE")
SUP_NAMES = ("N", "CA", "C", "O", "CB", "CG", "CD", "CE", "NZ", "H", "HA",
             "HB1", "HB2", "HG1", "HG2", "HD1")
SUP_ELEMENT_MASSES = {"N": 14.007, "C": 12.011, "O": 15.999, "H": 1.008}
#: TICA's lag (frames) and whitening cutoff: C0's noise eigenvalues (about
#: 2 A^2 at this noise and depth) fall under rcond times the top (400 A^2).
SUP_LAG, SUP_RCOND = 4, 0.02
#: the fitted rotations against the inverse of the imposed ones (entrywise:
#: the noise's share, about 2e-4, and the modes' second-order share of a
#: few 1e-4, are what separates them) and the RMSD against the float64
#: oracle (A).
SUP_ROTATION_BOUND, SUP_RMSD_BOUND = 5e-3, 1e-6


def superposition_universe(rng, n_frames):
    """``(frames float32 (T, N, 3), protein reference (SUP_ATOMS, 3),
    rotations (T, 3, 3), modes (2, SUP_ATOMS, 3), Universe)``: the protein
    (atoms 0 .. SUP_ATOMS - 1) and its solvent, 1 ps a frame."""

    from mdhelper_tpu_torch.core.universe import Universe

    # jittered lattice points nearest the center, ordered along a
    # serpentine path so that residues are compact
    a = 0.1 ** (-1 / 3)
    n = 24
    grid = np.indices((n, n, n)).reshape(3, -1).T
    centered = (grid - (n - 1) / 2) * a
    keep = np.argsort(np.linalg.norm(centered, axis=1),
                      kind="stable")[:SUP_ATOMS]
    x, y, z = grid[keep].T
    xs = np.where((y + z) % 2 == 1, -x, x)
    ys = np.where(z % 2 == 1, -y, y)
    base = centered[keep][np.lexsort((xs, ys, z))]
    base = base + rng.normal(0.0, 0.2, base.shape)

    names = np.tile(SUP_NAMES, SUP_RESIDUES)
    masses = np.array([SUP_ELEMENT_MASSES[name[0]] for name in names])
    backbone = np.isin(names, ("N", "CA", "C", "O"))
    # two modes over every protein atom, free of rigid motion in both fits
    # that see them: the mass-weighted one of all atoms and the unweighted
    # one of the backbone; each with a unit-norm backbone part
    constraints = []
    for weights in (masses, backbone.astype(float)):
        center = (weights[:, None] * base).sum(0) / weights.sum()
        for k in range(3):
            axis = np.eye(3)[k]
            constraints.append(weights[:, None] * axis)
            constraints.append(weights[:, None]
                               * np.cross(axis, base - center))
    basis = np.linalg.qr(np.stack([c.ravel() for c in constraints], 1))[0]
    modes = rng.normal(size=(2, base.size))
    modes -= (modes @ basis) @ basis.T
    modes = modes.reshape(2, SUP_ATOMS, 3)
    modes /= np.linalg.norm(modes[:, backbone].reshape(2, -1),
                            axis=1)[:, None, None]
    # AR(1) amplitudes, made zero-mean and uncorrelated over the frames,
    # with the sample variances SUP_MODE_VARS
    amps = np.empty((n_frames, 2))
    for k, tau in enumerate(SUP_MODE_TAUS):
        rho = np.exp(-1.0 / tau)
        amps[0, k] = rng.standard_normal()
        for t in range(1, n_frames):
            amps[t, k] = (rho * amps[t - 1, k]
                          + np.sqrt(1 - rho**2) * rng.standard_normal())
    amps = np.linalg.qr(amps - amps.mean(0))[0] * np.sqrt(
        np.asarray(SUP_MODE_VARS) * n_frames)
    rotations = np.empty((n_frames, 3, 3))
    frames = np.empty((n_frames, SUP_ATOMS + SUP_SOLVENT, 3), np.float32)
    for t in range(n_frames):
        q = rng.standard_normal(4)
        qw, qx, qy, qz = q / np.linalg.norm(q)
        rotations[t] = [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx * qx + qy * qy)]]
        local = (base + np.einsum("m,mnd->nd", amps[t], modes)
                 + rng.normal(0.0, SUP_NOISE / np.sqrt(3), base.shape))
        frames[t, :SUP_ATOMS] = (local @ rotations[t].T + SUP_BOX / 2
                                 + rng.normal(0.0, 2.0, 3))
        frames[t, SUP_ATOMS:] = rng.random((SUP_SOLVENT, 3)) * SUP_BOX
    masses = np.concatenate([masses, np.full(SUP_SOLVENT, 18.015)])
    u = Universe.from_arrays(
        frames, [SUP_BOX] * 3 + [90.0] * 3, dt=1.0, masses=masses,
        names=np.concatenate([names, np.full(SUP_SOLVENT, "OW")]),
        resnames=np.concatenate([
            np.repeat(np.resize(SUP_RESNAMES, SUP_RESIDUES), SUP_PER_RESIDUE),
            np.full(SUP_SOLVENT, "SOL")]),
        resindices=np.concatenate([
            np.repeat(np.arange(SUP_RESIDUES), SUP_PER_RESIDUE),
            SUP_RESIDUES + np.arange(SUP_SOLVENT)]))
    return frames, base, rotations, modes, u


def kabsch64(frames, ref, w):
    """float64 weighted Kabsch of float32 `frames` ``(T, N, 3)`` onto `ref`
    (SVD of the 3 x 3 covariance, the sign of the determinant fixed):
    ``(rmsd (T,), rotations (T, 3, 3), aligned (T, N, 3))``, the RMSD
    taken from the aligned coordinates."""

    w_total = w.sum()
    ref_c = ref - (w[:, None] * ref).sum(0) / w_total
    out = ([], [], [])
    for p in frames.astype(np.float64):
        pc = p - (w[:, None] * p).sum(0) / w_total
        u_, _, vt = np.linalg.svd((pc * w[:, None]).T @ ref_c)
        d = np.sign(np.linalg.det(u_ @ vt))
        rot = (u_ @ np.diag([1.0, 1.0, d]) @ vt).T
        aligned = pc @ rot.T
        out[0].append(np.sqrt((w * ((aligned - ref_c) ** 2).sum(1)).sum()
                              / w_total))
        out[1].append(rot)
        out[2].append(aligned)
    return tuple(np.array(x) for x in out)


def update_cost(analysis, frames, device):
    """``(ms, bytes)`` of `analysis` on the first CHUNK frames of `frames`:
    the device ms a frame of its update (CUDA events over 3 calls after a
    warm-up call), and the device memory its ``_prepare`` (the carry) and
    one update add at their peak, beyond the chunk's coordinates."""

    import torch

    idx = analysis._effective_atom_indices()
    pos = frames[:CHUNK] if idx is None else frames[:CHUNK][:, idx]
    pos = torch.from_numpy(np.ascontiguousarray(pos)).to(device)
    dims = torch.tensor([list(analysis.universe.dimensions)] * CHUNK,
                        dtype=torch.float64, device=device)
    mask = torch.ones(CHUNK, dtype=torch.float64, device=device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    analysis._setup_frames(analysis._trajectory)
    analysis._prepare()
    carry = analysis._carry
    analysis._update(carry, pos, dims, mask)  # warm-up (cuSOLVER handles)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated(device) - before
    ms = time_ms(lambda: analysis._update(carry, pos, dims, mask), 3)
    return ms / CHUNK, added


def fit_in(analysis, dtype):
    """The aligning fit of `analysis` (the steps of its ``_fit_fn``) in
    `dtype`: a copy kept here to time the float64 fit against the same
    fit in float32.  Its float64 results are held within 1e-12 of
    ``_fit_fn``'s in phase_superposition."""

    import torch

    from mdhelper_tpu_torch.analysis.rmsd import (
        _davenport_k,
        _rotation_from_quaternion,
    )

    device = analysis._device
    w = torch.as_tensor(analysis._weights, device=device, dtype=dtype)
    ref = torch.as_tensor(analysis._ref_centered, device=device, dtype=dtype)
    w_total = analysis._w_total

    def fit(positions):
        x = positions.to(dtype)
        com = torch.einsum("n,bnd->bd", w, x) / w_total
        pc = x - com[:, None, :]
        c = torch.einsum("bnd,ne->bde", pc * w[:, None], ref)
        _, vecs = torch.linalg.eigh(_davenport_k(c))
        rot = _rotation_from_quaternion(vecs[..., :, -1])
        aligned = torch.einsum("bnd,bed->bne", pc, rot)
        diff = aligned - ref
        ss = torch.einsum("n,bnd->b", w, diff * diff)
        return torch.sqrt(ss / w_total), rot, aligned

    return fit


def phase_superposition(device, rng, card):
    """Slice 18's superposition and contacts on the card, on the solvated
    protein (superposition_universe): one run_together of RMSD with mass
    weights on the protein's SUP_ATOMS atoms against its reference
    structure and against frame 0, RMSF, PrincipalComponentAnalysis and
    TICA (lag SUP_LAG, rcond SUP_RCOND) on the 1,200-atom backbone
    (select_atoms), and NativeContacts hard / soft / radius on the heavy
    atoms against themselves, in CHUNK-frame chunks (TICA's ring crosses
    them), through run_profiled (frames/s, busy share, device activities a
    frame).  Checks: the rotations equal the inverse of the imposed ones
    within SUP_ROTATION_BOUND, the RMSD a numpy float64 Kabsch oracle of
    the same float32 coordinates within SUP_RMSD_BOUND, frame 0 against
    itself below 1e-6 A; RMSF against the same oracle; the two leading
    principal components recover the imposed modes (|cos| >= 0.99) and
    transform() matches the port's CPU run; TICA's slowest component is
    the 10-frame mode, its eigenvalues and components equal the port's CPU
    run within rtol 1e-8; q(t) equals the CPU run's bit for bit (hard,
    radius; soft within 1e-6).  Each class's update ms a frame (CUDA
    events over a chunk) and the device memory it adds, and the fit's ms,
    in float64 and in float32."""

    import torch

    from mdhelper_tpu_torch.analysis import contacts, rmsd
    from mdhelper_tpu_torch.analysis.multi import run_together

    started = time.perf_counter()
    frames, base, rotations, modes, u = superposition_universe(rng,
                                                               SUP_FRAMES)
    out = {"data_s": time.perf_counter() - started}
    protein = u.select_atoms("not resname SOL")
    backbone = u.select_atoms("name N CA C O and not resname SOL")
    heavy = u.select_atoms("not resname SOL and not name H*")
    check(protein.n_atoms == SUP_ATOMS
          and backbone.n_atoms == 4 * SUP_RESIDUES,
          f"selections: {protein.n_atoms} protein, {backbone.n_atoms} "
          "backbone atoms")
    bb_ix = backbone.ix

    def make(where):
        analyses = [
            rmsd.RMSD(protein, base, weights="mass", verbose=False,
                      device=where),
            rmsd.RMSD(protein, weights="mass", verbose=False, device=where),
            rmsd.RMSF(protein, base, verbose=False, device=where),
            rmsd.PrincipalComponentAnalysis(backbone, base[bb_ix],
                                            verbose=False, device=where),
            rmsd.TICA(backbone, base[bb_ix], lag=SUP_LAG, rcond=SUP_RCOND,
                      verbose=False, device=where),
        ] + [contacts.NativeContacts(heavy, method=method, verbose=False,
                                     device=where)
             for method in ("hard", "soft", "radius")]
        # run_together streams every atom of the universe
        for a in analyses:
            a._chunk_bytes = CHUNK * u.atoms.n_atoms * 3 * 4
        return analyses

    launches_before = kernel_launch_counts()
    analyses = make(device)
    out["fps"], out["busy"], out["activities"] = run_profiled(
        analyses, SUP_FRAMES, CHUNK, remake=lambda: make(device))
    out["profiled_runs"] = run_profiled.runs
    check(kernel_launch_counts() == launches_before,
          "a kernel of the kernels line launched on the superposition path")
    fit_ref, fit_0, rmsf, pca, tica, *native = analyses

    w = protein.masses
    rmsd_o, rot_o, _ = kabsch64(frames[:, :SUP_ATOMS], base, w)
    out["rot_err"] = float(np.abs(
        fit_ref.results.rotations - rotations.transpose(0, 2, 1)).max())
    check(out["rot_err"] <= SUP_ROTATION_BOUND, f"rotations off the inverse "
          f"of the imposed ones by {out['rot_err']:.3e}")
    out["rmsd_err"] = float(np.abs(fit_ref.results.rmsd - rmsd_o).max())
    check(out["rmsd_err"] <= SUP_RMSD_BOUND, f"RMSD off the float64 Kabsch "
          f"oracle by {out['rmsd_err']:.3e} A")
    out["rot_oracle_err"] = float(np.abs(fit_ref.results.rotations
                                         - rot_o).max())
    rmsd0_o = kabsch64(frames[:, :SUP_ATOMS],
                       frames[0, :SUP_ATOMS].astype(np.float64), w)[0]
    out["rmsd0_err"] = float(np.abs(fit_0.results.rmsd - rmsd0_o).max())
    out["frame0"] = float(fit_0.results.rmsd[0])
    check(out["frame0"] < 1e-6 and out["rmsd0_err"] <= SUP_RMSD_BOUND,
          f"RMSD against frame 0: frame 0 {out['frame0']:.3e} A, off the "
          f"oracle by {out['rmsd0_err']:.3e} A")
    aligned = kabsch64(frames[:, :SUP_ATOMS], base, np.ones(SUP_ATOMS))[2]
    mean = aligned.mean(0)
    rmsf_o = np.sqrt(((aligned - mean) ** 2).sum(-1).mean(0))
    out["rmsf_err"] = float(np.abs(rmsf.results.rmsf - rmsf_o).max())
    check(out["rmsf_err"] <= SUP_RMSD_BOUND, f"RMSF off the float64 oracle "
          f"by {out['rmsf_err']:.3e} A")

    bb_modes = modes[:, bb_ix].reshape(2, -1)  # unit norm
    out["pca_cos"] = np.abs(np.sum(
        bb_modes * pca.results.p_components[:, :2].T, axis=1)).tolist()
    check(min(out["pca_cos"]) >= 0.99, f"PCA's leading components against "
          f"the imposed modes: |cos| {out['pca_cos']}")

    cpu_started = time.perf_counter()
    c_pca, c_tica, *c_native = run_together(make("cpu")[3:])
    k = 4
    proj, c_proj = pca.transform(k), c_pca.transform(k)
    out["transform_err"] = float(np.abs(proj - c_proj).max()
                                 / np.abs(c_proj).max())
    check(out["transform_err"] <= 1e-8, f"PCA transform off the CPU run by "
          f"{out['transform_err']:.3e} of its largest value")
    lam, c_lam = tica.results.eigenvalues, c_tica.results.eigenvalues
    check(tica.results.rank == c_tica.results.rank == 2,
          f"TICA's retained rank {tica.results.rank} (CPU "
          f"{c_tica.results.rank})")
    out["tica_lam_err"] = float(np.abs(lam / c_lam - 1).max())
    comps, c_comps = (tica.results.tica_components,
                      c_tica.results.tica_components)
    out["tica_comp_err"] = float(np.abs(comps - c_comps).max()
                                 / np.abs(c_comps).max())
    check(out["tica_lam_err"] <= 1e-8 and out["tica_comp_err"] <= 1e-8,
          f"TICA off the CPU run: eigenvalues {out['tica_lam_err']:.3e}, "
          f"components {out['tica_comp_err']:.3e}")
    x = kabsch64(frames[:, bb_ix], base[bb_ix], np.ones(len(bb_ix)))[2]
    slow = (x.reshape(SUP_FRAMES, -1)
            - x.reshape(SUP_FRAMES, -1).mean(0)) @ comps[:, 0]
    amps = np.einsum("tnd,mnd->tm", x - x.mean(0), modes[:, bb_ix])
    out["tica_corr"] = [abs(float(np.corrcoef(slow, a)[0, 1]))
                        for a in amps.T]
    check(out["tica_corr"][0] > 0.9 > out["tica_corr"][1],
          f"TICA's slowest component against the modes' amplitudes: "
          f"|corr| {out['tica_corr']}")
    for a, c in zip(native, c_native):
        if a._method == "soft":
            check(np.abs(a.results.q - c.results.q).max() <= 1e-6,
                  "soft q off the CPU run")
        else:
            check(np.array_equal(a.results.q, c.results.q),
                  f"{a._method} q differs from the CPU run")
    check(abs(native[0].results.q[0] - 1.0) <= EPS32
          and native[0].results.q.min() < 1.0,
          "hard q: 1 at the reference frame, below it later")
    out["cpu_s"] = time.perf_counter() - cpu_started

    # each class's update alone, and the fit in float64 and float32
    timed = make(device)
    names = ("rmsd", "rmsd_frame0", "rmsf", "pca", "tica", "hard", "soft",
             "radius")
    out["cost"] = {n: update_cost(a, frames, device)
                   for n, a in zip(names, timed)}
    pos = torch.from_numpy(frames[:CHUNK, :SUP_ATOMS]).to(device)
    fit64, fit32 = fit_in(timed[0], torch.float64), fit_in(timed[0],
                                                           torch.float32)
    out["fit_copy_err"] = max(
        float((a - b).abs().max())
        for a, b in zip(fit64(pos), timed[0]._fit_fn()(pos)))
    check(out["fit_copy_err"] <= 1e-12,
          f"the smoke's copy of the fit is {out['fit_copy_err']:.3e} off "
          "RMSD's own fit")
    fit32(pos)  # warm-up
    out["fit64_ms"] = time_ms(lambda: fit64(pos), 3) / CHUNK
    out["fit32_ms"] = time_ms(lambda: fit32(pos), 3) / CHUNK
    out["seconds"] = time.perf_counter() - started
    print(f"superposition phase ({SUP_ATOMS} protein atoms + {SUP_SOLVENT} "
          f"solvent, {SUP_FRAMES} frames): {out['fps']:.3f} frames/s, busy "
          f"{100 * out['busy']:.1f} %, {out['activities']:.0f} device "
          f"activities a frame (profiled run {out['profiled_runs']}); update "
          "ms a frame (MB of device memory added): " + ", ".join(
              f"{n} {ms:.4f} ({added / 1e6:.1f})"
              for n, (ms, added) in out["cost"].items())
          + f"; the float64 fit {out['fit64_ms']:.4f} ms a frame (float32 "
          f"{out['fit32_ms']:.4f}); rotations within {out['rot_err']:.2e} "
          f"of the imposed inverses ({out['rot_oracle_err']:.2e} of the "
          f"oracle's), RMSD off the float64 Kabsch oracle "
          f"{out['rmsd_err']:.2e} A (against frame 0 {out['rmsd0_err']:.2e},"
          f" frame 0 {out['frame0']:.2e} A), RMSF {out['rmsf_err']:.2e} A; "
          f"PCA |cos| with the modes {out['pca_cos'][0]:.5f}, "
          f"{out['pca_cos'][1]:.5f}, transform vs CPU "
          f"{out['transform_err']:.2e}; TICA eigenvalues {lam[0]:.4f}, "
          f"{lam[1]:.4f} (timescales {tica.results.timescales[0]:.2f}, "
          f"{tica.results.timescales[1]:.2f} ps), vs CPU "
          f"{out['tica_lam_err']:.2e} / {out['tica_comp_err']:.2e}, slowest "
          f"|corr| with the 10-frame mode {out['tica_corr'][0]:.4f}; "
          f"{native[0].results.n_native} native contacts, q == CPU (CPU runs "
          f"{out['cpu_s']:.1f} s); data {out['data_s']:.1f} s; "
          f"{out['seconds']:.1f} s on {card}")
    return out


#: bench.py's config-5 melt (phase_polymer's fixture) with its bonds, and
#: the frames that the port's CPU run repeats and the float64 oracles of
#: angles and dihedrals cover.
BONDED_FRAMES = POLYMER_FRAMES
BONDED_CHECK_FRAMES = CHUNK
#: the moments' tolerance against the CPU run and the float64 oracle
#: (float32 values summed in float64 in another order).
BONDED_RTOL = 1e-6


def edge_distance(values, edges):
    """Distance of each value to its nearest edge (sorted `edges`)."""

    i = np.clip(np.searchsorted(edges, values), 1, len(edges) - 1)
    return np.minimum(np.abs(values - edges[i - 1]),
                      np.abs(edges[i] - values))


def f64_bonded_values(kind, frames, terms, h, *, with_margin=False):
    """float64 lengths, angles or dihedrals (degrees) of float32 `frames`
    ``(T, N, 3)`` in the box matrix `h` rounded to float32 (the box the
    analyses fold by): each displacement folded by rounding its fractional
    coordinates (the minimum image of vectors far under half the cell's
    perpendicular widths, as bonds are).  With `with_margin`, also the
    degrees within which float32 angles or dihedrals may lie from them
    (``testing.float32_angle_margin``; the fold rounds by ``u`` of the
    raw vector in the cube, by ``4 kappa u`` of the raw and folded
    vectors in a triclinic cell)."""

    from mdhelper_tpu_torch.testing import float32_angle_margin

    h = np.asarray(h, np.float32).astype(np.float64)
    inv = np.linalg.inv(h)
    p = frames.astype(np.float64)
    raws, folds = [], []

    def mi(a, b):
        d = p[:, terms[:, a]] - p[:, terms[:, b]]
        folded = d - np.round(d @ inv) @ h
        raws.append(d)
        folds.append(folded)
        return folded

    if kind == "length":
        return np.linalg.norm(mi(0, 1), axis=-1)
    if kind == "angle":
        v1, v2 = mi(0, 1), mi(2, 1)
        cos = (v1 * v2).sum(-1) / np.sqrt((v1 * v1).sum(-1)
                                          * (v2 * v2).sum(-1))
        values = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    else:
        b1, b2, b3 = mi(1, 0), mi(2, 1), mi(3, 2)
        n1, n2 = np.cross(b1, b2), np.cross(b2, b3)
        m1 = np.cross(n1, b2 / np.linalg.norm(b2, axis=-1)[..., None])
        values = np.degrees(np.arctan2((m1 * n2).sum(-1),
                                       (n1 * n2).sum(-1)))
    if not with_margin:
        return values
    u = 2.0**-24
    fold_eps = (u if not np.count_nonzero(h - np.diag(np.diag(h)))
                else 4.0 * np.linalg.cond(h) * u)
    return values, float32_angle_margin(
        kind, np.stack(raws, axis=-2), np.stack(folds, axis=-2), values,
        fold_eps)


def card_bonded_values(analysis, frames, dims):
    """The float32 angles or dihedrals (degrees) that `analysis` (run on
    the card) bins for float32 `frames` ``(T, N, 3)`` in the box `dims`,
    from its own ``_values_fn``, as float64 ``(T, M)``."""

    import torch

    from mdhelper_tpu_torch.analysis.structure import _frame_boxes

    device = analysis._device
    dims = torch.tensor([list(dims)] * len(frames), dtype=torch.float64,
                        device=device)
    box = _frame_boxes(dims, analysis._triclinic)[0][:, None]
    pos = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    cols = torch.as_tensor(analysis._terms, device=device)
    ends = [pos[:, cols[:, c]] for c in range(cols.shape[1])]
    return analysis._values_fn()(ends, box)[1].double().cpu().numpy()


def phase_bonded(device, rng, card):
    """Slice 18's bonded distributions on the card, on bench.py's config-5
    melt (polymer_universe: 2,000 chains of 50 monomers) with its 98,000
    bonds and the 96,000 angles and 94,000 dihedrals derive_angles and
    derive_dihedrals find, over BONDED_FRAMES frames: one run_together of
    BondLengthDistribution, BondAngleDistribution and DihedralDistribution
    through run_profiled (frames/s, busy share, device activities a frame)
    in the cube, and again with the chains wrapped into
    POLYMER_TRICLINIC.  Checks, in each box: bond-length counts equal a
    float64 oracle's over every frame and the port's CPU run over
    BONDED_CHECK_FRAMES as integers; angle and dihedral counts within two
    counts for each value within its float32 margin of an edge
    (testing.float32_angle_margin) of both, and the card's values within
    those margins of the oracle's (over BONDED_CHECK_FRAMES); means and
    standard
    deviations within BONDED_RTOL of both.  Each class's update ms a
    frame (CUDA events over a chunk) and the device memory it adds."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.analysis import bonded
    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.core.universe import Universe

    started = time.perf_counter()
    frames, unwrapped, _ = polymer_universe(rng, BONDED_FRAMES)
    chain = np.arange(POLYMER_CHAINS)[:, None] * POLYMER_MONOMERS
    first = (chain + np.arange(POLYMER_MONOMERS - 1)).ravel()
    bonds = np.stack([first, first + 1], axis=1)
    terms = {"length": bonds, "angle": bonded.derive_angles(bonds),
             "dihedral": bonded.derive_dihedrals(bonds)}
    out = {"derive_s": time.perf_counter() - started}
    check([len(t) for t in terms.values()] == [
        POLYMER_CHAINS * (POLYMER_MONOMERS - k) for k in (1, 2, 3)],
        f"terms: {[len(t) for t in terms.values()]}")
    h_tri = triclinic_matrices(np.array([POLYMER_TRICLINIC], np.float64))[0]
    frac = unwrapped @ np.linalg.inv(h_tri)
    boxes = {
        "cube": (frames, [BOX] * 3 + [90.0] * 3, np.diag([BOX] * 3)),
        "triclinic": (((frac - np.floor(frac)) @ h_tri).astype(np.float32),
                      POLYMER_TRICLINIC, h_tri),
    }
    del unwrapped, frac
    out["data_s"] = time.perf_counter() - started
    classes = {"length": (bonded.BondLengthDistribution, "bonds", {}),
               "angle": (bonded.BondAngleDistribution, "angles", {}),
               "dihedral": (bonded.DihedralDistribution, "dihedrals", {})}

    for name, (traj, dims, h) in boxes.items():
        u = Universe.from_arrays(traj, dims, dt=1.0)

        def make(where, u=u):
            analyses = [cls(u.atoms, verbose=False, device=where,
                            **{key: terms[kind]})
                        for kind, (cls, key, _) in classes.items()]
            for a in analyses:
                a._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
            return analyses

        launches_before = kernel_launch_counts()
        analyses = make(device)
        fps, busy, activities = run_profiled(
            analyses, BONDED_FRAMES, CHUNK, remake=lambda make=make: make(
                device))
        check(kernel_launch_counts() == launches_before,
              "a kernel of the kernels line launched on the bonded path")
        res = {"fps": fps, "busy": busy, "activities": activities,
               "runs": run_profiled.runs}
        cpu_started = time.perf_counter()
        check_card = run_together(make(device), stop=BONDED_CHECK_FRAMES)
        check_cpu = run_together(make("cpu"), stop=BONDED_CHECK_FRAMES)
        res["cpu_s"] = time.perf_counter() - cpu_started
        for kind, full, card_a, cpu_a in zip(classes, analyses, check_card,
                                             check_cpu):
            edges = full.results.edges
            if kind == "length":
                values = f64_bonded_values(kind, traj, terms[kind], h)
                oracle = np.histogram(values, bins=edges)[0]
                check(np.array_equal(full.results.counts, oracle),
                      f"{name} bond-length counts differ from the float64 "
                      "oracle's")
                check(np.array_equal(card_a.results.counts,
                                     cpu_a.results.counts),
                      f"{name} bond-length counts differ from the CPU run's")
                res[f"{kind}_delta"] = (0, 0, 0)
            else:
                values, margin = f64_bonded_values(
                    kind, traj[:BONDED_CHECK_FRAMES], terms[kind], h,
                    with_margin=True)
                oracle = np.histogram(values, bins=edges)[0]
                near = edge_distance(values.ravel(), edges)
                bound = max(2, 2 * int((near < margin.ravel()).sum()))
                d_cpu = int(np.abs(card_a.results.counts
                                   - cpu_a.results.counts).sum())
                d_f64 = int(np.abs(card_a.results.counts - oracle).sum())
                check(d_cpu <= bound and d_f64 <= bound,
                      f"{name} {kind} counts: |delta| {d_cpu} (CPU), "
                      f"{d_f64} (float64) against the bound {bound}")
                err = np.abs(card_bonded_values(
                    card_a, traj[:BONDED_CHECK_FRAMES], dims) - values)
                if kind == "dihedral":
                    err = np.minimum(err, 360.0 - err)  # across +-180
                worst = float((err / margin).max())
                check(worst <= 1.0,
                      f"{name} {kind}: a card value {worst:.3f} margins "
                      "off the float64 oracle")
                res[f"{kind}_delta"] = (d_cpu, d_f64, bound)
                res[f"{kind}_margin"] = (float(np.median(margin)),
                                         float(err.max()), worst)
            if kind != "dihedral":
                for key in ("mean", "std"):
                    ref = values.mean() if key == "mean" else values.std()
                    err_cpu = abs(card_a.results[key] / cpu_a.results[key]
                                  - 1)
                    err_f64 = abs((full if kind == "length" else card_a)
                                  .results[key] / ref - 1)
                    check(err_cpu <= BONDED_RTOL and err_f64 <= BONDED_RTOL,
                          f"{name} {kind} {key}: {err_cpu:.2e} off the CPU "
                          f"run, {err_f64:.2e} off the float64 oracle")
            if kind != "length":
                check(full.results.counts.sum() == BONDED_FRAMES * len(
                    terms[kind]), f"{name} {kind}: every value in range")
        res["cost"] = {kind: update_cost(a, traj, device)
                       for kind, a in zip(classes, make(device))}
        out[name] = res
    out["seconds"] = time.perf_counter() - started
    print("bonded phase passes: " + "; ".join(
        f"{name} {r['fps']:.3f} frames/s, busy {100 * r['busy']:.1f} %, "
        f"{r['activities']:.0f} device activities a frame (profiled run "
        f"{r['runs']}), update ms a frame (MB of device memory added) "
        + ", ".join(f"{k} {ms:.4f} ({added / 1e6:.1f})"
                    for k, (ms, added) in r["cost"].items())
        for name, r in out.items() if isinstance(r, dict)))
    print(f"bonded phase ({POLYMER_CHAINS} chains x {POLYMER_MONOMERS}, "
          f"{BONDED_FRAMES} frames; {len(terms['length'])} bonds, "
          f"{len(terms['angle'])} angles, {len(terms['dihedral'])} "
          f"dihedrals derived in {out['derive_s']:.1f} s): bond-length "
          "counts == float64 oracle (every frame) and == CPU (first "
          f"{BONDED_CHECK_FRAMES} frames) in both boxes; angle / dihedral "
          "|count deltas| (CPU, float64, bound): " + "; ".join(
              f"{name} {out[name]['angle_delta']} / "
              f"{out[name]['dihedral_delta']}" for name in boxes)
          + "; float32 margins (median deg, the card's largest |error| "
          "deg, its largest error / margin), angle / dihedral: "
          + "; ".join(
              f"{name} " + " / ".join(
                  "({:.3e}, {:.3e}, {:.4f})".format(*out[name][f"{k}_margin"])
                  for k in ("angle", "dihedral")) for name in boxes)
          + f"; CPU runs {out['cube']['cpu_s']:.1f} + "
          f"{out['triclinic']['cpu_s']:.1f} s; data {out['data_s']:.1f} s; "
          f"{out['seconds']:.1f} s on {card}")
    return out


def main():
    import torch

    from mdhelper_tpu_torch._device import require_cuda
    from mdhelper_tpu_torch.ops import _build

    started = time.perf_counter()
    device = require_cuda()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    _build.load_library()
    info = _build.build_info()
    print(f"kernels built in {info['seconds']:.1f} s: {info['path']}")
    print(info["log"].strip())
    check_planner_constants()

    rng = np.random.default_rng(SEED)
    self_timing = phase_kernels(device, rng)
    cross_timing = phase_cross_kernels(device, rng)
    stream_timing = phase_stream_sizes(device, rng)
    launches, fps = phase_slice(device, rng)
    print(f"fused RDF+S(q)+MSD: {fps:.3f} frames/s on {card} "
          "(information, not a claim)")
    rdf_launches, rdf_fps = phase_cross_rdf(device, rng)
    print(f"cross RDF: {rdf_fps:.3f} frames/s on {card} "
          "(information, not a claim)")
    vh_launches, vh_fps = phase_vanhove(device, rng)
    print(f"Van Hove: {vh_fps:.3f} frames/s on {card} "
          "(information, not a claim)")
    # The triclinic slice draws from its own generator, so the phases
    # above see the data they always have.
    tri_rng = np.random.default_rng(SEED + 1)
    tri_timing = phase_triclinic_kernels(device, tri_rng)
    tri_rdf = phase_triclinic_rdf(device, tri_rng)
    for path, (_, path_fps) in tri_rdf.items():
        print(f"triclinic {path} RDF: {path_fps:.3f} frames/s on {card} "
              "(information, not a claim)")
    tri_vh_launches, tri_vh_fps = phase_triclinic_vanhove(device, tri_rng)
    print(f"triclinic Van Hove: {tri_vh_fps:.3f} frames/s on {card} "
          "(information, not a claim)")
    tri_self_launches = tri_rdf["self"][0]
    tri_cross_launches = tri_rdf["cross"][0]
    # Slice 4 draws from its own generator too.
    gen_rng = np.random.default_rng(SEED + 2)
    gen_timing = phase_generalized_kernels(device, gen_rng)
    tri_pp_timing = phase_tri_pp_kernels(device, gen_rng)
    phase_full_size_cross_checks(device, gen_rng)
    small_rdf = phase_small_box_rdf(device, gen_rng)
    small_vh = phase_small_box_vanhove(device, gen_rng)
    # Slice 5 draws from its own generator.
    mode_rng = np.random.default_rng(SEED + 4)
    mode_timing = phase_mode_kernels(device, mode_rng)
    phase_mode_fixtures(device, mode_rng)
    water = phase_water_paths(device, mode_rng)
    offset = phase_offset_paths(device, mode_rng)
    film = phase_film_paths(device, mode_rng)
    shape_paths = phase_mode_shape_paths(device, mode_rng)
    fast_paths = phase_fast_op_path(device, mode_rng)
    # Slice 6 draws from its own generator.
    sq_rng = np.random.default_rng(SEED + 5)
    trig_timing = phase_trig_kernels(device, sq_rng)
    sq = phase_direct_sq(device, sq_rng)
    for path, what in (("direct", "direct S(q), exact"),
                       ("auto", "split S(q) (auto, surfaces)"),
                       ("partial", "partial S(q), direct"),
                       ("fast", "direct S(q), fast")):
        print(f"{what}: {sq[path][1]:.3f} frames/s on {card} "
              "(information, not a claim)")
    print(f"factor S(q), exact: {sq['factor_fps']:.3f} frames/s on {card} "
          "(information, not a claim)")
    hist_launches, hist_timing = phase_pair_histogram(device, sq_rng)
    # Slice 7 draws from its own generator.
    phase_overlap(device, np.random.default_rng(SEED + 6))
    # Slice 10 draws from its own generator.
    isf_started = time.perf_counter()
    isf_kernel_timing = phase_isf_kernel(device,
                                         np.random.default_rng(SEED + 8))
    isf = phase_isf(device, np.random.default_rng(SEED + 7), card)
    print(f"the ISF phases took {time.perf_counter() - isf_started:.1f} s")
    # Slice 11 draws from its own generator.
    grouped_started = time.perf_counter()
    grouped = phase_groupings(device, np.random.default_rng(SEED + 9), card)
    print(f"grouped fused path (residue centers of {WATER_MOL} waters): "
          f"{grouped['fps']:.3f} frames/s on {card}, device busy "
          f"{100 * grouped['busy']:.1f} % (information, not a claim); the "
          f"groupings phase took {time.perf_counter() - grouped_started:.1f}"
          " s")
    # Slice 12 draws from its own generator.
    electro_started = time.perf_counter()
    electro = phase_electrolyte(device, np.random.default_rng(SEED + 10),
                                card)
    print(f"electrolyte path ({N_ATOMS} ions): {electro['fps']:.3f} frames/s "
          f"on {card} through the post-hoc methods ({electro['posthoc_s']:.3f}"
          f" s of them), device busy {100 * electro['busy']:.1f} % "
          f"(information, not a claim); the electrolyte phase took "
          f"{time.perf_counter() - electro_started:.1f} s")

    # Slice 13 draws from its own generator.
    files = phase_files(device, np.random.default_rng(SEED + 11), card)
    print(f"files path (GRO + XTC, {N_ATOMS} atoms): device busy "
          f"{100 * files['busy']:.1f} % (information, not a claim); the "
          f"files phase took {files['seconds']:.1f} s")

    # Slice 14 draws from its own generator.
    profiles = phase_profiles(device, np.random.default_rng(SEED + 12), card)
    print(f"config-4 path ({N_ATOMS} ions, z profile + potential): "
          f"{profiles['fps']:.3f} frames/s on {card}, device busy "
          f"{100 * profiles['busy']:.1f} %; permittivity path ({WATER_MOL} "
          f"waters): {profiles['dipole_fps']:.3f} frames/s (information, not "
          f"a claim); the profiles phase took {profiles['seconds']:.1f} s")

    # Slice 15 draws from its own generator.
    polymer = phase_polymer(device, np.random.default_rng(SEED + 14), card)
    print(f"config-5 trio ({POLYMER_CHAINS} chains x {POLYMER_MONOMERS}): "
          f"{polymer['fps']:.3f} frames/s on {card}, device busy "
          f"{100 * polymer['busy']:.1f} %; single-chain S(q) "
          f"{polymer['scsf_ms']:.3f} ms a frame; persistence length "
          f"{polymer['pl_fps']:.3f} and internal distances "
          f"{polymer['msid_fps']:.3f} frames/s, in a triclinic cell "
          f"{polymer['pl_fps_tri']:.3f} and {polymer['msid_fps_tri']:.3f} "
          f"frames/s (information, not a claim); "
          f"the polymer phase took {polymer['seconds']:.1f} s")

    # Slice 16 draws from its own generators, one a phase.
    mesh = phase_mesh(device, np.random.default_rng(SEED + 15), card)
    print(f"mesh S(q) on the fused path: {mesh['mesh']['fps']:.3f} frames/s "
          f"against {mesh['factor']['fps']:.3f} with the factor route on "
          f"{card} (information, not a claim); the mesh phase took "
          f"{mesh['seconds']:.1f} s")
    aggregates = phase_aggregates(device, np.random.default_rng(SEED + 16),
                                  card)
    print(f"aggregates path ({AGG_ATOMS} atoms): {aggregates['fps']:.3f} "
          f"frames/s on {card}, device busy "
          f"{100 * aggregates['busy']:.1f} % (information, not a claim); the "
          f"aggregates phase took {aggregates['seconds']:.1f} s")
    order = phase_order(device, np.random.default_rng(SEED + 17), card)
    print(f"order path ({AGG_ATOMS} atoms): {order['fps']:.3f} frames/s on "
          f"{card}, device busy {100 * order['busy']:.1f} % (information, not "
          f"a claim); the order phase took {order['seconds']:.1f} s")

    # Slice 17 draws from its own generators, one a phase.
    velocities = phase_velocities(device, np.random.default_rng(SEED + 18),
                                  card)
    print(f"velocity paths ({N_ATOMS} ions): "
          + ", ".join(f"{name} {velocities[name]['fps']:.3f}"
                      for name in ("velocities", "positions", "flow"))
          + f" frames/s on {card} (information, not a claim); the velocity "
          f"phase took {velocities['seconds']:.1f} s")
    interfaces = phase_interface(device, np.random.default_rng(SEED + 19),
                                 card)
    print(f"interface path ({IFACE_SITES} oxygens): "
          f"{interfaces['fps']:.3f} frames/s on {card}, device busy "
          f"{100 * interfaces['busy']:.1f} % (information, not a claim); the "
          f"interface phase took {interfaces['seconds']:.1f} s")

    # Slice 18 draws from its own generators, one a phase.
    sup = phase_superposition(device, np.random.default_rng(SEED + 20), card)
    print(f"superposition path ({SUP_ATOMS} protein atoms): "
          f"{sup['fps']:.3f} frames/s on {card}, device busy "
          f"{100 * sup['busy']:.1f} % (information, not a claim); the "
          f"superposition phase took {sup['seconds']:.1f} s")
    bonds = phase_bonded(device, np.random.default_rng(SEED + 21), card)
    print(f"bonded paths ({N_ATOMS} atoms): cube "
          f"{bonds['cube']['fps']:.3f}, triclinic "
          f"{bonds['triclinic']['fps']:.3f} frames/s on {card} (information, "
          f"not a claim); the bonded phase took {bonds['seconds']:.1f} s")

    def path_row(shape, timing_plan, path, plain_from=None, plain_shape=None):
        """(launches, shape, timing) of a slice-4 row, whose kernel was
        timed on the plan its path ran (checked here); a row whose shape
        is too large for the plain version takes the plain time of the
        smaller shape `plain_shape` (`plain_from`)."""

        timing, plan = timing_plan
        path_launches, _, path_plan = path
        check(all(plan.get(k) == path_plan.get(k) for k in
                  ("n_cells_dim", "reach", "capacity", "capacity2")),
              f"{shape}: timed on {plan}, but the path ran {path_plan}")
        if plain_from is not None:
            timing = {**timing, "plain_ms": plain_from[0]["plain_ms"],
                      "plain_shape": f"{plain_shape}, plan "
                      f"{plain_from[1]['n_cells_dim']}"}
        return path_launches, shape, timing

    def option_row(shape, row, path, option):
        """(launches, shape, timing) of a slice-5 row: the kernel timed on
        the plan of the path (launches, frames/s, plan) or fast op path
        (launches, plan) whose launches it carries."""

        timing = mode_timing[row]
        path_plan = path[-1]
        check(all(timing["plan"].get(k) == path_plan.get(k) for k in
                  ("n_cells_dim", "reach", "capacity", "capacity2")),
              f"{shape}: timed on {timing['plan']}, but the path ran "
              f"{path_plan}")
        return path[0], shape, {**timing, "option": option}

    self_src = "mdhelper_tpu_torch/csrc/cell_pair_histogram.cu"
    cross_src = "mdhelper_tpu_torch/csrc/cross_pair_histogram.cu"
    tri_self_src = "mdhelper_tpu_torch/csrc/triclinic_cell_pair_histogram.cu"
    tri_cross_src = (
        "mdhelper_tpu_torch/csrc/triclinic_cross_pair_histogram.cu")
    tpu = "mdhelper_tpu/ops/pallas_cell_histogram.py:{}"
    # Each entry names the TPU kernel that the JAX package runs at its
    # shape: the resident-table kernels at 100k atoms, the streaming
    # ones at 400k.  `launches` is the count of the path whose shape an
    # entry times; the 400k entries, which no path runs, carry every
    # path's count of that kernel.
    rows = [
        ("cell_pair_histogram", self_src, 1070, launches,
         f"{N_ATOMS} atoms (fused path)", self_timing),
        ("cell_pair_histogram", self_src, 1340, launches,
         f"{STREAM_ATOMS} atoms", stream_timing["self"]),
        ("cross_pair_histogram", cross_src, 1916, rdf_launches,
         f"{N_ATOMS // 2} x {N_ATOMS // 2} (cross-RDF path)",
         cross_timing["rdf"]),
        ("cross_pair_histogram", cross_src, 1916, vh_launches,
         f"{N_ATOMS} x {N_ATOMS}, exclusion (1, 1) (Van Hove path)",
         cross_timing["vanhove"]),
        ("cross_pair_histogram", cross_src, 1486, rdf_launches + vh_launches,
         f"{STREAM_ATOMS // 2} x {STREAM_ATOMS // 2}",
         stream_timing["cross"]),
        ("triclinic_cell_pair_histogram", tri_self_src, 1180,
         tri_self_launches,
         f"{N_ATOMS} atoms, dodecahedron (triclinic self-RDF path)",
         tri_timing["self"]),
        ("triclinic_cell_pair_histogram", tri_self_src, 1419,
         tri_self_launches,
         f"{STREAM_ATOMS} atoms, dodecahedron", tri_timing["self_stream"]),
        ("triclinic_cross_pair_histogram", tri_cross_src, 1262,
         tri_cross_launches,
         f"{N_ATOMS // 2} x {N_ATOMS // 2}, dodecahedron (triclinic "
         "cross-RDF path)", tri_timing["rdf"]),
        ("triclinic_cross_pair_histogram", tri_cross_src, 1262,
         tri_vh_launches,
         f"{N_ATOMS} x {N_ATOMS}, exclusion (1, 1), dodecahedron "
         "(triclinic Van Hove path)", tri_timing["vanhove"]),
        ("triclinic_cross_pair_histogram", tri_cross_src, 1542,
         tri_cross_launches + tri_vh_launches,
         f"{STREAM_ATOMS // 2} x {STREAM_ATOMS // 2}, dodecahedron",
         tri_timing["cross_stream"]),
        # Slice 4: the generalized and tri_pp modes of _kernel and
        # _cross_kernel (and of their streaming twins, which the same
        # kernels serve), each timed on its path's plan; `launches`
        # counts the mode on that path.
        ("cell_pair_histogram", self_src, 1070, *path_row(
            f"{GEN_ATOMS} atoms, cube {cube(GEN_ATOMS)[0]:.3f} A, r_max 15 "
            "(small-box self RDF path)",
            gen_timing["general"], small_rdf["general"])),
        ("cell_pair_histogram", self_src, 1070, *path_row(
            f"{SMALL_ATOMS} atoms, cube {cube(SMALL_ATOMS)[0]:.3f} A, "
            "r_max 8 (ordered self RDF path)",
            gen_timing["ordered"], small_rdf["ordered"])),
        ("cross_pair_histogram", cross_src, 1916, *path_row(
            f"{GEN_ATOMS // 2} x {GEN_ATOMS // 2}, cube, r_max 15 "
            "(small-box cross RDF path)",
            gen_timing["cross"], small_rdf["cross"])),
        ("cross_pair_histogram", cross_src, 1916, *path_row(
            f"{GEN_ATOMS} x {GEN_ATOMS}, exclusion (1, 1), cube, r_max 15 "
            "(small-box Van Hove path)",
            gen_timing["vanhove"], small_vh["general"])),
        ("triclinic_cell_pair_histogram", tri_self_src, 1070, *path_row(
            f"{GEN_ATOMS} atoms, dodecahedron a = {GEN_DODECA_A} A, "
            "r_max 15 (tri_pp self RDF path)",
            tri_pp_timing["self"], small_rdf["tri_pp_self"],
            tri_pp_timing["self_small"],
            f"{SMALL_ATOMS} atoms, dodecahedron a = {TRI_PP_A} A, r_max 6")),
        ("triclinic_cross_pair_histogram", tri_cross_src, 1916,
         *path_row(
            f"{GEN_ATOMS // 2} x {GEN_ATOMS // 2}, dodecahedron a = "
            f"{GEN_DODECA_A} A, r_max 15 (tri_pp cross RDF path)",
            tri_pp_timing["cross"], small_rdf["tri_pp_cross"],
            tri_pp_timing["cross_small"],
            f"{SMALL_ATOMS // 2} x {SMALL_ATOMS // 2}, dodecahedron a = "
            f"{TRI_PP_A} A, r_max 6")),
        ("triclinic_cross_pair_histogram", tri_cross_src, 1916,
         *path_row(
            f"{SMALL_ATOMS} x {SMALL_ATOMS}, exclusion (1, 1), dodecahedron "
            f"a = {TRI_PP_A} A, r_max 6 (tri_pp Van Hove path)",
            tri_pp_timing["vanhove"], small_vh["tri_pp"])),
    ]
    # Slice 5: tile exclusions, offset bins, 2-D grids and fast binning,
    # each timed on the plan of the path whose launches it carries.
    cube_text = f"{N_ATOMS} atoms, cube {BOX:.1f} A, r_max {R_MAX:g}"
    small_text = (f"{SMALL_ATOMS} atoms, cube {cube(SMALL_ATOMS)[0]:.2f} A, "
                  f"r_max {ORDERED_R:g} (ordered)")
    block_text = (f"{N_ATOMS} atoms, dodecahedron a = {DODECA_A} A, r_max "
                  f"{R_MAX:g} (per block)")
    tri_pp_text = (f"{SMALL_ATOMS} atoms, dodecahedron a = {TRI_PP_A} A, "
                   f"r_max {TRI_PP_R:g} (tri_pp)")
    film_text = f"film {FILM[0]:g} x {FILM[1]:g} x {FILM[2]:g} A, r_max 15"
    for ex in WATER_TILES:
        option = "tiles" if ex[0] == ex[1] else "asym"
        rows.append(("cell_pair_histogram", self_src, 1070, *option_row(
            f"{cube_text}, exclusion {ex} (water self-RDF path)",
            f"tiles {ex}", water[ex], option)))
    rows += [
        ("cell_pair_histogram", self_src, 1070, *option_row(
            f"{cube_text}, range {OFFSET_RANGE} (offset self-RDF path)",
            "offset self", offset["self"], "offset")),
        ("cross_pair_histogram", cross_src, 1916, *option_row(
            f"{N_ATOMS // 2} x {N_ATOMS // 2}, cube, range {OFFSET_RANGE} "
            "(offset cross-RDF path)", "offset cross", offset["cross"],
            "offset")),
        ("cell_pair_histogram", self_src, 1070, *option_row(
            f"{N_ATOMS} atoms, {film_text}, drop_axis z (film self-RDF "
            "path)", "2d self", film["self"], "2d")),
        ("cross_pair_histogram", cross_src, 1916, *option_row(
            f"{N_ATOMS // 2} x {N_ATOMS // 2}, {film_text}, drop_axis z "
            "(film cross-RDF path)", "2d cross", film["cross"], "2d")),
    ]
    for geometry, text, source, line in (
            ("ordered", small_text, self_src, 1070),
            ("block", block_text, tri_self_src, 1180),
            ("tri_pp", tri_pp_text, tri_self_src, 1070)):
        kernel = ("cell_pair_histogram" if source == self_src
                  else "triclinic_cell_pair_histogram")
        for ex in WATER_TILES:
            option = "tiles" if ex[0] == ex[1] else "asym"
            rows.append((kernel, source, line, *option_row(
                f"{text}, exclusion {ex} ({geometry} self-RDF path)",
                f"{geometry} tiles {ex}", shape_paths[geometry, option],
                option)))
        rows.append((kernel, source, line, *option_row(
            f"{text}, range (2.0, r_max) ({geometry} self-RDF path)",
            f"{geometry} offset", shape_paths[geometry, "offset"],
            "offset")))
    for geometry, text, triclinic, lines in (
            ("ortho", cube_text, False, (1070, 1916)),
            ("2d", f"{N_ATOMS} atoms, {film_text}, axes (0, 1)", False,
             (1070, 1916)),
            ("block", block_text, True, (1180, 1262)),
            ("tri_pp", tri_pp_text, True, (1070, 1916))):
        prefix, src = (("triclinic_", (tri_self_src, tri_cross_src))
                       if triclinic else ("", (self_src, cross_src)))
        rows.append((f"{prefix}cell_pair_histogram", src[0], lines[0],
                     *option_row(f"{text}, fast binning (fast op path)",
                                 f"fast {geometry}",
                                 fast_paths[geometry, "self"], "fast")))
        rows.append((f"{prefix}cross_pair_histogram", src[1], lines[1],
                     *option_row(f"{text}, even x odd atoms, fast binning "
                                 "(fast op path)", f"fast {geometry} cross",
                                 fast_paths[geometry, "cross"], "fast")))
    # Slice 6: the two kernels of mdhelper_tpu/ops/pallas_kernels.py.
    pallas_kernels = "mdhelper_tpu/ops/pallas_kernels.py:{}"
    trig_src = "mdhelper_tpu_torch/csrc/trig_sums.cu"
    n_q = N_QPTS**3
    for precision, path in (("exact", "direct"), ("fast", "fast")):
        rows.append(("trig_sums", trig_src, pallas_kernels.format(66),
                     sq[path][0],
                     f"{N_ATOMS} atoms x {n_q} float64 wavevectors (2 "
                     "frames a launch), "
                     f"{precision} (launches: the {precision} direct S(q) "
                     "path)", trig_timing[precision, False]))
    rows.append(("pair_histogram",
                 "mdhelper_tpu_torch/csrc/pair_histogram.cu",
                 pallas_kernels.format(203), hist_launches,
                 f"{N_ATOMS} atoms, cube {BOX:.1f} A, r_max {R_MAX:g}, "
                 f"{N_BINS} bins, exclusion (1, 1) (pair-histogram op path)",
                 hist_timing))
    for frames in (ISF_KERNEL_FRAMES, ISF_LAGS):
        rows.append(("trig_sums", trig_src, pallas_kernels.format(66),
                     isf["direct"][1]["fast"],
                     f"{N_ATOMS} atoms x {n_q} float64 wavevectors, "
                     f"{frames} displacement frames in +-L a launch, fast "
                     "(launches: the direct isf path's fast launches, one a "
                     f"frame over 1 to {ISF_LAGS} displacement frames, the "
                     "same count in both of its rows)",
                     isf_kernel_timing[frames]))
    # Slice 11: the three kernels on centers of mass, each timed on the
    # plan or at the width of the path whose launches it carries.
    rows += [
        ("cell_pair_histogram", self_src, 1070, grouped["launches"],
         f"{WATER_MOL} water centers of mass, cube {BOX:.1f} A, r_max "
         f"{R_MAX:g}, exclusion (1, 1) (grouped fused path)",
         grouped["self"]),
        ("cross_pair_histogram", cross_src, 1916, grouped["cross_launches"],
         f"{WATER_MOL} centers x {3 * WATER_MOL} atoms, cube (mixed-grouping "
         "RDF path)", grouped["cross"]),
        ("trig_sums", trig_src, pallas_kernels.format(66),
         grouped["direct_launches"],
         f"{WATER_MOL} water centers x {n_q} float64 wavevectors (2 frames "
         "a launch), exact (launches: the direct S(q) of the centers)",
         grouped["trig"]),
    ]
    # Slice 12: the cross kernel on the electrolyte path's plan.
    rows.append(("cross_pair_histogram", cross_src, 1916, electro["launches"],
                 f"{N_ATOMS // 2} cations x {N_ATOMS // 2} anions, cube "
                 f"{BOX:.1f} A, r_max {R_MAX:g} (electrolyte path)",
                 electro["cross"]))
    # Slice 13: both kernels on the main path from files.
    rows += [
        ("cell_pair_histogram", self_src, 1070, files["launches"],
         f"{N_ATOMS} atoms from an XTC (files fused path)", files["self"]),
        ("cross_pair_histogram", cross_src, 1916, files["cross_launches"],
         f"name A x name B, {N_ATOMS // 2} x {N_ATOMS // 2} from an XTC "
         "(files cross RDF)", files["cross"]),
    ]
    # Slice 15: the trig sums on the single-chain S(q) path's chain-frames.
    rows.append(("trig_sums", trig_src, pallas_kernels.format(66),
                 polymer["scsf_launches"],
                 f"{POLYMER_CHAINS:,} chains x {POLYMER_MONOMERS} monomers as "
                 f"chain-frames x {n_q:,} float32 wavevectors, exact "
                 "(single-chain S(q) path; ms a frame of all chains)",
                 polymer["trig"]))
    optional = ("launch_ms", "pairs_per_frame", "counted_per_frame",
                "terms_per_frame", "plain_shape",
                "option", "oracle_err", "tolerance")
    print(f"chip_smoke.py took {time.perf_counter() - started:.1f} s "
          "(kernel build included)")
    print(card)
    print(json.dumps({"kernels": [{
        "name": kernel,
        "route": "cuda",
        "source": source,
        "replaces": line if isinstance(line, str) else tpu.format(line),
        "mode": timing["mode"],
        "shape": shape,
        "launches": n,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        **{key: timing[key] for key in optional if key in timing},
    } for kernel, source, line, n, shape, timing in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
