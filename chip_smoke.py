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
function; and it checks their results.  Every check raises on failure,
so any failed phase exits non-zero.  The last lines of standard output
are the card's name and power limit, a JSON line of per-kernel
measurements (each beside its bound: the larger of the float32
operations of the pairs binned over the card's float32 peak and the
bytes of the slot tables and counts over its memory rate), and
``{"ok": true, "device": {...}}``.

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

#: float32 operations of one binned pair, counted in csrc/cell_bin.cuh.
OPS_PER_PAIR = {False: 254, True: 245}
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


def bound(pairs, n_bytes, triclinic, n_frames):
    """The least time a frame could take on the card for a kernel's
    work (``bound_ms``, and ``bound_by``, the larger term): `pairs`
    binned slot pairs times the float32 operations of one pair over the
    float32 peak, against `n_bytes` (the slot tables read once and the
    counts written once) over the memory rate, both over `n_frames`.
    No single PyTorch call computes a binned cell-list pair histogram,
    so ``library_ms`` is None."""

    ops_ms = pairs * OPS_PER_PAIR[triclinic] / PEAK_F32 * 1e3 / n_frames
    bytes_ms = n_bytes / PEAK_BYTES * 1e3 / n_frames
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "pairs_per_frame": pairs / n_frames,
    }


def kernel_vs_plain(kernel, plain, n_frames, what, work):
    """Run a kernel wrapper and its plain version on the same inputs
    (each a no-argument call returning ``(counts, *occupancies)``),
    check that every output is equal as integers, then time them in
    turns -- plain, kernel, kernel, plain -- in ms per frame, beside
    the bound of `work` (:func:`bound`)."""

    import torch

    k_out, p_out = kernel(), plain()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k_out[0]).all()), f"{what}: counts not finite")
    for k, p in zip(k_out, p_out):
        check(torch.equal(k, p), f"{what}: kernel differs from plain")
    max_abs_err = float((k_out[0] - p_out[0]).abs().max())
    plain_ms = [time_ms(plain, 1)]
    kernel_ms = [time_ms(kernel, 5) for _ in range(2)]
    plain_ms.append(time_ms(plain, 1))
    out = {
        "max_abs_err": max_abs_err,
        "ms": float(np.mean(kernel_ms)) / n_frames,
        "plain_ms": float(np.mean(plain_ms)) / n_frames,
        **work,
    }
    print(f"{what}: {int(k_out[0].sum())} pairs in [0, r_max) over "
          f"{n_frames} frame(s), kernel == plain; per frame kernel "
          f"{out['ms']:.3f} ms (runs "
          f"{[round(x / n_frames, 3) for x in kernel_ms]}), plain torch "
          f"{out['plain_ms']:.3f} ms (runs "
          f"{[round(x / n_frames, 3) for x in plain_ms]}); "
          f"{out['pairs_per_frame']:.0f} slot pairs binned a frame, bound "
          f"{out['bound_ms']:.3f} ms by {out['bound_by']} "
          f"({100 * out['bound_ms'] / out['ms']:.1f} % of the kernel's "
          "time)")
    return out, k_out


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


def self_kernel_vs_plain(frames, box, what):
    """The self kernel (triclinic for a box matrix) against its plain
    version on the (B, N, 3) device frames."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    triclinic = np.ndim(box) == 2
    n_frames, n_atoms = frames.shape[:2]
    plan = cch.cell_plan_search(n_atoms, plan_extents(box), R_MAX)
    kernel, plain = (
        (cch.triclinic_cell_pair_histogram,
         cch.triclinic_cell_pair_histogram_reference) if triclinic
        else (cch.cell_pair_histogram, cch.cell_pair_histogram_reference)
    )
    args = dict(box=box, r_max=R_MAX, n_cells_dim=plan["n_cells_dim"],
                capacity=plan["capacity"], n_bins=N_BINS)
    pairs = cch.swept_pairs(frames, box=box, n_cells_dim=plan["n_cells_dim"],
                            triclinic=triclinic)
    n_bytes = n_frames * (16 * plan["n_cells"] * plan["capacity"]
                          + 4 * plan["n_cells"] + 8 * N_BINS)
    out, (_, occ) = kernel_vs_plain(
        lambda: kernel(frames, **args), lambda: plain(frames, **args),
        n_frames,
        f"{what}, plan {plan['n_cells_dim']} capacity {plan['capacity']}",
        bound(pairs, n_bytes, triclinic, n_frames),
    )
    check(int(occ.max()) <= plan["capacity"], "capacity overflow")
    return out


def cross_kernel_vs_plain(frames1, frames2, box, what, exclusion=None):
    """The cross kernel (triclinic for a box matrix) against its plain
    version on the given (B, N1, 3) and (B, N2, 3) device frames."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    triclinic = np.ndim(box) == 2
    n_frames = frames1.shape[0]
    plan = cch.cell_plan_search(frames1.shape[1], plan_extents(box), R_MAX,
                                n_atoms2=frames2.shape[1])
    kernel, plain = (
        (cch.triclinic_cross_pair_histogram,
         cch.triclinic_cross_pair_histogram_reference) if triclinic
        else (cch.cross_pair_histogram, cch.cross_pair_histogram_reference)
    )
    args = dict(box=box, r_max=R_MAX,
                n_cells_dim=plan["n_cells_dim"],
                capacity1=plan["capacity"], capacity2=plan["capacity2"],
                n_bins=N_BINS, exclusion=exclusion)
    pairs = cch.swept_pairs(frames1, frames2, box=box,
                            n_cells_dim=plan["n_cells_dim"],
                            triclinic=triclinic)
    n_bytes = n_frames * (
        16 * plan["n_cells"] * (plan["capacity"] + plan["capacity2"])
        + 8 * plan["n_cells"] + 8 * N_BINS
    )
    out, (_, occ1, occ2) = kernel_vs_plain(
        lambda: kernel(frames1, frames2, **args),
        lambda: plain(frames1, frames2, **args),
        n_frames,
        f"{what}, plan {plan['n_cells_dim']} capacities "
        f"{plan['capacity']}/{plan['capacity2']}",
        bound(pairs, n_bytes, triclinic, n_frames),
    )
    check(int(occ1.max()) <= plan["capacity"]
          and int(occ2.max()) <= plan["capacity2"], "capacity overflow")
    return out


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


def slice_analyses(u, device, parts=("rdf", "sq", "msd")):
    """The main path's analyses (those named in `parts`, in that
    order), with the benchmark's settings and CHUNK-frame chunks."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        StructureFactor,
    )
    from mdhelper_tpu_torch.analysis.transport import Onsager

    make = {
        "rdf": lambda: RadialDistributionFunction(
            u.atoms, n_bins=N_BINS, range=(0.0, R_MAX), exclusion=(1, 1),
            verbose=False, device=device,
        ),
        "sq": lambda: StructureFactor(
            u.atoms, n_points=N_QPTS, sort=False, unique=False,
            method="factor", precision="exact", verbose=False,
            device=device,
        ),
        "msd": lambda: Onsager(u.atoms, unwrap=True, verbose=False,
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
    """Set every kernel wrapper's launch count to 0."""

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch

    for kernel in (cch.cell_pair_histogram, cch.cross_pair_histogram,
                   cch.triclinic_cell_pair_histogram,
                   cch.triclinic_cross_pair_histogram):
        kernel.launches = 0


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


def main():
    import torch

    from mdhelper_tpu_torch._device import require_cuda
    from mdhelper_tpu_torch.ops import _build

    device = require_cuda()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    _build.load_library()
    info = _build.build_info()
    print(f"kernels built in {info['seconds']:.1f} s: {info['path']}")
    print(info["log"].strip())

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

    self_src = "mdhelper_tpu_torch/csrc/cell_pair_histogram.cu"
    cross_src = "mdhelper_tpu_torch/csrc/cross_pair_histogram.cu"
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
        ("triclinic_cell_pair_histogram", self_src, 1180, tri_self_launches,
         f"{N_ATOMS} atoms, dodecahedron (triclinic self-RDF path)",
         tri_timing["self"]),
        ("triclinic_cell_pair_histogram", self_src, 1419, tri_self_launches,
         f"{STREAM_ATOMS} atoms, dodecahedron", tri_timing["self_stream"]),
        ("triclinic_cross_pair_histogram", cross_src, 1262,
         tri_cross_launches,
         f"{N_ATOMS // 2} x {N_ATOMS // 2}, dodecahedron (triclinic "
         "cross-RDF path)", tri_timing["rdf"]),
        ("triclinic_cross_pair_histogram", cross_src, 1262, tri_vh_launches,
         f"{N_ATOMS} x {N_ATOMS}, exclusion (1, 1), dodecahedron "
         "(triclinic Van Hove path)", tri_timing["vanhove"]),
        ("triclinic_cross_pair_histogram", cross_src, 1542,
         tri_cross_launches + tri_vh_launches,
         f"{STREAM_ATOMS // 2} x {STREAM_ATOMS // 2}, dodecahedron",
         tri_timing["cross_stream"]),
    ]
    print(card)
    print(json.dumps({"kernels": [{
        "name": kernel,
        "route": "cuda",
        "source": source,
        "replaces": tpu.format(line),
        "shape": shape,
        "launches": n,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "pairs_per_frame": timing["pairs_per_frame"],
    } for kernel, source, line, n, shape, timing in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
