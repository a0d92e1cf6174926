"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mdhelper_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain-torch version on the card at
the main path's shapes, then drives the main path once -- the fused
RDF + S(q) + MSD pass of 100k atoms through
``mdhelper_tpu_torch.analysis.multi.run_together`` -- and checks its
results.  Every check raises on failure, so any failed phase exits
non-zero.  The last lines of standard output are the card's name and
power limit, a JSON line of per-kernel measurements, and
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
SEED = 2026


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


def phase_kernels(device, rng):
    """Kernel vs plain version at the main path's shape and on the
    edge-straddle fixture."""

    import torch

    from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch
    from mdhelper_tpu_torch.testing import (
        edge_straddle_positions,
        f64_pair_histogram,
    )

    plan = cch.cell_plan_search(N_ATOMS, [BOX] * 3, R_MAX)
    frames = torch.from_numpy(
        (rng.random((2, N_ATOMS, 3)) * BOX).astype(np.float32)
    ).to(device)
    args = dict(box=(BOX,) * 3, r_max=R_MAX,
                n_cells_dim=plan["n_cells_dim"],
                capacity=plan["capacity"], n_bins=N_BINS)
    kernel, occ = cch.cell_pair_histogram(frames, **args)
    plain, plain_occ = cch.cell_pair_histogram_reference(frames, **args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(kernel).all()), "kernel counts not finite")
    check(int(occ.max()) <= plan["capacity"], "capacity overflow")
    check(torch.equal(occ, plain_occ), "occupancy differs")
    check(torch.equal(kernel, plain),
          "kernel counts differ from the plain version")
    max_abs_err = float((kernel - plain).abs().max())
    print(f"cell plan {plan['n_cells_dim']} capacity {plan['capacity']}: "
          f"{int(kernel.sum())} ordered pairs in [0, {R_MAX}) over 2 "
          "frames; kernel == plain")

    # In turns: plain, kernel, kernel, plain (ms per 2-frame call).
    plain_ms = [time_ms(lambda: cch.cell_pair_histogram_reference(
        frames, **args), 1)]
    kernel_ms = [time_ms(lambda: cch.cell_pair_histogram(frames, **args), 5)
                 for _ in range(2)]
    plain_ms.append(time_ms(lambda: cch.cell_pair_histogram_reference(
        frames, **args), 1))
    ms = float(np.mean(kernel_ms)) / 2
    p_ms = float(np.mean(plain_ms)) / 2
    print(f"cell_pair_histogram per frame: kernel {ms:.3f} ms "
          f"(runs {[round(x / 2, 3) for x in kernel_ms]}), plain torch "
          f"{p_ms:.3f} ms (runs {[round(x / 2, 3) for x in plain_ms]})")

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
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": p_ms}


def direct_msd(pos):
    """float64 direct-lag MSD of (T, N, 3) positions, averaged over
    origins and particles."""

    t = pos.shape[0]
    return np.array([
        ((pos[m:] - pos[:t - m]) ** 2).sum(-1).mean() for m in range(t)
    ])


def slice_universe(rng):
    """The main path's trajectory: N_FRAMES frames of N_ATOMS uniform
    float32 atoms in the cubic box, as an in-memory universe."""

    from mdhelper_tpu_torch.core.universe import Universe

    traj = rng.random((N_FRAMES, N_ATOMS, 3), dtype=np.float32) * np.float32(
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


def run_timed(analyses):
    """``run_together(analyses)``; returns frames/s clocked from the end
    of the first chunk to the end of the conclusions."""

    import torch

    from mdhelper_tpu_torch.analysis.multi import run_together

    marks = []

    def on_chunk(batch):
        if not marks:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    run_together(analyses, on_chunk=on_chunk)
    return (N_FRAMES - CHUNK) / (time.perf_counter() - marks[0])


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
    timing = phase_kernels(device, rng)
    launches, fps = phase_slice(device, rng)
    print(f"fused RDF+S(q)+MSD: {fps:.3f} frames/s on {card} "
          "(information, not a claim)")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "cell_pair_histogram",
        "route": "cuda",
        "source": "mdhelper_tpu_torch/csrc/cell_pair_histogram.cu",
        "replaces": "mdhelper_tpu/ops/pallas_cell_histogram.py:1070",
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
