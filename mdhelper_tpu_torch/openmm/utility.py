r"""
OpenMM utilities
================

The PME auto-tuner: benchmarks integrator wall time across FFT-legal
mesh/cutoff combinations and CPU-vs-GPU reciprocal space, as in
:mod:`mdhelper_tpu.openmm.utility`.  Requires OpenMM.
"""

from __future__ import annotations

import itertools
import logging
from datetime import datetime
from typing import Union

import numpy as np

try:
    import openmm
    from openmm import unit
except ImportError:  # pragma: no cover
    openmm = unit = None

__all__ = ["optimize_pme"]


def _create_context(
    system, integrator, positions, platform, properties
) -> openmm.Context:
    """Fresh context with a cloned integrator (contexts consume their
    integrator)."""

    integrator = openmm.XmlSerializer.clone(integrator)
    context = openmm.Context(system, integrator, platform, properties)
    context.setPositions(positions)
    return context


def _benchmark_integrator(context, steps: int) -> float:
    """Wall seconds for `steps` integrator steps."""

    start = datetime.now()
    context.getIntegrator().step(steps)
    return (datetime.now() - start).total_seconds()


def _fft_legal_mesh_sizes(start: int = 5):
    """Yield (n_mesh, pure235) for mesh sizes whose prime factors are
    {2,3,5,7} with at most one 11 or 13 (cuFFT rule); `pure235` marks
    sizes legal for the GPU path."""

    for n_mesh in itertools.count(start=start):
        check = n_mesh
        for factor in (2, 3, 5, 7):
            while check > 1 and check % factor == 0:
                check /= factor
        if check in (1, 11, 13):
            yield n_mesh, check == 1


def optimize_pme(
    system: openmm.System,
    integrator: openmm.Integrator,
    positions,
    platform: openmm.Platform,
    properties: dict,
    min_cutoff,
    max_cutoff,
    *,
    pmeforce=None,
    cpu_pme: bool = True,
    target: float = 10,
    target_std: float = None,
    window: int = 3,
    fastest: int = 5,
    rerun: int = 2,
    verbose: bool = True,
) -> tuple:
    r"""Find the fastest PME real-space cutoff (and whether to compute
    reciprocal space on the CPU) by timing integrator steps over the
    FFT-legal cutoff grid.

    It calibrates the step count to ~`target` seconds, sweeps the cutoffs
    derived from legal mesh sizes (stopping `window` consecutive slowdowns
    past the minimum), reruns the `fastest` few `rerun` times, and logs a
    ranked table.

    Returns ``(best_cutoff, use_cpu_pme)``.
    """

    if openmm is None:
        raise ImportError("OpenMM is required for optimize_pme.")

    logging.basicConfig(
        format="{asctime} | {levelname:^8s} | {message}",
        style="{",
        level=logging.INFO if verbose else logging.WARNING,
    )

    if pmeforce is None:
        for force in system.getForces():
            if isinstance(
                force,
                (openmm.NonbondedForce, openmm.AmoebaMultipoleForce),
            ):
                pmeforce = force
                break
    if pmeforce.getNonbondedMethod() != openmm.NonbondedForce.PME:
        raise ValueError(
            "The provided (or guessed) pair potential is not being "
            "evaluated using the particle mesh Ewald (PME) method."
        )
    cpu_pme &= isinstance(
        pmeforce, openmm.NonbondedForce
    ) and platform.supportsKernels(["CalcPmeReciprocalForce"])
    tol = pmeforce.getEwaldErrorTolerance()

    # Calibrate a step count that runs for ~target seconds.
    logging.info(
        "Determining a reasonable number of timesteps for PME "
        "optimizer..."
    )
    pmeforce.setCutoffDistance(np.sqrt(min_cutoff * max_cutoff))
    if target_std is None:
        target_std = 0.1 * target
    lb, ub = target - target_std, target + target_std
    time_width = max(9, int(np.ceil(np.log10(target))) + 7)

    def calibrate(use_cpu: str) -> int:
        properties["UseCpuPme"] = use_cpu
        context = _create_context(
            system, integrator, positions, platform, properties
        )
        steps = 20
        while True:
            elapsed = _benchmark_integrator(context, steps)
            label = "CPU" if use_cpu == "true" else "GPU"
            logging.info(
                f"  {label}: {steps:14,} ts ===> "
                f"{elapsed:{time_width}.5f} s elapsed"
            )
            if lb < elapsed < ub:
                return steps
            steps = int(target * steps / elapsed)

    steps = calibrate("false")
    if cpu_pme:
        steps = min(steps, calibrate("true"))
    steps = int(
        np.round(steps, 2 - int(np.ceil(np.log10(steps))))
    )
    logging.info(f"Starting PME optimizer (using {steps:,} timesteps)...")

    if isinstance(min_cutoff, unit.Quantity):
        min_cutoff = min_cutoff.value_in_unit(unit.nanometer)
    if isinstance(max_cutoff, unit.Quantity):
        max_cutoff = max_cutoff.value_in_unit(unit.nanometer)

    # Candidate cutoffs from the legal mesh sizes along each box axis.
    cutoffs = {"gpu": {min_cutoff}}
    if cpu_pme:
        cutoffs["cpu"] = {min_cutoff}
    box = [
        v[i].value_in_unit(unit.nanometer)
        for i, v in enumerate(system.getDefaultPeriodicBoxVectors())
    ]
    for dim in box:
        for n_mesh, pure235 in _fft_legal_mesh_sizes():
            alpha = 1.5 * n_mesh * tol**0.2 / dim
            cutoff = np.round(np.sqrt(-np.log(2 * tol) / alpha), 3)
            if cutoff < min_cutoff:
                break
            if cutoff < max_cutoff:
                if cpu_pme:
                    cutoffs["cpu"].add(cutoff)
                if pure235:
                    cutoffs["gpu"].add(cutoff)

    cutoff_width = max(
        7,
        int(
            np.ceil(
                np.log10(max(max(v) for v in cutoffs.values()))
            )
        )
        + 6,
    )

    # Sweep, aborting after `window` consecutive slowdowns.
    times = {}
    for arch in cutoffs:
        cutoffs[arch] = np.array(sorted(cutoffs[arch]))
        times[arch] = np.full(cutoffs[arch].shape, np.nan)
        for i, cutoff in enumerate(cutoffs[arch]):
            pmeforce.setCutoffDistance(cutoff)
            properties["UseCpuPme"] = str(arch == "cpu").lower()
            context = _create_context(
                system, integrator, positions, platform, properties
            )
            times[arch][i] = _benchmark_integrator(context, steps)
            logging.info(
                f"  {arch.upper()}: {cutoff:{cutoff_width}.4f} nm "
                f"cutoff ===> {times[arch][i]:{time_width}.5f} s "
                "elapsed"
            )
            if i > window and np.all(
                times[arch][i - window:i]
                > times[arch][i - window - 1:i - 1]
            ):
                break

    # Rerun the finalists and rank by median.
    best = sorted(
        [t, c, a]
        for a in times
        for c, t in zip(cutoffs[a], times[a])
    )[:fastest]
    for i, (elapsed, cutoff, arch) in enumerate(best):
        pmeforce.setCutoffDistance(cutoff)
        properties["UseCpuPme"] = str(arch == "cpu").lower()
        context = _create_context(
            system, integrator, positions, platform, properties
        )
        best[i][0] = sorted(
            (
                elapsed,
                *[
                    _benchmark_integrator(context, steps)
                    for _ in range(rerun)
                ],
            )
        )[1]
    best.sort()

    time_width = 8 + 2 * int(np.ceil(max(0, time_width - 8) // 2))
    cutoff_width = 11 + 2 * int(
        np.ceil(max(0, cutoff_width - 11) // 2)
    )
    table = "\n  ".join(
        f" {i + 1:>4} | {elapsed:{time_width}.5f} | "
        f"{cutoff:{cutoff_width}.4f} | {arch == 'cpu'}"
        for i, (elapsed, cutoff, arch) in enumerate(best)
    )
    logging.info(
        "PME optimization completed.\n"
        f"   Rank | {'Time (s)':^{time_width}} | "
        f"{'Cutoff (nm)':^{cutoff_width}} | CPU PME\n"
        f"  ------|{'-' * (time_width + 2)}|"
        f"{'-' * (cutoff_width + 2)}|---------\n  " + table
    )
    best_time, best_cutoff, best_arch = best[0]
    return best_cutoff * unit.nanometer, best_arch == "cpu"
