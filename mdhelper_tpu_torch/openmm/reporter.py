r"""
OpenMM reporters
================

NetCDF trajectory reporter for OpenMM simulations, as in
:mod:`mdhelper_tpu.openmm.reporter`.  Requires OpenMM.
"""

from typing import Union

import numpy as np
import openmm
from openmm import app, unit

from .file import NetCDFFile

__all__ = ["NetCDFReporter"]


class NetCDFReporter:
    """AMBER NetCDF trajectory reporter: time + coordinates and
    optionally velocities/forces, for all particles or a subset.

    Parameters
    ----------
    file : `str`
        Output filename (``.nc`` appended when missing).
    interval : `int`
        Report interval in timesteps.
    append : `bool`, default False
        Append to an existing file.
    periodic : `bool`, optional
        Wrap molecule centers into one periodic box (auto when None).
    velocities, forces : `bool`, keyword-only, default False
        Also write velocities / forces.
    subset : `slice`, `numpy.ndarray` or `openmm.app.Topology`, \
    keyword-only, optional
        Particle indices (or a topology whose atoms define them).
    """

    def __init__(
        self,
        file: str,
        interval: int,
        append: bool = False,
        periodic: bool = None,
        *,
        velocities: bool = False,
        forces: bool = False,
        subset: Union[slice, np.ndarray, "app.Topology"] = None,
    ) -> None:
        self._out = NetCDFFile(file, "a" if append else "w")
        self._interval = interval
        self._periodic = periodic
        self._subset = (
            np.fromiter((a.index for a in subset.atoms()), dtype=int)
            if isinstance(subset, app.Topology)
            else subset
        )
        self._velocities = velocities
        self._forces = forces

    def __del__(self) -> None:
        try:
            self._out._nc.close()
        except Exception:
            pass

    def describeNextReport(self, simulation):  # noqa: N802
        """(steps until next report, needs positions, velocities,
        forces, energies, wrap)."""

        return (
            self._interval
            - simulation.currentStep % self._interval,
            True,
            self._velocities,
            self._forces,
            False,
            self._periodic,
        )

    def report(self, simulation, state) -> None:
        """Write the current state as one trajectory frame."""

        data = {}
        sel = self._subset

        def grab(getter, target_unit):
            values = getter(asNumpy=True)
            if sel is not None:
                values = values[sel]
            return values.value_in_unit(target_unit)

        data["coordinates"] = grab(state.getPositions, unit.angstrom)
        if self._velocities:
            data["velocities"] = grab(
                state.getVelocities, unit.angstrom / unit.picosecond
            )
        if self._forces:
            data["forces"] = grab(
                state.getForces,
                unit.kilocalorie_per_mole / unit.angstrom,
            )

        if not hasattr(self._out._nc, "Conventions"):
            self._out.write_header(
                simulation.topology.getNumAtoms()
                if sel is None
                else len(data["coordinates"]),
                simulation.topology.getPeriodicBoxVectors() is not None,
                self._velocities,
                self._forces,
            )

        pbv = state.getPeriodicBoxVectors()
        if pbv is not None:
            a, b, c, alpha, beta, gamma = (
                app.internal.unitcell.computeLengthsAndAngles(pbv)
            )
            data["cell_lengths"] = 10 * np.array((a, b, c))
            data["cell_angles"] = (
                180 * np.array((alpha, beta, gamma)) / np.pi
            )

        self._out.write_model(
            state.getTime().value_in_unit(unit.picosecond),
            data["coordinates"],
            data.get("velocities"),
            data.get("forces"),
            data.get("cell_lengths"),
            data.get("cell_angles"),
        )
