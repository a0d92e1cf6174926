r"""
AMBER NetCDF trajectory and restart files
=========================================

Reader/writer for the AMBER NetCDF Trajectory/Restart Convention v1.0,
as :mod:`mdhelper_tpu.openmm.file`, built on the port's dependency-free
NetCDF-3 codec (:mod:`mdhelper_tpu_torch.io.netcdf3`).  The two
packages write the same bytes, and each reads the other's files.

Works without OpenMM: only :meth:`NetCDFFile.write_file` (which takes
an ``openmm.State``) requires it.  When OpenMM is present, unit-tagged
getters return ``openmm.unit`` quantities; otherwise this package's own
:class:`~mdhelper_tpu_torch.units.Quantity` objects are used.
"""

import platform
import warnings
from typing import Any, Union

import numpy as np

from .. import FOUND_OPENMM, VERSION, ureg
from ..io.netcdf3 import Dataset

if FOUND_OPENMM:
    import openmm
    from openmm import app, unit

__all__ = ["NetCDFFile"]


def _unit(name: str):
    """Pick the openmm unit when available, else the native one."""

    if FOUND_OPENMM:
        return {
            "angstrom": unit.angstrom,
            "picosecond": unit.picosecond,
            "degree": unit.degree,
            "angstrom/picosecond": unit.angstrom / unit.picosecond,
            "kilocalorie_per_mole/angstrom": (
                unit.kilocalorie_per_mole / unit.angstrom
            ),
        }[name]
    return {
        "angstrom": ureg.angstrom,
        "picosecond": ureg.picosecond,
        "degree": ureg.degree,
        "angstrom/picosecond": ureg.angstrom / ureg.picosecond,
        "kilocalorie_per_mole/angstrom": (
            ureg.kilocalorie / (ureg.mole * ureg.angstrom)
        ),
    }[name]


class NetCDFFile:
    """Interface for AMBER NetCDF trajectory and restart files.

    Parameters
    ----------
    file : `str` or :class:`mdhelper_tpu_torch.io.netcdf3.Dataset`
        NetCDF file (``.nc`` appended to bare filenames).
    mode : `str`
        ``"r"``, ``"w"`` or ``"a"``.
    restart : `bool`, default False
        Restart (single-frame, double-precision) vs trajectory file.
    """

    def __init__(
        self, file, mode: str, restart: bool = False, **kwargs
    ) -> None:
        if isinstance(file, str):
            if not file.endswith((".nc", ".ncdf")):
                file += ".nc"
            self._nc = Dataset(
                file, mode=mode, format="NETCDF3_64BIT_OFFSET", **kwargs
            )
        else:
            self._nc = file
        self._nc.set_always_mask(False)

        if mode == "r":
            self._frame = self._nc.variables["time"].shape[0]
            self._restart = self._nc.Conventions == "AMBERRESTART"
        elif mode == "a":
            self._frame = (
                self._nc.variables["time"].shape[0]
                if "time" in self._nc.variables
                else 0
            )
            self._restart = (
                getattr(self._nc, "Conventions", "") == "AMBERRESTART"
            )
        else:
            self._frame = 0
            self._restart = restart

    # -- getters -----------------------------------------------------------
    def get_dimensions(self, frames=None, units: bool = True):
        """Simulation box lengths (A) and angles (deg)."""

        lengths = (
            self._nc.variables["cell_lengths"][:]
            if frames is None
            else self._nc.variables["cell_lengths"][frames]
        )
        angles = (
            self._nc.variables["cell_angles"][:]
            if frames is None
            else self._nc.variables["cell_angles"][frames]
        )
        if units:
            return (
                lengths * _unit("angstrom"),
                angles * _unit("degree"),
            )
        return lengths, angles

    def get_num_frames(self) -> int:
        return self._nc.dimensions["frame"].size

    def get_num_atoms(self) -> int:
        return self._nc.dimensions["atom"].size

    def get_times(self, frames=None, units: bool = True):
        times = (
            self._nc.variables["time"][:]
            if frames is None
            else self._nc.variables["time"][frames]
        )
        return times * _unit("picosecond") if units else times

    def get_positions(self, frames=None, units: bool = True):
        positions = (
            self._nc.variables["coordinates"][:]
            if frames is None
            else self._nc.variables["coordinates"][frames]
        )
        return positions * _unit("angstrom") if units else positions

    def get_velocities(self, frames=None, units: bool = True):
        if "velocities" not in self._nc.variables:
            warnings.warn(
                "The NetCDF file does not contain information about "
                "the atom velocities."
            )
            return None
        velocities = (
            self._nc.variables["velocities"][:]
            if frames is None
            else self._nc.variables["velocities"][frames]
        )
        if units:
            return velocities * _unit("angstrom/picosecond")
        return velocities

    def get_forces(self, frames=None, units: bool = True):
        if "forces" not in self._nc.variables:
            warnings.warn(
                "The NetCDF file does not contain information about "
                "the forces acting on the atoms."
            )
            return None
        forces = (
            self._nc.variables["forces"][:]
            if frames is None
            else self._nc.variables["forces"][frames]
        )
        if units:
            return forces * _unit("kilocalorie_per_mole/angstrom")
        return forces

    # -- writers -----------------------------------------------------------
    def write_header(
        self: Any,
        N: int,
        cell: bool,
        velocities: bool,
        forces: bool,
        restart: bool = False,
        *,
        remd: str = None,
        temp0: float = None,
        remd_dimtype=None,
        remd_indices=None,
        remd_repidx: int = -1,
        remd_crdidx: int = -1,
        remd_values=None,
    ) -> "NetCDFFile":
        """Initialize headers per AMBER NetCDF Convention v1.0 rev C
        (incl. the REMD variables).  Usable as a static method with a
        filename."""

        if not isinstance(self, NetCDFFile):
            self = NetCDFFile(self, "w", restart=restart)

        nc = self._nc
        nc.Conventions = (
            "AMBERRESTART" if self._restart else "AMBER"
        )
        nc.ConventionVersion = "1.0"
        nc.program = "MDHelper-TPU"
        nc.programVersion = VERSION
        engine = (
            f"OpenMM {openmm.Platform.getOpenMMVersion()}"
            if FOUND_OPENMM
            else "MDHelper-TPU"
        )
        nc.title = f"{engine} / {platform.node()}"

        nc.createDimension("frame", 1 if self._restart else None)
        if remd == "multi":
            nc.createDimension("remd_dimension", len(remd_dimtype))
        nc.createDimension("spatial", 3)
        nc.createDimension("atom", N)

        if self._restart:
            nc.createVariable("coordinates", "d", ("atom", "spatial"))
        else:
            nc.createVariable(
                "coordinates", "f", ("frame", "atom", "spatial")
            )
        nc.variables["coordinates"].units = "angstrom"

        nc.createVariable("time", "d", ("frame",))
        nc.variables["time"].units = "picosecond"

        if cell:
            nc.createDimension("cell_spatial", 3)
            nc.createDimension("cell_angular", 3)
            nc.createDimension("label", 5)
            nc.createVariable("spatial", "c", ("spatial",))
            nc.variables["spatial"][:] = list("xyz")
            nc.createVariable("cell_spatial", "c", ("cell_spatial",))
            nc.variables["cell_spatial"][:] = list("abc")
            nc.createVariable(
                "cell_angular", "c", ("cell_angular", "label")
            )
            nc.variables["cell_angular"][:] = [
                list("alpha"), list("beta "), list("gamma"),
            ]
            if self._restart:
                nc.createVariable(
                    "cell_lengths", "d", ("cell_spatial",)
                )
                nc.createVariable("cell_angles", "d", ("cell_angular",))
            else:
                nc.createVariable(
                    "cell_lengths", "f", ("frame", "cell_spatial")
                )
                nc.createVariable(
                    "cell_angles", "f", ("frame", "cell_angular")
                )
            nc.variables["cell_lengths"].units = "angstrom"
            nc.variables["cell_angles"].units = "degree"

        if velocities:
            if self._restart:
                nc.createVariable(
                    "velocities", "d", ("atom", "spatial")
                )
            else:
                nc.createVariable(
                    "velocities", "f", ("frame", "atom", "spatial")
                )
            nc.variables["velocities"].units = "angstrom/picosecond"
            nc.variables["velocities"].scale_factor = 20.455

        if forces:
            if self._restart:
                nc.createVariable("forces", "d", ("atom", "spatial"))
            else:
                nc.createVariable(
                    "forces", "f", ("frame", "atom", "spatial")
                )
            nc.variables["forces"].units = "kilocalorie/mole/angstrom"

        if remd is not None:
            if remd == "temp":
                nc.createVariable("temp0", "d", ("frame",))
                if self._restart:
                    if temp0 is None:
                        raise ValueError(
                            "Temperature must be provided for a REMD "
                            "restart file."
                        )
                    nc.variables["temp0"][0] = temp0
                nc.variables["temp0"].units = "kelvin"
            elif remd == "multi":
                nc.createVariable(
                    "remd_dimtype", "i", ("remd_dimension",)
                )
                nc.createVariable("remd_repidx", "i", ("frame",))
                nc.createVariable("remd_crdidx", "i", ("frame",))
                if self._restart:
                    if remd_dimtype is None:
                        raise ValueError(
                            "Dimension types must be provided for a "
                            "multi-dimensional REMD restart file."
                        )
                    nc.variables["remd_dimtype"][:] = remd_dimtype
                    nc.createVariable(
                        "remd_indices", "i", ("remd_dimension",)
                    )
                    if remd_indices is None:
                        raise ValueError(
                            "Dimension indices must be provided for a "
                            "multi-dimensional REMD restart file."
                        )
                    nc.variables["remd_indices"][:] = remd_indices
                    nc.variables["remd_repidx"][0] = remd_repidx
                    nc.variables["remd_crdidx"][0] = remd_crdidx
                    nc.createVariable(
                        "remd_values", "d", ("remd_dimension",)
                    )
                    if remd_values is None:
                        raise ValueError(
                            "Replica values must be provided for a "
                            "multi-dimensional REMD restart file."
                        )
                    nc.variables["remd_values"][:] = remd_values
                else:
                    nc.createVariable(
                        "remd_indices", "i",
                        ("frame", "remd_dimension"),
                    )
                    nc.createVariable(
                        "remd_values", "d",
                        ("frame", "remd_dimension"),
                    )
        return self

    def write_file(self: Any, state) -> "NetCDFFile":
        """Write one ``openmm.State`` to a restart file (requires
        OpenMM)."""

        if not FOUND_OPENMM:
            raise ImportError(
                "OpenMM is required to write a State to a restart file."
            )
        data = {}
        pbv = state.getPeriodicBoxVectors()
        if pbv is not None:
            a, b, c, alpha, beta, gamma = (
                app.internal.unitcell.computeLengthsAndAngles(pbv)
            )
            data["cell_lengths"] = 10 * np.array((a, b, c))
            data["cell_angles"] = (
                180 * np.array((alpha, beta, gamma)) / np.pi
            )
        data["coordinates"] = state.getPositions(
            asNumpy=True
        ).value_in_unit(unit.angstrom)
        try:
            data["velocities"] = state.getVelocities(
                asNumpy=True
            ).value_in_unit(unit.angstrom / unit.picosecond)
        except openmm.OpenMMException:
            pass
        try:
            data["forces"] = state.getForces(
                asNumpy=True
            ).value_in_unit(unit.kilocalorie_per_mole / unit.angstrom)
        except openmm.OpenMMException:
            pass

        if not isinstance(self, NetCDFFile):
            self = NetCDFFile(self, "w", restart=True)
        if not hasattr(self._nc, "Conventions"):
            self.write_header(
                data["coordinates"].shape[0],
                "cell_lengths" in data or "cell_angles" in data,
                "velocities" in data,
                "forces" in data,
            )
        elif self._nc.Conventions != "AMBERRESTART":
            raise ValueError("The NetCDF file must be a restart file.")

        for key, value in data.items():
            self._nc.variables[key][:] = value
        self._nc.sync()
        return self

    def write_model(
        self: Any,
        time,
        coordinates,
        velocities=None,
        forces=None,
        cell_lengths=None,
        cell_angles=None,
        *,
        restart: bool = False,
    ) -> "NetCDFFile":
        """Append frame(s) to a trajectory file (usable as a static
        method with a filename)."""

        if not isinstance(self, NetCDFFile):
            self = NetCDFFile(self, "w", restart=restart)
        if not hasattr(self._nc, "Conventions"):
            self.write_header(
                np.asarray(coordinates).shape[-2],
                cell_lengths is not None or cell_angles is not None,
                velocities is not None,
                forces is not None,
            )

        n_frames = (
            len(time)
            if isinstance(time, (tuple, list, np.ndarray))
            else 1
        )
        frames = slice(self._frame, self._frame + n_frames)
        self._nc.variables["time"][frames] = time
        self._nc.variables["coordinates"][frames] = coordinates
        if velocities is not None:
            self._nc.variables["velocities"][frames] = velocities
        if forces is not None:
            self._nc.variables["forces"][frames] = forces
        if cell_lengths is not None:
            self._nc.variables["cell_lengths"][frames] = cell_lengths
        if cell_angles is not None:
            self._nc.variables["cell_angles"][frames] = cell_angles
        self._nc.sync()
        if not restart:
            self._frame += n_frames
        return self

    def close(self) -> None:
        self._nc.close()
