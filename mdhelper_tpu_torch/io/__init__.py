"""
File formats
============

Dependency-free byte-level codecs backing the trajectory I/O layer:
NetCDF-3 (AMBER), DCD (CHARMM/NAMD/X-PLOR), XTC (GROMACS compressed,
with a C++ fast path), TRR (GROMACS full precision), LAMMPS text
dumps, and the PSF/PDB/GRO/LAMMPS-data/GROMACS-top topology parsers.
"""

from . import (  # noqa: F401
    dcd,
    lammps_dump,
    netcdf3,
    structure_writers,
    topology_files,
    trr,
    xtc,
)
from .netcdf3 import Dataset  # noqa: F401
from .structure_writers import write_gro, write_pdb, write_xyz  # noqa: F401


def open_trajectory_writer(filename: str, n_atoms: int = None, **kwargs):
    """Streaming trajectory writer dispatched by extension — append
    frames one at a time without materializing the trajectory (the
    MDAnalysis ``Writer`` idiom):

    - ``.dcd`` — :class:`~mdhelper_tpu_torch.io.dcd.DCDWriter` (Angstrom;
      requires `n_atoms`, the header is patched with the frame count
      on close);
    - ``.xtc`` — :class:`~mdhelper_tpu_torch.io.xtc.XTCWriter` (nm,
      compressed);
    - ``.trr`` — :class:`~mdhelper_tpu_torch.io.trr.TRRWriter` (nm, full
      precision, optional velocities/forces).

    Use as a context manager::

        with open_trajectory_writer("out.xtc") as w:
            for frame, box in stream:
                w.write(frame, box)
    """

    lower = filename.lower()
    if lower.endswith(".dcd"):
        if n_atoms is None:
            raise ValueError(
                "The DCD header needs n_atoms up front; pass "
                "open_trajectory_writer(filename, n_atoms=...)."
            )
        from .dcd import DCDWriter

        return DCDWriter(filename, n_atoms, **kwargs)
    if lower.endswith(".xtc"):
        from .xtc import XTCWriter

        return XTCWriter(filename, n_atoms=n_atoms, **kwargs)
    if lower.endswith(".trr"):
        from .trr import TRRWriter

        return TRRWriter(filename, n_atoms=n_atoms, **kwargs)
    stem = lower[:-3] if lower.endswith(".gz") else lower
    if stem.endswith((".dump", ".lammpstrj")):
        from .lammps_dump import LAMMPSDumpWriter

        return LAMMPSDumpWriter(filename, **kwargs)
    raise ValueError(
        f"Unsupported trajectory-writer format: '{filename}' "
        "(supported: .dcd, .xtc, .trr, .dump/.lammpstrj[.gz])."
    )

__all__ = [
    "netcdf3",
    "dcd",
    "xtc",
    "trr",
    "lammps_dump",
    "topology_files",
    "structure_writers",
    "Dataset",
    "write_pdb",
    "write_gro",
    "write_xyz",
    "open_trajectory_writer",
]
