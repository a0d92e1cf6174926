r"""
LAMMPS topology writers
=======================

LAMMPS data-file output in ``atom_style full``, a copy of
:mod:`mdhelper_tpu.lammps.topology` over the port's
:mod:`~mdhelper_tpu_torch.algorithm.topology`.  A flat per-atom `charges`
array is split on the per-type atom counts, as in the JAX package.
:func:`mdhelper_tpu_torch.io.topology_files.read_lammps_data` reads the
files back.
"""

from io import TextIOWrapper
from numbers import Real
from typing import Any, Union

import numpy as np

from ..algorithm import topology as _topology

__all__ = ["create_atoms", "write_data"]


def create_atoms(*args, **kwargs) -> Any:
    """Alias of
    :func:`mdhelper_tpu_torch.algorithm.topology.create_atoms`."""

    return _topology.create_atoms(*args, **kwargs)


def write_data(
    file: Union[str, TextIOWrapper],
    positions: tuple,
    *,
    bonds: tuple = None,
    angles: tuple = None,
    dihedrals: tuple = None,
    impropers: tuple = None,
    dimensions: np.ndarray = None,
    tilt: np.ndarray = None,
    charges: np.ndarray = None,
    masses: np.ndarray = None,
) -> None:
    r"""Write a LAMMPS data file (``atom_style full``).

    Header counts, box bounds (``xlo xhi`` etc.) and optional triclinic
    tilt, Masses, Atoms, Bonds/Angles/Dihedrals/Impropers sections.
    One-indexed ids; the molecule id mirrors the atom id.  The index
    arrays are written as given, so they hold one-indexed atom ids.

    Parameters
    ----------
    file : `str` or writable text file
        Output target.
    positions : `tuple` of `numpy.ndarray`
        Per-atom-type position arrays, each ``(N_t, 3)``.
    bonds, angles, dihedrals, impropers : `tuple`, keyword-only
        Per-type index arrays (``(N, 2)``/``(N, 3)``/``(N, 4)``).
    dimensions : array-like, keyword-only
        ``(3,)`` box lengths (lo = 0) or ``(3, 2)`` lo/hi bounds.
    tilt : array-like, keyword-only
        ``(xy, xz, yz)`` tilt factors.
    charges : array-like, keyword-only
        Per-type scalars, per-type arrays, or one flat per-atom array.
    masses : array-like, keyword-only
        Per-type masses.
    """

    close = False
    if isinstance(file, str):
        file = open(file, "w")
        close = True

    file.write("LAMMPS Description\n\n")
    n_atoms_type = [len(p) for p in positions]
    n_atoms = sum(n_atoms_type)
    file.write(f"{n_atoms} atoms\n")
    file.write(f"{len(positions)} atom types\n")
    if bonds is not None:
        n_bonds_type = [len(b) for b in bonds]
        file.write(f"{sum(n_bonds_type)} bonds\n")
        file.write(f"{len(bonds)} bond types\n")
    if angles is not None:
        n_angles_type = [len(a) for a in angles]
        file.write(f"{sum(n_angles_type)} angles\n")
        file.write(f"{len(angles)} angle types\n")
    if dihedrals is not None:
        n_dihedrals_type = [len(d) for d in dihedrals]
        file.write(f"{sum(n_dihedrals_type)} dihedrals\n")
        file.write(f"{len(dihedrals)} dihedral types\n")
    if impropers is not None:
        n_impropers_type = [len(i) for i in impropers]
        file.write(f"{sum(n_impropers_type)} impropers\n")
        file.write(f"{len(impropers)} improper types\n")
    if dimensions is not None:
        dimensions = np.asarray(dimensions, dtype=float)
        if dimensions.ndim == 1:
            dimensions = np.vstack((np.zeros(3), dimensions)).T
        for i, (lo, hi) in enumerate(dimensions):
            axis = chr(120 + i)
            file.write(f"{lo:.6g} {hi:.6g} {axis}lo {axis}hi\n")
    if tilt is not None:
        file.write(
            f"{tilt[0]:.6g} {tilt[1]:.6g} {tilt[2]:.6g} xy xz yz\n"
        )

    if masses is not None:
        if len(masses) != len(positions):
            raise ValueError(
                "Number of masses must match number of atom types."
            )
        file.write("\nMasses\n\n")
        for i, mass in enumerate(masses):
            file.write(f"{i + 1} {mass:.6g}\n")

    if charges is None:
        charges = np.zeros(n_atoms)
    if len(charges) == len(positions):
        charges = list(charges)
        for i, (qs, n) in enumerate(zip(charges, n_atoms_type)):
            if isinstance(qs, Real):
                charges[i] = qs * np.ones(n)
    elif len(charges) == n_atoms:
        charges = np.array_split(
            np.asarray(charges), np.cumsum(n_atoms_type)[:-1]
        )
    else:
        raise ValueError("'charges' has an invalid shape.")

    file.write("\nAtoms # full\n\n")
    for t, (pos, qs) in enumerate(zip(positions, charges)):
        start = sum(n_atoms_type[:t])
        for i, (p, q) in enumerate(zip(pos, qs)):
            atom_id = start + i + 1
            file.write(
                f"{atom_id} {atom_id} {t + 1} {q:.6g} "
                f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n"
            )

    def write_section(name, groups, counts):
        file.write(f"\n{name}\n\n")
        for t, rows in enumerate(groups):
            start = sum(counts[:t])
            for i, row in enumerate(rows):
                indices = " ".join(str(int(x)) for x in row)
                file.write(f"{start + i + 1} {t + 1} {indices}\n")

    if bonds is not None:
        write_section("Bonds", bonds, n_bonds_type)
    if angles is not None:
        write_section("Angles", angles, n_angles_type)
    if dihedrals is not None:
        write_section("Dihedrals", dihedrals, n_dihedrals_type)
    if impropers is not None:
        write_section("Impropers", impropers, n_impropers_type)

    if close:
        file.close()
