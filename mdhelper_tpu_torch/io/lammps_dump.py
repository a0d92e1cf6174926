"""
LAMMPS dump reader
==================

Text-format LAMMPS dump (``dump atom`` / ``dump custom``) reader —
the natural input for the reference's LAMMPS-facing half
(``lammps/topology.py`` writes the data files;
``analysis/thermodynamics.py`` parses the logs; this closes the loop
on trajectories).  Handles:

- arbitrary ``ITEM: ATOMS`` column layouts (columns are declared in
  the header): ``x y z`` (wrapped), ``xs ys zs`` (scaled),
  ``xu yu zu`` (unwrapped), and image flags ``ix iy iz``;
- orthogonal and triclinic ``BOX BOUNDS`` (with xy/xz/yz tilts; the
  bounding-box extents are converted back to the cell vectors per the
  LAMMPS ``How-to triclinic`` convention);
- unsorted dumps (rows are re-ordered by the ``id`` column);
- gzip-compressed files (``.gz``).
"""

import gzip
from typing import Sequence

import numpy as np

__all__ = ["LAMMPSDumpFile", "read_lammps_dump",
           "LAMMPSDumpWriter", "write_lammps_dump"]


def _open(filename: str):
    if filename.endswith(".gz"):
        return gzip.open(filename, "rt")
    return open(filename)


class LAMMPSDumpFile:
    """A LAMMPS text dump opened for reading (frame offsets indexed on
    open; frames parse lazily)."""

    def __init__(self, filename: str):
        self.filename = filename
        with _open(filename) as fh:
            self._lines = fh.read().splitlines()
        self._index()

    def _index(self) -> None:
        self._frames = []  # line offsets of "ITEM: TIMESTEP"
        self.steps = []
        lines = self._lines
        i = 0
        n_atoms_ref = None
        while i < len(lines):
            if not lines[i].startswith("ITEM: TIMESTEP"):
                raise ValueError(
                    f"Expected 'ITEM: TIMESTEP' at line {i + 1} of "
                    f"'{self.filename}'."
                )
            step = int(lines[i + 1])
            if not lines[i + 2].startswith("ITEM: NUMBER OF ATOMS"):
                raise ValueError(
                    "Expected 'ITEM: NUMBER OF ATOMS' at line "
                    f"{i + 3}."
                )
            n_atoms = int(lines[i + 3])
            if n_atoms_ref is None:
                n_atoms_ref = n_atoms
            elif n_atoms != n_atoms_ref:
                raise ValueError(
                    "Variable atom counts are not supported."
                )
            self._frames.append(i)
            self.steps.append(step)
            # BOX BOUNDS: 3 lines; then ATOMS header + n_atoms rows.
            i += 4
            if not lines[i].startswith("ITEM: BOX BOUNDS"):
                raise ValueError(f"Expected 'ITEM: BOX BOUNDS' at line {i + 1}.")
            i += 4
            if not lines[i].startswith("ITEM: ATOMS"):
                raise ValueError(f"Expected 'ITEM: ATOMS' at line {i + 1}.")
            i += 1 + n_atoms
        self.n_atoms = int(n_atoms_ref or 0)
        self.n_frames = len(self._frames)
        self.steps = np.asarray(self.steps, dtype=np.int64)

    def read_frame(self, index: int):
        """Parse one frame.

        Returns ``(positions (N, 3) float64 — unwrapped when the dump
        stores xu/ix columns, wrapped otherwise — dimensions (6,)
        [lx, ly, lz, alpha, beta, gamma], step)``.
        """

        lines = self._lines
        i = self._frames[index]
        step = int(lines[i + 1])
        n_atoms = int(lines[i + 3])

        bounds_header = lines[i + 4]
        triclinic = (
            "xy" in bounds_header and "xz" in bounds_header
        )
        rows = [
            [float(x) for x in lines[i + 5 + k].split()]
            for k in range(3)
        ]
        if triclinic:
            (xlo_b, xhi_b, xy), (ylo_b, yhi_b, xz), (zlo, zhi, yz) = rows
            # Invert the bounding-box extension (LAMMPS Howto
            # triclinic): bounds include the tilt reach.
            xlo = xlo_b - min(0.0, xy, xz, xy + xz)
            xhi = xhi_b - max(0.0, xy, xz, xy + xz)
            ylo = ylo_b - min(0.0, yz)
            yhi = yhi_b - max(0.0, yz)
        else:
            (xlo, xhi), (ylo, yhi), (zlo, zhi) = [r[:2] for r in rows]
            xy = xz = yz = 0.0
        lx, ly, lz = xhi - xlo, yhi - ylo, zhi - zlo
        # Cell vectors a=(lx,0,0), b=(xy,ly,0), c=(xz,yz,lz).
        a_len = lx
        b_len = float(np.hypot(xy, ly))
        c_len = float(np.sqrt(xz**2 + yz**2 + lz**2))
        alpha = float(
            np.degrees(
                np.arccos((xy * xz + ly * yz) / (b_len * c_len))
            )
        ) if b_len and c_len else 90.0
        beta = float(
            np.degrees(np.arccos(xz / c_len))
        ) if c_len else 90.0
        gamma = float(
            np.degrees(np.arccos(xy / b_len))
        ) if b_len else 90.0
        dimensions = np.array([a_len, b_len, c_len, alpha, beta, gamma])

        columns = lines[i + 8].split()[2:]  # after "ITEM: ATOMS"
        col = {name: k for k, name in enumerate(columns)}
        data = np.fromiter(
            (
                float(value)
                for row in lines[i + 9:i + 9 + n_atoms]
                for value in row.split()
            ),
            dtype=np.float64,
        ).reshape(n_atoms, len(columns))

        def pick(names):
            if all(n in col for n in names):
                return data[:, [col[n] for n in names]]
            return None

        origin = np.array([xlo, ylo, zlo])
        xyz = pick(("x", "y", "z"))
        if xyz is None:
            xyz = pick(("xu", "yu", "zu"))
        if xyz is None:
            scaled = pick(("xs", "ys", "zs"))
            if scaled is None:
                raise ValueError(
                    "Dump has no x/xu/xs coordinate columns "
                    f"(columns: {columns})."
                )
            h = np.array(
                [[lx, 0, 0], [xy, ly, 0], [xz, yz, lz]]
            )
            xyz = scaled @ h + origin
        images = pick(("ix", "iy", "iz"))
        if images is not None:
            h = np.array(
                [[lx, 0, 0], [xy, ly, 0], [xz, yz, lz]]
            )
            xyz = xyz + images @ h

        if "id" in col:
            order = np.argsort(data[:, col["id"]], kind="stable")
            xyz = xyz[order]
        return xyz, dimensions, step

    def read_frames(self, indices: Sequence[int]):
        indices = np.asarray(indices, dtype=int)
        pos = np.empty((len(indices), self.n_atoms, 3))
        dims = np.empty((len(indices), 6))
        for out, i in enumerate(indices):
            pos[out], dims[out], _ = self.read_frame(int(i))
        return pos, dims

    def close(self) -> None:
        self._lines = []


def read_lammps_dump(filename: str):
    """Read a whole dump: ``(positions (F, N, 3), dimensions (F, 6),
    steps (F,))``."""

    dump = LAMMPSDumpFile(filename)
    pos, dims = dump.read_frames(range(dump.n_frames))
    return pos, dims, dump.steps


class LAMMPSDumpWriter:
    """Streaming LAMMPS text dump writer (``dump custom ... id type
    x y z`` layout) — the write-side complement of
    :class:`LAMMPSDumpFile`; frames append one at a time.

    `dimensions` per frame is ``[lx, ly, lz, alpha, beta, gamma]``
    (Angstrom/degrees); triclinic cells emit ``BOX BOUNDS xy xz yz``
    with the LAMMPS bounding-box extension (the exact inverse of the
    reader's conversion).
    """

    def __init__(self, filename: str) -> None:
        self._fh = (
            gzip.open(filename, "wt")
            if filename.endswith(".gz")
            else open(filename, "w")
        )
        self._step = 0

    def write(
        self,
        positions,
        dimensions=None,
        *,
        types=None,
        ids=None,
        step: int = None,
    ) -> None:
        """Append one frame: `positions` ``(N, 3)``, optional
        `dimensions` ``(3,)``/``(6,)``, integer `types`/`ids`
        (defaults 1 / 1..N), `step` (auto-incrementing default)."""

        positions = np.asarray(positions, dtype=np.float64)
        if positions.ndim != 2 or positions.shape[-1] != 3:
            raise ValueError(
                "positions must have shape (n_atoms, 3); got "
                f"{positions.shape}."
            )
        n = positions.shape[0]
        step = self._step if step is None else int(step)
        types = (
            np.ones(n, dtype=int)
            if types is None
            else np.asarray(types, dtype=int)
        )
        ids = (
            np.arange(1, n + 1)
            if ids is None
            else np.asarray(ids, dtype=int)
        )

        if dimensions is None:
            lo = positions.min(axis=0)
            hi = positions.max(axis=0)
            bounds_item = "ITEM: BOX BOUNDS pp pp pp"
            rows = [f"{lo[k]:.10g} {hi[k]:.10g}" for k in range(3)]
        else:
            dims = np.asarray(dimensions, dtype=np.float64).ravel()
            if len(dims) == 3:
                dims = np.concatenate((dims, [90.0, 90.0, 90.0]))
            if np.allclose(dims[3:6], 90.0):
                bounds_item = "ITEM: BOX BOUNDS pp pp pp"
                rows = [f"0 {dims[k]:.10g}" for k in range(3)]
            else:
                from ..algorithm.topology import triclinic_matrices

                m = np.asarray(triclinic_matrices(dims))
                lx, ly, lz = m[0, 0], m[1, 1], m[2, 2]
                xy, xz, yz = m[1, 0], m[2, 0], m[2, 1]
                # LAMMPS Howto triclinic: bounds extend by the tilts.
                xlo_b = min(0.0, xy, xz, xy + xz)
                xhi_b = lx + max(0.0, xy, xz, xy + xz)
                ylo_b = min(0.0, yz)
                yhi_b = ly + max(0.0, yz)
                bounds_item = (
                    "ITEM: BOX BOUNDS xy xz yz pp pp pp"
                )
                rows = [
                    f"{xlo_b:.10g} {xhi_b:.10g} {xy:.10g}",
                    f"{ylo_b:.10g} {yhi_b:.10g} {xz:.10g}",
                    f"0 {lz:.10g} {yz:.10g}",
                ]

        out = [
            "ITEM: TIMESTEP",
            str(step),
            "ITEM: NUMBER OF ATOMS",
            str(n),
            bounds_item,
            *rows,
            "ITEM: ATOMS id type x y z",
        ]
        for k in range(n):
            x, y, z = positions[k]
            out.append(
                f"{ids[k]} {types[k]} {x:.10g} {y:.10g} {z:.10g}"
            )
        self._fh.write("\n".join(out) + "\n")
        self._step = step + 1

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "LAMMPSDumpWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_lammps_dump(
    filename: str,
    positions,
    dimensions=None,
    *,
    types=None,
    steps=None,
) -> None:
    """Write a whole ``(n_frames, n_atoms, 3)`` trajectory as a
    LAMMPS text dump (see :class:`LAMMPSDumpWriter`)."""

    positions = np.asarray(positions, dtype=np.float64)
    if positions.ndim != 3 or positions.shape[-1] != 3:
        raise ValueError(
            "positions must have shape (n_frames, n_atoms, 3); got "
            f"{positions.shape}."
        )
    n_frames = positions.shape[0]
    if dimensions is not None:
        dimensions = np.asarray(dimensions, dtype=np.float64)
        if dimensions.ndim == 1:
            dimensions = np.tile(dimensions, (n_frames, 1))
    with LAMMPSDumpWriter(filename) as writer:
        for f in range(n_frames):
            writer.write(
                positions[f],
                dimensions[f] if dimensions is not None else None,
                types=types,
                step=None if steps is None else int(steps[f]),
            )
