"""
Structure (snapshot) writers — PDB, GRO and XYZ
===============================================

The write-side complement of :mod:`mdhelper_tpu_torch.io.topology_files`:
fixed-column emitters that round-trip with this package's own
``read_pdb`` / ``read_gro`` / XYZ readers, copied from
:mod:`mdhelper_tpu.io.structure_writers` so that the bytes written are
the JAX package's.  Multi-frame arrays emit multi-``MODEL``
PDBs / concatenated GRO or XYZ blocks, which the corresponding
trajectory readers in :mod:`mdhelper_tpu_torch.core.trajectory` ingest.

All positions are in Angstrom (the package convention); the GRO writer
converts to nm on output.
"""

import numpy as np

__all__ = ["write_pdb", "write_gro", "write_xyz"]


def _frames(positions) -> np.ndarray:
    positions = np.asarray(positions, dtype=np.float64)
    if positions.ndim == 2:
        positions = positions[None]
    if positions.ndim != 3 or positions.shape[-1] != 3:
        raise ValueError(
            "positions must have shape (n_atoms, 3) or "
            f"(n_frames, n_atoms, 3); got {positions.shape}."
        )
    return positions


def _labels(value, n, default):
    if value is None:
        return [default] * n
    value = [str(v) for v in value]
    if len(value) != n:
        raise ValueError(
            f"attribute length {len(value)} does not match the "
            f"{n} atoms."
        )
    return value


def _ints(value, n, default_start=1):
    if value is None:
        return np.arange(default_start, default_start + n)
    value = np.asarray(value, dtype=np.int64)
    if len(value) != n:
        raise ValueError(
            f"attribute length {len(value)} does not match the "
            f"{n} atoms."
        )
    return value


def write_pdb(
    filename: str,
    positions: np.ndarray,
    *,
    names=None,
    resnames=None,
    resids=None,
    segids=None,
    elements=None,
    dimensions=None,
    occupancies=None,
    tempfactors=None,
) -> None:
    """Write a PDB file (fixed-column ``ATOM`` records, ``CRYST1``
    box, ``MODEL``/``ENDMDL`` framing for multi-frame input).

    Parameters
    ----------
    positions : array-like
        ``(n_atoms, 3)`` or ``(n_frames, n_atoms, 3)`` coordinates in
        Angstrom.
    names, resnames, segids, elements : sequence of `str`, optional
        Per-atom labels (defaults ``X`` / ``UNK`` / ``A`` / first
        letter of the name).  ``segids`` supply the chain-ID column
        (first character).
    resids : array-like of `int`, optional
        Residue sequence numbers (default ``1..n``; emitted modulo
        10,000 — the PDB column width).
    dimensions : array-like, optional
        ``(a, b, c, alpha, beta, gamma)`` or ``(lx, ly, lz)`` for the
        ``CRYST1`` record.
    occupancies, tempfactors : array-like, optional
        The two ``%6.2f`` trailing columns (defaults 1.00 / 0.00).
    """

    frames = _frames(positions)
    n = frames.shape[1]
    names = _labels(names, n, "X")
    resnames = _labels(resnames, n, "UNK")
    chains = [s[:1] or "A" for s in _labels(segids, n, "A")]
    elements = (
        [e[:2] for e in _labels(elements, n, "")]
        if elements is not None
        else [name.strip()[:1] for name in names]
    )
    resids = _ints(resids, n)
    occ = (
        np.ones(n)
        if occupancies is None
        else np.asarray(occupancies, dtype=np.float64)
    )
    bf = (
        np.zeros(n)
        if tempfactors is None
        else np.asarray(tempfactors, dtype=np.float64)
    )

    lines = []
    if dimensions is not None:
        dims = np.asarray(dimensions, dtype=np.float64).ravel()
        if len(dims) == 3:
            dims = np.concatenate((dims, [90.0, 90.0, 90.0]))
        lines.append(
            f"CRYST1{dims[0]:9.3f}{dims[1]:9.3f}{dims[2]:9.3f}"
            f"{dims[3]:7.2f}{dims[4]:7.2f}{dims[5]:7.2f} P 1"
            "           1"
        )

    multi = frames.shape[0] > 1
    for f, frame in enumerate(frames):
        if multi:
            lines.append(f"MODEL     {f + 1:4d}")
        for i in range(n):
            name = names[i][:4]
            # PDB name column convention: short names start at
            # column 14 (one leading space), 4-char names at 13.
            if len(name) < 4:
                name = f" {name}"
            x, y, z = frame[i]
            lines.append(
                f"ATOM  {(i + 1) % 100000:5d} {name:<4s}"
                f" {resnames[i][:4]:<4s}{chains[i]:1s}"
                f"{int(resids[i]) % 10000:4d}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{occ[i]:6.2f}{bf[i]:6.2f}"
                f"          {elements[i]:>2s}"
            )
        if multi:
            lines.append("ENDMDL")
    lines.append("END")
    with open(filename, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_gro(
    filename: str,
    positions: np.ndarray,
    *,
    names=None,
    resnames=None,
    resids=None,
    dimensions=None,
    velocities=None,
    title: str = "Written by mdhelper_tpu",
) -> None:
    """Write a GROMACS ``.gro`` file (fixed columns, nm on disk;
    `positions` in Angstrom).  Multi-frame input emits concatenated
    blocks — the multi-frame ``.gro`` trajectory reader convention.

    `dimensions` is ``(lx, ly, lz[, alpha, beta, gamma])`` in
    Angstrom; triclinic cells emit the 9-field box line (lower-
    triangular GROMACS vector order).  `velocities` (same shape as
    `positions`, Angstrom/ps) appends the three ``%8.4f`` velocity
    columns.
    """

    frames = _frames(positions)
    n = frames.shape[1]
    names = _labels(names, n, "X")
    resnames = _labels(resnames, n, "UNK")
    resids = _ints(resids, n)
    vel = None
    if velocities is not None:
        vel = _frames(velocities)
        if vel.shape != frames.shape:
            raise ValueError(
                "velocities shape does not match positions."
            )

    box_line = "   0.00000   0.00000   0.00000"
    if dimensions is not None:
        dims = np.asarray(dimensions, dtype=np.float64).ravel()
        if len(dims) == 3 or np.allclose(dims[3:6], 90.0):
            box_nm = dims[:3] / 10.0
            box_line = "".join(f"{v:10.5f}" for v in box_nm)
        else:
            from ..algorithm.topology import triclinic_matrices

            m = np.asarray(triclinic_matrices(dims[:6])) / 10.0
            fields = (
                m[0, 0], m[1, 1], m[2, 2],
                m[0, 1], m[0, 2], m[1, 0],
                m[1, 2], m[2, 0], m[2, 1],
            )
            box_line = "".join(f"{v:10.5f}" for v in fields)

    lines = []
    for f, frame in enumerate(frames):
        lines.append(str(title) if frames.shape[0] == 1
                     else f"{title}, frame {f}")
        lines.append(f"{n:5d}")
        for i in range(n):
            fields = (
                f"{int(resids[i]) % 100000:5d}"
                f"{resnames[i][:5]:<5s}{names[i][:5]:>5s}"
                f"{(i + 1) % 100000:5d}"
                + "".join(f"{v / 10.0:8.3f}" for v in frame[i])
            )
            if vel is not None:
                fields += "".join(
                    f"{v / 10.0:8.4f}" for v in vel[f, i]
                )
            lines.append(fields)
        lines.append(box_line)
    with open(filename, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_xyz(
    filename: str,
    positions: np.ndarray,
    *,
    symbols=None,
    comment: str = "Written by mdhelper_tpu",
) -> None:
    """Write an (extended) XYZ file — Angstrom, one concatenated
    block per frame."""

    frames = _frames(positions)
    n = frames.shape[1]
    symbols = _labels(symbols, n, "X")
    lines = []
    for f, frame in enumerate(frames):
        lines.append(str(n))
        lines.append(str(comment) if frames.shape[0] == 1
                     else f"{comment}, frame {f}")
        for i in range(n):
            x, y, z = frame[i]
            lines.append(
                f"{symbols[i]:<4s} {x:15.8f} {y:15.8f} {z:15.8f}"
            )
    with open(filename, "w") as fh:
        fh.write("\n".join(lines) + "\n")
