"""
Universe and atom groups
========================

The subset of :mod:`mdhelper_tpu.core.universe` the ported analyses
touch: the per-atom :class:`Topology` (masses, charges, types, names,
residue and segment indices, bonds), :class:`Universe` with
:meth:`Universe.from_arrays`, and :class:`AtomGroup` with its static
attributes, residue and segment groupings, bond-graph fragments and
current-frame reductions.  The universe is host-side metadata only;
analyses stream coordinates from ``universe.trajectory.read_frames``
onto their device.  Selections, file parsers, velocities and forces are
not ported yet.
"""

from typing import Sequence

import numpy as np

from ..algorithm.utility import find_connected_nodes
from .trajectory import ArrayReader, TrajectoryReader

__all__ = ["Topology", "Universe", "AtomGroup"]


class Topology:
    """Static per-atom attributes.

    All arrays are optional; the defaults are those of the JAX package:
    unit masses, zero charges, type and name ``"X"``, one residue per
    atom (``resids`` one more than ``resindices``), resname ``"UNK"``,
    one segment ``"SYSTEM"`` and no bonds.
    """

    def __init__(
        self,
        n_atoms: int,
        *,
        masses: np.ndarray = None,
        charges: np.ndarray = None,
        types: Sequence[str] = None,
        names: Sequence[str] = None,
        resindices: np.ndarray = None,
        segindices: np.ndarray = None,
        resids: np.ndarray = None,
        resnames: Sequence[str] = None,
        segids: Sequence[str] = None,
        bonds: np.ndarray = None,
    ):
        self.n_atoms = int(n_atoms)

        def _arr(value, default, dtype):
            if value is None:
                return default
            out = np.asarray(value, dtype=dtype)
            if len(out) != self.n_atoms:
                raise ValueError(
                    "Topology attribute length does not match n_atoms."
                )
            return out

        def _labels(value, default):
            return _arr(value, np.array([default] * n_atoms, dtype=object),
                        object)

        self.masses = _arr(masses, np.ones(n_atoms), np.float64)
        self.charges = _arr(charges, np.zeros(n_atoms), np.float64)
        self.types = _labels(types, "X")
        self.names = _labels(names, "X")
        self.resindices = _arr(resindices, np.arange(n_atoms), np.int64)
        self.segindices = _arr(segindices, np.zeros(n_atoms, dtype=int),
                               np.int64)
        self.resids = _arr(resids, self.resindices + 1, np.int64)
        self.resnames = _labels(resnames, "UNK")
        self.segids = _labels(segids, "SYSTEM")
        self.bonds = (
            np.empty((0, 2), dtype=np.int64)
            if bonds is None
            else np.asarray(bonds, dtype=np.int64).reshape(-1, 2)
        )

    @property
    def n_residues(self) -> int:
        return len(np.unique(self.resindices))

    @property
    def n_segments(self) -> int:
        return len(np.unique(self.segindices))


class Universe:
    """Topology + trajectory pair.

    Parameters
    ----------
    topology : :class:`Topology`
    trajectory : :class:`~mdhelper_tpu_torch.core.trajectory.TrajectoryReader`

    Use :meth:`Universe.from_arrays` for quick in-memory construction.
    """

    def __init__(self, topology: Topology, trajectory: TrajectoryReader):
        if topology.n_atoms != trajectory.n_atoms:
            raise ValueError(
                f"Topology has {topology.n_atoms} atoms but the "
                f"trajectory has {trajectory.n_atoms}."
            )
        self._topology = topology
        self.trajectory = trajectory
        self.trajectory[0]  # load the first frame

    @classmethod
    def from_arrays(cls, positions, dimensions=None, *, dt: float = 1.0,
                    **topology_attrs) -> "Universe":
        """A universe over in-memory ``(n_frames, n_atoms, 3)`` (or one
        ``(n_atoms, 3)`` frame's) positions, with the :class:`Topology`
        attributes given as keywords (``masses=``, ``resindices=``,
        ``bonds=``, ...).  float32 positions stay float32 (the stream
        dtype), as :class:`ArrayReader` keeps them."""

        positions = np.asarray(positions)
        if positions.ndim == 2:
            positions = positions[None]
        reader = ArrayReader(positions, dimensions, dt=dt)
        return cls(Topology(positions.shape[1], **topology_attrs), reader)

    @property
    def atoms(self) -> "AtomGroup":
        return AtomGroup(self, np.arange(self._topology.n_atoms))

    @property
    def dimensions(self) -> np.ndarray:
        return self.trajectory.ts.dimensions

    @property
    def bonds(self) -> np.ndarray:
        return self._topology.bonds

    @property
    def residues(self):
        return self.atoms.residues

    @property
    def segments(self):
        return self.atoms.segments


class _SubGroup:
    """A residue or segment view: exposes ``.atoms``."""

    __slots__ = ("atoms", "index")

    def __init__(self, atoms: "AtomGroup", index: int):
        self.atoms = atoms
        self.index = index


class AtomGroup:
    """An ordered set of atoms in a :class:`Universe`."""

    def __init__(self, universe: Universe, indices):
        self.universe = universe
        self._ix = np.asarray(indices, dtype=np.int64)

    # -- identity ----------------------------------------------------------
    @property
    def ix(self) -> np.ndarray:
        return self._ix

    indices = ix

    @property
    def n_atoms(self) -> int:
        return len(self._ix)

    def __len__(self) -> int:
        return len(self._ix)

    def __getitem__(self, item) -> "AtomGroup":
        """Sub-group by slice, integer index or array, or boolean
        mask (``u.atoms[0::2]``)."""

        return AtomGroup(self.universe, np.atleast_1d(self._ix[item]))

    def __add__(self, other: "AtomGroup") -> "AtomGroup":
        return AtomGroup(self.universe, np.concatenate((self._ix, other._ix)))

    def union(self, other: "AtomGroup") -> "AtomGroup":
        return AtomGroup(
            self.universe, np.unique(np.concatenate((self._ix, other._ix)))
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, AtomGroup)
            and self.universe is other.universe
            and np.array_equal(self._ix, other._ix)
        )

    __hash__ = None

    # -- static attributes -------------------------------------------------
    @property
    def masses(self) -> np.ndarray:
        return self.universe._topology.masses[self._ix]

    @property
    def charges(self) -> np.ndarray:
        return self.universe._topology.charges[self._ix]

    @property
    def types(self) -> np.ndarray:
        return self.universe._topology.types[self._ix]

    @property
    def names(self) -> np.ndarray:
        return self.universe._topology.names[self._ix]

    @property
    def resnames(self) -> np.ndarray:
        return self.universe._topology.resnames[self._ix]

    @property
    def segids(self) -> np.ndarray:
        return self.universe._topology.segids[self._ix]

    @property
    def resindices(self) -> np.ndarray:
        return self.universe._topology.resindices[self._ix]

    @property
    def segindices(self) -> np.ndarray:
        return self.universe._topology.segindices[self._ix]

    @property
    def dimensions(self) -> np.ndarray:
        return self.universe.dimensions

    # -- dynamic attributes ------------------------------------------------
    @property
    def positions(self) -> np.ndarray:
        return self.universe.trajectory.ts.positions[self._ix]

    # -- groupings ---------------------------------------------------------
    def _grouped(self, labels: np.ndarray) -> list:
        """One :class:`_SubGroup` per distinct label, in ascending label
        order, each holding its atoms in group order."""

        order = np.argsort(labels, kind="stable")
        boundaries = np.flatnonzero(np.diff(labels[order])) + 1
        return [
            _SubGroup(AtomGroup(self.universe, self._ix[g]), i)
            for i, g in enumerate(np.split(order, boundaries))
        ]

    @property
    def residues(self) -> list:
        return self._grouped(self.resindices)

    @property
    def segments(self) -> list:
        return self._grouped(self.segindices)

    @property
    def n_residues(self) -> int:
        return len(np.unique(self.resindices))

    @property
    def n_segments(self) -> int:
        return len(np.unique(self.segindices))

    @property
    def bonds(self) -> np.ndarray:
        """Bonds (absolute indices) with both endpoints in this group."""

        bonds = self.universe._topology.bonds
        if not len(bonds):
            return bonds
        member = np.zeros(self.universe._topology.n_atoms, dtype=bool)
        member[self._ix] = True
        return bonds[member[bonds[:, 0]] & member[bonds[:, 1]]]

    @property
    def fragments(self) -> list:
        """Connected components of the bond graph restricted to this
        group, each as a group of its atoms in ascending index order."""

        adjacency = {int(i): [] for i in self._ix}
        for a, b in self.bonds:
            adjacency[int(a)].append(int(b))
            adjacency[int(b)].append(int(a))
        return [
            AtomGroup(self.universe, np.array(sorted(component)))
            for component in find_connected_nodes(adjacency)
        ]

    # -- reductions --------------------------------------------------------
    def center_of_mass(self) -> np.ndarray:
        masses = self.masses
        return (masses[:, None] * self.positions).sum(axis=0) / masses.sum()

    def total_charge(self) -> float:
        return float(self.charges.sum())

    def total_mass(self) -> float:
        return float(self.masses.sum())

    def center_of_geometry(self) -> np.ndarray:
        # float64, as the JAX package's float64 frames give it.
        return np.asarray(self.positions, dtype=np.float64).mean(axis=0)

    def radius_of_gyration(self) -> float:
        """Mass-weighted radius of gyration of the current frame (raw
        coordinates)."""

        masses = self.masses
        delta = self.positions - self.center_of_mass()
        return float(np.sqrt(
            (masses * (delta * delta).sum(axis=1)).sum() / masses.sum()
        ))
