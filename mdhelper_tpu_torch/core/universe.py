"""
Universe and atom groups
========================

The subset of :mod:`mdhelper_tpu.core.universe` the ported analyses
touch: :meth:`Universe.from_arrays` and an :class:`AtomGroup` with
indices, masses, current-frame positions and indexing into
sub-groups.  The universe is
host-side metadata only; analyses stream coordinates from
``universe.trajectory.read_frames`` onto their device.  Selections,
bonds and file parsers are not ported yet.
"""

import numpy as np

from .trajectory import ArrayReader, TrajectoryReader

__all__ = ["Universe", "AtomGroup"]


class Universe:
    """Per-atom masses plus a trajectory reader."""

    def __init__(self, trajectory: TrajectoryReader, *, masses=None):
        n = trajectory.n_atoms
        if masses is None:
            masses = np.ones(n)
        self.masses = np.asarray(masses, dtype=np.float64)
        if self.masses.shape != (n,):
            raise ValueError("masses must have one entry per atom.")
        #: bonds are not ported: every universe is bond-free.
        self.bonds = np.empty((0, 2), dtype=np.int64)
        self.trajectory = trajectory
        self.trajectory[0]  # load the first frame

    @classmethod
    def from_arrays(cls, positions, dimensions=None, *, dt: float = 1.0,
                    masses=None) -> "Universe":
        positions = np.asarray(positions)
        if positions.ndim == 2:
            positions = positions[None]
        reader = ArrayReader(positions, dimensions, dt=dt)
        return cls(reader, masses=masses)

    @property
    def atoms(self) -> "AtomGroup":
        return AtomGroup(self, np.arange(self.trajectory.n_atoms))

    @property
    def dimensions(self) -> np.ndarray:
        return self.trajectory.ts.dimensions


class AtomGroup:
    """An ordered set of atoms in a :class:`Universe`."""

    def __init__(self, universe: Universe, indices):
        self.universe = universe
        self._ix = np.asarray(indices, dtype=np.int64)

    @property
    def ix(self) -> np.ndarray:
        return self._ix

    @property
    def n_atoms(self) -> int:
        return len(self._ix)

    def __len__(self) -> int:
        return len(self._ix)

    def __getitem__(self, item) -> "AtomGroup":
        """Sub-group by slice, integer index or array, or boolean
        mask (``u.atoms[0::2]``)."""

        return AtomGroup(self.universe, np.atleast_1d(self._ix[item]))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, AtomGroup)
            and self.universe is other.universe
            and np.array_equal(self._ix, other._ix)
        )

    __hash__ = None

    @property
    def masses(self) -> np.ndarray:
        return self.universe.masses[self._ix]

    @property
    def positions(self) -> np.ndarray:
        return self.universe.trajectory.ts.positions[self._ix]

    @property
    def dimensions(self) -> np.ndarray:
        return self.universe.dimensions
