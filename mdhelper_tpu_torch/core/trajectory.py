"""
Trajectory readers
==================

Numpy-only subset of :mod:`mdhelper_tpu.core.trajectory`: the reader
protocol (random frame access plus the batched ``read_frames`` the
analyses stream from) and the in-memory :class:`ArrayReader`.  File
formats are not ported yet.
"""

from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = ["Frame", "TrajectoryReader", "ArrayReader"]


@dataclass
class Frame:
    """One trajectory frame."""

    positions: np.ndarray  # (N, 3)
    dimensions: np.ndarray  # (6,): lengths + angles (deg)
    time: float
    frame: int


def _normalize_dimensions(dimensions, n_frames: int) -> np.ndarray:
    """Broadcast box input to shape (n_frames, 6)."""

    dims = np.asarray(dimensions, dtype=float)
    if dims.ndim == 1:
        dims = np.tile(dims, (n_frames, 1))
    if dims.shape[-1] == 3:
        dims = np.concatenate((dims, np.full((len(dims), 3), 90.0)), axis=-1)
    if dims.shape != (n_frames, 6):
        raise ValueError(
            "Dimensions must have shape (3,), (6,), (n_frames, 3) or "
            f"(n_frames, 6); got {np.shape(dimensions)}."
        )
    return dims


class TrajectoryReader:
    """Reader protocol: random frame access plus batched block reads.

    Subclasses set ``_n_frames`` and ``_n_atoms`` and implement
    :meth:`_read_positions`, :meth:`_read_dimensions` and
    :meth:`read_frames`.
    """

    _n_frames: int
    _n_atoms: int
    dt: float = 1.0

    def _read_positions(self, index: int) -> np.ndarray:
        raise NotImplementedError

    def _read_dimensions(self, index: int) -> np.ndarray:
        raise NotImplementedError

    def _read_time(self, index: int) -> float:
        return index * self.dt

    @property
    def n_frames(self) -> int:
        return self._n_frames

    @property
    def n_atoms(self) -> int:
        return self._n_atoms

    def __len__(self) -> int:
        return self._n_frames

    def __getitem__(self, index) -> Frame:
        index = int(index)
        if index < 0:
            index += self._n_frames
        if not 0 <= index < self._n_frames:
            raise IndexError(
                f"Frame index {index} out of range for a trajectory "
                f"with {self._n_frames} frames."
            )
        self.ts = Frame(
            positions=self._read_positions(index),
            dimensions=self._read_dimensions(index),
            time=self._read_time(index),
            frame=index,
        )
        return self.ts

    def read_frames(
        self, indices: Sequence[int]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched read: ``(positions (F, N, 3), dimensions (F, 6))``."""

        raise NotImplementedError

    def check_slice_indices(self, start, stop, step):
        """Clamp (start, stop, step) to the trajectory bounds."""

        start = 0 if start is None else start
        stop = self._n_frames if stop is None else stop
        step = 1 if step is None else step
        if start < 0:
            start += self._n_frames
        if stop < 0:
            stop += self._n_frames
        stop = min(stop, self._n_frames)
        if step <= 0:
            raise ValueError("step must be a positive integer.")
        return start, stop, step


class ArrayReader(TrajectoryReader):
    """In-memory trajectory over NumPy arrays.

    Parameters
    ----------
    positions : `numpy.ndarray`
        Coordinates ``(n_frames, n_atoms, 3)``.  float32 input is kept
        as float32 (the stream dtype); anything else is stored as
        float64.
    dimensions : array-like, optional
        Box: ``(3,)``/``(6,)`` or per frame ``(n_frames, 3)``/
        ``(n_frames, 6)``.  Defaults to a zero box.
    dt : `float`, optional
        Time between consecutive frames (ps).
    """

    def __init__(self, positions, dimensions=None, *, dt: float = 1.0):
        positions = np.asarray(positions)
        if positions.dtype != np.float32:
            positions = positions.astype(np.float64)
        if positions.ndim != 3 or positions.shape[-1] != 3:
            raise ValueError(
                "positions must have shape (n_frames, n_atoms, 3); got "
                f"{positions.shape}."
            )
        self._positions = positions
        self._n_frames, self._n_atoms = positions.shape[:2]
        if dimensions is None:
            dimensions = np.zeros(6)
        self._dimensions = _normalize_dimensions(dimensions, self._n_frames)
        self.dt = float(dt)

    def _read_positions(self, index: int) -> np.ndarray:
        return self._positions[index]

    def _read_dimensions(self, index: int) -> np.ndarray:
        return self._dimensions[index]

    def read_frames(self, indices):
        indices = np.asarray(indices, dtype=int)
        return self._positions[indices], self._dimensions[indices]
