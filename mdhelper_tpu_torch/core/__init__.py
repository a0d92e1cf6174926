"""Host-side data layer: trajectory readers and the universe."""

from .trajectory import ArrayReader, Frame, TrajectoryReader
from .universe import AtomGroup, Universe

__all__ = ["ArrayReader", "AtomGroup", "Frame", "TrajectoryReader", "Universe"]
