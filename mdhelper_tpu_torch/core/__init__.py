"""Host-side data layer: trajectory readers, the universe and the
accumulator checkpoints."""

from .checkpoint import load_carry, save_carry
from .trajectory import (
    ArrayReader,
    Frame,
    NetCDFReader,
    NPZReader,
    TrajectoryReader,
    open_trajectory,
)
from .universe import AtomGroup, Topology, Universe

__all__ = ["ArrayReader", "AtomGroup", "Frame", "NPZReader", "NetCDFReader",
           "Topology", "TrajectoryReader", "Universe", "load_carry",
           "open_trajectory", "save_carry"]
