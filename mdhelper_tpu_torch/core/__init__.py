"""Host-side data layer: trajectory readers and the universe."""

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
           "Topology", "TrajectoryReader", "Universe", "open_trajectory"]
