"""
Analysis modules
================

The ported analyses and the streaming runtime, module for module as in
:mod:`mdhelper_tpu.analysis`.
"""

from . import (  # noqa: F401
    base,
    bonded,
    cluster,
    contacts,
    dynamics,
    electrostatics,
    flow,
    free_energy,
    hbonds,
    interface,
    multi,
    orientation,
    pairing,
    polymer,
    profile,
    rmsd,
    sasa,
    steinhardt,
    structure,
    thermodynamics,
    transport,
)
from .base import (  # noqa: F401
    DynamicAnalysisBase,
    Hash,
    NumbaAnalysisBase,
    ParallelAnalysisBase,
    SerialAnalysisBase,
)
from .multi import run_together  # noqa: F401

__all__ = [
    "base",
    "bonded",
    "cluster",
    "contacts",
    "dynamics",
    "electrostatics",
    "flow",
    "free_energy",
    "hbonds",
    "interface",
    "multi",
    "orientation",
    "pairing",
    "polymer",
    "profile",
    "rmsd",
    "run_together",
    "sasa",
    "steinhardt",
    "structure",
    "thermodynamics",
    "transport",
    "DynamicAnalysisBase",
    "Hash",
    "NumbaAnalysisBase",
    "ParallelAnalysisBase",
    "SerialAnalysisBase",
]
