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
    polymer,
    profile,
    rmsd,
    steinhardt,
    structure,
    thermodynamics,
    transport,
)
from .base import (  # noqa: F401
    DynamicAnalysisBase,
    Hash,
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
    "polymer",
    "profile",
    "rmsd",
    "run_together",
    "steinhardt",
    "structure",
    "thermodynamics",
    "transport",
    "DynamicAnalysisBase",
    "Hash",
    "SerialAnalysisBase",
]
