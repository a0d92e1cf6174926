"""
Analysis modules
================

The ported analyses and the streaming runtime, module for module as in
:mod:`mdhelper_tpu.analysis`.
"""

from . import (  # noqa: F401
    base,
    cluster,
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
    "cluster",
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
    "run_together",
    "steinhardt",
    "structure",
    "thermodynamics",
    "transport",
    "DynamicAnalysisBase",
    "Hash",
    "SerialAnalysisBase",
]
