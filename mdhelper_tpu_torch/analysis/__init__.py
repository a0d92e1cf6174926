"""
Analysis modules
================

The ported analyses and the streaming runtime, module for module as in
:mod:`mdhelper_tpu.analysis`.
"""

from . import (  # noqa: F401
    base,
    electrostatics,
    multi,
    polymer,
    profile,
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
    "electrostatics",
    "multi",
    "polymer",
    "profile",
    "run_together",
    "structure",
    "thermodynamics",
    "transport",
    "DynamicAnalysisBase",
    "Hash",
    "SerialAnalysisBase",
]
