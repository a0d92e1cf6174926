"""
Algorithms
==========

The numerical API of the port, module for module as in
:mod:`mdhelper_tpu.algorithm`.
"""

from . import (  # noqa: F401
    accelerated,
    correlation,
    molecule,
    topology,
    unit,
    utility,
)

__all__ = [
    "accelerated",
    "correlation",
    "molecule",
    "topology",
    "unit",
    "utility",
]
