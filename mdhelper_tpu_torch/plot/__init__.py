"""
Plotting helpers
================

Publication-figure utilities, module for module as in
:mod:`mdhelper_tpu.plot`.  Host-only matplotlib code: the package root
does not import this subpackage, so the port imports without matplotlib.
"""

from . import axis, color, rcparam  # noqa: F401

__all__ = ["axis", "color", "rcparam"]
