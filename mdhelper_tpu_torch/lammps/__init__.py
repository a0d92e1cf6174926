"""
LAMMPS helpers
==============

Simulation-setup utilities for LAMMPS, as in :mod:`mdhelper_tpu.lammps`.
"""

from . import topology  # noqa: F401

__all__ = ["topology"]
