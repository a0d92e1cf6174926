"""
Curve-fitting models
====================

Plain numpy functions shaped for :func:`scipy.optimize.curve_fit`, module
for module as in :mod:`mdhelper_tpu.fit`.  Host-side numpy: fits operate
on small reduced results, never on device data.
"""

from . import (  # noqa: F401
    distribution,
    exponential,
    fourier,
    gaussian,
    polynomial,
    power,
)

__all__ = [
    "distribution",
    "exponential",
    "fourier",
    "gaussian",
    "polynomial",
    "power",
]
