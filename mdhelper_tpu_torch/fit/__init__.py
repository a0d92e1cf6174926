"""
Curve-fitting models
====================

Plain numpy functions shaped for :func:`scipy.optimize.curve_fit`, as in
:mod:`mdhelper_tpu.fit`.  Only the exponential models are ported so far
(the polymer relaxation times fit a stretched exponential); the other
model modules come with the host-only packages (ROADMAP Queue 1, item
11).
"""

from . import exponential  # noqa: F401

__all__ = ["exponential"]
