r"""
Distribution models
===================

A copy of :mod:`mdhelper_tpu.fit.distribution` (numpy only).
"""

import numpy as np

__all__ = ["weibull"]


def weibull(x: np.ndarray, a: float, b: float, c: float = 0) -> np.ndarray:
    r"""Three-parameter Weibull distribution
    :math:`y = ab(x-c)^{b-1}\exp[-a(x-c)^b]` (``c=0`` gives the
    two-parameter form)."""

    x = np.asarray(x, dtype=float) - c
    return a * b * x ** (b - 1) * np.exp(-a * x**b)
