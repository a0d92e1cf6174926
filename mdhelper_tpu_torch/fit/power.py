r"""
Power-law models
================

A copy of :mod:`mdhelper_tpu.fit.power` (numpy only).
"""

import numpy as np

__all__ = ["power", "power1", "power2"]


def power(x: np.ndarray, a: float, b: float, c: float = 0) -> np.ndarray:
    r""":math:`y = a x^b + c`."""

    return a * np.asarray(x, dtype=float) ** b + c


def power1(x: np.ndarray, a: float, b: float) -> np.ndarray:
    r""":math:`y = a x^b` (MATLAB ``power1``)."""

    return power(x, a, b)


def power2(x: np.ndarray, a: float, b: float, c: float) -> np.ndarray:
    r""":math:`y = a x^b + c` (MATLAB ``power2``)."""

    return power(x, a, b, c)
