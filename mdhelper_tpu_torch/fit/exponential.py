r"""
Exponential models
==================

A copy of :mod:`mdhelper_tpu.fit.exponential` (numpy only).
"""

import numpy as np

__all__ = ["exp", "exp1", "exp2", "biexp", "stretched_exp"]


def exp(x: np.ndarray, *args: float) -> np.ndarray:
    r"""General sum of exponentials
    :math:`y = \sum_i a_i e^{b_i x}` with parameters ordered
    :math:`(a_1, b_1, a_2, b_2, \ldots)`."""

    n = len(args)
    if n < 2 or n % 2:
        raise ValueError(
            "Number of fitting parameters must be greater than 2 and "
            "even."
        )
    x = np.asarray(x, dtype=float)
    return np.exp(np.multiply.outer(x, args[1::2])) @ args[::2]


def exp1(x: np.ndarray, a: float, b: float) -> np.ndarray:
    r""":math:`y = a e^{bx}` (MATLAB ``exp1``)."""

    return exp(x, a, b)


def exp2(x: np.ndarray, a: float, b: float, c: float, d: float):
    r""":math:`y = a e^{bx} + c e^{dx}` (MATLAB ``exp2``)."""

    return exp(x, a, b, c, d)


def biexp(
    x: np.ndarray, y0: float, a: float, b: float, c: float, d: float
) -> np.ndarray:
    r"""Biexponential decay
    :math:`y = y_0 + a e^{-x/b} + c e^{-x/d}`."""

    x = np.asarray(x, dtype=float)
    return y0 + a * np.exp(-x / b) + c * np.exp(-x / d)


def stretched_exp(x: np.ndarray, alpha: float, beta: float) -> np.ndarray:
    r"""Stretched exponential (Kohlrausch–Williams–Watts)
    :math:`y = e^{-(x/\alpha)^\beta}`."""

    return np.exp(-((np.asarray(x, dtype=float) / alpha) ** beta))
