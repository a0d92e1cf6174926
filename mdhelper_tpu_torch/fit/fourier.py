r"""
Fourier series models
=====================

A copy of :mod:`mdhelper_tpu.fit.fourier` (numpy only).  The
general form takes ``(x, omega, a0, a1, b1, ...)``; the fixed-order
forms take ``(x, a0, a1, b1, ..., omega)`` (MATLAB convention, with the
fundamental frequency last).
"""

import numpy as np

__all__ = ["fourier"] + [f"fourier{n}" for n in range(1, 9)]


def fourier(
    x: np.ndarray, omega: float, a0: float, *args: float
) -> np.ndarray:
    r"""Fourier series
    :math:`y = a_0 + \sum_k a_k\cos(k\omega x) + b_k\sin(k\omega x)`
    with parameters ordered :math:`(a_1, b_1, a_2, b_2, \ldots)`."""

    n = len(args)
    if n < 2 or n % 2:
        raise ValueError(
            "Number of fitting parameters must be greater than 2 and "
            "even."
        )
    x = np.asarray(x, dtype=float)
    kwx = np.arange(1, n // 2 + 1)[:, None] * omega * x
    return a0 + np.asarray(args[::2]) @ np.cos(kwx) + np.asarray(
        args[1::2]
    ) @ np.sin(kwx)


def _make_fixed(n: int):
    def fixed(x, a0, *rest):
        if len(rest) != 2 * n + 1:
            raise TypeError(
                f"fourier{n} expects a0, {2 * n} harmonic "
                "coefficients, and omega."
            )
        *coefficients, omega = rest
        return fourier(x, omega, a0, *coefficients)

    fixed.__name__ = f"fourier{n}"
    fixed.__qualname__ = f"fourier{n}"
    fixed.__doc__ = (
        f"Fourier series with {n} harmonic(s): "
        "``(x, a0, a1, b1, ..., omega)``. As in "
        "``mdhelper_tpu.fit.fourier``."
    )
    return fixed


fourier1 = _make_fixed(1)
fourier2 = _make_fixed(2)
fourier3 = _make_fixed(3)
fourier4 = _make_fixed(4)
fourier5 = _make_fixed(5)
fourier6 = _make_fixed(6)
fourier7 = _make_fixed(7)
fourier8 = _make_fixed(8)
