r"""
Gaussian models
===============

A copy of :mod:`mdhelper_tpu.fit.gaussian` (numpy only).
"""

import numpy as np

__all__ = ["gauss"] + [f"gauss{n}" for n in range(1, 9)]


def gauss(x: np.ndarray, *args: float) -> np.ndarray:
    r"""Sum of Gaussians
    :math:`y = \sum_i a_i \exp[-((x - b_i)/c_i)^2]` with parameters
    ordered :math:`(a_1, b_1, c_1, a_2, \ldots)`."""

    n = len(args)
    if n < 3 or n % 3:
        raise ValueError(
            "Number of fitting parameters must be greater than and "
            "divisible by 3."
        )
    x = np.asarray(x, dtype=float)
    centers = np.asarray(args[1::3])
    widths = np.asarray(args[2::3])
    return np.exp(-(((x[..., None] - centers) / widths) ** 2)) @ np.asarray(
        args[::3]
    )


def _make_fixed(n: int):
    def fixed(x, *coefficients):
        if len(coefficients) != 3 * n:
            raise TypeError(
                f"gauss{n} expects {3 * n} coefficients, got "
                f"{len(coefficients)}."
            )
        return gauss(x, *coefficients)

    fixed.__name__ = f"gauss{n}"
    fixed.__qualname__ = f"gauss{n}"
    fixed.__doc__ = (
        f"Sum of {n} Gaussian(s) with parameters "
        "``(a1, b1, c1, ...)``. As in ``mdhelper_tpu.fit.gaussian``."
    )
    return fixed


gauss1 = _make_fixed(1)
gauss2 = _make_fixed(2)
gauss3 = _make_fixed(3)
gauss4 = _make_fixed(4)
gauss5 = _make_fixed(5)
gauss6 = _make_fixed(6)
gauss7 = _make_fixed(7)
gauss8 = _make_fixed(8)
