r"""
Polynomial models
=================

General polynomial and the MATLAB-style fixed-order convenience models
``poly1`` ... ``poly9``, as in :mod:`mdhelper_tpu.fit.polynomial`: in
the fixed-order forms, :math:`y = p_1 x^n + p_2 x^{n-1} + \cdots +
p_{n+1}` with the leading coefficient first.
"""

import numpy as np

__all__ = ["poly"] + [f"poly{n}" for n in range(1, 10)]


def poly(x: np.ndarray, *args: float) -> np.ndarray:
    r"""General polynomial :math:`y = \sum_{k=0}^n p_k x^k`, with the
    coefficients ordered from the :math:`x^0` term up."""

    return np.polynomial.polynomial.polyval(np.asarray(x), args)


def _make_fixed(n: int):
    def fixed(x, *coefficients):
        if len(coefficients) != n + 1:
            raise TypeError(
                f"poly{n} expects {n + 1} coefficients, got "
                f"{len(coefficients)}."
            )
        return poly(x, *coefficients[::-1])

    fixed.__name__ = f"poly{n}"
    fixed.__qualname__ = f"poly{n}"
    fixed.__doc__ = (
        f"MATLAB-style poly{n} model: "
        r":math:`y = p_1 x^{%d} + \cdots + p_{%d}`. "
        "As in ``mdhelper_tpu.fit.polynomial``." % (n, n + 1)
    )
    return fixed


poly1 = _make_fixed(1)
poly2 = _make_fixed(2)
poly3 = _make_fixed(3)
poly4 = _make_fixed(4)
poly5 = _make_fixed(5)
poly6 = _make_fixed(6)
poly7 = _make_fixed(7)
poly8 = _make_fixed(8)
poly9 = _make_fixed(9)
