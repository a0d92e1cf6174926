r"""
Double-float (float32 pair) arithmetic
======================================

Torch counterpart of :mod:`mdhelper_tpu.ops.doublefloat`, operation for
operation, on float32 tensors.  A value is carried as an unevaluated
sum ``hi + lo`` of two float32s (~48 significand bits), enough to bin
the squared distances of float32 coordinates exactly.

Each function is one eager elementwise op per line, and PyTorch never
fuses eager ops into fused multiply-adds, so the roundings are exactly
the ones written here.  The device copy of these primitives lives in
``csrc/doublefloat.cuh``; it spells every product and sum with the
``__fmul_rn`` / ``__fadd_rn`` intrinsics so that nvcc cannot contract
them either.  Python scalars (``2.0``, the Dekker splitter) stay weakly
typed under torch's promotion rules, so float32 inputs give float32
results.

XLA's CPU backend, which runs the JAX package in the tests, does contract
a float32 product and a sum into one fused multiply-add (a wrap ``x -
floor(x / L) * L``, a squared norm, ``x * s - 0.5``).  :func:`fma32` forms
those expressions with one rounding, where a port must give the JAX
package's bits (``ops.pbc.wrap_positions``, ``ops.histogram._norm2``).
"""

import numpy as np
import torch

__all__ = [
    "f32_constant",
    "two_sum",
    "two_diff",
    "two_prod",
    "df_add",
    "df_sub",
    "df_sum3",
    "df_square",
    "df_ge",
    "df_lt",
    "df_min",
    "fma32",
]

# 2^12 + 1 Dekker split.
_SPLITTER = 4097.0


def f32_constant(value, device):
    """0-d float32 tensor of `value` rounded to float32.  Constants
    that enter a Dekker split must be tensors like this: a Python float
    would be split in float64."""

    return torch.tensor(np.float32(value), dtype=torch.float32,
                        device=device)


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth)."""

    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def two_diff(a, b):
    """Error-free a - b = s + e."""

    s = a - b
    bb = s - a
    e = (a - (s - bb)) - (b + bb)
    return s, e


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker)."""

    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add(x, y):
    """(hi, lo) + (hi, lo) with renormalization."""

    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return two_sum(s, e)


def df_sub(x, y):
    return df_add(x, (-y[0], -y[1]))


def df_sum3(x, y, z):
    return df_add(df_add(x, y), z)


def df_square(x):
    """(hi, lo)^2 as a double-float."""

    p, e = two_prod(x[0], x[0])
    e = e + 2.0 * x[0] * x[1]
    return two_sum(p, e)


def df_ge(x, y):
    """x >= y for double-floats (lexicographic on normalized pairs)."""

    return (x[0] > y[0]) | ((x[0] == y[0]) & (x[1] >= y[1]))


def df_lt(x, y):
    return ~df_ge(x, y)


def df_min(x, y):
    """Elementwise minimum of two double-floats."""

    take_y = df_lt(y, x)
    return torch.where(take_y, y[0], x[0]), torch.where(take_y, y[1], x[1])


def fma32(a, b, c):
    """``a * b + c`` of float32 tensors (or Python numbers) rounded once to
    float32, as a fused multiply-add: the product is exact in float64, and
    the float64 sum is rounded to float32 (a double rounding, which can
    differ from a true FMA only at a near-tie)."""

    f64 = torch.float64
    if not (isinstance(a, torch.Tensor) and a.ndim):
        a, b = b, a
    # One operand in float64 carries the product and the sum up with it
    # (type promotion converts the others inside those kernels), unless
    # neither factor has a dimension.
    prod = torch.as_tensor(a, dtype=f64) * b
    if prod.ndim == 0:
        c = torch.as_tensor(c, dtype=f64)
    return (prod + c).to(torch.float32)
