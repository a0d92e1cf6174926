r"""
Spherical harmonics
===================

Real spherical harmonics and Wigner 3-j couplings for the
bond-orientational (Steinhardt) order parameters, ported from
:mod:`mdhelper_tpu.algorithm.spherical`.

The harmonics are evaluated as **polynomials in the Cartesian
components** of the unit bond vector -- no trigonometry, no complex
numbers -- elementwise on torch tensors (or numpy arrays):

.. math::

   Y_{lm}^{\cos} = \sqrt{2}\,K_{lm}\,\Pi_l^m(z)\,A_m(x, y), \qquad
   Y_{lm}^{\sin} = \sqrt{2}\,K_{lm}\,\Pi_l^m(z)\,B_m(x, y),

where :math:`\Pi_l^m(z) = d^m P_l(z)/dz^m` (plain polynomial,
Horner-evaluated from exact `Fraction` coefficients cached on the host),
:math:`A_m + i B_m = (x + i y)^m` (two-term recurrence), and
:math:`K_{lm}` is the orthonormalization constant.  The identity
:math:`\sin^m\theta\,e^{im\varphi} = (x + iy)^m` removes the
pole/azimuth singularities entirely.

With scipy's Condon-Shortley convention the columns relate to the
complex harmonics as :math:`Y_{lm}^{\cos} = \sqrt{2}(-1)^m
\mathrm{Re}\,Y_l^m` and :math:`Y_{lm}^{\sin} = \sqrt{2}(-1)^m
\mathrm{Im}\,Y_l^m`.  The invariants and the Wigner 3-j symbols are
host numpy (exact `Fraction` arithmetic), copies of the JAX package's.

Column layout for degree ``l`` (``2l + 1`` columns):
``[m=0, cos(1), sin(1), cos(2), sin(2), ..., cos(l), sin(l)]``.
"""

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "real_sph_harm",
    "sph_harm_columns",
    "complex_from_real",
    "invariant_ql",
    "invariant_wl",
    "wigner_3j",
    "wigner_3j_lll",
]


@lru_cache(maxsize=None)
def _legendre_coeffs(l: int) -> tuple:
    """Exact coefficients of the Legendre polynomial P_l(z),
    ascending order, as `Fraction`s (Bonnet recurrence)."""
    if l == 0:
        return (Fraction(1),)
    if l == 1:
        return (Fraction(0), Fraction(1))
    pm1 = _legendre_coeffs(l - 1)
    pm2 = _legendre_coeffs(l - 2)
    n = l - 1
    out = [Fraction(0)] * (l + 1)
    # (n+1) P_{n+1} = (2n+1) z P_n - n P_{n-1}
    for k, c in enumerate(pm1):
        out[k + 1] += Fraction(2 * n + 1, n + 1) * c
    for k, c in enumerate(pm2):
        out[k] -= Fraction(n, n + 1) * c
    return tuple(out)


@lru_cache(maxsize=None)
def _pi_lm_coeffs(l: int, m: int) -> tuple:
    """Float coefficients (ascending) of Pi_l^m(z) = d^m P_l / dz^m."""
    coeffs = list(_legendre_coeffs(l))
    for _ in range(m):
        coeffs = [
            k * c for k, c in enumerate(coeffs)
        ][1:] or [Fraction(0)]
    return tuple(float(c) for c in coeffs)


def _horner(coeffs: tuple, z):
    acc = None
    for c in reversed(coeffs):
        acc = c if acc is None else acc * z + c
    return acc


def _k_lm(l: int, m: int) -> float:
    return math.sqrt(
        (2 * l + 1)
        / (4.0 * math.pi)
        * math.factorial(l - m)
        / math.factorial(l + m)
    )


def sph_harm_columns(degrees) -> int:
    """Total number of real-harmonic columns for the given degrees."""
    return int(sum(2 * l + 1 for l in degrees))


def real_sph_harm(degrees, u):
    r"""Real spherical harmonics of unit vectors.

    Parameters
    ----------
    degrees : sequence of `int`
        Harmonic degrees :math:`l` (e.g. ``(4, 6)``).
    u : `torch.Tensor` or `numpy.ndarray`, shape ``(..., 3)``
        Unit vectors; the result is of the same kind, dtype and device.

    Returns
    -------
    Array of shape ``(..., sum(2l + 1))`` -- per-degree column blocks
    concatenated in the order of `degrees`, each block laid out
    ``[m=0, cos(1), sin(1), ..., cos(l), sin(l)]``.
    """
    if isinstance(u, torch.Tensor):
        ones, zeros = torch.ones_like, torch.zeros_like

        def stack(cols):
            return torch.stack(cols, dim=-1)
    else:
        ones, zeros = np.ones_like, np.zeros_like

        def stack(cols):
            return np.stack(cols, axis=-1)
    x = u[..., 0]
    y = u[..., 1]
    z = u[..., 2]
    l_max = max(degrees)
    # A_m + i B_m = (x + i y)^m, recurrence up to l_max
    a = [None] * (l_max + 1)
    b = [None] * (l_max + 1)
    a[0], b[0] = ones(x), zeros(x)
    for m in range(1, l_max + 1):
        a[m] = x * a[m - 1] - y * b[m - 1]
        b[m] = x * b[m - 1] + y * a[m - 1]
    sqrt2 = math.sqrt(2.0)
    cols = []
    for l in degrees:
        cols.append(_k_lm(l, 0) * _horner(_pi_lm_coeffs(l, 0), z))
        for m in range(1, l + 1):
            pi = _horner(_pi_lm_coeffs(l, m), z)
            scale = sqrt2 * _k_lm(l, m)
            cols.append(scale * pi * a[m])
            cols.append(scale * pi * b[m])
    return stack(cols)


def complex_from_real(l: int, q_real: np.ndarray) -> np.ndarray:
    r"""Complex coefficients :math:`q_l^m`, ``m = -l..l``, from one
    degree's real column block (host-side, numpy).

    ``q_real`` has shape ``(..., 2l + 1)`` in the
    :func:`real_sph_harm` layout; the result has shape
    ``(..., 2l + 1)`` indexed by ``m + l``.  Uses
    :math:`q_l^m = (-1)^m (r_m^{\cos} + i\,r_m^{\sin}) / \sqrt{2}`
    for :math:`m > 0` and :math:`q_l^{-m} = (-1)^m (q_l^m)^*`.
    """
    out = np.empty(
        q_real.shape[:-1] + (2 * l + 1,), dtype=np.complex128
    )
    out[..., l] = q_real[..., 0]
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for m in range(1, l + 1):
        rc = q_real[..., 2 * m - 1]
        rs = q_real[..., 2 * m]
        sign = -1.0 if m % 2 else 1.0
        qm = sign * inv_sqrt2 * (rc + 1j * rs)
        out[..., l + m] = qm
        out[..., l - m] = sign * np.conj(qm)
    return out


def invariant_ql(l: int, q_real, xp=np):
    r"""Second-order rotational invariant :math:`q_l = \sqrt{4\pi /
    (2l+1) \sum_m |q_l^m|^2}` from one degree's real column block
    ``(..., 2l + 1)`` (the real layout makes :math:`\sum_m
    |q_l^m|^2` a plain sum of squares)."""
    s = (q_real * q_real).sum(axis=-1)
    return xp.sqrt(4.0 * math.pi / (2 * l + 1) * s)


@lru_cache(maxsize=None)
def _fact(n: int) -> int:
    return math.factorial(n)


def wigner_3j(j1: int, j2: int, j3: int,
              m1: int, m2: int, m3: int) -> float:
    """Wigner 3-j symbol for integer arguments (Racah formula,
    exact integer arithmetic; result as float)."""
    if m1 + m2 + m3 != 0:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    # triangle coefficient and m-dependent factorials, exact
    delta = Fraction(
        _fact(j1 + j2 - j3) * _fact(j1 - j2 + j3)
        * _fact(-j1 + j2 + j3),
        _fact(j1 + j2 + j3 + 1),
    )
    prod = (
        _fact(j1 + m1) * _fact(j1 - m1)
        * _fact(j2 + m2) * _fact(j2 - m2)
        * _fact(j3 + m3) * _fact(j3 - m3)
    )
    k_min = max(0, j2 - j3 - m1, j1 - j3 + m2)
    k_max = min(j1 + j2 - j3, j1 - m1, j2 + m2)
    total = Fraction(0)
    for k in range(k_min, k_max + 1):
        term = Fraction(
            (-1) ** k,
            _fact(k) * _fact(j1 + j2 - j3 - k)
            * _fact(j1 - m1 - k) * _fact(j2 + m2 - k)
            * _fact(j3 - j2 + m1 + k) * _fact(j3 - j1 - m2 + k),
        )
        total += term
    if total == 0:
        return 0.0
    sign = (-1) ** (j1 - j2 - m3) * (1 if total > 0 else -1)
    # value = sign * sqrt(delta * prod) * |total|
    mag2 = delta * prod * total * total
    return sign * math.sqrt(float(mag2))


@lru_cache(maxsize=None)
def wigner_3j_lll(l: int) -> tuple:
    """All non-zero (m1, m2, m3, coefficient) entries of the
    (l, l, l) Wigner 3-j symbol with m1 + m2 + m3 = 0 — the coupling
    tensor of the third-order invariant w_l."""
    entries = []
    for m1 in range(-l, l + 1):
        for m2 in range(-l, l + 1):
            m3 = -m1 - m2
            if abs(m3) > l:
                continue
            w = wigner_3j(l, l, l, m1, m2, m3)
            if w != 0.0:
                entries.append((m1, m2, m3, w))
    return tuple(entries)


def invariant_wl(l: int, q_real: np.ndarray,
                 normalize: bool = True) -> np.ndarray:
    r"""Third-order rotational invariant

    .. math::

       w_l = \sum_{m_1 + m_2 + m_3 = 0}
       \begin{pmatrix} l & l & l \\ m_1 & m_2 & m_3 \end{pmatrix}
       q_{lm_1} q_{lm_2} q_{lm_3},

    normalized (``normalize=True``, the conventional
    :math:`\hat{w}_l`) by :math:`(\sum_m |q_l^m|^2)^{3/2}`.
    Host-side numpy (complex128); particles whose
    :math:`q_l^m` vanish (no neighbors) get 0.
    """
    qc = complex_from_real(l, np.asarray(q_real, dtype=np.float64))
    out = np.zeros(qc.shape[:-1], dtype=np.complex128)
    for m1, m2, m3, w in wigner_3j_lll(l):
        out += (
            w
            * qc[..., l + m1]
            * qc[..., l + m2]
            * qc[..., l + m3]
        )
    wl = out.real  # the invariant is real; imag is roundoff
    if normalize:
        norm = (np.abs(qc) ** 2).sum(axis=-1) ** 1.5
        wl = np.where(norm > 0, wl / np.where(norm > 0, norm, 1.0),
                      0.0)
    return wl
