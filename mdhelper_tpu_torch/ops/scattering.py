r"""
Scattering trig sums
====================

Torch counterpart of :mod:`mdhelper_tpu.ops.scattering`: the
per-wavevector sums

.. math::

   C(\mathbf{q}) = \sum_j w_j \cos(\mathbf{q}\cdot\mathbf{r}_j), \qquad
   S(\mathbf{q}) = \sum_j w_j \sin(\mathbf{q}\cdot\mathbf{r}_j),

so that :math:`|\sum_j w_j e^{i\mathbf{q}\cdot\mathbf{r}_j}|^2 = C^2 +
S^2`.  This module is the plain version of the hand-written kernel
``csrc/trig_sums.cu`` (:func:`mdhelper_tpu_torch.ops.cuda_kernels.trig_sums`),
which computes the same terms without the ``(N_q, N)`` intermediates.

* ``precision="fast"``: one float32 product ``qs @ pos.T`` (full float32:
  the package forbids TF32), then cos and sin.
* ``precision="exact"``: the phase in double-float arithmetic,
  operation for operation as the JAX package's ``_exact_phases``,
  reduced mod :math:`2\pi` and applied to the trig as a first-order
  correction.  float64 wavevectors are split into float32 ``hi`` and
  ``lo`` words, and the ``lo * r`` products join the error terms.

Both paths tile the wavevector axis so that a 100k-atom frame never
holds more than :data:`_TILE_ELEMENTS` phases at once, and both sum the
atom axis in float64 before rounding the sums to float32 once: a float32
running sum of :math:`10^5` terms of unit size loses about :math:`10^{-5}`
of its value, which is the S(q) tolerance at low :math:`q`.
"""

import numpy as np
import torch

from .doublefloat import df_add, df_sub, f32_constant, two_prod

__all__ = ["trig_sums_frame", "trig_sums_batch", "ssf_from_trig_sums"]

_TWO_PI = 2 * np.pi
_TWO_PI_HI = np.float32(_TWO_PI)
_TWO_PI_LO = np.float32(_TWO_PI - np.float64(_TWO_PI_HI))

#: phases held at once by one wavevector tile (2^25 float32, 128 MiB a
#: buffer; the exact path keeps about twenty such buffers alive).
_TILE_ELEMENTS = 1 << 25


def _exact_phases(qs, pos, qs_lo=None):
    r"""Range-reduced phases :math:`\mathbf{q}\cdot\mathbf{r} \bmod 2\pi`
    as a double-float ``(hi, lo)`` pair of ``(N_q, N)`` float32 tensors,
    operation for operation as the JAX package's ``_exact_phases``.

    ``qs`` ``(N_q, 3)`` and ``pos`` ``(N, 3)`` are float32; ``qs_lo``
    optionally carries the low words of float64 wavevectors, whose
    ``lo * r`` products fold into each component's error term.
    """

    phase = None
    for k in range(3):
        term = two_prod(qs[:, None, k], pos[None, :, k])
        if qs_lo is not None:
            term = (term[0], term[1] + qs_lo[:, None, k] * pos[None, :, k])
        phase = term if phase is None else df_add(phase, term)

    # phi - 2*pi*round(phi / 2*pi), with 2*pi as a double-float.
    two_pi_hi = f32_constant(_TWO_PI_HI, pos.device)
    turns = torch.round(phase[0] / two_pi_hi)
    correction = two_prod(turns, two_pi_hi)
    return df_sub(
        phase,
        (correction[0],
         correction[1] + turns * f32_constant(_TWO_PI_LO, pos.device)),
    )


def _split_wavevectors(qs, dtype):
    """``(hi, lo)``: `qs` in `dtype`, and the low words a wider `qs`
    loses in that cast (None when it is already `dtype`)."""

    if qs.dtype == dtype:
        return qs, None
    hi = qs.to(dtype)
    return hi, (qs - hi.to(qs.dtype)).to(dtype)


def _q_tile(n_q, n_atoms):
    return max(1, min(n_q, _TILE_ELEMENTS // max(n_atoms, 1)))


def _tile_sums(qs_hi, qs_lo, pos, weights, precision):
    """Sums of one frame over float32 wavevectors `qs_hi` (and low words
    `qs_lo`, exact path only), tile by tile; float32 ``(N_q,)`` each."""

    n_q = qs_hi.shape[0]
    tile = _q_tile(n_q, pos.shape[0])
    cos_sum = torch.empty(n_q, dtype=torch.float64, device=pos.device)
    sin_sum = torch.empty_like(cos_sum)
    for lo in range(0, n_q, tile):
        q = qs_hi[lo:lo + tile]
        if precision == "exact":
            hi, low = _exact_phases(
                q, pos, None if qs_lo is None else qs_lo[lo:lo + tile]
            )
            cos_hi, sin_hi = torch.cos(hi), torch.sin(hi)
            # First-order correction: low is about 1 ulp of the phase.
            cos = cos_hi - low * sin_hi
            sin = sin_hi + low * cos_hi
        else:
            phases = torch.matmul(q, pos.T)
            cos, sin = torch.cos(phases), torch.sin(phases)
        if weights is not None:
            cos = cos * weights
            sin = sin * weights
        cos_sum[lo:lo + tile] = cos.sum(dim=-1, dtype=torch.float64)
        sin_sum[lo:lo + tile] = sin.sum(dim=-1, dtype=torch.float64)
    return cos_sum.to(pos.dtype), sin_sum.to(pos.dtype)


def _check_precision(precision):
    if precision not in ("fast", "exact"):
        raise ValueError("precision must be 'fast' or 'exact'.")


def trig_sums_frame(qs, pos, weights=None, *, precision: str = "fast"):
    r"""Per-wavevector :math:`\sum_j w_j\cos(\mathbf{q}\cdot
    \mathbf{r}_j)` and :math:`\sum_j w_j\sin(\cdot)` for one frame.

    Parameters
    ----------
    qs : `torch.Tensor`
        Wavevectors, shape ``(N_q, 3)``; float64 wavevectors keep their
        low words on the exact path.
    pos : `torch.Tensor`
        Positions, shape ``(N, 3)``, float32.
    weights : `torch.Tensor`, optional
        Per-particle weights (e.g. padding mask or form factors),
        shape ``(N,)``.
    precision : `str`, keyword-only
        ``"fast"`` (float32 phases) or ``"exact"`` (double-float phases
        reduced mod :math:`2\pi`).

    Returns
    -------
    cos_sum, sin_sum : `torch.Tensor`
        Shape ``(N_q,)`` each, in the positions' dtype.
    """

    _check_precision(precision)
    qs = torch.as_tensor(qs, device=pos.device)
    if weights is not None:
        weights = torch.as_tensor(weights, device=pos.device).to(pos.dtype)
    # The sweep runs in the positions' dtype: on the exact path a wider
    # qs is split hi + lo, so no wavevector precision is lost.
    qs_hi, qs_lo = _split_wavevectors(qs, pos.dtype)
    if precision == "fast":
        qs_lo = None
    return _tile_sums(qs_hi, qs_lo, pos, weights, precision)


def trig_sums_batch(qs, pos, weights=None, *, precision: str = "fast"):
    """:func:`trig_sums_frame` of each frame of `pos` ``(B, N, 3)``;
    returns ``(B, N_q)`` cos and sin sums."""

    cos = torch.empty((pos.shape[0], len(qs)), dtype=pos.dtype,
                      device=pos.device)
    sin = torch.empty_like(cos)
    for b, p in enumerate(pos):
        cos[b], sin[b] = trig_sums_frame(qs, p, weights, precision=precision)
    return cos, sin


def ssf_from_trig_sums(cos_sum, sin_sum, mask):
    r"""Accumulate :math:`\sum_\mathrm{frames} |\sum_j e^{iqr_j}|^2`
    from per-frame trig sums ``(B, N_q)`` with a frame mask ``(B,)``;
    shape ``(N_q,)``."""

    ssf = cos_sum**2 + sin_sum**2
    return (ssf * mask[:, None]).sum(dim=0)
