r"""
Mean-squared displacement by FFT
================================

Torch counterpart of :func:`mdhelper_tpu.algorithm.correlation.msd_fft`
(and of the part of ``correlation_fft`` it needs), computed with
``torch.fft`` in float64.

:math:`\mathrm{MSD}_m = S_m - 2A_m` (Kneller et al.; Calandrini et
al.): :math:`A_m` is the position autocorrelation from the
Wiener-Khinchin theorem, with the transform zero-padded to
:math:`2\,\mathrm{nextfastlen}(N_t)`, and :math:`S_m` follows from the
recursion :math:`Q_m = Q_{m-1} - D_{m-1} - D_{N_t-m}` over the squared
norms :math:`D_k`.
"""

import warnings

import torch
from scipy import fft as _scipy_fft

__all__ = ["msd_fft"]


def _validate(pos1, pos2, axis):
    if pos1.numel() == 0:
        raise ValueError("The position arrays must not be empty.")
    ndim = pos1.ndim
    if not 2 <= ndim <= 4:
        raise ValueError(
            "The position arrays must have between 2 and 4 dimensions."
        )
    if pos2 is not None and pos1.shape != pos2.shape:
        raise ValueError("The position arrays must have the same dimensions.")
    if axis is None:
        if ndim == 4:
            axis = 1
        else:
            axis = 0
            if ndim > 2:
                warnings.warn(
                    "The axis along which to compute the correlation "
                    "was not specified and is ambiguous for a "
                    "multidimensional array. It has been set to the "
                    "first axis by default."
                )
    elif axis not in {0, 1}:
        raise ValueError(
            "The correlation can only be evaluated along the first or "
            "second axis."
        )
    return axis, ndim


def _displacement_correlation(pos1, pos2, axis, average):
    """``2 * sum_k <r_k(t0) . r_k(t0 + m)>`` over window origins (the
    ``double=True, vector=True`` correlation), with the particle
    average taken on the power spectrum when `average`."""

    work1 = torch.movedim(pos1, axis, 0)
    n_t = work1.shape[0]
    n_fft = 2 * _scipy_fft.next_fast_len(n_t, real=True)
    f1 = torch.fft.rfft(work1, n=n_fft, dim=0)
    if pos2 is None:
        spec = 2 * (f1 * f1.conj())
    else:
        f2 = torch.fft.rfft(torch.movedim(pos2, axis, 0), n=n_fft, dim=0)
        spec = f1.conj() * f2 + f1 * f2.conj()
    # The FFT is linear: reduce the vector components and the particle
    # axis on the power spectrum, one inverse transform instead of one
    # per particle.
    spec = spec.sum(dim=-1)
    if average:
        spec = spec.mean(dim=-1)
    corr = torch.fft.irfft(spec, n=n_fft, dim=0)[:n_t]
    desc = torch.arange(n_t, 0, -1, dtype=corr.dtype, device=corr.device)
    corr = corr / desc.reshape(-1, *(1,) * (corr.ndim - 1))
    return torch.movedim(corr, 0, axis)


def msd_fft(pos1, pos2=None, axis: int = None, *, average: bool = True):
    r"""Mean-squared displacement (or cross displacement for two position
    sets) by FFT, in float64.

    Parameters
    ----------
    pos1, pos2 : `torch.Tensor` or array-like
        Positions ``(N_t, 3)``, ``(N_t, N, 3)`` or ``(N_b, N_t, N, 3)``.
    axis : `int`, optional
        Time axis (auto-detected when omitted).
    average : `bool`, keyword-only
        Average over the particle axis.

    Returns
    -------
    disp : `torch.Tensor`
        float64 MSD or CD.
    """

    pos1 = torch.as_tensor(pos1).to(torch.float64)
    if pos2 is not None:
        pos2 = torch.as_tensor(pos2).to(torch.float64)
    axis, ndim = _validate(pos1, pos2, axis)
    pre_average = ndim - axis == 3 and average
    s2 = _displacement_correlation(pos1, pos2, axis, pre_average)
    r1r2 = (pos1 * (pos1 if pos2 is None else pos2)).sum(dim=-1)

    n_t = pos1.shape[axis]
    work = torch.movedim(r1r2, axis, 0)
    s2_work = torch.movedim(s2, axis, 0)
    if pre_average:
        work = work.mean(dim=-1)

    # Q_m = 2 sum(D) - cumsum_m(D_{m-1} + D_{N_t - m}), D_{-1} = D_{N_t} = 0.
    zeros = torch.zeros((1, *work.shape[1:]), dtype=work.dtype,
                        device=work.device)
    head = torch.cat((zeros, work[: n_t - 1]), dim=0)
    tail = torch.cat((zeros, torch.flip(work[1:], dims=(0,))), dim=0)
    ssum = 2 * work.sum(dim=0) - torch.cumsum(head + tail, dim=0)
    counts = torch.arange(n_t, 0, -1, dtype=work.dtype, device=work.device)
    disp = ssum / counts.reshape(-1, *(1,) * (ssum.ndim - 1)) - s2_work
    return torch.movedim(disp, 0, axis)
