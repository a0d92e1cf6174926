r"""
Correlations and mean-squared displacements by FFT
==================================================

Torch counterparts of :func:`mdhelper_tpu.algorithm.correlation.correlation_fft`
and :func:`~mdhelper_tpu.algorithm.correlation.msd_fft`, computed with
``torch.fft`` on the input's device (``msd_fft`` in float64), and copies
of the direct sliding-window forms :func:`correlation_shift` and
:func:`msd_shift` (host numpy, :math:`\mathcal{O}(N_t^2)`).

:math:`\mathrm{MSD}_m = S_m - 2A_m` (Kneller et al.; Calandrini et
al.): :math:`A_m` is the position autocorrelation from the
Wiener-Khinchin theorem, with the transform zero-padded to
:math:`2\,\mathrm{nextfastlen}(N_t)`, and :math:`S_m` follows from the
recursion :math:`Q_m = Q_{m-1} - D_{m-1} - D_{N_t-m}` over the squared
norms :math:`D_k`.
"""

import warnings

import numpy as np
import torch
from scipy import fft as _scipy_fft

__all__ = ["correlation_fft", "correlation_shift", "msd_fft", "msd_shift"]


def _validate(arr1, arr2, axis, min_ndim=1, name="The arrays"):
    """The time `axis` (resolved) and the number of dimensions of
    tensors or numpy arrays `arr1` and (optional) `arr2`."""

    if 0 in arr1.shape:
        raise ValueError(f"{name} must not be empty.")
    ndim = arr1.ndim
    if not min_ndim <= ndim <= 4:
        raise ValueError(
            f"{name} must have between {min_ndim} and 4 dimensions."
        )
    if arr2 is not None and arr1.shape != arr2.shape:
        raise ValueError(f"{name} must have the same dimensions.")
    if axis is None:
        if ndim == 4:
            axis = 1
        else:
            axis = 0
            if ndim > min_ndim:
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


def _as_series(arr):
    """`arr` as a tensor of its own floating or complex type (integers
    as float64)."""

    arr = torch.as_tensor(arr)
    if not (arr.is_floating_point() or arr.is_complex()):
        arr = arr.to(torch.float64)
    return arr


def correlation_fft(arr1, arr2=None, axis: int = None, *,
                    average: bool = False, double: bool = False,
                    vector: bool = False):
    r"""Auto- or cross-correlation of a time series by the Fast
    Correlation Algorithm (Wiener-Khinchin),

    .. math::

       A(\tau) = \mathrm{FFT}^{-1}\left[\mathrm{FFT}(\mathbf{r})\,
       \mathrm{FFT}(\mathbf{r})^*\right](\tau) / (N_t - \tau),

    with the transform zero-padded to :math:`2\,\mathrm{nextfastlen}(N_t)`
    as in the JAX package: float64 (complex128) for float64 inputs,
    float32 (complex64) for float32 ones, on the input's device.

    Parameters
    ----------
    arr1, arr2 : `torch.Tensor` or array-like
        Time series ``(N_t,)``, ``(N_t, N)``, ``(N_b, N_t)`` or
        ``(N_b, N_t, N)``, with a trailing axis of vector components when
        `vector`; real or complex.  With `arr2` the CCF, else the ACF of
        `arr1`.
    axis : `int`, optional
        Time axis (0, or 1 for blocked series); auto-detected when
        omitted.
    average : `bool`, keyword-only
        Average over the entity axis.
    double : `bool`, keyword-only
        Double the ACF, or fold the CCF's negative and positive lags
        (:math:`\langle a(t_0) b(t_0 + \tau)\rangle + \langle b(t_0)
        a(t_0 + \tau)\rangle`).
    vector : `bool`, keyword-only
        Contract the last axis (vector components).

    Returns
    -------
    corr : `torch.Tensor`
        The correlation, lags :math:`0 \ldots N_t - 1` on the time axis;
        a CCF with ``double=False`` is two-sided, lags
        :math:`-(N_t - 1) \ldots N_t - 1`.
    """

    arr1 = _as_series(arr1)
    if arr2 is not None:
        arr2 = _as_series(arr2).to(arr1.device)
    axis, ndim = _validate(arr1, arr2, axis)
    is_real = not arr1.is_complex() and (arr2 is None
                                         or not arr2.is_complex())
    work1 = torch.movedim(arr1, axis, 0)
    n_t = work1.shape[0]
    n_fft = 2 * _scipy_fft.next_fast_len(n_t, real=is_real)
    fft_, ifft_ = ((torch.fft.rfft, torch.fft.irfft) if is_real
                   else (torch.fft.fft, torch.fft.ifft))
    f1 = fft_(work1, n=n_fft, dim=0)
    two_sided = False
    if arr2 is None:
        spec = (double + 1) * (f1 * f1.conj())
    else:
        f2 = fft_(torch.movedim(arr2, axis, 0), n=n_fft, dim=0)
        if double:
            spec = f1.conj() * f2 + f1 * f2.conj()
        else:
            spec = f1.conj() * f2
            two_sided = True
    # The FFT is linear: contract the vector components and average the
    # entities on the power spectrum, one inverse transform in all.
    if vector:
        spec = spec.sum(dim=-1)
    if average:
        axis_avg = ndim - vector - 1
        if axis != axis_avg:
            # The entity axis in work coordinates (time moved first).
            spec = spec.mean(dim=axis_avg if axis_avg > axis
                             else axis_avg + 1)
    corr = ifft_(spec, n=n_fft, dim=0)
    if not two_sided:
        corr = corr[:n_t]

    # Triangular normalization: lag m averages N_t - |m| window positions.
    tail = (1,) * (corr.ndim - 1)
    real_dtype = corr.real.dtype if corr.is_complex() else corr.dtype
    desc = torch.arange(n_t, 0, -1, dtype=real_dtype,
                        device=corr.device).reshape(-1, *tail)
    if two_sided:
        asc = torch.arange(1, n_t, dtype=real_dtype,
                           device=corr.device).reshape(-1, *tail)
        corr = torch.cat((corr[corr.shape[0] + 1 - n_t:] / asc,
                          corr[:n_t] / desc), dim=0)
    else:
        corr = corr / desc
    return torch.movedim(corr, 0, axis)


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
    axis, ndim = _validate(pos1, pos2, axis, min_ndim=2,
                           name="The position arrays")
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


def _host(arr):
    """`arr` (a tensor on any device, or array-like) as a float64 numpy
    array."""

    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr, dtype=float)


def correlation_shift(arr1, arr2=None, axis: int = None, *,
                      average: bool = False, double: bool = False,
                      vector: bool = False) -> np.ndarray:
    r"""Auto- or cross-correlation evaluated directly with sliding
    windows, :math:`\mathcal{O}(N_t^2)`, in float64 numpy on the host
    (for checking :func:`correlation_fft` and for short series).

    The arguments are those of :func:`correlation_fft`; the result is a
    `numpy.ndarray`.  Cross-correlations hold the lags
    :math:`-(N_t - 1), \ldots, N_t - 1` unless `double` folds them.
    """

    arr1 = _host(arr1)
    arr2 = None if arr2 is None else _host(arr2)
    axis, ndim = _validate(arr1, arr2, axis)
    work1 = np.moveaxis(arr1, axis, 0)
    n_t = work1.shape[0]
    sum_axes = (0, work1.ndim - 1) if vector and work1.ndim > 1 else 0

    if arr2 is None:
        corr = np.stack([
            (work1[m:] * work1[: n_t - m if m else None]).sum(axis=sum_axes)
            for m in range(n_t)
        ])
        if double:
            corr = 2 * corr
        two_sided = False
    else:
        work2 = np.moveaxis(arr2, axis, 0)
        # Negative lags first (lag -(N_t - 1) ... -1), then 0 ... N_t - 1.
        out = []
        for m in range(1 - n_t, n_t):
            if m >= 0:
                prod = work1[: n_t - m if m else None] * work2[m:]
            else:
                prod = work1[-m:] * work2[: n_t + m]
            out.append(prod.sum(axis=sum_axes))
        corr = np.stack(out)
        if double:
            corr = corr[n_t - 1:] + corr[n_t - 1::-1]
            two_sided = False
        else:
            two_sided = True

    # Normalize by window counts.
    shape_tail = (1,) * (corr.ndim - 1)
    desc = np.arange(n_t, 0, -1).reshape(-1, *shape_tail)
    if two_sided:
        asc = np.arange(1, n_t).reshape(-1, *shape_tail)
        corr[: n_t - 1] /= asc
        corr[n_t - 1:] /= desc
    else:
        corr = corr / desc

    corr = np.moveaxis(corr, 0, axis)
    if average:
        axis_avg = ndim - vector - 1
        if axis != axis_avg:
            corr = corr.mean(axis=axis_avg)
    return corr


def msd_shift(pos1, pos2=None, axis: int = None, *,
              average: bool = True) -> np.ndarray:
    r"""Mean-squared (or cross) displacement evaluated directly from the
    Einstein relation, averaged over every window origin,
    :math:`\mathcal{O}(N_t^2)`, in float64 numpy on the host (for
    checking :func:`msd_fft`, and ``Onsager(fft=False)``).

    The arguments are those of :func:`msd_fft`; the result is a
    `numpy.ndarray`.
    """

    pos1 = _host(pos1)
    pos2 = None if pos2 is None else _host(pos2)
    axis, ndim = _validate(pos1, pos2, axis, min_ndim=2,
                           name="The position arrays")
    work1 = np.moveaxis(pos1, axis, 0)
    n_t = work1.shape[0]
    work2 = work1 if pos2 is None else np.moveaxis(pos2, axis, 0)

    disp = np.stack([
        ((work1[: n_t - m if m else None] - work1[m:])
         * (work2[: n_t - m if m else None] - work2[m:])).sum(axis=-1)
        .mean(axis=0)
        for m in range(n_t)
    ])
    disp = np.moveaxis(disp, 0, axis)
    if ndim - axis == 3 and average:
        disp = disp.mean(axis=ndim - 2)
    return disp
