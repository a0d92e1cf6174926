r"""
Accelerated kernels
===================

Torch counterparts of :mod:`mdhelper_tpu.algorithm.accelerated` (the
reference's Numba kernel library): dot and inner products, the Fourier
phase sums :math:`\sum_\mathbf{r} \exp(i\,\mathbf{q}\cdot\mathbf{r})`,
and row-wise cosine and sine sums.  Each is plain torch on the device of
its tensor inputs.  NumPy (or list) inputs are computed with torch on
the first CUDA device, which raises when there is no card, and come back
as NumPy arrays; a caller who wants the CPU passes CPU tensors.  Python
floats become float64, as under the JAX package's 64-bit mode.

As in the JAX package, each ``*_parallel_*`` name is an alias of the
single implementation (torch parallelizes the reductions itself), and
the ``*_inplace_*`` variants write the result into the given NumPy
buffer.  The tiled structure-factor sums the analyses use live in
:mod:`mdhelper_tpu_torch.ops.scattering` and the trig-sums kernel.
"""

import numpy as np
import torch

from .._device import require_cuda

__all__ = [
    "dot_1d_1d",
    "delta_fourier_transform_1d_1d",
    "delta_fourier_transform_sum_2d_2d",
    "delta_fourier_transform_sum_parallel_2d_2d",
    "inner_2d_2d",
    "inner_parallel_2d_2d",
    "pythagorean_trigonometric_identity_1d",
    "pythagorean_trigonometric_identity_1d_1d",
    "cosine_sum_1d",
    "cosine_sum_2d",
    "cosine_sum_parallel_2d",
    "cosine_sum_inplace_2d",
    "cosine_sum_inplace_parallel_2d",
    "sine_sum_1d",
    "sine_sum_2d",
    "sine_sum_parallel_2d",
    "sine_sum_inplace_2d",
    "sine_sum_inplace_parallel_2d",
]


def _tensors(*arrays):
    """``(tensors, numpy_out)``: the inputs as tensors on the device of the
    first tensor among them (the first CUDA device when there is none,
    :func:`require_cuda`; non-tensors go through ``numpy.asarray``, so
    Python floats are float64), and whether the result should be returned
    as NumPy (no input was a tensor)."""

    device = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
                  None)
    numpy_out = device is None
    if numpy_out:
        device = require_cuda()
    tensors = [
        a if isinstance(a, torch.Tensor)
        else torch.as_tensor(np.asarray(a), device=device)
        for a in arrays
    ]
    return tensors, numpy_out


def _returned(x, numpy_out):
    return x.cpu().numpy() if numpy_out else x


def _matmul(a, b):
    """``a @ b`` in the promoted dtype of the two."""

    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dtype), b.to(dtype))


def dot_1d_1d(a, b):
    r"""Dot product of two ``(3,)`` vectors."""

    (a, b), numpy_out = _tensors(a, b)
    return _returned(_matmul(a, b), numpy_out)


def delta_fourier_transform_1d_1d(q, r):
    r""":math:`\exp(i\,\mathbf{q}\cdot\mathbf{r})` for single vectors."""

    (q, r), numpy_out = _tensors(q, r)
    return _returned(torch.exp(1j * _matmul(q, r)), numpy_out)


def delta_fourier_transform_sum_2d_2d(qs, rs):
    r""":math:`\sum_\mathbf{r} \exp(i\,\mathbf{q}\cdot\mathbf{r})` for
    every wavevector of `qs` ``(N_q, 3)`` over the positions `rs` ``(N_r,
    3)``: shape ``(N_q,)``, from one ``(N_q, 3) @ (3, N_r)`` phase matrix
    and its cosine and sine row sums."""

    (qs, rs), numpy_out = _tensors(qs, rs)
    phases = _matmul(qs, rs.T)
    return _returned(
        torch.complex(torch.cos(phases).sum(dim=1),
                      torch.sin(phases).sum(dim=1)),
        numpy_out,
    )


delta_fourier_transform_sum_parallel_2d_2d = delta_fourier_transform_sum_2d_2d


def inner_2d_2d(qs, rs):
    r"""All pairwise inner products: ``(N_q, 3) x (N_r, 3) -> (N_q,
    N_r)``."""

    (qs, rs), numpy_out = _tensors(qs, rs)
    return _returned(_matmul(qs, rs.T), numpy_out)


inner_parallel_2d_2d = inner_2d_2d


def pythagorean_trigonometric_identity_1d(r):
    r""":math:`(\sum_i \cos r_i)^2 + (\sum_i \sin r_i)^2`."""

    (r,), numpy_out = _tensors(r)
    return _returned(torch.cos(r).sum() ** 2 + torch.sin(r).sum() ** 2,
                     numpy_out)


def pythagorean_trigonometric_identity_1d_1d(r, s):
    r""":math:`2(\sum_i \cos r_i \sum_j \cos s_j + \sum_i \sin r_i
    \sum_j \sin s_j)`."""

    (r, s), numpy_out = _tensors(r, s)
    return _returned(
        2 * (torch.cos(r).sum() * torch.cos(s).sum()
             + torch.sin(r).sum() * torch.sin(s).sum()),
        numpy_out,
    )


def cosine_sum_1d(x):
    r""":math:`\sum_i \cos x_i`."""

    (x,), numpy_out = _tensors(x)
    return _returned(torch.cos(x).sum(), numpy_out)


def cosine_sum_2d(xs):
    r"""Row-wise :math:`\sum_j \cos x_{ij}` of an ``(N, M)`` array."""

    (xs,), numpy_out = _tensors(xs)
    return _returned(torch.cos(xs).sum(dim=1), numpy_out)


cosine_sum_parallel_2d = cosine_sum_2d


def cosine_sum_inplace_2d(xs, s) -> None:
    r"""Row-wise cosine sums written into the NumPy buffer `s`."""

    out = cosine_sum_2d(xs)
    np.copyto(s, out.cpu().numpy() if isinstance(out, torch.Tensor) else out)


cosine_sum_inplace_parallel_2d = cosine_sum_inplace_2d


def sine_sum_1d(x):
    r""":math:`\sum_i \sin x_i`."""

    (x,), numpy_out = _tensors(x)
    return _returned(torch.sin(x).sum(), numpy_out)


def sine_sum_2d(xs):
    r"""Row-wise :math:`\sum_j \sin x_{ij}` of an ``(N, M)`` array."""

    (xs,), numpy_out = _tensors(xs)
    return _returned(torch.sin(xs).sum(dim=1), numpy_out)


sine_sum_parallel_2d = sine_sum_2d


def sine_sum_inplace_2d(xs, s) -> None:
    r"""Row-wise sine sums written into the NumPy buffer `s`."""

    out = sine_sum_2d(xs)
    np.copyto(s, out.cpu().numpy() if isinstance(out, torch.Tensor) else out)


sine_sum_inplace_parallel_2d = sine_sum_inplace_2d
