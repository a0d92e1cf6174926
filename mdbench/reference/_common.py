"""Helpers shared by the references."""

import numpy as np
import torch


def relative_gap(got, want):
    """The widest gap between `got` and `want`, each element's gap over
    the larger of its reference's magnitude and the median magnitude of
    the reference (so that values near 0 do not blow it up); ``inf`` when
    the shapes differ or `got` holds a NaN."""

    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    scale = np.maximum(np.abs(want), np.median(np.abs(want)))
    scale = np.where(scale > 0, scale, 1.0)
    return float(np.max(np.abs(got - want) / scale))


def min_image(d, box):
    """Orthorhombic minimum image of displacements `d` (``(..., 3)``)."""

    return d - box * torch.round(d / box)


def unwrap(frames, box, seed=None):
    """Unwrapped positions ``(T, N, 3)`` of wrapped `frames` (a tensor in
    the working dtype): from `seed` (the first frame's unwrapped
    positions; default the first frame), each frame adds the minimum
    image of its step from the frame before."""

    steps = min_image(frames[1:] - frames[:-1], box)
    first = frames[0] if seed is None else seed
    out = torch.empty_like(frames)
    out[0] = first
    out[1:] = first + torch.cumsum(steps, dim=0)
    return out


def lattice_axis(n_points, length, dtype, device, round_to_float32=False):
    """The grid's wavenumbers along one axis, ``2 pi n / L`` for ``n`` in
    ``0 .. n_points - 1`` (rounded to float32 first where the analysis
    takes float32 wavevectors)."""

    q = 2 * np.pi * np.arange(n_points) / length
    if round_to_float32:
        q = q.astype(np.float32).astype(np.float64)
    return torch.as_tensor(q, dtype=dtype, device=device)


def grouped_by_n2(values, n_points):
    """Values on the cubic ``(n_points,) * 3`` grid, indexed ``[nx, ny,
    nz]``, averaged over equal ``n^2 = nx^2 + ny^2 + nz^2`` in increasing
    order: ``(n2 values, means)``."""

    n = np.arange(n_points)
    n2 = (n[:, None, None] ** 2 + n[None, :, None] ** 2
          + n[None, None, :] ** 2).ravel()
    keys, inverse = np.unique(n2, return_inverse=True)
    sums = np.bincount(inverse, weights=np.asarray(values).ravel(),
                       minlength=len(keys))
    return keys, sums / np.bincount(inverse, minlength=len(keys))
