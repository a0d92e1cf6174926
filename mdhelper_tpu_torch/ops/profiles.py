"""
Density-profile binning
=======================

Torch counterpart of :mod:`mdhelper_tpu.ops.profiles`: 1-, 2- and 3-D
histograms of coordinates over a chunk of frames, with the
``numpy.histogram`` rules of the JAX package's ``_bin_indices`` (bin k
is ``[e_k, e_{k+1})``, a coordinate on the last edge falls in the last
bin, and coordinates outside the edges or NaN count nothing).

The JAX package contracts one-hot matrices on the TPU's matrix unit in
float32; here the bin ids go through ``torch.bincount``: counts are
int64, and weighted sums (charges) float64.  Binning compares in the
coordinates' dtype (float32 streams against float32 edges).

The particle-mesh deposit (``grid_deposit_frames``) and the periodic
Gaussian smoothing (``gaussian_smooth_periodic``) of the JAX module come
with :mod:`mdhelper_tpu.analysis.interface` (ROADMAP Queue 1, item 8).
"""

import numpy as np
import torch

__all__ = [
    "axis_histogram_batch",
    "bin_counts",
    "linspace_edges_f32",
    "plane_histogram_batch",
    "volume_histogram_batch",
]


def linspace_edges_f32(length, n_bins: int) -> np.ndarray:
    """float32 edges ``(n_bins + 1,)`` on ``[0, length]``, bit for bit the
    JAX package's ``jnp.linspace(0.0, length, n_bins + 1,
    dtype=float32)`` as XLA compiles it: the division by ``n_bins``
    becomes a product by the float32 reciprocal, and the products
    reassociate, so edge ``i`` is the float32 ``i * (L * (1 / n_bins))``
    with ``L`` the float32 `length`; the last edge is ``L`` itself.
    Neither ``torch.linspace`` nor a float64 ``numpy.linspace`` cast to
    float32 gives these bits for every length (e.g. 12, 14, 36.84 or
    49.99 A)."""

    length = np.float32(length)
    width = length * (np.float32(1.0) / np.float32(n_bins))
    steps = np.arange(n_bins, dtype=np.float32)
    return np.append(steps * width, length).astype(np.float32)


def _bin_indices(coords, edges):
    """``(index, in_range)`` of each coordinate: ``searchsorted(edges, x,
    side="right") - 1`` (the last edge in the last bin), clamped to the
    bins, and whether ``edges[0] <= x <= edges[-1]`` (False for NaN).
    `edges` is cast to the coordinates' dtype."""

    n_bins = edges.shape[0] - 1
    edges = edges.to(device=coords.device, dtype=coords.dtype)
    coords = coords.contiguous()
    idx = torch.searchsorted(edges, coords, right=True) - 1
    idx = torch.where(coords == edges[-1], n_bins - 1, idx)
    in_range = (coords >= edges[0]) & (coords <= edges[-1])
    return idx.clamp(0, n_bins - 1), in_range


def bin_counts(ids, valid, size: int, weights=None):
    """Totals ``(size,)`` of the entries of `ids` (int64 ids in ``[0,
    size)``) where `valid`: int64 counts, or float64 sums of `weights`
    (broadcast against `ids`).  Invalid entries go to a spill id that is
    dropped."""

    ids = torch.where(valid, ids, size).reshape(-1)
    if weights is None:
        return torch.bincount(ids, minlength=size + 1)[:size]
    weights = torch.broadcast_to(
        weights.to(device=ids.device, dtype=torch.float64), valid.shape
    )
    weights = torch.where(valid, weights, 0.0).reshape(-1)
    return torch.bincount(ids, weights=weights, minlength=size + 1)[:size]


def _frame_valid(valid, mask):
    """`valid` ``(B, ...)`` and the frame mask ``(B,)``."""

    mask = mask.to(valid.device) > 0
    return valid & mask.reshape(mask.shape + (1,) * (valid.ndim - 1))


def axis_histogram_batch(coords, mask, edges, weights=None):
    """Histogram of 1-D coordinates ``(B, N)`` over the frames of a
    chunk whose `mask` ``(B,)`` is set: int64 counts ``(n_bins,)``, or
    the float64 sums of `weights` ``(N,)`` or ``(B, N)`` (charges).  NaN
    coordinates count nothing (the JAX package marks atoms without a
    coordinate so)."""

    n_bins = edges.shape[0] - 1
    idx, ok = _bin_indices(coords, edges)
    return bin_counts(idx, _frame_valid(ok, mask), n_bins, weights)


def plane_histogram_batch(coords, mask, edges_x, edges_y, weights=None):
    """2-D histogram of plane coordinates ``(B, N, 2)`` over the frames
    whose `mask` is set: ``(n_x, n_y)`` int64 counts, or float64 sums of
    `weights` ``(N,)``."""

    n_x = edges_x.shape[0] - 1
    n_y = edges_y.shape[0] - 1
    ix, ok_x = _bin_indices(coords[..., 0], edges_x)
    iy, ok_y = _bin_indices(coords[..., 1], edges_y)
    ok = _frame_valid(ok_x & ok_y, mask)
    return bin_counts(ix * n_y + iy, ok, n_x * n_y, weights).reshape(
        n_x, n_y)


def volume_histogram_batch(coords, mask, edges_x, edges_y, edges_z,
                           weights=None, block: int = 2048):
    """3-D histogram of coordinates ``(B, N, 3)`` over the frames whose
    `mask` is set: ``(n_x, n_y, n_z)`` int64 counts, or float64 sums of
    `weights` ``(N,)``, from one ``bincount`` of the voxel ids.  `block`
    bounds the JAX package's one-hot blocks and is unused here."""

    del block
    n_x = edges_x.shape[0] - 1
    n_y = edges_y.shape[0] - 1
    n_z = edges_z.shape[0] - 1
    ix, ok_x = _bin_indices(coords[..., 0], edges_x)
    iy, ok_y = _bin_indices(coords[..., 1], edges_y)
    iz, ok_z = _bin_indices(coords[..., 2], edges_z)
    ok = _frame_valid(ok_x & ok_y & ok_z, mask)
    ids = (ix * n_y + iy) * n_z + iz
    return bin_counts(ids, ok, n_x * n_y * n_z, weights).reshape(
        n_x, n_y, n_z)
