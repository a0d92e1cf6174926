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

The particle-mesh deposit (:func:`grid_deposit_frames`) and the periodic
Gaussian smoothing (:func:`gaussian_smooth_periodic`) serve the
Willard-Chandler interfaces (:mod:`mdhelper_tpu_torch.analysis.interface`).
The JAX package deposits scatter-free (a sort, then differences of a
double-float cumsum); here the nearest-grid-point deposit is an integer
``bincount``, and the cloud-in-cell and triangular-shaped-cloud deposits
``index_add_`` their float32 corner weights into a float64 grid that is
rounded once to float32: per-cell totals of the same float32 weights,
each rounded once, as the JAX package's, and free of the run-to-run low
bits of float32 atomics.
"""

import numpy as np
import torch

__all__ = [
    "axis_histogram_batch",
    "bin_counts",
    "gaussian_smooth_periodic",
    "grid_deposit_frames",
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


def grid_deposit_frames(coords, n_cells_dim, box, order=1):
    r"""Particle-mesh deposit of wrapped coordinates onto a 3-D grid,
    frame by frame.  Grid point :math:`i` sits at the cell center
    :math:`(i+1/2)h`; the P3M assignment windows about it are

    * ``order=1`` — nearest grid point (1 corner, exact counts);
    * ``order=2`` — cloud-in-cell (8 corners, linear weights);
    * ``order=3`` — triangular-shaped cloud (27 corners, quadratic
      B-spline weights).

    Parameters
    ----------
    coords : `torch.Tensor`
        Wrapped coordinates in ``[0, L)``, shape ``(B, N, 3)``.
    n_cells_dim : `tuple`
        Grid shape ``(nx, ny, nz)``.
    box : `torch.Tensor`
        Orthorhombic box lengths, shape ``(3,)`` or per-frame
        ``(B, 3)``.
    order : `int`, default 1
        Assignment order (1, 2 or 3).

    Returns
    -------
    counts : `torch.Tensor`
        Per-frame deposited fields, shape ``(B, nx, ny, nz)``, in the
        coordinates' dtype; each particle contributes total weight 1.
        The weights are formed in float32, operation for operation as
        the JAX package writes them (XLA contracts some of them into fused
        multiply-adds, so a cell's total can differ from the JAX
        package's by an ulp), and each cell's total is summed in float64
        and rounded once.
    """

    nx, ny, nz = (int(n) for n in n_cells_dim)
    n_cells = nx * ny * nz
    dtype = coords.dtype
    device = coords.device
    frames = coords.shape[0]
    dims = torch.tensor([nx, ny, nz], dtype=dtype, device=device)
    dims_i = torch.tensor([nx, ny, nz], dtype=torch.int64, device=device)
    scale = dims / torch.as_tensor(box, dtype=dtype, device=device)
    if scale.ndim == 2:  # per-frame boxes: (B, 3) -> (B, 1, 3)
        scale = scale[:, None, :]
    scaled = coords * scale
    frame_base = torch.arange(frames, device=device)[:, None] * n_cells

    if order == 1:
        # float-to-int conversion truncates toward zero, as XLA's
        cell = torch.minimum(torch.clamp(scaled.to(torch.int64), min=0),
                             dims_i - 1)
        cid = (cell[..., 0] * ny + cell[..., 1]) * nz + cell[..., 2]
        counts = torch.bincount((cid + frame_base).reshape(-1),
                                minlength=frames * n_cells)
        return counts.to(dtype).reshape(frames, nx, ny, nz)

    s = scaled - 0.5
    if order == 2:
        # corners floor(s) and floor(s) + 1
        base = torch.floor(s)
        f = s - base
        offsets = (0, 1)
        weights = (1.0 - f, f)
    elif order == 3:
        base = torch.round(s)
        f = s - base  # in [-1/2, 1/2]
        lo, hi = 0.5 - f, 0.5 + f
        offsets = (-1, 0, 1)
        weights = (0.5 * (lo * lo), 0.75 - f * f, 0.5 * (hi * hi))
    else:
        raise ValueError("order must be 1, 2 or 3.")
    base = base.to(torch.int64)
    offsets = torch.tensor(offsets, dtype=torch.int64, device=device)
    # (B, N, 3, K) per-axis corner indices (periodic) and weights
    idx = torch.remainder(base[..., None] + offsets, dims_i[:, None])
    wts = torch.stack(weights, dim=-1)
    cid = ((idx[..., 0, :, None, None] * ny + idx[..., 1, None, :, None])
           * nz + idx[..., 2, None, None, :]).reshape(frames, -1)
    weight = (wts[..., 0, :, None, None] * wts[..., 1, None, :, None]
              * wts[..., 2, None, None, :]).reshape(frames, -1)
    grid = torch.zeros(frames * n_cells, dtype=torch.float64, device=device)
    grid.index_add_(0, (cid + frame_base).reshape(-1),
                    weight.reshape(-1).to(torch.float64))
    return grid.to(dtype).reshape(frames, nx, ny, nz)


def gaussian_smooth_periodic(fields, box, xi, order=1):
    r"""Periodic Gaussian smoothing of per-frame grid deposits by 3-D
    real FFTs: the coarse-grained density of Willard & Chandler
    (J. Phys. Chem. B 114, 1954 (2010)), particle-mesh style — deposit,
    then convolve with the normalized Gaussian :math:`\phi(r) =
    (2\pi\xi^2)^{-3/2}\exp(-r^2/2\xi^2)` in Fourier space, where the
    periodic image sum is exact (:math:`\hat\phi(k) = e^{-k^2\xi^2/2}`).

    Parameters
    ----------
    fields : `torch.Tensor`
        Per-frame deposits from :func:`grid_deposit_frames`, shape
        ``(B, nx, ny, nz)``.
    box : `torch.Tensor`
        Orthorhombic box lengths, shape ``(3,)`` or per-frame
        ``(B, 3)``.
    xi : `float`
        Gaussian coarse-graining width :math:`\xi` (Angstrom).
    order : `int`, default 1
        Assignment order of the deposit: divides by the B-spline window
        :math:`\prod_a \mathrm{sinc}^{\,\mathrm{order}}(k_a h_a/2)`
        (the P3M/PME deconvolution); ``order=0`` skips it.

    Returns
    -------
    density : `torch.Tensor`
        Smoothed number densities (length^-3), shape ``(B, nx, ny,
        nz)``, in the fields' dtype: the deposits over the grid-cell
        volume, so the field integrates to the particle count.  The
        kernel and the cell volume are formed in the fields' dtype as the
        JAX package forms them, but for the exponential, taken in float64
        and rounded once; the transforms (``torch.fft.rfftn`` and
        ``irfftn``: cuFFT on the card) run in float64 and the field is
        rounded once, so the card and the CPU give the same bits but for
        near-ties (and far below an ulp of the maximum where the field
        is tiny), where the JAX package's float32 transforms round at
        about 1e-7 of the field.
    """

    nx, ny, nz = (int(n) for n in fields.shape[1:])
    dtype = fields.dtype
    device = fields.device
    box = torch.as_tensor(box, dtype=dtype, device=device)
    batched = box.ndim == 2  # per-frame boxes: the kernel grows a B axis
    mx = np.fft.fftfreq(nx) * nx
    my = np.fft.fftfreq(ny) * ny
    mz = np.fft.rfftfreq(nz) * nz

    def axis_kernel(m, n, length):
        m_dev = torch.as_tensor(m, dtype=dtype, device=device)
        if batched:
            k = (2 * np.pi) * m_dev / length[:, None]
        else:
            k = (2 * np.pi) * m_dev / length
        xk = xi * k
        # exp in float64, rounded once: float32 exps round otherwise on
        # the CPU, the card and XLA
        kern = torch.exp(-0.5 * (xk * xk).to(torch.float64)).to(dtype)
        if order:
            # B-spline window sinc^order(k h / 2), kh/2 = pi m / n
            kern = kern / torch.as_tensor(np.sinc(m / n) ** order,
                                          dtype=dtype, device=device)
        return kern

    kx = axis_kernel(mx, nx, box[..., 0])
    ky = axis_kernel(my, ny, box[..., 1])
    kz = axis_kernel(mz, nz, box[..., 2])
    kernel = (kx[..., :, None, None] * ky[..., None, :, None]
              * kz[..., None, None, :])
    # float64 transforms of the float32 deposits and kernel, rounded once;
    # the products and the division run in place, so a frame holds its
    # spectrum, cuFFT's copy of it and the float64 output at the peak
    spectra = torch.fft.rfftn(fields.to(torch.float64), dim=(1, 2, 3))
    spectra *= kernel.to(torch.float64)
    smooth = torch.fft.irfftn(spectra, s=(nx, ny, nz), dim=(1, 2, 3))
    del spectra
    cell_volume = box.prod(dim=-1) / (nx * ny * nz)
    if batched:
        cell_volume = cell_volume[:, None, None, None]
    smooth /= cell_volume.to(torch.float64)
    return smooth.to(dtype)
