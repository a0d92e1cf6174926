r"""
Mesh (NUFFT) structure-factor sums
==================================

Torch counterpart of :mod:`mdhelper_tpu.ops.mesh_scattering`: the trig
sums :math:`\rho(\mathbf{q}) = \sum_j w_j e^{i\mathbf{q}\cdot\mathbf{r}_j}`
on the full wavevector grid :math:`\mathbf{q} = 2\pi\mathbf{n}/L` by
Kaiser-Bessel gridding, a 3-D FFT and the window's deconvolution, in
:math:`\mathcal{O}(N w^3 + M^3 \log M)` work in place of the
:math:`\mathcal{O}(N_q N)` direct sums.

The JAX package spreads the atoms as a dense matrix chain (three
``(N, M)`` per-axis windows contracted on the TPU's matrix unit, every
atom's window evaluated on the whole axis).  The window is zero outside
``|d| < width / 2``, so here each atom is spread over its ``width``
support points on each axis only, with one ``index_add_`` of
``width**3`` values an atom into the flattened ``M**3`` float32 grid, as
GPU PME codes spread charges.  On a GPU those adds are float32 atomics
in no fixed order, so the grid's low bits (about 1e-7 relative) vary
from run to run; :func:`mesh_trig_sums_plain` forms the same grid by the
JAX package's dense chain, in a fixed order, and the tests and
``chip_smoke.py`` hold the scatter route against it.

After the spreading both follow the JAX order of operations: the grid's
mean is subtracted (the total weight would otherwise dominate the float32
FFT's roundoff: about 1e-3 relative noise at q != 0 for 100k atoms), a
complex64 ``fftn``, ``cos = Re * scale`` and ``sin = -Im * scale`` with
the per-axis deconvolution, and :math:`\rho(0)` set to the sum of the
weights.  No hand kernel is involved: the JAX package runs this in XLA.
"""

import numpy as np
import torch

__all__ = ["mesh_plan", "mesh_trig_sums", "mesh_trig_sums_plain"]

#: window values a spreading call holds at most (``width**3`` an atom).
_SPREAD_VALUES = 1 << 24


def _kb_beta(width: float, oversampling: float) -> float:
    """Beatty et al. (2005) optimal Kaiser-Bessel shape parameter."""

    return float(
        np.pi
        * np.sqrt(
            (width / oversampling) ** 2
            * (oversampling - 0.5) ** 2
            - 0.8
        )
    )


def mesh_plan(
    n_points: int,
    box,
    *,
    oversampling: float = 2.0,
    width: int = 10,
) -> dict:
    """Host-side gridding geometry for the positive-octant wavevector
    grid ``q = 2*pi*n/L``, ``n in [0, n_points)^3``.

    ``mesh`` is the per-axis FFT size (a power of two at least
    ``oversampling * 2 * n_points``), ``width`` the Kaiser-Bessel
    support in mesh units, and ``deconv`` the per-axis inverse window
    transforms evaluated at the grid frequencies (float64 on host).
    """

    box = np.asarray(box, dtype=np.float64)
    mesh = 1
    while mesh < oversampling * 2 * n_points:
        mesh *= 2
    beta = _kb_beta(width, oversampling=mesh / (2.0 * n_points))

    # Continuous FT of the KB window (support width w, unit grid):
    #   Phi(k) = w * sinh(sqrt(beta^2 - (pi w k / M)^2)) /
    #            (I0(beta) * sqrt(beta^2 - (pi w k / M)^2))
    k = np.arange(n_points, dtype=np.float64)
    arg2 = beta**2 - (np.pi * width * k / mesh) ** 2
    root = np.sqrt(np.abs(arg2))
    phi = np.where(
        arg2 > 0, np.sinh(root) / root, np.sinc(root / np.pi)
    ) * (width / np.i0(beta))
    return {
        "n_points": int(n_points),
        "mesh": int(mesh),
        "width": int(width),
        "beta": float(beta),
        "deconv": (1.0 / phi).astype(np.float64),
        "box": tuple(float(b) for b in box),
    }


def _window(d, width: int, beta: float):
    """Kaiser-Bessel window values at float32 mesh offsets `d` (zero
    outside ``|d| < width / 2``), as the JAX package forms them."""

    u2 = 1.0 - (d * np.float32(2.0 / width)) ** 2
    inside = u2 > 0
    vals = torch.special.i0(
        np.float32(beta) * torch.sqrt(torch.where(inside, u2, 0.0)))
    return torch.where(inside, vals, 0.0) * np.float32(1.0 / np.i0(beta))


def _fractions(positions, box, weights):
    """float32 fractional coordinates in [0, 1) of `positions` ``(B, N,
    3)`` and their float32 weights ``(B, N)`` (ones by default)."""

    box_t = torch.tensor(box, dtype=torch.float32, device=positions.device)
    frac = positions.to(torch.float32) / box_t
    frac = frac - torch.floor(frac)
    if weights is None:
        w = torch.ones(frac.shape[:-1], dtype=torch.float32,
                       device=frac.device)
    else:
        w = torch.broadcast_to(
            torch.as_tensor(weights, device=frac.device).to(torch.float32),
            frac.shape[:-1])
    return frac, w


def _spread_scatter(frac, w, mesh: int, width: int, beta: float):
    """``(B, M**3)`` float32 grids: each atom's window over its ``width``
    support points on each axis, added by ``index_add_`` (float32
    atomics on a GPU)."""

    n_frames, n = frac.shape[:2]
    device = frac.device
    m3 = mesh**3
    grid = torch.zeros(n_frames * m3, dtype=torch.float32, device=device)
    centers = (frac * np.float32(mesh)).reshape(-1, 3)  # (B N, 3)
    weights = w.reshape(-1)
    frame_base = (torch.arange(n_frames, device=device) * m3).repeat_interleave(n)
    steps = torch.arange(width, dtype=torch.float32, device=device)
    rows = max(1, _SPREAD_VALUES // width**3)
    for lo in range(0, centers.shape[0], rows):
        c = centers[lo:lo + rows]
        # The support points a with |a - c| < width / 2, unwrapped: the
        # offsets are those of the JAX package's wrapped ones (both exact).
        first = torch.floor(c - np.float32(width / 2)) + 1.0
        points = first[:, :, None] + steps  # (R, 3, width)
        vals = _window(points - c[:, :, None], width, beta)
        idx = points.to(torch.int64) % mesh
        wx = vals[:, 0] * weights[lo:lo + rows, None]
        p = vals[:, 1, :, None] * vals[:, 2, None, :]  # (R, w, w)
        values = wx[:, :, None, None] * p[:, None]
        flat = ((idx[:, 0, :, None, None] * mesh
                 + idx[:, 1, None, :, None]) * mesh
                + idx[:, 2, None, None, :]
                + frame_base[lo:lo + rows, None, None, None])
        grid.index_add_(0, flat.reshape(-1), values.reshape(-1))
    return grid.reshape(n_frames, m3)


def _axis_window(frac, mesh: int, width: int, beta: float):
    """Dense per-axis window matrix ``(N, mesh)``: ``W[i, a] =
    kb(dist_periodic(a, x_i * mesh))`` (the JAX package's
    ``_axis_window``)."""

    centers = frac[:, None] * np.float32(mesh)
    grid = torch.arange(mesh, dtype=torch.float32, device=frac.device)
    d = grid[None, :] - centers
    d = d - np.float32(mesh) * torch.round(d / np.float32(mesh))
    return _window(d, width, beta)


def _spread_dense(frac, w, mesh: int, width: int, beta: float,
                  atom_chunk: int = 2048):
    """``(B, M**3)`` float32 grids by the JAX package's dense chain:
    per-axis windows on the whole axis, contracted in atom chunks of
    `atom_chunk` in order, as full-float32 matrix products."""

    grids = []
    for f, wf in zip(frac, w):
        acc = torch.zeros((mesh, mesh * mesh), dtype=torch.float32,
                          device=frac.device)
        for lo in range(0, f.shape[0], atom_chunk):
            fr = f[lo:lo + atom_chunk]
            wx = _axis_window(fr[:, 0], mesh, width, beta) * wf[
                lo:lo + atom_chunk, None]
            wy = _axis_window(fr[:, 1], mesh, width, beta)
            wz = _axis_window(fr[:, 2], mesh, width, beta)
            p = (wy[:, :, None] * wz[:, None, :]).reshape(fr.shape[0], -1)
            acc = acc + wx.T @ p
        grids.append(acc.reshape(-1))
    return torch.stack(grids)


def _grid_sums(grid, total_w, n_points: int, mesh: int, deconv):
    """``(cos, sin)`` of ``(B, M**3)`` grids: mean removed, complex64
    FFT, deconvolved, rho(0) set to the total weight."""

    n_frames = grid.shape[0]
    grid = grid - grid.mean(dim=1, keepdim=True)
    # rho(q_n) = conj(FFT(mesh))[n] / Phi(n)  (the FFT is e^{-i...}).
    rho = torch.fft.fftn(
        grid.reshape(n_frames, mesh, mesh, mesh).to(torch.complex64),
        dim=(1, 2, 3))
    rho = rho[:, :n_points, :n_points, :n_points]
    dec = torch.as_tensor(np.asarray(deconv, np.float32),
                          device=grid.device)
    if dec.ndim == 1:
        dx = dy = dz = dec
    else:
        dx, dy, dz = dec
    scale = dx[:, None, None] * dy[None, :, None] * dz[None, None, :]
    cos = rho.real * scale
    sin = -rho.imag * scale
    cos[:, 0, 0, 0] = total_w
    sin[:, 0, 0, 0] = 0.0
    return cos, sin


def _mesh_sums(spread, positions, n_points, mesh, width, beta, box, deconv,
               weights):
    single = positions.ndim == 2
    if single:
        positions = positions[None]
        if weights is not None:
            weights = torch.as_tensor(weights)[None]
    frac, w = _fractions(positions, box, weights)
    grid = spread(frac, w, mesh, width, beta)
    cos, sin = _grid_sums(grid, w.sum(dim=1), n_points, mesh, deconv)
    return (cos[0], sin[0]) if single else (cos, sin)


def mesh_trig_sums(positions, *, n_points: int, mesh: int, width: int,
                   beta: float, box, deconv, weights=None):
    r"""Grid :math:`(\sum_j w_j\cos\mathbf{q}\cdot\mathbf{r}_j, \sum_j
    w_j \sin\cdot)` for every wavevector of the positive octant ``q =
    2*pi*(nx, ny, nz)/L`` with ``n`` in ``[0, n_points)^3``, by spreading
    each atom over its window's support with ``index_add_``.

    Parameters come from :func:`mesh_plan` (``deconv`` as a ``(3,
    n_points)`` or ``(n_points,)`` array).  `positions` is ``(N, 3)`` or
    a batch of frames ``(B, N, 3)`` (any coordinates: they are wrapped
    into the box), `weights` ``(N,)`` or ``(B, N)``.  Returns two float32
    tensors of shape ``(n_points,) * 3`` (C order, ``nx`` slowest), with a
    leading ``B`` for a batch.  On a GPU the spreading's float32 atomics
    add in no fixed order, so the sums vary from run to run at about 1e-7
    of the grid's values; :func:`mesh_trig_sums_plain` is the in-order
    version.
    """

    return _mesh_sums(_spread_scatter, positions, n_points, mesh, width,
                      beta, box, deconv, weights)


def mesh_trig_sums_plain(positions, *, n_points: int, mesh: int,
                         width: int, beta: float, box, deconv,
                         weights=None):
    """:func:`mesh_trig_sums` with the grid formed in a fixed order by the
    JAX package's dense matrix chain (every atom's window on the whole
    axis, ``(N, M)`` per axis, contracted in chunks of 2,048 atoms): the
    plain version that the scatter route is held against.  About ``2 N
    M**3`` float32 operations a frame."""

    return _mesh_sums(_spread_dense, positions, n_points, mesh, width,
                      beta, box, deconv, weights)
