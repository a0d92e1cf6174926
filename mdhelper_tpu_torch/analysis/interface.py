r"""
Instantaneous liquid interfaces
===============================

Willard–Chandler instantaneous interfaces (J. Phys. Chem. B 114,
1954–1958 (2010)), ported from :mod:`mdhelper_tpu.analysis.interface`:
the coarse-grained density field :math:`\bar\rho(\mathbf{r},t) = \sum_i
\phi(|\mathbf{r} - \mathbf{r}_i(t)|;\xi)` with a normalized Gaussian
:math:`\phi` of width :math:`\xi`, and the interface as its iso-density
surface :math:`\bar\rho = c`.

Each chunk runs on the analysis's device as a particle-mesh pipeline: a
deposit onto the grid
(:func:`mdhelper_tpu_torch.ops.profiles.grid_deposit_frames`), the
periodic Gaussian convolution by 3-D real FFTs with the deconvolution of
the assignment window
(:func:`mdhelper_tpu_torch.ops.profiles.gaussian_smooth_periodic`), and a
vectorized first-crossing interpolation along the slab normal.  Frames
are a batch axis; per-frame height maps stream to the host one chunk
late.

The smoothing transforms run in float64 and round the field once to
float32, and every float reduction of a chunk (the deposit, the bulk
level) is summed in float64, so the card reproduces the CPU's fields,
heights and counts but for near-ties.  The JAX package's float32
transforms round at about 1e-7 of the field, so a grid point within that
of the iso-density level, or of half the field's maximum (the bulk
mask), can fall on the other side of it than in the JAX package: heights
stay continuous across such a point, the level moves by about one over
the bulk mask's size, and a column whose maximum sits at the level can
flip between a height and NaN.  Where XLA's CPU backend contracts a
product and a sum (the wraps, the bilinear interpolation, the minimum
image along the normal), the port rounds them once too
(:func:`~mdhelper_tpu_torch.ops.doublefloat.fma32`).

A chunk streams as many frames as its coordinates' ``_chunk_bytes`` hold,
hundreds for a slab of tens of thousands of sites, while a frame's grid
pipeline holds tens of bytes a grid point.  So each class runs a chunk's
frames through the grid in passes that fit its ``_grid_bytes``
(:func:`_grid_pass_frames`).
"""

import warnings
from numbers import Real
from typing import Union

import numpy as np
import torch

from .. import Q_, ureg
from ..ops.doublefloat import fma32
from ..ops.pbc import wrap_positions
from ..ops.profiles import (
    _bin_indices,
    _frame_valid,
    bin_counts,
    gaussian_smooth_periodic,
    grid_deposit_frames,
)
from .base import DynamicAnalysisBase
from .profile import _broadcast_groupings, _pmf_kbt
from .structure import (
    _column_selector,
    _frame_boxes,
    _group_segment_ids,
    _resolve_group_charges,
    _segment_com_reducer,
)

__all__ = ["IntrinsicDensityProfile", "WillardChandlerInterface"]

#: device bytes that a frame of the grid pipeline holds at its peak, per
#: grid point (the float32 deposit and field, the float64 input of the
#: transform, the complex128 spectrum, cuFFT's copy of it and the float64
#: output, and the float64 terms of the bulk level) and per surface entity
#: and stencil corner (the deposit's int64 cell ids and float64 weights).
_BYTES_PER_POINT, _BYTES_PER_CORNER = 64, 32


def _grid_pass_frames(grid_bytes, n_cells, n_entities, order):
    """Frames that one pass of the grid pipeline takes: as many as
    `grid_bytes` holds for a grid of `n_cells` points and `n_entities`
    deposited entities of assignment `order`, at least one."""

    per_frame = (_BYTES_PER_POINT * int(np.prod(n_cells))
                 + _BYTES_PER_CORNER * n_entities * order**3)
    return max(1, int(grid_bytes) // per_frame)


def coarse_grained_heights(pts, boxes, n_cells, xi, order, axis,
                           fixed_level):
    r"""Per-frame Willard–Chandler pipeline core: particle-mesh
    deposit, FFT Gaussian smoothing, iso-density level, and the two
    interface height maps along ``axis``.

    Parameters
    ----------
    pts : `torch.Tensor`
        Wrapped surface-group coordinates, shape ``(B, N, 3)``.
    boxes : `torch.Tensor`
        Per-frame orthorhombic box lengths, shape ``(B, 3)``.
    n_cells : `tuple`
        Grid shape ``(nx, ny, nz)``.
    xi, order : see
        :func:`mdhelper_tpu_torch.ops.profiles.grid_deposit_frames`.
    axis : `int`
        Slab normal (0-2).
    fixed_level : `float` or None
        Iso-density level; None = half the per-frame bulk density
        (bulk = mean of the field over grid points at or above half its
        maximum, summed in float64 and rounded to the field's dtype).

    Returns
    -------
    dens : `torch.Tensor`
        Smoothed density fields, shape ``(B, nx, ny, nz)``.
    level : `torch.Tensor`
        Per-frame iso-density levels, shape ``(B,)``.
    heights : `torch.Tensor`
        ``(lower, upper)`` height maps, shape ``(2, B, n1, n2)``
        (transverse axes in coordinate order); NaN where a column
        never reaches the level.
    """

    n_axis = n_cells[axis]
    counts = grid_deposit_frames(pts, n_cells, boxes, order)
    dens = gaussian_smooth_periodic(counts, boxes, xi, order)
    del counts
    if fixed_level is None:
        dmax = dens.amax(dim=(1, 2, 3), keepdim=True)
        bulk_mask = dens >= 0.5 * dmax
        bulk = ((dens.to(torch.float64) * bulk_mask).sum(dim=(1, 2, 3))
                / bulk_mask.sum(dim=(1, 2, 3)))
        level = 0.5 * bulk.to(dens.dtype)
    else:
        level = torch.full((dens.shape[0],), fixed_level, dtype=dens.dtype,
                           device=dens.device)
    dens_t = torch.movedim(dens, 1 + axis, -1)
    heights = slab_interface_heights(
        dens_t, level[:, None, None, None], n_axis,
        boxes[:, axis, None, None],
    )
    return dens, level, heights


def interpolate_height_maps(maps, frac):
    r"""Periodic bilinear interpolation of per-frame height maps at
    fractional transverse coordinates.

    Parameters
    ----------
    maps : `torch.Tensor`
        Height maps, shape ``(B, n1, n2)``; NaN marks unresolved
        columns (NaN propagates to any point whose interpolation
        stencil touches one).
    frac : `torch.Tensor`
        Fractional transverse coordinates in ``[0, 1)``, shape
        ``(B, N, 2)``.

    Returns
    -------
    values : `torch.Tensor`
        Interpolated heights, shape ``(B, N)``: the four corners'
        weighted terms added in row-major order with fused multiply-adds,
        as XLA compiles the JAX package's reduction.
    """

    n1, n2 = (int(n) for n in maps.shape[1:])
    # Grid point j sits at fractional (j + 1/2) / n (n u - 1/2 fused, as
    # XLA contracts it).
    u = fma32(frac[..., 0], n1, -0.5)
    v = fma32(frac[..., 1], n2, -0.5)
    i0 = torch.floor(u)
    j0 = torch.floor(v)
    fu = (u - i0)[..., None]
    fv = (v - j0)[..., None]
    two = torch.arange(2, device=maps.device)
    ii = torch.remainder(i0.to(torch.int64)[..., None] + two, n1)
    jj = torch.remainder(j0.to(torch.int64)[..., None] + two, n2)
    flat = maps.reshape(maps.shape[0], -1)
    cid = ii[..., :, None] * n2 + jj[..., None, :]  # (B, N, 2, 2)
    corners = torch.gather(flat, 1, cid.reshape(cid.shape[0], -1)).reshape(
        cid.shape)
    wu = torch.cat((1.0 - fu, fu), dim=-1)  # (B, N, 2)
    wv = torch.cat((1.0 - fv, fv), dim=-1)
    p = corners * wu[..., :, None]
    # XLA's reduction: each (corner * wu) * wv term fused into the sum
    total = p[..., 0, 0] * wv[..., 0]
    for i, j in ((0, 1), (1, 0), (1, 1)):
        total = fma32(p[..., i, j], wv[..., j], total)
    return total


def _setup_wc_geometry(obj, what, axis, xi, n_cells, level, order):
    """Shared Willard-Chandler constructor validation: sets
    ``_triclinic``, ``_axis``, ``_trans_axes``, ``_dimensions``,
    ``_xi``, ``_n_cells``, ``_level`` and ``_order`` on `obj`."""

    obj._setup_periodic_box()
    if obj._triclinic:
        raise ValueError(f"{what} needs an orthorhombic cell.")

    if isinstance(axis, str):
        if axis not in ("x", "y", "z"):
            raise ValueError("axis must be 'x', 'y', 'z' or 0-2.")
        axis = "xyz".index(axis)
    if axis not in (0, 1, 2):
        raise ValueError("axis must be 'x', 'y', 'z' or 0-2.")
    obj._axis = int(axis)
    obj._trans_axes = tuple(a for a in range(3) if a != obj._axis)

    obj._require_box(what)
    obj._dimensions = np.asarray(obj.universe.dimensions[:3],
                                 dtype=np.float64)

    obj._xi = float(xi)
    if obj._xi <= 0:
        raise ValueError("xi must be positive.")
    if n_cells is None:
        n_cells = tuple(
            1 << int(np.ceil(np.log2(max(8.0, L / (obj._xi / 2)))))
            for L in obj._dimensions
        )
    elif isinstance(n_cells, Real):
        n_cells = (int(n_cells),) * 3
    n_cells = tuple(int(n) for n in n_cells)
    if len(n_cells) != 3 or min(n_cells) < 4:
        raise ValueError("n_cells must be an int >= 4 or a triple of them.")
    obj._n_cells = n_cells
    obj._level = None if level is None else float(level)
    if order not in (1, 2, 3):
        raise ValueError("order must be 1 (NGP), 2 (CIC) or 3 (TSC).")
    obj._order = int(order)


def slab_interface_heights(density, level, n_axis, length_axis):
    r"""Locate the two iso-density crossings of a slab along the LAST
    grid axis by linear interpolation, vectorized over frames and
    transverse columns.

    For each column the lower interface is the first cell (from the
    box floor) with :math:`\bar\rho \geq c` and the upper interface
    the last, each refined by interpolating the crossing between that
    cell and its outward neighbor (periodic).  Columns that never
    reach the level return NaN.  A slab straddling the periodic
    boundary along the normal yields wrapped (discontinuous) heights —
    recenter the trajectory first.

    Parameters
    ----------
    density : `torch.Tensor`
        Smoothed densities with the slab normal LAST, shape
        ``(..., n1, n2, n_axis)``.
    level : `torch.Tensor` or `float`
        Iso-density level, broadcastable to ``density`` (e.g. a
        per-frame ``(B, 1, 1, 1)`` column).
    n_axis : `int`
        Grid size along the normal.
    length_axis : `float` or `torch.Tensor`
        Box length along the normal.

    Returns
    -------
    heights : `torch.Tensor`
        ``(lower, upper)`` crossing coordinates in ``[0, L)``, shape
        ``(2, ..., n1, n2)``; NaN where the column has no crossing.
    """

    h = length_axis / n_axis
    above = density >= level
    occupied = above.any(dim=-1)

    # The interpolation fraction needs the level with the normal axis
    # dropped.
    level_t = level
    if isinstance(level_t, torch.Tensor) and level_t.ndim:
        level_t = level_t.squeeze(-1)

    def interp(first_idx, outward):
        idx = first_idx[..., None]
        d_in = torch.gather(density, -1, idx)[..., 0]
        d_out = torch.gather(density, -1,
                             torch.remainder(idx + outward, n_axis))[..., 0]
        denom = d_in - d_out
        frac = torch.where(
            denom > 0,
            (d_in - level_t) / torch.where(denom > 0, denom, 1.0),
            0.0,
        )
        return torch.clamp(frac, 0.0, 1.0)

    # argmax returns the first maximal index
    above_i = above.to(torch.uint8)
    lower_idx = torch.argmax(above_i, dim=-1)
    upper_idx = n_axis - 1 - torch.argmax(above_i.flip(-1), dim=-1)
    lower = (lower_idx + 0.5 - interp(lower_idx, -1)) * h
    upper = (upper_idx + 0.5 + interp(upper_idx, +1)) * h
    heights = torch.remainder(torch.stack((lower, upper)), length_axis)
    return torch.where(occupied[None], heights, torch.nan)


class WillardChandlerInterface(DynamicAnalysisBase):
    r"""Willard–Chandler instantaneous interfaces of a liquid slab (see
    the module docstring).

    Each frame, the group's coarse-grained density
    :math:`\bar\rho(\mathbf{r})` is evaluated on a regular grid
    (Gaussian width `xi`), and the two iso-density crossings along
    `axis` are located per transverse grid column — instantaneous
    height maps :math:`\zeta^\pm(x_1, x_2, t)` of the lower and upper
    interfaces.  :meth:`calculate_spectrum` adds the capillary-wave
    spectrum and :meth:`calculate_surface_tension` its low-:math:`q`
    surface tension.

    Parameters
    ----------
    group : `AtomGroup`
        The condensed phase (e.g. the liquid's oxygens).
    grouping : `str`, default ``"atoms"``
        ``"atoms"``, ``"residues"`` or ``"segments"`` (centers of
        mass of wrapped coordinates for molecule groupings).
    axis : `str` or `int`, default ``"z"``
        Slab normal.  The slab must not straddle the periodic
        boundary along this axis (recenter first).
    xi : `float`, keyword-only, default 2.4
        Gaussian coarse-graining width (Angstrom; the water value of
        Willard & Chandler).
    n_cells : `int` or triple, keyword-only, optional
        Grid points per box axis.  Default: the smallest power of two
        giving a spacing :math:`\leq \xi/2` per axis.
    level : `float`, keyword-only, optional
        Iso-density level :math:`c` (length^-3).  Default: half the
        per-frame bulk density, the bulk estimated as the mean of the
        smoothed field over grid points above half its maximum.
    order : `int`, keyword-only, default 2
        Particle-mesh assignment order: 1 = NGP, 2 = CIC, 3 = TSC.
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units.
    parallel : `bool`, keyword-only, default False
        Shard the frames over the ranks of :mod:`torch.distributed` (a
        world of one without a process group): each rank builds the
        fields of its block of each chunk in grid passes of
        ``_grid_bytes``, the density of its real frames (mask 1) adds up
        over the ranks, and the per-frame heights and levels are
        gathered in frame order.
    device : `torch.device` or `str`, keyword-only, optional
        Where the fields are built (default: the first CUDA device);
        ``"cpu"`` for the CPU.

    Notes
    -----
    Per-frame (NPT) boxes are honored: each frame wraps, deposits,
    smooths, and scales its heights against its own cell.  The grid
    point COUNTS are fixed, so ``results.bins`` and
    ``results.density_field`` report the constructor box's geometry;
    the capillary spectrum's wavevectors likewise use the constructor's
    transverse lengths.

    Results
    -------
    ``results.bins``
        Grid centers per box axis (Angstrom), three arrays.
    ``results.density_field``
        Time-averaged coarse-grained density (Angstrom^-3), shape
        ``(nx, ny, nz)``.
    ``results.heights``
        Instantaneous height maps (Angstrom), shape
        ``(2, N_frames, n1, n2)`` — ``[lower, upper]``; NaN where a
        column never reaches the level.
    ``results.levels``
        Per-frame iso-density level used (Angstrom^-3).
    ``results.mean_heights``
        Transverse-averaged interface positions per frame, shape
        ``(2, N_frames)``.
    ``results.interface_width``
        Time-averaged RMS capillary roughness per interface, shape
        ``(2,)``.
    """

    #: device bytes that one pass of the grid pipeline may hold: a
    #: chunk's frames are deposited, smoothed and searched that many at a
    #: time (:func:`_grid_pass_frames`).
    _grid_bytes: int = 1 << 30

    _checkpointable_stores = True
    _rank_sharded = True

    def _checkpoint_attrs(self) -> tuple:
        return ("_heights",)

    def _result_stores(self) -> dict:
        return {"levels": 0}

    def __init__(
        self,
        group,
        grouping: str = "atoms",
        axis: Union[str, int] = "z",
        *,
        xi: float = 2.4,
        n_cells: Union[int, tuple] = None,
        level: float = None,
        order: int = 2,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ) -> None:
        self._group = group
        self.universe = group.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device, **kwargs)
        if grouping not in ("atoms", "residues", "segments"):
            raise ValueError(
                "grouping must be 'atoms', 'residues' or 'segments'."
            )
        self._grouping = grouping
        _setup_wc_geometry(self, "WillardChandlerInterface", axis, xi,
                           n_cells, level, order)
        self._reduced = reduced
        # Stream in group order: masses and segment ids are group-ordered.
        self._atom_indices = np.asarray(group.ix)
        self._seg_info = _group_segment_ids(group, grouping)

    def _prepare(self) -> None:
        nx, ny, nz = self._n_cells
        self.results.bins = [
            (np.arange(n) + 0.5) * L / n
            for n, L in zip(self._n_cells, self._dimensions)
        ]
        if not self._reduced:
            self.results.units = {
                "results.bins": ureg.angstrom,
                "results.density_field": ureg.angstrom**-3,
                "results.heights": ureg.angstrom,
                "results.levels": ureg.angstrom**-3,
                "results.mean_heights": ureg.angstrom,
                "results.interface_width": ureg.angstrom,
            }
        n1, n2 = (self._n_cells[a] for a in self._trans_axes)
        # frame-leading buffer; results.heights is its (2, T, n1, n2) view
        self._heights = np.full((self.n_frames, 2, n1, n2), np.nan)
        self.results.levels = np.full(self.n_frames, np.nan)
        self._store_offset = 0
        device = self._device
        self._carry = {
            "density": torch.zeros((nx, ny, nz), dtype=torch.float64,
                                   device=device),
            "n": torch.zeros((), dtype=torch.float64, device=device),
        }
        self._make_update()

    def _make_update(self) -> None:
        device = self._device
        n_cells = self._n_cells
        axis = self._axis
        seg, n_seg = self._seg_info
        reduce = (None if seg is None else _segment_com_reducer(
            seg, n_seg, self._group.masses, device))
        xi = self._xi
        order = self._order
        fixed_level = self._level
        per_pass = _grid_pass_frames(
            self._grid_bytes, n_cells,
            len(self._atom_indices) if seg is None else n_seg, order)

        def update(carry, positions, dimensions, mask):
            # Each frame deposits, smooths and scales its heights against
            # its own cell; the grid point counts stay fixed.
            boxes = _frame_boxes(dimensions, False)[0]
            pts = positions if reduce is None else reduce(positions)
            pts = wrap_positions(pts, boxes[:, None, :])
            mask = mask.to(device=pts.device, dtype=torch.float64)
            density = carry["density"]
            heights, levels = [], []
            for lo in range(0, pts.shape[0], per_pass):
                hi = lo + per_pass
                dens, level, pass_heights = coarse_grained_heights(
                    pts[lo:hi], boxes[lo:hi], n_cells, xi, order, axis,
                    fixed_level
                )
                # frame by frame, in float64 without a float64 copy of the
                # pass's fields
                for f in range(dens.shape[0]):
                    density = density + dens[f] * mask[lo + f]
                heights.append(pass_heights)
                levels.append(level)
            carry = {"density": density, "n": carry["n"] + mask.sum()}
            return carry, (torch.movedim(torch.cat(heights, dim=1), 0, 1),
                           torch.cat(levels))

        self._update = update

    def _store_chunk(self, extras, batch) -> None:
        heights, levels = extras
        n_real = batch.n_real
        lo = self._store_offset
        self._heights[lo:lo + n_real] = heights[:n_real]
        self.results.levels[lo:lo + n_real] = levels[:n_real]
        self._store_offset += n_real

    def _conclude(self) -> None:
        n = float(self._carry["n"])
        self.results.density_field = (
            self._carry["density"].cpu().numpy() / max(n, 1.0)
        )
        self.results.heights = np.moveaxis(self._heights, 0, 1)
        heights = self.results.heights
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            mean = np.nanmean(heights, axis=(2, 3))
            self.results.mean_heights = mean
            fluct = heights - mean[..., None, None]
            self.results.interface_width = np.sqrt(
                np.nanmean(fluct**2, axis=(1, 2, 3))
            )

    def calculate_spectrum(self) -> None:
        r"""Capillary-wave spectrum of the height fluctuations:
        :math:`S(q) = A\,\langle|\hat\zeta_\mathbf{q}|^2\rangle` with
        :math:`\hat\zeta_\mathbf{q} = (n_1 n_2)^{-1}\sum_\mathbf{r}
        (\zeta(\mathbf{r}) - \bar\zeta)\,e^{-i\mathbf{q}\cdot
        \mathbf{r}}`, radially averaged over transverse wavevector
        shells of width :math:`\min_a 2\pi/L_a`.  Frames with
        unresolved columns (NaN heights) are skipped per interface.

        Results: ``results.spectrum_wavenumbers`` (Angstrom^-1,
        shell centers, :math:`q > 0`) and ``results.spectrum``
        (Angstrom^4, shape ``(2, n_q)``; NaN for empty shells or an
        interface with no complete frames).
        """

        heights = self.results.heights
        _, n_frames, n1, n2 = heights.shape
        L1, L2 = (self._dimensions[a] for a in self._trans_axes)
        area = L1 * L2

        q1 = 2 * np.pi * np.fft.fftfreq(n1, d=L1 / n1)
        q2 = 2 * np.pi * np.fft.fftfreq(n2, d=L2 / n2)
        q_mag = np.hypot(q1[:, None], q2[None, :])
        dq = 2 * np.pi / max(L1, L2)
        shells = np.round(q_mag / dq).astype(int)
        n_q = shells.max() + 1
        shell_counts = np.bincount(shells.ravel(), minlength=n_q)

        spectra = np.full((2, n_q), np.nan)
        for side in range(2):
            maps = heights[side]
            valid = ~np.isnan(maps).any(axis=(1, 2))
            if not valid.any():
                continue
            maps = maps[valid]
            fluct = maps - maps.mean(axis=(1, 2), keepdims=True)
            zhat = np.fft.fft2(fluct) / (n1 * n2)
            power = (np.abs(zhat) ** 2).mean(axis=0)
            sums = np.bincount(
                shells.ravel(), weights=power.ravel(), minlength=n_q
            )
            with np.errstate(invalid="ignore"):
                spectra[side] = area * sums / shell_counts

        keep = shell_counts > 0
        keep[0] = False  # q = 0 carries the (removed) mean
        self.results.spectrum_wavenumbers = np.arange(n_q)[keep] * dq
        self.results.spectrum = spectra[:, keep]
        if not self._reduced:
            self.results.units["results.spectrum_wavenumbers"] = (
                ureg.angstrom**-1
            )
            self.results.units["results.spectrum"] = ureg.angstrom**4

    def calculate_surface_tension(
        self,
        temperature: Union[float, "Q_"],
        *,
        q_max: float = None,
    ) -> None:
        r"""Surface tension from the low-:math:`q` capillary-wave
        spectrum, :math:`S(q) = k_\mathrm{B}T/(\gamma q^2)`: a
        least-squares fit of :math:`1/S` against :math:`q^2` through
        the origin over shells with :math:`q \leq q_\mathrm{max}`
        (default :math:`1/\xi`, inside the capillary regime).

        Results: ``results.surface_tension`` (kJ/mol/Angstrom^2, or
        the reduced :math:`\epsilon/\sigma^2`), shape ``(2,)``.
        """

        if "spectrum" not in self.results:
            self.calculate_spectrum()
        kbt = _pmf_kbt(temperature, self._reduced)
        if q_max is None:
            q_max = 1.0 / self._xi
        q = self.results.spectrum_wavenumbers
        window = q <= q_max
        if not window.any():
            raise ValueError(
                "No spectrum shells below q_max; enlarge q_max or the "
                "transverse box."
            )
        gammas = np.full(2, np.nan)
        for side in range(2):
            s = self.results.spectrum[side][window]
            qs = q[window]
            good = np.isfinite(s) & (s > 0)
            if not good.any():
                continue
            q2 = qs[good] ** 2
            inv_s = 1.0 / s[good]
            gammas[side] = kbt * (q2 @ inv_s) / (q2 @ q2)
        self.results.surface_tension = gammas
        if not self._reduced:
            self.results.units["results.surface_tension"] = (
                ureg.kilojoule / ureg.mole / ureg.angstrom**2
            )


class IntrinsicDensityProfile(DynamicAnalysisBase):
    r"""Intrinsic (interface-relative) density profiles
    :math:`\rho_g(d)` of one or more groups, measured along the slab
    normal from the instantaneous Willard–Chandler interface of a
    surface-defining group.

    Each frame, the surface group's coarse-grained density defines
    the two iso-density height maps :math:`\zeta^\pm(x_1, x_2)`
    (exactly as :class:`WillardChandlerInterface`); every profiled
    entity is assigned the signed normal distance to the bilinearly
    interpolated interface under its transverse position,

    .. math::

       d^- = z - \zeta^-(x_1, x_2), \qquad
       d^+ = \zeta^+(x_1, x_2) - z,

    minimum-imaged along the normal — **positive into the liquid**
    for both interfaces — and histogrammed in float32 against the
    float64 ``numpy.linspace`` edges rounded to float32 (integer
    ``bincount`` counts).

    Parameters
    ----------
    surface : `AtomGroup`
        The condensed phase defining the interface (e.g. water
        oxygens).
    groups : `AtomGroup` or array-like, optional
        Group(s) to profile.  Default: the surface group itself.
    groupings : `str` or array-like, default ``"atoms"``
        ``"atoms"``, ``"residues"`` or ``"segments"`` per profiled
        group.
    axis : `str` or `int`, default ``"z"``
        Slab normal (the slab must not straddle the periodic
        boundary along it; recenter first).
    n_bins : `int`, default 200
        Distance histogram bins.
    range : array-like, keyword-only, optional
        ``(d_min, d_max)`` distance window (Angstrom).  Default:
        ``(-L_axis/2, L_axis/2)`` — the full minimum-image range.
    surface_grouping : `str`, keyword-only, default ``"atoms"``
        Grouping for the surface-defining group.
    xi, n_cells, level, order :
        Willard–Chandler parameters (see
        :class:`WillardChandlerInterface`).
    side : `str`, keyword-only, default ``"both"``
        ``"lower"``, ``"upper"`` or ``"both"`` (average of the two
        interfaces' profiles).
    charges : array-like, keyword-only, optional
        Per-group entity charges (auto-detected from the topology when
        uniform).
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units.
    parallel : `bool`, keyword-only, default False
        Shard the frames over the ranks of :mod:`torch.distributed` (a
        world of one without a process group): each rank finds the
        surfaces of its block of each chunk and bins its real frames
        (mask 1), and the counts, areas and frame counts add up over the
        ranks.
    device : `torch.device` or `str`, keyword-only, optional
        Where the fields are built (default: the first CUDA device);
        ``"cpu"`` for the CPU.

    Notes
    -----
    Entities over unresolved interface columns (NaN height anywhere
    in their bilinear stencil) drop out of the histogram; the
    normalization still uses the full transverse area.  Per-frame
    (NPT) boxes are honored as in :class:`WillardChandlerInterface`.

    Results
    -------
    ``results.bins`` / ``results.edges``
        Distance bin centers / edges (Angstrom).
    ``results.counts``
        Raw per-side counts, shape ``(G, 2, n_bins)`` —
        ``[lower, upper]``.
    ``results.number_densities``
        Intrinsic number densities (Angstrom^-3), shape
        ``(G, n_bins)``, per `side`.
    ``results.charge_densities``
        :math:`\sum_g q_g \rho_g(d)` (e/Angstrom^3), shape
        ``(n_bins,)`` — when entity charges are uniform per group or
        `charges` is given.
    """

    _rank_sharded = True
    #: as :attr:`WillardChandlerInterface._grid_bytes`.
    _grid_bytes: int = 1 << 30

    def __init__(
        self,
        surface,
        groups=None,
        groupings: Union[str, tuple] = "atoms",
        axis: Union[str, int] = "z",
        n_bins: int = 200,
        *,
        range=None,
        surface_grouping: str = "atoms",
        xi: float = 2.4,
        n_cells: Union[int, tuple] = None,
        level: float = None,
        order: int = 2,
        side: str = "both",
        charges=None,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ) -> None:
        self._surface = surface
        self.universe = surface.universe
        if groups is None:
            groups = [surface]
        self._groups = (
            [groups] if hasattr(groups, "universe") else list(groups)
        )
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device, **kwargs)
        _setup_wc_geometry(self, "IntrinsicDensityProfile", axis, xi,
                           n_cells, level, order)
        if surface_grouping not in ("atoms", "residues", "segments"):
            raise ValueError(
                "surface_grouping must be 'atoms', 'residues' or "
                "'segments'."
            )
        if side not in ("lower", "upper", "both"):
            raise ValueError("side must be 'lower', 'upper' or 'both'.")
        self._side = side
        self._n_groups = len(self._groups)
        self._groupings = _broadcast_groupings(self._groups, groupings)
        self._charges = _resolve_group_charges(
            self._groups, self._groupings, charges, reduced
        )
        self._reduced = reduced

        self._n_bins = int(n_bins)
        if self._n_bins < 1:
            raise ValueError("n_bins must be positive.")
        if range is None:
            half = 0.5 * self._dimensions[self._axis]
            range = (-half, half)
        self._range = (float(range[0]), float(range[1]))
        if not self._range[0] < self._range[1]:
            raise ValueError("range must be increasing.")

        # Streaming columns: the surface first, then the profiled groups,
        # each in group order (masses and segment ids are group-ordered).
        column_groups = [surface] + self._groups
        self._atom_indices = np.concatenate([g.ix for g in column_groups])
        self._sels = []
        offset = 0
        for g in column_groups:
            self._sels.append(offset + np.arange(g.n_atoms))
            offset += g.n_atoms
        self._surf_seg = _group_segment_ids(surface, surface_grouping)
        self._segs = [
            _group_segment_ids(g, grouping)
            for g, grouping in zip(self._groups, self._groupings)
        ]

    def _prepare(self) -> None:
        self.results.edges = np.linspace(*self._range, self._n_bins + 1)
        self.results.bins = (
            self.results.edges[:-1] + self.results.edges[1:]
        ) / 2
        self.results.units = {}
        if not self._reduced:
            self.results.units = {
                "results.bins": ureg.angstrom,
                "results.edges": ureg.angstrom,
                "results.number_densities": ureg.angstrom**-3,
            }
            if self._charges is not None:
                self.results.units["results.charge_densities"] = (
                    ureg.elementary_charge / ureg.angstrom**3
                )
        device = self._device
        self._carry = {
            "counts": torch.zeros((self._n_groups, 2, self._n_bins),
                                  dtype=torch.int64, device=device),
            "area": torch.zeros((), dtype=torch.float64, device=device),
            "n": torch.zeros((), dtype=torch.float64, device=device),
        }
        self._make_update()

    def _make_update(self) -> None:
        device = self._device
        n_cells = self._n_cells
        axis = self._axis
        t1, t2 = self._trans_axes
        xi = self._xi
        order = self._order
        fixed_level = self._level
        n_bins = self._n_bins
        # float64 linspace edges, rounded to the float32 distances
        edges = torch.as_tensor(self.results.edges.astype(np.float32),
                                device=device)
        n_cols = len(self._atom_indices)
        takes = [_column_selector(sel, n_cols, device) for sel in self._sels]
        surf_seg, surf_n = self._surf_seg
        surf_reduce = (None if surf_seg is None else _segment_com_reducer(
            surf_seg, surf_n, self._surface.masses, device))
        reducers = [
            None if seg is None
            else _segment_com_reducer(seg, n, g.masses, device)
            for (seg, n), g in zip(self._segs, self._groups)
        ]
        per_pass = _grid_pass_frames(
            self._grid_bytes, n_cells,
            self._surface.n_atoms if surf_seg is None else surf_n, order)

        def update(carry, positions, dimensions, mask):
            boxes = _frame_boxes(dimensions, False)[0]
            spts = takes[0](positions)
            if surf_reduce is not None:
                spts = surf_reduce(spts)
            spts = wrap_positions(spts, boxes[:, None, :])
            heights = torch.cat([
                coarse_grained_heights(
                    spts[lo:lo + per_pass], boxes[lo:lo + per_pass],
                    n_cells, xi, order, axis, fixed_level)[2]
                for lo in range(0, spts.shape[0], per_pass)
            ], dim=1)
            length = boxes[:, axis, None]
            group_counts = []
            for take, reduce in zip(takes[1:], reducers):
                pos = take(positions)
                if reduce is not None:
                    pos = reduce(pos)
                pos = wrap_positions(pos, boxes[:, None, :])
                frac = torch.stack(
                    (pos[..., t1] / boxes[:, None, t1],
                     pos[..., t2] / boxes[:, None, t2]),
                    dim=-1,
                )
                z = pos[..., axis]
                side_counts = []
                for s, sign in ((0, 1.0), (1, -1.0)):
                    d = sign * (z - interpolate_height_maps(heights[s],
                                                            frac))
                    d = fma32(-length, torch.round(d / length), d)
                    idx, ok = _bin_indices(d, edges)
                    side_counts.append(
                        bin_counts(idx, _frame_valid(ok, mask), n_bins))
                group_counts.append(torch.stack(side_counts))
            mask = mask.to(device=boxes.device, dtype=torch.float64)
            area = (boxes[:, t1] * boxes[:, t2]).to(torch.float64)
            return {
                "counts": carry["counts"] + torch.stack(group_counts),
                "area": carry["area"] + (area * mask).sum(),
                "n": carry["n"] + mask.sum(),
            }

        self._update = update

    def _conclude(self) -> None:
        counts = self._carry["counts"].cpu().numpy().astype(np.float64)
        area = float(self._carry["area"])
        dd = float(self.results.edges[1] - self.results.edges[0])
        self.results.counts = counts
        norm = max(area * dd, np.finfo(np.float64).tiny)
        if self._side == "both":
            dens = counts.sum(axis=1) / (2.0 * norm)
        else:
            dens = counts[:, 0 if self._side == "lower" else 1] / norm
        self.results.number_densities = dens
        if self._charges is not None:
            self.results.charge_densities = np.einsum(
                "g,gb->b", self._charges, dens
            )
        else:
            self.results.charge_densities = None

    def calculate_pmf(
        self,
        temperature: Union[float, "Q_"],
        *,
        reference_densities=None,
    ) -> None:
        r"""Intrinsic potential of mean force
        :math:`w_g(d) = -k_\mathrm{B}T\ln(\rho_g(d)/
        \rho_{\mathrm{ref},g})` (the
        :class:`~mdhelper_tpu_torch.analysis.profile.RadialDensityProfile`
        ``calculate_pmf`` convention).

        ``reference_densities``: per-group ``(G,)`` references
        (:math:`\mathrm{\AA}^{-3}`); default: each group's mean
        density over the top (largest-:math:`d`) quarter of bins —
        assumes the range ends in the bulk liquid; pass explicit
        references otherwise.  Results: ``results.pmf``
        ``(G, n_bins)`` in kJ/mol (:math:`k_\mathrm{B}T` when
        reduced); zero-density bins map to ``inf``.
        """

        kbt = _pmf_kbt(temperature, self._reduced)
        if not self._reduced:
            self.results.units["results.pmf"] = ureg.kilojoule / ureg.mole
        dens = np.asarray(self.results.number_densities, dtype=np.float64)
        if reference_densities is None:
            ref = dens[:, -max(1, self._n_bins // 4):].mean(
                axis=-1, keepdims=True
            )
            if (ref <= 0).any():
                # e.g. a purely surface-adsorbed species with no bulk
                # presence: its PMF zero is undefined without an
                # explicit reference.
                warnings.warn(
                    "Group(s) "
                    f"{np.flatnonzero(ref.ravel() <= 0).tolist()} "
                    "have zero density over the default reference "
                    "window (the top quarter of the distance range); "
                    "their PMF is NaN — pass reference_densities."
                )
        else:
            ref = np.asarray(
                reference_densities, dtype=np.float64
            ).reshape(self._n_groups, 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.results.pmf = np.where(
                ref > 0, -kbt * np.log(dens / ref), np.nan
            )
