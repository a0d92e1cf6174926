r"""
Transport properties
====================

Ported from :mod:`mdhelper_tpu.analysis.transport`: :class:`Onsager`
(per-frame unwrap with image flags carried across streamed chunks,
:func:`mdhelper_tpu_torch.ops.pbc.unwrap_scan`, optional removal of the
system's center-of-mass motion, a host store of the per-frame entity
positions, and the float64 mean-squared and cross displacements at the
conclusion, by FFT on the device or by the direct sliding windows on the
host), of atoms or of the centers of mass of residues or segments; and
the host fits that turn those displacements into self-diffusion and
Onsager coefficients, conductivities, electrophoretic mobilities and
transference numbers (numpy and scipy, as in the JAX package).
"""

import itertools
import warnings
from typing import Union

import numpy as np
import torch
from scipy import optimize

from .. import Q_, ureg
from ..algorithm import correlation
from ..algorithm.topology import unwrap_edge
from ..algorithm.unit import strip_unit
from ..ops.pbc import unwrap_scan, wrap_positions
from .base import SerialAnalysisBase, _check_even_frame_spacing
from .structure import (
    _entity_positions_fn,
    _entity_values,
    _frame_time_step,
    _group_segment_ids,
    _groupings_per_group,
)

__all__ = [
    "msd_fft",
    "msd_shift",
    "calculate_transport_coefficients",
    "calculate_conductivity",
    "calculate_nernst_einstein_conductivity",
    "calculate_electrophoretic_mobility",
    "calculate_transference_number",
    "Onsager",
]


def msd_fft(*args, **kwargs):
    """Alias of :func:`mdhelper_tpu_torch.algorithm.correlation.msd_fft`."""

    return correlation.msd_fft(*args, **kwargs)


def msd_shift(*args, **kwargs):
    """Alias of :func:`mdhelper_tpu_torch.algorithm.correlation.msd_shift`."""

    return correlation.msd_shift(*args, **kwargs)


def _poly1(x, p1, p2):
    """The straight line :math:`y = p_1 x + p_2` (the ``poly1`` model of
    the JAX package's ``fit.polynomial``, kept here until that host-only
    package is ported)."""

    return np.polynomial.polynomial.polyval(np.asarray(x), (p2, p1))


def _fit_slope_or_intercept(x, y, scale, enforce_linear, label):
    """One MSD-vs-time fit: linear slope, or exp(intercept) of the
    log-log fit (optionally with the slope pinned to 1)."""

    if scale == "linear":
        return np.polyfit(x, y, 1)[0]
    if scale == "log":
        if enforce_linear:
            return float(
                np.exp(
                    optimize.curve_fit(
                        lambda t, b: _poly1(t, 1, b), np.log(x), np.log(y)
                    )[0]
                )
            )
        fit = np.polyfit(np.log(x), np.log(y), 1)
        if abs(1 - fit[0]) >= 0.01:
            warnings.warn(
                f"The slope for log({label}) vs. log(t) fit is "
                f"{fit[0]:.6f}."
            )
        return np.exp(fit[1])
    raise ValueError("Invalid scale. Valid values: 'linear', 'log'.")


def calculate_transport_coefficients(
    time: np.ndarray,
    msd_cross: np.ndarray,
    msd_self: np.ndarray,
    Ns: np.ndarray,
    dimensions: np.ndarray,
    kBT: float,
    start: int = 1,
    stop: int = None,
    scale: str = "log",
    *,
    start_self: int = None,
    stop_self: int = None,
    scale_self: str = None,
    enforce_linear: bool = True,
    verbose: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    r"""Fit MSDs and cross displacements to the self-diffusion
    coefficients :math:`D_i` and the Onsager coefficients :math:`L_{ij}`
    and :math:`L_{ii}^\mathrm{self}`.

    Each fit window keeps only its positive, finite points; a series
    with fewer than two left gets `nan`.  :math:`L_{ij}` is fitted on the
    upper triangle and mirrored.

    Parameters
    ----------
    time : `numpy.ndarray`
        Lag times ``(N_t,)``.
    msd_cross : `numpy.ndarray`
        Cross displacements ``(C(N_g + 1, 2), [N_b,] N_t)``, already
        divided by :math:`2D`.
    msd_self : `numpy.ndarray`
        Particle-averaged MSDs ``(N_g, [N_b,] N_t)``, divided the same way.
    Ns : array-like
        Entities in each group.
    dimensions : array-like
        Box lengths (zero lengths are left out of the volume).
    kBT : `float`
        Thermal energy.
    start, stop : `int`
        Fit window of the cross displacements.
    scale : `str`, default ``"log"``
        ``"linear"`` (slope) or ``"log"`` (intercept of the log-log fit,
        with the slope pinned to 1 when `enforce_linear`).
    start_self, stop_self, scale_self : keyword-only, optional
        The same for the MSDs (default: those of the cross fits).
    enforce_linear : `bool`, keyword-only, default True
        Pin the log-log slope to 1.
    verbose : `bool`, keyword-only
        Unused (kept for the signature).

    Returns
    -------
    L_ij, L_ii_self, D_i : `numpy.ndarray`
        ``(N_b, N_g, N_g)``, ``(N_b, N_g)`` and ``(N_b, N_g)``.
    """

    if start_self is None:
        start_self = start
    if stop_self is None:
        stop_self = stop
    if scale_self is None:
        scale_self = scale

    msd_self = np.asarray(msd_self)
    msd_cross = np.asarray(msd_cross)
    if msd_self.ndim == 2:
        msd_self = msd_self[:, None]
        msd_cross = msd_cross[:, None]
    elif msd_self.ndim != 3:
        raise ValueError(
            "The arrays containing the cross- and self-MSDs have "
            "invalid shapes."
        )
    n_groups, n_blocks = msd_self.shape[:2]

    L_ij = np.zeros((n_blocks, n_groups, n_groups))
    D_i = np.zeros((n_blocks, n_groups))
    rows, cols = np.triu_indices(n_groups)
    denom = kBT * np.asarray(dimensions)[
        ~np.isclose(dimensions, 0)
    ].prod()

    for b in range(n_blocks):
        for i, msd in enumerate(msd_cross[:, b] / denom):
            y = msd[start:stop]
            valid = np.isfinite(y) & (y > 0)
            y = y[valid]
            x = time[start:stop][valid]
            L_ij[b, rows[i], cols[i]] = (
                _fit_slope_or_intercept(x, y, scale, enforce_linear, "MSDc")
                if len(x) > 1
                else np.nan
            )
        L_ij[b] = L_ij[b] + L_ij[b].T - np.diag(np.diag(L_ij[b]))

        for i, msd in enumerate(msd_self[:, b]):
            y = msd[start_self:stop_self]
            valid = np.isfinite(y) & (y > 0)
            y = y[valid]
            x = time[start_self:stop_self][valid]
            D_i[b, i] = (
                _fit_slope_or_intercept(x, y, scale_self, enforce_linear,
                                        "MSD")
                if len(x) > 1
                else np.nan
            )

    return L_ij, np.asarray(Ns) * D_i / denom, D_i


def calculate_conductivity(
    L_ij: np.ndarray, z: np.ndarray, *, reduced: bool = False
) -> np.ndarray:
    r"""Ionic conductivity :math:`\kappa = \sum_{ij} z_i z_j L_{ij}`, per
    block, in :math:`\mathrm{C^2/(kJ\,\AA\,ps)}` unless `reduced`."""

    z = np.asarray(z, dtype=float)
    kappas = np.einsum("bij,ij->b", L_ij, z * z[:, None])
    return _conductivity_si(kappas, reduced)


def _conductivity_si(kappas: np.ndarray, reduced: bool) -> np.ndarray:
    """The (mol e)^2-to-C^2 conversion shared by kappa and kappa_NE (one
    definition keeps their ratio, the ionicity, consistent)."""

    if not reduced:
        kappas = (
            kappas
            * ureg.avogadro_constant
            * ureg.elementary_charge**2
            * ureg.mole
            / ureg.coulomb**2
        ).to_reduced_units().magnitude
    return kappas


def calculate_nernst_einstein_conductivity(
    L_ii_self: np.ndarray, z: np.ndarray, *, reduced: bool = False
) -> np.ndarray:
    r"""Nernst-Einstein (ideal, uncorrelated) conductivity
    :math:`\kappa_\mathrm{NE} = \sum_i z_i^2 L_{ii}^\mathrm{self}` with
    :math:`L_{ii}^\mathrm{self} = N_i D_i / (V k_\mathrm{B}T)`, in the
    units of :func:`calculate_conductivity`, so that
    :math:`\kappa / \kappa_\mathrm{NE}` is the ionicity."""

    z = np.asarray(z, dtype=float)
    kappas = np.einsum("bi,i->b", np.asarray(L_ii_self), z * z)
    return _conductivity_si(kappas, reduced)


def calculate_electrophoretic_mobility(
    L_ij: np.ndarray,
    z: np.ndarray,
    rho: np.ndarray,
    *,
    reduced: bool = False,
) -> np.ndarray:
    r"""Electrophoretic mobilities
    :math:`\mu_i = \sum_j z_j L_{ij} / \rho_i`, in
    :math:`\mathrm{\AA^2\,C/(kJ\,ps)}` unless `reduced`."""

    z = np.asarray(z, dtype=float)
    rho = np.asarray(rho, dtype=float)
    mus = (L_ij * z / rho[:, None]).sum(axis=-1)
    if not reduced:
        mus = (
            mus
            * ureg.avogadro_constant
            * ureg.elementary_charge
            * ureg.mole
            / ureg.coulomb
        ).to_reduced_units().magnitude
    return mus


def calculate_transference_number(
    L_ij: np.ndarray, z: np.ndarray
) -> np.ndarray:
    r"""Transference numbers
    :math:`t_i = z_i\sum_j z_j L_{ij} / \sum_{ij} z_i z_j L_{ij}`."""

    z = np.asarray(z, dtype=float)
    s = z * (L_ij * z).sum(axis=-1)
    return s / s.sum(axis=-1, keepdims=True)


def _check_unitless(reduced, unit_, name):
    """With `reduced`, `name` must have been given without units."""

    if reduced and not isinstance(unit_, (str, type(None))):
        raise TypeError(f"'{name}' cannot have units when reduced=True.")


class Onsager(SerialAnalysisBase):
    r"""Onsager transport coefficients from mean-squared and cross
    displacements.

    .. math::

       L_{ij} = \frac{1}{6k_\mathrm{B}TV}\lim_{t\to\infty}
       \frac{d}{dt}\left\langle\sum_\alpha
       [\mathbf{r}_\alpha(t)-\mathbf{r}_\alpha(0)]\cdot\sum_\beta
       [\mathbf{r}_\beta(t)-\mathbf{r}_\beta(0)]\right\rangle

    ``results.msd_self`` holds particle-averaged MSDs and
    ``results.msd_cross`` the displacements of group sums, both divided
    by :math:`2D` (the reference convention).  The post-hoc methods fit
    them (:meth:`calculate_transport_coefficients`) and derive the
    conductivity, the Nernst-Einstein conductivity and ionicity, the
    electrophoretic mobilities and the transference numbers.

    Parameters
    ----------
    groups : `AtomGroup` or sequence of them
        Group(s) to analyze.
    groupings : `str` or sequence, default ``"atoms"``
        ``"atoms"``, ``"residues"`` or ``"segments"``, for every group or
        one for each: the displacements of the residues' or segments'
        centers of mass (entities in ascending label order), reduced from
        the unwrapped positions of the group's own atoms.
    temperature : `float` or `Quantity`, default 300
        System temperature in K (the energy scale :math:`k_\mathrm{B}T`
        itself, without units, when ``reduced=True``).
    charges : array-like, keyword-only, optional
        Charge numbers, one a group (default: each group's first
        entity's charge from the topology).
    dimensions : array-like or `Quantity`, keyword-only, optional
        Box lengths (defaults to the trajectory).
    dt : `float` or `Quantity`, keyword-only, optional
        Time between frames (ps).
    n_blocks : `int`, keyword-only, default 1
        Statistical blocks.
    center : `bool`, keyword-only, default False
        Subtract the system's center of mass from every frame: of the
        groups' entities, or of every atom of the universe with
        `center_atom`.
    center_atom : `bool`, keyword-only, default False
        Take the system's center of mass from every atom of the
        universe (streamed, like `unwrap`, in full).
    center_wrap : `bool`, keyword-only, default False
        Take the center of mass of the positions wrapped into the box.
    fft : `bool`, keyword-only, default True
        FFT evaluation of the displacements on the device, or (False)
        the direct sliding windows in float64 on the host.
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units: `temperature`, `dt` and `charges` take no
        units, and the coefficients are not converted.
    unwrap : `bool`, keyword-only, default False
        Unwrap positions by image-flag tracking (fragments made whole at
        the first frame).
    device : optional
        Device the chunks are folded on (default: the first CUDA
        device, which must exist; ``"cpu"`` for the CPU).
    """

    _checkpointable_stores = True

    def _checkpoint_attrs(self) -> tuple:
        return ("_positions",)

    #: the unwrap and the stored positions follow the frames in order.
    _sequential = True

    def __init__(self, groups, groupings: Union[str, tuple] = "atoms",
                 temperature: Union[float, Q_] = 300, *, charges=None,
                 dimensions=None, dt=None, n_blocks: int = 1,
                 center: bool = False, center_atom: bool = False,
                 center_wrap: bool = False, fft: bool = True,
                 reduced: bool = False, unwrap: bool = False,
                 verbose: bool = True, device=None, **kwargs):
        self._groups = (
            [groups] if hasattr(groups, "universe") else list(groups)
        )
        self.universe = self._groups[0].universe
        super().__init__(self.universe.trajectory, verbose, device=device,
                         **kwargs)
        self.results.units = {"_kBT": ureg.kilojoule / ureg.mole}
        self._n_groups = len(self._groups)
        self._groupings = _groupings_per_group(
            groupings, self._n_groups, {"atoms", "residues", "segments"})

        temperature, unit_ = strip_unit(temperature, "kelvin")
        if reduced:
            _check_unitless(True, unit_, "temperature")
            self._kBT = temperature
        else:
            self._kBT = (
                ureg.avogadro_constant
                * ureg.boltzmann_constant
                * temperature
                * ureg.kelvin
            ).m_as(self.results.units["_kBT"])

        if dimensions is not None:
            if len(dimensions) != 3:
                raise ValueError("'dimensions' must have length 3.")
            self._dimensions = np.asarray(
                strip_unit(dimensions, "angstrom")[0], dtype=float
            )
        elif self.universe.dimensions is not None:
            self._dimensions = np.asarray(
                self.universe.dimensions[:3], dtype=float
            ).copy()
        else:
            raise ValueError("No system dimensions found or provided.")
        self._dt, unit_ = strip_unit(
            _frame_time_step(dt, self._trajectory), "picosecond"
        )
        _check_unitless(reduced, unit_, "dt")
        self._reduced = reduced
        self._charges = None
        if charges is not None:
            self._resolve_charges(charges)
        else:
            self._charges = np.array([
                _entity_values(g, gr, g.charges)[0]
                for g, gr in zip(self._groups, self._groupings)
            ])

        self._Ns = [_group_segment_ids(g, gr)[1]
                    for g, gr in zip(self._groups, self._groupings)]
        self._N = int(sum(self._Ns))
        self._entity_slices = []
        index = 0
        for n in self._Ns:
            self._entity_slices.append(slice(index, index + n))
            index += n
        if np.all(~np.isclose(self._dimensions, 0)):
            self._rhos = (np.asarray(self._Ns, dtype=float)
                          / self._dimensions.prod())
        else:
            self._rhos = None

        self._atom_indices = np.concatenate([g.ix for g in self._groups])
        self._n_blocks = n_blocks
        self._center = center
        self._center_atom = center_atom
        self._center_wrap = center_wrap
        self._fft = fft
        self._unwrap = unwrap
        if unwrap or (center and center_atom):
            # The image flags and the system's center of mass take every
            # atom of the universe; the groups' columns are gathered
            # after them.
            self._columns = self._atom_indices
            self._atom_indices = None

    def _prepare(self) -> None:
        self._frame_step = _check_even_frame_spacing(self.frames)
        self.results.pairs = tuple(
            itertools.combinations_with_replacement(
                range(self._n_groups), 2
            )
        )
        self._n_frames_block = self.n_frames // self._n_blocks
        self._n_frames = self._n_blocks * self._n_frames_block
        extra = self.n_frames - self._n_frames
        if extra > 0:
            warnings.warn(
                f"The trajectory is not divisible into {self._n_blocks:,} "
                f"blocks, so the last {extra:,} frame(s) will be discarded."
            )
        self.results.times = (
            self._frame_step * self._dt * np.arange(self._n_frames_block)
        )
        self.results.units["results.times"] = ureg.picosecond
        self.results.units["results.msd_cross"] = ureg.angstrom**2
        self.results.units["results.msd_self"] = ureg.angstrom**2
        # Host store of per-frame entity positions, filled one chunk
        # late by _store_chunk (the copy overlaps the next chunk).
        self._positions = np.empty((self.n_frames, self._N, 3))
        self._store_offset = 0

        device = self._device
        box = torch.as_tensor(self._dimensions, dtype=torch.float32,
                              device=device)
        unwrap = self._unwrap
        columns = None
        if self._atom_indices is None:
            n = self.universe.atoms.n_atoms
            if not np.array_equal(self._columns, np.arange(n)):
                columns = torch.as_tensor(self._columns, device=device)
        if unwrap:
            # Fragments made whole at the first frame.
            self.universe.trajectory[int(self.frames[0])]
            made_whole = unwrap_edge(group=self.universe.atoms)
            self._carry = (
                torch.as_tensor(made_whole, dtype=torch.float32,
                                device=device),
                torch.zeros((self.universe.atoms.n_atoms, 3),
                            dtype=torch.int32, device=device),
            )
        else:
            self._carry = (
                torch.zeros((), device=device),
                torch.zeros((), device=device),
            )
        entities = _entity_positions_fn(self._groups, self._groupings,
                                        device)
        center = self._center_fn()

        def update(carry, positions, dimensions, mask):
            # The port streams no padding frames, so every mask entry is
            # 1 and the unwrap scan runs over the whole chunk.
            del dimensions, mask
            if unwrap:
                positions, carry = unwrap_scan(
                    positions, box, initial=carry[0], images=carry[1]
                )
            # The center of every universe atom comes from the full
            # frame, before the groups' columns are gathered.
            full = positions
            if columns is not None:
                positions = positions[:, columns]
            out = entities(positions)
            if center is not None:
                out = center(full, out)
            return carry, out

        self._update = update

    def _center_fn(self):
        """``center(full, entities) -> (B, N, 3)``: the float64 entity
        positions less the system's center of mass in each frame (of every
        universe atom, from the full streamed frame, with `center_atom`;
        else of the entities), or None without `center`.

        The center is a float64 mass-weighted mean of the float32
        positions (wrapped into the box in float32 first with
        `center_wrap`), subtracted in float64, as the reference's float64
        numpy does it: the host store holds the centered positions
        unrounded.  (The JAX package's device path sums and subtracts in
        the float32 stream, which moves a centered coordinate by up to a
        few of its float32 ulps.)"""

        if not self._center:
            return None
        device = self._device
        box = torch.as_tensor(self._dimensions, dtype=torch.float32,
                              device=device)
        if self._center_atom:
            masses = self.universe.atoms.masses
        else:
            masses = np.concatenate([
                _entity_values(g, gr, g.masses)
                for g, gr in zip(self._groups, self._groupings)
            ])
        masses = torch.as_tensor(masses, dtype=torch.float64, device=device)
        total = masses.sum()
        center_atom = self._center_atom
        center_wrap = self._center_wrap

        def center(full, entities):
            ref = full if center_atom else entities
            if center_wrap:
                ref = wrap_positions(ref, box)
            com = (masses[:, None] * ref.to(torch.float64)).sum(
                dim=-2, keepdim=True) / total
            return entities.to(torch.float64) - com

        return center

    def _store_chunk(self, entities, batch) -> None:
        n_real = batch.n_real
        self._positions[
            self._store_offset:self._store_offset + n_real
        ] = entities[:n_real]
        self._store_offset += n_real

    def _conclude(self) -> None:
        positions_all = self._positions[:self._n_frames]
        delete_dims = np.isclose(self._dimensions, 0)
        if self._fft:
            device = self._device

            def msd(*args, **kwargs):
                return correlation.msd_fft(*args, **kwargs).cpu().numpy()
        else:
            # The direct windows run in numpy on the host.
            device = torch.device("cpu")
            msd = correlation.msd_shift
        keep = torch.as_tensor(~delete_dims, device=device)

        def block_positions(i):
            pos = torch.as_tensor(
                positions_all[:, self._entity_slices[i]], device=device
            ).reshape(self._n_blocks, -1, self._Ns[i], 3)
            return pos * keep

        n_pairs = len(self.results.pairs)
        msd_cross = np.empty((n_pairs, self._n_blocks, self._n_frames_block))
        msd_self = np.empty(
            (self._n_groups, self._n_blocks, self._n_frames_block)
        )
        for i, (i1, i2) in enumerate(self.results.pairs):
            if not (self._Ns[i1] and self._Ns[i2]):
                msd_cross[i] = np.nan
                if i1 == i2:
                    msd_self[i1] = np.nan
                continue
            p1 = block_positions(i1)
            if i1 == i2:
                msd_cross[i] = msd(p1.sum(dim=2), axis=1)
                # average=True reduces the power spectrum over particles
                # before the inverse FFT: one transform instead of N.
                msd_self[i1] = msd(p1, axis=1, average=True)
            else:
                p2 = block_positions(i2)
                msd_cross[i] = msd(p1.sum(dim=2), p2.sum(dim=2), axis=1)
        D = 2 * int((~delete_dims).sum())
        self.results.msd_cross = msd_cross / D
        self.results.msd_self = msd_self / D

    # -- post-hoc coefficient methods --------------------------------------
    def calculate_transport_coefficients(
        self,
        start: int = 1,
        stop: int = None,
        scale: str = "log",
        *,
        start_self: int = None,
        stop_self: int = None,
        scale_self: str = None,
        enforce_linear: bool = True,
    ) -> None:
        """Fit the displacements (:func:`calculate_transport_coefficients`)
        to ``results.L_ij``, ``results.L_ii_self`` and ``results.D_i``."""

        if self.results.msd_cross is None:
            raise RuntimeError(
                "Call Onsager.run() before "
                "Onsager.calculate_transport_coefficients()."
            )
        (
            self.results.L_ij,
            self.results.L_ii_self,
            self.results.D_i,
        ) = calculate_transport_coefficients(
            self.results.times,
            self.results.msd_cross,
            self.results.msd_self,
            np.asarray(self._Ns),
            self._dimensions,
            self._kBT,
            start,
            stop,
            scale,
            start_self=start_self,
            stop_self=stop_self,
            scale_self=scale_self,
            enforce_linear=enforce_linear,
            verbose=self._verbose,
        )
        if not self._reduced:
            self.results.units["results.D_i"] = (
                ureg.angstrom**2 / ureg.picosecond
            )
            self.results.units["results.L_ij"] = self.results.units[
                "results.L_ii_self"
            ] = 1 / (
                ureg.kilojoule * ureg.angstrom * ureg.picosecond
                / ureg.mole
            )

    def _resolve_charges(self, charges) -> None:
        if charges is not None:
            if len(charges) != self._n_groups:
                raise ValueError(
                    "The number of group charges is not equal to the "
                    "number of groups."
                )
            charges, unit_ = strip_unit(charges, "elementary_charge")
            _check_unitless(self._reduced, unit_, "charges")
            self._charges = np.asarray(charges)
        if self._charges is None:
            raise ValueError("No charge number information available.")

    def _require_fit(self, method: str) -> None:
        if self.results.L_ij is None:
            raise RuntimeError(
                "Call Onsager.calculate_transport_coefficients() before "
                f"Onsager.{method}()."
            )

    def calculate_conductivity(self, *, charges=None) -> None:
        """Ionic conductivity from ``results.L_ij``
        (``results.conductivities``, one a block)."""

        self._require_fit("calculate_conductivity")
        self._resolve_charges(charges)
        self.results.conductivities = calculate_conductivity(
            self.results.L_ij, self._charges, reduced=self._reduced
        )
        self.results.units["results.conductivities"] = (
            ureg.coulomb**2
            / (ureg.kilojoule * ureg.angstrom * ureg.picosecond)
        )

    def calculate_nernst_einstein_conductivity(
        self, *, charges=None
    ) -> None:
        r"""Ideal (uncorrelated) Nernst-Einstein conductivity from
        ``results.L_ii_self`` (``results.ne_conductivities``), the
        denominator of the ionicity
        :math:`\alpha = \kappa / \kappa_\mathrm{NE}`."""

        self._require_fit("calculate_nernst_einstein_conductivity")
        self._resolve_charges(charges)
        self.results.ne_conductivities = (
            calculate_nernst_einstein_conductivity(
                self.results.L_ii_self,
                self._charges,
                reduced=self._reduced,
            )
        )
        self.results.units["results.ne_conductivities"] = (
            ureg.coulomb**2
            / (ureg.kilojoule * ureg.angstrom * ureg.picosecond)
        )

    def calculate_ionicity(self, *, charges=None) -> None:
        r"""Ionicity :math:`\alpha = \kappa / \kappa_\mathrm{NE}` and the
        Haven ratio :math:`1/\alpha` (``results.ionicity`` and
        ``results.haven_ratios``, one a block).  Both conductivities are
        recomputed, so they share the charges and the current fits."""

        self.calculate_conductivity(charges=charges)
        self.calculate_nernst_einstein_conductivity(charges=charges)
        self.results.ionicity = (
            self.results.conductivities / self.results.ne_conductivities
        )
        self.results.haven_ratios = 1.0 / self.results.ionicity

    def calculate_electrophoretic_mobility(
        self, *, charges=None, rhos=None
    ) -> None:
        """Electrophoretic mobilities from ``results.L_ij``
        (``results.electrophoretic_mobilities``); `rhos` are the groups'
        number densities (default: entities over the box volume)."""

        self._require_fit("calculate_electrophoretic_mobility")
        self._resolve_charges(charges)
        if rhos is not None:
            if len(rhos) != self._n_groups:
                raise ValueError(
                    "The number of group number densities is not equal "
                    "to the number of groups."
                )
            rhos, unit_ = strip_unit(rhos, "angstrom**-3")
            _check_unitless(self._reduced, unit_, "rhos")
            self._rhos = np.asarray(rhos)
        if self._rhos is None:
            raise ValueError("No number density information available.")
        self.results.electrophoretic_mobilities = (
            calculate_electrophoretic_mobility(
                self.results.L_ij,
                self._charges,
                self._rhos,
                reduced=self._reduced,
            )
        )
        self.results.units["results.electrophoretic_mobilities"] = (
            ureg.angstrom**2
            * ureg.coulomb
            / (ureg.kilojoule * ureg.picosecond)
        )

    def calculate_transference_number(self, *, charges=None) -> None:
        """Transference numbers from ``results.L_ij``
        (``results.transference_numbers``)."""

        self._require_fit("calculate_transference_number")
        self._resolve_charges(charges)
        self.results.transference_numbers = calculate_transference_number(
            self.results.L_ij, self._charges
        )
