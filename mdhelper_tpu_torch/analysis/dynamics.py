r"""
Velocity dynamics
=================

Velocity autocorrelation and the vibrational density of states, the
charge-current autocorrelation, zone survival, and the self-overlap
function with its four-point susceptibility, ported from
:mod:`mdhelper_tpu.analysis.dynamics`.

The velocity analyses stream the ``"velocities"`` payload
(:attr:`~mdhelper_tpu_torch.analysis.base.SerialAnalysisBase._payload`):
a chunk's columns are velocities (Angstrom/ps), read without decoding
positions.  Their per-chunk work stays on the analysis's device: the
velocity autocorrelation keeps the ``(n_frames, N, 3)`` float64
velocities there, and the current autocorrelation the ``(n_frames, 3)``
float64 currents; both correlate at conclusion with the
Wiener-Khinchin engine in float64 on that device.

.. math::

   C_{vv}(t) = \frac{1}{N}\sum_i \langle \mathbf{v}_i(t_0) \cdot
   \mathbf{v}_i(t_0 + t) \rangle_{t_0},
   \qquad
   D(\nu) = 2 \Delta t \sum_i m_i \int C_{vv,i}(t)
   \cos(2\pi\nu t)\,dt .

The current :math:`\sum_i q_i \mathbf{v}_i` is summed in float64 (the
JAX package sums it in float32, where the cancellation of the two
charges' terms leaves its rounding a large share of the current).
"""

import warnings
from numbers import Real

import numpy as np
import torch

from .. import ureg
from ..algorithm.unit import strip_unit
from ..ops.histogram import _min_image_vectors, _norm2, _root, _row_blocks
from .base import DynamicAnalysisBase, existence_lifetimes
from .structure import _frame_boxes

__all__ = [
    "ElectricCurrentAutocorrelation",
    "OverlapFunction",
    "SurvivalProbability",
    "VelocityAutocorrelation",
]


def _block_split(n_frames: int, n_blocks: int) -> int:
    """Frames a statistical block (warning when frames are left over;
    raising below two)."""

    per_block = n_frames // n_blocks
    if per_block < 2:
        raise ValueError("Too few frames per block for a correlation.")
    extra = n_frames - n_blocks * per_block
    if extra:
        warnings.warn(
            f"The trajectory is not divisible into {n_blocks:,} "
            f"blocks, so the last {extra:,} frame(s) will be "
            "discarded."
        )
    return per_block


def _require_velocities(trajectory, what: str) -> None:
    if not getattr(trajectory, "has_velocities", False):
        raise ValueError(
            f"The trajectory stores no velocities; {what} needs a "
            "velocity-carrying format (in-memory arrays with "
            "velocities=, TRR)."
        )


class VelocityAutocorrelation(DynamicAnalysisBase):
    r"""Velocity autocorrelation function and vibrational density of
    states.

    Parameters
    ----------
    group : `AtomGroup`
        Atoms whose velocities are analyzed; the trajectory must
        store velocities (in-memory arrays or TRR).
    n_blocks : `int`, keyword-only, default 1
        Statistical blocks: the time axis splits into `n_blocks`
        segments whose ACFs are averaged (shorter FFTs, error bars).
    vdos : `bool`, keyword-only, default True
        Also compute the mass-weighted vibrational density of states
        (cosine transform of the per-atom ACFs).
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    parallel : `bool`, keyword-only, default False
        Shard the frames over the ranks: each rank stores the velocities
        of its own frames, and the stores are gathered in frame order
        before the correlation.
    device : `torch.device` or `str`, keyword-only, optional
        Where the velocities are kept and correlated (default: the first
        CUDA device); ``"cpu"`` for the CPU.

    Results
    -------
    ``results.times``
        Lag times (ps), length ``n_frames // n_blocks``.
    ``results.vacf``
        Raw entity-averaged ACF, (Angstrom/ps)^2.
    ``results.acf``
        ``vacf`` normalized to 1 at :math:`t = 0`.
    ``results.frequencies``, ``results.vdos``
        (with ``vdos=True``) frequency grid (1/ps = THz) and the
        mass-weighted density of states (amu Angstrom^2/ps).
    """

    _payload = "velocities"

    _checkpointable_stores = True
    _rank_sharded = True

    def _checkpoint_attrs(self) -> tuple:
        return ("_store",)

    def __init__(
        self,
        group,
        *,
        n_blocks: int = 1,
        vdos: bool = True,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ) -> None:
        self.group = group
        self.universe = group.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device, **kwargs)
        _require_velocities(self._trajectory, "VelocityAutocorrelation")
        if n_blocks < 1:
            raise ValueError("'n_blocks' must be positive.")
        self._n_blocks = int(n_blocks)
        self._vdos = bool(vdos)
        self._reduced = reduced
        self._atom_indices = group.ix

    def _prepare(self) -> None:
        self._store = torch.empty((self.n_frames, self.group.n_atoms, 3),
                                  dtype=torch.float64, device=self._device)
        self._store_offset = 0
        self._carry = torch.zeros((), device=self._device)

        def update(carry, positions, dimensions, mask):
            # `positions` is the velocity payload; a rank's padded tail
            # (mask 0) is not stored.
            del dimensions, mask
            lo, n = self._store_offset, self._n_real
            self._store[lo:lo + n] = positions[:n]
            self._store_offset += n
            return carry

        self._update = update

    def _per_atom_acf(self, per_block: int):
        """``(per_block, N)`` float64 per-atom ACFs averaged over the
        blocks, correlated in blocks of atoms whose transforms fit
        ``_chunk_bytes``."""

        from ..algorithm.correlation import correlation_fft

        n_blocks = self._n_blocks
        v = self._store[:n_blocks * per_block].reshape(
            n_blocks, per_block, -1, 3)
        n_atoms = v.shape[2]
        # complex128 spectra of a zero-padded (2 per_block) transform
        atoms = max(1, self._chunk_bytes // (n_blocks * 2 * per_block * 3
                                             * 16))
        return torch.cat([
            correlation_fft(v[:, :, lo:lo + atoms], axis=1,
                            vector=True).mean(dim=0)
            for lo in range(0, n_atoms, atoms)
        ], dim=1)

    def _conclude(self) -> None:
        per_block = _block_split(self.n_frames, self._n_blocks)
        per_atom = self._per_atom_acf(per_block)
        self.results.vacf = per_atom.mean(dim=1).cpu().numpy()
        self.results.acf = self.results.vacf / self.results.vacf[0]
        dt = self._uniform_lag_dt("VelocityAutocorrelation")
        self.results.times = np.arange(per_block) * dt
        if not self._reduced:
            self.results.units = {
                "results.times": ureg.picosecond,
                "results.vacf": (ureg.angstrom / ureg.picosecond) ** 2,
            }
        if not self._vdos:
            return
        masses = torch.as_tensor(np.asarray(self.group.masses,
                                            dtype=np.float64),
                                 device=self._device)
        weighted = (per_atom @ masses).cpu().numpy()  # (t,)
        # cosine transform: D(nu) = 2 dt [C(0)/2 + sum C(t) cos(...)]
        half = weighted.copy()
        half[0] *= 0.5
        self.results.vdos = 2.0 * dt * np.fft.rfft(half).real
        self.results.frequencies = np.fft.rfftfreq(per_block, dt)
        if not self._reduced:
            self.results.units["results.frequencies"] = 1 / ureg.picosecond
            self.results.units["results.vdos"] = (
                ureg.unified_atomic_mass_unit * ureg.angstrom**2
                / ureg.picosecond
            )


class ElectricCurrentAutocorrelation(DynamicAnalysisBase):
    r"""Charge-current autocorrelation and the Green-Kubo ionic
    conductivity (the time-domain complement of the Einstein route of
    :meth:`~mdhelper_tpu_torch.analysis.transport.Onsager.calculate_conductivity`):

    .. math::

       \mathbf{J}(t) = \sum_i q_i\,\mathbf{v}_i(t), \qquad
       \sigma = \frac{1}{3 V k_\mathrm{B}T} \int_0^\infty \langle
       \mathbf{J}(0)\cdot\mathbf{J}(t)\rangle\,dt .

    The per-frame reduction is one :math:`O(N)` charge-weighted float64
    sum into an ``(n_frames, 3)`` store on the analysis's device; all lags
    evaluate at conclusion through
    :func:`~mdhelper_tpu_torch.analysis.thermodynamics.calculate_ionic_conductivity`
    on that device.

    Parameters
    ----------
    group : `AtomGroup`
        Charged atoms; the trajectory must store velocities
        (in-memory arrays with ``velocities=``, TRR).
    temperature : `float` or `pint.Quantity`
        System temperature (K), or the LJ energy scale
        :math:`k_\mathrm{B}T` when ``reduced=True``.
    charges : array-like, keyword-only, optional
        Per-atom charges (e); defaults to the topology's.
    n_blocks : `int`, keyword-only, default 1
        Statistical blocks (block-averaged ACF).
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    parallel : `bool`, keyword-only, default False
        Shard the frames over the ranks: each rank stores the currents
        of its own frames, and the stores are gathered in frame order
        before the correlation.
    device : `torch.device` or `str`, keyword-only, optional
        Where the currents are summed and correlated (default: the first
        CUDA device); ``"cpu"`` for the CPU.

    Results
    -------
    ``results.times``
        Lag times (ps), length ``n_frames // n_blocks``.
    ``results.current``
        Charge-current series :math:`\mathbf{J}(t)`, shape
        ``(n_frames, 3)`` (e Angstrom/ps).
    ``results.acf``
        Component-averaged current ACF ((e Angstrom/ps)^2).
    ``results.running_conductivity``, ``results.conductivity``
        Cumulative Green-Kubo integral and its full-window value
        (S/m).
    """

    _payload = "velocities"

    _checkpointable_stores = True
    _rank_sharded = True

    def _checkpoint_attrs(self) -> tuple:
        return ("_current",)

    def __init__(
        self,
        group,
        temperature,
        *,
        charges=None,
        n_blocks: int = 1,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ) -> None:
        self.group = group
        self.universe = group.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device, **kwargs)
        _require_velocities(self._trajectory,
                            "ElectricCurrentAutocorrelation")
        if n_blocks < 1:
            raise ValueError("'n_blocks' must be positive.")
        self._require_box("ElectricCurrentAutocorrelation")
        self._n_blocks = int(n_blocks)
        self._temperature, _ = strip_unit(
            temperature, None if reduced else "kelvin"
        )
        if charges is None:
            charges = group.charges
        else:
            charges, _ = strip_unit(
                charges, None if reduced else "elementary_charge"
            )
        charges = np.asarray(charges, dtype=np.float64)
        if charges.shape != (group.n_atoms,):
            raise ValueError(
                "'charges' must have one value per atom in 'group'."
            )
        if not charges.any():
            warnings.warn(
                "All charges are zero; the current (and "
                "conductivity) will vanish."
            )
        self._charges = charges
        self._reduced = reduced
        self._atom_indices = group.ix

    def _prepare(self) -> None:
        device = self._device
        self._current = torch.empty((self.n_frames, 3), dtype=torch.float64,
                                    device=device)
        self._store_offset = 0
        self._carry = torch.zeros((), device=device)
        charges = torch.as_tensor(self._charges, device=device)

        def update(carry, positions, dimensions, mask):
            # `positions` is the velocity payload; the float64 sum keeps
            # the cancelling +-q v terms exact to the float32 inputs.
            # A rank's padded tail (mask 0) is not stored.
            del dimensions, mask
            lo, n = self._store_offset, self._n_real
            self._current[lo:lo + n] = torch.einsum(
                "n,bnd->bd", charges, positions[:n].to(torch.float64))
            self._store_offset += n
            return carry

        self._update = update

    def _conclude(self) -> None:
        from ..algorithm.topology import box_volume
        from .thermodynamics import calculate_ionic_conductivity

        n_blocks = self._n_blocks
        per_block = _block_split(self.n_frames, n_blocks)
        volume = box_volume(self.universe.dimensions)
        dt = self._uniform_lag_dt("ElectricCurrentAutocorrelation")
        current = self._current.cpu().numpy()
        self.results.current = current
        blocks = [
            calculate_ionic_conductivity(
                current[b * per_block:(b + 1) * per_block],
                volume,
                self._temperature,
                dt,
                reduced=self._reduced,
                device=self._device,
            )
            for b in range(n_blocks)
        ]
        self.results.times = blocks[0].times
        self.results.acf = np.mean([b.acf for b in blocks], axis=0)
        self.results.running_conductivity = np.mean(
            [b.running_conductivity for b in blocks], axis=0
        )
        self.results.conductivity = float(
            np.mean([b.conductivity for b in blocks])
        )
        if not self._reduced:
            units = blocks[0].units
            self.results.units = {
                "results.times": units.times,
                "results.current": (
                    ureg.elementary_charge * ureg.angstrom / ureg.picosecond
                ),
                "results.acf": units.acf,
                "results.running_conductivity": units.running_conductivity,
                "results.conductivity": units.conductivity,
            }


class SurvivalProbability(DynamicAnalysisBase):
    r"""Residence dynamics of a group in a spatial zone: the
    intermittent correlation :math:`c(t) = \langle h(0)h(t) \rangle /
    \langle h \rangle` and the continuous survival :math:`S(t)`
    (atoms counted only while *continuously* inside).

    Per frame the zone membership of each atom is an elementwise test on
    the analysis's device (the shell zone's any-contact test in row
    blocks of the group, :func:`~mdhelper_tpu_torch.ops.histogram.
    _row_blocks`); the boolean series streams to the host and both
    lifetime functions evaluate at conclusion
    (:func:`~mdhelper_tpu_torch.analysis.base.existence_lifetimes`, on
    the analysis's device).

    Parameters
    ----------
    group : `AtomGroup`
        Atoms whose residence is tracked.
    zone : `tuple`
        Zone specification:

        * ``("slab", axis, lo, hi)`` — wrapped coordinate along
          ``axis`` (``"x"/"y"/"z"``) in ``[lo, hi)`` (orthorhombic
          cells only; only that column is streamed);
        * ``("sphere", center, radius)`` — minimum-image distance to
          a fixed point;
        * ``("shell", other_group, radius)`` — minimum-image distance
          to ANY atom of ``other_group`` (solvation-shell residence).
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    parallel : `bool`, keyword-only, default False
        Shard the frames over the ranks: each rank stores the
        memberships of its own frames, and they are gathered in frame
        order before the lifetimes.
    device : `torch.device` or `str`, keyword-only, optional
        Where the chunks are tested (default: the first CUDA device);
        ``"cpu"`` for the CPU.

    Results
    -------
    ``results.times``
        Lag times (ps).
    ``results.intermittent``
        :math:`c(t)`, normalized to 1.
    ``results.survival``
        Continuous :math:`S(t)`, normalized to 1.
    ``results.n_in_zone``
        Per-frame member count, shape ``(n_frames,)``.
    """

    _checkpointable_stores = True
    _rank_sharded = True

    def _checkpoint_attrs(self) -> tuple:
        return ("_membership",)

    def _result_stores(self) -> dict:
        return {"n_in_zone": 0}

    def __init__(
        self,
        group,
        zone,
        *,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ) -> None:
        self.group = group
        self.universe = group.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device, **kwargs)
        self._reduced = reduced
        self._setup_periodic_box()

        if not isinstance(zone, (tuple, list)) or not zone:
            raise ValueError(
                "zone must be ('slab', axis, lo, hi), "
                "('sphere', center, radius) or "
                "('shell', group, radius)."
            )
        kind = zone[0]
        self._shell_group = None

        def _length(value, what):
            value = strip_unit(value, "angstrom")[0]
            if not isinstance(value, Real):
                raise ValueError(f"{what} must be a scalar length.")
            return float(value)

        if kind == "slab":
            if self._triclinic:
                raise ValueError("Slab zones need an orthorhombic cell.")
            _, axis, lo, hi = zone
            if axis not in ("x", "y", "z"):
                raise ValueError("Slab axis must be 'x', 'y' or 'z'.")
            lo = _length(lo, "Slab lower bound")
            hi = _length(hi, "Slab upper bound")
            if not lo < hi:
                raise ValueError("Slab bounds must satisfy lo < hi.")
            self._zone = ("slab", "xyz".index(axis), lo, hi)
        elif kind == "sphere":
            _, center, radius = zone
            center = np.asarray(
                strip_unit(center, "angstrom")[0], dtype=np.float64
            )
            if center.shape != (3,):
                raise ValueError("Sphere center must have shape (3,).")
            radius = _length(radius, "Sphere radius")
            if radius <= 0:
                raise ValueError("Sphere radius must be positive.")
            self._zone = ("sphere", center, radius)
        elif kind == "shell":
            _, other, radius = zone
            if not hasattr(other, "universe"):
                raise ValueError("'shell' zones take an AtomGroup.")
            radius = _length(radius, "Shell radius")
            if radius <= 0:
                raise ValueError("Shell radius must be positive.")
            self._shell_group = other
            self._zone = ("shell", None, radius)
        else:
            raise ValueError(f"Unknown zone kind: {kind!r}.")

        cols = [group.ix]
        if self._shell_group is not None:
            cols.append(self._shell_group.ix)
        involved = np.unique(np.concatenate(cols))
        self._atom_indices = involved
        self._g_col = np.searchsorted(involved, group.ix)
        if self._shell_group is not None:
            self._s_col = np.searchsorted(involved, self._shell_group.ix)

    # A slab zone reads one coordinate: only that column is streamed.
    @property
    def _coord_axes(self):
        if self._zone[0] == "slab":
            return [self._zone[1]]
        return None

    def _prepare(self) -> None:
        n = self.group.n_atoms
        self._membership = np.empty((self.n_frames, n), dtype=bool)
        self.results.n_in_zone = np.empty(self.n_frames, dtype=int)
        self._store_offset = 0
        self._carry = torch.zeros((), device=self._device)
        self._make_update()

    def _make_update(self) -> None:
        device = self._device
        g_col = torch.as_tensor(self._g_col, device=device)
        kind = self._zone[0]
        triclinic = self._triclinic
        if kind == "slab":
            _, axis, lo, hi = self._zone
            lo = torch.tensor(lo, dtype=torch.float32, device=device)
            hi = torch.tensor(hi, dtype=torch.float32, device=device)
        else:
            radius = self._zone[2]
            # The JAX package compares against float32(r * r).
            r2 = torch.tensor(radius * radius, dtype=torch.float32,
                              device=device)
        if kind == "sphere":
            center = torch.as_tensor(self._zone[1].astype(np.float32),
                                     device=device)
        if kind == "shell":
            s_col = torch.as_tensor(self._s_col, device=device)
            blocks = _row_blocks(len(self._g_col), len(self._s_col), device)

        def shell_frame(pos, box):
            pts, shell = pos[g_col], pos[s_col]
            return torch.cat([
                (_norm2(_min_image_vectors(
                    pts[a:b, None, :] - shell[None, :, :], box)) <= r2
                 ).any(dim=1)
                for a, b in blocks
            ])

        def update(carry, positions, dimensions, mask):
            del mask
            boxes = _frame_boxes(dimensions, triclinic)[0]
            pts = positions[:, g_col]
            if kind == "slab":
                # the stream carries only the slab's column
                coord = torch.remainder(pts[..., 0], boxes[:, axis, None])
                member = (coord >= lo) & (coord < hi)
            elif kind == "sphere":
                d = _min_image_vectors(pts - center, boxes[:, None])
                member = _norm2(d) <= r2
            else:
                member = torch.stack([shell_frame(pos, box) for pos, box
                                      in zip(positions, boxes)])
            return carry, (member, member.sum(dim=1, dtype=torch.int32))

        self._update = update

    def _store_chunk(self, extras, batch) -> None:
        member, counts = extras
        n_real = batch.n_real
        lo = self._store_offset
        self._membership[lo:lo + n_real] = member[:n_real]
        self.results.n_in_zone[lo:lo + n_real] = counts[:n_real]
        self._store_offset += n_real

    def _conclude(self) -> None:
        T = self.n_frames
        lag_dt = self._uniform_lag_dt("SurvivalProbability")
        self.results.times = np.arange(T) * lag_dt
        self.results.intermittent, self.results.survival = (
            existence_lifetimes(self._membership, device=self._device)
        )
        if not self._reduced:
            self.results.units = {"results.times": ureg.picosecond}


class OverlapFunction(DynamicAnalysisBase):
    r"""Self-overlap function :math:`Q(t)` and the four-point dynamic
    susceptibility :math:`\chi_4(t)`.

    .. math::

       Q(t) = \frac{1}{N} \sum_i w\bigl(|\mathbf{r}_i(t_0 + t) -
       \mathbf{r}_i(t_0)|\bigr), \qquad
       \chi_4(t) = N \bigl[ \langle Q(t)^2 \rangle_{t_0} -
       \langle Q(t) \rangle_{t_0}^2 \bigr],

    with :math:`w(d) = \Theta(a - d)` the overlap window of width
    `a` (commonly :math:`0.3\sigma`).

    A ring of the last ``n_lags`` frames' positions stays on the
    analysis's device, as in the
    :class:`~mdhelper_tpu_torch.analysis.structure.
    IntermediateScatteringFunction`; each frame takes one minimum-image
    pass against every resident lag at once.  Each frame's :math:`Q` is
    the float32 count of overlapping entities times the float32
    :math:`1/N` (the JAX package's ``mean``, bit for bit), accumulated in
    float64.

    Parameters
    ----------
    group : `AtomGroup`
        Atoms (or grouping entities) to analyze.
    a : `float`, default 1.0
        Overlap window (Å): displacements below `a` count as
        overlapping.
    grouping : `str`, keyword-only, default ``"atoms"``
        ``"atoms"``, ``"residues"`` or ``"segments"`` (COM
        positions).
    dt : `float` or `pint.Quantity`, keyword-only, optional
        Time between frames (defaults to the trajectory's ``dt``).
    n_lags : `int`, keyword-only, optional
        Ring length in frames (defaults to the analyzed frame
        count).
    lags : `str` or array-like, keyword-only, optional
        Lag subset — ``"log"`` or explicit frame offsets (see
        :class:`~mdhelper_tpu_torch.analysis.structure.
        IntermediateScatteringFunction`).
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    device : `torch.device` or `str`, keyword-only, optional
        Where the ring lives (default: the first CUDA device); ``"cpu"``
        for the CPU.

    Results
    -------
    ``results.times``
        Lag times (ps).
    ``results.Q``
        Mean overlap :math:`\langle Q(t) \rangle`, shape
        ``(n_sel,)``.
    ``results.chi4``
        Four-point susceptibility, shape ``(n_sel,)``.
    ``results.origins``
        Time origins entering each lag's averages.

    Minimum-image caveat: like every wrapped-trajectory displacement
    estimator, lags must be short enough that particles do not
    diffuse half a box (see
    :class:`~mdhelper_tpu_torch.analysis.structure.VanHoveFunction`).
    """

    _sequential = True

    def __init__(
        self,
        group,
        a: float = 1.0,
        *,
        grouping: str = "atoms",
        dt=None,
        n_lags: int = None,
        lags=None,
        reduced: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ) -> None:
        from .structure import (
            _frame_time_step,
            _group_segment_ids,
            _validate_groupings,
        )

        self.group = group
        self.universe = group.universe
        super().__init__(self.universe.trajectory, False, verbose,
                         device=device, **kwargs)
        if not isinstance(a, Real):
            a = strip_unit(a, "angstrom")[0]
        if a <= 0:
            raise ValueError("'a' must be positive.")
        self._a = float(a)
        self._grouping = _validate_groupings(grouping)[0]
        self._reduced = reduced
        self._n_lags = n_lags
        self._lag_spec = lags
        # A scalar Quantity is taken (the JAX class raises there).
        self._dt = strip_unit(_frame_time_step(dt, self._trajectory),
                              "picosecond")[0]
        self._require_box(type(self).__name__)
        self._setup_periodic_box()
        self._atom_indices = np.asarray(group.ix)
        self._seg, self._n = _group_segment_ids(group, self._grouping)

    def _prepare(self) -> None:
        from .base import _check_even_frame_spacing
        from .structure import _resolve_lag_values, _segment_com_reducer

        lag_values, n_lags = _resolve_lag_values(
            self._lag_spec, self._n_lags, self.n_frames
        )
        self._lag_values = lag_values
        step = _check_even_frame_spacing(self.frames)
        self.results.times = step * self._dt * lag_values
        self.results.units = {}
        if not self._reduced:
            self.results.units = {"results.times": ureg.picosecond}

        device = self._device
        n_sel = len(lag_values)
        n = self._n
        self._carry = {
            "ring": torch.zeros((n_lags, n, 3), dtype=torch.float32,
                                device=device),
            "q1": torch.zeros(n_sel, dtype=torch.float64, device=device),
            "q2": torch.zeros(n_sel, dtype=torch.float64, device=device),
            "origins": torch.zeros(n_sel, dtype=torch.float64,
                                   device=device),
            "frame": 0,
        }
        reduce = (None if self._seg is None else _segment_com_reducer(
            self._seg, n, self.group.masses, device))
        triclinic = self._triclinic
        lag_range = torch.as_tensor(lag_values, device=device)
        a = torch.tensor(self._a, dtype=torch.float32, device=device)
        # jnp.mean of a float32 count multiplies by the float32 1/N.
        inv_n = torch.tensor(np.float32(1.0) / np.float32(n),
                             dtype=torch.float32, device=device)

        def update(carry, positions, dimensions, mask):
            # Frames arrive in order, one at a time through the ring.
            del mask
            pos = positions if reduce is None else reduce(positions)
            boxes = _frame_boxes(dimensions, triclinic)[0]
            ring, q1, q2 = carry["ring"], carry["q1"], carry["q2"]
            origins, fi = carry["origins"], carry["frame"]
            for f in range(len(pos)):
                ring[fi % n_lags] = pos[f]
                ok = lag_range <= fi
                past = ring[torch.remainder(fi - lag_range, n_lags)]
                d = _root(_norm2(_min_image_vectors(pos[f] - past,
                                                    boxes[f])))
                count = (d < a).sum(dim=1).to(torch.float32)
                q = torch.where(ok, (count * inv_n).to(torch.float64), 0.0)
                q1 = q1 + q
                q2 = q2 + q * q
                origins = origins + ok
                fi += 1
            return {"ring": ring, "q1": q1, "q2": q2, "origins": origins,
                    "frame": fi}

        self._update = update

    def _conclude(self) -> None:
        q1 = self._carry["q1"].cpu().numpy()
        q2 = self._carry["q2"].cpu().numpy()
        origins = self._carry["origins"].cpu().numpy()
        self.results.origins = origins.astype(np.int64)
        with np.errstate(divide="ignore", invalid="ignore"):
            q_mean = q1 / origins
            q2_mean = q2 / origins
        self.results.Q = q_mean
        self.results.chi4 = self._n * (q2_mean - q_mean**2)
