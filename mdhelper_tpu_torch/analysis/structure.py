r"""
Structural analysis
===================

Ported from :mod:`mdhelper_tpu.analysis.structure`:

* :class:`RadialDistributionFunction` for one group against itself
  (with an optional ``(e, e)`` or asymmetric ``(e0, e1)`` tile
  exclusion) or between two groups, in an orthorhombic or
  triclinic 3-D box, or in 2-D (``drop_axis``, orthorhombic), on bins
  from 0 or from ``range[0] > 0``, through the cell-list pair histograms
  (:mod:`mdhelper_tpu_torch.ops.cuda_cell_histogram`): the hand-written
  CUDA kernels on a GPU, their plain-torch versions on the CPU.  This
  cell route is the port's only RDF route.
* :class:`StructureFactor`, total (``mode=None``), ``"pair"`` and
  ``"partial"``, over the wavevector grid (with optional spherical-surface
  points), a ``q_max`` subset of it or explicit wavevectors: the direct
  trig sums (:func:`mdhelper_tpu_torch.ops.cuda_kernels.trig_sums`, the
  hand-written CUDA kernel on a GPU, its plain-torch version on the CPU),
  the factorized lattice sums
  (:mod:`mdhelper_tpu_torch.ops.factor_scattering`), or both for a mixed
  set (``method="auto"``: the lattice part factorized, the off-grid extras
  direct).
* :class:`IntermediateScatteringFunction`, the coherent, partial and
  incoherent :math:`F(q, t)` by the time FFT or a lag ring on the sums of
  :class:`StructureFactor` (the direct ones through the same kernel, a
  chunk's frames or a frame's lags in one launch), and the dynamic
  structure factor.
* :class:`VanHoveFunction`, the self and distinct parts of
  :math:`G(r, t)` over a ring of past frames: the exact displacement
  histogram for the self part, the cross cell-list kernel for the
  distinct part, on bins from 0 or from ``range[0] > 0``.

Each class keeps the JAX package's ``results.units`` (the unit of each
result in the port's registry, :mod:`mdhelper_tpu_torch.units`) and its
post-hoc methods: the RDF's coordination numbers, potential of mean force
and S(q) from g(r), the partial S(q)'s weighted and charge recombinations
and screening length, the ISF's dynamic structure factor.  The module
functions :func:`radial_histogram` (one frame, exact, on the device),
:func:`zeroth_order_hankel_transform`, :func:`radial_fourier_transform`,
:func:`calculate_coordination_numbers` and
:func:`calculate_structure_factor` (numpy and scipy on the host) are
those of the JAX package.

The RDF and Van Hove run in any periodic 3-D box.  Boxes at least 3
cutoffs wide on every axis (perpendicular width, for a triclinic box)
take reach-1 cell grids; narrower ones take the generalized grids of
:func:`~mdhelper_tpu_torch.ops.cuda_cell_histogram.cell_plan_search`
(cells narrower than the cutoff, swept several cells out).  A triclinic
box runs the triclinic kernels: on a reach-1 grid each (cell,
neighbour) block takes one lattice translation, on a generalized grid
each pair searches its 27 nearest images (the JAX package's ``tri_pp``
mode).  The cross RDF takes overlapping groups (a shared atom lands in
bin 0, as in the JAX class).  Each analysis takes ``groupings=`` (Van
Hove: ``grouping=``): ``"residues"`` or ``"segments"`` run it on the
centers of mass of a group's residues or segments, reduced in torch in a
fixed order (:func:`_com_reducer`) from the streamed atom columns.  The
S(q) and the ISF also take the mesh route (``method="mesh"``: Kaiser-Bessel
gridding and a 3-D FFT, :mod:`mdhelper_tpu_torch.ops.mesh_scattering`).
The JAX package has no 2-D Van Hove function.
"""

import warnings
from itertools import combinations_with_replacement
from numbers import Real
from typing import Union

import numpy as np
import torch
from scipy.integrate import simpson
from scipy.signal import argrelextrema
from scipy.special import jv

from .. import Q_, ureg
from .._device import resolve_device
from ..algorithm.topology import triclinic_matrices
from ..algorithm.unit import strip_unit
from ..algorithm.utility import get_closest_factors
from ..core import profiling
from ..ops.cuda_cell_histogram import (
    _ASYM_SLOT_BYTES,
    _SLOT_BYTES,
    CellCapacityOverflow,
    cell_pair_histogram,
    cell_plan_search,
    cross_pair_histogram,
    triclinic_cell_pair_histogram,
    triclinic_cross_pair_histogram,
    triclinic_perpendicular_widths,
)
from ..algorithm.correlation import correlation_fft
from ..ops.cuda_kernels import trig_sums, trig_workspace
from ..ops.factor_scattering import factor_plan, factor_trig_sums
from ..ops.histogram import (
    _min_image_distance,
    displacement_histogram_frame,
    radial_histogram_frame,
)
from ..ops.mesh_scattering import mesh_plan, mesh_trig_sums
from ..parallel.mesh import fetch_global
from .base import (
    NumbaAnalysisBase,
    SerialAnalysisBase,
    _check_even_frame_spacing,
    carry_leaves,
)

__all__ = [
    "radial_histogram",
    "zeroth_order_hankel_transform",
    "radial_fourier_transform",
    "calculate_coordination_numbers",
    "calculate_structure_factor",
    "RadialDistributionFunction",
    "StructureFactor",
    "IntermediateScatteringFunction",
    "VanHoveFunction",
    "unique_wavenumber_groups",
    "group_mean_last_axis",
]

#: "no overflow" value of the occupancy-excess carry.
_NO_EXCESS = -(2**30)


def radial_histogram(pos1: np.ndarray, pos2: np.ndarray, n_bins: int,
                     range: tuple, dims: np.ndarray, *,
                     exclusion: tuple = None, device=None) -> np.ndarray:
    r"""Radial histogram of one frame's minimum-image pair distances.

    An exact all-pairs sweep
    (:func:`mdhelper_tpu_torch.ops.histogram.radial_histogram_frame`):
    the positions are taken as float32 and every pair's squared distance
    is formed and binned in error-free double-float arithmetic against
    the uniform float64 edges, so the counts are those of a float64
    evaluation of the same float32 coordinates.

    Parameters
    ----------
    pos1, pos2 : `numpy.ndarray`
        Positions, shapes ``(N_1, 3)`` / ``(N_2, 3)``.  In an orthorhombic
        box, coordinates outside ``[0, L)`` are wrapped into it first.
    n_bins : `int`
        Number of histogram bins.
    range : array-like
        ``(r_min, r_max)``.
    dims : array-like
        Box lengths ``(3,)``, or ``(6,)`` lengths and angles (any
        triclinic cell).
    exclusion : array-like, keyword-only, optional
        ``(e0, e1)``: drop pairs with ``i // e0 == j // e1`` (e.g.
        ``(1, 1)`` removes self-pairs).
    device : keyword-only, optional
        Device of the sweep (default: the first CUDA device, which must
        exist; ``"cpu"`` for the CPU).

    Returns
    -------
    histogram : `numpy.ndarray`
        int64 counts, shape ``(n_bins,)``.
    """

    device = resolve_device(device)
    dims = np.asarray(dims, dtype=float)
    pos1 = np.asarray(pos1, dtype=np.float32)
    pos2 = np.asarray(pos2, dtype=np.float32)
    if dims.shape[-1] == 6 and not np.allclose(dims[3:], 90.0):
        box = torch.as_tensor(triclinic_matrices(dims), dtype=torch.float32)
    else:
        lengths = dims[:3].astype(np.float32)
        # The orthorhombic sweep takes one image shift an axis.
        pos1, pos2 = (
            p if ((p >= 0) & (p < lengths)).all()
            else p - np.floor(p / lengths) * lengths
            for p in (pos1, pos2)
        )
        box = torch.as_tensor(lengths)
    counts = radial_histogram_frame(
        torch.as_tensor(pos1, device=device),
        torch.as_tensor(pos2, device=device),
        box.to(device),
        np.linspace(range[0], range[1], n_bins + 1),
        exclusion=None if exclusion is None else tuple(exclusion),
    )
    return counts.cpu().numpy().astype(np.int64)


def zeroth_order_hankel_transform(
    r: np.ndarray, f: np.ndarray, q: np.ndarray
) -> np.ndarray:
    r"""Zeroth-order Hankel transform
    :math:`F_0(q) = 2\pi\int f(r) J_0(qr) r\,dr` of discrete data."""

    q = np.asarray(q, dtype=float)
    ht = 2 * np.pi * simpson(f * r * jv(0, np.outer(q, r)), x=r)
    if 0 in q:
        ht[q == 0] = 2 * np.pi * simpson(f * r, x=r)
    return ht


def radial_fourier_transform(
    r: np.ndarray, f: np.ndarray, q: np.ndarray
) -> np.ndarray:
    r"""Radial Fourier transform
    :math:`\hat{f}(q) = \frac{4\pi}{q}\int f(r)\,r\sin(qr)\,dr` of
    discrete data."""

    q = np.asarray(q, dtype=float)
    with np.errstate(divide="ignore", invalid="ignore"):
        rft = 4 * np.pi * np.divide(
            simpson(f * r * np.sin(np.outer(q, r)), x=r), q
        )
    if 0 in q:
        rft[q == 0] = 4 * np.pi * simpson(f * r**2, x=r)
    return rft


def calculate_coordination_numbers(
    bins: np.ndarray,
    rdf: np.ndarray,
    rho: float,
    *,
    n_coord_nums: int = 2,
    n_dims: int = 3,
    threshold: float = 0.1,
) -> np.ndarray:
    r"""Coordination numbers from a radial distribution function:
    :math:`n_k = 4\pi\rho_j \int_{r_{k-1}}^{r_k} r^2 g_{ij}(r)\,dr`
    (3-D) or :math:`2\pi\rho_j \int r\,g_{ij}(r)\,dr` (2-D), with the
    shell boundaries at the local minima of :math:`g_{ij}(r)` that are at
    least `threshold` deep; `nan` where fewer than `n_coord_nums` minima
    exist."""

    if n_dims not in {2, 3}:
        raise ValueError("Invalid number of dimensions.")

    def shell_integral(r_slice, g_slice):
        if n_dims == 3:
            return 4 * np.pi * rho * simpson(r_slice**2 * g_slice,
                                             x=r_slice)
        return 2 * np.pi * rho * simpson(r_slice * g_slice, x=r_slice)

    coord_nums = np.full(n_coord_nums, np.nan)
    (minima,) = argrelextrema(rdf, np.less)
    minima = minima[rdf[minima] >= threshold]
    if not len(minima):
        warnings.warn("No local minima found.")
        return coord_nums

    stops = [0, *(int(i) + 1 for i in minima)]
    for k in range(min(n_coord_nums, len(minima))):
        lo = 0 if k == 0 else stops[k] - 1
        hi = stops[k + 1]
        coord_nums[k] = shell_integral(bins[lo:hi], rdf[lo:hi])
    return coord_nums


def calculate_structure_factor(
    r: np.ndarray,
    g: np.ndarray,
    equal: bool,
    rho: float,
    x_i: float = 1,
    x_j: float = None,
    q: np.ndarray = None,
    *,
    q_lower: float = None,
    q_upper: float = None,
    n_q: int = 1_000,
    n_dims: int = 3,
    formalism: str = "FZ",
) -> tuple[np.ndarray, np.ndarray]:
    r"""(Partial) static structure factor of an isotropic fluid from
    :math:`g_{ij}(r)`, in the Faber-Ziman (``"FZ"``), Ashcroft-Langreth
    (``"AL"``) or ``"general"`` formalism.  Returns ``(q, S(q))``."""

    if q is None:
        if q_lower is None:
            q_lower = 2 * np.pi / r[-1]
        if q_upper is None:
            q_upper = 2 * np.pi / r[0]
        q = np.linspace(
            q_lower,
            q_upper,
            int((q_upper - q_lower) / q_lower) if n_q is None else n_q,
        )

    if n_dims == 3:
        transform = radial_fourier_transform
    elif n_dims == 2:
        transform = zeroth_order_hankel_transform
    else:
        raise ValueError("Invalid number of dimensions.")

    rho_sft = rho * transform(r, g - 1, q)
    if equal or formalism == "FZ":
        return q, 1 + rho_sft
    if formalism == "AL":
        return q, (x_i == x_j) + np.sqrt(x_i * x_j) * rho_sft
    if formalism == "general":
        return q, 1 + x_i * x_j * rho_sft
    raise ValueError("Invalid formalism.")


def _frame_time_step(dt, trajectory):
    """`dt` (a number or a `Quantity`), or the trajectory's time step
    when `dt` is omitted or zero."""

    if isinstance(dt, Q_) or dt:
        return dt
    return trajectory.dt


def _entity_values(group, grouping: str, values: np.ndarray):
    """Per-entity (atom, residue or segment) sums of a per-atom array."""

    if grouping == "atoms":
        return values
    seg, n = _group_segment_ids(group, grouping)
    out = np.zeros(n)
    np.add.at(out, seg, values)
    return out


def _resolve_group_charges(groups, groupings, charges, reduced,
                           what: str = "charge density profile"):
    """Explicit per-group charges (unit-stripped), or each group's
    uniform entity charge from the topology (None, with a warning, when a
    group's entities differ; `what` names the quantity in it)."""

    if charges is not None:
        if len(charges) != len(groups):
            raise ValueError(
                "The number of group charges is not equal to the "
                "number of groups."
            )
        charges, unit_ = strip_unit(charges, "elementary_charge")
        if reduced and not isinstance(unit_, (str, type(None))):
            raise TypeError("'charges' cannot have units when reduced=True.")
        return np.asarray(charges)
    out = np.empty(len(groups))
    for i, (group, grouping) in enumerate(zip(groups, groupings)):
        entity = _entity_values(group, grouping, group.charges)
        if not np.allclose(entity[0], entity):
            warnings.warn(
                f"Not all {grouping} in group {i} share the same "
                f"charge. No {what} will be calculated."
            )
            return None
        out[i] = entity[0]
    return out


def _plan_extents(dimensions, triclinic):
    """Per-axis extents a cell plan sees: the orthorhombic box lengths,
    or the perpendicular widths of the float32-rounded triclinic cell
    (the rounding the kernels' shift table uses; the JAX package's
    ``_pallas_plan_extents``)."""

    dims = np.asarray(dimensions, np.float64)
    if not triclinic:
        return dims[:3]
    h32 = triclinic_matrices(dims).astype(np.float32)
    return np.asarray(triclinic_perpendicular_widths(h32), np.float64)


def _frame_boxes(dimensions, triclinic, drop_axis=None):
    """``(kernel box, volume)`` of each frame of a chunk's ``(B, 6)``
    float64 dimensions: the float32 lengths ``(B, 3)`` and their
    product, or the float32 box matrices ``(B, 3, 3)`` and
    ``h00 * h11 * h22`` of the float64 ones.  With `drop_axis` the
    "volume" is the area of the two kept lengths, formed as the JAX
    package's XLA route forms it (the dropped length set to the largest,
    the product divided by it)."""

    if triclinic:
        h = triclinic_matrices(dimensions)
        return h.to(torch.float32), h[:, 0, 0] * h[:, 1, 1] * h[:, 2, 2]
    lengths = dimensions[:, :3]
    if drop_axis is None:
        return lengths.to(torch.float32), lengths.prod(dim=1)
    padded = lengths.clone()
    padded[:, drop_axis] = lengths.max(dim=1).values
    return (lengths.to(torch.float32),
            padded.prod(dim=1) / padded[:, drop_axis])


def _check_range(range_):
    r_min, r_max = (float(r) for r in range_)
    if not 0.0 <= r_min < r_max:
        raise ValueError(f"range must satisfy 0 <= range[0] < range[1], not "
                         f"{tuple(range_)}.")
    return r_min, r_max


def _validate_groupings(groupings) -> list:
    """``groupings=`` as a list of two of ``"atoms"``, ``"residues"`` and
    ``"segments"`` (one name, or a sequence of one or two)."""

    valid = {"atoms", "residues", "segments"}
    names = [groupings] if isinstance(groupings, str) else list(groupings)
    for g in names:
        if g not in valid:
            raise ValueError(
                f"Invalid grouping '{g}'. The options are 'atoms', "
                "'residues', and 'segments'."
            )
    return names * 2 if len(names) == 1 else names


def _groupings_per_group(groupings, n_groups: int, valid) -> list:
    """``groupings=`` of an analysis over `n_groups` groups (one name for
    all, or one each) as a list, each name in `valid`."""

    groupings = (n_groups * [groupings] if isinstance(groupings, str)
                 else list(groupings))
    if len(groupings) != n_groups:
        raise ValueError(
            "The number of grouping values is not equal to the number of "
            "groups."
        )
    for g in groupings:
        if g not in valid:
            raise ValueError(f"Invalid grouping '{g}'. Valid values: "
                             f"{', '.join(sorted(valid))}.")
    return groupings


def _group_segment_ids(ag, grouping: str):
    """``(segment ids, entity count)`` of a group under `grouping`: ``None``
    and the atom count for ``"atoms"``, else each atom's entity relabeled
    0..G-1 in ascending order of its residue or segment index."""

    if grouping == "atoms":
        return None, ag.n_atoms
    labels = ag.resindices if grouping == "residues" else ag.segindices
    _, ids = np.unique(labels, return_inverse=True)
    ids = ids.reshape(-1)
    return ids.astype(np.int32), int(ids.max()) + 1


def _com_reducer(group, grouping: str, device):
    """``(reduce, n_entities)`` of a group under `grouping`: ``reduce`` maps
    ``(B, n_atoms, C)`` float32 columns of the group (in group order; C
    coordinate columns, usually 3) to the ``(B, n_entities, C)`` centers
    of mass of its residues or segments (entities in ascending label
    order), or is ``None`` for ``"atoms"``
    (:func:`_segment_com_reducer`)."""

    seg, n = _group_segment_ids(group, grouping)
    if seg is None:
        return None, n
    return _segment_com_reducer(seg, n, group.masses, device), n


def _segment_com_reducer(seg, n, masses, device):
    """``reduce``: ``(B, n_atoms, C)`` float32 columns to the ``(B, n, C)``
    centers of mass of the segments ``seg`` (ids ``0..n-1``, one an atom)
    under `masses`.

    Each segment's members form a row of a ``(n, K)`` table built here,
    on the host, in ascending atom order and padded with a zero column
    (``K`` is the largest segment).  The weighted positions ``positions *
    masses`` (one float32 product) are summed over the table's ``K``
    columns in order, from 0, then divided by the mass sums taken the
    same way: the order of the JAX package's ``segment_sum`` on the CPU,
    with no atomics, so the card and the CPU give the same bits.  ``K``
    steps of a gather and an add: cheap for molecules, ``K`` launches a
    chunk for a segment of ``K`` atoms."""

    seg = np.asarray(seg)
    n_atoms = len(seg)
    order = np.argsort(seg, kind="stable")
    sizes = np.bincount(seg, minlength=n)
    starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    table = np.full((n, int(sizes.max())), n_atoms, dtype=np.int64)
    table[seg[order], np.arange(n_atoms) - starts[seg[order]]] = order
    masses = np.append(np.asarray(masses, np.float32), np.float32(0))
    mass_sums = np.zeros(n, dtype=np.float32)
    for column in table.T:
        mass_sums = mass_sums + masses[column]
    masses = torch.as_tensor(masses[:-1], device=device)
    mass_sums = torch.as_tensor(mass_sums, device=device)
    columns = torch.as_tensor(table.T.copy(), device=device)

    def reduce(positions):
        width = positions.shape[-1]
        weighted = positions * masses[:, None]
        weighted = torch.cat(
            (weighted,
             weighted.new_zeros(weighted.shape[:-2] + (1, width))),
            dim=-2)
        total = weighted.new_zeros(weighted.shape[:-2] + (n, width))
        for column in columns:
            total = total + weighted[..., column, :]
        return total / mass_sums[:, None]

    return reduce


def _column_selector(sel, n_cols, device):
    """``take(columns)``: the ``(B, len(sel), C)`` columns `sel` of a
    chunk's ``(B, n_cols, C)`` columns on `device`, or the chunk itself
    when `sel` is every column in order (the JAX package's
    ``_column_selector``)."""

    sel = np.asarray(sel)
    if len(sel) == n_cols and np.array_equal(sel, np.arange(n_cols)):
        return lambda columns: columns
    index = torch.as_tensor(sel, device=device)
    return lambda columns: columns[:, index]


def _entity_positions_fn(groups, groupings, device):
    """``entities(columns)``: the ``(B, N, 3)`` entity positions of a
    chunk's group-ordered atom columns (the groups' columns one after
    another), group after group: the columns themselves, or the centers
    of mass of each group's residues or segments (:func:`_com_reducer`)."""

    parts, lo = [], 0
    for group, grouping in zip(groups, groupings):
        reduce, _ = _com_reducer(group, grouping, device)
        parts.append((lo, group.n_atoms, reduce))
        lo += group.n_atoms
    if all(reduce is None for *_, reduce in parts):
        return lambda columns: columns

    def entities(columns):
        return torch.cat([
            columns[:, lo:lo + n] if reduce is None
            else reduce(columns[:, lo:lo + n])
            for lo, n, reduce in parts
        ], dim=1)

    return entities


class _CellPlanned(SerialAnalysisBase):
    """Shared by the analyses on the cell-list kernels: the plan cache,
    capacity escalation in :meth:`run` and the carry checks.
    Subclasses set ``_plan_atoms``: ``(n1, None)`` plans the self sweep,
    ``(n1, n2)`` the cross sweep."""

    _cell_plan_cache = None
    _plan_atoms = None
    #: the grid's coordinate columns (None: all three; two for a 2-D
    #: grid) and the shared-memory bytes of its slots.
    _axes = None
    _slot_bytes = _SLOT_BYTES

    def _searched_cell_plan(self):
        if self._cell_plan_cache is None:
            with profiling.span("plan.cells"):
                n1, n2 = self._plan_atoms
                extents = _plan_extents(self.universe.dimensions,
                                        self._triclinic)
                if self._axes is not None:
                    extents = extents[list(self._axes)]
                self._cell_plan_cache = cell_plan_search(
                    n1, extents, float(self._range[1]), n_atoms2=n2,
                    capacity_sigmas=self._capacity_sigmas,
                    slot_bytes=self._slot_bytes,
                )
        return self._cell_plan_cache

    def run(self, *args, **kwargs):
        """Run, re-planning with ``capacity_sigmas += 2`` (twice at
        most) when a cell overflows its planned capacity."""

        try:
            return super().run(*args, **kwargs)
        except CellCapacityOverflow:
            retries = getattr(self, "_capacity_retries", 0)
            if retries >= 2:
                raise
            self._capacity_retries = retries + 1
            self._capacity_sigmas += 2.0
            self._cell_plan_cache = None
            warnings.warn(
                "Cell capacity overflow (a density fluctuation exceeded "
                "the planned slot count); re-planning with "
                f"capacity_sigmas={self._capacity_sigmas} and re-running."
            )
            return self.run(*args, **kwargs)

    def _check_cell_carry(self, counts_key) -> None:
        """Raise on a capacity overflow or a NaN-poisoned frame."""

        if "max_occ" not in self._carry:
            return
        excess = int(self._carry.pop("max_occ"))
        if excess > 0:
            raise CellCapacityOverflow(
                f"cell capacity overflow (by {excess} atoms): a cell "
                "exceeded its planned slot count (a density fluctuation "
                "or clustering). Re-run with a larger capacity_sigmas= "
                "(default 4.0)."
            )
        if torch.isnan(self._carry[counts_key]).any():
            raise RuntimeError(
                "A frame's box shrank below the planned cell grid (box "
                "length, or perpendicular width of a triclinic box, "
                "over n_cells_dim under r_max on some axis); the "
                "neighbor sweep would miss pairs. Re-plan against the "
                "smallest box along the trajectory."
            )


class RadialDistributionFunction(_CellPlanned):
    r"""Radial distribution function :math:`g(r)` of one group with
    itself, or between two groups (which may overlap), in three dimensions or
    (``drop_axis``) in the plane of the two other axes.

    The box may be orthorhombic or triclinic (then the volume is
    :math:`h_{00} h_{11} h_{22}` of the box matrix), of any size: boxes
    under 3 cutoffs take generalized cell grids.  A 2-D RDF needs an
    orthorhombic box; its normalization is the area of the kept axes and
    the ring areas :math:`\pi \Delta(r^2)`.

    Parameters
    ----------
    ag1 : `AtomGroup`
        The group (group :math:`i`).
    ag2 : `AtomGroup`, optional
        Group :math:`j`; omitted or equal to `ag1` for the self RDF (with
        equal `groupings`).  A different group may share atoms with
        `ag1`: each shared atom pairs with itself at distance 0, in bin 0.
    n_bins : `int`, default 201
        Number of bins.
    range : `tuple`, default ``(0.0, 15.0)``
        Histogram range ``(r_min, r_max)``, ``0 <= r_min < r_max``.
    drop_axis : `int` or `str`, optional
        Axis left out of a 2-D analysis (``0``/``"x"``, ``1``/``"y"``,
        ``2``/``"z"``), e.g. the normal of a film or membrane.
    norm : `str`, default ``"rdf"``
        ``"rdf"``, ``"density"`` or ``None``.
    exclusion : `tuple`, optional
        ``(e0, e1)`` tile exclusion: ordered pairs with ``i // e0 == j //
        e1`` on the group-local entity indices are dropped (e.g. ``(3,
        3)`` for the intramolecular pairs of a 3-site water model).  Self
        RDF: ``None`` keeps the identical-entity pairs (bin 0, as in the
        reference, when the range starts at 0), ``(1, 1)`` drops them,
        any other tile, symmetric or not, is served by the self kernel.
        Cross RDF: any ``(e0, e1)`` (e.g. cation-anion pairs of one
        molecule).
    groupings : `str` or `tuple`, keyword-only, default ``"atoms"``
        ``"atoms"``, ``"residues"`` or ``"segments"``, for both groups or
        one for each: the RDF of the residues' or segments' centers of
        mass (entities in ascending label order).  The sweep is the self
        sweep only when `ag2` is omitted or equal to `ag1` and both
        groupings are equal: ``groupings=("residues", "atoms")`` over one
        group is a cross sweep of centers against atoms.  Counts and the
        normalization count entities.
    reduced : `bool`, keyword-only, default False
        Data in reduced (LJ) units: :meth:`calculate_pmf` then takes the
        energy scale :math:`k_\mathrm{B}T` itself, without units.
    n_batches : `int`, keyword-only, optional
        Accepted for compatibility and ignored (with a warning): the cell
        kernels tile the pair sweep themselves.
    parallel : `bool`, keyword-only, default False
        Shard the frames over the ranks of :mod:`torch.distributed` (see
        :mod:`mdhelper_tpu_torch.analysis.base`; a world of one without a
        process group).
    shard : `str`, keyword-only, optional
        ``None``, ``"frames"`` (``parallel=True``) or ``"atoms"``: the
        atom-sharded ring (:mod:`mdhelper_tpu_torch.parallel.ring`), every
        rank reading every frame and counting its block of group 1 against
        each rotating block of group 2 (of the group itself for a self
        RDF), on the cross cell-list kernel with global exclusion ids.  It
        needs ``groupings="atoms"`` and an orthorhombic box.
    capacity_sigmas : `float`, default 4.0
        Cell-capacity headroom in Poisson sigmas; :meth:`run` raises it
        by 2 and re-runs after a capacity overflow (twice at most; over
        ranks the overflow is the maximum over them, so every rank
        re-runs together).
    device : optional
        Device the chunks are folded on (default: the current CUDA
        device, which must exist; ``"cpu"`` for the CPU).

    The post-hoc methods :meth:`calculate_coordination_numbers`,
    :meth:`calculate_pmf` and :meth:`calculate_structure_factor` work on
    the RDF whatever the `norm` of the run.
    """

    _rank_sharded = True

    def __init__(self, ag1, ag2=None, n_bins: int = 201,
                 range: tuple = (0.0, 15.0), *, drop_axis=None,
                 norm: str = "rdf", exclusion: tuple = None,
                 groupings="atoms", reduced: bool = False,
                 n_batches: int = None, parallel: bool = False,
                 shard: str = None, capacity_sigmas: float = 4.0,
                 verbose: bool = True, device=None, **kwargs):
        if shard not in {None, "frames", "atoms"}:
            raise ValueError(
                "Invalid shard. Valid values: None, 'frames', 'atoms'."
            )
        if shard == "atoms" and any(
                g != "atoms" for g in
                ([groupings] if isinstance(groupings, str) else groupings)):
            raise ValueError(
                "shard='atoms' requires groupings='atoms' (center-"
                "of-mass reduction would cross atom shards)."
            )
        self._groupings = _validate_groupings(groupings)
        same_atoms = ag2 is None or ag2 == ag1
        self._cross = (not same_atoms
                       or self._groupings[0] != self._groupings[1])
        self.ag1 = ag1
        self.ag2 = ag1 if same_atoms else ag2
        self.universe = ag1.universe
        super().__init__(self.universe.trajectory, verbose, device=device,
                         **kwargs)
        self._shard = shard
        self._parallel = bool(parallel) or shard == "frames"
        if shard == "atoms":
            # Every rank reads every frame; the ring shards the atoms.
            self._shard_axis = "replicated"
        self._require_box("RadialDistributionFunction")
        self._range = _check_range(range)
        self._drop_axis = (ord(drop_axis) - ord("x")
                           if isinstance(drop_axis, str) else drop_axis)
        if self._drop_axis not in {0, 1, 2, None}:
            raise ValueError("Invalid axis to drop.")
        self._setup_periodic_box()
        if self._triclinic and shard == "atoms":
            raise ValueError(
                "shard='atoms' currently supports orthorhombic boxes only."
            )
        if self._drop_axis is not None:
            if self._triclinic:
                raise ValueError("drop_axis (2-D analysis) requires an "
                                 "orthorhombic box.")
            self._axes = tuple(a for a in (0, 1, 2) if a != self._drop_axis)
        self._exclusion = (
            None if exclusion is None
            else tuple(int(e) for e in exclusion)
        )
        # One copy of the columns when both sides take the same atoms.
        # Overlapping groups need no route of their own: the cross kernel
        # applies no identical-atom mask, so an atom in both groups lands
        # at distance 0, in bin 0, as in the JAX class.
        self._atom_indices = (
            np.asarray(ag1.ix) if same_atoms
            else np.concatenate((ag1.ix, ag2.ix))
        )
        if (not self._cross and self._exclusion is not None
                and self._exclusion[0] != self._exclusion[1]):
            # The second tile ids widen the self kernel's slots.
            self._slot_bytes = _ASYM_SLOT_BYTES
        self._n_bins = n_bins
        self._norm = norm
        self._reduced = reduced
        self._capacity_sigmas = float(capacity_sigmas)
        if n_batches is not None:
            warnings.warn(
                "n_batches is accepted for API compatibility but has no "
                "effect: the cell-list kernels tile the pair sweep "
                "themselves."
            )
        # Entity counts (atoms, residues or segments).
        _, self._n1 = _group_segment_ids(self.ag1, self._groupings[0])
        _, self._n2 = _group_segment_ids(self.ag2, self._groupings[1])
        self._plan_atoms = (self._n1, self._n2 if self._cross else None)

    def _n_shards(self) -> int:
        if self._shard == "atoms":
            from ..parallel.mesh import get_mesh

            return max(1, min(get_mesh().world, self.ag1.n_atoms))
        return super()._n_shards()

    def _prepare(self) -> None:
        self.results.edges = np.linspace(*self._range, self._n_bins + 1)
        self.results.bins = (
            self.results.edges[:-1] + self.results.edges[1:]
        ) / 2
        self.results.units = {
            "results.bins": ureg.angstrom,
            "results.edges": ureg.angstrom,
        }
        device = self._device
        self._carry = {
            "counts": torch.zeros(
                self._n_bins, dtype=torch.float64, device=device
            ),
            "volume": torch.zeros((), dtype=torch.float64, device=device),
            "max_occ": torch.full(
                (), _NO_EXCESS, dtype=torch.int32, device=device
            ),
        }
        # Over ranks the occupancy excess reduces by its maximum, so an
        # overflow on one rank re-plans every rank (run()).
        self._carry_reductions = {"max_occ": "max"}
        if self._shard == "atoms":
            self._prepare_ring()
            return
        plan = self._searched_cell_plan()
        r_min, r_max = self._range
        n_bins = self._n_bins
        n1 = self._n1
        cross = self._cross
        # Group 2's columns follow group 1's when the groups differ.
        split = None if self.ag2 is self.ag1 else self.ag1.n_atoms
        com1, _ = _com_reducer(self.ag1, self._groupings[0], device)
        com2, _ = _com_reducer(self.ag2, self._groupings[1], device)
        exclusion = self._exclusion
        triclinic = self._triclinic
        drop_axis = self._drop_axis
        self_sweep, cross_sweep = (
            (triclinic_cell_pair_histogram, triclinic_cross_pair_histogram)
            if triclinic else (cell_pair_histogram, cross_pair_histogram)
        )
        # exclusion=None (the reference default) of a self RDF: the
        # kernel drops identical-atom pairs, whose distance is exactly
        # 0, so they are added back into bin 0 -- unless the range
        # starts above 0, which leaves them out.
        self_pairs = (n1 if not cross and exclusion is None and r_min == 0.0
                      else 0)
        grid = dict(r_max=r_max, r_min=r_min, n_cells_dim=plan["n_cells_dim"],
                    reach=plan["reach"], n_bins=n_bins)
        if self._axes is not None:
            grid["axes"] = self._axes

        def sweep(positions, box):
            """(counts, occupancy excess over capacity) per frame."""

            pos1 = positions if split is None else positions[:, :split]
            if com1 is not None:
                pos1 = com1(pos1)
            if cross:
                pos2 = positions if split is None else positions[:, split:]
                if com2 is not None:
                    pos2 = com2(pos2)
                counts, occ1, occ2 = cross_sweep(
                    pos1, pos2, box=box,
                    capacity1=plan["capacity"],
                    capacity2=plan["capacity2"], exclusion=exclusion,
                    **grid,
                )
                return counts, torch.maximum(
                    occ1 - plan["capacity"], occ2 - plan["capacity2"]
                )
            counts, occ = self_sweep(
                pos1, box=box, capacity=plan["capacity"],
                exclusion=exclusion, **grid
            )
            if self_pairs:
                counts[:, 0] += self_pairs
            return counts, occ - plan["capacity"]

        def update(carry, positions, dimensions, mask):
            box, frame_volume = _frame_boxes(dimensions, triclinic,
                                             drop_axis)
            counts, excess = sweep(positions, box)
            valid = mask > 0
            # > 0 is an overflow.
            excess = torch.where(valid, excess, _NO_EXCESS).max().to(
                torch.int32
            )
            # where, not a product: a NaN-poisoned padding frame times 0
            # would still be NaN.
            counts = torch.where(valid[:, None], counts, 0.0)
            volume = (frame_volume * mask).sum()
            return {
                "counts": carry["counts"] + counts.sum(dim=0),
                "volume": carry["volume"] + volume,
                "max_occ": torch.maximum(carry["max_occ"], excess),
            }

        self._update = update

    def _prepare_ring(self) -> None:
        """The atom-sharded update (JAX ``_prepare_ring``): every rank
        streams every frame's ``[group 1 | group 2]`` columns (one copy
        for a self RDF), and the rank of shard ``k`` counts group-1 atoms
        ``[k s_1, (k + 1) s_1)`` against each block of group 2 the ring
        passes it (:func:`mdhelper_tpu_torch.parallel.ring._ring_counts`:
        the cross kernel with global exclusion ids on the card, the plain
        dense block on the CPU), all of a chunk's frames at once.  Every
        rank sums the volumes of all frames itself, so that leaf is not
        summed over the ranks."""

        from ..parallel.ring import (
            _RingStep, _pad_rows, _ring_counts, _shard_blocks,
        )

        mesh = self._mesh
        cross = self.ag2 is not self.ag1
        n1 = self.ag1.n_atoms
        n2 = self.ag2.n_atoms if cross else n1
        shard_i, _ = _shard_blocks(n1, mesh.size)
        shard_j, padded_j = _shard_blocks(n2, mesh.size)
        r_min, r_max = self._range
        step = _RingStep(
            r_min=r_min, r_max=r_max, n_bins=self._n_bins,
            exclusion=self._exclusion, precision="exact",
            shards=(shard_i, shard_j),
            extents=_plan_extents(self.universe.dimensions, False),
            axes=self._axes, capacity_sigmas=self._capacity_sigmas,
        )
        self._carry_reductions = {"max_occ": "max", "volume": "replicated"}
        drop_axis = self._drop_axis
        index = mesh.index

        def update(carry, positions, dimensions, mask):
            box, frame_volume = _frame_boxes(dimensions, False, drop_axis)
            carry = dict(carry, volume=carry["volume"]
                         + (frame_volume * mask).sum())
            if index is None:
                return carry
            lo = index * shard_i
            pos_i = positions[:, lo:min(lo + shard_i, n1)]
            pos_j = positions[:, n1:] if cross else positions
            block = _pad_rows(pos_j, padded_j)[
                :, index * shard_j:(index + 1) * shard_j]
            counts, excess = _ring_counts(
                pos_i, block, box, mesh, step, i_offset=lo,
                shard_j=shard_j, n_real_j=n2)
            valid = mask > 0
            # where, not a product: a NaN-poisoned frame times 0 is NaN.
            counts = torch.where(valid[:, None], counts, 0.0)
            excess = torch.where(valid, excess, _NO_EXCESS).max()
            return dict(
                carry, counts=carry["counts"] + counts.sum(dim=0),
                max_occ=torch.maximum(carry["max_occ"],
                                      excess.to(torch.int32)))

        self._update = update

    def _conclude(self) -> None:
        self._check_cell_carry("counts")
        self.results.counts = (
            self._carry["counts"].cpu().numpy().astype(np.int64)
        )
        self._area_or_volume = float(self._carry["volume"])
        norm = self.n_frames
        if self._norm is not None:
            edges = self.results.edges
            if self._drop_axis is None:
                norm = norm * (4 * np.pi * np.diff(edges**3) / 3)
            else:
                norm = norm * np.pi * np.diff(edges**2)
            if self._norm == "rdf":
                n2 = self._n2
                if self._exclusion:
                    n2 -= self._exclusion[1]
                norm = norm * (
                    self._n1 * n2 * self.n_frames / self._area_or_volume
                )
        self.results.rdf = self.results.counts / norm

    def _get_rdf(self) -> np.ndarray:
        """The RDF whatever the `norm` the analysis ran with."""

        if self._norm == "rdf":
            return self.results.rdf
        n2 = self._n2
        if self._exclusion:
            n2 -= self._exclusion[1]
        if self._drop_axis is None:
            shell = 4 * np.diff(self.results.edges**3) / 3
        else:
            shell = np.diff(self.results.edges**2)
        return self._area_or_volume * self.results.counts / (
            np.pi * self.n_frames**2 * self._n1 * n2 * shell
        )

    def calculate_coordination_numbers(self, rho: float, *,
                                       n_coord_nums: int = 2,
                                       threshold: float = 0.1) -> None:
        """Coordination numbers :math:`n_k` of the computed RDF
        (:func:`calculate_coordination_numbers` with the number density
        `rho` of group :math:`j`), as ``results.coordination_numbers``."""

        self.results.coordination_numbers = calculate_coordination_numbers(
            self.results.bins,
            self._get_rdf(),
            rho,
            n_coord_nums=n_coord_nums,
            n_dims=2 + (self._drop_axis is None),
            threshold=threshold,
        )

    def calculate_pmf(self, temperature: Union[float, Q_]) -> None:
        r"""Potential of mean force
        :math:`w_{ij}(r) = -k_\mathrm{B}T\ln g_{ij}(r)` (kJ/mol; `-inf`
        where :math:`g = 0`), as ``results.pmf``.  With ``reduced=True``,
        `temperature` is the energy scale itself and takes no units (the
        JAX package's check, which departs from its reference's inverted
        one)."""

        self.results.units["results.pmf"] = ureg.kilojoule / ureg.mole
        temperature, unit_ = strip_unit(temperature, "kelvin")
        if self._reduced:
            if not isinstance(unit_, (str, type(None))):
                raise ValueError(
                    "'temperature' cannot have units when reduced=True."
                )
            kbt = temperature
        else:
            kbt = (
                ureg.avogadro_constant
                * ureg.boltzmann_constant
                * temperature
                * ureg.kelvin
            ).m_as(self.results.units["results.pmf"])
        with np.errstate(divide="ignore"):
            self.results.pmf = -kbt * np.log(self._get_rdf())

    def calculate_structure_factor(self, rho: float, x_i: float = None,
                                   x_j: float = None, q: np.ndarray = None,
                                   *, q_lower: float = None,
                                   q_upper: float = None, n_q: int = 1_000,
                                   formalism: str = "FZ") -> None:
        """S(q) of the computed RDF (:func:`calculate_structure_factor`;
        a self RDF when the two groups are equal), as
        ``results.wavenumbers`` and ``results.ssf``."""

        self.results.wavenumbers, self.results.ssf = (
            calculate_structure_factor(
                self.results.bins,
                self._get_rdf(),
                self.ag1 == self.ag2,
                rho,
                x_i,
                x_j,
                q=q,
                q_lower=q_lower,
                q_upper=q_upper,
                n_q=n_q,
                n_dims=2 + (self._drop_axis is None),
                formalism=formalism,
            )
        )


def _wavevector_grid(dimensions, n_points: int, n_surfaces: int = None,
                     n_surface_points: int = 8) -> np.ndarray:
    r"""Wavevector grid :math:`2\pi\mathbf{n}/L` in the reference's
    meshgrid order, with optional extra spherical-surface points for
    cubic boxes (the first-octant construction of the JAX package's
    ``_wavevector_grid``, operation for operation; a non-cubic box warns
    and ignores `n_surfaces`)."""

    dimensions = np.asarray(dimensions, dtype=float)
    if np.allclose(dimensions, dimensions[0]):
        grid = 2 * np.pi * np.arange(n_points) / dimensions[0]
        wavevectors = np.stack(
            np.meshgrid(grid, grid, grid), axis=-1
        ).reshape(-1, 3)
        if n_surfaces:
            n_theta, n_phi = get_closest_factors(
                n_surface_points, 2, reverse=True
            )
            theta = np.linspace(
                np.pi / (2 * n_theta + 4),
                np.pi / 2 - np.pi / (2 * n_theta + 4),
                n_theta,
            )
            phi = np.linspace(
                np.pi / (2 * n_phi + 4),
                np.pi / 2 - np.pi / (2 * n_phi + 4),
                n_phi,
            )
            directions = np.stack(
                (
                    np.sin(theta) * np.cos(phi)[:, None],
                    np.sin(theta) * np.sin(phi)[:, None],
                    np.tile(np.cos(theta)[None, :], (n_phi, 1)),
                ),
                axis=-1,
            )
            surface = np.einsum(
                "o,tpd->otpd", grid[1:n_surfaces + 1], directions
            ).reshape(n_surfaces * n_surface_points, 3)
            wavevectors = np.vstack((wavevectors, surface))
    else:
        if n_surfaces:
            warnings.warn(
                "Spherical-surface wavevectors require a cubic box; "
                "n_surfaces is ignored."
            )
        wavevectors = np.stack(
            np.meshgrid(
                *[2 * np.pi * np.arange(n_points) / L for L in dimensions]
            ),
            axis=-1,
        ).reshape(-1, 3)
    return wavevectors


def unique_wavenumber_groups(wavenumbers):
    """Unique wavenumbers (rounded to 11 decimals) and each
    wavevector's group index."""

    unique, inverse = np.unique(
        np.asarray(wavenumbers).round(11), return_inverse=True
    )
    return unique, inverse.ravel()


def group_mean_last_axis(values, group, n_unique):
    """Mean of `values` over last-axis segments defined by `group`."""

    moved = np.ascontiguousarray(np.moveaxis(values, -1, 0))
    sums = np.zeros((n_unique,) + moved.shape[1:], dtype=np.float64)
    np.add.at(sums, group, moved)
    counts = np.bincount(group, minlength=n_unique)
    sums /= counts.reshape((-1,) + (1,) * (sums.ndim - 1))
    return np.moveaxis(sums, 0, -1)


class StructureFactor(NumbaAnalysisBase):
    r"""Static structure factor :math:`S(q)` and partial structure
    factors :math:`S_{\alpha\beta}(q)` from particle positions.

    .. math::

       S(q) = \frac{1}{N}\left\langle\left(\sum_j
       \cos(\mathbf{q}\cdot\mathbf{r}_j)\right)^2 + \left(\sum_j
       \sin(\mathbf{q}\cdot\mathbf{r}_j)\right)^2\right\rangle

    The per-group sums :math:`\sum_j \cos` and :math:`\sum_j \sin` come
    from the direct trig sums (the CUDA kernel of
    :func:`mdhelper_tpu_torch.ops.cuda_kernels.trig_sums`, all of a
    chunk's frames in one launch) or from the factorized lattice sums
    (:mod:`mdhelper_tpu_torch.ops.factor_scattering`); ``mode="pair"``
    and ``"partial"`` combine them into the rows :math:`c_j^2 + s_j^2`
    and :math:`2(c_j c_k + s_j s_k)`.

    Parameters
    ----------
    groups : `AtomGroup` or sequence of them
        Group(s) of atoms.  With ``mode=None`` the groups must jointly
        contain every atom of the universe; with ``mode="pair"`` exactly
        one or two groups.
    groupings : `str` or sequence, default ``"atoms"``
        ``"atoms"`` or ``"residues"`` (the residues' centers of mass, in
        ascending label order), for every group or one for each.  The
        normalization counts these entities.
    mode : `str`, optional
        ``None`` (total S(q)), ``"pair"`` (the pair of the first and last
        group) or ``"partial"`` (every pair of groups, with repeats).
    form : `str`, default ``"exp"``
        ``"exp"`` or ``"trig"``; both evaluate the same trig sums (as in
        the JAX package).
    dimensions : array-like or `Quantity`, optional
        Box lengths (default: the trajectory's first frame).
    n_points : `int`, default 32
        Wavevector grid points per axis.
    n_surfaces, n_surface_points : `int`
        Extra spherical-surface wavevectors (cubic boxes): `n_surfaces`
        shells of `n_surface_points` first-octant directions each.
    q_max : `float` or `Quantity`, optional
        Wavenumber cutoff (1/A).
    wavevectors : `numpy.ndarray`, optional
        Explicit wavevectors (overrides the grid; any, on the lattice or
        off it).
    sort, unique : `bool`, default True
        Sort by wavenumber / average equal-magnitude wavevectors.
    parallel : `bool`, default False
        Shard the frames over the ranks of :mod:`torch.distributed` (see
        :mod:`mdhelper_tpu_torch.analysis.base`; a world of one without a
        process group).
    shard : `str`, optional
        ``None``, ``"frames"`` (``parallel=True``) or ``"q"``: every rank
        reads every frame and sums the direct trig sums of its own
        contiguous tile of the wavevectors (the tiles may differ by one in
        length), and the tiles are gathered in order at the end
        (:func:`~mdhelper_tpu_torch.parallel.mesh.all_gather_tiles`).
        ``"q"`` takes the direct sums: ``method="factor"`` and ``"mesh"``
        raise.
    precision : `str`, default ``"auto"``
        ``"exact"`` (double-float phases; what ``"auto"`` means for the
        port's float32 streams) or ``"fast"`` (float32 phases).
    method : `str`, default ``"auto"``
        ``"direct"``: the trig sums of every wavevector.  ``"factor"``:
        the factorized sums, which need lattice wavevectors
        :math:`2\pi\mathbf{n}/L` with non-negative indices.
        ``"auto"``: the factorized sums when the wavevectors are on the
        lattice, the direct ones otherwise.  A mixed set (a lattice grid
        plus off-grid extras such as the surface points) is split under
        ``"auto"`` and ``"factor"``: at least 64 lattice points go through
        the factorized sums and the extras through the direct ones.
        ``"mesh"``: Kaiser-Bessel gridding and a 3-D FFT
        (:func:`~mdhelper_tpu_torch.ops.mesh_scattering.mesh_trig_sums`,
        about 5e-6 relative) for lattice wavevectors with non-negative
        indices, in the box given at construction; one group with
        ``mode=None`` only.
    device : optional
        Device the chunks are folded on (default: the current CUDA
        device, which must exist; ``"cpu"`` for the CPU).
    """

    _rank_sharded = True

    def __init__(self, groups, groupings="atoms", *, mode: str = None,
                 form: str = "exp", dimensions=None, n_points: int = 32,
                 n_surfaces: int = None, n_surface_points: int = 8,
                 q_max=None, wavevectors=None, sort: bool = True,
                 unique: bool = True, parallel: bool = False,
                 shard: str = None, precision: str = "auto",
                 method: str = "auto", verbose: bool = True, device=None, **kwargs):
        self._groups = (
            [groups] if hasattr(groups, "universe") else list(groups)
        )
        self.universe = self._groups[0].universe
        if shard not in {None, "frames", "q"}:
            raise ValueError(
                "Invalid shard. Valid values: None, 'frames', 'q'."
            )
        if shard == "q" and method in {"mesh", "factor"}:
            raise ValueError(
                "shard='q' applies to the direct wavevector sweep; "
                f"method='{method}' distributes over frames instead."
            )
        super().__init__(self.universe.trajectory, verbose, device=device,
                         **kwargs)
        self._shard = shard
        self._parallel = bool(parallel) or shard == "frames"
        if shard == "q":
            # Every rank reads every frame; the wavevectors are sharded.
            self._shard_axis = "replicated"
        self._n_groups = len(self._groups)
        self._groupings = groupings = _groupings_per_group(
            groupings, self._n_groups, {"atoms", "residues"})
        if form not in {"exp", "trig"}:
            raise ValueError("Invalid form. Valid values: 'exp', 'trig'.")
        if method not in {"auto", "direct", "factor", "mesh"}:
            raise ValueError(
                "Invalid method. Valid values: 'auto', 'direct', "
                "'factor', 'mesh'."
            )
        self._method = method
        if mode not in {None, "pair", "partial"}:
            raise ValueError("Invalid mode.")
        if mode == "pair" and not 1 <= self._n_groups <= 2:
            raise ValueError(
                "There must be exactly one or two groups when "
                "mode='pair'."
            )
        if mode is None and sum(g.n_atoms for g in self._groups) != (
            self.universe.atoms.n_atoms
        ):
            raise ValueError(
                "The provided atom groups do not contain all atoms in "
                "the universe."
            )
        self._mode = mode
        if precision not in {"auto", "fast", "exact"}:
            raise ValueError(
                "Invalid precision. Valid values: 'auto', 'fast', 'exact'."
            )
        # The port streams float32, for which the JAX package's "auto"
        # is the exact double-float path.
        self._precision = "exact" if precision == "auto" else precision
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
        elif wavevectors is None:
            raise ValueError("No system dimensions found or provided.")
        else:
            self._dimensions = None
        if wavevectors is None and not (self._dimensions > 0).all():
            raise ValueError(
                "The wavevector grid needs a periodic box with non-zero "
                "dimensions (pass explicit wavevectors= for box-less "
                "systems)."
            )
        if wavevectors is not None:
            self._wavevectors = np.asarray(wavevectors, dtype=float)
        else:
            self._wavevectors = _wavevector_grid(
                self._dimensions, n_points, n_surfaces, n_surface_points
            )
        self._wavenumbers = np.linalg.norm(self._wavevectors, axis=1)
        if q_max is not None:
            q_max = strip_unit(q_max, "angstrom**-1")[0]
            keep = self._wavenumbers <= q_max
            self._wavevectors = self._wavevectors[keep]
            self._wavenumbers = self._wavenumbers[keep]
        # The groups' columns are streamed one group after another; each
        # group scatters as its entities (atoms or residues).
        self._atom_indices = np.concatenate([g.ix for g in self._groups])
        self._Ns = np.array([_group_segment_ids(g, gr)[1]
                             for g, gr in zip(self._groups, groupings)])
        self._N = int(self._Ns.sum())
        # Each group's entities in the concatenated entity positions.
        ends = np.cumsum(self._Ns)
        self._entity_slices = [(int(e - n), int(n))
                               for e, n in zip(ends, self._Ns)]
        self._sort = sort
        self._unique = unique

    def _factor_setup(self):
        """The factorized-lattice plan of the wavevector set (or None for
        the direct sums), as the JAX package's ``_factor_setup``.  A mixed
        set -- a lattice grid plus off-grid extras -- is split: the
        lattice part goes through the factorized sums and only the extras
        through the direct ones (``self._factor_split``)."""

        self._factor_split = None
        if (self._method not in {"auto", "factor"} or self._shard == "q"
                or self._dimensions is None):
            if self._method == "factor" and self._dimensions is None:
                raise ValueError("method='factor' requires box dimensions.")
            return None
        try:
            return factor_plan(self._wavevectors, self._dimensions)
        except ValueError as exc:
            full_set_error = exc
        qs = np.asarray(self._wavevectors, np.float64)
        dims = np.asarray(self._dimensions, np.float64)
        n_float = qs * dims / (2 * np.pi)
        n_int = np.rint(n_float)
        on_grid = (
            np.isclose(n_float, n_int, atol=1e-8).all(axis=1)
            & (n_int >= 0).all(axis=1)
        )
        idx_grid = np.nonzero(on_grid)[0]
        idx_rest = np.nonzero(~on_grid)[0]
        # Below 64 lattice points the factorized tables cost more than
        # they save: everything runs direct.
        if len(idx_grid) < 64 or len(idx_rest) == 0:
            if self._method == "factor":
                raise full_set_error
            return None
        order = np.concatenate((idx_grid, idx_rest))
        self._factor_split = {
            "qs_rest": qs[idx_rest],
            "inv_perm": np.argsort(order),
        }
        return factor_plan(qs[idx_grid], dims)

    def _mesh_setup(self):
        """``(plan, flat_idx, n_points)``: every wavevector mapped to its
        integer grid coordinates n = q L / (2 pi) in the construction
        box, the index of each in the C-ordered ``(n_points,) * 3`` mesh
        sums, and the gridding plan (the JAX package's
        ``_mesh_setup``)."""

        if self._dimensions is None:
            raise ValueError("method='mesh' requires box dimensions.")
        dims = np.asarray(self._dimensions, np.float64)
        n_float = self._wavevectors * dims / (2 * np.pi)
        n_int = np.rint(n_float).astype(int)
        if not np.allclose(n_float, n_int, atol=1e-8):
            raise ValueError(
                "method='mesh' requires grid wavevectors q = 2*pi*n/L "
                "(no spherical surfaces or custom wavevectors)."
            )
        if n_int.min() < 0:
            raise ValueError(
                "method='mesh' requires non-negative grid indices."
            )
        n_points = int(n_int.max()) + 1
        flat_idx = (n_int[:, 0] * n_points * n_points
                    + n_int[:, 1] * n_points + n_int[:, 2])
        return mesh_plan(n_points, dims), flat_idx, n_points

    def _mesh_sums_fn(self):
        """The mesh route of :meth:`_group_sums_fn`: every frame of a batch
        gridded at once (``precision`` and ``workspace`` do not apply)."""

        plan, flat_idx, n_points = self._mesh_setup()
        flat = torch.as_tensor(flat_idx, device=self._device)
        options = {key: plan[key] for key in
                   ("mesh", "width", "beta", "box", "deconv")}

        def sums(pos, precision=None, workspace=None):
            del precision, workspace
            cos, sin = mesh_trig_sums(pos, n_points=n_points, **options)
            return (cos.reshape(len(pos), -1)[:, flat],
                    sin.reshape(len(pos), -1)[:, flat])

        return sums

    def _group_sums_fn(self, wavevectors=None):
        """``sums(positions, precision=None, workspace=None) -> (cos,
        sin)``: one group's float32 ``(B, N_q)`` trig sums of any ``(B,
        n, 3)`` batch (a chunk's frames, or a frame's displacements over
        its lags), in `precision` (default: the analysis's).  `workspace`
        (:func:`~mdhelper_tpu_torch.ops.cuda_kernels.trig_workspace`)
        holds the partial sums of the direct launches.  `wavevectors`
        (direct sums only: a rank's q tile) replaces the analysis's."""

        if self._method == "mesh":
            return self._mesh_sums_fn()
        device = self._device
        default = self._precision
        plan = self._factor
        if plan is None:
            qs = torch.as_tensor(
                self._wavevectors if wavevectors is None else wavevectors,
                device=device)

            def direct(pos, precision=None, workspace=None):
                return trig_sums(qs, pos, precision=precision or default,
                                 workspace=workspace)

            return direct
        flat = torch.as_tensor(plan["flat_idx"], device=device)
        split = self._factor_split
        if split is not None:
            qs_rest = torch.as_tensor(split["qs_rest"], device=device)
            inv_perm = torch.as_tensor(split["inv_perm"], device=device)

        def sums(pos, precision=None, workspace=None):
            precision = precision or default
            frames = [
                factor_trig_sums(p, k=plan["k"], box=plan["box"],
                                 precision=precision)
                for p in pos
            ]
            c = torch.stack([f[0][flat] for f in frames])
            s = torch.stack([f[1][flat] for f in frames])
            if split is None:
                return c, s
            # The off-grid extras pay the direct sums (all frames in one
            # launch); the permutation restores the caller's order.
            cr, sr = trig_sums(qs_rest, pos, precision=precision,
                               workspace=workspace)
            return (torch.cat((c, cr), dim=1)[:, inv_perm],
                    torch.cat((s, sr), dim=1)[:, inv_perm])

        return sums

    def _prepare(self) -> None:
        self.results.pairs = (
            tuple(combinations_with_replacement(range(self._n_groups), 2))
            if self._mode == "partial"
            else ((0, self._n_groups - 1),)
            if self._mode == "pair"
            else ((None, None),)
        )
        if self._unique:
            self.results.wavenumbers, self._q_group = (
                unique_wavenumber_groups(self._wavenumbers)
            )
        else:
            self.results.wavenumbers = self._wavenumbers
        self.results.units = {"results.wavenumbers": ureg.angstrom**-1}
        self._factor = self._factor_setup()
        if self._method == "mesh" and (self._n_groups != 1
                                       or self._mode is not None):
            raise ValueError(
                "method='mesh' currently supports a single group with "
                "mode=None."
            )
        wavevectors = self._wavevectors
        if self._shard == "q":
            # This rank's contiguous tile of the wavevectors (none for a
            # rank without a shard); _reduce_rank_carry gathers them.
            mesh = self._mesh
            tiles = np.array_split(np.arange(len(wavevectors)), mesh.size)
            tile = (tiles[mesh.index] if mesh.index is not None
                    else np.arange(0))
            self._q_tile = tile
            wavevectors = wavevectors[tile]
        self._carry = {
            "ssf": torch.zeros(
                (len(self.results.pairs), len(wavevectors)),
                dtype=torch.float64, device=self._device,
            )
        }
        group_sums = self._group_sums_fn(wavevectors)
        n_q = len(wavevectors)
        entities = _entity_positions_fn(self._groups, self._groupings,
                                        self._device)
        slices = self._entity_slices
        pairs = self.results.pairs
        mode = self._mode

        def update(carry, positions, dimensions, mask):
            del dimensions
            if not n_q:
                return carry
            positions = entities(positions)
            sums = [group_sums(positions[:, lo:lo + n]) for lo, n in slices]
            cos = torch.stack([c for c, _ in sums], dim=1)  # (B, G, N_q)
            sin = torch.stack([s for _, s in sums], dim=1)
            if mode is None:
                total_c = cos.sum(dim=1)
                total_s = sin.sum(dim=1)
                frame_ssf = (total_c**2 + total_s**2)[:, None, :]
            else:
                rows = []
                for j, k in pairs:
                    if j == k:
                        rows.append(cos[:, j] ** 2 + sin[:, j] ** 2)
                    else:
                        rows.append(
                            2 * (cos[:, j] * cos[:, k]
                                 + sin[:, j] * sin[:, k])
                        )
                frame_ssf = torch.stack(rows, dim=1)  # (B, P, N_q)
            return {
                "ssf": carry["ssf"] + (
                    frame_ssf.to(torch.float64) * mask[:, None, None]
                ).sum(dim=0)
            }

        self._update = update

    def _n_shards(self) -> int:
        if self._shard == "q":
            from ..parallel.mesh import get_mesh

            return max(1, min(get_mesh().world, len(self._wavevectors)))
        return super()._n_shards()

    def _reduce_rank_carry(self, carry):
        """Over ranks: a q-sharded run's carry stays this rank's q tile
        (every rank summed every frame itself; :meth:`_conclude` gathers
        the tiles), else the frame sums are summed (the base's)."""

        if self._shard == "q":
            return carry
        return super()._reduce_rank_carry(carry)

    def _rank_checkpoint_carry(self, carry):
        """A q-sharded run's checkpoint holds every rank's q tile, in
        order (the whole job's sums), else the base's."""

        if self._shard == "q":
            from ..parallel.mesh import all_gather_tiles

            return {"ssf": all_gather_tiles(carry["ssf"], axis=1)}
        return super()._rank_checkpoint_carry(carry)

    def _rank_resumed_carry(self, carry, rank: int):
        """A q-sharded run resumes each rank's own q tile of the whole
        job's sums, else the base's share."""

        if self._shard == "q":
            tile = torch.as_tensor(self._q_tile, device=carry["ssf"].device)
            return {"ssf": carry["ssf"][:, tile]}
        return super()._rank_resumed_carry(carry, rank)

    def _conclude(self) -> None:
        # The JAX package's fetch_global: a q-sharded run's tiles in order.
        ssf = fetch_global(self._carry["ssf"],
                           self._mesh if self._shard == "q" else None,
                           axis=1) / (self.n_frames * self._N)
        if self._unique:
            ssf = group_mean_last_axis(
                ssf, self._q_group, len(self.results.wavenumbers)
            )
        if self._sort:
            order = np.argsort(self.results.wavenumbers)
            self.results.wavenumbers = self.results.wavenumbers[order]
            ssf = ssf[:, order]
        self.results.ssf = ssf

    def calculate_weighted_sum(self, weights, *,
                               normalization: str = "b2") -> np.ndarray:
        r"""The partial rows recombined into a scattering-weighted total,

        .. math::

           S_w(q) = \frac{1}{\mathcal{N}} \sum_{\alpha\beta}
           b_\alpha b_\beta\,\mathrm{Re}\,\langle
           \rho_\alpha(\mathbf{q})\rho_\beta^*(\mathbf{q})\rangle / N

        (e.g. the neutron-weighted total with coherent scattering
        lengths).  With unit weights and ``normalization="none"`` it is the
        row sum of ``results.ssf``.

        Parameters
        ----------
        weights : array-like
            Per-group weights :math:`b_\alpha`, ``(n_groups,)``, or
            ``(n_groups, n_wavenumbers)`` for q-dependent form factors on
            ``results.wavenumbers``.
        normalization : `str`, keyword-only, default ``"b2"``
            :math:`\mathcal{N}`: ``"b2"`` (:math:`\sum_\alpha x_\alpha
            b_\alpha^2`, with :math:`x_\alpha` the entity fractions),
            ``"b_mean_sq"`` (:math:`(\sum_\alpha x_\alpha b_\alpha)^2`)
            or ``"none"`` (1).

        Returns
        -------
        weighted : `numpy.ndarray`
            The weighted total, also ``results.weighted_ssf``.
        """

        self.results.weighted_ssf = self._recombine_partials(
            weights, normalization
        )
        return self.results.weighted_ssf

    def _recombine_partials(self, weights, normalization: str) -> np.ndarray:
        """The weighted recombination of the partial rows, without
        touching ``results``."""

        if self._mode != "partial":
            raise ValueError(
                "Weighted recombination needs mode='partial' (every "
                "pair row must be available)."
            )
        weights = np.asarray(strip_unit(weights, None)[0], dtype=np.float64)
        n_q = self.results.ssf.shape[1]
        if weights.shape not in ((self._n_groups,), (self._n_groups, n_q)):
            raise ValueError(
                "weights must have shape (n_groups,) or "
                "(n_groups, n_wavenumbers) -- the latter for "
                "q-dependent X-ray form factors f(q)."
            )
        if weights.ndim == 1:
            weights = np.broadcast_to(
                weights[:, None], (self._n_groups, n_q)
            )
        rows = np.zeros(n_q)
        for row, (j, k) in zip(self.results.ssf, self.results.pairs):
            rows = rows + weights[j] * weights[k] * row
        # Entity counts: residues scatter as their centers.
        fractions = self._Ns / self._Ns.sum()
        if normalization == "b2":
            norm = (fractions[:, None] * weights**2).sum(axis=0)
        elif normalization == "b_mean_sq":
            norm = (fractions[:, None] * weights).sum(axis=0) ** 2
        elif normalization == "none":
            norm = 1.0
        else:
            raise ValueError(
                "Invalid normalization. Valid values: 'b2', "
                "'b_mean_sq', 'none'."
            )
        return rows / norm

    def calculate_charge_structure_factor(self, charges=None) -> np.ndarray:
        r"""Charge-charge structure factor of the partial rows,

        .. math::

           S_{ZZ}(q) = \frac{1}{N} \left\langle \left|
           \sum_i z_i e^{i\mathbf{q}\cdot\mathbf{r}_i}
           \right|^2 \right\rangle,

        which perfect screening drives to 0 as :math:`q \to 0`
        (:meth:`calculate_screening_length`).

        Parameters
        ----------
        charges : array-like, optional
            Per-group entity charges :math:`z_\alpha` (e).  `None` takes
            each group's uniform entity charge from the topology (atom
            charges, or residue totals); a group whose entities differ
            raises.

        Returns
        -------
        charge_ssf : `numpy.ndarray`
            :math:`S_{ZZ}(q)`, also ``results.charge_ssf``.
        """

        if self._mode != "partial":
            raise ValueError(
                "The charge structure factor needs mode='partial' "
                "(every pair row must be available)."
            )
        z = _resolve_group_charges(
            self._groups, self._groupings, charges, False,
            what="charge structure factor",
        )
        if z is None:
            raise ValueError(
                "A group has non-uniform entity charges; pass "
                "charges=[z_1, ...] explicitly."
            )
        self.results.charge_ssf = self._recombine_partials(z, "none")
        return self.results.charge_ssf

    def calculate_screening_length(self, *, q_max=None,
                                   charges=None) -> float:
        r"""Charge screening length from the low-:math:`q` charge
        structure factor: a least-squares fit of

        .. math::

           S_{ZZ}(q) = \frac{A\,q^2}{q^2 + \kappa^2},
           \qquad \lambda_\mathrm{s} = 1/\kappa

        (the Debye-Hueckel form) over ``0 < q <= q_max``.

        Parameters
        ----------
        q_max : `float` or `Quantity`, keyword-only, optional
            Upper edge of the fit window (1/A; default: the tenth smallest
            positive wavenumber).
        charges : array-like, keyword-only, optional
            For :meth:`calculate_charge_structure_factor`, when
            ``results.charge_ssf`` is absent.

        Returns
        -------
        screening_length : `float`
            :math:`\lambda_\mathrm{s}` (A), also
            ``results.screening_length``, with ``results.charge_ssf_fit``
            ``(A, kappa)``, ``results.charge_ssf_fit_q`` and
            ``results.charge_ssf_fit_curve``.
        """

        from scipy import optimize

        if getattr(self.results, "charge_ssf", None) is None:
            self.calculate_charge_structure_factor(charges)
        if q_max is not None and not isinstance(q_max, Real):
            q_max = strip_unit(q_max, "1/angstrom")[0]
        q = np.asarray(self.results.wavenumbers, dtype=np.float64)
        s = np.asarray(self.results.charge_ssf, dtype=np.float64)
        if q_max is None:
            positive = np.sort(q[q > 0])
            if len(positive) == 0:
                raise ValueError("No positive wavenumbers.")
            q_max = float(positive[min(9, len(positive) - 1)])
        window = (q > 0) & (q <= q_max)
        if window.sum() < 3:
            raise ValueError(
                "Fewer than 3 wavenumbers below q_max; increase "
                "q_max, use a larger box, or a denser wavevector "
                "grid."
            )
        qf, sf = q[window], s[window]
        a0 = max(float(sf[-1]), 1e-6)
        (a, kappa), _ = optimize.curve_fit(
            lambda x, a, k: a * x * x / (x * x + k * k),
            qf,
            sf,
            p0=(a0, max(float(qf[0]), 1e-3)),
            bounds=(0, np.inf),
            maxfev=10000,
        )
        if kappa <= 1e-3 * float(qf[0]):
            # An inverse length far below the smallest resolvable
            # wavenumber is indistinguishable from no suppression.
            raise ValueError(
                "The fit resolved no q^2 suppression in the window "
                "(kappa -> 0): S_ZZ is flat there -- either the "
                "window sits past the low-q regime (decrease "
                "q_max) or the system shows no charge screening "
                "over the accessible wavenumbers."
            )
        self.results.charge_ssf_fit = np.array([a, kappa])
        self.results.charge_ssf_fit_q = qf
        self.results.charge_ssf_fit_curve = (
            a * qf * qf / (qf * qf + kappa * kappa)
        )
        self.results.screening_length = float(1.0 / kappa)
        self.results.units["results.screening_length"] = ureg.angstrom
        return self.results.screening_length


def _resolve_lag_values(spec, n_lags, n_frames):
    """Resolve a ``lags=`` specification against the ring length
    ``n_lags`` (``None`` = analyzed frame count).  Returns
    ``(lag_values, n_lags)`` with ``lag_values`` an ascending `numpy`
    array of frame offsets."""

    resolved = n_lags or n_frames
    if resolved > n_frames:
        resolved = n_frames
    if spec is None:
        lag_values = np.arange(resolved)
    elif isinstance(spec, str):
        if spec != "log":
            raise ValueError(f"Invalid lags specification: {spec!r}.")
        # Every lag through 8, then quarter-octave geometric spacing;
        # always include the longest resident lag.
        short = np.arange(min(resolved, 9))
        if resolved > 9:
            geometric = np.round(
                2.0 ** np.arange(3.0, np.log2(resolved - 1) + 0.25, 0.25)
            ).astype(np.int64)
            lag_values = np.union1d(
                np.union1d(short, geometric[geometric < resolved]),
                [resolved - 1],
            )
        else:
            lag_values = short
    else:
        lag_values = np.unique(np.asarray(spec, dtype=np.int64))
        if len(lag_values) == 0 or lag_values[0] < 0:
            raise ValueError("lags must be non-negative frame offsets.")
        if n_lags is None:
            resolved = min(int(lag_values[-1]) + 1, n_frames)
        dropped = lag_values[lag_values >= resolved]
        if len(dropped):
            raise ValueError(
                f"lags {dropped.tolist()} are not below n_lags "
                f"({resolved}; n_lags is capped at the analyzed frame "
                f"count {n_frames}) -- the ring holds lags 0..n_lags - 1 "
                "only."
            )
    return lag_values, resolved


class IntermediateScatteringFunction(StructureFactor):
    r"""Coherent :math:`F(q, t)`, partial :math:`F_{\alpha\beta}(q, t)` and
    incoherent (self) :math:`F_\mathrm{s}(q, t)` intermediate scattering
    functions, and from them the dynamic structure factor
    :math:`S(q, \omega)`.

    .. math::

       F(q, t) = \frac{1}{N}\left\langle\sum_{j,k}
       e^{i\mathbf{q}\cdot(\mathbf{r}_j(t_0 + t) - \mathbf{r}_k(t_0))}
       \right\rangle, \qquad
       F_\mathrm{s}(q, t) = \frac{1}{N}\left\langle\sum_j
       e^{i\mathbf{q}\cdot(\mathbf{r}_j(t_0 + t) - \mathbf{r}_j(t_0))}
       \right\rangle

    averaged over every window origin :math:`t_0` (lag :math:`t` over the
    :math:`N_t - t` windows that hold it).  Two estimators, as in the JAX
    package:

    * the time FFT (coherent-only runs, the default there): each frame's
      per-group sums :math:`\rho(\mathbf{q}, t)` go to a host store, and
      :meth:`_conclude` correlates them with
      :func:`~mdhelper_tpu_torch.algorithm.correlation.correlation_fft`;
    * the lag ring (``fft=False``, and every ``incoherent=True`` run): the
      last ``n_lags`` frames' sums (and, for the self part, positions) stay
      on the device, and each frame adds its products with every resident
      selected lag.  The chunk's sums are taken for all its frames in one
      call; a frame's self part takes the sums of its displacements from
      every resident lag, stacked, in one call (one trig-sums launch a frame
      on the direct route), always with float32 (``"fast"``) phases.
      Displacements are not unwrapped, as in the JAX package: for lattice
      wavevectors the phase is box-periodic anyway.

    The sums come from the routes of :class:`StructureFactor`: the
    factorized lattice sums under ``method="auto"`` for a lattice grid, the
    direct trig sums (the CUDA kernel of
    :func:`mdhelper_tpu_torch.ops.cuda_kernels.trig_sums` on a GPU) under
    ``"direct"``, both for a split set, or the mesh sums under ``"mesh"``
    (each group's sums gridded, all of a batch's frames in one call; the
    self part grids the displacements, which the fractional wrap keeps
    box-periodic).

    Parameters (beside those of :class:`StructureFactor`)
    -----------------------------------------------------
    dt : `float` or `Quantity`, optional
        Time between frames in ps (default: the trajectory's ``dt``).
    n_lags : `int`, optional
        Ring length in frames (default and cap: the analyzed frame count).
    lags : `str` or array-like, optional
        ``None`` (every lag below ``n_lags``), ``"log"`` (every lag through
        8, then quarter-octave spacing) or explicit frame offsets below
        ``n_lags`` (with no ``n_lags``, the ring holds ``max(lags) + 1``
        frames).
    incoherent : `bool`, default False
        Also compute :math:`F_\mathrm{s}(q, t)` (keeps an ``(n_lags, N,
        3)`` ring of the entities' positions, centers of mass under
        ``groupings="residues"``, on the device).
    fft : `bool`, optional
        The time-FFT estimator: ``None`` means it for coherent-only runs;
        ``True`` with ``incoherent=True`` raises.
    parallel : `bool`, default False
        Shard the frames over the ranks (the time-FFT estimator: each rank
        stores rho(q, t) of its frames, and the stores are gathered in
        frame order before the conclusion).  The lag ring is
        order-dependent (``_sequential``) and raises over more than one
        rank; over one it runs.
    shard : optional
        ``None`` only: any other value raises `ValueError`, as in the JAX
        package (the JAX class takes it through ``**kwargs``).

    Results: ``pairs``, ``times`` (ps), ``wavenumbers``, ``cisf`` of shape
    ``(N_lags, N_pairs, N_q)`` and, with ``incoherent=True``, ``iisf`` of
    shape ``(N_lags, N_groups, N_q)``; ``unique`` and ``sort`` act on the
    last axis as in :class:`StructureFactor`.
    """

    def __init__(self, groups, groupings="atoms", *, mode: str = None,
                 form: str = "exp", dimensions=None, dt=None,
                 n_points: int = 32, n_surfaces: int = None,
                 n_surface_points: int = 8, q_max=None, wavevectors=None,
                 sort: bool = True, unique: bool = True, n_lags: int = None,
                 lags=None, incoherent: bool = False, fft: bool = None,
                 parallel: bool = False, shard=None,
                 precision: str = "auto", method: str = "auto",
                 verbose: bool = True, device=None, **kwargs):
        super().__init__(
            groups, groupings, mode=mode, form=form, dimensions=dimensions,
            n_points=n_points, n_surfaces=n_surfaces,
            n_surface_points=n_surface_points, q_max=q_max,
            wavevectors=wavevectors, sort=sort, unique=unique,
            parallel=parallel, shard=shard, precision=precision,
            method=method, verbose=verbose, device=device, **kwargs,
        )
        if shard is not None:
            # The JAX message: neither frame- nor q-sharding applies.
            raise ValueError(
                "IntermediateScatteringFunction does not support "
                "shard= (the lag ring buffer is sequential)."
            )
        self._dt = strip_unit(_frame_time_step(dt, self._trajectory),
                              "picosecond")[0]
        self._n_lags = n_lags
        self._lag_spec = lags
        self._incoherent = incoherent
        if fft and incoherent:
            raise ValueError(
                "fft=True requires incoherent=False: the self part needs "
                "per-particle phases at every lag (the ring buffer bounds "
                "that memory; a time FFT would need the full (N_t, N_q, N) "
                "phase history)."
            )
        self._time_fft = not incoherent if fft is None else bool(fft)
        # The lag ring folds frames in order; the time FFT stores them.
        self._sequential = not self._time_fft
        self._rank_sharded = self._time_fft

    def _prepare(self) -> None:
        lag_values, n_lags = _resolve_lag_values(
            self._lag_spec, self._n_lags, self.n_frames
        )
        self._lag_values = lag_values
        step = _check_even_frame_spacing(self.frames)
        mode = self._mode
        self.results.pairs = (
            tuple(combinations_with_replacement(range(self._n_groups), 2))
            if mode == "partial"
            else ((0, self._n_groups - 1),)
            if mode == "pair"
            else ((None, None),)
        )
        self.results.times = step * self._dt * lag_values
        if self._unique:
            self.results.wavenumbers, self._q_group = (
                unique_wavenumber_groups(self._wavenumbers)
            )
        else:
            self.results.wavenumbers = self._wavenumbers
        self.results.units = {
            "results.times": ureg.picosecond,
            "results.wavenumbers": ureg.angstrom**-1,
        }

        device = self._device
        n_q = len(self._wavenumbers)
        n_groups = 1 if mode is None else self._n_groups
        self._factor = self._factor_setup()
        sums = self._group_sums_fn()
        frame_positions = _entity_positions_fn(
            self._groups, self._groupings, device)
        # mode=None sums every entity at once, as the JAX class does.
        slices = [(0, self._N)] if mode is None else self._entity_slices

        def group_sums(pos, precision=None, workspace=None):
            """``(B, G, N_q)`` float32 cos and sin sums of a ``(B, N, 3)``
            batch of entity positions, in one call a group."""

            parts = [sums(pos[:, lo:lo + n], precision, workspace)
                     for lo, n in slices]
            return (torch.stack([c for c, _ in parts], dim=1),
                    torch.stack([s for _, s in parts], dim=1))

        if self._time_fft:
            # rho(q, t) of every frame goes to a host store; _conclude
            # correlates it.  The carry holds nothing.
            self._rho = np.empty((self.n_frames, n_groups, n_q, 2))
            self._store_offset = 0
            self._store_chunk = self._store_rho
            self._checkpointable_stores = True
            self._checkpoint_attrs = lambda: ("_rho",)
            self._carry = {}

            def fft_update(carry, positions, dimensions, mask):
                del dimensions, mask
                cos, sin = group_sums(frame_positions(positions))
                return carry, torch.stack((cos, sin), dim=-1)

            self._update = fft_update
            return

        self._store_chunk = None
        pairs = self.results.pairs
        incoherent = self._incoherent
        n_sel = len(lag_values)

        def zeros(*shape, dtype=torch.float64):
            return torch.zeros(shape, dtype=dtype, device=device)

        # Rings in the stream's float32, accumulators in float64 (the JAX
        # carry's dtypes on a float32 stream).  The frame counter stays on
        # the host: it picks the ring slots and the lags each frame can
        # serve with no device round trip, and a carry taken over from the
        # JAX package brings its own count.
        self._carry = {
            "ring_cos": zeros(n_lags, n_groups, n_q, dtype=torch.float32),
            "ring_sin": zeros(n_lags, n_groups, n_q, dtype=torch.float32),
            "cisf": zeros(n_sel, len(pairs), n_q),
            "frame": torch.zeros((), dtype=torch.int64),
        }
        # The ring slot of each selected lag, by the current frame's slot.
        past_slots = torch.as_tensor(
            (np.arange(n_lags)[:, None] - lag_values[None, :]) % n_lags,
            device=device)
        workspace = None
        if incoherent:
            self._carry["ring_pos"] = zeros(n_lags, self._N, 3,
                                            dtype=torch.float32)
            self._carry["iisf"] = zeros(n_sel, n_groups, n_q)
            direct_qs = (0 if self._method == "mesh"
                         else n_q if self._factor is None
                         else 0 if self._factor_split is None
                         else len(self._factor_split["qs_rest"]))
            if device.type == "cuda" and direct_qs:
                # The displacement launches' partial sums, once a run.
                workspace = trig_workspace(
                    n_sel, max(n for _, n in slices), direct_qs, device)

        def fold_frame(carry, pos, cos, sin):
            """Fold one frame (its positions and ``(G, N_q)`` sums) into
            the carry, in place."""

            fi = int(carry["frame"])
            slot = fi % n_lags
            carry["ring_cos"][slot] = cos
            carry["ring_sin"][slot] = sin
            if incoherent:
                carry["ring_pos"][slot] = pos
            carry["frame"] += 1
            # lag_ok: lags longer than the frames seen so far have no
            # partner yet (the JAX class multiplies their rows by 0).  The
            # lags are ascending, so those that have one are a prefix.
            n_ok = int(np.searchsorted(lag_values, fi, side="right"))
            if not n_ok:
                return
            past = past_slots[slot, :n_ok]
            past_cos = carry["ring_cos"][past]  # (L, G, N_q)
            past_sin = carry["ring_sin"][past]
            # Products in float32, accumulated in float64, as in JAX.
            contrib = []
            for j, k in pairs:
                if j is None:
                    j = k = 0
                row = past_cos[:, j] * cos[k] + past_sin[:, j] * sin[k]
                if j != k:
                    row = (row + past_cos[:, k] * cos[j]
                           + past_sin[:, k] * sin[j])
                contrib.append(row)
            carry["cisf"][:n_ok] += torch.stack(contrib, dim=1).to(
                torch.float64)
            if incoherent:
                # Every resident lag's displacements in one call.
                delta = pos - carry["ring_pos"][past]
                self_cos, _ = group_sums(delta, "fast", workspace)
                carry["iisf"][:n_ok] += self_cos.to(torch.float64)

        def update(carry, positions, dimensions, mask):
            # The port streams no padding frames (every mask entry is 1).
            del dimensions, mask
            positions = frame_positions(positions)
            # The chunk's sums do not depend on the ring: one call.
            cos, sin = group_sums(positions)
            for pos, c, s in zip(positions, cos, sin):
                fold_frame(carry, pos, c, s)
            return carry

        self._update = update

    def _store_rho(self, rho, batch) -> None:
        n_real = batch.n_real
        self._rho[self._store_offset:self._store_offset + n_real] = (
            rho[:n_real]
        )
        self._store_offset += n_real

    def _carry_from_numpy(self, tree):
        """The carry of a JAX ``IntermediateScatteringFunction`` fetched as
        numpy (the ring route), or, on the time-FFT route, its rho store
        as ``{"rho": jax_isf._rho}``: the stored frames go ahead of this
        run's, and :meth:`_conclude` correlates them all."""

        if not self._time_fft:
            return carry_leaves(self, tree)
        if set(tree) != {"rho"}:
            raise ValueError(
                "The time-FFT route resumes from {'rho': store}, not "
                f"{sorted(tree)}."
            )
        rho = np.asarray(tree["rho"], dtype=np.float64)
        if rho.shape[1:] != self._rho.shape[1:]:
            raise ValueError(
                f"A rho store of shape {rho.shape[1:]} a frame, not "
                f"{self._rho.shape[1:]}."
            )
        self._rho = np.concatenate((rho, self._rho[self._store_offset:]))
        self._store_offset += len(rho)
        return self._carry

    def _conclude_time_fft(self) -> np.ndarray:
        """Every selected lag's coherent F(q, t) from the rho store, by the
        Fast Correlation Algorithm: the lag ring's triangular-normalized
        estimator, one FFT a (group, q)."""

        rho = torch.from_numpy(self._rho[:self._store_offset])
        z = torch.complex(rho[..., 0], rho[..., 1])  # (T, G, N_q)
        rows = []
        for j, k in self.results.pairs:
            if j is None:
                j = k = 0
            if j == k:
                corr = correlation_fft(z[:, j], axis=0)
            else:
                # The folded CCF is the ring's j <-> k product sum.
                corr = correlation_fft(z[:, j], z[:, k], axis=0, double=True)
            rows.append(corr.real.numpy()[self._lag_values])
        return np.stack(rows, axis=1) / self._N

    def _conclude(self) -> None:
        iisf = None
        if self._time_fft:
            cisf = self._conclude_time_fft()
        else:
            # Lag l averages the windows that hold it: frames folded (a
            # resumed run counts the JAX package's too) less l.
            frames = int(self._carry["frame"])
            normalization = (
                self._N * (frames - self._lag_values)[:, None, None]
            )
            cisf = self._carry["cisf"].cpu().numpy() / normalization
            if self._incoherent:
                iisf = self._carry["iisf"].cpu().numpy() / normalization
        if self._unique:
            n_unique = len(self.results.wavenumbers)
            cisf = group_mean_last_axis(cisf, self._q_group, n_unique)
            if iisf is not None:
                iisf = group_mean_last_axis(iisf, self._q_group, n_unique)
        if self._sort:
            order = np.argsort(self.results.wavenumbers)
            self.results.wavenumbers = self.results.wavenumbers[order]
            cisf = cisf[:, :, order]
            if iisf is not None:
                iisf = iisf[:, :, order]
        self.results.cisf = cisf
        if iisf is not None:
            self.results.iisf = iisf

    def calculate_dynamic_structure_factor(self, *,
                                           t_max: Union[float, Q_] = None,
                                           window: str = None) -> None:
        r"""Dynamic structure factor, the time Fourier transform of
        :math:`F(q, t)` with the even extension :math:`F(q, -t) = F(q, t)`:

        .. math::

           S(q, \omega) = \frac{1}{\pi}\int_0^\infty F(q, t)
           \cos(\omega t)\,dt,

        a trapezoid-weighted real FFT on the ``rfftfreq`` angular grid, so
        that the two-sided sum :math:`\sum_\omega S(q, \omega)
        \Delta\omega` over one period equals :math:`F(q, 0)`.  Needs a
        dense, evenly spaced lag grid (``lags=None``).

        Parameters
        ----------
        t_max : `float` or `Quantity`, keyword-only, optional
            Keep :math:`F(q, t)` up to this lag time (ps) only.
        window : `str`, keyword-only, optional
            ``None`` (plain trapezoid) or ``"hann"`` (a half-Hann taper on
            the positive lags).

        Sets ``results.angular_frequencies`` (rad/ps), ``results.dsf`` of
        shape ``(N_freq, N_pairs, N_q)`` and, after an ``incoherent=True``
        run, ``results.idsf``.
        """

        if "cisf" not in self.results:
            raise RuntimeError(
                "Call run() before calculate_dynamic_structure_factor()."
            )
        times = np.asarray(self.results.times, dtype=np.float64)
        if len(times) < 2:
            raise ValueError(
                "The dynamic structure factor needs at least two time lags."
            )
        dt_lag = np.diff(times)
        if not np.allclose(dt_lag, dt_lag[0]):
            raise ValueError(
                "calculate_dynamic_structure_factor() requires a dense, "
                "evenly spaced lag grid -- rerun with the default "
                "lags=None (a 'log' or index-subset lag grid cannot be "
                "Fourier transformed)."
            )
        dt_lag = float(dt_lag[0])
        if window not in {None, "hann"}:
            raise ValueError(
                f"Invalid window: {window!r}. Valid values: None, 'hann'."
            )

        def transform(f):
            f = np.asarray(f, dtype=np.float64)
            if t_max is not None:
                keep_t = strip_unit(t_max, "picosecond")[0]
                keep = max(2, min(len(f), int(round(keep_t / dt_lag)) + 1))
                f = f[:keep]
            n_t = f.shape[0]
            # Trapezoid end-point halving, on the optional half-Hann taper.
            weights = np.ones(n_t)
            if window == "hann":
                weights = 0.5 * (1.0 + np.cos(np.pi * np.arange(n_t)
                                              / (n_t - 1)))
            weights[0] *= 0.5
            weights[-1] *= 0.5
            spec = np.fft.rfft(weights[:, None, None] * f, axis=0).real
            return (dt_lag / np.pi) * spec, n_t

        self.results.dsf, n_t = transform(self.results.cisf)
        self.results.angular_frequencies = (
            2.0 * np.pi * np.fft.rfftfreq(n_t, dt_lag)
        )
        self.results.units["results.angular_frequencies"] = (
            ureg.picosecond**-1
        )
        self.results.units["results.dsf"] = ureg.picosecond
        if "iisf" in self.results:
            self.results.idsf, _ = transform(self.results.iisf)
            self.results.units["results.idsf"] = ureg.picosecond


class VanHoveFunction(_CellPlanned):
    r"""Van Hove space-time correlation function :math:`G(r, t)`.

    .. math::

       G(r, t) = \underbrace{\frac{1}{N}\Bigl\langle\sum_i
       \delta\bigl(r - |\mathbf{r}_i(t) - \mathbf{r}_i(0)|\bigr)
       \Bigr\rangle}_{G_\mathrm{s}(r,t)}
       + \underbrace{\frac{1}{N}\Bigl\langle\sum_{i \ne j}
       \delta\bigl(r - |\mathbf{r}_j(t) - \mathbf{r}_i(0)|\bigr)
       \Bigr\rangle}_{G_\mathrm{d}(r,t)}

    Each streamed frame is wrapped into the box (an orthorhombic one; a
    triclinic frame is kept as streamed, since the triclinic kernel
    folds fractionally and the self part searches the 27 images) and
    written to a ring of the last ``n_lags`` frames, then compared with
    the ring frame of every selected lag that has one (lags longer than
    the frames seen so far are skipped, as the JAX package masks them):
    the self part by the exact displacement histogram and the exact
    moments
    :math:`\langle r^2\rangle`, :math:`\langle r^4\rangle`; the distinct
    part by the cross cell-list kernel with exclusion ``(1, 1)``, one
    launch a frame over all of its lags.

    Results (lag rows follow ``results.times``): ``counts_self``,
    ``counts_distinct`` (ordered pairs, ``i != j``), ``gs`` (a
    probability density), ``gd`` (a time-lagged RDF), ``msd`` and the
    non-Gaussian parameter ``alpha2``.

    Parameters
    ----------
    group : `AtomGroup`
        Atoms to analyze.
    n_bins : `int`, default 201
        Number of radial bins.
    range : `tuple`, default ``(0.0, 15.0)``
        Radii range ``(r_min, r_max)``, ``0 <= r_min < r_max``.
    grouping : `str`, keyword-only, default ``"atoms"``
        ``"atoms"``, ``"residues"`` or ``"segments"``: the function of
        the residues' or segments' centers of mass (entities in ascending
        label order), taken from the streamed coordinates before they are
        wrapped.
    dt : `float` or `Quantity`, optional
        Time between frames in ps (defaults to the trajectory's ``dt``).
    n_lags : `int`, optional
        Ring length in frames (defaults to the analyzed frame count).
    lags : `str` or array-like, optional
        ``"log"`` or explicit frame offsets below ``n_lags``.
    self_part, distinct_part : `bool`, default True
        Which parts to accumulate.
    capacity_sigmas : `float`, default 4.0
        Cell-capacity headroom in Poisson sigmas (see
        :class:`RadialDistributionFunction`).
    reduced : `bool`, keyword-only, default False
        Data in reduced (LJ) units: ``results.units`` stays empty (the
        histograms themselves are unitless).
    device : optional
        Device the chunks are folded on (default: the first CUDA
        device, which must exist; ``"cpu"`` for the CPU).
    """

    #: the ring of past frames folds them in order.
    _sequential = True

    def __init__(self, group, n_bins: int = 201,
                 range: tuple = (0.0, 15.0), *, grouping: str = "atoms",
                 dt=None, n_lags: int = None, lags=None,
                 self_part: bool = True, distinct_part: bool = True,
                 capacity_sigmas: float = 4.0, reduced: bool = False,
                 verbose: bool = True, device=None, **kwargs):
        self.group = group
        self.universe = group.universe
        super().__init__(self.universe.trajectory, verbose, device=device,
                         **kwargs)
        if not (self_part or distinct_part):
            raise ValueError(
                "At least one of self_part/distinct_part is required."
            )
        self._grouping = _validate_groupings(grouping)[0]
        self._require_box("VanHoveFunction")
        self._n_bins = int(n_bins)
        self._range = _check_range(range)
        self._setup_periodic_box()
        self._self_part = bool(self_part)
        self._distinct_part = bool(distinct_part)
        self._n_lags = n_lags
        self._lag_spec = lags
        self._reduced = reduced
        self._dt = strip_unit(_frame_time_step(dt, self._trajectory),
                              "picosecond")[0]
        self._capacity_sigmas = float(capacity_sigmas)
        self._atom_indices = np.asarray(group.ix)
        _, self._n = _group_segment_ids(group, self._grouping)
        # The cross kernel over one group at two times: a joint
        # (equal-count) grid.
        self._plan_atoms = (self._n, self._n)

    def _prepare(self) -> None:
        lag_values, n_lags = _resolve_lag_values(
            self._lag_spec, self._n_lags, self.n_frames
        )
        step = _check_even_frame_spacing(self.frames)
        self.results.edges = np.linspace(*self._range, self._n_bins + 1)
        self.results.bins = (
            self.results.edges[:-1] + self.results.edges[1:]
        ) / 2
        self.results.times = step * self._dt * lag_values
        self.results.units = {}
        if not self._reduced:
            self.results.units = {
                "results.bins": ureg.angstrom,
                "results.edges": ureg.angstrom,
                "results.times": ureg.picosecond,
                "results.gs": ureg.angstrom**-3,
            }

        device = self._device
        n_sel = len(lag_values)

        def zeros(*shape, dtype=torch.float64):
            return torch.zeros(shape, dtype=dtype, device=device)

        self._carry = {
            "ring": zeros(n_lags, self._n, 3, dtype=torch.float32),
            "self": zeros(n_sel, self._n_bins),
            "distinct": zeros(n_sel, self._n_bins),
            "m2": zeros(n_sel),
            "m4": zeros(n_sel),
            "origins": zeros(n_sel),
            "volume": zeros(),
            # The frame counter stays on the host: it picks the ring
            # slots and the lags each frame can serve, with no device
            # round trip.  A carry taken over from the JAX package brings
            # its own count, so the ring resumes where it left off.
            "frame": torch.zeros((), dtype=torch.int64),
        }
        edges = self.results.edges
        self_part = self._self_part
        distinct_part = self._distinct_part
        triclinic = self._triclinic
        distinct_sweep = (
            triclinic_cross_pair_histogram if triclinic
            else cross_pair_histogram
        )
        if distinct_part:
            plan = self._searched_cell_plan()
            self._carry["max_occ"] = torch.full(
                (), _NO_EXCESS, dtype=torch.int32, device=device
            )
            cell = dict(
                r_min=self._range[0], r_max=self._range[1],
                n_cells_dim=plan["n_cells_dim"], reach=plan["reach"],
                capacity1=plan["capacity"], capacity2=plan["capacity"],
                n_bins=self._n_bins, exclusion=(1, 1),
            )

        def fold_frame(carry, pos, box, volume):
            """Fold one frame into the carry, in place (the ring alone
            is n_lags x N x 3 floats; a copy a frame would double it)."""

            if not triclinic:
                # The orthorhombic cell kernel needs wrapped coordinates.
                pos = pos - box * torch.floor(pos / box)
            fi = int(carry["frame"])
            carry["ring"][fi % n_lags] = pos
            carry["volume"] += volume
            carry["frame"] += 1
            # Lags longer than the frames seen so far have no partner yet.
            sel = np.flatnonzero(lag_values <= fi)
            if not len(sel):
                return
            past = carry["ring"][
                torch.as_tensor((fi - lag_values[sel]) % n_lags,
                                device=device)
            ]
            rows = torch.as_tensor(sel, device=device)
            carry["origins"][rows] += 1.0
            if self_part:
                # Per-atom math in float32, per-lag sums cast to float64
                # (the JAX package's order of rounding).
                dmin = _min_image_distance(pos - past, box)
                r2 = dmin * dmin
                carry["m2"].index_add_(0, rows, r2.sum(dim=1).double())
                carry["m4"].index_add_(
                    0, rows, (r2 * r2).sum(dim=1).double()
                )
                carry["self"].index_add_(
                    0, rows,
                    displacement_histogram_frame(pos, past, box, edges)
                    .double(),
                )
            if distinct_part:
                counts, occ1, occ2 = distinct_sweep(
                    past, pos.expand_as(past), box=box, **cell
                )
                carry["distinct"].index_add_(0, rows, counts)
                excess = torch.maximum(occ1, occ2).max() - cell["capacity1"]
                carry["max_occ"] = torch.maximum(
                    carry["max_occ"], excess.to(torch.int32)
                )

        com, _ = _com_reducer(self.group, self._grouping, device)

        def update(carry, positions, dimensions, mask):
            # The port streams no padding frames (every mask entry is
            # 1), and the ring makes the frames of a chunk sequential.
            del mask
            if com is not None:
                positions = com(positions)
            boxes, volumes = _frame_boxes(dimensions, triclinic)
            for pos, box, volume in zip(positions, boxes, volumes):
                fold_frame(carry, pos, box, volume)
            return carry

        self._update = update

    def _conclude(self) -> None:
        if self._distinct_part:
            self._check_cell_carry("distinct")
        carry = {
            k: self._carry[k].cpu().numpy()
            for k in ("self", "distinct", "m2", "m4", "origins", "volume",
                      "frame")
        }
        origins = carry["origins"]
        # Frames folded, counted from the carry: a run resumed from
        # another's carry averages the volume over every frame.
        volume_mean = float(carry["volume"]) / int(carry["frame"])
        shell = 4 * np.pi * np.diff(self.results.edges**3) / 3
        n = self._n
        if self._self_part:
            self.results.counts_self = carry["self"].astype(np.int64)
            self.results.gs = carry["self"] / (origins[:, None] * n * shell)
            m2 = carry["m2"] / (origins * n)
            m4 = carry["m4"] / (origins * n)
            self.results.msd = m2
            with np.errstate(divide="ignore", invalid="ignore"):
                self.results.alpha2 = 3 * m4 / (5 * m2**2) - 1
            if not self._reduced:
                self.results.units["results.msd"] = ureg.angstrom**2
        if self._distinct_part:
            self.results.counts_distinct = carry["distinct"].astype(
                np.int64
            )
            self.results.gd = carry["distinct"] * volume_mean / (
                origins[:, None] * n * (n - 1) * shell
            )
