r"""
Structural analysis
===================

Ported from :mod:`mdhelper_tpu.analysis.structure`:

* :class:`RadialDistributionFunction` for one group against itself in
  an orthorhombic 3-D box with bins from 0, through the cell-list pair
  histogram (:mod:`mdhelper_tpu_torch.ops.cuda_cell_histogram`): the
  hand-written CUDA kernel on a GPU, its plain-torch version on the
  CPU.  This cell route is the port's only RDF route.
* :class:`StructureFactor` over reciprocal-lattice wavevectors through
  the factorized trig sums (:mod:`mdhelper_tpu_torch.ops.factor_scattering`).

Cross-group, triclinic, 2-D and offset-range RDFs and the direct and
mesh S(q) methods are not ported yet.
"""

import warnings

import numpy as np
import torch

from ..ops.cuda_cell_histogram import (
    CellCapacityOverflow,
    cell_pair_histogram,
    cell_plan_search,
)
from ..ops.factor_scattering import factor_plan, factor_trig_sums
from .base import SerialAnalysisBase

__all__ = [
    "RadialDistributionFunction",
    "StructureFactor",
    "unique_wavenumber_groups",
    "group_mean_last_axis",
]

#: "no overflow" value of the occupancy-excess carry.
_NO_EXCESS = -(2**30)


class RadialDistributionFunction(SerialAnalysisBase):
    r"""Radial distribution function :math:`g(r)` of one group with
    itself.

    Parameters
    ----------
    ag1 : `AtomGroup`
        The group.
    ag2 : `AtomGroup`, optional
        Must be `ag1` (or omitted): cross-group RDFs are not ported yet.
    n_bins : `int`, default 201
        Number of bins.
    range : `tuple`, default ``(0.0, 15.0)``
        Histogram range; it must start at 0.
    norm : `str`, default ``"rdf"``
        ``"rdf"``, ``"density"`` or ``None``.
    exclusion : `tuple`, optional
        ``None`` (identical-atom pairs land in bin 0, as in the
        reference) or ``(1, 1)`` (they are dropped).
    capacity_sigmas : `float`, default 4.0
        Cell-capacity headroom in Poisson sigmas; :meth:`run` raises it
        by 2 and re-runs after a capacity overflow (twice at most).
    device : optional
        Device the chunks are folded on.
    """

    def __init__(self, ag1, ag2=None, n_bins: int = 201,
                 range: tuple = (0.0, 15.0), *, norm: str = "rdf",
                 exclusion: tuple = None, capacity_sigmas: float = 4.0,
                 verbose: bool = True, device=None):
        if ag2 is not None and ag2 != ag1:
            raise NotImplementedError(
                "Cross-group RDFs are not ported yet."
            )
        self.ag1 = self.ag2 = ag1
        self.universe = ag1.universe
        super().__init__(self.universe.trajectory, verbose, device=device)
        self._require_box("RadialDistributionFunction")
        self._require_orthorhombic("RadialDistributionFunction")
        if range[0] != 0:
            raise NotImplementedError(
                "RDF ranges starting above 0 are not ported yet."
            )
        if exclusion is not None and tuple(exclusion) != (1, 1):
            raise NotImplementedError(
                "Tile exclusions other than (1, 1) are not ported yet."
            )
        self._n_bins = n_bins
        self._range = tuple(range)
        self._norm = norm
        self._exclusion = None if exclusion is None else (1, 1)
        self._capacity_sigmas = float(capacity_sigmas)
        self._atom_indices = np.asarray(ag1.ix)
        self._n1 = self._n2 = ag1.n_atoms
        self._cell_plan_cache = None

    def _searched_cell_plan(self):
        if self._cell_plan_cache is None:
            self._cell_plan_cache = cell_plan_search(
                self._n1,
                np.asarray(self.universe.dimensions[:3], np.float64),
                float(self._range[1]),
                capacity_sigmas=self._capacity_sigmas,
            )
        return self._cell_plan_cache

    def _prepare(self) -> None:
        self.results.edges = np.linspace(*self._range, self._n_bins + 1)
        self.results.bins = (
            self.results.edges[:-1] + self.results.edges[1:]
        ) / 2
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
        plan = self._searched_cell_plan()
        r_max = float(self._range[1])
        n_bins = self._n_bins
        # exclusion=None (the reference default): the kernel drops
        # identical-atom pairs, whose distance is exactly 0, so they are
        # added back into bin 0.
        self_pairs = self._n1 if self._exclusion is None else 0

        def update(carry, positions, dimensions, mask):
            box = dimensions[:, :3].to(torch.float32)
            counts, occ = cell_pair_histogram(
                positions, box=box, r_max=r_max,
                n_cells_dim=plan["n_cells_dim"],
                capacity=plan["capacity"], n_bins=n_bins,
            )
            if self_pairs:
                counts[:, 0] += self_pairs
            valid = mask > 0
            # `occ` becomes the occupancy excess over capacity (> 0 is
            # an overflow).
            excess = torch.where(
                valid, occ - plan["capacity"], _NO_EXCESS
            ).max().to(torch.int32)
            # where, not a product: a NaN-poisoned padding frame times 0
            # would still be NaN.
            counts = torch.where(valid[:, None], counts, 0.0)
            volume = (dimensions[:, :3].prod(dim=1) * mask).sum()
            return {
                "counts": carry["counts"] + counts.sum(dim=0),
                "volume": carry["volume"] + volume,
                "max_occ": torch.maximum(carry["max_occ"], excess),
            }

        self._update = update

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

    def _check_pallas_carry(self) -> None:
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
        if torch.isnan(self._carry["counts"]).any():
            raise RuntimeError(
                "A frame's box shrank below the planned cell grid (box "
                "/ n_cells_dim under r_max on some axis); the neighbor "
                "sweep would miss pairs. Re-plan against the smallest "
                "box along the trajectory."
            )

    def _conclude(self) -> None:
        self._check_pallas_carry()
        self.results.counts = (
            self._carry["counts"].cpu().numpy().astype(np.int64)
        )
        self._area_or_volume = float(self._carry["volume"])
        norm = self.n_frames
        if self._norm is not None:
            norm = norm * (4 * np.pi * np.diff(self.results.edges**3) / 3)
            if self._norm == "rdf":
                n2 = self._n2
                if self._exclusion:
                    n2 -= self._exclusion[1]
                norm = norm * (
                    self._n1 * n2 * self.n_frames / self._area_or_volume
                )
        self.results.rdf = self.results.counts / norm


def _wavevector_grid(dimensions, n_points: int) -> np.ndarray:
    r"""Wavevector grid :math:`2\pi\mathbf{n}/L` in the reference's
    meshgrid order (spherical-surface extras are not ported)."""

    dimensions = np.asarray(dimensions, dtype=float)
    if np.allclose(dimensions, dimensions[0]):
        grid = 2 * np.pi * np.arange(n_points) / dimensions[0]
        axes = (grid, grid, grid)
    else:
        axes = [2 * np.pi * np.arange(n_points) / L for L in dimensions]
    return np.stack(np.meshgrid(*axes), axis=-1).reshape(-1, 3)


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


class StructureFactor(SerialAnalysisBase):
    r"""Static structure factor

    .. math::

       S(q) = \frac{1}{N}\left\langle\left(\sum_j
       \cos(\mathbf{q}\cdot\mathbf{r}_j)\right)^2 + \left(\sum_j
       \sin(\mathbf{q}\cdot\mathbf{r}_j)\right)^2\right\rangle

    over reciprocal-lattice wavevectors, by the factorized trig sums
    (``method="factor"``, the only method ported).

    Parameters
    ----------
    groups : `AtomGroup` or sequence of them
        Groups that jointly contain every atom of the universe
        (``mode=None``, the total S(q); partial modes are not ported).
    n_points : `int`, default 32
        Wavevector grid points per axis.
    dimensions : array-like, optional
        Box lengths (default: the trajectory's first frame).
    q_max : `float`, optional
        Wavenumber cutoff.
    wavevectors : `numpy.ndarray`, optional
        Explicit lattice wavevectors (overrides the grid).
    sort, unique : `bool`, default True
        Sort by wavenumber / average equal-magnitude wavevectors.
    precision : `str`, default ``"auto"``
        ``"exact"`` (double-float phase tables; what ``"auto"`` means
        for the port's float32 streams) or ``"fast"``.
    method : `str`, default ``"factor"``
        Only ``"factor"``.
    """

    def __init__(self, groups, groupings="atoms", *, mode: str = None,
                 dimensions=None, n_points: int = 32, q_max=None,
                 wavevectors=None, sort: bool = True, unique: bool = True,
                 precision: str = "auto", method: str = "factor",
                 verbose: bool = True, device=None):
        self._groups = (
            [groups] if hasattr(groups, "universe") else list(groups)
        )
        self.universe = self._groups[0].universe
        super().__init__(self.universe.trajectory, verbose, device=device)
        if groupings != "atoms" and set(groupings) != {"atoms"}:
            raise NotImplementedError("Only groupings='atoms' is ported.")
        if mode is not None:
            raise NotImplementedError("Only mode=None is ported.")
        if method != "factor":
            raise NotImplementedError("Only method='factor' is ported.")
        if precision not in {"auto", "fast", "exact"}:
            raise ValueError(
                "Invalid precision. Valid values: 'auto', 'fast', 'exact'."
            )
        self._precision = "exact" if precision == "auto" else precision
        if sum(g.n_atoms for g in self._groups) != (
            self.universe.atoms.n_atoms
        ):
            raise ValueError(
                "The provided atom groups do not contain all atoms in "
                "the universe."
            )
        if dimensions is not None:
            if len(dimensions) != 3:
                raise ValueError("'dimensions' must have length 3.")
            self._dimensions = np.asarray(dimensions, dtype=float)
        else:
            self._require_box("StructureFactor")
            self._dimensions = np.asarray(
                self.universe.dimensions[:3], dtype=float
            ).copy()
        if wavevectors is not None:
            self._wavevectors = np.asarray(wavevectors, dtype=float)
        else:
            self._wavevectors = _wavevector_grid(self._dimensions, n_points)
        self._wavenumbers = np.linalg.norm(self._wavevectors, axis=1)
        if q_max is not None:
            keep = self._wavenumbers <= q_max
            self._wavevectors = self._wavevectors[keep]
            self._wavenumbers = self._wavenumbers[keep]
        self._atom_indices = np.concatenate([g.ix for g in self._groups])
        self._N = int(self._atom_indices.size)
        self._sort = sort
        self._unique = unique

    def _prepare(self) -> None:
        self.results.pairs = ((None, None),)
        if self._unique:
            self.results.wavenumbers, self._q_group = (
                unique_wavenumber_groups(self._wavenumbers)
            )
        else:
            self.results.wavenumbers = self._wavenumbers
        device = self._device
        plan = factor_plan(self._wavevectors, self._dimensions)
        flat = torch.as_tensor(plan["flat_idx"], device=device)
        self._carry = {
            "ssf": torch.zeros(
                (1, len(self._wavenumbers)), dtype=torch.float64,
                device=device,
            )
        }
        # The groups jointly hold every atom, so the total sums run over
        # all streamed columns at once.
        precision = self._precision

        def update(carry, positions, dimensions, mask):
            del dimensions
            frames = []
            for p in positions:
                c, s = factor_trig_sums(
                    p, k=plan["k"], box=plan["box"], precision=precision
                )
                c, s = c[flat], s[flat]
                frames.append(c * c + s * s)
            frame_ssf = torch.stack(frames)[:, None, :].to(torch.float64)
            return {
                "ssf": carry["ssf"]
                + (frame_ssf * mask[:, None, None]).sum(dim=0)
            }

        self._update = update

    def _conclude(self) -> None:
        ssf = self._carry["ssf"].cpu().numpy() / (self.n_frames * self._N)
        if self._unique:
            ssf = group_mean_last_axis(
                ssf, self._q_group, len(self.results.wavenumbers)
            )
        if self._sort:
            order = np.argsort(self.results.wavenumbers)
            self.results.wavenumbers = self.results.wavenumbers[order]
            ssf = ssf[:, order]
        self.results.ssf = ssf
