r"""
Solvent-accessible surface area
===============================

Shrake-Rupley solvent-accessible surface area (SASA), ported from
:mod:`mdhelper_tpu.analysis.sasa`: each atom's van der Waals sphere is
inflated by the probe radius and sampled with a golden-spiral point set;
a point is accessible iff it lies outside every other inflated sphere,
and an atom's area is the accessible fraction of its inflated sphere
(Shrake & Rupley 1973).

A frame is swept in row blocks of atoms
(:func:`~mdhelper_tpu_torch.ops.histogram._row_blocks`, sized for the
``(rows, n_points, K, 3)`` occlusion block): a dense minimum-image
candidate test ``|r_ij|^2 < (R_i + R_j)^2`` against every atom, a
``torch.topk`` compaction to the ``K`` nearest candidates (the static
budget ``max_occluders``), and the ``(rows, n_points, K)`` point test
``|R_i s_p - r_ij|^2 < R_j^2``.  Candidate positions are taken relative
to the central atom from the minimum-imaged pair vectors, which holds
while the occluders' reach stays under half the box (a warning says when
it does not).  The float32 point test is formed as XLA's CPU backend
forms the JAX package's (a fused multiply-add for ``R_i s_p - r_ij`` and
the fused squared norm of
:func:`~mdhelper_tpu_torch.ops.histogram._norm2`, :func:`_point_distances2`),
so free-point counts equal the JAX class's (areas within two float32
roundings: XLA associates the area's product as its constants allow).  An atom with more
candidates than ``K`` raises :class:`OccluderOverflow`, and :meth:`run`
doubles the budget, at most twice.  The JAX package's host KD-tree
pipeline and watchdog chunk cap are not ported.
"""

import warnings
from numbers import Real

import numpy as np
import torch

from .. import ureg
from ..algorithm.topology import resolve_vdw_radii, triclinic_matrices
from ..algorithm.unit import strip_unit
from ..ops.cuda_cell_histogram import triclinic_perpendicular_widths
from ..ops.histogram import _min_image_vectors, _norm2, _row_blocks
from .base import DynamicAnalysisBase
from .structure import _frame_boxes

__all__ = [
    "OccluderOverflow",
    "SolventAccessibleSurfaceArea",
    "sphere_points",
]


class OccluderOverflow(ValueError):
    """An atom had more occlusion candidates than the static
    ``max_occluders`` budget (dense local packing); re-run with a larger
    budget.  :meth:`SolventAccessibleSurfaceArea.run` escalates twice
    before propagating."""


def sphere_points(n: int) -> np.ndarray:
    r"""Deterministic unit-sphere quadrature points (golden-spiral /
    Fibonacci lattice): ``n`` points with near-uniform area weights, the
    standard Shrake-Rupley test-point set.

    Returns
    -------
    points : `numpy.ndarray`
        Unit vectors, shape ``(n, 3)``.
    """

    if n < 1:
        raise ValueError("'n' must be positive.")
    k = np.arange(n, dtype=np.float64) + 0.5
    z = 1.0 - 2.0 * k / n
    phi = k * (np.pi * (3.0 - np.sqrt(5.0)))
    rho = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([rho * np.cos(phi), rho * np.sin(phi), z], axis=1)


def _point_distances2(r_i, sphere, rel):
    """``(rows, M, K)`` float32 ``|R_i s_p - r_ij|^2`` of radii `r_i`
    ``(rows,)``, unit points `sphere` ``(M, 3)`` and candidate vectors
    `rel` ``(rows, K, 3)``, as XLA's CPU backend forms the JAX class's: the
    difference fused with its product, ``fma(R_i, s, -r)``, and the fused
    squared norm ``fma(z, z, fma(y, y, x * x))``.  Bit for bit
    ``_norm2(fma32(R_i, s_p, -r_ij))``: each fused step is computed in
    float64, where its product is exact, and rounded once to the float32
    tensor it is stored in, so no float64 tensor of the block's size but
    one accumulator is written."""

    f64 = torch.float64
    rows, n_points, k = len(r_i), len(sphere), rel.shape[1]
    product = r_i.to(f64)[:, None, None, None] * sphere.to(f64)[None, :,
                                                                 None, :]
    dd = rel.new_empty((rows, n_points, k, 3))
    torch.sub(product, rel[:, None, :, :], out=dd)
    x, y, z = dd.unbind(dim=-1)
    acc = torch.empty((rows, n_points, k), dtype=f64, device=rel.device)
    torch.mul(x, x, out=acc)            # float32 x x, held in float64
    out = rel.new_empty((rows, n_points, k))
    torch.addcmul(acc, y, y, out=out)   # fl32(y y + x x)
    acc.copy_(out)
    return torch.addcmul(acc, z, z, out=out)


class SolventAccessibleSurfaceArea(DynamicAnalysisBase):
    r"""Shrake-Rupley solvent-accessible surface area.

    Each atom :math:`i` takes the inflated radius :math:`R_i =
    r_i^\mathrm{vdW} + r_\mathrm{probe}`; ``n_points`` golden-spiral test
    points lie on that sphere, a point is accessible iff it lies outside
    every other inflated sphere, and

    .. math::

       A_i = 4 \pi R_i^2 \,
       \frac{n_\mathrm{accessible}(i)}{n_\mathrm{points}}.

    Parameters
    ----------
    group : `AtomGroup`
        Atoms to compute surface areas for; they occlude each other, and
        atoms outside the group are ignored.
    probe_radius : `float` or unit-bearing quantity, default :code:`1.4`
        Solvent probe radius (Angstrom).
    n_points : `int`, default :code:`960`
        Test points per atom.
    radii : `dict`, array-like, or `None`, keyword-only
        Van der Waals radii (Angstrom).  `None` resolves the group's atom
        names against the Bondi table
        (:data:`mdhelper_tpu_torch.algorithm.topology.VDW_RADII`; the
        atom types when every name is the placeholder ``"X"``); a `dict`
        overrides or extends that table (UPPERCASE symbols); an array
        gives per-atom radii.
    max_occluders : `int`, keyword-only, optional
        Static per-atom occlusion-candidate budget ``K`` (default 128;
        liquid-density systems need about 50).  A run that exceeds it
        raises :class:`OccluderOverflow`, and :meth:`run` doubles it, at
        most twice.
    reduced : `bool`, keyword-only, default :code:`False`
        Reduced (LJ) units: `probe_radius` and `radii` are dimensionless
        and ``results.units`` is omitted.
    parallel : `bool`, keyword-only, default :code:`False`
        Shard the frames over the ranks of :mod:`torch.distributed` (a
        world of one without a process group): the areas, totals and
        candidate counts of each rank's real frames are gathered in
        frame order.  The occluder budget is checked over every rank (the
        most candidates of any frame, a max over the ranks) before the
        gather and each checkpoint save, so every rank escalates
        together.
    device : `torch.device` or `str`, keyword-only, optional
        Where the frames are swept (default: the first CUDA device);
        ``"cpu"`` for the CPU.

    Results
    -------
    ``results.areas``
        Per-atom SASA (Angstrom^2), shape ``(n_frames, N)``.
    ``results.total_areas``
        Group totals (Angstrom^2), shape ``(n_frames,)``.
    ``results.n_neighbors``
        Per-atom occlusion-candidate counts, ``(n_frames, N)``.
    ``results.times``
        Frame times (ps).

    Notes
    -----
    Orthorhombic and triclinic cells use minimum-image occlusion;
    zero-length boxes are aperiodic.  Occluder reach (:math:`R_i + R_j`)
    must stay below half the box.
    """

    _checkpointable_stores = True
    _rank_sharded = True

    def _result_stores(self) -> dict:
        return {"areas": 0, "total_areas": 0, "n_neighbors": 0}

    def __init__(
        self,
        group,
        probe_radius=1.4,
        n_points: int = 960,
        *,
        radii=None,
        max_occluders: int = None,
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
        if not isinstance(probe_radius, Real):
            probe_radius = strip_unit(probe_radius, "angstrom")[0]
        if probe_radius < 0:
            raise ValueError("'probe_radius' must be non-negative.")
        if int(n_points) < 1:
            raise ValueError("'n_points' must be positive.")
        n = group.n_atoms
        if n < 1:
            raise ValueError("'group' must contain at least 1 atom.")
        if radii is None or isinstance(radii, dict):
            labels = group.names
            if all(str(label) == "X" for label in labels):
                # placeholder names (array-built universes): the types
                labels = group.types
            vdw = resolve_vdw_radii(labels, vdwradii=radii)
        else:
            vdw = np.asarray(radii, dtype=np.float64).reshape(-1)
            if len(vdw) != n:
                raise ValueError(
                    f"'radii' has {len(vdw)} entries for {n} atoms."
                )
        if (vdw <= 0).any():
            raise ValueError("van der Waals radii must be positive.")
        self._n_points = int(n_points)
        self._probe = float(probe_radius)
        self._inflated = vdw + self._probe
        if max_occluders is not None and int(max_occluders) < 1:
            raise ValueError("'max_occluders' must be positive.")
        self._max_occluders = (
            None if max_occluders is None else int(max_occluders)
        )
        self._reduced = reduced
        self._atom_indices = group.ix
        self._setup_periodic_box()
        self._sphere = sphere_points(self._n_points)

    def _budget(self, n: int) -> int:
        if self._max_occluders is not None:
            return min(self._max_occluders, max(1, n - 1))
        return min(128, max(1, n - 1))

    def _prepare(self) -> None:
        n = len(self._atom_indices)
        self.results.areas = np.empty((self.n_frames, n))
        self.results.total_areas = np.empty(self.n_frames)
        self.results.n_neighbors = np.empty((self.n_frames, n),
                                            dtype=np.int64)
        self.results.times = self.frames * self._trajectory.dt
        if not self._reduced:
            self.results.units = {
                "results.areas": ureg.angstrom**2,
                "results.total_areas": ureg.angstrom**2,
                "results.times": ureg.picosecond,
            }
        self._store_offset = 0
        self._most_candidates = 0
        self._reach_warned = False
        self._carry = torch.zeros((), device=self._device)
        self._make_update()

    def _make_update(self) -> None:
        device = self._device
        n = len(self._atom_indices)
        k = self._budget(n)
        # The budget this update truncates to: the overflow check compares
        # against it, so an escalated retry never accepts a chunk that an
        # earlier, smaller budget computed.
        self._active_budget = k
        blocks = _row_blocks(n, max(n, self._n_points * k), device)
        radii = torch.as_tensor(self._inflated.astype(np.float32),
                                device=device)
        sphere = torch.as_tensor(self._sphere.astype(np.float32),
                                 device=device)
        point_weight = torch.tensor(4.0 * np.pi / self._n_points,
                                    dtype=torch.float32, device=device)
        atoms = torch.arange(n, device=device)
        triclinic = self._triclinic

        def frame_fields(pos, box):
            free, cnt = [], []
            for lo, hi in blocks:
                r_i = radii[lo:hi]
                dvec = _min_image_vectors(pos[None, :, :]
                                          - pos[lo:hi, None, :], box)
                d2 = _norm2(dvec)
                touch = r_i[:, None] + radii[None, :]
                cand = ((d2 < touch * touch)
                        & (atoms[lo:hi, None] != atoms[None, :]))
                cnt.append(cand.sum(dim=1))
                # the K nearest candidates (all of them while cnt <= K,
                # which the store checks)
                score = torch.where(cand, -d2, -torch.inf)
                idx = torch.topk(score, k, dim=1).indices
                rel_j = torch.take_along_dim(dvec, idx[..., None], dim=1)
                r_j = radii[idx]
                is_cand = torch.take_along_dim(cand, idx, dim=1)
                pd2 = _point_distances2(r_i, sphere, rel_j)
                occ = ((pd2 < (r_j * r_j)[:, None, :])
                       & is_cand[:, None, :]).any(dim=-1)
                free.append((~occ).sum(dim=1).to(torch.float32))
            free, cnt = torch.cat(free), torch.cat(cnt)
            # (w f) (R R), as XLA associates the JAX package's w f R R
            # for distinct radii (it folds equal ones otherwise)
            return (point_weight * free) * (radii * radii), cnt

        def update(carry, positions, dimensions, mask):
            del mask
            boxes = _frame_boxes(dimensions, triclinic)[0]
            fields = [frame_fields(pos, box)
                      for pos, box in zip(positions, boxes)]
            return carry, (torch.stack([a for a, _ in fields]),
                           torch.stack([c for _, c in fields]))

        self._update = update

    def _check_min_image_reach(self, batch) -> None:
        """Warn (once a run) when the occluder reach ``2 max R_i`` exceeds
        half the smallest box width: beyond it, second periodic images of
        occluders in reach are dropped and areas are overestimated."""

        if self._reach_warned:
            return
        dims = batch.host[1] if batch.host is not None else batch.dimensions
        dims = dims[:batch.n_real].numpy().astype(np.float64)
        if dims.size == 0:
            return
        reach = 2.0 * float(self._inflated.max())
        if self._triclinic:
            matrices = triclinic_matrices(torch.as_tensor(dims)).numpy()
            min_width = float(np.min(triclinic_perpendicular_widths(
                matrices)))
        else:
            lengths = dims[:, :3]
            positive = lengths > 0
            if not positive.any():
                return  # aperiodic: no images to miss
            min_width = float(lengths[positive].min())
        if reach > 0.5 * min_width:
            self._reach_warned = True
            warnings.warn(
                "occluder reach (2 * max inflated radius = "
                f"{reach:.2f} A) exceeds half the smallest box "
                f"width ({0.5 * min_width:.2f} A); minimum-image "
                "occlusion drops second periodic images and SASA "
                "will be overestimated in dense small cells."
            )

    def _store_chunk(self, extras, batch) -> None:
        areas, counts = extras
        n_real = batch.n_real
        areas = np.asarray(areas, dtype=np.float64)[:n_real]
        counts = np.asarray(counts)[:n_real].astype(np.int64)
        self._check_min_image_reach(batch)
        most = int(counts.max(initial=0))
        if self._mesh is not None and self._mesh.grouped:
            # Over ranks the budget is checked on every rank together
            # (_check_rank_stores); a rank raising alone would leave the
            # others waiting in their next collective.
            self._most_candidates = max(self._most_candidates, most)
        else:
            self._check_budget(most)
        lo = self._store_offset
        hi = lo + n_real
        self.results.areas[lo:hi] = areas
        self.results.total_areas[lo:hi] = areas.sum(axis=1)
        self.results.n_neighbors[lo:hi] = counts
        self._store_offset += n_real

    def _check_budget(self, most: int) -> None:
        """Raise :class:`OccluderOverflow` when an atom had `most`
        candidates, more than the active budget."""

        k = self._active_budget
        if most > k:
            raise OccluderOverflow(
                f"an atom had {most} occlusion candidates against a "
                f"max_occluders budget of {k}; re-run with "
                f"max_occluders >= {most}."
            )

    def _check_rank_stores(self) -> None:
        from ..parallel.mesh import all_reduce

        self._check_budget(int(all_reduce(
            torch.tensor(self._most_candidates, dtype=torch.int64), "max")))

    def run(self, *args, **kwargs):
        """Run, doubling the occlusion-candidate budget on overflow: each
        retry doubles ``max_occluders`` and streams again; two
        escalations bound the recursion."""

        try:
            result = super().run(*args, **kwargs)
        except OccluderOverflow:
            # The failed run's store queue may still hold the overflowing
            # chunk (the raise stops _drain_stores before it clears):
            # replayed into the retry it would store truncated areas and
            # shift every later frame.
            self._pending_stores.clear()
            retries = getattr(self, "_occluder_retries", 0)
            if retries >= 2:
                raise
            self._occluder_retries = retries + 1
            n = len(self._atom_indices)
            self._max_occluders = min(2 * self._budget(n), max(1, n - 1))
            warnings.warn(
                "occlusion-candidate budget overflow (dense local "
                "packing); re-running with max_occluders="
                f"{self._max_occluders}."
            )
            return self.run(*args, **kwargs)
        self._occluder_retries = 0
        return result
