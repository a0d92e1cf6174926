r"""
Bond-orientational order
========================

Steinhardt bond-orientational order parameters (:math:`q_l`,
:math:`w_l`, and the Lechner-Dellago neighbor-averaged
:math:`\bar{q}_l`, :math:`\bar{w}_l`) and the Errington-Debenedetti
tetrahedral order parameter, ported from
:mod:`mdhelper_tpu.analysis.steinhardt`.

Neighbors come from a dense minimum-image sweep in row blocks
(``ops.histogram._contact_map`` and ``_row_blocks``).  The Steinhardt
sums then run over each particle's neighbor list, padded to the frame's
largest count (one host sync a frame for its size), in ascending
neighbor order, with the real spherical harmonics as trig-free
Cartesian polynomials
(:func:`~mdhelper_tpu_torch.algorithm.spherical.real_sph_harm`); the JAX
package sums them over every column of its dense blocks instead.  The
tetrahedral parameter takes each particle's k nearest neighbors, ties
broken by the lower index (as ``lax.top_k`` breaks them).  The
rotational invariants, and the Wigner-3j third-order couplings in
float64, are formed on the host as each chunk's fields arrive.  The JAX
package's host KD-tree pipeline and its watchdog chunk cap are not
ported.
"""

from numbers import Real

import numpy as np
import torch

from .. import ureg
from ..algorithm.spherical import (
    invariant_ql,
    invariant_wl,
    real_sph_harm,
    sph_harm_columns,
)
from ..algorithm.unit import strip_unit
from ..ops.histogram import (
    _contact_map,
    _min_image_vectors,
    _norm2,
    _row_blocks,
)
from .base import DynamicAnalysisBase
from .structure import _frame_boxes

__all__ = ["SteinhardtOrderParameter", "TetrahedralOrderParameter"]


class SteinhardtOrderParameter(DynamicAnalysisBase):
    r"""Per-particle Steinhardt bond-orientational order parameters.

    For each particle :math:`i` with neighbors :math:`j` within
    `cutoff`,

    .. math::

       q_{lm}(i) = \frac{1}{N_b(i)} \sum_{j \in \mathcal{N}(i)}
       Y_{lm}(\hat{r}_{ij}), \qquad
       q_l(i) = \sqrt{\frac{4\pi}{2l+1} \sum_m |q_{lm}(i)|^2},

    with optional third-order invariants :math:`\hat{w}_l(i)`
    (``wl=True``) and the Lechner-Dellago neighborhood averages
    :math:`\bar{q}_l(i)`, :math:`\bar{w}_l(i)` (``averaged=True``),
    which average :math:`q_{lm}` over :math:`\mathcal{N}(i) \cup
    \{i\}` before forming the invariants.

    Parameters
    ----------
    group : `AtomGroup`
        Particles to analyze.
    cutoff : `float` or unit-bearing quantity
        Neighbor-shell cutoff (Å).
    degrees : sequence of `int`, default ``(4, 6)``
        Harmonic degrees :math:`l`.
    averaged : `bool`, keyword-only, default False
        Also compute :math:`\bar{q}_l` (and :math:`\bar{w}_l` with
        ``wl=True``).
    wl : `bool`, keyword-only, default False
        Also compute the normalized third-order invariants
        :math:`\hat{w}_l`.
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    parallel : `bool`, keyword-only, default False
        Not ported (``True`` raises `NotImplementedError`).
    device : optional
        Device the chunks are folded on (default: the first CUDA
        device, which must exist; ``"cpu"`` for the CPU).

    Results
    -------
    ``results.ql``
        Per-particle :math:`q_l`, shape ``(n_frames, n_degrees,
        N)``.  Particles with no neighbors get 0.
    ``results.ql_mean``
        Particle-averaged :math:`\langle q_l \rangle`, shape
        ``(n_frames, n_degrees)``.
    ``results.Ql``
        Global order parameter from the particle-averaged
        :math:`q_{lm}`, shape ``(n_frames, n_degrees)``.
    ``results.wl``, ``results.ql_avg``, ``results.wl_avg``
        (with the corresponding flags) :math:`\hat{w}_l`,
        :math:`\bar{q}_l`, :math:`\hat{\bar{w}}_l`, each
        ``(n_frames, n_degrees, N)``.
    ``results.n_neighbors``
        Per-particle neighbor counts, ``(n_frames, N)``.
    ``results.times``
        Frame times (ps).
    """

    def __init__(
        self,
        group,
        cutoff,
        degrees=(4, 6),
        *,
        averaged: bool = False,
        wl: bool = False,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
    ) -> None:
        self.group = group
        self.universe = group.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device)
        if not isinstance(cutoff, Real):
            cutoff = strip_unit(cutoff, "angstrom")[0]
        if cutoff <= 0:
            raise ValueError("'cutoff' must be positive.")
        degrees = tuple(int(l) for l in degrees)
        if not degrees or any(l < 1 for l in degrees):
            raise ValueError(
                "'degrees' must be a non-empty sequence of "
                "positive integers."
            )
        if group.n_atoms < 2:
            raise ValueError("'group' must contain at least 2 atoms.")
        self._cutoff = float(cutoff)
        self._degrees = degrees
        self._n_cols = sph_harm_columns(degrees)
        self._averaged = bool(averaged)
        self._wl = bool(wl)
        self._reduced = reduced
        self._atom_indices = group.ix
        self._setup_periodic_box()
        self._require_box("Bond-orientational order")

    def _prepare(self) -> None:
        n = len(self._atom_indices)
        n_l = len(self._degrees)
        self.results.ql = np.empty((self.n_frames, n_l, n))
        self.results.ql_mean = np.empty((self.n_frames, n_l))
        self.results.Ql = np.empty((self.n_frames, n_l))
        self.results.n_neighbors = np.empty(
            (self.n_frames, n), dtype=np.int64
        )
        if self._wl:
            self.results.wl = np.empty((self.n_frames, n_l, n))
        if self._averaged:
            self.results.ql_avg = np.empty((self.n_frames, n_l, n))
            if self._wl:
                self.results.wl_avg = np.empty((self.n_frames, n_l, n))
        self.results.times = self.frames * self._trajectory.dt
        if not self._reduced:
            self.results.units = {"results.times": ureg.picosecond}
        self._store_offset = 0
        # Everything is stored; the carry holds nothing.
        self._carry = {}
        self._make_update()

    def _make_update(self) -> None:
        n = len(self._atom_indices)
        device = self._device
        degrees = self._degrees
        averaged = self._averaged
        triclinic = self._triclinic
        cut2 = torch.tensor(self._cutoff * self._cutoff,
                            dtype=torch.float32, device=device)
        eps = torch.tensor(1e-12, dtype=torch.float32, device=device)

        def neighbor_table(pts, box):
            """``(table, valid, counts)``: each particle's neighbors in
            ascending order, padded with ``n`` to the largest count."""

            mask = _contact_map(pts, box, cut2).fill_diagonal_(False)
            rows, cols = mask.nonzero(as_tuple=True)  # row-major order
            counts = torch.bincount(rows, minlength=n)
            width = max(int(counts.max()), 1)
            starts = torch.cumsum(counts, 0) - counts
            table = torch.full((n, width), n, dtype=torch.int64,
                               device=device)
            table[rows, torch.arange(len(rows), device=device)
                  - starts[rows]] = cols
            return table, table < n, counts

        def frame_fields(pts, box):
            table, valid, counts = neighbor_table(pts, box)
            padded = torch.cat((pts, pts.new_zeros(1, 3)))
            # The bond r_i - r_j of each neighbor, as the JAX sweep forms it.
            dvec = _min_image_vectors(pts[:, None, :] - padded[table], box)
            d2 = _norm2(dvec)
            u = dvec * torch.rsqrt(torch.maximum(d2, eps))[..., None]
            y = real_sph_harm(degrees, u)
            y = torch.where(valid[..., None], y, 0.0)
            cnt = counts.to(torch.float32)
            qlm = y.sum(dim=1) / torch.clamp(cnt, min=1.0)[:, None]
            if not averaged:
                return qlm, counts, qlm.new_zeros(())
            nbr = torch.where(valid[..., None],
                              torch.cat((qlm, qlm.new_zeros(1, qlm.shape[1])))
                              [table], 0.0).sum(dim=1)
            return qlm, counts, (qlm + nbr) / (cnt + 1.0)[:, None]

        def update(carry, positions, dimensions, mask):
            del mask
            boxes = _frame_boxes(dimensions, triclinic)[0]
            fields = [frame_fields(pos, box)
                      for pos, box in zip(positions, boxes)]
            return carry, tuple(torch.stack(f) for f in zip(*fields))

        self._update = update

    def _store_chunk(self, extras, batch) -> None:
        qlm, counts, qbar = extras
        n_real = batch.n_real
        qlm = np.asarray(qlm, dtype=np.float64)[:n_real]
        lo = self._store_offset
        hi = lo + n_real
        self.results.n_neighbors[lo:hi] = counts[:n_real]
        if self._averaged:
            qbar = np.asarray(qbar, dtype=np.float64)[:n_real]
        col = 0
        for k, l in enumerate(self._degrees):
            width = 2 * l + 1
            block = qlm[..., col:col + width]
            self.results.ql[lo:hi, k] = invariant_ql(l, block)
            self.results.ql_mean[lo:hi, k] = self.results.ql[
                lo:hi, k
            ].mean(axis=-1)
            self.results.Ql[lo:hi, k] = invariant_ql(l, block.mean(axis=1))
            if self._wl:
                self.results.wl[lo:hi, k] = invariant_wl(l, block)
            if self._averaged:
                ablock = qbar[..., col:col + width]
                self.results.ql_avg[lo:hi, k] = invariant_ql(l, ablock)
                if self._wl:
                    self.results.wl_avg[lo:hi, k] = invariant_wl(l, ablock)
            col += width
        self._store_offset += n_real


class TetrahedralOrderParameter(DynamicAnalysisBase):
    r"""Errington-Debenedetti tetrahedral order parameter

    .. math::

       q_{\mathrm{tet}}(i) = 1 - \frac{3}{8} \sum_{j < k}^{4}
       \left( \cos\psi_{jik} + \tfrac{1}{3} \right)^2

    over the four nearest neighbors of each particle (1 for a
    perfect tetrahedral cage, 0 on average for an ideal gas).  Neighbors
    at equal distances go in ascending index order, as in the JAX
    package.

    Parameters
    ----------
    group : `AtomGroup`
        Particles to analyze (e.g. water oxygens).
    n_neighbors : `int`, keyword-only, default 4
        Neighbors defining the local cage; the prefactor
        generalizes as :math:`q = 1 - \frac{9}{2 k (k - 1)}
        \sum_{j<k} (\cos\psi + 1/3)^2` for :math:`k` neighbors.
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    parallel : `bool`, keyword-only, default False
        Not ported (``True`` raises `NotImplementedError`).
    device : optional
        Device the chunks are folded on (default: the first CUDA
        device, which must exist; ``"cpu"`` for the CPU).

    Results
    -------
    ``results.q_tet``
        Per-particle order parameter, shape ``(n_frames, N)``.
    ``results.q_tet_mean``
        Particle-averaged value per frame, shape ``(n_frames,)``.
    ``results.times``
        Frame times (ps).
    """

    def __init__(
        self,
        group,
        *,
        n_neighbors: int = 4,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
    ) -> None:
        self.group = group
        self.universe = group.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device)
        n_neighbors = int(n_neighbors)
        if n_neighbors < 2:
            raise ValueError("'n_neighbors' must be at least 2.")
        if group.n_atoms <= n_neighbors:
            raise ValueError(
                "'group' must contain more atoms than 'n_neighbors'."
            )
        self._k = n_neighbors
        self._reduced = reduced
        self._atom_indices = group.ix
        self._setup_periodic_box()
        self._require_box("Tetrahedral order")

    def _prepare(self) -> None:
        n = len(self._atom_indices)
        self.results.q_tet = np.empty((self.n_frames, n))
        self.results.q_tet_mean = np.empty(self.n_frames)
        self.results.times = self.frames * self._trajectory.dt
        if not self._reduced:
            self.results.units = {"results.times": ureg.picosecond}
        self._store_offset = 0
        self._carry = {}
        self._make_update()

    @staticmethod
    def _angle_sum_prefactor(k: int) -> float:
        # Errington-Debenedetti normalization: 3/8 at k = 4 (k(k-1)/2
        # angle pairs, each worth up to (1 + 1/3)^2 = 16/9; the
        # prefactor makes an ideal gas average to ~0).
        return 9.0 / (2.0 * k * (k - 1))

    def _make_update(self) -> None:
        n = len(self._atom_indices)
        k = self._k
        device = self._device
        triclinic = self._triclinic
        pref = torch.tensor(self._angle_sum_prefactor(k),
                            dtype=torch.float32, device=device)
        third = torch.tensor(1.0 / 3.0, dtype=torch.float32, device=device)
        eps = torch.tensor(1e-12, dtype=torch.float32, device=device)
        blocks = _row_blocks(n, n, device)
        j_idx = torch.arange(n, device=device)
        upper = torch.triu(torch.ones((k, k), dtype=torch.bool,
                                      device=device), 1)

        def nearest(pts, box, lo, hi):
            """The `k` nearest neighbors of rows ``lo:hi``, by ascending
            d^2 and then index: d^2 >= 0 orders as its float32 bits, so
            ``(bits << 32) | j`` is a key with no ties."""

            d2 = _norm2(_min_image_vectors(
                pts[lo:hi, None, :] - pts[None, :, :], box))
            d2 = torch.where(j_idx[lo:hi, None] == j_idx[None, :],
                             torch.inf, d2)
            key = (d2.view(torch.int32).to(torch.int64) << 32) | j_idx
            return torch.topk(key, k, dim=1, largest=False).indices

        def frame_q(pts, box):
            idx = torch.cat([nearest(pts, box, lo, hi) for lo, hi in blocks])
            v = _min_image_vectors(pts[idx] - pts[:, None, :], box)
            u = v * torch.rsqrt(torch.maximum(_norm2(v), eps))[..., None]
            g = (u[:, :, None, 0] * u[:, None, :, 0]
                 + u[:, :, None, 1] * u[:, None, :, 1]
                 + u[:, :, None, 2] * u[:, None, :, 2])
            s = torch.where(upper, (g + third) ** 2, 0.0).sum(dim=(-1, -2))
            return 1.0 - pref * s

        def update(carry, positions, dimensions, mask):
            del mask
            boxes = _frame_boxes(dimensions, triclinic)[0]
            return carry, torch.stack([frame_q(pos, box)
                                       for pos, box in zip(positions, boxes)])

        self._update = update

    def _store_chunk(self, extras, batch) -> None:
        q = np.asarray(extras, dtype=np.float64)[: batch.n_real]
        lo = self._store_offset
        hi = lo + batch.n_real
        self.results.q_tet[lo:hi] = q
        self.results.q_tet_mean[lo:hi] = q.mean(axis=-1)
        self._store_offset += batch.n_real
