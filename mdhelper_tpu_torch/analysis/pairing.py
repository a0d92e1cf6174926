r"""
Ion pairing
===========

Contact ion-pair statistics between two groups, ported from
:mod:`mdhelper_tpu.analysis.pairing`: per-frame pair counts, per-ion
coordination numbers, free-ion fractions and, optionally, the per-pair
contact-frame counts and the intermittent pair-lifetime correlation
:math:`c(t)` with the continuous survival :math:`S(t)`
(:func:`~mdhelper_tpu_torch.analysis.base.existence_lifetimes`).

Criterion: two entities (atoms, or residue centers of mass for molecular
ions) form a contact pair when their minimum-image distance is at most
`cutoff`, conventionally the first minimum of their RDF.

Entity positions are a column gather, or residue centers through
:func:`~mdhelper_tpu_torch.analysis.structure._segment_com_reducer`.  A
chunk is swept as a dense ``(B, N_1, N_2)`` minimum-image test
``|v|^2 <= cutoff^2`` (orthorhombic or triclinic cells) in row blocks of
group-1 entities (:func:`~mdhelper_tpu_torch.ops.histogram._row_blocks`,
sized for all the chunk's frames at once), the squared norm fused as XLA
forms it (:func:`~mdhelper_tpu_torch.ops.histogram._norm2`).  Partner
counts and the pair-count matrix accumulate in int64 on the device.  The
JAX package's host KD-tree pipeline and its watchdog chunk cap are not
ported.
"""

from numbers import Real
from typing import Union

import numpy as np
import torch

from .. import ureg
from ..algorithm.unit import strip_unit
from ..ops.histogram import _min_image_vectors, _norm2, _row_blocks
from .base import DynamicAnalysisBase, existence_lifetimes
from .structure import _frame_boxes, _group_segment_ids, _segment_com_reducer

__all__ = ["IonPairAnalysis"]


class IonPairAnalysis(DynamicAnalysisBase):
    r"""Contact ion-pair statistics between two groups.

    Parameters
    ----------
    group1, group2 : `AtomGroup`
        The two ion groups (e.g. cations and anions).  Overlapping
        groups (or the same group twice, for like-ion pairing) are
        allowed: identical entities are not paired with themselves.
    cutoff : `float` or unit-bearing quantity
        Contact distance cutoff (Angstrom).
    groupings : `str` or 2-tuple, default :code:`"atoms"`
        ``"atoms"`` or ``"residues"`` per group (residue centers of mass
        for molecular ions).
    pair_counts : `bool`, keyword-only, default :code:`False`
        Accumulate the full ``(N_1, N_2)`` per-pair contact-frame count
        matrix.
    lifetimes : `bool`, keyword-only, default :code:`False`
        Store the per-frame pair-existence matrix and compute the
        intermittent pair correlation :math:`c(t)` and the continuous
        survival :math:`S(t)`.  Memory: ``n_frames x N_1 x N_2`` bools
        on the host.
    reduced : `bool`, keyword-only, default :code:`False`
        Reduced (LJ) units: `cutoff` is dimensionless and
        ``results.units`` is omitted.
    parallel : `bool`, keyword-only, default :code:`False`
        Shard the frames over the ranks of :mod:`torch.distributed` (a
        world of one without a process group): the partner and pair
        counts of each rank's real frames (mask 1) add up over the ranks,
        and the per-frame counts, free fractions and the existence
        matrix (as uint8 over gloo) are gathered in frame order.
    device : `torch.device` or `str`, keyword-only, optional
        Where the chunks are swept (default: the first CUDA device);
        ``"cpu"`` for the CPU.

    Results
    -------
    ``results.counts``
        Per-frame contact-pair count, shape ``(n_frames,)``.  When
        `group1` and `group2` resolve to the same entity set (like-ion
        pairing) each unordered pair counts once; for partially
        overlapping selections pairs are ordered.
    ``results.mean_count``
        Time-averaged pair count.
    ``results.coordination``
        ``[c_1, c_2]``: time-averaged counter-ion coordination number
        per group-1 / group-2 entity, shapes ``(N_1,)`` and ``(N_2,)``.
    ``results.free_fractions``
        Per-frame fraction of entities with no counter-ion contact,
        shape ``(n_frames, 2)``.
    ``results.pair_counts``
        (``pair_counts=True``) per-pair contact-frame counts, shape
        ``(N_1, N_2)`` (the full symmetric matrix for like ions).
    ``results.lifetime``, ``results.survival``, ``results.lifetime_times``
        (``lifetimes=True``) :math:`c(t)`, :math:`S(t)` (both 1 at
        :math:`t = 0`) and the lag times (ps).
    ``results.times``
        Frame times (ps).
    """

    _checkpointable_stores = True
    _rank_sharded = True

    def _checkpoint_attrs(self) -> tuple:
        return ("_existence",) if self._lifetimes else ()

    def _result_stores(self) -> dict:
        return {"counts": 0, "free_fractions": 0}

    def __init__(
        self,
        group1,
        group2,
        cutoff,
        groupings: Union[str, tuple] = "atoms",
        *,
        pair_counts: bool = False,
        lifetimes: bool = False,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ) -> None:
        self._groups = [group1, group2]
        self.universe = group1.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device, **kwargs)

        if not isinstance(cutoff, Real):
            cutoff = strip_unit(cutoff, "angstrom")[0]
        if cutoff <= 0:
            raise ValueError("'cutoff' must be positive.")
        self._cutoff = float(cutoff)

        valid = {"atoms", "residues"}
        if isinstance(groupings, str):
            groupings = (groupings, groupings)
        if len(groupings) != 2 or any(g not in valid for g in groupings):
            raise ValueError(
                "Invalid groupings; valid values: "
                f"{', '.join(sorted(valid))}."
            )
        self._groupings = tuple(groupings)

        # Both groups' columns stream back to back (duplicates are fine).
        self._atom_indices = np.concatenate([g.ix for g in self._groups])
        self._sels, self._segs, self._n_entities = [], [], []
        entity_ids = []
        offset = 0
        for g, gr in zip(self._groups, self._groupings):
            if g.n_atoms == 0:
                raise ValueError("Groups must be non-empty.")
            self._sels.append(offset + np.arange(g.n_atoms))
            seg, n = _group_segment_ids(g, gr)
            if gr == "atoms":
                ids = np.asarray(g.ix, dtype=np.int64)
            else:
                # one resindex an entity, in np.unique's sorted order, the
                # order of _group_segment_ids's relabeled segments
                ids = np.unique(np.asarray(g.resindices, dtype=np.int64))
            self._segs.append(seg)
            self._n_entities.append(int(n))
            entity_ids.append(ids)
            offset += g.n_atoms
        # Self pairs are excluded only where the entity id sets overlap
        # (like with like: atoms with atoms, residues with residues).
        same_kind = self._groupings[0] == self._groupings[1]
        if same_kind and np.intersect1d(entity_ids[0], entity_ids[1]).size:
            self._not_self = entity_ids[0][:, None] != entity_ids[1][None, :]
        else:
            self._not_self = None
        # Identical entity sets: the contact matrix is symmetric, so the
        # counts report each unordered pair once (the matrix sum halved);
        # pair_counts stays the full matrix.
        self._symmetric = same_kind and np.array_equal(entity_ids[0],
                                                       entity_ids[1])
        self._pair_counts = bool(pair_counts)
        self._lifetimes = bool(lifetimes)
        self._reduced = reduced
        self._setup_periodic_box()

    def _entity_extractor(self, which: int):
        """``(B, n_columns, 3)`` streamed columns to the ``(B, N_i, 3)``
        entity positions of group `which`: a column gather, or the residue
        centers of mass of those columns."""

        sel = torch.as_tensor(self._sels[which], device=self._device)
        seg = self._segs[which]
        if seg is None:
            return lambda positions: positions[:, sel]
        reduce = _segment_com_reducer(seg, self._n_entities[which],
                                      self._groups[which].masses,
                                      self._device)
        return lambda positions: reduce(positions[:, sel])

    def _prepare(self) -> None:
        n1, n2 = self._n_entities
        self.results.counts = np.empty(self.n_frames, dtype=int)
        self.results.free_fractions = np.empty((self.n_frames, 2))
        self.results.times = self.frames * self._trajectory.dt
        if not self._reduced:
            self.results.units = {"results.times": ureg.picosecond}
        self._store_offset = 0
        if self._lifetimes:
            self._existence = np.zeros((self.n_frames, n1, n2), dtype=bool)
        device = self._device
        self._carry = {
            "partners1": torch.zeros(n1, dtype=torch.int64, device=device),
            "partners2": torch.zeros(n2, dtype=torch.int64, device=device),
        }
        if self._pair_counts:
            self._carry["pair_counts"] = torch.zeros(
                (n1, n2), dtype=torch.int64, device=device)
        self._make_update()

    def _make_update(self) -> None:
        device = self._device
        extract1 = self._entity_extractor(0)
        extract2 = self._entity_extractor(1)
        cut2 = torch.tensor(self._cutoff * self._cutoff, dtype=torch.float32,
                            device=device)
        not_self = (None if self._not_self is None
                    else torch.as_tensor(self._not_self, device=device))
        triclinic = self._triclinic
        track_pairs = self._pair_counts
        lifetimes = self._lifetimes
        n1, n2 = self._n_entities

        def update(carry, positions, dimensions, mask):
            # a rank's padded tail (mask 0) pairs nothing in the carry
            real = mask > 0
            boxes = _frame_boxes(dimensions, triclinic)[0]
            # one box a frame, broadcast over (rows, N_2)
            boxes = boxes[:, None, None]
            e1, e2 = extract1(positions), extract2(positions)
            n_frames = len(positions)
            partners1, within = [], []
            partners2 = torch.zeros((n_frames, n2), dtype=torch.int64,
                                    device=device)
            new = dict(carry)
            for lo, hi in _row_blocks(n1, n_frames * n2, device):
                v = _min_image_vectors(
                    e2[:, None, :, :] - e1[:, lo:hi, None, :], boxes)
                w = _norm2(v) <= cut2
                if not_self is not None:
                    w = w & not_self[lo:hi]
                partners1.append(w.sum(dim=2))
                partners2 += w.sum(dim=1)
                if track_pairs:
                    # in place: the carry's matrix is the run's own
                    new["pair_counts"][lo:hi] += (
                        w & real[:, None, None]).sum(dim=0)
                if lifetimes:
                    within.append(w)
            partners1 = torch.cat(partners1, dim=1)
            new["partners1"] = carry["partners1"] + (
                partners1 * real[:, None]).sum(dim=0)
            new["partners2"] = carry["partners2"] + (
                partners2 * real[:, None]).sum(dim=0)
            counts = partners1.sum(dim=1)
            free1 = (partners1 == 0).sum(dim=1)
            free2 = (partners2 == 0).sum(dim=1)
            if lifetimes:
                return new, (counts, free1, free2, torch.cat(within, dim=1))
            return new, (counts, free1, free2)

        self._update = update

    def _store_chunk(self, extras, batch) -> None:
        if self._lifetimes:
            counts, free1, free2, within = extras
        else:
            (counts, free1, free2), within = extras, None
        n_real = batch.n_real
        n1, n2 = self._n_entities
        lo = self._store_offset
        chunk_counts = counts[:n_real]
        if self._symmetric:
            # a symmetric matrix without its diagonal: even sums
            chunk_counts = chunk_counts // 2
        self.results.counts[lo:lo + n_real] = chunk_counts
        self.results.free_fractions[lo:lo + n_real, 0] = free1[:n_real] / n1
        self.results.free_fractions[lo:lo + n_real, 1] = free2[:n_real] / n2
        if within is not None:
            self._existence[lo:lo + n_real] = within[:n_real]
        self._store_offset += n_real

    def _conclude(self) -> None:
        self.results.mean_count = float(self.results.counts.mean())
        self.results.coordination = [
            self._carry[key].cpu().numpy() / self.n_frames
            for key in ("partners1", "partners2")
        ]
        if self._pair_counts:
            self.results.pair_counts = self._carry["pair_counts"].cpu().numpy()
        if self._lifetimes:
            T = self.n_frames
            h = self._existence.reshape(T, -1)
            lag_dt = self._uniform_lag_dt("Ion-pair lifetimes")
            self.results.lifetime_times = np.arange(T) * lag_dt
            self.results.lifetime, self.results.survival = (
                existence_lifetimes(h, device=self._device)
            )
            if not self._reduced:
                self.results.units["results.lifetime_times"] = ureg.picosecond
