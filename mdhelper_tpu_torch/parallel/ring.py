r"""
Ring-pass pair histogram (atom sharding)
========================================

The port of :mod:`mdhelper_tpu.parallel.ring`: when a frame's atoms
outgrow one device, the pair-distance histogram shards *atoms*, not
frames, over the ranks of a :class:`~mdhelper_tpu_torch.parallel.mesh.Mesh`.
Each shard keeps its i-block of the atoms fixed while the j-blocks rotate
around the ring, one ``batch_isend_irecv`` pair a step
(:func:`~mdhelper_tpu_torch.parallel.mesh.ring_shift`); after ``size``
steps every shard has met every j-block, and the partial counts are
summed over the ranks.

A step counts every ordered (i, j) pair of its two blocks, with the
exclusion taken on the *global* atom indices and padded rows left out
(each block is cut to its real rows before it is counted).  On a CUDA
tensor the step is the cross cell-list kernel
(:func:`~mdhelper_tpu_torch.ops.cuda_cell_histogram.cross_pair_histogram`),
whose slot tables carry the blocks' global ids (``id_offsets``); on a CPU
tensor it is the plain dense block (:func:`_plain_block_counts`), binned
with the same arithmetic as the kernel's plain version.
"""

import numpy as np
import torch

from ..ops.cuda_cell_histogram import (
    CellCapacityOverflow,
    _bin_boundary_constants,
    _bin_index,
    _device_constants,
    _fast_bin_index,
    _fast_d2_orthorhombic,
    _on_cpu,
    cell_plan_search,
    cross_pair_histogram,
)
from ..ops.histogram import _exact_d2_orthorhombic, _row_blocks
from .mesh import all_reduce, get_mesh, ring_shift

__all__ = ["ring_radial_histogram"]

#: "no overflow" value of an occupancy excess.
_NO_EXCESS = -(2**30)


def _plain_block_counts(pos_i, pos_j, box, *, r_min, r_max, n_bins,
                        exclusion, offsets, precision, axes=None):
    """Counts ``(B, n_bins)`` (int64) of every ordered pair of the blocks
    ``pos_i`` ``(B, n_i, 3)`` and ``pos_j`` ``(B, n_j, 3)`` under the
    orthorhombic float32 boxes ``box`` ``(B, 3)``, in plain torch: the
    minimum-image squared distances of the kernels' plain version (exact
    double-float, or float32 with ``precision="fast"``) over the
    coordinate columns `axes` (default all three), binned on
    ``[r_min, r_max]``; pairs with ``(o_i + i) // e0 == (o_j + j) // e1``
    for ``exclusion=(e0, e1)`` and ``offsets=(o_i, o_j)`` left out."""

    device = pos_i.device
    b, n_i, _ = pos_i.shape
    n_j = pos_j.shape[1]
    if axes is not None:
        pos_i, pos_j, box = (pos_i[..., list(axes)], pos_j[..., list(axes)],
                             box[..., list(axes)])
    n_axes = pos_i.shape[-1]
    consts = _device_constants(_bin_boundary_constants(r_max, n_bins, r_min),
                               device)
    if exclusion is not None:
        e0, e1 = exclusion
        i_ids = (offsets[0] + torch.arange(n_i, device=device)) // e0
        j_ids = (offsets[1] + torch.arange(n_j, device=device)) // e1
    counts = torch.zeros((b, n_bins + 1), dtype=torch.int64, device=device)
    for f in range(b):
        for lo, hi in _row_blocks(n_i, n_j, device):
            a = pos_i[f, lo:hi, None, :]
            c = pos_j[f, None, :, :]
            if precision == "exact":
                idx = _bin_index(_exact_d2_orthorhombic(a, c, box[f], n_axes),
                                 consts, n_bins)
            else:
                idx = _fast_bin_index(
                    _fast_d2_orthorhombic(a, c, box[f], n_axes), consts,
                    n_bins)
            idx = torch.clamp(idx, max=n_bins).long()
            if exclusion is not None:
                keep = i_ids[lo:hi, None] != j_ids[None, :]
                idx = torch.where(keep, idx, n_bins)
            counts[f] += torch.bincount(idx.reshape(-1), minlength=n_bins + 1)
    return counts[:, :n_bins]


class _RingStep:
    """One ring step's counts of a block pair: the cross kernel on a CUDA
    tensor (a cell plan for blocks of ``shards`` = (i rows, j rows) atoms
    in boxes of `extents`, re-planned by :meth:`replan`), the plain dense
    block on a CPU tensor.  Calls return ``(counts (B, n_bins) float64,
    occupancy excess over capacity (B,) int)``."""

    def __init__(self, *, r_min, r_max, n_bins, exclusion, precision,
                 shards, extents, axes=None, capacity_sigmas=4.0):
        self.binning = dict(r_min=r_min, r_max=r_max, n_bins=n_bins)
        self.exclusion = exclusion
        self.precision = precision
        self.shards = shards
        self.extents = np.asarray(extents, np.float64)
        self.axes = axes
        self.capacity_sigmas = capacity_sigmas
        self._plan = None

    def plan(self):
        if self._plan is None:
            extents = (self.extents if self.axes is None
                       else self.extents[list(self.axes)])
            self._plan = cell_plan_search(
                self.shards[0], extents, self.binning["r_max"],
                n_atoms2=self.shards[1],
                capacity_sigmas=self.capacity_sigmas)
        return self._plan

    def replan(self):
        """Two Poisson sigmas more headroom (after an agreed overflow)."""

        self.capacity_sigmas += 2.0
        self._plan = None

    def __call__(self, pos_i, pos_j, box, offsets):
        if _on_cpu(pos_i, "the ring step"):
            counts = _plain_block_counts(
                pos_i, pos_j, box, exclusion=self.exclusion, offsets=offsets,
                precision=self.precision, axes=self.axes, **self.binning)
            excess = torch.full((pos_i.shape[0],), _NO_EXCESS,
                                dtype=torch.int64)
            return counts.to(torch.float64), excess
        plan = self.plan()
        counts, occ1, occ2 = cross_pair_histogram(
            pos_i, pos_j, box=box, n_cells_dim=plan["n_cells_dim"],
            reach=plan["reach"], capacity1=plan["capacity"],
            capacity2=plan["capacity2"], exclusion=self.exclusion,
            axes=self.axes, precision=self.precision, id_offsets=offsets,
            **self.binning)
        excess = torch.maximum(occ1 - plan["capacity"],
                               occ2 - plan["capacity2"])
        return counts.to(torch.float64), excess.to(torch.int64)


def _ring_counts(pos_i, block_j, box, mesh, step, *, i_offset, shard_j,
                 n_real_j):
    """This shard's counts ``(B, n_bins)`` float64 and excess ``(B,)``
    over one ring pass: `pos_i` ``(B, n_i, 3)`` holds its real i rows
    (global indices from `i_offset`), `block_j` ``(B, shard_j, 3)`` the
    j-block it starts with (the one of its own shard index, padded to
    `shard_j` rows; the j side has `n_real_j` real rows in all).  At step
    ``s`` the block of shard ``index - s`` is counted, then passed on."""

    counts = excess = None
    block = block_j
    for s in range(mesh.size):
        owner = (mesh.index - s) % mesh.size
        j_offset = owner * shard_j
        n_j = min(max(n_real_j - j_offset, 0), shard_j)
        if n_j and pos_i.shape[1]:
            c, e = step(pos_i, block[:, :n_j], box, (i_offset, j_offset))
            counts = c if counts is None else counts + c
            excess = e if excess is None else torch.maximum(excess, e)
        if s + 1 < mesh.size:
            block = ring_shift(block, mesh)
    b = pos_i.shape[0]
    if counts is None:
        counts = torch.zeros((b, step.binning["n_bins"]), dtype=torch.float64,
                             device=pos_i.device)
        excess = torch.full((b,), _NO_EXCESS, dtype=torch.int64,
                            device=pos_i.device)
    return counts, excess


def _shard_blocks(n_real, n_shards):
    """``(rows a shard, padded length)`` of `n_real` rows over
    `n_shards` shards."""

    size = -(-n_real // n_shards)
    return size, size * n_shards


def _pad_rows(pos, n_padded):
    """``(B, n, 3)`` rows padded with zeros to `n_padded` rows."""

    pad = n_padded - pos.shape[1]
    if pad <= 0:
        return pos
    return torch.cat((pos, pos.new_zeros((pos.shape[0], pad, pos.shape[2]))),
                     dim=1)


def ring_radial_histogram(
    positions,
    box,
    edges,
    mesh=None,
    *,
    positions2=None,
    exclusion=None,
    axis_name: str = None,
    precision: str = "fast",
    device=None,
):
    r"""Atom-sharded radial pair-distance histogram over the ring of
    `mesh`'s ranks.

    Every ordered pair ``(i, j)`` of ``positions`` (each with itself too,
    at distance 0, unless the exclusion drops it), or of ``positions``
    against ``positions2``, binned by its minimum-image distance on the
    uniform `edges` (the JAX package's function, with each step's block
    counted as described in the module docstring).

    Parameters
    ----------
    positions : array-like
        Coordinates ``(N, 3)``, wrapped into the box; every rank passes
        the whole array and counts with its i-shard.
    box : array-like
        Orthorhombic box lengths ``(3,)``.
    edges : array-like
        Uniform bin edges ``(n_bins + 1,)`` from ``edges[0] >= 0``.
    mesh : `Mesh`, optional
        The ranks of the ring (default: every rank of the default group,
        on an ``"atoms"`` axis; a world of one without a process group).
    positions2 : array-like, keyword-only, optional
        The second group ``(N_2, 3)`` of a cross histogram: the i side
        stays `positions`, this side rotates.  Indices on each side are
        per group, as in the unsharded cross histogram.
    exclusion : `tuple`, keyword-only, optional
        ``(e0, e1)``: drop pairs with ``i // e0 == j // e1`` on the global
        (per-group) atom indices.
    axis_name : `str`, keyword-only, optional
        The default mesh's axis name (``"atoms"``).
    precision : `str`, keyword-only, default ``"fast"``
        ``"exact"`` (double-float distances) or ``"fast"`` (float32
        distances, the cell kernels' fast binning).
    device : optional
        Device of the counts (default: the current CUDA device, which must
        exist; ``"cpu"`` for the plain blocks).

    Returns
    -------
    counts : `numpy.ndarray`
        float64 counts ``(n_bins,)``, the same on every rank.

    A capacity overflow of the cell plan (CUDA) is agreed over the ranks
    and re-planned with two Poisson sigmas more, twice at most, on every
    rank together.
    """

    from .._device import resolve_device

    device = resolve_device(device)
    if mesh is None:
        mesh = get_mesh(axis_name=axis_name or "atoms")
    edges = np.asarray(edges, np.float64)
    n_bins = len(edges) - 1
    r_min, r_max = float(edges[0]), float(edges[-1])
    if not np.allclose(np.diff(edges), (r_max - r_min) / n_bins,
                       rtol=1e-9, atol=0.0):
        raise ValueError("The ring bins on uniform edges only.")
    if precision not in ("exact", "fast"):
        raise ValueError("precision must be 'exact' or 'fast'.")
    pos1 = torch.as_tensor(np.asarray(positions, np.float32), device=device)
    pos2 = (pos1 if positions2 is None else
            torch.as_tensor(np.asarray(positions2, np.float32),
                            device=device))
    n1, n2 = pos1.shape[0], pos2.shape[0]
    shard_i, _ = _shard_blocks(n1, mesh.size)
    shard_j, padded_j = _shard_blocks(n2, mesh.size)
    box32 = torch.as_tensor(np.asarray(box, np.float32)[None], device=device)
    step = _RingStep(r_min=r_min, r_max=r_max, n_bins=n_bins,
                     exclusion=(None if exclusion is None
                                else tuple(int(e) for e in exclusion)),
                     precision=precision, shards=(shard_i, shard_j),
                     extents=np.asarray(box, np.float64))
    counts = torch.zeros((1, n_bins), dtype=torch.float64, device=device)
    for attempt in range(3):
        excess = torch.full((1,), _NO_EXCESS, dtype=torch.int64,
                            device=device)
        counts.zero_()
        if mesh.index is not None:
            lo = mesh.index * shard_i
            own_j = _pad_rows(pos2[None], padded_j)[
                :, mesh.index * shard_j:(mesh.index + 1) * shard_j]
            counts, excess = _ring_counts(
                pos1[None, lo:lo + shard_i], own_j, box32, mesh, step,
                i_offset=lo, shard_j=shard_j, n_real_j=n2)
        if int(all_reduce(excess.max(), "max")) <= 0:
            break
        if attempt == 2:
            raise CellCapacityOverflow(
                "cell capacity overflow in the ring's blocks after two "
                "re-plans.")
        step.replan()
    return all_reduce(counts[0], "sum").cpu().numpy()
