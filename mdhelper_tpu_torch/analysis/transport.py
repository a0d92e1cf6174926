r"""
Transport properties
====================

:class:`Onsager`, ported from :mod:`mdhelper_tpu.analysis.transport`:
per-frame unwrap with image flags carried across streamed chunks
(:func:`mdhelper_tpu_torch.ops.pbc.unwrap_scan`), a host store of the
per-frame entity positions, and the float64 FFT mean-squared and cross
displacements at the conclusion, of atoms or of the centers of mass of
residues or segments (taken from the unwrapped positions).  Centering
and the post-hoc coefficient fits come later.
"""

import itertools
import warnings

import numpy as np
import torch

from ..algorithm.correlation import msd_fft
from ..algorithm.topology import unwrap_edge
from ..ops.pbc import unwrap_scan
from .base import SerialAnalysisBase, _check_even_frame_spacing
from .structure import (
    _entity_positions_fn,
    _group_segment_ids,
    _groupings_per_group,
)

__all__ = ["Onsager"]


class Onsager(SerialAnalysisBase):
    r"""Mean-squared and cross displacements for Onsager transport
    coefficients.

    ``results.msd_self`` holds particle-averaged MSDs and
    ``results.msd_cross`` the displacements of group sums, both divided
    by :math:`2D` (the reference convention).  The reference's
    ``temperature`` and ``reduced`` arguments only scale the transport
    coefficients, which are not ported yet, so they are absent here.

    Parameters
    ----------
    groups : `AtomGroup` or sequence of them
        Group(s) to analyze.
    groupings : `str` or sequence, default ``"atoms"``
        ``"atoms"``, ``"residues"`` or ``"segments"``, for every group or
        one for each: the displacements of the residues' or segments'
        centers of mass (entities in ascending label order), reduced from
        the unwrapped positions of the group's own atoms.
    dimensions : array-like, keyword-only, optional
        Box lengths (defaults to the trajectory).
    dt : `float`, keyword-only, optional
        Time between frames (ps).
    n_blocks : `int`, keyword-only, default 1
        Statistical blocks.
    fft : `bool`, keyword-only, default True
        Only the FFT evaluation is ported.
    unwrap : `bool`, keyword-only, default False
        Unwrap positions by image-flag tracking.
    device : optional
        Device the chunks are folded on (default: the first CUDA
        device, which must exist; ``"cpu"`` for the CPU).
    """

    def __init__(self, groups, groupings="atoms", *,
                 dimensions=None, dt=None, n_blocks: int = 1,
                 fft: bool = True, unwrap: bool = False,
                 verbose: bool = True, device=None):
        self._groups = (
            [groups] if hasattr(groups, "universe") else list(groups)
        )
        self.universe = self._groups[0].universe
        super().__init__(self.universe.trajectory, verbose, device=device)
        if not fft:
            raise NotImplementedError("Only fft=True is ported.")
        self._n_groups = len(self._groups)
        self._groupings = _groupings_per_group(
            groupings, self._n_groups, {"atoms", "residues", "segments"})
        if dimensions is not None:
            if len(dimensions) != 3:
                raise ValueError("'dimensions' must have length 3.")
            self._dimensions = np.asarray(dimensions, dtype=float)
        elif self.universe.dimensions is not None:
            self._dimensions = np.asarray(
                self.universe.dimensions[:3], dtype=float
            ).copy()
        else:
            raise ValueError("No system dimensions found or provided.")
        self._dt = dt or self._trajectory.dt
        self._Ns = [_group_segment_ids(g, gr)[1]
                    for g, gr in zip(self._groups, self._groupings)]
        self._N = int(sum(self._Ns))
        self._entity_slices = []
        index = 0
        for n in self._Ns:
            self._entity_slices.append(slice(index, index + n))
            index += n
        self._atom_indices = np.concatenate([g.ix for g in self._groups])
        self._n_blocks = n_blocks
        self._unwrap = unwrap
        if unwrap:
            # The image flags track every atom of the universe.
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
        # Host store of per-frame entity positions, filled one chunk
        # late by _store_chunk (the copy overlaps the next chunk).
        self._positions = np.empty((self.n_frames, self._N, 3))
        self._store_offset = 0

        device = self._device
        box = torch.as_tensor(self._dimensions, dtype=torch.float32,
                              device=device)
        unwrap = self._unwrap
        columns = None
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
            n = self.universe.atoms.n_atoms
            if not np.array_equal(self._columns, np.arange(n)):
                columns = torch.as_tensor(self._columns, device=device)
        else:
            self._carry = (
                torch.zeros((), device=device),
                torch.zeros((), device=device),
            )
        entities = _entity_positions_fn(self._groups, self._groupings,
                                        device)

        def update(carry, positions, dimensions, mask):
            # The port streams no padding frames, so every mask entry is
            # 1 and the unwrap scan runs over the whole chunk.
            del dimensions, mask
            if not unwrap:
                return carry, entities(positions)
            unwrapped, carry = unwrap_scan(
                positions, box, initial=carry[0], images=carry[1]
            )
            if columns is not None:
                unwrapped = unwrapped[:, columns]
            return carry, entities(unwrapped)

        self._update = update

    def _store_chunk(self, entities, batch) -> None:
        n_real = batch.n_real
        self._positions[
            self._store_offset:self._store_offset + n_real
        ] = entities[:n_real]
        self._store_offset += n_real

    def _conclude(self) -> None:
        device = self._device
        positions_all = self._positions[:self._n_frames]
        delete_dims = np.isclose(self._dimensions, 0)
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
                msd_cross[i] = msd_fft(p1.sum(dim=2), axis=1).cpu().numpy()
                # average=True reduces the power spectrum over particles
                # before the inverse FFT: one transform instead of N.
                msd_self[i1] = msd_fft(p1, axis=1, average=True).cpu().numpy()
            else:
                p2 = block_positions(i2)
                msd_cross[i] = msd_fft(
                    p1.sum(dim=2), p2.sum(dim=2), axis=1
                ).cpu().numpy()
        D = 2 * int((~delete_dims).sum())
        self.results.msd_cross = msd_cross / D
        self.results.msd_self = msd_self / D
