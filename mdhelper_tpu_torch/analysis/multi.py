"""
Fused multi-analysis streaming
==============================

:func:`run_together` reads the trajectory ONCE and folds every chunk
into several analyses' carries, so host reading and host-to-device
copies are paid once instead of once per analysis.  Ported from
:mod:`mdhelper_tpu.analysis.multi`; ``parallel=True`` shards the fused
stream's frames over the :mod:`torch.distributed` ranks, as
:class:`~mdhelper_tpu_torch.analysis.base.ParallelAnalysisBase` does.

An analysis with a per-frame shift table (``_frame_shifts``: a
``DensityProfile(recenter=..., parallel=True)``) gets each chunk's rows of
it subtracted from its own gathered columns on the device, in float64 and
rounded once to float32, as its own run subtracts them on the host: on
float32 positions (the in-memory reader's, XTC's) the fused profile
equals its standalone run.  The JAX package's fused pass
drops that shift and returns the profile without recentering.
"""

from typing import Sequence

import numpy as np
import torch

from .base import (
    ParallelAnalysisBase,
    SerialAnalysisBase,
    _Checkpoint,
    _refuse_unsharded,
    carry_from_numpy,
)

__all__ = ["run_together"]


def run_together(
    analyses: Sequence[SerialAnalysisBase],
    start: int = None,
    stop: int = None,
    step: int = None,
    frames=None,
    on_chunk=None,
    parallel: bool = False,
    checkpoint: str = None,
    initial=None,
):
    """Run several analyses over one shared trajectory stream.

    Parameters
    ----------
    analyses : sequence of analysis instances
        Carry-protocol analyses sharing the same trajectory reader and
        the same device.
    start, stop, step, frames
        Frame selection, as in ``run()``.
    on_chunk : callable, optional
        Called with each streamed batch after every analysis has folded
        it (under ranks: each rank's own blocks).
    parallel : bool, optional
        Shard the fused stream's frames over the ranks of the default
        process group (a world of one without one): each rank reads and
        folds its block of each chunk, and the carries and stores are
        reduced and gathered before the conclusions, as
        :class:`~mdhelper_tpu_torch.analysis.base.ParallelAnalysisBase`
        does.  An order-dependent analysis (``_sequential``: the Van Hove
        ring, Onsager, the ISF's lag ring, TICA, an unwrap scan) raises
        over more than one rank, as does a user subclass that does not
        declare that its carry and stores reduce over the ranks (not
        ``_rank_sharded``), and so does `initial` (the JAX package has no
        ``initial=``: ROADMAP Queue 3, item 18).  Per-analysis sharding
        knobs (``shard=``) are not supported in fused mode.
    checkpoint : str, optional
        A file path, used as given: every analysis's carry, the
        registered store buffers (keys prefixed ``{i}::``) and the
        stream position are written there after each chunk, and a pass
        whose checkpoint exists resumes at the first frame it has not
        folded (the contract of ``run(checkpoint=...)``; every store-type
        analysis must be registered).  Over ranks the file holds the
        whole job's state, as ``run(checkpoint=...)``'s does, and
        resumes over any number of ranks.
    initial : sequence, optional
        Per analysis, ``None`` or a carry of the JAX package's
        counterpart fetched as numpy, to continue a run that the JAX
        package started (see
        :func:`~mdhelper_tpu_torch.analysis.base.carry_from_numpy`);
        an order-dependent carry, such as the Van Hove ring and its
        frame counter, resumes where that run stopped.

    Returns
    -------
    analyses : the input sequence, with ``results`` populated as
        individual ``run()`` calls would have.
    """

    if not analyses:
        raise ValueError("No analyses given.")
    trajectory = analyses[0]._trajectory
    device = analyses[0]._device
    for a in analyses:
        if a._trajectory is not trajectory:
            raise ValueError(
                "All analyses must share the same trajectory reader."
            )
        if a._device != device:
            raise ValueError("All analyses must run on the same device.")
        if getattr(a, "_shard", None) not in (None, False):
            raise ValueError(
                "Sharding knobs are not supported in fused mode."
            )
    if initial is not None and len(initial) != len(analyses):
        raise ValueError("initial= needs one entry per analysis.")
    if initial is not None and checkpoint is not None:
        raise ValueError(
            "initial= and checkpoint= both set the starting carries; pass "
            "one of them."
        )
    # One stream, one payload: a velocity-payload analysis fused with
    # position analyses would be fed the wrong columns.
    payloads = {a._payload for a in analyses}
    if len(payloads) > 1:
        raise ValueError(
            "All fused analyses must stream the same coordinate "
            f"payload; got {sorted(payloads)}. Run the velocity-"
            "payload analyses in their own fused pass."
        )

    # The stream reads every atom and every column of the payload (3, or
    # 6 for positions and velocities); each analysis gathers its atoms
    # and, where it streams fewer when run alone, its columns.  Under
    # parallel=True it is a ParallelAnalysisBase's, over the ranks.
    shared = (ParallelAnalysisBase if parallel else SerialAnalysisBase)(
        trajectory, device=device)
    shared._setup_frames(
        trajectory, start=start, stop=stop, step=step, frames=frames
    )
    shared._mesh = shared._run_mesh()
    mesh = shared._mesh
    if mesh is not None and mesh.world > 1:
        for a in analyses:
            if a._sequential:
                raise ValueError(
                    f"{type(a).__name__} streams order-dependent physics "
                    "(a sequential carry) and cannot shard frames; run the "
                    "fused pass serially or move this analysis out of it."
                )
        for a in analyses:
            _refuse_unsharded(a, mesh.world)
        if initial is not None:
            raise NotImplementedError(
                f"initial= does not run over {mesh.world} ranks: a carry of "
                "the JAX package's run continues on one rank (the JAX "
                "package has no initial=; ROADMAP Queue 3, item 18)."
            )

    for i, a in enumerate(analyses):
        a._setup_frames(
            a._trajectory, start=start, stop=stop, step=step, frames=frames
        )
        a._mesh = None
        a._store_prefix = 0
        a._prepare()
        # The fused stream's ranks, which a store that checks itself over
        # them reads (SASA's occluder budget).
        a._mesh = mesh
        if initial is not None and initial[i] is not None:
            a._carry = carry_from_numpy(a, initial[i])

    parts = [a._fused_parts() for a in analyses]
    gathers = []
    for a in analyses:
        idx = a._effective_atom_indices()
        axes = a._coord_axes
        gathers.append((
            None if idx is None else torch.as_tensor(idx, device=device),
            None if axes is None else list(axes),
        ))

    def shifted(a, pos, batch, axes):
        """`pos` less the rows of ``a._frame_shifts`` of the batch's
        frames (its padded tail: the last frame's), columns `axes`."""

        pad = len(pos) - batch.n_real
        frames = np.concatenate(
            (batch.indices, np.repeat(batch.indices[-1:], pad)))
        rows = a._frame_shifts[frames][:, [0, 1, 2] if axes is None
                                       else axes]
        rows = torch.as_tensor(rows, device=pos.device)
        return (pos.to(torch.float64) - rows[:, None, :]).to(torch.float32)

    shared._payload = payloads.pop()
    shared._chunk_bytes = min(a._chunk_bytes for a in analyses)
    # The shared stream prefetches unless an analysis turned it off.
    shared._prefetch_batches = all(a._prefetch_batches for a in analyses)

    carries = [a._carry for a in analyses]
    done = 0
    if checkpoint is not None:
        for a in analyses:
            a._check_checkpointable()
        file = _Checkpoint(checkpoint, analyses, mesh, fused=True)
        carries, done = file.load(carries)
    shared._stream_from = done
    for batch in shared._stream_batches():
        for i, (a, (device_fn, absorb), (idx, axes)) in enumerate(
                zip(analyses, parts, gathers)):
            pos = batch.positions if idx is None else batch.positions[:, idx]
            if axes is not None:
                pos = pos[:, :, axes]
            if a._frame_shifts is not None:
                pos = shifted(a, pos, batch, axes)
            a._n_real = batch.n_real
            carries[i], aux = device_fn(
                carries[i], pos, batch.dimensions, batch.mask
            )
            if absorb is not None and aux is not None:
                absorb(aux, batch)
        if on_chunk is not None:
            on_chunk(batch)
        if checkpoint is not None:
            file.save(carries, shared._rank_rows, batch.chunk_end)
    if checkpoint is not None:
        file.finish(carries, shared._rank_rows, shared._chunk_ends)

    for a, carry in zip(analyses, carries):
        # Each analysis's carry and stores reduce as its own run()'s do.
        a._mesh = mesh
        a._finish_ranks(carry, shared._rank_rows)
        a._conclude()
    return analyses
