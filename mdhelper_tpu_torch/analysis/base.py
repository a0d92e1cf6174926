"""
Analysis base classes
=====================

The streaming runtime, ported from :mod:`mdhelper_tpu.analysis.base`.
Frames are a batch axis: the trajectory is read in fixed-size chunks of
``(B, N, 3)`` float32 coordinates, each chunk is copied to the
analysis's device, and a per-chunk ``_update(carry, positions,
dimensions, mask)`` folds it into an accumulator ("carry").  Store-type
analyses also return per-chunk extras, fetched to the host one chunk
late so the copy overlaps the next chunk's compute.

On a CUDA device the host side of a chunk goes through a pinned buffer
and a ``non_blocking`` copy on a side stream, one chunk ahead of the
compute; with ``_prefetch_batches`` (the default) a worker thread reads,
decodes and stages the next chunk while the current one is launched.
An analysis that reads only some coordinate columns names them in
``_coord_axes``: the chunk is sliced on the host before the pin and the
copy, and sized by the columns it carries.  ``_payload`` says what the
columns are: positions (the default), velocities, or both concatenated
on the last axis (``(B, N, 6)``: 0-2 positions, 3-5 velocities).
With ``run(checkpoint=path)`` the carry and the registered store
buffers are written to `path` after every chunk, and a later run with
the same path resumes at the first frame not yet folded.

:class:`ParallelAnalysisBase` (and ``parallel=True`` where an analysis
takes it) shards the frames over the ranks of :mod:`torch.distributed`,
one rank a device (:mod:`mdhelper_tpu_torch.parallel.mesh`): each chunk
holds a multiple of the shard count, rank *r* reads only its contiguous
block of it (a tail padded with the last frame under mask 0), on its
prefetch thread, and folds it into a carry of its own.  After the stream
every carry leaf, at any depth of its dicts, tuples and lists, is summed
over the ranks (``_carry_reductions`` names the subtrees reduced
otherwise), the per-frame stores (the buffers of ``_checkpoint_attrs``
and the ``results`` arrays of ``_result_stores``) are gathered in frame
order, and every rank concludes to the same results.  A per-frame shift
table (``_frame_shifts``: a recentered profile's centre-of-mass shifts,
from a host pre-pass) is subtracted from each chunk on the prefetch
thread, so an update that would otherwise be order-dependent shards.
An analysis may shard another axis instead (``_shard_axis``: the RDF's
atoms, the S(q)'s wavevectors), reading every frame on every rank.
Without a process group ``parallel=True`` runs as a world of one on the
analysis's device.  Order-dependent analyses (``_sequential``) and
analyses that do not declare that their carry and stores reduce over the
ranks (``_rank_sharded``: a user subclass that has not) refuse more than
one rank.

A checkpoint over ranks holds the whole job's state at a chunk boundary,
as a serial run's does: the carry reduced over the ranks, the stores
gathered in frame order and the frames done.  Every rank writes the path
it is given; ranks given one path leave it to the lowest of them, behind
a barrier.  On resume every rank loads its file, rank 0 keeps the
summed leaves and the restored store prefix, and the others start
those from zero, so a file resumes over any number of ranks.  The
resumed stream starts at the checkpoint's frame, so no chunk straddles
it.  There is no host pipeline.
"""

import logging
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Iterator

import numpy as np
import torch

from .._device import resolve_device
from ..core import profiling

__all__ = ["DynamicAnalysisBase", "Hash", "JittedAnalysisBase",
           "NumbaAnalysisBase", "ParallelAnalysisBase",
           "SerialAnalysisBase", "carry_from_numpy", "carry_leaves",
           "existence_lifetimes"]


def existence_lifetimes(h, device=None) -> tuple:
    """Intermittent correlation c(t) and continuous survival S(t)
    from a boolean existence series ``h`` of shape ``(T, P)`` (P
    independent bond/membership channels), both normalized to 1 at
    t = 0 (the JAX package's function).

    c(t) = <h(0)h(t)> / <h> (Luzar & Chandler 1996) -- with 0/1 data
    and the triangular normalization of
    :func:`~mdhelper_tpu_torch.algorithm.correlation.correlation_fft`,
    <h(0)h(0)> = <h>, so c is the channel-summed ACF over its t = 0
    value, correlated in float64 on `device` (default: the first CUDA
    device, raising `RuntimeError` without one; ``"cpu"`` for the CPU).

    S(t) counts only channels set at EVERY sample in [0, t]: a
    maximal run of L consecutive ones contributes ``max(L - t, 0)``
    origins at lag t, so with cnt[L] runs of each length,
    ``num(t) = sum_{L > t} cnt[L] (L - t)`` -- two reversed cumulative
    sums, O(T) after the run-length scan (host numpy).
    """

    from ..algorithm.correlation import correlation_fft

    device = resolve_device(device)
    h = np.asarray(h, dtype=bool)
    T, P = h.shape
    ever = h.any(axis=0)
    if not ever.any():
        empty = np.zeros(T)
        if T:
            empty[0] = 1.0
        return empty, empty.copy()
    h = h[:, ever]
    series = torch.as_tensor(h.astype(np.float64), device=device)
    acf = correlation_fft(series, axis=0).sum(dim=1).cpu().numpy()
    c = acf / acf[0]

    P = h.shape[1]
    # column-major flatten with a zero separator so every run closes
    # inside its own channel's series
    flat = np.concatenate(
        [h.T, np.zeros((P, 1), dtype=bool)], axis=1
    ).ravel()
    d = np.diff(np.concatenate([[0], flat.astype(np.int8)]))
    lengths = np.flatnonzero(d == -1) - np.flatnonzero(d == 1)
    cnt = np.bincount(lengths, minlength=T + 2).astype(np.float64)
    rev1 = np.append(np.cumsum(cnt[::-1])[::-1], 0.0)
    rev2 = np.append(
        np.cumsum((cnt * np.arange(len(cnt)))[::-1])[::-1], 0.0
    )
    t = np.arange(T)
    num = rev2[t + 1] - t * rev1[t + 1]
    S = num / (T - t)
    return c, S / S[0]


class Hash(dict):
    """A `dict` with attribute access; the results container."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if not isinstance(arg, dict):
                raise TypeError("Positional arguments must be dictionaries.")
            self.update(arg)
        self.update(kwargs)

    def __getattr__(self, name):
        return self.get(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


class _Batch:
    """One device-ready chunk of trajectory data."""

    __slots__ = ("positions", "dimensions", "mask", "indices", "n_real",
                 "host", "chunk_end")

    def __init__(self, positions, dimensions, mask, indices, chunk_end=None):
        self.positions = positions
        self.dimensions = dimensions
        self.mask = mask
        self.indices = indices
        # frames past n_real (a rank's padded tail) have mask 0
        self.n_real = len(indices)
        self.host = None
        # position in the frame selection where the batch's chunk ends
        self.chunk_end = chunk_end


def carry_from_numpy(analysis, tree):
    """The port's carry for a prepared `analysis` from a carry of the
    JAX package's counterpart whose leaves were fetched as numpy
    (``jax.tree.map(np.asarray, jax_analysis._carry)``).

    Leaves take the dtype and device of the port's own prepared carry,
    so a run can start in JAX and continue in the port (see
    ``run_together(..., initial=)``).  Dict carries may lack keys the
    port's carry has (the JAX RDF's XLA route keeps no ``"max_occ"``);
    those keep their prepared values.  An analysis whose state is more
    than its carry takes `tree` itself (``_carry_from_numpy``: the ISF's
    time-FFT store).
    """

    own = getattr(analysis, "_carry_from_numpy", None)
    if own is not None:
        return own(tree)
    return carry_leaves(analysis, tree)


def carry_leaves(analysis, tree):
    """:func:`carry_from_numpy` leaf by leaf: each leaf of `tree` in the
    dtype and on the device of the matching leaf of ``analysis._carry``,
    whose shape it must have."""

    template = analysis._carry
    name = type(analysis).__name__

    def leaf(value, like):
        value = np.array(value)
        if value.shape != tuple(like.shape):
            raise ValueError(
                f"{name}'s carry holds a {tuple(like.shape)} leaf, not "
                f"{value.shape}."
            )
        return torch.as_tensor(value).to(device=like.device,
                                         dtype=like.dtype)

    if isinstance(template, dict):
        unknown = set(tree) - set(template)
        if unknown:
            raise ValueError(f"{name} carries no {sorted(unknown)}.")
        return {
            key: leaf(tree[key], value) if key in tree else value
            for key, value in template.items()
        }
    if len(tree) != len(template):
        raise ValueError(
            f"{name}'s carry has {len(template)} leaves, not {len(tree)}."
        )
    return tuple(leaf(t, like) for t, like in zip(tree, template))


def _check_even_frame_spacing(frames) -> int:
    """Validate evenly spaced, forward-in-time frame selections (lag
    rings and MSDs index time in frame steps); returns the frame
    step."""

    df = np.diff(frames)
    if len(df) and (df[0] <= 0 or not np.allclose(df, df[0])):
        raise ValueError(
            "The selected frames must be evenly spaced and proceed "
            "forward in time."
        )
    return int(df[0]) if len(df) else 1


class SerialAnalysisBase:
    """Single-device streaming analysis driver.

    Subclasses implement :meth:`_prepare` (set ``self._carry`` and
    ``self._update``), optionally ``_store_chunk(extras, batch)`` (then
    ``_update`` returns ``(carry, extras)``), and :meth:`_conclude`.

    Parameters
    ----------
    trajectory : `TrajectoryReader`
        The stream's source.
    verbose : `bool`
        Log start and end of :meth:`run`.
    device : `torch.device` or `str`, optional
        Where the chunks are folded (default: the first CUDA device;
        raises `RuntimeError` without one).  Pass ``"cpu"`` to run on
        the CPU.
    """

    #: bytes of float32 coordinates per streamed chunk.
    _chunk_bytes: int = 128 << 20
    #: atom columns to read per frame (None = all atoms).
    _atom_indices = None
    #: what the stream carries: "positions", "velocities" (read through
    #: ``read_velocity_frames`` and ``read_dimension_frames``, never
    #: decoding positions) or "positions+velocities" (one
    #: ``read_frames_with_velocities`` call, concatenated on the last axis
    #: to ``(B, N, 6)``).
    _payload: str = "positions"
    #: columns of the payload to stream, in this order (None = all of
    #: them; 0-2 are positions, or velocities for a velocity payload, and
    #: 3-5 the velocities of "positions+velocities").
    _coord_axes = None
    #: read, cast, pin and start the copy of the next chunk on a worker
    #: thread while the current chunk is launched (a pipeline one chunk
    #: deep); false reads each chunk on the calling thread.
    _prefetch_batches: bool = True
    #: index in the frame selection where the stream starts (a resumed
    #: run's first frame not yet folded).
    _stream_from: int = 0
    #: host half of the chunk protocol (see the class docstring).
    _store_chunk = None
    _update = None
    #: order-dependent physics (a lag ring, an unwrap scan): the frames
    #: cannot be sharded, so a run over more than one rank raises.
    _sequential = False
    #: the carry reduces over the ranks (a sum, or ``_carry_reductions``),
    #: the update weights its frames by the mask, and the per-frame stores
    #: are the buffers of ``_checkpoint_attrs`` and the ``results`` arrays
    #: of ``_result_stores``: without it a run, fused or not, over more
    #: than one rank raises.
    _rank_sharded = False
    #: shard the frames over the ranks (``parallel=True``).
    _parallel = False
    #: the shard count asked for (``run(n_jobs=...)``; None: every rank).
    _n_jobs = None
    #: the axis sharded over the ranks: ``"frames"``, or ``"atoms"`` or
    #: ``"replicated"`` when the analysis shards something else itself
    #: (then every rank reads every frame).
    _shard_axis = "frames"
    #: carry keys not summed over the ranks: ``"max"``, or
    #: ``"replicated"`` for a leaf every rank already holds whole; a key
    #: names the reduction of every leaf under it.
    _carry_reductions = {}
    #: per-frame float64 shifts ``(trajectory frames, 3)`` subtracted from
    #: the position columns of every streamed chunk (None: none); see
    #: :meth:`_host_transform`.
    _frame_shifts = None
    #: frames of the chunk being folded that are not a rank's padding,
    #: set before each update (for an update that writes a store on the
    #: device, where reading the mask would wait for the device).
    _n_real = 0
    #: the ranks of the current run (None: a serial run), and the
    #: positions in the frame selection of the frames this rank streamed.
    _mesh = None
    _rank_rows = ()
    #: where each chunk of the current stream ends in the frame selection
    #: (every chunk's, also those that hold no frame of this rank).
    _chunk_ends = ()
    #: frames at the head of the store buffers that a resumed run over
    #: ranks restored on this rank (rank 0 holds the whole prefix, the
    #: others none), gathered before this rank's own.
    _store_prefix = 0

    def __init__(self, trajectory, verbose: bool = False, *, device=None,
                 **kwargs):
        self._trajectory = trajectory
        self._verbose = verbose
        self._device = resolve_device(device)
        self._pending_stores = []
        self.results = Hash()
        _ignore_kwargs(self, kwargs)

    # -- frame bookkeeping -------------------------------------------------
    def _setup_frames(self, trajectory=None, start=None, stop=None,
                      step=None, frames=None) -> None:
        trajectory = trajectory or self._trajectory
        if frames is not None:
            if start is not None or stop is not None or step is not None:
                raise ValueError(
                    "start/stop/step cannot be combined with frames."
                )
            self.frames = np.arange(trajectory.n_frames)[frames]
            self.start = self.stop = self.step = None
        else:
            start, stop, step = trajectory.check_slice_indices(
                start, stop, step
            )
            self.start, self.stop, self.step = start, stop, step
            self.frames = np.arange(start, stop, step)
        self.n_frames = len(self.frames)
        self.times = np.asarray(
            [trajectory._read_time(int(i)) for i in self.frames]
        )

    def _prepare(self) -> None:
        pass

    def _conclude(self) -> None:
        pass

    def _require_box(self, what: str) -> None:
        dims = self.universe.dimensions
        if dims is None or not (np.asarray(dims[:3]) > 0).all():
            raise ValueError(
                f"{what} needs a periodic box with non-zero "
                "dimensions (this universe has none)."
            )

    def _setup_periodic_box(self) -> None:
        """Set ``self._triclinic`` from the universe's box angles.
        Zero-length boxes are aperiodic, not triclinic."""

        dims = self.universe.dimensions
        self._triclinic = bool(
            dims is not None
            and len(dims) >= 6
            and (np.asarray(dims[:3]) > 0).all()
            and not np.allclose(dims[3:6], 90.0)
        )

    # -- ranks -------------------------------------------------------------
    def _n_shards(self) -> int:
        """Shards of the run: with ``parallel``, ``min(n_jobs or world,
        world, n_frames)`` (the JAX package's rule), else 1."""

        if not self._parallel:
            return 1
        from ..parallel.mesh import get_mesh

        world = get_mesh().world
        return max(1, min(self._n_jobs or world, world, self.n_frames or 1))

    def _run_mesh(self):
        """The ranks of a run (:class:`~mdhelper_tpu_torch.parallel.mesh.
        Mesh`), or None for a serial one."""

        if not self._parallel and self._shard_axis == "frames":
            return None
        from ..parallel.mesh import get_mesh

        return get_mesh(self._n_shards())

    def _check_ranks(self) -> None:
        """Refuse what does not run over more than one rank: an
        order-dependent analysis (the JAX package's multi-host refusal) and
        a user subclass that does not declare ``_rank_sharded``."""

        mesh = self._mesh
        if mesh is None or mesh.world == 1:
            return
        if self._sequential:
            raise NotImplementedError(
                "Order-dependent analyses (ISF ring buffers, unwrap scans) "
                f"stream on a single host: {type(self).__name__} cannot "
                f"shard frames over {mesh.world} ranks; run it with "
                "parallel=False."
            )
        _refuse_unsharded(self, mesh.world)

    def _reduce_rank_carry(self, carry):
        """The carry reduced over the ranks: each tensor leaf, at any depth
        of dicts, tuples and lists, summed, unless ``_carry_reductions``
        names another reduction for a dict key above it (the nearest such
        key holds for its whole subtree).  Other leaves are kept."""

        from ..parallel.mesh import all_reduce

        return self._map_rank_carry(
            carry, lambda value, op: all_reduce(value, op))

    def _map_rank_carry(self, carry, fn):
        """`carry` with each tensor leaf that is not ``"replicated"`` put
        through ``fn(leaf, op)``, `op` its reduction (``"sum"``, or the
        one that ``_carry_reductions`` names above it)."""

        reductions = self._carry_reductions

        def walk(value, op):
            if isinstance(value, dict):
                return {key: walk(leaf, reductions.get(key, op))
                        for key, leaf in value.items()}
            if isinstance(value, (tuple, list)):
                return type(value)(walk(leaf, op) for leaf in value)
            if op == "replicated" or not isinstance(value, torch.Tensor):
                return value
            return fn(value, op)

        return walk(carry, "sum")

    def _rank_checkpoint_carry(self, carry):
        """The whole job's carry for a checkpoint over ranks (every rank
        gets it): :meth:`_reduce_rank_carry`'s."""

        return self._reduce_rank_carry(carry)

    def _rank_resumed_carry(self, carry, rank: int):
        """Rank `rank`'s share of a whole job's carry that a checkpoint
        restored: rank 0 keeps it, the other ranks start the summed leaves
        from zero; ``"max"`` and ``"replicated"`` leaves stay on every
        rank."""

        if rank == 0:
            return carry
        return self._map_rank_carry(
            carry, lambda value, op: (torch.zeros_like(value)
                                      if op == "sum" else value))

    def _check_rank_stores(self) -> None:
        """A check of the absorbed stores that every rank must pass or
        fail together, made before each checkpoint save and the gather of
        a run over ranks (collectively: every rank calls it).  Subclasses
        whose store check raises override (SASA's occluder budget)."""

    def _finish_ranks(self, carry, rows) -> None:
        """End of a stream: keep `carry` (reduced over the ranks in a
        grouped run), absorb the queued stores, and in a grouped
        frame-sharded run gather them (`rows` as
        :meth:`_gather_rank_stores` takes them)."""

        mesh = self._mesh
        grouped = mesh is not None and mesh.grouped
        self._carry = self._reduce_rank_carry(carry) if grouped else carry
        self._drain_stores()
        if grouped:
            self._check_rank_stores()
        if grouped and self._shard_axis == "frames":
            self._gather_rank_stores(rows)

    def _result_stores(self) -> dict:
        """``results`` keys of the per-frame arrays a run fills in the
        order it streams its frames (from index 0 of their frame axis),
        each with its frame axis; a key whose value is a list names each
        array of it.  Over ranks they are gathered as the buffers of
        :meth:`_checkpoint_attrs` are.  Subclasses with such arrays
        override."""

        return {}

    def _gathered_stores(self, rows) -> tuple:
        """``(buffers, results, frames)``: the per-frame stores this rank
        filled (the buffers named by :meth:`_checkpoint_attrs` and the
        ``results`` arrays of :meth:`_result_stores`, indices ``[0,
        _store_offset)`` of their frame axis, of which the first
        ``_store_prefix`` are a restored checkpoint's) reassembled into
        every rank's, in frame order, on every rank, and how many frames
        they hold.  `rows` holds the positions in the frame selection of
        this rank's streamed frames, in the order it stored them; entries
        past those frames are ignored."""

        from ..parallel.mesh import all_gather_tiles

        offset = int(getattr(self, "_store_offset", 0))
        local = np.concatenate(
            [np.arange(self._store_prefix)] + list(rows)).astype(np.int64)
        order = all_gather_tiles(torch.as_tensor(local[:offset])).numpy()

        def gathered(buffer, axis=0):
            if isinstance(buffer, torch.Tensor):
                mine = buffer.movedim(axis, 0)[:offset]
                tiles = all_gather_tiles(mine.contiguous())
                full = torch.empty_like(buffer)
                full.movedim(axis, 0)[
                    torch.as_tensor(order, device=full.device)] = tiles
                return full
            mine = np.moveaxis(buffer, axis, 0)[:offset]
            tiles = all_gather_tiles(torch.as_tensor(
                np.ascontiguousarray(mine)))
            full = np.empty_like(buffer)
            np.moveaxis(full, axis, 0)[order] = tiles.numpy()
            return full

        buffers = {attr: gathered(getattr(self, attr))
                   for attr in self._checkpoint_attrs()}
        results = {}
        for key, axis in self._result_stores().items():
            value = self.results[key]
            results[key] = ([gathered(v, axis) for v in value]
                            if isinstance(value, list)
                            else gathered(value, axis))
        return buffers, results, len(order)

    def _gather_rank_stores(self, rows) -> None:
        """Replace this rank's per-frame stores by every rank's, in frame
        order (:meth:`_gathered_stores`)."""

        if not self._checkpoint_attrs() and not self._result_stores():
            return
        buffers, results, frames = self._gathered_stores(rows)
        for attr, value in buffers.items():
            setattr(self, attr, value)
        self.results.update(results)
        self._store_offset = frames
        self._store_prefix = 0

    def _rank_store_state(self, rows) -> dict:
        """:meth:`_store_state` of the whole job over ranks (collectively:
        every rank calls it): the stores gathered in frame order, as
        :meth:`_gather_rank_stores` gathers them; this rank's own stay as
        they are."""

        if not self._checkpoint_attrs() and not self._result_stores():
            return self._store_state()
        buffers, results, frames = self._gathered_stores(rows)
        state = {"__store_offset__": np.int64(frames)}
        for key, value in self.results.items():
            value = results.get(key, value)
            if isinstance(value, np.ndarray) and value.dtype != object:
                state[f"results::{key}"] = value
        for attr, value in buffers.items():
            value = value[:frames]
            if isinstance(value, torch.Tensor):
                value = value.cpu().numpy()
            state[f"attr::{attr}"] = value
        return state

    # -- chunk protocol ----------------------------------------------------
    def _batched_update(self, carry, batch: _Batch):
        """Fold one chunk into the carry; store extras (unless None) are
        queued and absorbed one chunk late."""

        self._n_real = batch.n_real
        with profiling.span("fold", analysis=type(self).__name__,
                            frames=batch.n_real):
            out = self._update(
                carry, batch.positions, batch.dimensions, batch.mask
            )
        if self._store_chunk is None:
            return out
        carry, extras = out
        if extras is not None:
            self._queue_store(extras, batch)
        return carry

    def _queue_store(self, extras, batch: _Batch) -> None:
        """Start the device-to-host copy of one chunk's extras (a tensor,
        or a tuple or list of tensors), then absorb the previously queued
        chunk, whose copy has had a chunk of compute to finish."""

        parts = extras if isinstance(extras, (tuple, list)) else (extras,)
        with profiling.span("store.queue",
                            bytes=sum(part.nbytes for part in parts)):
            event = cuda = None
            host = []
            for part in parts:
                if part.device.type == "cuda":
                    cuda = part.device
                    pinned = torch.empty(part.shape, dtype=part.dtype,
                                         pin_memory=True)
                    pinned.copy_(part, non_blocking=True)
                    part = pinned
                host.append(part)
            if cuda is not None:
                # One event after the last copy covers them all.
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(cuda))
            if isinstance(extras, (tuple, list)):
                host = type(extras)(host)
            else:
                host = host[0]
            self._drain_stores()
            self._pending_stores.append((host, event, batch))

    def _drain_stores(self) -> None:
        with profiling.span("store.drain"):
            for extras, event, batch in self._pending_stores:
                if event is not None:
                    event.synchronize()
                if isinstance(extras, (tuple, list)):
                    extras = type(extras)(part.numpy() for part in extras)
                else:
                    extras = extras.numpy()
                self._store_chunk(extras, batch)
            self._pending_stores.clear()

    def _effective_atom_indices(self):
        """``_atom_indices``, with the identity selection normalized to
        ``None`` (an identity gather would copy every chunk)."""

        idx = self._atom_indices
        if idx is None:
            return None
        n = self._trajectory.n_atoms
        if len(idx) == n and np.array_equal(idx, np.arange(n)):
            return None
        return idx

    def _payload_width(self) -> int:
        """Columns of the payload before ``_coord_axes`` slices it: 3, or
        6 for "positions+velocities"."""

        return 6 if self._payload == "positions+velocities" else 3

    def _read_payload(self, block) -> tuple:
        """``(payload (F, N, width), dimensions (F, 6))`` of one frame
        block, as ``_payload`` says."""

        trajectory = self._trajectory
        if self._payload == "velocities":
            return (trajectory.read_velocity_frames(block),
                    trajectory.read_dimension_frames(block))
        if self._payload == "positions+velocities":
            # One call decodes each frame once (a TRR frame holds both).
            positions, velocities, dimensions = (
                trajectory.read_frames_with_velocities(block))
            return (np.concatenate([positions, velocities], axis=-1),
                    dimensions)
        return trajectory.read_frames(block)

    def _host_transform(self, positions, frames):
        """A chunk's positions ``(F, N, C)`` as read, after the atom and
        column gather (columns ``_coord_axes`` of the positions, or all
        three), with each frame's row of ``_frame_shifts`` subtracted:
        in float64, rounded once to float32.  `frames` are the chunk's
        frame indices."""

        columns = [0, 1, 2] if self._coord_axes is None else self._coord_axes
        shifts = self._frame_shifts[np.asarray(frames)][:, columns]
        return (np.asarray(positions, dtype=np.float64)
                - shifts[:, None, :]).astype(np.float32)

    def _stream_batches(self) -> Iterator[_Batch]:
        """Stream the selected frames from index ``_stream_from`` of the
        selection on, in chunks of ``_chunk_bytes`` of
        float32 payload columns (those of ``_coord_axes``, or all of the
        payload's), each read, sliced, cast, pinned and copied to the
        device one chunk ahead of the compute: on a worker thread while
        the consumer launches the chunk before it when
        ``_prefetch_batches`` is set, else on the calling thread before
        it yields that chunk.  Chunks arrive in frame order either
        way.

        Under a frame-sharded run (``_mesh`` with ``_shard_axis ==
        "frames"``) a chunk holds a multiple of the shard count, and this
        rank reads and yields only its block of each chunk
        (:func:`~mdhelper_tpu_torch.parallel.mesh.process_frame_block` of
        the chunk padded to that multiple), padded with its last frame
        under mask 0 to the block's length; ``_rank_rows`` collects the
        positions of its frames in the selection, and ``_chunk_ends`` where
        every chunk ends in it.  With ``_frame_shifts``
        each chunk's real frames go through :meth:`_host_transform`
        before the padding."""

        device = self._device
        atom_indices = self._effective_atom_indices()
        n_atoms = (
            len(atom_indices) if atom_indices is not None
            else self._trajectory.n_atoms
        )
        axes = (None if self._coord_axes is None
                else np.asarray(self._coord_axes, dtype=np.intp))
        n_columns = self._payload_width() if axes is None else len(axes)
        chunk = max(1, self._chunk_bytes // max(n_atoms * n_columns * 4, 1))
        mesh = self._mesh if self._shard_axis == "frames" else None
        if mesh is not None:
            chunk = max(mesh.size, chunk - chunk % mesh.size)
        self._rank_rows = []
        self._chunk_ends = []
        blocks = []
        for lo in range(self._stream_from, self.n_frames, chunk):
            block = self.frames[lo:lo + chunk]
            end = lo + len(block)
            self._chunk_ends.append(end)
            if mesh is None:
                blocks.append((block, 0, end))
                continue
            from ..parallel.mesh import process_frame_block

            first, last = process_frame_block(
                len(block) + (-len(block)) % mesh.size, mesh)
            local = block[first:min(last, len(block))]
            if len(local):
                blocks.append((local, last - first - len(local), end))
                self._rank_rows.append(
                    np.arange(lo + first, lo + first + len(local)))
        cuda = device.type == "cuda"
        copy_stream = torch.cuda.Stream(device) if cuda else None

        def stage(planned):
            block, pad, end = planned
            positions, dimensions = self._read_payload(block)
            if atom_indices is not None and axes is not None:
                # One gather of the wanted atoms' wanted columns.
                positions = positions[:, np.asarray(atom_indices)[:, None],
                                      axes]
            elif atom_indices is not None:
                positions = positions[:, atom_indices]
            elif axes is not None:
                positions = positions[:, :, axes]
            if self._frame_shifts is not None:
                positions = self._host_transform(positions, block)
            pos = torch.from_numpy(
                np.ascontiguousarray(positions, dtype=np.float32)
            )
            dims = torch.from_numpy(
                np.ascontiguousarray(dimensions, dtype=np.float64)
            )
            mask = torch.ones(len(block) + pad, dtype=torch.float64)
            if pad:
                # A rank's padded tail: its last frame again, masked out.
                pos = torch.cat((pos, pos[-1:].expand(pad, -1, -1)))
                dims = torch.cat((dims, dims[-1:].expand(pad, -1)))
                mask[len(block):] = 0.0
            if not cuda:
                return _Batch(pos, dims, mask, block, end)
            host = (pos.pin_memory(), dims.pin_memory(), mask.pin_memory())
            with torch.cuda.stream(copy_stream):
                pos, dims, mask = (part.to(device, non_blocking=True)
                                   for part in host)
            batch = _Batch(pos, dims, mask, block, end)
            # The pinned sources live as long as the batch.
            batch.host = host
            return batch

        def consume(batch):
            if cuda:
                compute = torch.cuda.current_stream(device)
                compute.wait_stream(copy_stream)
                # The allocator must not reuse these buffers until the
                # compute stream is done with them.
                batch.positions.record_stream(compute)
                batch.dimensions.record_stream(compute)
                batch.mask.record_stream(compute)
            return batch

        if not blocks:
            return
        def wait(i):
            """The span of the consumer's wait for chunk `i`."""

            return profiling.span("stream.wait", chunk=i,
                                  frames=len(blocks[i][0]))

        if not self._prefetch_batches:
            with wait(0):
                staged = stage(blocks[0])
            for i in range(len(blocks)):
                batch = consume(staged)
                staged = None
                if i + 1 < len(blocks):
                    with wait(i + 1):
                        staged = stage(blocks[i + 1])
                yield batch
            return
        # One worker, one chunk deep: it reads chunk n + 1 (the XTC
        # reader's own decode threads run inside it) and starts its copy
        # while the consumer launches chunk n.
        with ThreadPoolExecutor(max_workers=1) as worker:
            future = worker.submit(stage, blocks[0])
            for i in range(len(blocks)):
                with wait(i):
                    staged = future.result()
                batch = consume(staged)
                if i + 1 < len(blocks):
                    future = worker.submit(stage, blocks[i + 1])
                yield batch

    def _fused_parts(self):
        """``(device_fn, absorb)`` for fused streaming
        (:func:`mdhelper_tpu_torch.analysis.multi.run_together`):
        ``device_fn(carry, positions, dimensions, mask) -> (carry,
        extras)`` and the host absorb of the extras (or ``None``)."""

        update = self._update
        if self._store_chunk is not None:
            return update, self._queue_store

        def device_fn(carry, positions, dimensions, mask):
            return update(carry, positions, dimensions, mask), None

        return device_fn, None

    # -- checkpoints -------------------------------------------------------
    #: Analyses whose state beyond the carry is fully captured by
    #: :meth:`_store_state` (every per-frame buffer is either a
    #: frame-leading numeric array in ``results`` or named by
    #: :meth:`_checkpoint_attrs`) opt in by setting this true; their store
    #: state is saved with the carry.  ``run(checkpoint=...)`` refuses a
    #: store-type analysis that has not, rather than checkpoint half its
    #: state.
    _checkpointable_stores: bool = False

    def _checkpoint_attrs(self) -> tuple:
        """Names of the private frame-leading buffers (numpy arrays, or
        tensors on the analysis's device) that a run fills beyond the
        ``results`` arrays, persisted by checkpoints.  Subclasses with
        such buffers override."""

        return ()

    def _check_checkpointable(self) -> None:
        """Raise `ValueError` before streaming if this analysis cannot be
        checkpointed (a store-type analysis whose buffers are not
        registered)."""

        if self._store_chunk is not None and not self._checkpointable_stores:
            raise ValueError(
                "Checkpointing is not supported for this "
                "analysis: its per-frame host buffers are "
                "not registered for checkpointing (see "
                "SerialAnalysisBase._checkpointable_"
                "stores)."
            )

    def _store_state(self) -> dict:
        """Store state for :func:`~mdhelper_tpu_torch.core.checkpoint.
        save_carry`: the store offset, every numeric array in ``results``
        (per-frame buffers restore their filled prefix; static arrays
        round-trip unchanged), and the filled prefix of each buffer named
        by :meth:`_checkpoint_attrs`."""

        offset = int(getattr(self, "_store_offset", 0))
        state = {"__store_offset__": np.int64(offset)}
        for key, value in self.results.items():
            if isinstance(value, np.ndarray) and value.dtype != object:
                state[f"results::{key}"] = value
        for attr in self._checkpoint_attrs():
            value = getattr(self, attr, None)
            if value is not None:
                # Frame-leading by construction: a chunk's checkpoint
                # costs O(frames done), not O(n_frames).
                value = value[:offset]
                if isinstance(value, torch.Tensor):
                    value = value.cpu().numpy()
                state[f"attr::{attr}"] = value
        return state

    def _restore_store_state(self, stores: dict) -> None:
        """Restore :meth:`_store_state` into this run's freshly prepared
        buffers.  Arrays restore into the leading prefix, so a partial
        run's checkpoint resumes into a longer frame selection."""

        stores = dict(stores)
        offset = stores.pop("__store_offset__", None)
        if offset is not None:
            self._store_offset = int(offset)

        def restore(dst, src, name):
            if (
                not isinstance(dst, (np.ndarray, torch.Tensor))
                or tuple(dst.shape[1:]) != src.shape[1:]
                or dst.shape[0] < src.shape[0]
            ):
                raise ValueError(
                    f"Checkpointed store {name!r} (shape {src.shape}) "
                    "is incompatible with this run's frame selection "
                    f"(buffer shape {getattr(dst, 'shape', None)}); "
                    "resume with the same analysis configuration and "
                    "a frame selection extending the original."
                )
            if isinstance(dst, torch.Tensor):
                src = torch.as_tensor(src).to(device=dst.device,
                                              dtype=dst.dtype)
            dst[:len(src)] = src

        for key, value in stores.items():
            kind, _, name = key.partition("::")
            if kind == "results":
                restore(self.results.get(name), value, name)
            else:
                restore(getattr(self, name, None), value, name)

    def save(self, file, archive: bool = True, compress: bool = True,
             **kwargs) -> None:
        """Save ``results`` to ``.npz`` (compressed unless `compress` is
        false) or, without `archive`, one ``.npy`` a key; tensors are
        saved as numpy arrays."""

        data = {
            key: value.cpu().numpy() if isinstance(value, torch.Tensor)
            else value
            for key, value in self.results.items()
        }
        if archive and compress:
            np.savez_compressed(file, **data, **kwargs)
        elif archive:
            np.savez(file, **data, **kwargs)
        else:
            for key, value in data.items():
                np.save(f"{file}_{key}", value, **kwargs)

    # -- driver ------------------------------------------------------------
    def run(self, start: int = None, stop: int = None, step: int = None,
            frames=None, verbose: bool = None, checkpoint: str = None,
            **kwargs):
        """Run the analysis over the selected frames.

        With `checkpoint` set (a file path, used as given: no ``.npz`` is
        added), the carry and the registered store buffers are written
        there after every streamed chunk, and a run whose checkpoint
        exists resumes at the first frame it has not folded.  A
        store-type analysis whose buffers are not registered raises
        `ValueError` before streaming.  Over ranks the file holds the
        whole job's state (see the module docstring), so it resumes over
        any number of ranks, or serially.  Other keyword arguments (the
        JAX runner's) are accepted and ignored.

        A rank-sharded run (see the module docstring) reduces the carry
        and gathers the stores over the ranks before the conclusion, so
        every rank concludes to the same results.
        """

        verbose = self._verbose if verbose is None else verbose
        _ignore_kwargs(self, kwargs, "run")
        if verbose:
            time_start = datetime.now()
            logging.info(f"Starting {type(self).__name__} analysis...")
        self._setup_frames(
            self._trajectory, start=start, stop=stop, step=step,
            frames=frames,
        )
        self._mesh = self._run_mesh()
        self._check_ranks()
        self._store_prefix = 0
        name = type(self).__name__
        with profiling.span("pass", analyses=name, frames=self.n_frames):
            with profiling.span("prepare", analysis=name):
                self._prepare()
            carry = self._carry
            done = 0
            if checkpoint is not None:
                self._check_checkpointable()
                file = _Checkpoint(checkpoint, [self], self._mesh, fused=False)
                (carry,), done = file.load([carry])
            # A resumed run streams from the checkpoint's frame on: no chunk
            # straddles it, so no update sees a frame twice.
            self._stream_from = done
            for batch in self._stream_batches():
                carry = self._batched_update(carry, batch)
                if checkpoint is not None:
                    file.save([carry], self._rank_rows, batch.chunk_end)
            if checkpoint is not None:
                file.finish([carry], self._rank_rows, self._chunk_ends)
            self._finish_ranks(carry, self._rank_rows)
            with profiling.span("conclude", analysis=name):
                self._conclude()
        if verbose:
            logging.info(
                f"Analysis finished in {datetime.now() - time_start}."
            )
        return self


class _Checkpoint:
    """The checkpoint file of one run (`analyses` of one, ``fused=False``)
    or fused pass (``fused=True``: the carries as a tuple, the store keys
    prefixed ``{i}::``) at `path`, over the ranks of `mesh` or serially.

    Over ranks a save writes the whole job's state (each analysis's
    :meth:`SerialAnalysisBase._rank_checkpoint_carry` and
    :meth:`SerialAnalysisBase._rank_store_state`) and a load hands each
    rank its share (:meth:`SerialAnalysisBase._rank_resumed_carry`; the
    restored store prefix on rank 0 alone).  Every rank writes the path it
    is given, unless a lower rank was given the same one; when any path is
    shared, every save ends at a barrier, so no rank reads a file that is
    being written."""

    def __init__(self, path, analyses, mesh, *, fused: bool):
        self.path = path
        self.analyses = analyses
        self.fused = fused
        self.mesh = mesh
        self.grouped = mesh is not None and mesh.grouped
        self.writes, self.shared = True, False
        self.saved = 0
        if self.grouped and mesh.world > 1:
            import torch.distributed as dist

            mine = os.path.abspath(path)
            paths = [None] * mesh.world
            dist.all_gather_object(paths, mine)
            self.writes = mine not in paths[:mesh.rank]
            self.shared = len(set(paths)) < len(paths)

    def _agreed(self, done):
        """`done` (None: no file) agreed over the ranks; a `ValueError`
        on every rank when their files disagree."""

        if not (self.grouped and self.mesh.world > 1):
            return done
        import torch.distributed as dist

        every = [None] * self.mesh.world
        dist.all_gather_object(every, done)
        if len(set(every)) > 1:
            raise ValueError(
                f"The ranks' checkpoints disagree (frames done by rank, "
                f"None for no file: {every}); give every rank a file of one "
                "job, or none."
            )
        return done

    def load(self, carries):
        """``(carries, frames done)``: the prepared `carries`, or those
        the file holds (this rank's share of them over ranks), with the
        store state restored into the analyses."""

        from ..core.checkpoint import load_carry

        exists = os.path.exists(self.path)
        if exists:
            loaded, done, stores = load_carry(
                self.path, tuple(carries) if self.fused else carries[0],
                with_stores=True)
        if self._agreed(done if exists else None) is None:
            return carries, 0
        loaded = list(loaded) if self.fused else [loaded]
        for i, a in enumerate(self.analyses):
            prefix = f"{i}::" if self.fused else ""
            sub = {key[len(prefix):]: value for key, value in stores.items()
                   if key.startswith(prefix)}
            if sub:
                a._restore_store_state(sub)
            if self.grouped:
                loaded[i] = a._rank_resumed_carry(loaded[i], self.mesh.rank)
                offset = int(getattr(a, "_store_offset", 0))
                if self.mesh.rank == 0:
                    a._store_prefix = offset
                elif hasattr(a, "_store_offset"):
                    a._store_offset = 0
        logging.info(f"Resuming from {self.path} at frame {done}.")
        return loaded, done

    def save(self, carries, rows, done) -> None:
        """Write the state after the chunk that ends at position `done`
        of the frame selection (collectively over ranks)."""

        states = {}
        whole = []
        for i, (a, carry) in enumerate(zip(self.analyses, carries)):
            # The store queue is one chunk late: absorb this chunk's
            # extras before the buffers are saved with it.
            a._drain_stores()
            if self.grouped:
                carry = a._rank_checkpoint_carry(carry)
                a._check_rank_stores()
            whole.append(carry)
            if a._checkpointable_stores:
                state = (a._rank_store_state(rows)
                         if self.grouped and a._shard_axis == "frames"
                         else a._store_state())
                prefix = f"{i}::" if self.fused else ""
                states.update({f"{prefix}{key}": value
                               for key, value in state.items()})
        if self.writes:
            from ..core.checkpoint import save_carry

            save_carry(self.path, tuple(whole) if self.fused else whole[0],
                       done, stores=states or None)
        if self.shared:
            import torch.distributed as dist

            dist.barrier()
        self.saved += 1

    def finish(self, carries, rows, chunk_ends) -> None:
        """After the stream: the saves of the chunks that held no frame of
        this rank (the last chunk's, where its block is empty), which the
        other ranks made."""

        for done in chunk_ends[self.saved:]:
            self.save(carries, rows, done)


def _ignore_kwargs(analysis, kwargs, where="__init__") -> None:
    """Log (at debug level) keyword arguments that are accepted, as the JAX
    package accepts them, and ignored."""

    if kwargs:
        logging.debug(
            f"{type(analysis).__name__}.{where} ignores {sorted(kwargs)}: "
            "accepted for compatibility with the JAX package."
        )


def _unsharded_message(analysis, what: str) -> str:
    return (
        f"{type(analysis).__name__} does not declare that its carry and "
        f"stores reduce over ranks, so {what}.  A subclass declares it "
        "with _rank_sharded = True once its carry sums over the frames (or "
        "names its other reductions in _carry_reductions), its update "
        "weights the frames by the mask (a rank's padded tail has mask 0) "
        "and its per-frame stores are the buffers of _checkpoint_attrs and "
        "the results arrays of _result_stores."
    )


def _refuse_unsharded(analysis, world: int) -> None:
    """Raise unless `analysis` declares ``_rank_sharded``: its carry and
    stores would not be reduced right over `world` ranks."""

    if not analysis._rank_sharded:
        raise NotImplementedError(_unsharded_message(
            analysis, f"it cannot run over {world} ranks; run it on one"))


class NumbaAnalysisBase(SerialAnalysisBase):
    """The JAX package's parity shim for a thread-pooled base: ``run``
    takes ``n_threads`` and ignores it with a warning (CUDA and PyTorch
    schedule the device's threads), and otherwise runs as
    :meth:`SerialAnalysisBase.run`, ``checkpoint=`` and a rank-sharded
    run included."""

    def run(self, start: int = None, stop: int = None, step: int = None,
            frames=None, n_threads: int = None, verbose: bool = None,
            **kwargs) -> "NumbaAnalysisBase":
        if n_threads is not None:
            warnings.warn(
                "n_threads is accepted for API parity but ignored: CUDA "
                "and PyTorch manage device parallelism (like the "
                "n_batches no-op).",
                stacklevel=2,
            )
        return super().run(start=start, stop=stop, step=step,
                           frames=frames, verbose=verbose, **kwargs)


#: The JAX package's other name for the shim.
JittedAnalysisBase = NumbaAnalysisBase


class ParallelAnalysisBase(SerialAnalysisBase):
    """Frame-parallel analysis over the ranks of :mod:`torch.distributed`
    (the JAX package's class, which shards over a device mesh): each
    chunk's frames are split into contiguous blocks, one a rank, each rank
    folds its block into its own carry, and the carries are reduced over
    the ranks at the end (see the module docstring).  Without a process
    group it runs as a world of one.

    ``run(n_jobs=...)`` caps the shard count; ``module=`` is checked as
    the JAX package checks it and otherwise ignored (the ranks are the
    workers).  The JAX run's ``block=`` and ``method=`` (its worker
    pool's options) are not taken.  Other keyword arguments, of the
    constructor and of :meth:`run`, are accepted and ignored, as the JAX
    package ignores them.

    A subclass runs over more than one rank once it sets
    ``_rank_sharded = True``: its carry sums over frames (or names its
    other reductions in ``_carry_reductions``), its update weights the
    frames by the mask (a rank's padded tail has mask 0), and its per-frame
    stores are the buffers of ``_checkpoint_attrs`` and the ``results``
    arrays of ``_result_stores``.
    """

    def __init__(self, trajectory, verbose: bool = False, *, device=None,
                 **kwargs):
        super().__init__(trajectory, verbose, device=device, **kwargs)
        self._parallel = True
        self._n_jobs = None

    def run(self, start: int = None, stop: int = None, step: int = None,
            frames=None, verbose: bool = None, n_jobs: int = None,
            module: str = None, **kwargs):
        """Run over the selected frames, sharded over at most `n_jobs`
        ranks (default: every rank); `kwargs` go to
        :meth:`SerialAnalysisBase.run` (``checkpoint=``)."""

        if module not in (None, "multiprocessing", "joblib", "dask"):
            raise ValueError(f"Invalid parallelization module: {module}.")
        if module is not None:
            logging.debug(
                f"module={module!r} is accepted for API compatibility; the "
                "frames are sharded over the torch.distributed ranks."
            )
        self._n_jobs = n_jobs
        return SerialAnalysisBase.run(
            self, start=start, stop=stop, step=step, frames=frames,
            verbose=verbose, **kwargs,
        )


class DynamicAnalysisBase(ParallelAnalysisBase):
    """Serial or frame-parallel (``parallel=True``) analysis: the JAX
    package's switchable base.  ``parallel=False`` runs as
    :class:`SerialAnalysisBase`, ``parallel=True`` as
    :class:`ParallelAnalysisBase`.

    Every frame-parallel class of the package sets ``_rank_sharded =
    True`` (see :class:`ParallelAnalysisBase`) and takes ``parallel=True``
    over any number of ranks; an order-dependent one (``_sequential``:
    TICA's lag ring) takes it on one rank and raises over more, as the
    JAX package runs it unsharded.  A subclass that sets neither raises
    `NotImplementedError` for ``parallel=True``."""

    def __init__(self, trajectory, parallel: bool, verbose: bool = False,
                 *, device=None, **kwargs):
        if parallel and not (self._rank_sharded or self._sequential):
            raise NotImplementedError(_unsharded_message(
                self, "it takes no parallel=True; run it with "
                "parallel=False"))
        super().__init__(trajectory, verbose, device=device, **kwargs)
        self._parallel = bool(parallel)

    def run(self, start: int = None, stop: int = None, step: int = None,
            frames=None, verbose: bool = None, **kwargs):
        """:meth:`ParallelAnalysisBase.run` with ``parallel=True`` (which
        takes ``n_jobs=`` and the rest), else
        :meth:`SerialAnalysisBase.run`."""

        base = ParallelAnalysisBase if self._parallel else SerialAnalysisBase
        return base.run(self, start=start, stop=stop, step=step,
                        frames=frames, verbose=verbose, **kwargs)

    def _uniform_lag_dt(self, what: str) -> float:
        """Lag-grid spacing (ps) for the correlators' conclusions: the
        trajectory's ``dt`` times the (required-uniform) frame stride.
        Raises for non-uniform frame selections -- the FFT correlator
        silently assumes an even grid."""

        steps = np.diff(self.frames)
        if len(steps) and not np.all(steps == steps[0]):
            raise ValueError(
                f"{what} needs uniformly spaced frames (the "
                "Wiener-Khinchin correlator assumes a constant lag "
                "grid); got a non-uniform frame selection."
            )
        stride = int(steps[0]) if len(steps) else 1
        return self._trajectory.dt * stride
