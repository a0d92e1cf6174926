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
copy, and sized by the columns it carries.
The port runs on one device; there is no frame sharding, host
pipeline, multi-host mode or checkpointing yet
(:class:`DynamicAnalysisBase` takes ``parallel=False`` only).
"""

import logging
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Iterator

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["DynamicAnalysisBase", "Hash", "SerialAnalysisBase",
           "carry_from_numpy", "carry_leaves", "existence_lifetimes"]


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
                 "host")

    def __init__(self, positions, dimensions, mask, indices):
        self.positions = positions
        self.dimensions = dimensions
        self.mask = mask
        self.indices = indices
        self.n_real = len(indices)
        self.host = None


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
    #: coordinate columns to stream, in this order (None = x, y and z).
    _coord_axes = None
    #: read, cast, pin and start the copy of the next chunk on a worker
    #: thread while the current chunk is launched (a pipeline one chunk
    #: deep); false reads each chunk on the calling thread.
    _prefetch_batches: bool = True
    #: host half of the chunk protocol (see the class docstring).
    _store_chunk = None
    _update = None

    def __init__(self, trajectory, verbose: bool = False, *, device=None):
        self._trajectory = trajectory
        self._verbose = verbose
        self._device = resolve_device(device)
        self._pending_stores = []
        self.results = Hash()

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

    # -- chunk protocol ----------------------------------------------------
    def _batched_update(self, carry, batch: _Batch):
        """Fold one chunk into the carry; store extras (unless None) are
        queued and absorbed one chunk late."""

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

    def _stream_batches(self) -> Iterator[_Batch]:
        """Stream the selected frames in chunks of ``_chunk_bytes`` of
        float32 coordinates (the columns of ``_coord_axes``, or all
        three), each read, sliced, cast, pinned and copied to the
        device one chunk ahead of the compute: on a worker thread while
        the consumer launches the chunk before it when
        ``_prefetch_batches`` is set, else on the calling thread before
        it yields that chunk.  Chunks arrive in frame order either
        way."""

        device = self._device
        atom_indices = self._effective_atom_indices()
        n_atoms = (
            len(atom_indices) if atom_indices is not None
            else self._trajectory.n_atoms
        )
        axes = (None if self._coord_axes is None
                else np.asarray(self._coord_axes, dtype=np.intp))
        n_columns = 3 if axes is None else len(axes)
        chunk = max(1, self._chunk_bytes // max(n_atoms * n_columns * 4, 1))
        blocks = [
            self.frames[lo:lo + chunk]
            for lo in range(0, self.n_frames, chunk)
        ]
        cuda = device.type == "cuda"
        copy_stream = torch.cuda.Stream(device) if cuda else None

        def stage(block):
            positions, dimensions = self._trajectory.read_frames(block)
            if atom_indices is not None and axes is not None:
                # One gather of the wanted atoms' wanted columns.
                positions = positions[:, np.asarray(atom_indices)[:, None],
                                      axes]
            elif atom_indices is not None:
                positions = positions[:, atom_indices]
            elif axes is not None:
                positions = positions[:, :, axes]
            pos = torch.from_numpy(
                np.ascontiguousarray(positions, dtype=np.float32)
            )
            dims = torch.from_numpy(
                np.ascontiguousarray(dimensions, dtype=np.float64)
            )
            if not cuda:
                mask = torch.ones(len(block), dtype=torch.float64)
                return _Batch(pos, dims, mask, block)
            host = (pos.pin_memory(), dims.pin_memory())
            with torch.cuda.stream(copy_stream):
                pos = host[0].to(device, non_blocking=True)
                dims = host[1].to(device, non_blocking=True)
                mask = torch.ones(len(block), dtype=torch.float64,
                                  device=device)
            batch = _Batch(pos, dims, mask, block)
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
        if not self._prefetch_batches:
            staged = stage(blocks[0])
            for i in range(len(blocks)):
                batch = consume(staged)
                staged = stage(blocks[i + 1]) if i + 1 < len(blocks) else None
                yield batch
            return
        # One worker, one chunk deep: it reads chunk n + 1 (the XTC
        # reader's own decode threads run inside it) and starts its copy
        # while the consumer launches chunk n.
        with ThreadPoolExecutor(max_workers=1) as worker:
            future = worker.submit(stage, blocks[0])
            for i in range(len(blocks)):
                batch = consume(future.result())
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

    # -- driver ------------------------------------------------------------
    def run(self, start: int = None, stop: int = None, step: int = None,
            frames=None, verbose: bool = None):
        """Run the analysis over the selected frames."""

        verbose = self._verbose if verbose is None else verbose
        if verbose:
            time_start = datetime.now()
            logging.info(f"Starting {type(self).__name__} analysis...")
        self._setup_frames(
            self._trajectory, start=start, stop=stop, step=step,
            frames=frames,
        )
        self._prepare()
        carry = self._carry
        for batch in self._stream_batches():
            carry = self._batched_update(carry, batch)
        self._carry = carry
        self._drain_stores()
        self._conclude()
        if verbose:
            logging.info(
                f"Analysis finished in {datetime.now() - time_start}."
            )
        return self


class DynamicAnalysisBase(SerialAnalysisBase):
    """The base of the analyses that the JAX package can shard over
    frames (``parallel=True``).  The port runs them serially:
    ``parallel=False`` is :class:`SerialAnalysisBase`, and
    ``parallel=True`` raises `NotImplementedError` until the mesh runtime
    is ported (ROADMAP Queue 1, item 10)."""

    def __init__(self, trajectory, parallel: bool, verbose: bool = False,
                 *, device=None):
        if parallel:
            raise NotImplementedError(
                "parallel=True is not ported yet (ROADMAP Queue 1, item 10:"
                " parallel/); run with parallel=False."
            )
        super().__init__(trajectory, verbose, device=device)

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
