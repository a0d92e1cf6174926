"""
Ranks and sharding helpers
==========================

The port's counterpart of :mod:`mdhelper_tpu.parallel.mesh`.  The JAX
package shards over a :class:`jax.sharding.Mesh` of the devices one
process owns; the port runs one :mod:`torch.distributed` rank a device,
as ``torchrun --nproc-per-node=N`` starts them: NCCL between cards, gloo
on the CPU and where ranks share one card, and rank *r* on
``cuda:{LOCAL_RANK}``.  The port's "mesh" (:class:`Mesh`) is the ranks of
the default process group that hold shards of one axis; the other ranks
hold none and still join every collective.  Without a process group a
mesh is a world of one, and nothing is communicated.

Every collective goes through the helpers here (:func:`all_reduce`,
:func:`all_gather_tiles`, :func:`ring_shift`).  The group's backend
decides where a tensor travels: NCCL takes CUDA tensors (a CPU tensor is
copied to the current card), gloo takes CPU tensors (a CUDA tensor is
staged through the host and copied back).

The JAX module's ``frame_sharding``, ``replicated_sharding`` and
``pad_to_multiple`` are not ported: they place a chunk on the JAX mesh,
and the ranks here read their blocks of a chunk that
:class:`~mdhelper_tpu_torch.analysis.base.SerialAnalysisBase` pads.
"""

import os
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "FRAME_AXIS",
    "Mesh",
    "initialize_distributed",
    "get_mesh",
    "fetch_global",
    "process_frame_block",
    "all_reduce",
    "all_gather_tiles",
    "ring_shift",
]

FRAME_AXIS = "frames"


def _grouped() -> bool:
    """True once a default process group exists."""

    return dist.is_available() and dist.is_initialized()


def _world() -> tuple:
    """``(world size, rank)`` of the default group, ``(1, 0)`` without
    one."""

    if not _grouped():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Join a multi-rank analysis job: one process a device, each calling
    this once before it builds analyses (the JAX package's
    ``jax.distributed.initialize``).

    Parameters
    ----------
    coordinator_address : `str`, optional
        Rendezvous of the job: ``"host:port"`` (TCP) or an init-method URL
        (``"tcp://..."``, ``"file:///shared/path"``).  ``None`` reads
        ``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``).
    num_processes, process_id : `int`, optional
        World size and this process's rank; ``None`` reads ``WORLD_SIZE``
        and ``RANK``.
    **kwargs
        ``backend`` (default ``"nccl"`` where CUDA is available, else
        ``"gloo"``), ``timeout`` (seconds or a `timedelta`), and any other
        keyword of :func:`torch.distributed.init_process_group`.

    With CUDA available the rank's card, ``LOCAL_RANK`` (default: the rank)
    modulo the cards seen, becomes the current device, which the analyses
    take by default.
    """

    env = os.environ
    backend = kwargs.pop("backend", None) or (
        "nccl" if torch.cuda.is_available() else "gloo")
    timeout = kwargs.pop("timeout", None)
    if isinstance(timeout, (int, float)):
        timeout = timedelta(seconds=timeout)
    if timeout is not None:
        kwargs["timeout"] = timeout
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if torch.cuda.is_available():
        local_rank = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            **kwargs)


class Mesh:
    """The ranks holding shards of one axis: the first `size` of
    `devices` (ranks of the default group), shard ``i`` on
    ``devices[i]``.

    Attributes: ``size`` (shards), ``devices`` (their ranks), ``world``
    and ``rank`` (of the default group; 1 and 0 without one),
    ``index`` (this rank's shard, or None when it holds none),
    ``axis_name`` and ``grouped`` (a process group exists, so carries
    and stores are reduced through it, even in a world of one).
    """

    def __init__(self, devices: Sequence[int], axis_name: str = FRAME_AXIS):
        self.world, self.rank = _world()
        self.devices = tuple(int(d) for d in devices)
        if not self.devices or max(self.devices) >= self.world:
            raise ValueError(f"Ranks {self.devices} are not all in a world "
                             f"of {self.world}.")
        self.size = len(self.devices)
        self.axis_name = axis_name
        self.grouped = _grouped()
        self.index = (self.devices.index(self.rank)
                      if self.rank in self.devices else None)

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_name!r}: ranks {self.devices} of "
                f"{self.world})")


def get_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    axis_name: str = FRAME_AXIS,
) -> Mesh:
    """A :class:`Mesh` over (up to) `n_devices` ranks.

    ``devices`` are the ranks that may hold shards, in shard order
    (default: every rank of the default group); ``n_devices=1``
    reproduces a serial run on rank 0, ``None`` takes every rank of
    `devices`.  Without a process group the mesh is a world of one.
    """

    if devices is None:
        devices = range(_world()[0])
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:max(1, min(int(n_devices), len(devices)))]
    return Mesh(devices, axis_name)


def process_frame_block(n_padded: int,
                        mesh: Optional[Mesh] = None) -> tuple:
    """The contiguous ``[lo, hi)`` block of a padded, frame-sharded chunk
    of `n_padded` frames that this rank owns under `mesh` (default: every
    rank): shard ``i`` takes ``[i * n_padded / size, (i + 1) * n_padded /
    size)``; a rank without a shard takes the empty block at the end."""

    mesh = get_mesh() if mesh is None else mesh
    if n_padded % mesh.size:
        raise ValueError(
            f"Padded frame axis ({n_padded}) must divide evenly over "
            f"{mesh.size} shards."
        )
    if mesh.index is None:
        return n_padded, n_padded
    per = n_padded // mesh.size
    lo = mesh.index * per
    return lo, lo + per


def _staged(tensor: torch.Tensor) -> torch.Tensor:
    """`tensor` on the device the default group's backend takes: the
    current card for NCCL, the host for gloo."""

    if dist.get_backend() == "nccl":
        if tensor.device.type != "cuda":
            return tensor.to(torch.device("cuda",
                                          torch.cuda.current_device()))
        return tensor
    return tensor.cpu() if tensor.device.type != "cpu" else tensor


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN} if dist.is_available() else {}


def all_reduce(tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``op`` (``"sum"``, ``"max"`` or ``"min"``) of `tensor` over every
    rank, returned on `tensor`'s device; `tensor` itself is unchanged.
    Without a process group, `tensor`."""

    if not _grouped():
        return tensor
    staged = _staged(tensor).clone()
    dist.all_reduce(staged, op=_OPS[op])
    return staged.to(tensor.device)


def all_gather_tiles(tensor: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every rank's `tensor` concatenated along `axis` in rank order, on
    `tensor`'s device.  The tiles may differ in length along `axis` (a
    rank without one passes a length of 0); their other dimensions and
    dtype must agree.  A bool tensor travels as uint8 (gloo takes no
    bool).  Without a process group, `tensor`."""

    if not _grouped():
        return tensor
    if tensor.dtype == torch.bool:
        return all_gather_tiles(tensor.to(torch.uint8), axis).bool()
    world = dist.get_world_size()
    staged = _staged(tensor)
    lengths = _staged(torch.tensor([tensor.shape[axis]], dtype=torch.int64))
    every = [torch.empty_like(lengths) for _ in range(world)]
    dist.all_gather(every, lengths)
    every = [int(n) for n in torch.cat(every).cpu()]
    longest = max(every)
    if longest == 0:
        return tensor
    if staged.shape[axis] < longest:
        pad = list(staged.shape)
        pad[axis] = longest - staged.shape[axis]
        staged = torch.cat((staged, staged.new_zeros(pad)), dim=axis)
    tiles = [torch.empty_like(staged) for _ in range(world)]
    dist.all_gather(tiles, staged.contiguous())
    out = torch.cat([t.narrow(axis, 0, n) for t, n in zip(tiles, every)],
                    dim=axis)
    return out.to(tensor.device)


def ring_shift(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One hop of the ring over `mesh`'s shards: shard ``i`` sends
    `tensor` to shard ``i + 1`` and returns what shard ``i - 1`` sent (one
    ``batch_isend_irecv`` pair); every shard's tensor has the same shape
    and dtype.  Ranks outside the mesh must not call it."""

    if mesh.size == 1:
        return tensor
    staged = _staged(tensor).contiguous()
    received = torch.empty_like(staged)
    nxt = mesh.devices[(mesh.index + 1) % mesh.size]
    prv = mesh.devices[(mesh.index - 1) % mesh.size]
    ops = [dist.P2POp(dist.isend, staged, nxt),
           dist.P2POp(dist.irecv, received, prv)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return received.to(tensor.device)


def fetch_global(array, mesh: Optional[Mesh] = None,
                 axis: int = 0) -> np.ndarray:
    """A tile-sharded tensor fetched whole to host numpy on every rank:
    with `mesh`, the tiles of its shards concatenated along `axis` in
    shard order (ranks outside it pass a tile of length 0;
    :func:`all_gather_tiles`), e.g. the q tiles of a q-sharded S(q);
    without, `array` as numpy."""

    if not isinstance(array, torch.Tensor):
        return np.asarray(array)
    if mesh is not None and mesh.grouped:
        array = all_gather_tiles(array, axis)
    return array.cpu().numpy()

