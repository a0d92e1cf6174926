"""
Periodic-boundary transforms
============================

Torch counterpart of :mod:`mdhelper_tpu.ops.pbc`: wrapping, and the
order-dependent trajectory unwrap with image-flag tracking (the JAX
``lax.scan`` becomes a loop over the frames of a chunk).
"""

import torch

from .doublefloat import fma32

__all__ = ["wrap_positions", "unwrap_scan"]


def wrap_positions(positions, box):
    """Wrap coordinates into [0, box), the product and the difference
    rounded once (``fma(-floor(x / L), L, x)``), as XLA's CPU backend
    contracts the JAX package's wrap inside its compiled classes: a
    coordinate outside the box can wrap one float32 ulp away from the
    separately rounded form."""

    return fma32(-torch.floor(positions / box), box, positions)


def unwrap_scan(positions, box, initial=None, images=None):
    r"""Unwrap a (chunk of a) trajectory with image-flag tracking.

    A particle that moves at least half a box length between
    consecutive frames is taken to have crossed the boundary.

    Parameters
    ----------
    positions : `torch.Tensor`
        Wrapped coordinates, shape ``(T, N, 3)``.
    box : `torch.Tensor`
        Box lengths, shape ``(3,)`` or ``(T, 3)``.
    initial : `torch.Tensor`, optional
        Wrapped positions of the frame preceding this chunk.  Defaults
        to the first frame.
    images : `torch.Tensor`, optional
        int32 image counts carried in from the previous chunk.

    Returns
    -------
    unwrapped : `torch.Tensor`
        Unwrapped coordinates, shape ``(T, N, 3)``.
    carry : `tuple`
        ``(last wrapped frame, last image counts)`` for the next chunk.
    """

    prev = positions[0] if initial is None else initial
    if images is None:
        images = torch.zeros(
            positions.shape[1:], dtype=torch.int32,
            device=positions.device,
        )
    per_frame_box = box.ndim == 2
    out = torch.empty_like(positions)
    for t in range(positions.shape[0]):
        pos = positions[t]
        frame_box = box[t] if per_frame_box else box
        delta = pos - prev
        crossings = torch.where(
            delta.abs() >= frame_box / 2,
            torch.sign(delta).to(torch.int32),
            0,
        )
        images = images - crossings
        out[t] = pos + images * frame_box
        prev = pos
    return out, (prev, images)
