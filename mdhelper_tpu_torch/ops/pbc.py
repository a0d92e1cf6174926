"""
Periodic-boundary transforms
============================

Torch counterpart of :mod:`mdhelper_tpu.ops.pbc`: the orthorhombic
minimum image, wrapping, the order-dependent trajectory unwrap with
image-flag tracking (the JAX ``lax.scan`` becomes a loop over the frames
of a chunk), and the removal of the center-of-mass drift.
"""

import torch

from .doublefloat import fma32

__all__ = [
    "min_image_displacement",
    "wrap_positions",
    "unwrap_scan",
    "com_shift_scan",
]


def min_image_displacement(delta, box):
    """Orthorhombic minimum images of displacement vectors `delta`;
    `box` broadcasts against the trailing axis of `delta` (``delta - box
    * round(delta / box)``, each operation rounded once, as the JAX
    package's function evaluates it outside a compiled class)."""

    return delta - box * torch.round(delta / box)


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


def com_shift_scan(unwrapped, masses):
    """Remove the system's center-of-mass drift from an unwrapped chunk
    ``(T, N, 3)``: each frame's mass-weighted mean position (`masses`
    ``(N,)``, a tensor or an array) is subtracted from its atoms.  The
    product and the sum run in the promoted dtype of the two inputs."""

    masses = torch.as_tensor(masses)
    dtype = torch.promote_types(unwrapped.dtype, masses.dtype)
    masses = masses.to(device=unwrapped.device, dtype=dtype)
    unwrapped = unwrapped.to(dtype)
    com = torch.einsum("a,tad->td", masses, unwrapped) / masses.sum()
    return unwrapped - com[:, None, :]
