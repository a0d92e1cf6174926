"""
Topology helpers
================

The part of :mod:`mdhelper_tpu.algorithm.topology` the ported analyses
call.
"""

import numpy as np
import torch

__all__ = ["triclinic_matrices", "unwrap_edge"]


def triclinic_matrices(dimensions):
    r"""``(..., 6)`` box parameters :math:`(a, b, c, \alpha, \beta,
    \gamma)` (degrees) to ``(..., 3, 3)`` lower-triangular box matrices
    whose rows are the box vectors, operation for operation as
    ``mdhelper_tpu.algorithm.topology.triclinic_matrices``.  Takes a
    NumPy array (returns NumPy) or a torch tensor (returns a tensor on
    its device, in its dtype)."""

    d = dimensions
    xp = torch if isinstance(d, torch.Tensor) else np
    a, b, c = d[..., 0], d[..., 1], d[..., 2]
    alpha, beta, gamma = (xp.deg2rad(d[..., i]) for i in (3, 4, 5))
    cos_a, cos_b, cos_g = xp.cos(alpha), xp.cos(beta), xp.cos(gamma)
    sin_g = xp.sin(gamma)
    bx, by = b * cos_g, b * sin_g
    cx = c * cos_b
    cy = c * (cos_a - cos_b * cos_g) / sin_g
    cz = xp.sqrt(xp.maximum(c * c - cx * cx - cy * cy, xp.zeros_like(c)))
    zero = xp.zeros_like(a)
    return xp.stack(
        (
            xp.stack((a, zero, zero), axis=-1),
            xp.stack((bx, by, zero), axis=-1),
            xp.stack((cx, cy, cz), axis=-1),
        ),
        axis=-2,
    )


def unwrap_edge(*, group):
    r"""Make the molecules of `group` whole at the current frame.

    Counterpart of ``mdhelper_tpu.algorithm.topology.unwrap_edge(group=)``
    for groups with no bonds, where every atom is its own molecule and
    the result is a float64 copy of the current positions.  Bonded
    groups (the bond-graph walk) are not ported yet and raise.
    """

    bonds = getattr(group.universe, "bonds", None)
    if bonds is not None and len(bonds):
        raise NotImplementedError(
            "unwrap_edge of a bonded group is not ported yet."
        )
    return np.array(group.positions, dtype=np.float64)
