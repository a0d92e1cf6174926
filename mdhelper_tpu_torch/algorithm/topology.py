"""
Topology helpers
================

The part of :mod:`mdhelper_tpu.algorithm.topology` the ported analyses
call.
"""

import numpy as np

__all__ = ["unwrap_edge"]


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
