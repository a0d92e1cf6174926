"""
Parallelism
===========

Ranks of :mod:`torch.distributed` and the sharding helpers over them
(the port of :mod:`mdhelper_tpu.parallel`): :mod:`.mesh` (the ranks, the
frame blocks and the collectives) and :mod:`.ring` (the atom-sharded
pair histogram).
"""

from . import mesh  # noqa: F401
from .mesh import FRAME_AXIS, get_mesh  # noqa: F401

__all__ = ["mesh", "FRAME_AXIS", "get_mesh"]
