"""
OpenMM helpers
==============

Simulation-setup utilities for OpenMM, module for module as in
:mod:`mdhelper_tpu.openmm`.  The energy expressions
(:mod:`~mdhelper_tpu_torch.openmm.expressions`) and the trajectory file
layer (:mod:`~mdhelper_tpu_torch.openmm.file`) work without OpenMM and are
always imported; the other modules come with OpenMM.  ``unit``,
``system`` and ``utility`` import without it (their OpenMM functions
raise ``ImportError``); ``pair``, ``bond``, ``topology`` and ``reporter``
import OpenMM at module level.  Host-side code: nothing here touches the
device, and the package root does not import this subpackage.
"""

from importlib.util import find_spec

from . import expressions, file  # noqa: F401

__all__ = ["expressions", "file"]

if find_spec("openmm") is not None:  # pragma: no cover
    from . import (  # noqa: F401
        bond,
        pair,
        reporter,
        system,
        topology,
        unit,
        utility,
    )

    __all__ += [
        "bond",
        "pair",
        "reporter",
        "system",
        "topology",
        "unit",
        "utility",
    ]
