r"""
OpenMM physical constants and unit reduction
============================================

As in :mod:`mdhelper_tpu.openmm.unit`.  Works without OpenMM
(``VACUUM_PERMITTIVITY`` falls back to the port's unit registry).
"""

try:
    from openmm import unit
except ImportError:  # pragma: no cover
    unit = None

from .. import ureg
from ..algorithm import unit as _unit

__all__ = [
    "VACUUM_PERMITTIVITY",
    "get_scaling_factors",
    "get_lj_scaling_factors",
]

#: Vacuum permittivity :math:`\varepsilon_0` in OpenMM units (or the
#: internal registry's units when OpenMM is absent).
if unit is not None:  # pragma: no cover
    VACUUM_PERMITTIVITY = (
        8.854187812813e-12 * unit.farad / unit.meter
    )
else:
    VACUUM_PERMITTIVITY = (
        8.854187812813e-12 * ureg.farad / ureg.meter
    )


def get_scaling_factors(
    bases: dict, other: dict = {}
) -> dict:
    """Alias of
    :func:`mdhelper_tpu_torch.algorithm.unit.get_scaling_factors` for
    ``openmm.unit`` quantities."""

    return _unit.get_scaling_factors(bases, other)


def get_lj_scaling_factors(
    bases: dict, other: dict = {}
) -> dict:
    """Alias of
    :func:`mdhelper_tpu_torch.algorithm.unit.get_lj_scaling_factors` for
    ``openmm.unit`` quantities."""

    return _unit.get_lj_scaling_factors(bases, other)
