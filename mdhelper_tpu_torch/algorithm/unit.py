"""
Unit manipulation
=================

Helpers for stripping, converting and reducing units, ported from
:mod:`mdhelper_tpu.algorithm.unit` onto the port's own unit engine
(:mod:`mdhelper_tpu_torch.units`).

The JAX package also takes ``openmm.unit`` quantities here when OpenMM
is installed.  Those conversions come with the port of its ``openmm``
package: until then an OpenMM quantity or unit raises, with the errors
the JAX package raises when OpenMM is absent (a `TypeError` for LJ bases,
:class:`~mdhelper_tpu_torch.units.UnitsError` for a conversion).
"""

from numbers import Number
from typing import Any, Union

import numpy as np

from .. import FOUND_OPENMM, Q_, ureg
from ..units import Unit, UnitsError

__all__ = ["get_scaling_factors", "get_lj_scaling_factors", "strip_unit"]


def _is_openmm_quantity(value: Any) -> bool:
    return getattr(value, "__module__", None) == "openmm.unit.quantity"


def _is_openmm_unit(value: Any) -> bool:
    return getattr(value, "__module__", None) == "openmm.unit.unit"


def _no_openmm():
    """The error of a conversion to or from ``openmm.unit``."""

    if not FOUND_OPENMM:
        return UnitsError("OpenMM is not installed.")
    return UnitsError(
        "openmm.unit quantities are not supported by this package yet; "
        "pass mdhelper_tpu_torch Quantity objects."
    )


def get_scaling_factors(
    bases: dict[str, Any], other: dict[str, list] = {}
) -> dict[str, Any]:
    r"""Evaluate scaling factors for reduced units.

    Parameters
    ----------
    bases : `dict`
        Fundamental quantities, e.g. molar mass (:math:`m`), length
        (:math:`\sigma`), and energy (:math:`\epsilon`), plus any
        already-derived factors.
    other : `dict`, optional
        Additional factors to compute, each given as tuples of
        ``(base_name, power)``. Example:
        ``{"diffusivity": (("length", 2), ("time", -1))}``.

    Returns
    -------
    scales : `dict`
        Scaling factors (the input `bases` dict, updated in place).
    """

    for name, params in other.items():
        factor = 1
        for base, power in params:
            factor *= bases[base] ** power
        bases[name] = factor
    return bases


def get_lj_scaling_factors(
    bases: dict[str, Any], other: dict[str, list] = {}
) -> dict[str, Any]:
    r"""Evaluate scaling factors for Lennard-Jones reduced units.

    Derived factors:

    * ``molar_energy``: :math:`N_\mathrm{A}\epsilon`
    * ``time``: :math:`\sqrt{m\sigma^2/(N_\mathrm{A}\epsilon)}`
    * ``velocity``: :math:`\sigma/\tau`
    * ``force``: :math:`N_\mathrm{A}\epsilon/\sigma`
    * ``temperature``: :math:`\epsilon/k_\mathrm{B}`
    * ``pressure``: :math:`\epsilon/\sigma^3`
    * ``dynamic_viscosity``: :math:`\epsilon\tau/\sigma^3`
    * ``charge``: :math:`\sqrt{4\pi\varepsilon_0\sigma\epsilon}`
    * ``dipole``: :math:`\sigma q`
    * ``electric_field``: force / charge
    * ``mass_density``: :math:`m/(N_\mathrm{A}\sigma^3)`

    Parameters
    ----------
    bases : `dict`
        Fundamental quantities ``{"mass": ..., "length": ...,
        "energy": ...}`` as :class:`mdhelper_tpu_torch.units.Quantity`
        objects.
    other : `dict`, optional
        Additional factors, as in :func:`get_scaling_factors`.

    Returns
    -------
    scales : `dict`
        Scaling factors.
    """

    if not isinstance(bases["mass"], Q_):
        if FOUND_OPENMM:
            raise TypeError(
                "The base quantities must be mdhelper_tpu_torch Quantity "
                "objects (openmm.unit quantities are not supported by "
                "this package yet)."
            )
        raise TypeError(
            "The base quantities must be mdhelper_tpu_torch Quantity "
            "objects (or openmm.unit quantities, but OpenMM was not "
            "found)."
        )
    avogadro = ureg.avogadro_constant
    boltzmann = ureg.boltzmann_constant
    bases["molar_energy"] = bases["energy"] * avogadro
    bases["time"] = (
        bases["mass"] * bases["length"] ** 2 / bases["molar_energy"]
    ).sqrt().to(ureg.picosecond)
    bases["charge"] = (
        4 * np.pi * ureg.vacuum_permittivity
        * bases["length"] * bases["energy"]
    ).sqrt().to(ureg.elementary_charge)
    bases["velocity"] = bases["length"] / bases["time"]
    bases["force"] = bases["molar_energy"] / bases["length"]
    bases["temperature"] = bases["energy"] / boltzmann
    bases["pressure"] = bases["energy"] / bases["length"] ** 3
    bases["dynamic_viscosity"] = bases["pressure"] * bases["time"]
    bases["dipole"] = bases["length"] * bases["charge"]
    bases["electric_field"] = bases["force"] / bases["charge"]
    bases["mass_density"] = bases["mass"] / (
        bases["length"] ** 3 * avogadro
    )
    return get_scaling_factors(bases, other)


def strip_unit(
    value: Union[Number, np.ndarray, Any],
    unit_: Union[str, Unit, Any] = None,
) -> tuple:
    """Strip the unit from a quantity, optionally converting first.

    Accepts plain numbers and :class:`mdhelper_tpu_torch.units.Quantity`
    objects; `unit_` may be a string or an
    :class:`mdhelper_tpu_torch.units.Unit`.

    Returns
    -------
    value : `numbers.Number` or `numpy.ndarray`
        Magnitude of the quantity in the requested (or original) unit.
    unit : unit object or `str` or `None`
        The unit the magnitude is expressed in.  For plain-number
        input, `unit_` is passed through unchanged.
    """

    if isinstance(value, Q_):
        if unit_ is None:
            return value.magnitude, value.units
        if _is_openmm_unit(unit_):
            raise _no_openmm()
        native = ureg.Unit(unit_) if not isinstance(unit_, Unit) else unit_
        return value.m_as(native), native
    if _is_openmm_quantity(value):
        raise _no_openmm()
    return value, unit_
