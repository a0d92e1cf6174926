"""
Unit manipulation
=================

Helpers for stripping, converting and reducing units, ported from
:mod:`mdhelper_tpu.algorithm.unit` onto the port's own unit engine
(:mod:`mdhelper_tpu_torch.units`).  When OpenMM is installed they also
take ``openmm.unit`` quantities and units, as in the JAX package.
OpenMM's vacuum permittivity comes from
:mod:`mdhelper_tpu_torch.openmm.unit`, which imports this module, so it is
imported where it is used.
"""

from numbers import Number
from typing import Any, Union

import numpy as np

from .. import FOUND_OPENMM, Q_, ureg
from ..units import Unit, UnitsError

if FOUND_OPENMM:
    from openmm import unit as openmm_unit

__all__ = ["get_scaling_factors", "get_lj_scaling_factors", "strip_unit"]


def _is_openmm_quantity(value: Any) -> bool:
    return getattr(value, "__module__", None) == "openmm.unit.quantity"


def _is_openmm_unit(value: Any) -> bool:
    return getattr(value, "__module__", None) == "openmm.unit.unit"


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
        "energy": ...}`` as :class:`mdhelper_tpu_torch.units.Quantity` or
        ``openmm.unit.Quantity`` objects.
    other : `dict`, optional
        Additional factors, as in :func:`get_scaling_factors`.

    Returns
    -------
    scales : `dict`
        Scaling factors.
    """

    if isinstance(bases["mass"], Q_):
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
    elif FOUND_OPENMM:
        from ..openmm.unit import VACUUM_PERMITTIVITY

        avogadro = openmm_unit.AVOGADRO_CONSTANT_NA
        boltzmann = openmm_unit.BOLTZMANN_CONSTANT_kB
        bases["molar_energy"] = bases["energy"] * avogadro
        bases["time"] = (
            bases["mass"] * bases["length"] ** 2 / bases["molar_energy"]
        ).sqrt().in_units_of(openmm_unit.picosecond)
        bases["charge"] = (
            4 * np.pi * VACUUM_PERMITTIVITY
            * bases["length"] * bases["energy"]
        ).sqrt().in_units_of(openmm_unit.elementary_charge)
    else:
        raise TypeError(
            "The base quantities must be mdhelper_tpu_torch Quantity "
            "objects (or openmm.unit quantities, but OpenMM was not "
            "found)."
        )

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

    Accepts plain numbers, :class:`mdhelper_tpu_torch.units.Quantity`
    objects and (when OpenMM is installed) ``openmm.unit.Quantity``
    objects; `unit_` may be a string, an
    :class:`mdhelper_tpu_torch.units.Unit` or an ``openmm.unit.Unit``.

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
            # Convert the OpenMM target unit to a native Unit for the
            # conversion, but hand back the OpenMM unit object.
            native = _native_from_openmm_unit(unit_)
            return value.m_as(native), unit_
        native = ureg.Unit(unit_) if not isinstance(unit_, Unit) else unit_
        return value.m_as(native), native

    if _is_openmm_quantity(value):
        if unit_ is None:
            return value.value_in_unit(value.unit), value.unit
        if _is_openmm_unit(unit_):
            return value.value_in_unit(unit_), unit_
        # A str target hands back the OpenMM unit, a native Unit target
        # the native Unit, as in the JAX package.
        swap = not isinstance(unit_, str)
        native = ureg.Unit(unit_) if not isinstance(unit_, Unit) else unit_
        omm = _openmm_from_native_unit(native)
        stripped = value.value_in_unit(omm)
        return (stripped, native) if swap else (stripped, omm)

    return value, unit_


def _native_from_openmm_unit(omm_unit) -> Unit:
    """Convert an ``openmm.unit.Unit`` into a native :class:`Unit`."""

    native = ureg.Unit("")
    for base, power in omm_unit.iter_base_or_scaled_units():
        native = native * ureg.Unit(base.name.replace(" ", "_")) ** power
    return native


def _openmm_from_native_unit(native: Unit):
    """Convert a native :class:`Unit` into an ``openmm.unit.Unit``.

    Raises a `ValueError` when a component unit has no OpenMM
    equivalent.
    """

    if not FOUND_OPENMM:  # pragma: no cover - guarded by callers
        raise UnitsError("OpenMM is not installed.")
    omm = openmm_unit.dimensionless
    try:
        for name, power in native.names.items():
            omm *= getattr(openmm_unit, name) ** float(power)
    except AttributeError:
        emsg = (
            "At least one unit in 'unit_' is not defined the same way "
            "in openmm.unit and mdhelper_tpu_torch.units, so the "
            "conversion cannot be performed. Try an openmm.unit.Quantity "
            "instead."
        )
        raise ValueError(emsg)
    return omm
