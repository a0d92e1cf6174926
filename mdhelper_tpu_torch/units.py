"""
Self-contained unit system
==========================

A copy of :mod:`mdhelper_tpu.units`, the package's own numpy-only unit
engine (the port imports nothing of the JAX package, so it keeps its
own).  It provides the subset of :mod:`pint` that the toolkit relies
on, with the same public surface:

* ``ureg`` -- a :class:`UnitRegistry` with attribute access
  (``ureg.angstrom``), string parsing (``ureg.Unit("foot/second**2")``)
  and physical constants (``ureg.boltzmann_constant``).
* ``Q_`` / :class:`Quantity` -- magnitude + unit with ``.to()``,
  ``.m_as()``, ``.magnitude`` and ``.units``.

Only absolute (non-offset) units are supported; degree Celsius and
friends are intentionally omitted.  Units are represented as a scale
factor to coherent SI plus a vector of rational dimension exponents,
so multiplication, division, powers (including fractional powers from
square roots) and conversion are exact operations on Fractions.
Quantities of this engine and of :mod:`mdhelper_tpu.units` are distinct
types: compare their ``factor``, ``dims`` and strings, not the objects.
"""

from __future__ import annotations

import math
import re
from fractions import Fraction
from numbers import Number
from typing import Union

import numpy as np

__all__ = ["Unit", "Quantity", "UnitRegistry", "UnitsError"]

# Coherent SI base dimensions.
_DIMS = (
    "length",
    "mass",
    "time",
    "current",
    "temperature",
    "substance",
    "luminosity",
)
_ZERO = (Fraction(0),) * len(_DIMS)


class UnitsError(ValueError):
    """Raised for undefined units or incompatible conversions."""


def _dim(**kwargs: int) -> tuple[Fraction, ...]:
    return tuple(Fraction(kwargs.get(d, 0)) for d in _DIMS)


def _fmt_power(name: str, power: Fraction) -> str:
    if power == 1:
        return name
    if power.denominator == 1:
        return f"{name} ** {power.numerator}"
    return f"{name} ** {float(power)}"


class Unit:
    """A (possibly compound) unit: an SI scale factor, a dimension
    vector, and a symbolic name composition for display."""

    __slots__ = ("_registry", "factor", "dims", "names")
    __array_priority__ = 100.0

    def __init__(self, registry, factor, dims, names):
        self._registry = registry
        self.factor = float(factor)
        self.dims = tuple(dims)
        # names: dict unit-name -> Fraction power (for display only)
        self.names = {k: v for k, v in names.items() if v != 0}

    # -- representation ------------------------------------------------
    def __str__(self):
        if not self.names:
            return "dimensionless"
        num = [_fmt_power(n, p) for n, p in self.names.items() if p > 0]
        den = [_fmt_power(n, -p) for n, p in self.names.items() if p < 0]
        if not num:
            num = ["1"]
        out = " * ".join(num)
        for d in den:
            out += f" / {d}"
        return out

    def __repr__(self):
        return f"<Unit('{self}')>"

    @property
    def dimensionality(self):
        return {f"[{d}]": p for d, p in zip(_DIMS, self.dims) if p != 0}

    @property
    def dimensionless(self):
        return self.dims == _ZERO

    # -- algebra -------------------------------------------------------
    def _combine(self, other: "Unit", sign: int) -> "Unit":
        names = dict(self.names)
        for k, v in other.names.items():
            names[k] = names.get(k, Fraction(0)) + sign * v
        factor = self.factor * other.factor**sign
        dims = tuple(
            a + sign * b for a, b in zip(self.dims, other.dims)
        )
        return Unit(self._registry, factor, dims, names)

    def __mul__(self, other):
        if isinstance(other, Unit):
            return self._combine(other, 1)
        if isinstance(other, Quantity):
            return Quantity(other.magnitude, self * other.units)
        if isinstance(other, (Number, np.ndarray, list, tuple)):
            return Quantity(other, self)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return self._combine(other, -1)
        if isinstance(other, Quantity):
            return Quantity(1.0 / other.magnitude, self / other.units)
        if isinstance(other, (Number, np.ndarray)):
            return Quantity(1.0 / np.asarray(other), self)
        return NotImplemented

    def __rtruediv__(self, other):
        if isinstance(other, (Number, np.ndarray)):
            return Quantity(other, self**-1)
        return NotImplemented

    def __pow__(self, power):
        if isinstance(power, float) and not power.is_integer():
            power = Fraction(power).limit_denominator(1_000_000)
        power = Fraction(power)
        names = {k: v * power for k, v in self.names.items()}
        dims = tuple(d * power for d in self.dims)
        return Unit(self._registry, self.factor ** float(power), dims, names)

    def __eq__(self, other):
        if isinstance(other, Unit):
            return (
                self.dims == other.dims
                and math.isclose(self.factor, other.factor, rel_tol=1e-12)
            )
        if isinstance(other, str):
            try:
                return self == self._registry.Unit(other)
            except UnitsError:
                return False
        return NotImplemented

    def __hash__(self):
        return hash((self.dims, round(math.log(self.factor), 9) if self.factor > 0 else 0))

    def is_compatible_with(self, other: "Unit") -> bool:
        return self.dims == other.dims

    def conversion_factor(self, other: "Unit") -> float:
        if self.dims != other.dims:
            raise UnitsError(
                f"Cannot convert from '{self}' to '{other}': "
                "incompatible dimensions."
            )
        return self.factor / other.factor


class Quantity:
    """Magnitude + :class:`Unit`, mirroring ``pint.Quantity``."""

    __slots__ = ("_magnitude", "_units")
    __array_priority__ = 100.0
    # Keep numpy from consuming us in ufuncs; we implement the subset
    # needed (sqrt, multiply, divide, power) in __array_ufunc__.

    def __init__(self, magnitude, units: Union[Unit, str, None] = None):
        if isinstance(magnitude, Quantity):
            units_ = magnitude.units if units is None else _as_unit(units)
            magnitude = magnitude.m_as(units_)
            self._magnitude, self._units = magnitude, units_
            return
        if units is None:
            units = _default_registry().dimensionless
        self._magnitude = magnitude
        self._units = _as_unit(units)

    # -- accessors ------------------------------------------------------
    @property
    def magnitude(self):
        return self._magnitude

    m = magnitude

    @property
    def units(self) -> Unit:
        return self._units

    u = units

    @property
    def dimensionless(self) -> bool:
        return self._units.dimensionless

    def to(self, target: Union[Unit, str]) -> "Quantity":
        target = _as_unit(target)
        f = self._units.conversion_factor(target)
        return Quantity(np.multiply(self._magnitude, f) if f != 1
                        else self._magnitude, target)

    def m_as(self, target: Union[Unit, str]):
        return self.to(target).magnitude

    def to_reduced_units(self) -> "Quantity":
        """Cancel redundant unit names (pint's ``to_reduced_units``);
        a leftover dimensionless scale is folded into the magnitude."""

        q = self._reduced()
        if q.units.dims == _ZERO and (q.units.factor != 1.0 or q.units.names):
            reg = q.units._registry or _default_registry()
            return Quantity(
                np.multiply(q.magnitude, q.units.factor),
                Unit(reg, 1.0, _ZERO, {}),
            )
        return q

    def to_base_units(self) -> "Quantity":
        reg = self._units._registry or _default_registry()
        names = {}
        for d, p in zip(_DIMS, self._units.dims):
            if p != 0:
                names[reg._base_names[d]] = p
        base = Unit(reg, 1.0, self._units.dims, names)
        return Quantity(np.multiply(self._magnitude, self._units.factor), base)

    # -- representation ---------------------------------------------------
    def __str__(self):
        return f"{self._magnitude} {self._units}"

    def __repr__(self):
        return f"<Quantity({self._magnitude}, '{self._units}')>"

    def _reduced(self) -> "Quantity":
        """Cancel dimensionally-identical unit names against each other
        (e.g. ``kilojoule * kelvin / joule`` -> ``kelvin``), folding the
        leftover scale into the magnitude — pint's
        ``auto_reduce_dimensions`` behavior."""

        reg = self._units._registry
        if reg is None or not getattr(reg, "auto_reduce_dimensions", False):
            return self
        names = dict(self._units.names)
        scale = 1.0
        changed = True
        while changed:
            changed = False
            keys = [k for k, v in names.items() if v != 0]
            for i, n1 in enumerate(keys):
                for n2 in keys[i + 1:]:
                    u1, u2 = getattr(reg, n1), getattr(reg, n2)
                    if u1.dims != u2.dims or u1.dims == _ZERO:
                        continue
                    p1, p2 = names[n1], names[n2]
                    if p1 * p2 >= 0:
                        continue
                    c = min(abs(p1), abs(p2))
                    sign = 1 if p1 > 0 else -1
                    scale *= (u1.factor / u2.factor) ** float(sign * c)
                    names[n1] = p1 - sign * c
                    names[n2] = p2 + sign * c
                    changed = True
                    break
                if changed:
                    break
        if scale == 1.0 and names == self._units.names:
            return self
        unit = Unit(reg, self._units.factor / scale, self._units.dims,
                    names)
        return Quantity(np.multiply(self._magnitude, scale), unit)

    # -- algebra ----------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Quantity):
            return Quantity(np.multiply(self._magnitude, other._magnitude),
                            self._units * other._units)._reduced()
        if isinstance(other, Unit):
            return Quantity(self._magnitude, self._units * other)._reduced()
        return Quantity(np.multiply(self._magnitude, other), self._units)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return Quantity(np.divide(self._magnitude, other._magnitude),
                            self._units / other._units)._reduced()
        if isinstance(other, Unit):
            return Quantity(self._magnitude, self._units / other)._reduced()
        return Quantity(np.divide(self._magnitude, other), self._units)

    def __rtruediv__(self, other):
        if isinstance(other, Unit):
            return Quantity(1.0 / np.asarray(self._magnitude),
                            other / self._units)
        return Quantity(np.divide(other, self._magnitude), self._units**-1)

    def __pow__(self, power):
        return Quantity(np.power(self._magnitude, float(power)),
                        self._units**power)

    def __add__(self, other):
        if isinstance(other, Quantity):
            return Quantity(
                np.add(self._magnitude, other.m_as(self._units)), self._units
            )
        if self.dimensionless:
            return Quantity(np.add(np.multiply(self._magnitude,
                                               self._units.factor), other),
                            self._units._registry.dimensionless)
        raise UnitsError(f"Cannot add bare number to quantity '{self}'.")

    __radd__ = __add__

    def __sub__(self, other):
        return self.__add__(-other)

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __neg__(self):
        return Quantity(np.negative(self._magnitude), self._units)

    def __abs__(self):
        return Quantity(np.abs(self._magnitude), self._units)

    def sqrt(self) -> "Quantity":
        return self**Fraction(1, 2)

    def mean(self, *args, **kwargs) -> "Quantity":
        return Quantity(np.mean(self._magnitude, *args, **kwargs),
                        self._units)

    def sum(self, *args, **kwargs) -> "Quantity":
        return Quantity(np.sum(self._magnitude, *args, **kwargs),
                        self._units)

    def std(self, *args, **kwargs) -> "Quantity":
        return Quantity(np.std(self._magnitude, *args, **kwargs),
                        self._units)

    def __eq__(self, other):
        if isinstance(other, Quantity):
            if self._units.dims != other._units.dims:
                return False
            return np.all(
                np.isclose(np.multiply(self._magnitude, self._units.factor),
                           np.multiply(other._magnitude, other._units.factor),
                           rtol=1e-12)
            )
        if self.dimensionless:
            return np.all(np.isclose(
                np.multiply(self._magnitude, self._units.factor), other))
        return NotImplemented

    def __hash__(self):
        return hash((float(np.asarray(self._magnitude).sum()), self._units))

    def __float__(self):
        if not self.dimensionless:
            raise UnitsError(f"Cannot coerce '{self}' to float.")
        return float(self._magnitude) * self._units.factor

    def __len__(self):
        return len(self._magnitude)

    def __getitem__(self, idx):
        return Quantity(self._magnitude[idx], self._units)

    # numpy interop: support the handful of ufuncs the toolkit needs.
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__":
            return NotImplemented
        if ufunc is np.sqrt:
            return self.sqrt()
        if ufunc is np.multiply:
            a, b = inputs
            return (self.__mul__(a) if b is self else self.__mul__(b))
        if ufunc is np.divide or ufunc is np.true_divide:
            a, b = inputs
            return self.__rtruediv__(a) if b is self else self.__truediv__(b)
        if ufunc is np.add:
            a, b = inputs
            return self.__add__(a if b is self else b)
        if ufunc is np.subtract:
            a, b = inputs
            return self.__rsub__(a) if b is self else self.__sub__(b)
        if ufunc is np.power and inputs[0] is self:
            return self.__pow__(inputs[1])
        if ufunc is np.negative:
            return self.__neg__()
        if ufunc is np.absolute:
            return self.__abs__()
        return NotImplemented


_IDENT = re.compile(r"[A-Za-z_][A-Za-z_0-9]*")
_ALLOWED = re.compile(r"^[A-Za-z_0-9*/() .+\-]*$")


class UnitRegistry:
    """Registry of named units with attribute access and parsing.

    Mirrors the subset of ``pint.UnitRegistry`` that the toolkit uses.
    """

    def __init__(self, auto_reduce_dimensions: bool = True):
        self.auto_reduce_dimensions = auto_reduce_dimensions
        self._units: dict[str, Unit] = {}
        self._base_names = {
            "length": "meter",
            "mass": "kilogram",
            "time": "second",
            "current": "ampere",
            "temperature": "kelvin",
            "substance": "mole",
            "luminosity": "candela",
        }
        self._build()

    # -- construction ----------------------------------------------------
    def _def(self, name: str, factor: float, dims, aliases=()):
        unit = Unit(self, factor, dims, {name: Fraction(1)})
        self._units[name] = unit
        for a in aliases:
            self._units[a] = Unit(self, factor, dims, {name: Fraction(1)})
        return unit

    def _build(self):
        d = _dim
        # base units
        self._def("meter", 1.0, d(length=1), ("m", "metre"))
        self._def("kilogram", 1.0, d(mass=1), ("kg",))
        self._def("second", 1.0, d(time=1), ("s", "sec"))
        self._def("ampere", 1.0, d(current=1), ("A", "amp"))
        self._def("kelvin", 1.0, d(temperature=1), ("K",))
        self._def("mole", 1.0, d(substance=1), ("mol",))
        self._def("candela", 1.0, d(luminosity=1), ("cd",))
        # lengths
        self._def("angstrom", 1e-10, d(length=1), ("Å", "AA"))
        self._def("foot", 0.3048, d(length=1), ("ft", "feet"))
        self._def("inch", 0.0254, d(length=1), ("in",))
        self._def("mile", 1609.344, d(length=1))
        # mass
        self._def("gram", 1e-3, d(mass=1), ("g",))
        self._def("dalton", 1.66053906660e-27, d(mass=1),
                  ("amu", "unified_atomic_mass_unit", "atomic_mass_unit", "Da"))
        # time
        self._def("minute", 60.0, d(time=1), ("min",))
        self._def("hour", 3600.0, d(time=1), ("h", "hr"))
        # angle (dimensionless)
        self._def("radian", 1.0, d(), ("rad",))
        self._def("degree", math.pi / 180.0, d(), ("deg",))
        # derived
        self._def("hertz", 1.0, d(time=-1), ("Hz",))
        self._def("newton", 1.0, d(mass=1, length=1, time=-2), ("N",))
        self._def("pascal", 1.0, d(mass=1, length=-1, time=-2), ("Pa",))
        self._def("joule", 1.0, d(mass=1, length=2, time=-2), ("J",))
        self._def("watt", 1.0, d(mass=1, length=2, time=-3), ("W",))
        self._def("coulomb", 1.0, d(current=1, time=1), ("C",))
        self._def("volt", 1.0, d(mass=1, length=2, time=-3, current=-1),
                  ("V",))
        self._def("farad", 1.0, d(mass=-1, length=-2, time=4, current=2),
                  ("F",))
        self._def("ohm", 1.0, d(mass=1, length=2, time=-3, current=-2))
        self._def("siemens", 1.0, d(mass=-1, length=-2, time=3, current=2),
                  ("S",))
        self._def("calorie", 4.184, d(mass=1, length=2, time=-2), ("cal",))
        self._def("erg", 1e-7, d(mass=1, length=2, time=-2))
        self._def("electron_volt", 1.602176634e-19,
                  d(mass=1, length=2, time=-2), ("eV",))
        self._def("bar", 1e5, d(mass=1, length=-1, time=-2))
        self._def("atmosphere", 101325.0, d(mass=1, length=-1, time=-2),
                  ("atm", "standard_atmosphere"))
        self._def("liter", 1e-3, d(length=3), ("L", "litre"))
        self._def("poise", 0.1, d(mass=1, length=-1, time=-1), ("P",))
        self._def("elementary_charge", 1.602176634e-19, d(current=1, time=1),
                  ("e",))
        self._def("debye", 3.33564e-30, d(current=1, time=1, length=1),
                  ("D",))
        # SI prefixes for the common prefixed unit families
        prefixes = {
            "yocto": 1e-24, "zepto": 1e-21, "atto": 1e-18, "femto": 1e-15,
            "pico": 1e-12, "nano": 1e-9, "micro": 1e-6, "milli": 1e-3,
            "centi": 1e-2, "deci": 1e-1, "kilo": 1e3, "mega": 1e6,
            "giga": 1e9, "tera": 1e12,
        }
        short = {
            "yocto": "y", "zepto": "z", "atto": "a", "femto": "f",
            "pico": "p", "nano": "n", "micro": "u", "milli": "m",
            "centi": "c", "deci": "d", "kilo": "k", "mega": "M",
            "giga": "G", "tera": "T",
        }
        prefixable = {
            "meter": "m", "second": "s", "gram": "g", "joule": "J",
            "calorie": "cal", "pascal": "Pa", "hertz": "Hz",
            "coulomb": "C", "volt": "V", "farad": "F", "ampere": "A",
            "mole": "mol", "liter": "L", "newton": "N", "siemens": "S",
            "electron_volt": "eV", "kelvin": "K",
        }
        for base, sym in prefixable.items():
            u = self._units[base]
            for pre, mult in prefixes.items():
                if pre == "kilo" and base == "gram":
                    continue  # kilogram is primitive
                name = pre + base
                self._def(name, u.factor * mult, u.dims,
                          (short[pre] + sym,))
        # constants (Quantities, matching pint's attribute names)
        self.avogadro_constant = Quantity(6.02214076e23, self.mole**-1)
        self.avogadro_number = Quantity(6.02214076e23, self.dimensionless)
        self.boltzmann_constant = Quantity(
            1.380649e-23, self.joule / self.kelvin
        )
        self.molar_gas_constant = self.gas_constant = Quantity(
            8.31446261815324, self.joule / (self.kelvin * self.mole)
        )
        self.vacuum_permittivity = self.electric_constant = Quantity(
            8.8541878128e-12, self.farad / self.meter
        )
        self.speed_of_light = Quantity(299792458.0, self.meter / self.second)
        self.elementary_charge_constant = Quantity(
            1.602176634e-19, self.coulomb
        )

    # -- lookup ------------------------------------------------------------
    @property
    def dimensionless(self) -> Unit:
        return Unit(self, 1.0, _ZERO, {})

    def __getattr__(self, name: str) -> Unit:
        # Only called when normal attribute lookup fails.
        try:
            return self.__getattribute__("_units")[name]
        except KeyError:
            pass
        # naive plural fallback: "seconds" -> "second"
        if name.endswith("s"):
            try:
                return self.__getattribute__("_units")[name[:-1]]
            except KeyError:
                pass
        raise AttributeError(f"'{name}' is not defined in the unit registry")

    def __contains__(self, name: str) -> bool:
        return name in self._units

    def Unit(self, expr) -> Unit:  # noqa: N802 (pint-compatible name)
        if isinstance(expr, Unit):
            return expr
        if expr is None or expr == "" or expr == "dimensionless":
            return self.dimensionless
        if not isinstance(expr, str):
            raise UnitsError(f"Cannot interpret '{expr!r}' as a unit.")
        expr = expr.replace("^", "**").replace("·", "*")
        if not _ALLOWED.match(expr):
            raise UnitsError(f"Invalid characters in unit string '{expr}'.")
        names = {}
        for ident in set(_IDENT.findall(expr)):
            try:
                names[ident] = getattr(self, ident)
            except AttributeError:
                raise UnitsError(f"Undefined unit '{ident}' in '{expr}'.")
        try:
            result = eval(expr, {"__builtins__": {}}, names)  # noqa: S307
        except Exception as exc:
            raise UnitsError(f"Cannot parse unit string '{expr}': {exc}")
        if isinstance(result, Number):
            return Unit(self, float(result), _ZERO, {})
        if isinstance(result, Quantity):
            return Unit(self, result.units.factor * float(result.magnitude),
                        result.units.dims, result.units.names)
        if not isinstance(result, Unit):
            raise UnitsError(f"'{expr}' did not evaluate to a unit.")
        return result

    parse_units = Unit

    def Quantity(self, value, units=None) -> Quantity:  # noqa: N802
        return Quantity(value, self.Unit(units) if units is not None
                        else None)

    def __call__(self, expr: str) -> Quantity:
        return Quantity(1.0, self.Unit(expr))


_REGISTRY: UnitRegistry | None = None


def _default_registry() -> UnitRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = UnitRegistry()
    return _REGISTRY


def _as_unit(unit: Union[Unit, str, None]) -> Unit:
    if isinstance(unit, Unit):
        return unit
    return _default_registry().Unit(unit)
