"""The port's unit engine and unit helpers against the JAX package's.

Every case of ``tests/test_units.py`` and ``tests/test_algorithm_unit.py``
runs as a parity case: the same expression is evaluated with each
package's ``Q_``, ``ureg`` and helpers, and the results must match
magnitude for magnitude (the engines are the same numpy code, so bit for
bit), with the same scale factor, dimension vector and string of every
unit, or raise the same kind of error.  The two engines' objects are
distinct types and are never compared with ``==`` across packages.
"""

import types

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import mdhelper_tpu as jax_pkg  # noqa: E402
from mdhelper_tpu import units as jax_units  # noqa: E402
from mdhelper_tpu.algorithm import unit as jax_unit  # noqa: E402
from mdhelper_tpu.analysis import transport as jax_transport  # noqa: E402

import mdhelper_tpu_torch as port_pkg  # noqa: E402
from mdhelper_tpu_torch import units as port_units  # noqa: E402
from mdhelper_tpu_torch.algorithm import unit as port_unit  # noqa: E402
from mdhelper_tpu_torch.analysis import (  # noqa: E402
    transport as port_transport,
)


def _namespace(pkg, units, unit, transport):
    return types.SimpleNamespace(
        Q_=pkg.Q_, ureg=pkg.ureg, UnitsError=units.UnitsError,
        Unit=units.Unit, Quantity=units.Quantity,
        strip_unit=unit.strip_unit,
        get_scaling_factors=unit.get_scaling_factors,
        get_lj_scaling_factors=unit.get_lj_scaling_factors,
        transport=transport,
    )


JAX = _namespace(jax_pkg, jax_units, jax_unit, jax_transport)
PORT = _namespace(port_pkg, port_units, port_unit, port_transport)


def _plain(value, m):
    """`value` in plain Python and numpy terms: units and quantities as
    their scale factor, dimension vector and string (and magnitude),
    containers element by element."""

    if isinstance(value, m.Unit):
        return ("unit", value.factor, value.dims, str(value))
    if isinstance(value, m.Quantity):
        return ("quantity", np.asarray(value.magnitude),
                *_plain(value.units, m)[1:])
    if isinstance(value, dict):
        return {k: _plain(v, m) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_plain(v, m) for v in value)
    if isinstance(value, (np.ndarray, np.generic)):
        return np.asarray(value)
    return value


def _assert_same(port, ref):
    if isinstance(ref, dict):
        assert port.keys() == ref.keys()
        for key in ref:
            _assert_same(port[key], ref[key])
    elif isinstance(ref, (tuple, list)):
        assert type(port) is type(ref) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_same(p, r)
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(port, ref)
        assert port.dtype == ref.dtype
    else:
        assert port == ref and type(port) is type(ref)


def _argon(m):
    return {
        "mass": 39.948 * m.ureg.gram / m.ureg.mole,
        "energy": 3.9520829798737548e-25 * m.ureg.kilocalorie,
        "length": 3.4 * m.ureg.angstrom,
    }


CASES = {
    # tests/test_units.py
    "unit_ratio": lambda m: m.ureg.meter / m.ureg.second**2,
    "unit_parse": lambda m: m.ureg.Unit("meter/second**2"),
    "unit_eq_parsed": lambda m: (m.ureg.meter / m.ureg.second**2
                                 == m.ureg.Unit("meter/second**2")),
    "unit_eq_string": lambda m: m.ureg.foot / m.ureg.second**2
    == "foot/second**2",
    "unit_str": lambda m: str(m.ureg.joule / m.ureg.kelvin),
    "unit_fractional_power": lambda m: (m.ureg.meter**2) ** 0.5,
    "unit_sqrt_eq": lambda m: (m.ureg.meter**2) ** 0.5 == m.ureg.meter,
    "to_feet": lambda m: (9.80665 * m.ureg.meter / m.ureg.second**2).m_as(
        m.ureg.foot / m.ureg.second**2),
    "kcal_to_kj": lambda m: (1.0 * m.ureg.kilocalorie).m_as(
        m.ureg.kilojoule),
    "angstrom_to_nm": lambda m: (1.0 * m.ureg.angstrom).m_as("nanometer"),
    "per_particle": lambda m: (0.238 * m.ureg.kilocalorie / m.ureg.mole
                               / m.ureg.avogadro_constant),
    "per_particle_joule": lambda m: (
        0.238 * m.ureg.kilocalorie / m.ureg.mole
        / m.ureg.avogadro_constant).m_as(m.ureg.joule),
    "quantity_sqrt": lambda m: (
        1.0 * m.ureg.meter / (m.ureg.meter / m.ureg.second**2)).sqrt(),
    "numpy_sqrt": lambda m: np.sqrt(4.0 * m.ureg.second**2),
    "boltzmann": lambda m: m.ureg.boltzmann_constant.m_as("joule/kelvin"),
    "gas_constant": lambda m: (
        m.ureg.boltzmann_constant * m.ureg.avogadro_constant
    ).m_as("joule/(kelvin*mole)"),
    "gas_constant_kj": lambda m: (
        m.ureg.boltzmann_constant * m.ureg.avogadro_constant
    ).m_as("kilojoule/(kelvin*mole)"),
    "vacuum_permittivity": lambda m: m.ureg.vacuum_permittivity.m_as(
        "farad/meter"),
    "elementary_charge": lambda m: (1.0 * m.ureg.elementary_charge).m_as(
        "coulomb"),
    "array_quantity": lambda m: np.arange(3.0) * m.ureg.angstrom,
    "array_to_nm": lambda m: (np.arange(3.0) * m.ureg.angstrom).m_as(
        "nanometer"),
    "Q_constructor": lambda m: m.Q_(np.array([1.0, 2.5]), "nm").to(
        "angstrom"),
    "Q_of_Q": lambda m: m.Q_(m.Q_(2.0, "ps"), "fs"),
    "add_sub": lambda m: (m.Q_(1.0, "nm") + m.Q_(3.0, "angstrom"),
                          m.Q_(1.0, "nm") - m.Q_(3.0, "angstrom")),
    "reduced_units": lambda m: (
        2.0 * m.ureg.avogadro_constant * m.ureg.elementary_charge**2
        * m.ureg.mole / m.ureg.coulomb**2).to_reduced_units(),
    "base_units": lambda m: m.Q_(3.0, "kilojoule/mole").to_base_units(),
    "kbt_kj_per_mol": lambda m: (
        m.ureg.avogadro_constant * m.ureg.boltzmann_constant * 300.0
        * m.ureg.kelvin).m_as(m.ureg.kilojoule / m.ureg.mole),
    "inverse_length": lambda m: m.ureg.Unit("1/angstrom")
    == m.ureg.angstrom**-1,
    "dimensionality": lambda m: (m.ureg.joule / m.ureg.mole).dimensionality,
    # tests/test_algorithm_unit.py
    "lj_argon": lambda m: m.get_lj_scaling_factors(_argon(m)),
    "lj_other": lambda m: m.get_lj_scaling_factors(
        {"mass": 1.0 * m.ureg.gram / m.ureg.mole,
         "energy": 1.0e-21 * m.ureg.joule,
         "length": 1.0 * m.ureg.nanometer},
        {"diffusivity": (("length", 2), ("time", -1))}),
    "lj_time_seconds": lambda m: m.get_lj_scaling_factors(_argon(m))[
        "time"].m_as("second"),
    "scaling_factors": lambda m: m.get_scaling_factors(
        {"length": 2.0, "time": 4.0},
        {"velocity": (("length", 1), ("time", -1))}),
    "strip_number": lambda m: m.strip_unit(90.0, "deg"),
    "strip_number_unit": lambda m: m.strip_unit(90.0, m.ureg.degree),
    "strip_plain": lambda m: m.strip_unit(1.380649e-23),
    "strip_quantity": lambda m: m.strip_unit(
        1.380649e-23 * m.ureg.joule * m.ureg.kelvin**-1),
    "strip_to_string": lambda m: m.strip_unit(
        9.80665 * m.ureg.meter / m.ureg.second**2, "foot/second**2"),
    "strip_to_unit": lambda m: m.strip_unit(
        9.80665 * m.ureg.meter / m.ureg.second**2,
        m.ureg.foot / m.ureg.second**2),
    "strip_array": lambda m: m.strip_unit(
        m.Q_(np.array([50.0, 51.0, 52.0]), "nm"), "angstrom"),
    "strip_number_parsed_eq": lambda m: m.strip_unit(
        32.17404855643044, "foot/second**2")[1]
    == m.ureg.foot / m.ureg.second**2,
    # The conversion of conductivities and mobilities.
    "conductivity_si": lambda m: m.transport._conductivity_si(
        np.array([1.0, 2.5e-3]), False),
    "mobility_si": lambda m: m.transport.calculate_electrophoretic_mobility(
        np.ones((1, 2, 2)), [1.0, -1.0], [0.1, 0.1]),
}

ERRORS = {
    "incompatible": lambda m: (1.0 * m.ureg.meter).to(m.ureg.second),
    "undefined": lambda m: m.ureg.Unit("not_a_real_unit_xyz"),
    "injection": lambda m: m.ureg.Unit("import os"),
    "strip_incompatible": lambda m: m.strip_unit(m.Q_(1.0, "nm"),
                                                 "picosecond"),
    "float_of_dimensioned": lambda m: float(m.Q_(1.0, "nm")),
    "lj_plain_numbers": lambda m: m.get_lj_scaling_factors(
        {"mass": 39.948, "energy": 1.0, "length": 3.4}),
}


@pytest.mark.parametrize("name", CASES)
def test_units_match_jax(name):
    ref = _plain(CASES[name](JAX), JAX)
    port = _plain(CASES[name](PORT), PORT)
    _assert_same(port, ref)


@pytest.mark.parametrize("name", ERRORS)
def test_unit_errors_match_jax(name):
    with pytest.raises(Exception) as ref:
        ERRORS[name](JAX)
    with pytest.raises(Exception) as port:
        ERRORS[name](PORT)
    names = {JAX.UnitsError: "UnitsError", PORT.UnitsError: "UnitsError"}
    assert (names.get(port.type, port.type.__name__)
            == names.get(ref.type, ref.type.__name__))


def test_lj_argon_against_hand_values():
    """The argon LJ scales of ``tests/test_algorithm_unit.py`` from the
    port, against the same independent evaluation."""

    factors = PORT.get_lj_scaling_factors(_argon(PORT))
    na, kb, eps0 = 6.02214076e23, 1.380649e-23, 8.8541878128e-12
    m_kg = 39.948e-3 / na
    sigma = 3.4e-10
    eps_j = 3.9520829798737548e-25 * 4184
    tau = np.sqrt(m_kg * sigma**2 / eps_j)
    assert np.isclose(factors["time"].m_as("second"), tau)
    assert np.isclose(factors["temperature"].m_as("kelvin"), eps_j / kb)
    assert np.isclose(factors["pressure"].m_as("pascal"), eps_j / sigma**3)
    assert np.isclose(factors["charge"].m_as("coulomb"),
                      np.sqrt(4 * np.pi * eps0 * sigma * eps_j))
    assert np.isclose(factors["force"].m_as("joule/(mole*meter)"),
                      eps_j * na / sigma)


def test_conductivity_conversion_is_codata():
    """The (mol e)^2 -> C^2 factor of the conductivities is e^2 N_A with
    the CODATA 2018 values, to rtol 1e-12."""

    e, na = 1.602176634e-19, 6.02214076e23
    got = port_transport._conductivity_si(np.array([1.0]), False)
    np.testing.assert_allclose(got, [e * e * na], rtol=1e-12)
    np.testing.assert_array_equal(
        port_transport._conductivity_si(np.array([1.0]), True), [1.0])


def test_openmm_quantities_raise_without_openmm():
    """No OpenMM on this machine: a value that claims to be an
    ``openmm.unit`` quantity raises the port's UnitsError."""

    assert port_pkg.FOUND_OPENMM == jax_pkg.FOUND_OPENMM
    fake = type("Quantity", (), {"__module__": "openmm.unit.quantity"})()
    with pytest.raises(PORT.UnitsError):
        PORT.strip_unit(fake, "nanometer")
