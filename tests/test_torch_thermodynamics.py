"""The port's thermodynamics against the JAX package's functions.

``ConstantVolumeHeatCapacity`` reads LAMMPS and OpenMM logs with the
port's own parser (the JAX class uses pandas): its energies and mean
temperature must equal the JAX class's exactly on logs whose numbers
pandas parses correctly rounded (up to 15 significant digits), and its
heat capacity too.  On 17-digit numbers (the shortest round-trip form
OpenMM writes) pandas' default parser is off by an ulp in about half the
fields; the port equals Python's ``float`` there and the JAX class within
a few ulps.  The Green-Kubo and Einstein-Helfand functions run the same
float64 series through both packages' FFT correlators: within rtol 1e-10
(two FFT libraries).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("pandas")

from mdhelper_tpu import Q_ as JQ  # noqa: E402
from mdhelper_tpu.analysis import thermodynamics as jax_thermo  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.analysis import thermodynamics  # noqa: E402

FFT_RTOL = 1e-10


def _both(*args, **kwargs):
    """The JAX and the port's ConstantVolumeHeatCapacity, run."""

    return (jax_thermo.ConstantVolumeHeatCapacity(*args, **kwargs).run(),
            thermodynamics.ConstantVolumeHeatCapacity(*args, **kwargs).run())


def _same(j, p):
    np.testing.assert_array_equal(p.results.energies, j.results.energies)
    assert p.temperature == j.temperature
    assert p.results.heat_capacity == j.results.heat_capacity
    assert {k: str(v) for k, v in p.results.units.items()} == {
        k: str(v) for k, v in j.results.units.items()}


def _openmm_log(path, columns, values, sep=",", fmt="{:.6f}"):
    header = sep.join(f'"{c}"' for c in ["Step", *columns])
    lines = ["#" + header]
    lines += [sep.join([str(i), *(fmt.format(float(v)) for v in row)])
              for i, row in enumerate(values)]
    path.write_text("\n".join(lines) + "\n")
    return path


def test_openmm_log_equals_jax(tmp_path):
    """The JAX test's state-data file: total energy and temperature."""

    rng = np.random.default_rng(53)
    U = rng.normal(-100.0, 1.0, 500)
    temps = rng.normal(300.0, 3.0, 500)
    log = _openmm_log(tmp_path / "state.csv",
                      ["Total Energy (kJ/mole)", "Temperature (K)"],
                      np.stack((U, temps), axis=1))
    j, p = _both(log)
    assert p._format == "openmm"
    _same(j, p)


@pytest.mark.parametrize("sep", [",", "\t", ";"])
def test_openmm_kinetic_potential_equals_jax(tmp_path, sep):
    """Kinetic + potential energy (no total), other separators, 10
    significant digits."""

    rng = np.random.default_rng(1)
    values = np.stack((rng.normal(5000.0, 50.0, 300),
                       rng.normal(-20000.0, 80.0, 300),
                       rng.normal(310.0, 4.0, 300),
                       rng.normal(1.0, 0.01, 300)), axis=1)
    log = _openmm_log(tmp_path / "state.txt",
                      ["Kinetic Energy (kJ/mole)",
                       "Potential Energy (kJ/mole)", "Temperature (K)",
                       "Density (g/mL)"], values, sep=sep, fmt="{:.10g}")
    j, p = _both(log, sep=sep)
    _same(j, p)


def test_openmm_shortest_repr_fields(tmp_path):
    """17-digit fields: the port's energies are Python's correctly rounded
    floats of the text; pandas' (the JAX class's) are within 2 ulps and
    differ from them somewhere.  The heat capacities agree within 1e-12
    (ROADMAP Queue 3)."""

    rng = np.random.default_rng(17)
    U = rng.normal(-1234.5, 7.0, 400)
    temps = rng.normal(300.0, 3.0, 400)
    log = _openmm_log(tmp_path / "repr.csv",
                      ["Total Energy (kJ/mole)", "Temperature (K)"],
                      np.stack((U, temps), axis=1), fmt="{!r}")
    j, p = _both(log)
    text = [line.split(",") for line in log.read_text().split("\n")[1:-1]]
    np.testing.assert_array_equal(p.results.energies,
                                  [float(row[1]) for row in text])
    ulps = np.abs(j.results.energies - p.results.energies) / np.spacing(
        np.abs(p.results.energies))
    assert ulps.max() <= 2 and ulps.max() > 0
    assert p.results.heat_capacity == pytest.approx(j.results.heat_capacity,
                                                    rel=1e-12)


def _lammps_log(path, columns, values, minimize=False):
    """A LAMMPS log with a thermo table of `columns` (after a minimization
    section with its own table when `minimize`)."""

    head = ["LAMMPS (2 Aug 2023)", "units real", "read_data polymer.data",
            "thermo_style custom step temp etotal"]
    if minimize:
        head += ["minimize 1.0e-4 1.0e-6 100 1000",
                 "   Step          Temp          TotEng    ",
                 "         0   0             -1502.25      ",
                 "        37   0             -1633.0017    ",
                 "Loop time of 0.0432 on 4 procs for 37 steps with 4000 atoms",
                 "", "Minimization stats:",
                 "  Stopping criterion = energy tolerance",
                 "  Energy initial, next-to-last, final = ",
                 "     -1502.25  -1632.9  -1633.0017",
                 "  Iterations, force evaluations = 37 70", "",
                 "velocity all create 300.0 4928459",
                 f"run {len(values)}"]
    else:
        head += [f"run {len(values)}"]
    rows = [" ".join(f"{v:12.8g}" if k else f"{int(v):10d}"
                     for k, v in enumerate(row)) for row in values]
    table = ["   " + "   ".join(["Step", *columns]), *rows,
             f"Loop time of 1.23 on 4 procs for {len(values)} steps with "
             "4000 atoms", "", "Performance: 12.3 ns/day", "Total wall "
             "time: 0:00:01"]
    path.write_text("\n".join(head + table) + "\n")
    return path


def test_lammps_log_equals_jax(tmp_path):
    """The JAX test's log: Temp and TotEng, reduced units, a given
    temperature."""

    rng = np.random.default_rng(53)
    U = rng.normal(-40.0, 0.5, 200)
    temps = rng.normal(1.2, 0.01, 200)
    rows = "\n".join(f"{i} {t:.6f} {u:.6f}"
                     for i, (t, u) in enumerate(zip(temps, U)))
    log = tmp_path / "log.lammps"
    log.write_text("LAMMPS (fake)\nrun 200\n"
                   f"Step Temp TotEng\n{rows}\nLoop time of 1.0 on 1 procs\n")
    j, p = _both(log, temperature=1.2, reduced=True)
    assert p._format == "lammps"
    _same(j, p)


@pytest.mark.parametrize("columns", [
    ["Temp", "KinEng", "PotEng", "Press"],
    ["Temp", "KinEng", "E_bond", "E_angle", "E_dihed", "E_impro", "E_vdwl",
     "E_coul", "E_long", "Press"],
], ids=["kinetic_potential", "kinetic_terms"])
def test_lammps_minimized_log_equals_jax(tmp_path, columns):
    """A log that minimizes first (its table skipped), then runs:
    kinetic + potential, or kinetic + every per-term energy (nine columns
    summed one after another, as pandas adds a row); the temperature from
    the log's mean."""

    rng = np.random.default_rng(9)
    n = 250
    values = np.column_stack([
        np.arange(n) * 100,
        rng.normal(300.0, 3.0, n),
        *(rng.normal(rng.uniform(-5000, 5000), rng.uniform(1, 50), n)
          for _ in columns[1:]),
    ])
    log = _lammps_log(tmp_path / "log.lammps", columns, values,
                      minimize=True)
    j, p = _both(log)
    assert p._format == "lammps"
    assert len(p.results.energies) == n
    _same(j, p)
    p2 = thermodynamics.ConstantVolumeHeatCapacity(log).run(start=10,
                                                           stop=200, step=3)
    j2 = jax_thermo.ConstantVolumeHeatCapacity(log).run(start=10, stop=200,
                                                       step=3)
    assert p2.results.heat_capacity == j2.results.heat_capacity


def test_energies_equal_jax():
    rng = np.random.default_rng(53)
    U = rng.normal(100.0, 2.0, 5000)
    j, p = _both(energies=U, temperature=2.0, reduced=True)
    _same(j, p)
    U = rng.normal(-500.0, 5.0, 2000)
    j = jax_thermo.ConstantVolumeHeatCapacity(
        energies=U, temperature=JQ(300.0, "K")).run(frames=np.arange(0, 2000,
                                                                     2))
    p = thermodynamics.ConstantVolumeHeatCapacity(
        energies=U, temperature=Q_(300.0, "K")).run(frames=np.arange(0, 2000,
                                                                     2))
    assert p.results.heat_capacity == j.results.heat_capacity
    na, kb = 6.02214076e23, 1.380649e-23
    var = U[::2].var()
    assert p.results.heat_capacity == pytest.approx(
        var * 1e6 / (na**2 * kb * 300.0**2) / 1000, rel=1e-12)


def test_heat_capacity_validation_matches_jax(tmp_path):
    odd = tmp_path / "odd.log"
    odd.write_text("nothing to read here\n1 2 3\n")
    bad_lammps = tmp_path / "bad.lammps"
    bad_lammps.write_text("PotEng only\n")
    for cls in (jax_thermo.ConstantVolumeHeatCapacity,
                thermodynamics.ConstantVolumeHeatCapacity):
        with pytest.raises(ValueError, match="No log file or energy"):
            cls()
        with pytest.raises(ValueError, match="temperature"):
            cls(energies=np.ones(10))
        with pytest.raises(ValueError, match="Could not determine"):
            cls(odd)
        with pytest.raises(ValueError, match="No thermodynamic data"):
            cls(bad_lammps)
        with pytest.raises(ValueError, match="Invalid log format"):
            cls(bad_lammps, log_format="gromacs")


def _series(rng, n, c, memory=0.9):
    """An AR(1) series ``(n, c)`` of unit variance and correlation
    ``memory^k``."""

    x = np.empty((n, c))
    x[0] = rng.normal(size=c)
    noise = rng.normal(size=(n, c)) * np.sqrt(1 - memory**2)
    for t in range(1, n):
        x[t] = memory * x[t - 1] + noise[t]
    return x


def _close(p, j, keys):
    for key in keys:
        np.testing.assert_allclose(p[key], j[key], rtol=FFT_RTOL,
                                   atol=FFT_RTOL * np.abs(j[key]).max())


@pytest.mark.parametrize("method", ["green-kubo", "einstein"])
@pytest.mark.parametrize("shape", ["one", "three", "tensor"])
@pytest.mark.parametrize("reduced", [False, True])
def test_shear_viscosity_matches_jax(method, shape, reduced):
    rng = np.random.default_rng(4)
    series = 40.0 * _series(rng, 3000, 9)
    pressures = {"one": series[:, 0], "three": series[:, :3],
                 "tensor": series.reshape(-1, 3, 3)}[shape]
    kwargs = dict(method=method, reduced=reduced, fit_interval=(0.02, 0.2))
    j = jax_thermo.calculate_shear_viscosity(pressures, 8.0e4, 300.0, 0.002,
                                             **kwargs)
    p = thermodynamics.calculate_shear_viscosity(pressures, 8.0e4, 300.0,
                                                 0.002, **kwargs,
                                                 device="cpu")
    assert set(p) == set(j)
    np.testing.assert_array_equal(p.times, j.times)
    if method == "green-kubo":
        _close(p, j, ["acf", "running_viscosity"])
    else:
        # The Helfand MSD at lag m is a difference of FFT sums of order
        # N max G^2 over the N - m window origins: within FFT_RTOL N
        # max|MSD| at the last lags; the running viscosity is the same
        # constant times each package's own gradient of it.
        msd = j.helfand_msd
        np.testing.assert_allclose(p.helfand_msd, msd, rtol=0,
                                   atol=FFT_RTOL * len(msd)
                                   * np.abs(msd).max())
        slope = np.gradient(msd, 0.002)
        k = int(np.argmax(np.abs(slope)))
        np.testing.assert_allclose(
            p.running_viscosity,
            j.running_viscosity[k] / slope[k]
            * np.gradient(p.helfand_msd, 0.002), rtol=1e-12,
            atol=1e-12 * np.abs(j.running_viscosity).max())
    assert p.viscosity == pytest.approx(j.viscosity, rel=1e-8)
    if not reduced:
        assert {k: str(v) for k, v in p.units.items()} == {
            k: str(v) for k, v in j.units.items()}


def test_green_kubo_integral_is_closed_form():
    """An AR(1) stress of variance s^2 and correlation a^k integrates (by
    the trapezoid rule) to s^2 dt (1 + a) / (2 (1 - a)): the viscosity is
    that times V / kT, within 5 % on 200,000 samples of three components;
    Einstein-Helfand agrees within 5 %."""

    rng = np.random.default_rng(8)
    a, dt, s = 0.8, 0.002, 50.0
    pressures = s * _series(rng, 200_000, 3, memory=a)
    gk = thermodynamics.calculate_shear_viscosity(
        pressures, 1.0, 1.0, dt, reduced=True, device="cpu")
    window = 200
    expected = s**2 * dt * (1 + a) / (2 * (1 - a))
    assert gk.running_viscosity[window] == pytest.approx(expected, rel=0.05)
    eh = thermodynamics.calculate_shear_viscosity(
        pressures, 1.0, 1.0, dt, reduced=True, method="einstein",
        fit_interval=(0.0005, 0.002), device="cpu")
    assert eh.viscosity == pytest.approx(expected, rel=0.05)


@pytest.mark.parametrize("reduced", [False, True])
def test_conductivities_match_jax(reduced):
    rng = np.random.default_rng(6)
    flux = 0.01 * _series(rng, 2000, 3)
    for name in ("calculate_thermal_conductivity",
                 "calculate_ionic_conductivity"):
        for series in (flux, flux[:, 0]):
            j = getattr(jax_thermo, name)(series, 5.0e4, 300.0, 0.001,
                                          reduced=reduced)
            p = getattr(thermodynamics, name)(series, 5.0e4, 300.0, 0.001,
                                              reduced=reduced, device="cpu")
            assert set(p) == set(j)
            _close(p, j, ["times", "acf", "running_conductivity"])
            assert p.conductivity == pytest.approx(j.conductivity, rel=1e-8)


def test_quantity_inputs_match_jax():
    """Quantities convert to the working units in both packages."""

    rng = np.random.default_rng(2)
    flux = _series(rng, 1000, 3)
    j = jax_thermo.calculate_thermal_conductivity(
        JQ(flux, "kJ / mol / angstrom**2 / ps"), JQ(50.0, "nm**3"),
        JQ(300.0, "K"), JQ(2.0, "fs"))
    p = thermodynamics.calculate_thermal_conductivity(
        Q_(flux, "kJ / mol / angstrom**2 / ps"), Q_(50.0, "nm**3"),
        Q_(300.0, "K"), Q_(2.0, "fs"), device="cpu")
    _close(p, j, ["times", "acf", "running_conductivity"])
    j = jax_thermo.calculate_ionic_conductivity(
        JQ(flux, "elementary_charge * nm / ps"), 5.0e4, 300.0, 0.001)
    p = thermodynamics.calculate_ionic_conductivity(
        Q_(flux, "elementary_charge * nm / ps"), 5.0e4, 300.0, 0.001,
        device="cpu")
    _close(p, j, ["acf", "running_conductivity"])


def test_transport_validation_matches_jax():
    good = np.ones((10, 3))
    cases = [
        ("calculate_shear_viscosity", (good, 1.0, 1.0, 1.0),
         dict(method="bad"), "Invalid method"),
        ("calculate_shear_viscosity", (good, 1.0, 1.0, 1.0),
         dict(fit_interval=(0.5, 0.1)), "fit_interval"),
        ("calculate_shear_viscosity", (np.ones((10, 2, 3)), 1.0, 1.0, 1.0),
         {}, "tensor series"),
        ("calculate_shear_viscosity", (np.ones((2, 2, 2, 2)), 1.0, 1.0, 1.0),
         {}, "pressures must have shape"),
        ("calculate_ionic_conductivity", (np.ones((10, 2)), 1.0, 1.0, 1.0),
         {}, "current must have shape"),
        ("calculate_thermal_conductivity", (np.ones((4, 2, 2)), 1.0, 1.0,
                                            1.0), {}, "flux series"),
    ]
    for name, args, kwargs, match in cases:
        with pytest.raises(ValueError, match=match):
            getattr(jax_thermo, name)(*args, **kwargs)
        with pytest.raises(ValueError, match=match):
            getattr(thermodynamics, name)(*args, **kwargs, device="cpu")


def test_no_pandas_in_the_port():
    """The port's module parses logs without pandas (the card's machine
    has none): importing it leaves pandas out of its namespace."""

    assert not hasattr(thermodynamics, "pd")
    assert "pandas" not in thermodynamics.__dict__
