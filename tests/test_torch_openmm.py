"""The port's ``openmm`` package and the OpenMM branches of
``algorithm.unit`` against the JAX package's, on the CPU.

They need no OpenMM installed, and go through fakes where it would be:

* the energy expressions, the image-charge lattice sums, the FFT mesh
  sizes and ``file.NetCDFFile`` need no OpenMM and run as they are;
* ``system.py`` runs on the fakes of ``tests/test_openmm_mock.py``
  (copied below), patched into both packages' modules, and the fake
  systems, topologies and forces they leave are compared;
* ``pair``, ``bond``, ``topology``, ``reporter``, ``utility.optimize_pme``
  and the ``algorithm.unit`` branches run under a fake ``openmm`` package
  (``openmm``, ``openmm.unit``, ``openmm.app``) put into ``sys.modules``
  for one test, with both packages' ``openmm`` subpackages imported anew
  under it and every module it made importable removed afterwards.

Both packages do the same arithmetic on the same inputs, so everything
is held equal, exactly.
"""

import importlib
import importlib.machinery
from contextlib import nullcontext
import itertools
import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")
pytest.importorskip("mpmath")

from mdhelper_tpu.algorithm import topology as jax_topology  # noqa: E402
from mdhelper_tpu.algorithm import unit as jax_unit  # noqa: E402
from mdhelper_tpu.openmm import expressions as jax_ex  # noqa: E402
from mdhelper_tpu.openmm import file as jax_file  # noqa: E402
from mdhelper_tpu.openmm import system as jax_system  # noqa: E402
from mdhelper_tpu.openmm import utility as jax_utility  # noqa: E402

import mdhelper_tpu as jax_pkg  # noqa: E402
import mdhelper_tpu_torch as port_pkg  # noqa: E402
from mdhelper_tpu_torch.algorithm import topology as port_topology  # noqa: E402
from mdhelper_tpu_torch.algorithm import unit as port_unit  # noqa: E402
from mdhelper_tpu_torch.openmm import expressions as ex  # noqa: E402
from mdhelper_tpu_torch.openmm import file as port_file  # noqa: E402
from mdhelper_tpu_torch.openmm import system as port_system  # noqa: E402
from mdhelper_tpu_torch.openmm import utility as port_utility  # noqa: E402


def _describe(obj):
    """A comparable tree of `obj`: arrays as (dtype, shape, values), fake
    quantities and units by value, factor and names, other objects by
    their type and attributes."""

    if isinstance(obj, np.ndarray):
        if obj.dtype == object:
            return ("objects", [_describe(x) for x in obj])
        return (str(obj.dtype), obj.shape, obj.tolist())
    if isinstance(obj, (list, tuple)):
        return [_describe(x) for x in obj]
    if isinstance(obj, dict):
        return sorted((_describe(k), _describe(v)) for k, v in obj.items())
    if isinstance(obj, (str, int, float, bool, type(None), np.generic)):
        return obj
    if isinstance(obj, (types.FunctionType, type)):
        return obj.__qualname__
    state = {k: v for k, v in vars(obj).items() if not k.startswith("_x")}
    return (type(obj).__name__, _describe(state))


# -- the energy expressions ---------------------------------------------------

#: the argument sets of tests/test_openmm_expressions.py and
#: tests/test_openmm_expressions_numeric.py.
EXPRESSION_CALLS = [
    ("coul_gauss_energy", (), {}),
    ("coul_gauss_energy", ("default",), {}),
    ("coul_gauss_energy", ("core",), {}),
    ("coul_gauss_energy", ("alpha12=0.5;", ["zeta"]), {}),
    ("ewald_g", (1.2, 1e-4), {}),
    ("pme_mesh_dimensions", (3.1, np.array([4.0, 4.0, 8.0]), 1e-4), {}),
    ("dpd_energy", (1.0,), {}),
    ("dpd_energy", (1.0, "A12=sqrt(A1*A2);"), {}),
    ("dpd_energy", (0.9,), {"mix": "A12=sqrt(A1*A2);"}),
    ("gauss_energy", (2.0, 1.5), {}),
    ("gauss_energy", (2.0, 2.0), {"shift": False, "mix": "arithmetic"}),
    ("gauss_energy", (2.0, 2.0), {"mix": "core", "known_globals": ("A",)}),
    ("gauss_energy", (1.1, 1.1), {"shift": False, "mix": "core",
                                  "known_globals": ("A",)}),
    ("gauss_energy", (1.1, 1.1), {"mix": "core"}),
    ("gauss_energy", (2.0, 2.0), {"mix": "A=3;core", "per_params": ["q"]}),
] + [
    ("gauss_energy", (1.2, 1.0), {"shift": shift, "mix": mix})
    for shift in (True, False) for mix in ("geometric", "arithmetic")
] + [
    ("ljts_energy", (3.0, 2.5), {}),
    ("ljts_energy", (3.0, 3.0), {"shift": False, "mix": "sixthpower"}),
    ("ljts_energy", (3.0, 3.0), {"shift": False, "mie": True,
                                 "powers": (14, 7)}),
    ("ljts_energy", (3.0, 3.0), {"wca": True}),
    ("ljts_energy", (3.0, 3.0), {"mie": True, "wca": True}),
    ("ljts_energy", (1.3, 1.3), {"shift": False,
                                 "coefs": {"A": 2.0, "B": 3.0, "C": 1.5},
                                 "powers": {"r": 9, "a": 3}}),
    ("ljts_energy", (1.5, 1.5), {"shift": False, "powers": (14, 7),
                                 "mie": True}),
    ("ljts_energy", (1.5, 1.5), {"wca": True, "mix": "arithmetic"}),
] + [
    ("ljts_energy", (1.2, 1.0), {"shift": shift, "mix": mix})
    for shift in (True, False)
    for mix in ("arithmetic", "geometric", "sixthpower")
] + [
    ("solvation_energy", (2.0,), {}),
    ("solvation_energy", (1.1,), {"mix": "arithmetic"}),
    ("solvation_energy", (1.1,), {"mix": "geometric"}),
    ("yukawa_energy", (2.0, 2.0), {}),
    ("yukawa_energy", (2.0, 1.5), {"known_globals": ("kappa",)}),
    ("yukawa_energy", (2.0, 2.0), {"shift": False,
                                   "mix": "geometric;kappa=2.5"}),
    ("yukawa_energy", (1.2, 1.0), {"mix": "geometric"}),
] + [
    ("yukawa_energy", (1.2, 1.0), {"shift": shift, "mix": "geometric",
                                   "known_globals": ("kappa",)})
    for shift in (True, False)
] + [("fene_energy", (), {})]


@pytest.mark.parametrize("name, args, kwargs", EXPRESSION_CALLS,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(EXPRESSION_CALLS)])
def test_expressions_equal_jax(name, args, kwargs):
    """Every expression string and parameter list, or the error raised,
    equals the JAX package's."""

    outcomes = []
    for module in (ex, jax_ex):
        try:
            outcomes.append(("ok", _describe(getattr(module, name)(
                *args, **kwargs))))
        except ValueError as error:
            outcomes.append(("raised", str(error)))
    assert outcomes[0] == outcomes[1]


def test_expression_names_equal_jax():
    assert ex.__all__ == jax_ex.__all__


# -- the lattice sums and the mesh sizes -------------------------------------


@pytest.mark.parametrize("gamma", [-1.0, -0.8, -0.5, 0.0, 0.3, 0.5, 0.9,
                                   1.0])
def test_ic_beta_equals_jax(gamma):
    for x in (0.0, 0.25, 0.5, 0.7, 1.0):
        assert port_system._ic_beta(gamma, x) == jax_system._ic_beta(gamma,
                                                                     x)
    for module in (port_system, jax_system):
        with pytest.raises(ValueError, match="between 0 and 1"):
            module._ic_beta(gamma, 1.5)


@pytest.mark.parametrize("start", [5, 37, 200])
def test_fft_legal_mesh_sizes_equal_jax(start):
    assert (list(itertools.islice(port_utility._fft_legal_mesh_sizes(start),
                                  60))
            == list(itertools.islice(jax_utility._fft_legal_mesh_sizes(start),
                                     60)))


def test_openmm_functions_raise_without_openmm():
    """The OpenMM functions of system.py and utility.py raise ImportError
    here, as in the JAX package; ``unit`` falls back to the registry."""

    from mdhelper_tpu_torch.openmm import unit

    for fn, args in ((port_system.register_particles, (None, None)),
                     (port_system.add_electric_field, (None, None, 1.0)),
                     (port_system.estimate_pressure_tensor, (None,)),
                     (port_system.add_slab_correction,
                      (None, None, None, 1, 1, 1)),
                     (port_system.add_image_charges,
                      (None, None, None, 1, 1, 1)),
                     (port_utility.optimize_pme,
                      (None, None, None, None, {}, 1, 2))):
        with pytest.raises(ImportError, match="OpenMM"):
            fn(*args)
    assert np.isclose(unit.VACUUM_PERMITTIVITY.magnitude, 8.854187812813e-12)
    assert str(unit.VACUUM_PERMITTIVITY.units) == str(
        port_pkg.ureg.farad / port_pkg.ureg.meter)


# -- NetCDF files -------------------------------------------------------------


def _netcdf_frames():
    rng = np.random.default_rng(5)
    n_frames, n_atoms = 4, 7
    return {
        "time": np.arange(n_frames) * 0.5,
        "coordinates": (rng.random((n_frames, n_atoms, 3)) * 20).astype(
            np.float32),
        "velocities": rng.normal(size=(n_frames, n_atoms, 3)).astype(
            np.float32),
        "forces": rng.normal(size=(n_frames, n_atoms, 3)).astype(np.float32),
        "cell_lengths": np.tile([20.0, 21.0, 22.0], (n_frames, 1)),
        "cell_angles": np.tile([90.0, 80.0, 70.0], (n_frames, 1)),
    }


def _write_trajectory(module, path, split):
    """`split` frames, then the rest appended through mode "a"."""

    data = _netcdf_frames()
    first = {k: v[:split] for k, v in data.items()}
    rest = {k: v[split:] for k, v in data.items()}
    module.NetCDFFile.write_model(
        path, first["time"], first["coordinates"], first["velocities"],
        first["forces"], first["cell_lengths"], first["cell_angles"]).close()
    f = module.NetCDFFile(path, "a")
    f.write_model(rest["time"], rest["coordinates"], rest["velocities"],
                  rest["forces"], rest["cell_lengths"], rest["cell_angles"])
    f.close()
    return data


def _read_back(module, path):
    f = module.NetCDFFile(path, "r")
    out = {
        "frames": f.get_num_frames(), "atoms": f.get_num_atoms(),
        "time": f.get_times(units=False),
        "coordinates": f.get_positions(units=False),
        "velocities": f.get_velocities(units=False),
        "forces": f.get_forces(units=False),
        "dimensions": f.get_dimensions(units=False),
        "some": f.get_positions(frames=[0, 2], units=False),
        "attrs": {k: getattr(f._nc, k) for k in (
            "Conventions", "ConventionVersion", "program", "programVersion",
            "title")},
        "units": {k: getattr(f._nc.variables[k], "units", None)
                  for k in f._nc.variables},
    }
    quantity = f.get_positions(frames=1)
    out["quantity"] = (np.asarray(quantity.magnitude).tolist(),
                       str(quantity.units))
    f.close()
    return out


def _assert_same_reads(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert _describe(a[key]) == _describe(b[key]), key


def test_netcdf_trajectories_cross_read(tmp_path):
    """A trajectory written by each package (two frames, then two
    appended) has the same bytes, and reads back equal through the other
    package, in variables and attributes.  No header field is skipped: the
    only one that names the machine, ``title``, holds the host name in
    both."""

    paths = {}
    for name, module in (("port", port_file), ("jax", jax_file)):
        paths[name] = str(tmp_path / f"{name}.nc")
        data = _write_trajectory(module, paths[name], split=2)
    assert (open(paths["port"], "rb").read()
            == open(paths["jax"], "rb").read())
    reads = {(writer, reader): _read_back(module, paths[writer])
             for writer in paths
             for reader, module in (("port", port_file), ("jax", jax_file))}
    base = reads["port", "port"]
    for key, read in reads.items():
        _assert_same_reads(read, base)
    np.testing.assert_array_equal(base["coordinates"], data["coordinates"])
    np.testing.assert_array_equal(base["dimensions"][1], data["cell_angles"])
    assert base["attrs"]["program"] == "MDHelper-TPU"


@pytest.mark.parametrize("remd", [None, "temp", "multi"])
def test_netcdf_restart_headers_equal_jax(tmp_path, remd):
    """Restart files with each REMD layout: the same bytes from both
    packages, read back equal by both, and the same errors for missing
    REMD values."""

    kwargs = {None: {}, "temp": {"temp0": 300.0},
              "multi": {"remd_dimtype": [1, 3], "remd_indices": [2, 1],
                        "remd_repidx": 4, "remd_crdidx": 5,
                        "remd_values": [300.0, 1.5]}}[remd]
    data = _netcdf_frames()
    paths = {}
    for name, module in (("port", port_file), ("jax", jax_file)):
        paths[name] = str(tmp_path / f"{name}.ncrst")
        f = module.NetCDFFile.write_header(
            paths[name], 7, True, True, False, restart=True, remd=remd,
            **kwargs)
        # The restart payload as NetCDFFile.write_file stores it.
        f._nc.variables["time"][0] = 2.5
        for key, value in (
                ("coordinates", data["coordinates"][0].astype(float)),
                ("velocities", data["velocities"][0].astype(float)),
                ("cell_lengths", data["cell_lengths"][0]),
                ("cell_angles", data["cell_angles"][0])):
            f._nc.variables[key][:] = value
        f.close()
        if remd is not None:
            with pytest.raises(ValueError, match="must be provided"):
                module.NetCDFFile.write_header(
                    str(tmp_path / f"{name}-bad.ncrst"), 7, True, True,
                    False, restart=True, remd=remd,
                    **{k: v for k, v in kwargs.items()
                       if k == "remd_dimtype"})
    assert (open(paths["port"] + ".nc", "rb").read()
            == open(paths["jax"] + ".nc", "rb").read())
    for module in (port_file, jax_file):
        f = module.NetCDFFile(paths["port"] + ".nc", "r")
        assert f._restart and f.get_num_atoms() == 7
        np.testing.assert_array_equal(
            f.get_positions(units=False),
            data["coordinates"][0].astype(float))
        f.close()


def test_netcdf_write_file_needs_openmm(tmp_path):
    for module in (port_file, jax_file):
        with pytest.raises(ImportError, match="OpenMM"):
            module.NetCDFFile.write_file(str(tmp_path / "x.nc"), None)


# -- system.py on the mock fakes ----------------------------------------------
# The fakes of tests/test_openmm_mock.py, copied: a fake quantity and unit
# symbol whose conversions are the identity, and the recording system,
# topology and forces.


def _val(x):
    return x.v if isinstance(x, FQ) else x


class FQ:
    """Fake openmm.unit.Quantity: wraps a value, all unit ops are
    identity."""

    __array_ufunc__ = None

    def __init__(self, v):
        self.v = v

    def value_in_unit(self, u):
        return self.v

    def in_units_of(self, u):
        return self

    def __mul__(self, o):
        return FQ(self.v * _val(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return FQ(self.v / _val(o))

    def __rtruediv__(self, o):
        return FQ(_val(o) / self.v)

    def __pow__(self, p):
        return FQ(self.v**p)

    def __getitem__(self, i):
        return FQ(self.v[i])

    def __setitem__(self, i, value):
        self.v[i] = _val(value)

    def __float__(self):
        return float(self.v)


class FU:
    """Fake unit symbol: composes to FU, attaches to values as FQ."""

    __array_ufunc__ = None

    def __mul__(self, o):
        return FU() if isinstance(o, FU) else FQ(o)

    def __rmul__(self, o):
        return FQ(o)

    def __truediv__(self, o):
        return FU()

    __rtruediv__ = __truediv__

    def __pow__(self, p):
        return FU()


MOCK_UNIT = types.SimpleNamespace(
    Quantity=FQ,
    nanometer=FU(),
    elementary_charge=FU(),
    kilojoule_per_mole=FU(),
    AVOGADRO_CONSTANT_NA=FQ(6.02214076e23),
    BOLTZMANN_CONSTANT_kB=FQ(1.380649e-23),
)


class Recorder:
    """A fake OpenMM object that records every call made on it."""

    def __init__(self, *args):
        self.calls = [("__init__", args)]

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def record(*args):
            self.calls.append((name, args))

        return record


class FakeExternalForce(Recorder):
    pass


class FakeCVForce(Recorder):
    pass


class FakeCustomIntegrator(Recorder):
    pass


class FakeLangevinMiddleIntegrator(Recorder):
    pass


MOCK_OPENMM = types.SimpleNamespace(
    CustomExternalForce=FakeExternalForce,
    CustomCVForce=FakeCVForce,
    CustomIntegrator=FakeCustomIntegrator,
    LangevinMiddleIntegrator=FakeLangevinMiddleIntegrator,
)


class FakeSystem:
    def __init__(self, n):
        self.n = n
        self.pbv = [
            np.array([4.0, 0, 0]),
            np.array([0, 4.0, 0]),
            np.array([0, 0, 6.0]),
        ]
        self.forces = []

    def getDefaultPeriodicBoxVectors(self):
        return self.pbv

    def setDefaultPeriodicBoxVectors(self, *pbv):
        self.pbv = list(pbv)

    def addParticle(self, mass):
        self.n += 1

    def getNumParticles(self):
        return self.n

    def addForce(self, force):
        self.forces.append(force)


class _Obj:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class FakeTopology:
    def __init__(self, n, dims):
        self._dims = np.asarray(dims, dtype=float)
        self.chains = [_Obj(index=0)]
        self.residues_ = [
            _Obj(index=i, name=f"R{i}", chain=self.chains[0])
            for i in range(n)
        ]
        self.atoms_ = [
            _Obj(name=f"A{i}", element=None, residue=self.residues_[i])
            for i in range(n)
        ]

    def getUnitCellDimensions(self):
        return FQ(self._dims)

    def setUnitCellDimensions(self, dims):
        self._dims = np.asarray(_val(dims), dtype=float)

    def getNumChains(self):
        return len(self.chains)

    def atoms(self):
        return iter(self.atoms_)

    def residues(self):
        return iter(self.residues_)

    def addChain(self):
        chain = _Obj(index=len(self.chains))
        self.chains.append(chain)
        return chain

    def addResidue(self, name, chain):
        residue = _Obj(index=len(self.residues_), name=name, chain=chain)
        self.residues_.append(residue)
        return residue

    def addAtom(self, name, element, residue):
        atom = _Obj(name=name, element=element, residue=residue)
        self.atoms_.append(atom)
        return atom


class FakeNonbondedForce:
    def __init__(self, charges):
        self.params = [(q, 1.0, 0.5) for q in charges]
        self.exceptions = []

    def getParticleParameters(self, i):
        return self.params[i]

    def addParticle(self, charge, sigma, epsilon):
        self.params.append((charge, sigma, epsilon))

    def getNumParticles(self):
        return len(self.params)

    def getNumExceptions(self):
        return len(self.exceptions)

    def getExceptionParameters(self, i):
        return self.exceptions[i]

    def addException(self, i, j, qq, sigma, epsilon):
        self.exceptions.append((i, j, qq, sigma, epsilon))


class FakeCustomNonbondedForce:
    def __init__(self, params_per_particle):
        self.params = [tuple(p) for p in params_per_particle]
        self.exclusions = []

    def getParticleParameters(self, i):
        return self.params[i]

    def addParticle(self, params):
        self.params.append(tuple(params))

    def getExclusionParticles(self, i):
        return self.exclusions[i]

    def addExclusion(self, i, j):
        self.exclusions.append((i, j))


class FakeIntegrator:
    def __init__(self, temp, fric, dt, n_cells):
        self.args = (temp, fric, dt, n_cells)


N = 6
LZ = 6.0
# atoms 0 and 5 are electrode (wall) atoms at z = 0 and z = LZ.
POSITIONS = np.array(
    [
        [0.5, 0.5, 0.0],
        [1.0, 1.0, 1.5],
        [2.0, 2.0, 3.0],
        [3.0, 1.0, 4.0],
        [1.0, 3.0, 5.0],
        [0.5, 0.5, LZ],
    ]
)
CHARGES = [0.5, 1.0, -1.0, 1.0, -1.0, -0.5]


@pytest.fixture
def mocked(monkeypatch):
    """Both packages' system modules on the mock fakes."""

    for module in (port_system, jax_system):
        monkeypatch.setattr(module, "openmm", MOCK_OPENMM)
        monkeypatch.setattr(module, "unit", MOCK_UNIT)
        monkeypatch.setattr(module, "ICLangevinIntegrator", FakeIntegrator)
        monkeypatch.setattr(module, "FOUND_ICPLUGIN", True)
        monkeypatch.setattr(module, "VACUUM_PERMITTIVITY", 8.8541878128e-12)


def _build(charges=CHARGES):
    system = FakeSystem(N)
    topology = FakeTopology(N, [4.0, 4.0, LZ])
    nbforce = FakeNonbondedForce(charges)
    nbforce.exceptions.append((1, 2, 0.25, 0.0, 0.0))  # bonded pair
    nbforce.exceptions.append((0, 1, 0.10, 0.0, 0.0))  # involves wall
    cnb = FakeCustomNonbondedForce([(q, 0.3, 1) for q in charges])
    cnb.exclusions.append((1, 2))
    cnb.exclusions.append((0, 1))
    return system, topology, nbforce, cnb


def _both(call):
    """``call(module, system, topology, nbforce, cnb)`` in both packages
    on fresh fakes: the described results and fakes of each, or the
    errors they raised."""

    outcomes = []
    for module in (port_system, jax_system):
        fakes = _build()
        try:
            result = call(module, *fakes)
        except (ValueError, ImportError) as error:
            outcomes.append(("raised", type(error).__name__, str(
                error).replace("mdhelper_tpu_torch.", "mdhelper_tpu.")))
            continue
        outcomes.append(_describe((result, fakes)))
    assert outcomes[0] == outcomes[1]
    return outcomes[0]


IMAGE_CHARGE_CASES = {
    "default": dict(),
    "custom_forces": dict(cnb={"charge": 0, "zero": [1],
                               "replace": {2: {1: 7}}}),
    "exclude": dict(exclude=True),
    "gamma_half": dict(gamma=0.5),
    "gamma_plus_one": dict(gamma=1.0),
    "four_cells": dict(n_cells=4),
    "charged": dict(charges=[0.5, 1.0, -1.0, 1.0, 1.0, -0.5]),
    "charged_gamma": dict(charges=[0.5, 1.0, -1.0, 1.0, 1.0, -0.5],
                          gamma=-0.7),
    "no_nbforce": dict(no_nbforce=True, cnb={"charge": 0}),
    "gamma_zero": dict(gamma=0.0),
    "cells_with_gamma": dict(gamma=0.5, n_cells=4),
    "no_charges": dict(no_nbforce=True),
}


@pytest.mark.parametrize("case", list(IMAGE_CHARGE_CASES))
def test_image_charges_equal_jax(mocked, case):
    """The image-charge bookkeeping, corrections and errors: the
    positions, integrator, system, topology and forces each package leaves
    are equal."""

    options = dict(IMAGE_CHARGE_CASES[case])
    charges = options.pop("charges", CHARGES)
    cnb_kwargs = options.pop("cnb", None)
    no_nbforce = options.pop("no_nbforce", False)

    def call(module, system, topology, nbforce, cnb):
        nbforce.params = [(q, 1.0, 0.5) for q in charges]
        cnb.params = [(q, 0.3, 1) for q in charges]
        return module.add_image_charges(
            system, topology, POSITIONS.copy(), 300.0, 1.0, 0.01,
            nbforce=None if no_nbforce else nbforce,
            cnbforces={cnb: cnb_kwargs} if cnb_kwargs is not None else None,
            **options)

    if no_nbforce and cnb_kwargs is not None:
        # Without a NonbondedForce the exclusions cannot be mirrored; both
        # packages fail alike there (nbforce.getNumExceptions on None).
        outcomes = []
        for module in (port_system, jax_system):
            with pytest.raises(AttributeError) as caught:
                call(module, *_build())
            outcomes.append(str(caught.value))
        assert outcomes[0] == outcomes[1]
        return
    _both(call)


@pytest.mark.parametrize("method", ["force", "integrator", "bad"])
@pytest.mark.parametrize("charges", ["neutral", "charged", "uniform"])
@pytest.mark.parametrize("z_scale", [3, 1.5, 6])
def test_slab_correction_equal_jax(mocked, method, charges, z_scale):
    q = {"neutral": CHARGES, "charged": [0.5, 1.0, -1.0, 1.0, 1.0, -0.5],
         "uniform": [0.0] * N}[charges]

    def call(module, system, topology, nbforce, cnb):
        nbforce.params = [(c, 1.0, 0.5) for c in q]
        return module.add_slab_correction(
            system, topology, nbforce, 300.0, 1.0, 0.002, axis=2,
            z_scale=z_scale, method=method)

    with pytest.warns(UserWarning) if z_scale != 3 else nullcontext():
        _both(call)


@pytest.mark.parametrize("options", [
    {}, {"axis": 0, "dielectric": 2.0}, {"atom_indices": 4},
    {"atom_indices": [1, 3, 5], "charge_index": 0},
])
def test_electric_field_equal_jax(mocked, options):
    _both(lambda module, system, topology, nbforce, cnb:
          module.add_electric_field(system, nbforce, 0.25, **options))


def test_register_particles_equal_jax(mocked):
    def call(module, system, topology, nbforce, cnb):
        module.register_particles(system, topology, 3, 12.0, name="C",
                                  nbforce=nbforce, charge=0.5, sigma=0.3,
                                  epsilon=0.2, cnbforces={cnb: (0.5, 0.3)})
        chain = topology.addChain()
        module.register_particles(None, topology, 2, chain=chain,
                                  resname="W", name="O")

    _both(call)


# -- the fake openmm package -----------------------------------------------


class FakeUnit:
    """An ``openmm.unit.Unit`` stand-in: a factor to SI and the named
    units it is made of."""

    __module__ = "openmm.unit.unit"
    __array_ufunc__ = None

    def __init__(self, factor=1.0, names=None):
        self.factor = factor
        self.names = dict(names or {})

    def iter_base_or_scaled_units(self):
        return [(types.SimpleNamespace(name=name.replace("_", " ")), p)
                for name, p in self.names.items()]

    def _combined(self, other, sign):
        names = dict(self.names)
        for name, p in other.names.items():
            names[name] = names.get(name, 0) + sign * p
        return FakeUnit(self.factor * other.factor**sign,
                        {k: v for k, v in names.items() if v})

    def __mul__(self, other):
        if isinstance(other, FakeUnit):
            return self._combined(other, 1)
        return FakeQuantity(other, self)

    def __rmul__(self, other):
        return FakeQuantity(other, self)

    def __truediv__(self, other):
        if isinstance(other, FakeUnit):
            return self._combined(other, -1)
        return FakeQuantity(1.0 / other, self)

    def __rtruediv__(self, other):
        return FakeQuantity(other, self**-1)

    def __pow__(self, p):
        return FakeUnit(self.factor**p, {k: v * p for k, v in
                                         self.names.items()})

    def __eq__(self, other):
        return (isinstance(other, FakeUnit) and self.factor == other.factor
                and self.names == other.names)

    def __hash__(self):
        return hash((self.factor, tuple(sorted(self.names.items()))))


class FakeQuantity:
    """An ``openmm.unit.Quantity`` stand-in over :class:`FakeUnit`."""

    __module__ = "openmm.unit.quantity"
    __array_ufunc__ = None

    def __init__(self, value, unit):
        self._value = value
        self.unit = unit

    @staticmethod
    def _split(other):
        if isinstance(other, FakeQuantity):
            return other._value, other.unit
        if isinstance(other, FakeUnit):
            return 1.0, other
        return other, FakeUnit()

    def value_in_unit(self, unit):
        return self._value * (self.unit.factor / unit.factor)

    def in_units_of(self, unit):
        return FakeQuantity(self.value_in_unit(unit), unit)

    def sqrt(self):
        return FakeQuantity(np.sqrt(self._value), self.unit**0.5)

    def __mul__(self, other):
        value, unit = self._split(other)
        return FakeQuantity(self._value * value, self.unit * unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        value, unit = self._split(other)
        return FakeQuantity(self._value / value, self.unit / unit)

    def __rtruediv__(self, other):
        value, unit = self._split(other)
        return FakeQuantity(value / self._value, unit / self.unit)

    def __pow__(self, p):
        return FakeQuantity(self._value**p, self.unit**p)

    def __add__(self, other):
        return FakeQuantity(self._value + other.value_in_unit(self.unit),
                            self.unit)

    def __sub__(self, other):
        return FakeQuantity(self._value - other.value_in_unit(self.unit),
                            self.unit)

    def __getitem__(self, index):
        return FakeQuantity(self._value[index], self.unit)

    def __len__(self):
        return len(self._value)


def _fake_unit_module():
    unit = types.ModuleType("openmm.unit")
    u = FakeUnit
    named = {
        "nanometer": u(1e-9, {"nanometer": 1}),
        "angstrom": u(1e-10, {"angstrom": 1}),
        "meter": u(1.0, {"meter": 1}),
        "picosecond": u(1e-12, {"picosecond": 1}),
        "dalton": u(1.66053906660e-27, {"dalton": 1}),
        "joule": u(1.0, {"joule": 1}),
        "kilojoule": u(1e3, {"kilojoule": 1}),
        "kilocalorie": u(4184.0, {"kilocalorie": 1}),
        "mole": u(1.0, {"mole": 1}),
        "kelvin": u(1.0, {"kelvin": 1}),
        "degree": u(np.pi / 180, {"degree": 1}),
        "elementary_charge": u(1.602176634e-19, {"elementary_charge": 1}),
        "farad": u(1.0, {"farad": 1}),
        "atmosphere": u(101325.0, {"atmosphere": 1}),
    }
    vars(unit).update(named)
    unit.Quantity, unit.Unit = FakeQuantity, FakeUnit
    unit.dimensionless = FakeUnit()
    unit.kilojoule_per_mole = named["kilojoule"] / named["mole"]
    unit.kilocalorie_per_mole = named["kilocalorie"] / named["mole"]
    unit.AVOGADRO_CONSTANT_NA = 6.02214076e23 / named["mole"]
    unit.BOLTZMANN_CONSTANT_kB = 1.380649e-23 * named["joule"] / named[
        "kelvin"]
    return unit


class FakeAtom:
    def __init__(self, index, residue):
        self.index, self.residue = index, residue


class FakeResidue:
    def __init__(self, index, chain):
        self.index, self.chain, self._xatoms, self._xbonds = (
            index, chain, [], [])

    def atoms(self):
        return iter(self._xatoms)

    def bonds(self):
        return iter(self._xbonds)


class FakeChain:
    def __init__(self, index):
        self.index, self._xresidues = index, []

    def residues(self):
        return iter(self._xresidues)


class FakeBond:
    def __init__(self, atom1, atom2):
        self.atom1, self.atom2 = atom1, atom2


class FakeAppTopology:
    """Two chains of two residues of two atoms, bonded within residues
    and across the first chain's residues; a cubic cell of 3 nm."""

    def __init__(self):
        self._xchains, self._xresidues = [], []
        self._xatoms, self._xbonds = [], []
        for c in range(2):
            chain = FakeChain(c)
            self._xchains.append(chain)
            for _ in range(2):
                residue = FakeResidue(len(self._xresidues), chain)
                chain._xresidues.append(residue)
                self._xresidues.append(residue)
                for _ in range(2):
                    atom = FakeAtom(len(self._xatoms), residue)
                    residue._xatoms.append(atom)
                    self._xatoms.append(atom)
                bond = FakeBond(*residue._xatoms)
                residue._xbonds.append(bond)
                self._xbonds.append(bond)
        self._xbonds.append(FakeBond(self._xatoms[1], self._xatoms[2]))

    def atoms(self):
        return iter(self._xatoms)

    def bonds(self):
        return iter(self._xbonds)

    def chains(self):
        return iter(self._xchains)

    def residues(self):
        return iter(self._xresidues)

    def getNumAtoms(self):
        return len(self._xatoms)

    def getUnitCellDimensions(self):
        return FakeQuantity(np.array([3.0, 3.0, 3.0]),
                            sys.modules["openmm.unit"].nanometer)

    def getPeriodicBoxVectors(self):
        return self.getUnitCellDimensions()


class FakeModeller:
    def __init__(self, topology, positions):
        self.topology, self.positions = topology, positions
        self.deleted = None

    def delete(self, items):
        self.deleted = [_item_name(i) for i in items]


def _item_name(item):
    if isinstance(item, FakeBond):
        return ("bond", item.atom1.index, item.atom2.index)
    return (type(item).__name__, item.index)


def _lengths_and_angles(pbv):
    """``app.internal.unitcell.computeLengthsAndAngles``: nm and
    radians."""

    nm = sys.modules["openmm.unit"].nanometer
    a, b, c = (np.asarray(v.value_in_unit(nm), float) for v in pbv)
    lengths = [float(np.linalg.norm(v)) for v in (a, b, c)]

    def angle(x, y):
        return float(np.arccos(x @ y / np.linalg.norm(x) / np.linalg.norm(y)))

    return (*lengths, angle(b, c), angle(a, c), angle(a, b))


class FakeNonbondedRecorder(Recorder):
    NoCutoff, CutoffPeriodic, PME = 0, 2, 4


class FakeCustomNonbondedRecorder(Recorder):
    NoCutoff, CutoffPeriodic = 0, 2


class FakeDiscrete2DFunction(Recorder):
    pass


class FakeCustomBondForce(Recorder):
    pass


def _fake_openmm_modules():
    """The fake ``openmm``, ``openmm.unit`` and ``openmm.app`` modules,
    each with a spec, as ``importlib.util.find_spec`` requires."""

    def module(name, package=True):
        made = types.ModuleType(name)
        made.__spec__ = importlib.machinery.ModuleSpec(
            name, None, is_package=package)
        if package:
            made.__path__ = []
        return made

    openmm = module("openmm")
    unit = _fake_unit_module()
    unit.__spec__ = importlib.machinery.ModuleSpec("openmm.unit", None)
    app = module("openmm.app")
    app.Topology, app.Atom, app.Residue, app.Chain = (
        FakeAppTopology, FakeAtom, FakeResidue, FakeChain)
    app.Modeller = FakeModeller
    app.topology = types.SimpleNamespace(Bond=FakeBond)
    app.internal = types.SimpleNamespace(unitcell=types.SimpleNamespace(
        computeLengthsAndAngles=_lengths_and_angles))
    openmm.unit, openmm.app = unit, app
    vars(openmm).update(
        CustomNonbondedForce=FakeCustomNonbondedRecorder,
        NonbondedForce=FakeNonbondedRecorder,
        CustomBondForce=FakeCustomBondForce,
        Discrete2DFunction=FakeDiscrete2DFunction,
        CustomExternalForce=FakeExternalForce,
        CustomCVForce=FakeCVForce,
        CustomIntegrator=FakeCustomIntegrator,
        LangevinMiddleIntegrator=FakeLangevinMiddleIntegrator,
        AmoebaMultipoleForce=type("AmoebaMultipoleForce", (Recorder,), {}),
        OpenMMException=type("OpenMMException", (Exception,), {}),
        System=Recorder, Integrator=Recorder, Context=Recorder,
        Platform=Recorder, State=Recorder, XmlSerializer=Recorder,
    )
    return {"openmm": openmm, "openmm.unit": unit, "openmm.app": app}


def _under_fake(name):
    return name.split(".")[0] == "openmm" or any(
        name == p or name.startswith(p + ".")
        for p in ("mdhelper_tpu.openmm", "mdhelper_tpu_torch.openmm"))


@pytest.fixture
def fake_openmm(monkeypatch):
    """The fake ``openmm`` package in ``sys.modules``, and both packages'
    ``openmm`` subpackages imported anew under it (each returned as
    ``(port, jax)`` by its module name); at teardown every module it made
    importable is removed and the original modules are put back."""

    saved = {n: m for n, m in sys.modules.items() if _under_fake(n)}
    parents = {pkg: vars(pkg).get("openmm") for pkg in (port_pkg, jax_pkg)}
    for name in saved:
        del sys.modules[name]
    sys.modules.update(_fake_openmm_modules())
    try:
        def load(module):
            return (importlib.import_module(f"mdhelper_tpu_torch.openmm."
                                            f"{module}"),
                    importlib.import_module(f"mdhelper_tpu.openmm.{module}"))

        yield load
    finally:
        for name in [n for n in sys.modules if _under_fake(n)]:
            del sys.modules[name]
        sys.modules.update(saved)
        for pkg, value in parents.items():
            if value is None:
                vars(pkg).pop("openmm", None)
            else:
                pkg.openmm = value


def test_fake_openmm_imports_every_module_and_leaves_nothing(fake_openmm):
    """Under the fake, both openmm packages import all nine modules, and
    ``find_spec`` (which both ``__init__`` call) finds the fake."""

    port, _ = fake_openmm("unit")
    import mdhelper_tpu.openmm as jax_package
    import mdhelper_tpu_torch.openmm as port_package

    assert port_package.__all__ == jax_package.__all__
    assert set(port_package.__all__) == {
        "expressions", "file", "bond", "pair", "reporter", "system",
        "topology", "unit", "utility"}
    assert importlib.util.find_spec("openmm") is not None
    assert port.VACUUM_PERMITTIVITY._value == 8.854187812813e-12


def test_fake_openmm_is_gone_after_its_test():
    assert "openmm" not in sys.modules
    assert importlib.util.find_spec("openmm") is None
    import mdhelper_tpu_torch.openmm as package

    assert package.__all__ == ["expressions", "file"]
    assert package.file is port_file


# -- pair and bond ------------------------------------------------------------


PAIR_CALLS = [
    ("coul_gauss", (1.2,), {}),
    ("coul_gauss", (1.2, 1e-5), {"g_ewald": 3.0,
                                 "dims": np.array([4.0, 4.0, 8.0]),
                                 "mix": "core",
                                 "global_params": {"EPS": 1.0}}),
    ("dpd", (1.0,), {"mix": "A12=sqrt(A1*A2);", "per_params": ["A"]}),
    ("dpd", (1.0, 1.5), {}),
    ("gauss", (1.5, 1.2), {"tab_funcs": {"T": np.eye(2)}}),
    ("gauss", (1.5,), {"mix": "core", "global_params": {"A": 2.0}}),
    ("gauss", (1.5,), {"mix": "core"}),
    ("lj_coul", (1.2,), {}),
    ("lj_coul", (1.2, 1e-5), {"g_ewald": 3.0,
                              "dims": np.array([4.0, 5.0, 6.0])}),
    ("ljts", (1.2, 1.0), {"mix": "geometric"}),
    ("ljts", (1.2,), {"mie": True, "powers": (14, 7), "shift": False}),
    ("solvation", (1.2, 1.0), {"mix": "geometric"}),
    ("solvation", (1.2,), {"global_params": {"cut": 0.9}}),
    ("wca", (1.2,), {"mix": "sixthpower", "global_params": {"x": 1}}),
    ("yukawa", (1.2, 1.0), {"global_params": {"kappa": 2.0}}),
    ("yukawa", (1.2,), {"mix": "geometric;kappa=1.5", "shift": False}),
    ("yukawa", (1.2,), {}),
    ("ljts", (1.0, 1.2), {}),
]


@pytest.mark.parametrize("name, args, kwargs", PAIR_CALLS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(PAIR_CALLS)])
def test_pair_forces_equal_jax(fake_openmm, name, args, kwargs):
    """Every call the factories make on the forces they build, or the
    error they raise, equals the JAX package's; cutoffs also go in as
    quantities."""

    port, jax_pair = fake_openmm("pair")
    nm = sys.modules["openmm.unit"].nanometer
    outcomes = []
    for module in (port, jax_pair):
        for quantity in (False, True):
            given = tuple(a * nm if quantity and isinstance(a, float)
                          and i == 0 else a for i, a in enumerate(args))
            try:
                result = getattr(module, name)(*given, **kwargs)
                outcomes.append(("ok", _describe(result)))
            except ValueError as error:
                outcomes.append(("raised", str(error)))
    assert outcomes[0] == outcomes[2] and outcomes[1] == outcomes[3]


@pytest.mark.parametrize("kwargs", [{}, {"wca": False},
                                    {"global_args": {"k": 30.0}},
                                    {"global_args": {"k": 30.0, "r0": 1.5},
                                     "mix": "geometric"}])
def test_fene_bond_equals_jax(fake_openmm, kwargs):
    port, jax_bond = fake_openmm("bond")
    got = port.fene(**({"cutoff": 1.1} | kwargs
                       if kwargs.get("wca", True) else kwargs))
    want = jax_bond.fene(**({"cutoff": 1.1} | kwargs
                            if kwargs.get("wca", True) else kwargs))
    assert _describe(got) == _describe(want)


# -- algorithm/unit's OpenMM branches ---------------------------------------


@pytest.fixture
def unit_branches(fake_openmm, monkeypatch):
    """Both packages' algorithm.unit with OpenMM found: the fake
    ``openmm.unit`` module and its vacuum permittivity."""

    fake = sys.modules["openmm.unit"]
    port_omm, jax_omm = fake_openmm("unit")
    for module in (port_unit, jax_unit):
        monkeypatch.setattr(module, "FOUND_OPENMM", True)
        monkeypatch.setattr(module, "openmm_unit", fake, raising=False)
    monkeypatch.setattr(jax_unit, "VACUUM_PERMITTIVITY",
                        jax_omm.VACUUM_PERMITTIVITY, raising=False)
    return fake, port_omm, jax_omm


def test_lj_scaling_factors_of_openmm_quantities(unit_branches):
    """The OpenMM branch of get_lj_scaling_factors, directly and through
    openmm.unit's aliases, equals the JAX package's."""

    fake, port_omm, jax_omm = unit_branches
    results = []
    for get in (port_unit.get_lj_scaling_factors,
                jax_unit.get_lj_scaling_factors,
                port_omm.get_lj_scaling_factors,
                jax_omm.get_lj_scaling_factors):
        bases = {"mass": 39.948 * fake.dalton,
                 "length": 0.34 * fake.nanometer,
                 "energy": 0.99774 * fake.kilojoule_per_mole}
        results.append(_describe(get(
            bases, {"diffusivity": (("length", 2), ("time", -1))})))
    assert results[0] == results[1] == results[2] == results[3]
    assert len(results[0]) == 15
    assert _describe(port_omm.get_scaling_factors(
        {"a": 2.0 * fake.meter}, {"b": (("a", 2),)})) == _describe(
        jax_omm.get_scaling_factors({"a": 2.0 * fake.meter},
                                    {"b": (("a", 2),)}))


def test_lj_scaling_factors_refuse_plain_numbers(unit_branches,
                                                 monkeypatch):
    for module in (port_unit, jax_unit):
        monkeypatch.setattr(module, "FOUND_OPENMM", False)
        with pytest.raises(TypeError, match="OpenMM was not found"):
            module.get_lj_scaling_factors({"mass": 1.0, "length": 1.0,
                                           "energy": 1.0})


def test_strip_unit_of_openmm_quantities(unit_branches):
    """Each branch of strip_unit with OpenMM: native quantities to OpenMM
    units, OpenMM quantities to none, OpenMM, string and native units, and
    the error for a unit OpenMM does not define."""

    fake = unit_branches[0]
    cases = [
        (lambda pkg: pkg.Q_(np.array([1.5, 2.5]), "nanometer"),
         lambda pkg: fake.angstrom),
        (lambda pkg: pkg.Q_(3.0, "kilojoule/mole"),
         lambda pkg: fake.kilocalorie_per_mole),
        (lambda pkg: pkg.Q_(2.0, "elementary_charge"),
         lambda pkg: fake.elementary_charge),
        (lambda pkg: 4.0 * fake.nanometer, lambda pkg: None),
        (lambda pkg: np.array([4.0, 5.0]) * fake.nanometer,
         lambda pkg: fake.angstrom),
        (lambda pkg: 4.0 * fake.nanometer, lambda pkg: "angstrom"),
        (lambda pkg: 4.0 * fake.picosecond,
         lambda pkg: pkg.ureg.Unit("picosecond")),
        (lambda pkg: 2.0 * fake.kilojoule_per_mole, lambda pkg: "kJ/mol"),
        (lambda pkg: 2.0 * fake.nanometer, lambda pkg: "hour"),
        (lambda pkg: 7, lambda pkg: "nanometer"),
    ]
    for value, target in cases:
        outcomes = []
        for pkg, module in ((port_pkg, port_unit), (jax_pkg, jax_unit)):
            try:
                got = module.strip_unit(value(pkg), target(pkg))
            except ValueError as error:
                outcomes.append(("raised", str(error).replace(
                    "mdhelper_tpu_torch.units", "mdhelper_tpu.units")))
                continue
            magnitude, unit = got
            unit = str(unit) if not isinstance(unit, FakeUnit) else (
                unit.factor, unit.names)
            outcomes.append((_describe(magnitude), unit))
        assert outcomes[0] == outcomes[1], outcomes


# -- topology --------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(),
    dict(delete="objects"),
    dict(delete=[0, 3], types="atom"),
    dict(delete=[1, 0], types=["residue", "chain"]),
    dict(keep="chain"),
    dict(keep=[0], types="residue"),
    dict(keep=[2, 1], types=["atom", "bond"]),
    dict(keep=[1], types=["atoms"]),
    dict(keep=[0], delete=[1], types="atom"),
    dict(delete=[0]),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()) or "none")
def test_get_subset_equals_jax(fake_openmm, case):
    """What each package hands to Modeller.delete (or returns, or
    raises) is the same.  Two faults of the JAX package are kept, and
    pinned here as raising alike (ROADMAP Queue 3, item 21): `keep` of
    topology objects without `types` hands None to Modeller.delete, and
    ``types="atoms"`` (which the function tests for) is no key of its
    tables."""

    port, jax_topo = fake_openmm("topology")
    outcomes = []
    for module in (port, jax_topo):
        topology = FakeAppTopology()
        kwargs = dict(case)
        if kwargs.get("delete") == "objects":
            kwargs["delete"] = [topology._xatoms[0], topology._xbonds[-1],
                                topology._xresidues[3]]
        if kwargs.get("keep") == "chain":
            kwargs["keep"] = [topology._xchains[1]]
        try:
            top, positions = module.get_subset(topology, "positions",
                                               **kwargs)
        except (ValueError, TypeError, KeyError) as error:
            outcomes.append(("raised", type(error).__name__, str(error)))
            continue
        outcomes.append((getattr(top, "deleted", "untouched"), positions))
    assert outcomes[0] == outcomes[1]


def test_create_atoms_takes_an_openmm_topology(fake_openmm, monkeypatch):
    """With OpenMM found, create_atoms reads the box of an
    ``openmm.app.Topology`` and returns quantities in its unit."""

    port_topo, jax_topo = fake_openmm("topology")
    fake = sys.modules["openmm.unit"]
    for module in (port_topology, jax_topology, port_unit, jax_unit):
        monkeypatch.setattr(module, "FOUND_OPENMM", True)
    for module in (port_topology, jax_topology):
        monkeypatch.setattr(module, "app", sys.modules["openmm.app"],
                            raising=False)
    for module in (port_unit, jax_unit):
        monkeypatch.setattr(module, "openmm_unit", fake, raising=False)
    unseeded = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *args, **kwargs: unseeded(3))
    outcomes = []
    for create in (port_topology.create_atoms, jax_topology.create_atoms,
                   port_topo.create_atoms, jax_topo.create_atoms):
        melt = create(FakeAppTopology(), 20)
        lattice = create(FakeAppTopology(), lattice="hcp", length=0.4)
        outcomes.append(_describe((melt, lattice)))
    assert outcomes[0] == outcomes[1] == outcomes[2] == outcomes[3]
    assert outcomes[0][0][0] == "FakeQuantity"


# -- reporter -----------------------------------------------------------------


class FakeState:
    def __init__(self, step):
        unit = sys.modules["openmm.unit"]
        rng = np.random.default_rng(step)
        self._xdata = {
            "positions": rng.random((8, 3)) * 3 * unit.nanometer,
            "velocities": rng.normal(size=(8, 3)) * (
                unit.nanometer / unit.picosecond),
            "forces": rng.normal(size=(8, 3)) * (
                unit.kilojoule_per_mole / unit.nanometer),
        }
        self._xtime = 0.002 * step * unit.picosecond
        self._xbox = [np.array(v) * unit.nanometer for v in (
            [3.0, 0.0, 0.0], [0.5, 3.0, 0.0], [0.0, 0.0, 3.5])]

    def getPositions(self, asNumpy=False):
        return self._xdata["positions"]

    def getVelocities(self, asNumpy=False):
        return self._xdata["velocities"]

    def getForces(self, asNumpy=False):
        return self._xdata["forces"]

    def getPeriodicBoxVectors(self):
        return self._xbox

    def getTime(self):
        return self._xtime


@pytest.mark.parametrize("subset", [None, "slice", "topology"])
@pytest.mark.parametrize("extras", [False, True])
def test_reporter_files_equal_jax(fake_openmm, tmp_path, subset, extras):
    """Three reports through each package's NetCDFReporter give the same
    file, and the port reads back what the fake states held."""

    port, jax_reporter = fake_openmm("reporter")
    selection = {None: None, "slice": slice(1, 6),
                 "topology": FakeAppTopology()}[subset]
    paths = []
    for name, module in (("port", port), ("jax", jax_reporter)):
        path = str(tmp_path / f"{name}.nc")
        reporter = module.NetCDFReporter(path, 10, velocities=extras,
                                         forces=extras, subset=selection)
        simulation = types.SimpleNamespace(currentStep=13,
                                           topology=FakeAppTopology())
        assert reporter.describeNextReport(simulation) == (
            7, True, extras, extras, False, None)
        for step in (10, 20, 30):
            reporter.report(simulation, FakeState(step))
        reporter._out.close()
        paths.append(path)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    f = port_file.NetCDFFile(paths[0], "r")
    pick = {None: slice(None), "slice": slice(1, 6),
            "topology": slice(None)}[subset]
    want = FakeState(30).getPositions()._value[pick] * 10
    np.testing.assert_allclose(f.get_positions(units=False)[2], want,
                               rtol=1e-6)  # float32 coordinates in the file
    np.testing.assert_allclose(f.get_times(units=False), [0.02, 0.04, 0.06])
    f.close()


# -- utility.optimize_pme -----------------------------------------------------


class FakePME(FakeNonbondedRecorder):
    def __init__(self):
        super().__init__()
        self._xcutoff = 1.0

    def getNonbondedMethod(self):
        return self.PME

    def getEwaldErrorTolerance(self):
        return 5e-4

    def setCutoffDistance(self, cutoff):
        self._xcutoff = float(cutoff)
        self.calls.append(("setCutoffDistance", (cutoff,)))


class FakeContext:
    def __init__(self, system, integrator, platform, properties):
        self._xcutoff = system._xpme._xcutoff
        self._xcpu = properties["UseCpuPme"] == "true"

    def setPositions(self, positions):
        pass


def _pme_seconds(context, steps):
    """A step's cost: least at a 1.1 nm cutoff, a fifth more on the
    CPU."""

    cost = 1e-3 * (1 + (context._xcutoff - 1.1) ** 2)
    return steps * cost * (1.2 if context._xcpu else 1.0)


@pytest.mark.parametrize("cpu_pme", [True, False])
def test_optimize_pme_equals_jax(fake_openmm, monkeypatch, cpu_pme):
    """The calibration, sweep, reruns and ranking on a deterministic step
    time: both packages pick the same cutoff and reciprocal-space device,
    after the same calls on the force."""

    port, jax_utility_fake = fake_openmm("utility")
    unit = sys.modules["openmm.unit"]
    outcomes = []
    for module in (port, jax_utility_fake):
        monkeypatch.setattr(module, "_benchmark_integrator", _pme_seconds)
        monkeypatch.setattr(module.openmm, "Context", FakeContext)
        monkeypatch.setattr(module.openmm, "XmlSerializer",
                            types.SimpleNamespace(clone=lambda x: x))
        pme = FakePME()
        system = types.SimpleNamespace(
            _xpme=pme, getForces=lambda: [pme],
            getDefaultPeriodicBoxVectors=lambda: [
                np.array(v) * unit.nanometer for v in (
                    [4.0, 0, 0], [0, 4.5, 0], [0, 0, 5.0])])
        platform = types.SimpleNamespace(supportsKernels=lambda k: True)
        best, on_cpu = module.optimize_pme(
            system, "integrator", "positions", platform, {},
            0.9, 1.4, cpu_pme=cpu_pme, verbose=False)
        outcomes.append((_describe(best), on_cpu, _describe(pme.calls)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] is False  # the GPU's steps are the cheaper


# -- signatures of the modules that need OpenMM ---------------------------


@pytest.mark.parametrize("module", ["pair", "bond", "topology", "reporter",
                                    "system", "utility", "unit"])
def test_public_signatures_equal_jax(fake_openmm, module):
    """Under the fake, every public name of the modules that import
    OpenMM has the JAX package's signature (names, kinds, defaults)."""

    import inspect

    port, jax_module = fake_openmm(module)
    assert port.__all__ == jax_module.__all__
    for name in port.__all__:
        got, want = getattr(port, name), getattr(jax_module, name)
        if not callable(want):
            continue
        assert [(p.name, p.kind, p.default) for p in
                inspect.signature(got).parameters.values()] == [
            (p.name, p.kind, p.default) for p in
            inspect.signature(want).parameters.values()], name
