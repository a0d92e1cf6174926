"""Two rules of the port, checked without a card.

* The port imports neither JAX nor the JAX package, nor pandas or sympy:
  every module of ``mdhelper_tpu_torch/`` and ``chip_smoke.py`` is parsed
  and its import statements are read (the machine with the card has no
  JAX, no pandas and no sympy).
* The analyses run on the card unless the caller asks for the CPU: with
  no card, constructing one without ``device=`` raises, and
  ``device="cpu"`` runs.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mdhelper_tpu_torch.analysis import bonded, contacts, rmsd  # noqa: E402
from mdhelper_tpu_torch.analysis import thermodynamics  # noqa: E402
from mdhelper_tpu_torch.analysis.cluster import (  # noqa: E402
    ClusterSizeDistribution,
)
from mdhelper_tpu_torch.analysis.electrostatics import (  # noqa: E402
    DipoleMoment,
    calculate_dielectric_spectrum,
)
from mdhelper_tpu_torch.analysis.hbonds import (  # noqa: E402
    HydrogenBondAnalysis,
)
from mdhelper_tpu_torch.analysis.orientation import (  # noqa: E402
    NematicOrderParameter,
    OrientationProfile,
)
from mdhelper_tpu_torch.analysis.polymer import (  # noqa: E402
    EndToEndVector,
    Gyradius,
    MeanSquareInternalDistance,
    PersistenceLength,
    RouseModes,
    SingleChainStructureFactor,
)
from mdhelper_tpu_torch.analysis.profile import (  # noqa: E402
    DensityMap2D,
    DensityMap3D,
    DensityProfile,
    RadialDensityProfile,
)
from mdhelper_tpu_torch.analysis.steinhardt import (  # noqa: E402
    SteinhardtOrderParameter,
    TetrahedralOrderParameter,
)
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    IntermediateScatteringFunction,
    RadialDistributionFunction,
    StructureFactor,
    VanHoveFunction,
)
from mdhelper_tpu_torch.analysis.transport import Onsager  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "mdhelper_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _forbidden(name):
    """jax and its submodules, and the JAX package and its submodules
    (the port's own name only shares a prefix)."""

    top = name.split(".")[0]
    return top in ("jax", "mdhelper_tpu")


def _imported_names(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_never_imports_jax(path):
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _imports_pandas(name):
    return name.split(".")[0] == "pandas"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_never_imports_pandas(path):
    bad = [n for n in _imported_names(path) if _imports_pandas(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _imports_sympy(name):
    return name.split(".")[0] == "sympy"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_never_imports_sympy(path):
    bad = [n for n in _imported_names(path) if _imports_sympy(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_sources_cover_the_molecule_layer():
    """The superposition, bonded, contacts, molecule, accelerated and
    utility modules are among the parsed sources, and the sympy rule
    catches sympy and its submodules."""

    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("analysis/rmsd", "analysis/bonded", "analysis/contacts",
                   "analysis/cluster", "algorithm/molecule",
                   "algorithm/accelerated", "algorithm/utility",
                   "algorithm/topology", "ops/pbc", "algorithm/__init__"):
        assert f"mdhelper_tpu_torch/{module}.py" in names
    assert _imports_sympy("sympy") and _imports_sympy("sympy.ntheory")
    assert not _imports_sympy("sympy_like")


def test_sources_cover_the_polymer_layer():
    """The polymer, thermodynamics and fit modules are among the parsed
    sources, and the pandas rule catches pandas and its submodules."""

    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("analysis/polymer", "analysis/thermodynamics",
                   "fit/__init__", "fit/exponential"):
        assert f"mdhelper_tpu_torch/{module}.py" in names
    assert _imports_pandas("pandas") and _imports_pandas("pandas.io.parsers")
    assert not _imports_pandas("pandas_like")


def test_sources_cover_the_file_layer():
    """The file layer's modules are among the parsed sources, and the
    native XTC codec is built from the port's own copy of its source."""

    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("__init__", "dcd", "xtc", "_xtc_native", "trr",
                   "netcdf3", "lammps_dump", "topology_files", "tpr",
                   "structure_writers"):
        assert f"mdhelper_tpu_torch/io/{module}.py" in names
    assert "mdhelper_tpu_torch/core/trajectory.py" in names
    from mdhelper_tpu_torch.io import _xtc_native

    assert _xtc_native._SRC == ROOT / "mdhelper_tpu_torch/io/_xtc_native.cpp"
    assert _xtc_native._BUILD == ROOT / "mdhelper_tpu_torch/_build"


def test_sources_cover_the_profile_layer():
    """The density-profile and electrostatics modules are among the parsed
    sources."""

    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("analysis/base", "analysis/multi", "analysis/profile",
                   "analysis/electrostatics", "ops/profiles",
                   "ops/histogram", "testing"):
        assert f"mdhelper_tpu_torch/{module}.py" in names


def test_sources_cover_the_aggregates_and_order_layer():
    """The mesh route's and the aggregates' and order classes' modules are
    among the parsed sources."""

    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("ops/mesh_scattering", "analysis/cluster",
                   "analysis/hbonds", "analysis/orientation",
                   "analysis/steinhardt", "algorithm/spherical"):
        assert f"mdhelper_tpu_torch/{module}.py" in names


def test_sources_cover_the_velocity_and_interface_layer():
    """The velocity, flow, interface and free-energy modules are among the
    parsed sources."""

    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("analysis/dynamics", "analysis/flow", "analysis/interface",
                   "analysis/free_energy", "ops/profiles", "ops/pbc",
                   "ops/doublefloat", "algorithm/topology"):
        assert f"mdhelper_tpu_torch/{module}.py" in names


def test_import_rule_catches_both_packages():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("mdhelper_tpu") and _forbidden("mdhelper_tpu.ops.x")
    assert not _forbidden("mdhelper_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def _analyses(u, **device):
    chains = dict(n_chains=6, n_monomers=10, verbose=False)
    return {
        "rdf": lambda: RadialDistributionFunction(
            u.atoms, n_bins=8, range=(0.0, 2.5), verbose=False, **device
        ),
        "cross_rdf": lambda: RadialDistributionFunction(
            u.atoms[0::2], u.atoms[1::2], n_bins=8, range=(0.0, 2.5),
            verbose=False, **device
        ),
        "vanhove": lambda: VanHoveFunction(
            u.atoms, n_bins=8, range=(0.0, 2.5), verbose=False, **device
        ),
        "sq": lambda: StructureFactor(u.atoms, n_points=3, verbose=False,
                                      **device),
        "onsager": lambda: Onsager(u.atoms, verbose=False, **device),
        "profile": lambda: DensityProfile(u.atoms, axes="z", n_bins=8,
                                          verbose=False, **device),
        "radial": lambda: RadialDensityProfile(
            u.atoms, np.full(3, 4.0), n_bins=8, range=(0.0, 3.0),
            verbose=False, **device),
        "map2d": lambda: DensityMap2D(u.atoms, n_bins=4, verbose=False,
                                      **device),
        "map3d": lambda: DensityMap3D(u.atoms, n_bins=4, verbose=False,
                                      **device),
        "dipole": lambda: DipoleMoment(u.atoms, verbose=False, **device),
        "gyradius": lambda: Gyradius(u.atoms, **chains, **device),
        "e2e": lambda: EndToEndVector(u.atoms, **chains, **device),
        "rouse": lambda: RouseModes(u.atoms, **chains, **device),
        "scsf": lambda: SingleChainStructureFactor(
            u.atoms, n_points=3, **chains, **device),
        "persistence": lambda: PersistenceLength(u.atoms, **chains,
                                                 **device),
        "msid": lambda: MeanSquareInternalDistance(u.atoms, **chains,
                                                   **device),
        "mesh_sq": lambda: StructureFactor(u.atoms, n_points=3,
                                           method="mesh", verbose=False,
                                           **device),
        "mesh_isf": lambda: IntermediateScatteringFunction(
            u.atoms, n_points=3, method="mesh", incoherent=True, n_lags=2,
            verbose=False, **device),
        "cluster": lambda: ClusterSizeDistribution(u.atoms, 1.0,
                                                   verbose=False, **device),
        "hbonds": lambda: HydrogenBondAnalysis(
            u, acceptors_sel="all", donor_hydrogen_pairs=[[0, 1], [2, 3]],
            lifetimes=True, verbose=False, **device),
        "nematic": lambda: NematicOrderParameter(
            u.atoms[0::2], u.atoms[1::2], acf=True, verbose=False,
            **device),
        "orientation": lambda: OrientationProfile(
            u.atoms[0::2], u.atoms[1::2], n_bins=4, verbose=False,
            **device),
        "steinhardt": lambda: SteinhardtOrderParameter(
            u.atoms, 2.0, averaged=True, wl=True, verbose=False, **device),
        "tetrahedral": lambda: TetrahedralOrderParameter(
            u.atoms, verbose=False, **device),
        "rmsd": lambda: rmsd.RMSD(u.atoms, verbose=False, **device),
        "rmsf": lambda: rmsd.RMSF(u.atoms, verbose=False, **device),
        "pca": lambda: rmsd.PrincipalComponentAnalysis(
            u.atoms[:20], verbose=False, **device),
        "tica": lambda: rmsd.TICA(u.atoms[:20], verbose=False, **device),
        "bond_lengths": lambda: bonded.BondLengthDistribution(
            u.atoms, bonds=[[0, 1], [2, 3]], verbose=False, **device),
        "bond_angles": lambda: bonded.BondAngleDistribution(
            u.atoms, angles=[[0, 1, 2]], verbose=False, **device),
        "dihedrals": lambda: bonded.DihedralDistribution(
            u.atoms, dihedrals=[[0, 1, 2, 3]], verbose=False, **device),
        "contacts": lambda: contacts.NativeContacts(
            u.atoms[:30], u.atoms[30:], verbose=False, **device),
    }


@pytest.fixture
def universe():
    rng = np.random.default_rng(0)
    traj = (rng.random((2, 60, 3)) * 8.0).astype(np.float32)
    return Universe.from_arrays(traj, [8.0] * 3 + [90.0] * 3)


@pytest.mark.parametrize("name", ["rdf", "cross_rdf", "vanhove", "sq",
                                  "onsager", "profile", "radial", "map2d",
                                  "map3d", "dipole", "gyradius", "e2e",
                                  "rouse", "scsf", "persistence", "msid",
                                  "mesh_sq", "mesh_isf", "cluster", "hbonds",
                                  "nematic", "orientation", "steinhardt",
                                  "tetrahedral", "rmsd", "rmsf", "pca",
                                  "tica", "bond_lengths", "bond_angles",
                                  "dihedrals", "contacts"])
def test_default_device_is_the_card(monkeypatch, universe, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _analyses(universe)[name]()
    analysis = _analyses(universe, device="cpu")[name]()
    assert analysis._device == torch.device("cpu")
    analysis.run()


@pytest.mark.parametrize("name", ["calculate_shear_viscosity",
                                  "calculate_thermal_conductivity",
                                  "calculate_ionic_conductivity",
                                  "calculate_dielectric_spectrum"])
def test_transport_functions_default_to_the_card(monkeypatch, name):
    """The FFTs of the post-hoc transport functions run on the first CUDA
    device unless ``device=`` says otherwise: without a card the default
    raises, and ``device="cpu"`` runs."""

    series = np.random.default_rng(1).normal(size=(64, 3))
    fn = getattr(thermodynamics, name, None) or calculate_dielectric_spectrum
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(series, 1.0, 1.0, 0.1, reduced=True)
    out = fn(series, 1.0, 1.0, 0.1, reduced=True, device="cpu")
    assert np.isfinite(out.acf).all()


def test_existence_lifetimes_default_to_the_card(monkeypatch):
    """The lifetime correlation's FFT runs on the first CUDA device unless
    ``device=`` says otherwise: without a card the default raises (also on
    a series with no channel ever set), and ``device="cpu"`` runs."""

    from mdhelper_tpu_torch.analysis.base import existence_lifetimes

    h = np.random.default_rng(2).random((32, 5)) < 0.5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for series in (h, np.zeros_like(h)):
        with pytest.raises(RuntimeError, match="CUDA"):
            existence_lifetimes(series)
    c, s = existence_lifetimes(h, device="cpu")
    assert c[0] == 1.0 and s[0] == 1.0


def test_accelerated_defaults_to_the_card(monkeypatch):
    """``algorithm.accelerated`` computes NumPy inputs on the first CUDA
    device: without a card they raise, and CPU tensors run on the CPU."""

    from mdhelper_tpu_torch.algorithm import accelerated

    xs = np.random.default_rng(4).normal(size=(3, 8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("cosine_sum_2d", "inner_2d_2d"):
        fn = getattr(accelerated, name)
        args = (xs,) if name == "cosine_sum_2d" else (xs[:, :3], xs[:, :3])
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args)
        out = fn(*[torch.as_tensor(a) for a in args])
        assert out.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        accelerated.sine_sum_inplace_2d(xs, np.zeros(3))


@pytest.fixture
def velocity_universe():
    rng = np.random.default_rng(3)
    traj = (rng.random((6, 40, 3)) * 8.0).astype(np.float32)
    vel = rng.standard_normal((6, 40, 3)).astype(np.float32)
    return Universe.from_arrays(traj, [8.0] * 3 + [90.0] * 3,
                                velocities=vel,
                                charges=np.tile([1.0, -1.0], 20))


def _velocity_analyses(u, **device):
    from mdhelper_tpu_torch.analysis import dynamics, flow, interface

    return {
        "vacf": lambda: dynamics.VelocityAutocorrelation(
            u.atoms, verbose=False, **device),
        "current": lambda: dynamics.ElectricCurrentAutocorrelation(
            u.atoms, 300.0, verbose=False, **device),
        "survival": lambda: dynamics.SurvivalProbability(
            u.atoms, ("shell", u.atoms[:5], 2.0), verbose=False, **device),
        "overlap": lambda: dynamics.OverlapFunction(
            u.atoms, 0.5, verbose=False, **device),
        "flow": lambda: flow.FlowProfile(u.atoms, n_bins=4, verbose=False,
                                         **device),
        "wc": lambda: interface.WillardChandlerInterface(
            u.atoms, n_cells=8, verbose=False, **device),
        "intrinsic": lambda: interface.IntrinsicDensityProfile(
            u.atoms, n_cells=8, n_bins=8, verbose=False, **device),
    }


@pytest.mark.parametrize("name", ["vacf", "current", "survival", "overlap",
                                  "flow", "wc", "intrinsic"])
def test_velocity_and_interface_classes_default_to_the_card(
        monkeypatch, velocity_universe, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _velocity_analyses(velocity_universe)[name]()
    analysis = _velocity_analyses(velocity_universe, device="cpu")[name]()
    assert analysis._device == torch.device("cpu")
    analysis.run()


def test_conclusions_run_on_the_analysis_device(monkeypatch,
                                                 velocity_universe):
    """The velocity autocorrelation's correlation_fft, the current's
    calculate_ionic_conductivity and the survival's existence_lifetimes
    are reached with the analysis's device (their tensors on it, or
    ``device=`` it)."""

    from mdhelper_tpu_torch.algorithm import correlation
    from mdhelper_tpu_torch.analysis import dynamics

    seen = {}

    def recorder(name, fn, device_of):
        def call(*args, **kwargs):
            seen.setdefault(name, []).append(device_of(args, kwargs))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(correlation, "correlation_fft", recorder(
        "correlation_fft", correlation.correlation_fft,
        lambda a, k: torch.as_tensor(a[0]).device))
    monkeypatch.setattr(thermodynamics, "calculate_ionic_conductivity",
                        recorder("calculate_ionic_conductivity",
                                 thermodynamics.calculate_ionic_conductivity,
                                 lambda a, k: torch.device(k["device"])))
    monkeypatch.setattr(dynamics, "existence_lifetimes", recorder(
        "existence_lifetimes", dynamics.existence_lifetimes,
        lambda a, k: torch.device(k["device"])))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = _velocity_analyses(velocity_universe, device="cpu")
    for name in ("vacf", "current", "survival"):
        made[name]().run()
    assert set(seen) == {"correlation_fft", "calculate_ionic_conductivity",
                         "existence_lifetimes"}
    for devices in seen.values():
        assert devices and all(d == torch.device("cpu") for d in devices)
