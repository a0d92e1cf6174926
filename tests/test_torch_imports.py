"""Two rules of the port, checked without a card.

* The port imports neither JAX nor the JAX package, nor pandas: every
  module of ``mdhelper_tpu_torch/`` and ``chip_smoke.py`` is parsed and its
  import statements are read (the machine with the card has no JAX and
  no pandas).
* The analyses run on the card unless the caller asks for the CPU: with
  no card, constructing one without ``device=`` raises, and
  ``device="cpu"`` runs.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
                                  "tetrahedral"])
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
