"""The port's host tools against the JAX package's, on the CPU.

The ``NumbaAnalysisBase`` shim (``n_threads`` warns and is ignored), the
curve-fitting models of ``fit``, ``algorithm.topology.create_atoms``,
``lammps.topology.write_data``, ``plot`` and ``core.profiling``.  The
same seeded numpy inputs go through both packages.  These are the same
numpy operations in both, so the results are held equal, exactly;
``create_atoms`` draws from numpy's unseeded ``default_rng()`` in both
packages, which the tests replace by one seeded factory.
"""

import json
import logging
import os
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import mdhelper_tpu as jax_pkg  # noqa: E402
from mdhelper_tpu import lammps as jax_lammps  # noqa: E402
from mdhelper_tpu.algorithm import topology as jax_topology  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis.structure import (  # noqa: E402
    IntermediateScatteringFunction as JaxISF,
    StructureFactor as JaxSF,
)
from mdhelper_tpu.core import profiling as jax_profiling  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu.fit import (  # noqa: E402
    distribution as jax_distribution,
    exponential as jax_exponential,
    fourier as jax_fourier,
    gaussian as jax_gaussian,
    polynomial as jax_polynomial,
    power as jax_power,
)

import mdhelper_tpu_torch as port_pkg  # noqa: E402
from mdhelper_tpu_torch import fit as port_fit  # noqa: E402
from mdhelper_tpu_torch import lammps as port_lammps  # noqa: E402
from mdhelper_tpu_torch.algorithm import topology as port_topology  # noqa: E402
from mdhelper_tpu_torch.analysis import base as port_base  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    IntermediateScatteringFunction,
    StructureFactor,
)
from mdhelper_tpu_torch.core import profiling  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.fit import (  # noqa: E402
    distribution,
    exponential,
    fourier,
    gaussian,
    polynomial,
    power,
)
from mdhelper_tpu_torch.io.topology_files import (  # noqa: E402
    read_lammps_data,
)

X = np.linspace(0.1, 4.0, 37)


# -- the n_threads shim ----------------------------------------------------


def test_shim_names_and_classes():
    """Both names are exported as in the JAX package, and the S(q) classes
    derive from the shim."""

    assert port_base.JittedAnalysisBase is port_base.NumbaAnalysisBase
    for name in ("NumbaAnalysisBase", "JittedAnalysisBase"):
        assert name in port_base.__all__ and name in jax_base.__all__
    from mdhelper_tpu_torch import analysis

    assert analysis.NumbaAnalysisBase is port_base.NumbaAnalysisBase
    for cls, jax_cls in ((StructureFactor, JaxSF),
                         (IntermediateScatteringFunction, JaxISF)):
        assert issubclass(cls, port_base.NumbaAnalysisBase)
        assert issubclass(jax_cls, jax_base.NumbaAnalysisBase)
    assert issubclass(port_base.NumbaAnalysisBase,
                      port_base.SerialAnalysisBase)


@pytest.fixture(scope="module")
def sq_frames():
    rng = np.random.default_rng(23)
    return (rng.random((3, 60, 3)) * 6.0).astype(np.float32)


def test_n_threads_warns_in_both_and_sq_is_equal(sq_frames):
    """``run(n_threads=2)`` warns in both packages, names n_threads, and the
    S(q) equals that of a run without it; the port's equals the JAX
    package's within the fused slice's tolerance (rtol 1e-4, atol 1e-5:
    float32 trig sums in both, summed in other orders)."""

    dims = [6.0] * 3 + [90.0] * 3
    port_u = Universe.from_arrays(sq_frames, dims)
    jax_u = JaxUniverse.from_arrays(sq_frames, dims)
    runs = {}
    for name, make in (
            ("port", lambda: StructureFactor(port_u.atoms, n_points=3,
                                             verbose=False, device="cpu")),
            ("jax", lambda: JaxSF(jax_u.atoms, n_points=3,
                                  verbose=False))):
        with pytest.warns(UserWarning, match="n_threads is accepted") as w:
            shimmed = make().run(n_threads=2)
        assert ("CUDA and PyTorch" in str(w[0].message)) == (name == "port")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            plain = make().run()
        np.testing.assert_array_equal(shimmed.results.ssf,
                                      plain.results.ssf)
        runs[name] = shimmed
    np.testing.assert_allclose(runs["port"].results.ssf,
                               runs["jax"].results.ssf, rtol=1e-4,
                               atol=1e-5)


def test_shim_keeps_the_checkpoint(sq_frames, tmp_path):
    """``n_threads`` and ``checkpoint=`` together: the shim passes the
    checkpoint on, and the resumed run equals a plain one."""

    u = Universe.from_arrays(sq_frames, [6.0] * 3 + [90.0] * 3)
    path = str(tmp_path / "sq.npz")
    with pytest.warns(UserWarning, match="n_threads"):
        first = StructureFactor(u.atoms, n_points=3, verbose=False,
                                device="cpu").run(n_threads=3,
                                                  checkpoint=path)
    assert os.path.exists(path)
    plain = StructureFactor(u.atoms, n_points=3, verbose=False,
                            device="cpu").run()
    np.testing.assert_array_equal(first.results.ssf, plain.results.ssf)


# -- fit ---------------------------------------------------------------------


FIT_CALLS = [
    ("distribution", "weibull", (0.7, 1.6)),
    ("distribution", "weibull", (0.7, 1.6, 0.05)),
    ("exponential", "exp", (1.0, -0.5, 0.3, -2.0)),
    ("exponential", "exp1", (1.2, -0.4)),
    ("exponential", "exp2", (1.0, -0.5, 0.3, -2.0)),
    ("exponential", "biexp", (0.1, 1.0, 0.5, 0.3, 2.0)),
    ("exponential", "stretched_exp", (1.5, 0.7)),
    ("fourier", "fourier", (1.3, 0.2, 0.5, -0.4, 0.1, 0.3)),
    ("gaussian", "gauss", (1.0, 1.5, 0.4, 0.3, 3.0, 0.8)),
    ("polynomial", "poly", (0.5, -1.0, 0.25, 0.125)),
    ("power", "power", (1.5, 0.8)),
    ("power", "power", (1.5, 0.8, 0.2)),
    ("power", "power1", (1.5, 0.8)),
    ("power", "power2", (1.5, 0.8, 0.2)),
] + [("fourier", f"fourier{n}", tuple(np.linspace(0.1, 0.9, 2 * n + 2)))
     for n in range(1, 9)] + [
    ("gaussian", f"gauss{n}", tuple(np.tile([1.0, 2.0, 0.5], n)
                                    + 0.1 * np.arange(3 * n)))
    for n in range(1, 9)] + [
    ("polynomial", f"poly{n}", tuple(np.linspace(-1.0, 1.0, n + 1)))
    for n in range(1, 10)]

JAX_FIT = {"distribution": jax_distribution, "exponential": jax_exponential,
           "fourier": jax_fourier, "gaussian": jax_gaussian,
           "polynomial": jax_polynomial, "power": jax_power}
PORT_FIT = {"distribution": distribution, "exponential": exponential,
            "fourier": fourier, "gaussian": gaussian,
            "polynomial": polynomial, "power": power}


def test_fit_lists_six_modules_and_their_names():
    assert port_fit.__all__ == ["distribution", "exponential", "fourier",
                                "gaussian", "polynomial", "power"]
    for name, module in PORT_FIT.items():
        assert module.__all__ == JAX_FIT[name].__all__
        assert getattr(port_fit, name) is module


@pytest.mark.parametrize("module, name, args", FIT_CALLS,
                         ids=[f"{c[1]}-{len(c[2])}" for c in FIT_CALLS])
def test_fit_models_equal_jax(module, name, args):
    got = getattr(PORT_FIT[module], name)(X, *args)
    want = getattr(JAX_FIT[module], name)(X, *args)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("module, name, args, error", [
    ("fourier", "fourier", (1.0, 0.2, 0.5), ValueError),
    ("fourier", "fourier", (1.0, 0.2), ValueError),
    ("fourier", "fourier2", (0.2, 0.5, 0.1, 1.0), TypeError),
    ("fourier", "fourier1", (0.2, 0.5, 0.1, 0.3, 1.0), TypeError),
    ("gaussian", "gauss", (1.0, 2.0), ValueError),
    ("gaussian", "gauss2", (1.0, 2.0, 0.5), TypeError),
    ("polynomial", "poly3", (1.0, 2.0), TypeError),
    ("exponential", "exp", (1.0,), ValueError),
])
def test_fit_errors_equal_jax(module, name, args, error):
    """A bad parameter count raises the same error, with the same message,
    in both packages."""

    messages = []
    for table in (PORT_FIT, JAX_FIT):
        with pytest.raises(error) as caught:
            getattr(table[module], name)(X, *args)
        messages.append(str(caught.value))
    assert messages[0] == messages[1]


# -- create_atoms -------------------------------------------------------------


@pytest.fixture
def seeded_rng(monkeypatch):
    """numpy's ``default_rng()`` made to return a generator seeded 7 at
    each call, in both packages (they share numpy)."""

    unseeded = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *args, **kwargs: unseeded(7))


def _assert_equal_outputs(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal_outputs(g, w)
    else:
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("lattice", ["fcc", "hcp", "cubic", "honeycomb"])
@pytest.mark.parametrize("flexible", [False, True])
def test_lattices_equal_jax(lattice, flexible):
    dims = [6.3, 5.1, 0.0 if lattice == "honeycomb" else 7.7]
    got = port_topology.create_atoms(dims, lattice=lattice, length=0.9,
                                     flexible=flexible)
    want = jax_topology.create_atoms(dims, lattice=lattice, length=0.9,
                                     flexible=flexible)
    _assert_equal_outputs(got, want)
    assert len(got[0]) > 0


def test_lattice_with_quantities_and_units_equals_jax():
    dims = port_pkg.Q_(np.array([2.0, 2.0, 2.5]), "nanometer")
    jax_dims = jax_pkg.Q_(np.array([2.0, 2.0, 2.5]), "nanometer")
    got = port_topology.create_atoms(dims, lattice="fcc", length=3.0,
                                     length_unit=port_pkg.ureg.angstrom)
    want = jax_topology.create_atoms(jax_dims, lattice="fcc", length=3.0,
                                     length_unit=jax_pkg.ureg.angstrom)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.magnitude, w.magnitude)
        assert str(g.units) == str(w.units)


@pytest.mark.parametrize("options", [
    {"N": 90},
    {"N": 120, "N_p": 10, "bonds": True, "angles": True,
     "dihedrals": True},
    {"N": 120, "N_p": 12, "bonds": True, "randomize": True},
    {"N": 96, "N_p": 8, "angles": True, "wrap": True},
    {"N": 60, "N_p": 6},
], ids=["melt", "chains", "randomized", "wrapped", "bare"])
def test_random_atoms_equal_jax(seeded_rng, options):
    """The random melt and the random walks, drawn from one seeded
    factory in both packages, and the chains' index arrays."""

    got = port_topology.create_atoms([5.0, 6.0, 7.0], **options)
    want = jax_topology.create_atoms([5.0, 6.0, 7.0], **options)
    _assert_equal_outputs(got, want)


def test_chain_indices_count_and_order():
    _, bonds, angles, dihedrals = port_topology.create_atoms(
        [9.0] * 3, 40, 10, bonds=True, angles=True, dihedrals=True)
    assert bonds.shape == (36, 2) and angles.shape == (32, 3)
    assert dihedrals.shape == (28, 4)
    np.testing.assert_array_equal(bonds[:2], [[0, 1], [1, 2]])
    np.testing.assert_array_equal(bonds[9], [10, 11])


@pytest.mark.parametrize("kwargs, match", [
    ({}, "must be specified"),
    ({"N": 10.0}, "must be an integer"),
    ({"N": 10, "N_p": 11}, "between 1 and N"),
    ({"N": 10, "N_p": 3}, "evenly divided"),
    ({"lattice": "bcc"}, "Invalid lattice"),
])
def test_create_atoms_errors_equal_jax(kwargs, match):
    messages = []
    for module in (port_topology, jax_topology):
        with pytest.raises(ValueError, match=match) as caught:
            module.create_atoms([4.0] * 3, **kwargs)
        messages.append(str(caught.value))
    assert messages[0] == messages[1]


# -- lammps ----------------------------------------------------------------


def _lammps_inputs():
    rng = np.random.default_rng(11)
    positions = (rng.random((5, 3)) * 10.0, rng.random((3, 3)) * 10.0)
    bonds = (np.array([[1, 2], [2, 3]]), np.array([[6, 7]]))
    angles = (np.array([[1, 2, 3]]),)
    dihedrals = (np.array([[1, 2, 3, 4]]),)
    impropers = (np.array([[2, 1, 3, 4]]),)
    return positions, bonds, angles, dihedrals, impropers


@pytest.mark.parametrize("box", ["ortho", "tilt", "bounds"])
@pytest.mark.parametrize("charges", ["none", "per_type", "flat",
                                     "per_type_arrays"])
def test_write_data_bytes_equal_jax(tmp_path, box, charges):
    positions, bonds, angles, dihedrals, impropers = _lammps_inputs()
    dims = {"ortho": [10.0, 11.0, 12.0], "tilt": [10.0, 11.0, 12.0],
            "bounds": [[-1.0, 9.0], [0.0, 11.0], [2.0, 14.0]]}[box]
    q = {"none": None, "per_type": [0.5, -1.25],
         "flat": np.linspace(-1.0, 1.0, 8),
         "per_type_arrays": [np.full(5, 0.3), np.full(3, -0.5)]}[charges]
    kwargs = dict(bonds=bonds, angles=angles, dihedrals=dihedrals,
                  impropers=impropers, dimensions=dims, charges=q,
                  masses=[12.011, 1.008],
                  tilt=[0.5, -0.25, 0.125] if box == "tilt" else None)
    port_lammps.topology.write_data(str(tmp_path / "port.data"),
                                    positions, **kwargs)
    with open(tmp_path / "jax.data", "w") as fh:
        jax_lammps.topology.write_data(fh, positions, **kwargs)
    port_bytes = (tmp_path / "port.data").read_bytes()
    assert port_bytes == (tmp_path / "jax.data").read_bytes()

    back = read_lammps_data(str(tmp_path / "port.data"))
    np.testing.assert_array_equal(
        back["positions"],
        np.char.mod("%.6g", np.concatenate(positions)).astype(float))
    np.testing.assert_array_equal(back["bonds"], [[0, 1], [1, 2], [5, 6]])
    assert list(back["types"]) == ["1"] * 5 + ["2"] * 3


def test_write_data_errors_equal_jax(tmp_path):
    positions = _lammps_inputs()[0]
    for kwargs, match in (({"masses": [1.0]}, "masses"),
                          ({"charges": np.zeros(7)}, "charges")):
        for module in (port_lammps, jax_lammps):
            with pytest.raises(ValueError, match=match):
                module.topology.write_data(str(tmp_path / "x.data"),
                                           positions, **kwargs)


def test_lammps_create_atoms_alias(seeded_rng):
    _assert_equal_outputs(
        port_lammps.topology.create_atoms([4.0] * 3, 12, 4, bonds=True),
        port_topology.create_atoms([4.0] * 3, 12, 4, bonds=True))


# -- plot --------------------------------------------------------------------


@pytest.fixture
def plots():
    matplotlib = pytest.importorskip("matplotlib")
    from mdhelper_tpu import plot as jax_plot
    from mdhelper_tpu_torch import plot

    with matplotlib.rc_context():
        yield matplotlib, plot, jax_plot


@pytest.mark.parametrize("journal", [None, "acs", "aip", "rsc"])
def test_rcparams_equal_jax(plots, journal):
    matplotlib, plot, jax_plot = plots
    states = []
    for module in (plot, jax_plot):
        matplotlib.rcdefaults()
        module.rcparam.update(journal, font_scaling=1.25, size_scaling=0.9,
                              **{"lines.linewidth": 0.75})
        states.append(dict(matplotlib.rcParams))
    assert states[0] == states[1]
    assert states[0]["font.size"] == 1.25 * 9
    assert (plot.rcparam.FIGURE_SIZE_LIMITS
            == jax_plot.rcparam.FIGURE_SIZE_LIMITS)


@pytest.mark.parametrize("color", ["tab:blue", "red", "#12ab9f",
                                   (0.2, 0.4, 0.6),
                                   ["navy", (0.9, 0.1, 0.3)]])
@pytest.mark.parametrize("amount", [0.5, 1.3, 3.0])
def test_adjust_lightness_equal_jax(plots, color, amount):
    _, plot, jax_plot = plots
    assert (plot.color.adjust_lightness(color, amount)
            == jax_plot.color.adjust_lightness(color, amount))


@pytest.mark.parametrize("options", [
    {},
    {"hlabel": "anion", "vlabel": "cation"},
    {"hlabel": "anion", "vlabel": "cation", "hla": "center",
     "vla": "center"},
    {"vlabel": "cation", "condense": True, "loc": "upper left"},
])
def test_tabular_legend_equal_jax(plots, options):
    _, plot, jax_plot = plots
    rows, cols = ["a", "b", "c"], ["x", "y"]
    got = plot.axis.set_up_tabular_legend(rows, cols, **options)
    want = jax_plot.axis.set_up_tabular_legend(rows, cols, **options)
    assert got.keys() == want.keys()
    for key in want:
        if key != "handles":
            assert got[key] == want[key]
    assert len(got["handles"]) == len(want["handles"])
    for g, w in zip(got["handles"], want["handles"]):
        assert type(g) is type(w)
        assert (g.get_xy(), g.get_width(), g.get_height(), g.get_fill(),
                g.get_edgecolor()) == (w.get_xy(), w.get_width(),
                                       w.get_height(), w.get_fill(),
                                       w.get_edgecolor())


# -- core.profiling -----------------------------------------------------------


def test_timer_counts_and_report_match_jax():
    timers = (profiling.Timer(), jax_profiling.Timer())
    for timer in timers:
        for stage in ("read", "update", "read"):
            with timer(stage):
                pass
    assert timers[0].counts == timers[1].counts == {"read": 2, "update": 1}
    for timer in timers:
        report = timer.report()
        assert report.startswith("pipeline stage timings:\n")
        assert "(     2 calls)" in report and "(     1 calls)" in report
    with pytest.raises(KeyError):
        with timers[0]("failing"):
            raise KeyError("x")
    assert timers[0].counts["failing"] == 1


def test_benchmark_grid_ranks_by_median():
    """The configurations rank by their median time, fastest first, and
    each call's tensors are returned through the timer untouched."""

    import time

    def build(delay):
        def call(x):
            time.sleep(delay)
            return {"out": (x * 2, [x + 1])}
        return call

    configs = [{"delay": 0.004}, {"delay": 0.0}, {"delay": 0.002}]
    best, ranking = profiling.benchmark_grid(build, configs,
                                             torch.ones(4), repeats=3)
    assert best == {"delay": 0.0}
    assert [c["delay"] for _, c in ranking] == [0.0, 0.002, 0.004]
    assert ranking[2][0] >= 0.004 > ranking[0][0]


def test_benchmark_grid_skips_failing_configs(caplog):
    def build(size):
        if size > 2:
            def call(x):
                raise ValueError(f"{size} does not fit")
            return call
        return lambda x: x[:size].sum()

    with caplog.at_level(logging.DEBUG):
        best, ranking = profiling.benchmark_grid(
            build, [{"size": 4}, {"size": 1}], torch.ones(8))
    assert best == {"size": 1} and len(ranking) == 1
    assert "does not fit" in caplog.text
    with pytest.raises(RuntimeError, match="No benchmark configuration"):
        profiling.benchmark_grid(build, [{"size": 3}], torch.ones(8))


def test_benchmark_grid_raises_on_a_dead_context(monkeypatch):
    """An error that leaves the CUDA context unusable is raised, not
    skipped: the later configurations would time a dead device."""

    def build(size):
        def call(x):
            raise RuntimeError("CUDA error: an illegal memory access")
        return call

    monkeypatch.setattr(profiling, "_context_alive", lambda: False)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        profiling.benchmark_grid(build, [{"size": 1}, {"size": 2}],
                                 torch.ones(2))


def test_benchmark_grid_waits_for_the_returned_tensors(monkeypatch):
    """Each call ends when the devices of its CUDA tensors are done: the
    synchronisation is asked for every device found in the output."""

    waited = []
    monkeypatch.setattr(profiling, "_cuda_devices",
                        lambda out: {"cuda:0"} if out is not None else set())
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: waited.append(device))
    profiling.benchmark_grid(lambda: (lambda: 1), [{}], warmup=1,
                             repeats=3)
    assert waited == ["cuda:0"] * 4


def test_cuda_devices_of_nested_outputs(monkeypatch):
    """The devices are looked for at any depth of tuples, lists and dicts;
    CPU tensors and other values have none."""

    cpu = torch.ones(2)
    assert profiling._cuda_devices(({"a": [cpu]}, cpu, 3, None)) == set()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    assert profiling._cuda_devices(({"a": [cpu]}, 3)) == {cpu.device}


def test_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace holds the host's activities of the block."""

    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        torch.ones(64).cumsum(0)
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
