"""Checkpoint and resume of the port's streaming runtime.

* ``core/checkpoint.py``: ``save_carry``/``load_carry`` round trips of
  dict and tuple carries in the JAX package's archive layout (``leaf_{i}``
  in ``jax.tree.flatten`` order, ``__frames_done__``, ``__n_leaves__``,
  ``store||{key}``), read by the JAX ``load_carry`` too; a leaf count that
  differs from the template raises the JAX package's `ValueError`.
* The exact path: ``np.savez`` adds ``.npz`` to a path that lacks it, so
  the JAX ``run(checkpoint="state")`` writes ``state.npz`` and its next run
  starts again from frame 0 (ROADMAP Queue 3, item 17); the port writes
  and reads ``state`` itself and resumes.
* Every public analysis class of the port, built by a small factory (20
  atoms, 12 frames): where the JAX class refuses ``run(checkpoint=)``
  before streaming, the port refuses with the same `ValueError`;
  otherwise a run killed at its third chunk (2-frame chunks) and resumed
  with 3-frame chunks gives the uninterrupted run's results, and so does
  a kill-and-resume that keeps the chunking: bit for bit, but for the
  classes in ``CHUNK_ROUNDED``, whose float64 sums or batched fits over a
  chunk's frames round otherwise when the chunk starts elsewhere: their
  integer arrays equal, float arrays within 1e-12 of each array's largest
  magnitude.  A class missing from the factories fails.
* ``run_together(checkpoint=)`` with store-type classes (keys prefixed
  ``{i}::``), ``initial=`` with ``checkpoint=``, a resume into a longer
  frame selection, and ``_restore_store_state``'s shape error.
"""

import inspect
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import mdhelper_tpu.analysis as jax_analysis  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.core import checkpoint as jax_checkpoint  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

import mdhelper_tpu_torch.analysis as analysis  # noqa: E402
from mdhelper_tpu_torch.analysis import base  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.core import checkpoint  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N, T, BOX = 20, 12, 8.0
NAMES = np.array(["O", "H", "H", "C", "N"] * 4)
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_streams_float32(monkeypatch):
    monkeypatch.setattr(jax_base.SerialAnalysisBase, "_coord_dtype",
                        np.float32)


def _arrays(seed=2051, frames=T):
    rng = np.random.default_rng(seed)
    start = rng.random((N, 3)) * BOX
    steps = rng.normal(scale=0.3, size=(frames, N, 3))
    walk = start + np.cumsum(steps, axis=0)
    positions = np.mod(walk, BOX).astype(np.float32)
    velocities = rng.normal(size=(frames, N, 3)).astype(np.float32)
    topology = dict(
        masses=np.tile([16.0, 1.0, 1.0, 12.0, 14.0], 4),
        charges=np.tile([1.0, -1.0], N // 2),
        resindices=np.repeat(np.arange(N // 2), 2),
        names=NAMES, types=NAMES,
    )
    return positions, velocities, topology


def _universes(frames=T):
    positions, velocities, topology = _arrays(frames=frames)
    dims = np.array([BOX] * 3 + [90.0] * 3)
    return (
        JaxUniverse.from_arrays(positions.astype(np.float64), dims,
                                velocities=velocities, **topology),
        Universe.from_arrays(positions, dims, velocities=velocities,
                             **topology),
    )


CHAINS = dict(n_chains=4, n_monomers=5)

#: One factory a configuration: ``(analysis package, universe, device
#: keywords) -> analysis``, the same arguments for the JAX class and the
#: port's.  Keys are class names, with a bracketed configuration where a
#: class appears more than once.
FACTORIES = {
    "BondLengthDistribution": lambda A, u, d: A.bonded.BondLengthDistribution(
        u.atoms, n_bins=16, bonds=[[0, 1], [2, 3], [5, 6]], verbose=False,
        **d),
    "BondAngleDistribution": lambda A, u, d: A.bonded.BondAngleDistribution(
        u.atoms, n_bins=18, angles=[[0, 1, 2], [3, 4, 5]], verbose=False,
        **d),
    "DihedralDistribution": lambda A, u, d: A.bonded.DihedralDistribution(
        u.atoms, n_bins=18, dihedrals=[[0, 1, 2, 3]], verbose=False, **d),
    "ClusterSizeDistribution": lambda A, u, d:
        A.cluster.ClusterSizeDistribution(u.atoms, 1.5, verbose=False, **d),
    "NativeContacts": lambda A, u, d: A.contacts.NativeContacts(
        u.atoms[:10], u.atoms[10:], radius=4.0, verbose=False, **d),
    "VelocityAutocorrelation": lambda A, u, d:
        A.dynamics.VelocityAutocorrelation(u.atoms, verbose=False, **d),
    "ElectricCurrentAutocorrelation": lambda A, u, d:
        A.dynamics.ElectricCurrentAutocorrelation(u.atoms, 300.0,
                                                  verbose=False, **d),
    "SurvivalProbability": lambda A, u, d: A.dynamics.SurvivalProbability(
        u.atoms, ("shell", u.atoms[:4], 2.5), verbose=False, **d),
    "OverlapFunction": lambda A, u, d: A.dynamics.OverlapFunction(
        u.atoms, 0.5, n_lags=5, verbose=False, **d),
    "DipoleMoment": lambda A, u, d: A.electrostatics.DipoleMoment(
        u.atoms, unwrap=True, verbose=False, **d),
    "FlowProfile": lambda A, u, d: A.flow.FlowProfile(
        u.atoms, n_bins=4, verbose=False, **d),
    "HydrogenBondAnalysis": lambda A, u, d: A.hbonds.HydrogenBondAnalysis(
        u, acceptors_sel="name O N", donor_hydrogen_pairs=[[0, 1], [5, 6]],
        d_a_cutoff=4.0, d_h_a_angle_cutoff=100.0, pair_counts=True,
        lifetimes=True, verbose=False, **d),
    "WillardChandlerInterface": lambda A, u, d:
        A.interface.WillardChandlerInterface(u.atoms, n_cells=4,
                                             verbose=False, **d),
    "IntrinsicDensityProfile": lambda A, u, d:
        A.interface.IntrinsicDensityProfile(u.atoms, n_cells=4, n_bins=6,
                                            verbose=False, **d),
    "NematicOrderParameter": lambda A, u, d:
        A.orientation.NematicOrderParameter(u.atoms[0::2], u.atoms[1::2],
                                            acf=True, verbose=False, **d),
    "OrientationProfile": lambda A, u, d: A.orientation.OrientationProfile(
        u.atoms[0::2], u.atoms[1::2], n_bins=4, verbose=False, **d),
    "Gyradius": lambda A, u, d: A.polymer.Gyradius(
        u.atoms, **CHAINS, shape=True, unwrap=True, verbose=False, **d),
    "EndToEndVector": lambda A, u, d: A.polymer.EndToEndVector(
        u.atoms, **CHAINS, unwrap=True, verbose=False, **d),
    "SingleChainStructureFactor": lambda A, u, d:
        A.polymer.SingleChainStructureFactor(u.atoms, n_points=3, **CHAINS,
                                             verbose=False, **d),
    "RouseModes": lambda A, u, d: A.polymer.RouseModes(
        u.atoms, **CHAINS, verbose=False, **d),
    "IonPairAnalysis": lambda A, u, d: A.pairing.IonPairAnalysis(
        u.atoms[0::2], u.atoms[1::2], 3.0, pair_counts=True,
        lifetimes=True, verbose=False, **d),
    "IonPairAnalysis[residues]": lambda A, u, d: A.pairing.IonPairAnalysis(
        u.atoms, u.atoms, 4.0, "residues", verbose=False, **d),
    "SolventAccessibleSurfaceArea": lambda A, u, d:
        A.sasa.SolventAccessibleSurfaceArea(u.atoms, n_points=30,
                                            verbose=False, **d),
    "PersistenceLength": lambda A, u, d: A.polymer.PersistenceLength(
        u.atoms, **CHAINS, unwrap=True, verbose=False, **d),
    "MeanSquareInternalDistance": lambda A, u, d:
        A.polymer.MeanSquareInternalDistance(u.atoms, **CHAINS,
                                             verbose=False, **d),
    "DensityProfile": lambda A, u, d: A.profile.DensityProfile(
        u.atoms, axes="z", n_bins=6, verbose=False, **d),
    "DensityProfile[recenter]": lambda A, u, d: A.profile.DensityProfile(
        [u.atoms[:4], u.atoms[4:]], axes="z", n_bins=6, recenter=0,
        verbose=False, **d),
    "RadialDensityProfile": lambda A, u, d: A.profile.RadialDensityProfile(
        u.atoms, np.full(3, 4.0), n_bins=6, range=(0.0, 3.0),
        verbose=False, **d),
    "DensityMap2D": lambda A, u, d: A.profile.DensityMap2D(
        u.atoms, n_bins=4, verbose=False, **d),
    "DensityMap3D": lambda A, u, d: A.profile.DensityMap3D(
        u.atoms, n_bins=4, verbose=False, **d),
    "RMSD": lambda A, u, d: A.rmsd.RMSD(u.atoms, verbose=False, **d),
    "RMSF": lambda A, u, d: A.rmsd.RMSF(u.atoms, verbose=False, **d),
    "PrincipalComponentAnalysis": lambda A, u, d:
        A.rmsd.PrincipalComponentAnalysis(u.atoms[:3], align=False,
                                          verbose=False, **d),
    "TICA": lambda A, u, d: A.rmsd.TICA(u.atoms[:3], lag=2, align=False,
                                        verbose=False, **d),
    "SteinhardtOrderParameter": lambda A, u, d:
        A.steinhardt.SteinhardtOrderParameter(u.atoms, 3.0, averaged=True,
                                              wl=True, verbose=False, **d),
    "TetrahedralOrderParameter": lambda A, u, d:
        A.steinhardt.TetrahedralOrderParameter(u.atoms, verbose=False, **d),
    "RadialDistributionFunction": lambda A, u, d:
        A.structure.RadialDistributionFunction(
            u.atoms, n_bins=8, range=(0.0, 2.5), verbose=False, **d),
    "RadialDistributionFunction[cross]": lambda A, u, d:
        A.structure.RadialDistributionFunction(
            u.atoms[0::2], u.atoms[1::2], n_bins=8, range=(0.0, 2.5),
            verbose=False, **d),
    "StructureFactor[mesh]": lambda A, u, d: A.structure.StructureFactor(
        u.atoms, n_points=3, method="mesh", verbose=False, **d),
    "StructureFactor": lambda A, u, d: A.structure.StructureFactor(
        u.atoms, n_points=3, verbose=False, **d),
    "IntermediateScatteringFunction": lambda A, u, d:
        A.structure.IntermediateScatteringFunction(
            u.atoms, n_points=3, n_lags=5, verbose=False, **d),
    "IntermediateScatteringFunction[ring]": lambda A, u, d:
        A.structure.IntermediateScatteringFunction(
            u.atoms, n_points=3, n_lags=5, fft=False, incoherent=True,
            verbose=False, **d),
    "VanHoveFunction": lambda A, u, d: A.structure.VanHoveFunction(
        u.atoms, n_bins=8, range=(0.0, 2.5), n_lags=5, verbose=False, **d),
    "Onsager": lambda A, u, d: A.transport.Onsager(
        u.atoms, unwrap=True, center=True, verbose=False, **d),
}

#: Configurations whose float results depend on where a chunk starts: a
#: chunk's float64 moments or sums (bond-length std, flow profiles, the
#: persistence ACF, PCA, TICA, the single-chain S(q)) or its batched fit
#: (RMSD, RMSF: one batched eigh a chunk).
CHUNK_ROUNDED = {
    "BondLengthDistribution", "FlowProfile", "PersistenceLength",
    "PrincipalComponentAnalysis", "RMSD", "RMSF",
    "SingleChainStructureFactor", "TICA",
}

#: The abstract bases the analyses derive from (with the n_threads shim
#: and its other name).
BASES = {"SerialAnalysisBase", "ParallelAnalysisBase", "DynamicAnalysisBase",
         "NumbaAnalysisBase", "JittedAnalysisBase"}


def _public_classes():
    names = set()
    for module in vars(analysis).values():
        if not inspect.ismodule(module):
            continue
        for name, obj in vars(module).items():
            if (inspect.isclass(obj)
                    and issubclass(obj, base.SerialAnalysisBase)
                    and obj.__module__ == module.__name__
                    and not name.startswith("_") and name not in BASES):
                names.add(name)
    return names


def test_every_public_class_has_a_factory():
    covered = {key.split("[")[0] for key in FACTORIES}
    missing = _public_classes() - covered
    assert not missing, f"no checkpoint factory for {sorted(missing)}"


class _Streamed(Exception):
    pass


def _jax_refuses(name, ju, path):
    """Whether the JAX class refuses ``run(checkpoint=)`` before it
    streams (its stream is replaced by one that raises at once)."""

    a = FACTORIES[name](jax_analysis, ju, {})

    def stream(*args, **kwargs):
        raise _Streamed

    a._stream_batches = stream
    try:
        a.run(checkpoint=str(path))
    except _Streamed:
        return None
    except ValueError as err:
        return str(err)
    raise AssertionError("the JAX run returned without streaming")


@pytest.fixture
def chunk_frames(monkeypatch):
    """A dict whose ``"frames"`` entry sets every stream's chunk, in
    frames, whatever columns it carries."""

    setting = {"frames": 2}
    stream = base.SerialAnalysisBase._stream_batches

    def chunked(self):
        idx = self._effective_atom_indices()
        n = len(idx) if idx is not None else self._trajectory.n_atoms
        cols = (self._payload_width() if self._coord_axes is None
                else len(self._coord_axes))
        self._chunk_bytes = setting["frames"] * n * cols * 4
        return stream(self)

    monkeypatch.setattr(base.SerialAnalysisBase, "_stream_batches", chunked)
    return setting


class _Killed(Exception):
    pass


def _kill_at_chunk(a, k):
    """Make `a`'s run raise when it reaches its `k`-th chunk (1-based),
    before folding it."""

    update = a._batched_update
    seen = [0]

    def killer(carry, batch):
        seen[0] += 1
        if seen[0] == k:
            raise _Killed
        return update(carry, batch)

    a._batched_update = killer


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return value


def assert_same_results(ref, got, where="results", exact=True):
    """Equal bit for bit (`exact`), or integers equal and floats within
    1e-12 of each array's largest magnitude; other values equal
    (quantities by their text)."""

    ref, got = _host(ref), _host(got)
    if isinstance(ref, dict):
        assert set(ref) == set(got), where
        for key in ref:
            assert_same_results(ref[key], got[key], f"{where}.{key}",
                                exact)
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), where
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_same_results(r, g, f"{where}[{i}]", exact)
    elif isinstance(ref, (np.ndarray, np.generic, float, int, bool)):
        ref, got = np.asarray(ref), np.asarray(got)
        assert ref.shape == got.shape, where
        if exact or ref.dtype.kind in "biu":
            np.testing.assert_array_equal(got, ref, err_msg=where,
                                          strict=True)
        else:
            finite = np.abs(ref[np.isfinite(ref)])
            scale = float(finite.max()) if finite.size else 0.0
            np.testing.assert_allclose(got, ref, rtol=1e-12,
                                       atol=1e-12 * scale, equal_nan=True,
                                       err_msg=where)
    else:
        assert str(ref) == str(got), where


def _determined(name, results):
    """`results` less what rounding alone picks: PCA's components of zero
    variance (centering removes three dimensions) span a null space whose
    basis the eigensolver picks from the moments' last bits."""

    if name == "PrincipalComponentAnalysis":
        variance = results["variance"]
        keep = variance > 1e-9 * variance[0]
        results = dict(results, p_components=results["p_components"][:, keep])
    return results


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_every_class_resumes_or_refuses_as_jax(name, tmp_path,
                                               chunk_frames):
    ju, tu = _universes()
    refusal = _jax_refuses(name, ju, tmp_path / "jax_state")
    path = str(tmp_path / "state")
    if refusal is not None:
        port = FACTORIES[name](analysis, tu, CPU)
        with pytest.raises(ValueError) as err:
            port.run(checkpoint=path)
        assert str(err.value) == refusal
        assert not Path(path).exists()
        return

    ref = FACTORIES[name](analysis, tu, CPU).run()
    for resume_frames in (3, 2):
        Path(path).unlink(missing_ok=True)
        chunk_frames["frames"] = 2
        killed = FACTORIES[name](analysis, tu, CPU)
        _kill_at_chunk(killed, 3)
        with pytest.raises(_Killed):
            killed.run(checkpoint=path)
        _, done = checkpoint.load_carry(path, killed._carry)
        assert done == 4
        chunk_frames["frames"] = resume_frames
        resumed = FACTORIES[name](analysis, tu, CPU)
        streamed = []
        update = resumed._batched_update
        resumed._batched_update = lambda c, b: (
            streamed.append(list(b.indices)) or update(c, b))
        resumed.run(checkpoint=path)
        assert streamed[0][0] == 4
        assert sum(map(len, streamed)) == T - 4
        assert_same_results(_determined(name, ref.results),
                            _determined(name, resumed.results),
                            exact=name not in CHUNK_ROUNDED)


# -- the archive ----------------------------------------------------------------


def test_dict_and_tuple_carries_round_trip_in_the_jax_layout(tmp_path):
    carry = {
        "b": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "a": (torch.tensor([1.5, 2.5], dtype=torch.float64),
              torch.zeros((), dtype=torch.float32)),
        "c": None,
        "d": [torch.ones(2, dtype=torch.int32), 7],
    }
    path = str(tmp_path / "carry")
    stores = {"results::x": np.arange(4.0), "__store_offset__": np.int64(3)}
    checkpoint.save_carry(path, carry, 9, stores=stores)
    assert Path(path).exists() and not Path(path + ".npz").exists()
    with np.load(path) as archive:
        assert sorted(archive.files) == [
            "__frames_done__", "__n_leaves__", "leaf_0", "leaf_1",
            "leaf_2", "leaf_3", "leaf_4", "store||__store_offset__",
            "store||results::x"]
        assert int(archive["__n_leaves__"]) == 5
        # jax.tree.flatten's order: dict keys sorted, sequences in order
        np.testing.assert_array_equal(archive["leaf_0"], [1.5, 2.5])
        np.testing.assert_array_equal(archive["leaf_2"], np.arange(6)
                                      .reshape(2, 3))
        assert int(archive["leaf_4"]) == 7
    template = {key: value for key, value in carry.items()}
    template["b"] = torch.zeros((2, 3), dtype=torch.int64)
    loaded, done, got = checkpoint.load_carry(path, template,
                                              with_stores=True)
    assert done == 9 and list(loaded) == list(carry)
    assert loaded["c"] is None and loaded["d"][1] == 7
    assert isinstance(loaded["d"][1], int) and isinstance(loaded["a"], tuple)
    for key in ("b",):
        assert torch.equal(loaded[key], carry[key])
        assert loaded[key].dtype == carry[key].dtype
    assert loaded["a"][1].dtype == torch.float32
    np.testing.assert_array_equal(got["results::x"], np.arange(4.0))
    assert checkpoint.load_carry(path, template)[1] == 9
    # the JAX package reads the port's archive with a JAX template
    jtemplate = jax.tree.map(lambda x: np.asarray(x), {
        "b": np.zeros((2, 3), np.int64), "a": (np.zeros(2), np.float32(0)),
        "c": None, "d": [np.zeros(2, np.int32), 0]})
    jcarry, jdone = jax_checkpoint.load_carry(path, jtemplate)
    assert jdone == 9
    np.testing.assert_array_equal(jcarry["a"][0], [1.5, 2.5])
    np.testing.assert_array_equal(jcarry["b"], np.arange(6).reshape(2, 3))


def test_a_tuple_carry_reads_a_jax_archive(tmp_path):
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_carry(path, (np.ones(3), {"y": np.int64(2),
                                                  "x": np.zeros(2)}), 5)
    template = (torch.zeros(3, dtype=torch.float32),
                {"x": torch.ones(2), "y": torch.zeros((), dtype=torch.int64)})
    carry, done = checkpoint.load_carry(path, template)
    assert done == 5
    assert carry[0].dtype == torch.float32 and carry[0].tolist() == [1.0] * 3
    assert int(carry[1]["y"]) == 2 and carry[1]["x"].tolist() == [0.0, 0.0]


def test_a_leaf_count_change_raises_as_jax(tmp_path):
    path = str(tmp_path / "carry")
    checkpoint.save_carry(path, (torch.zeros(2), torch.zeros(3)), 4)
    with pytest.raises(ValueError) as port_err:
        checkpoint.load_carry(path, (torch.zeros(2),))
    jax_checkpoint.save_carry(str(tmp_path / "jax.npz"),
                              (np.zeros(2), np.zeros(3)), 4)
    with pytest.raises(ValueError) as jax_err:
        jax_checkpoint.load_carry(str(tmp_path / "jax.npz"), (np.zeros(2),))
    assert str(port_err.value) == str(jax_err.value)


def test_the_exact_path_resumes_where_jax_does_not(tmp_path, chunk_frames):
    """``run(checkpoint="state")``: ``np.savez`` makes the JAX class write
    ``state.npz``, which its next run never finds, so it starts again
    from frame 0 (ROADMAP Queue 3, item 17); the port writes ``state``
    and resumes at frame 4."""

    ju, tu = _universes()
    rdf = FACTORIES["RadialDistributionFunction"]
    jpath = tmp_path / "jax" / "state"
    jpath.parent.mkdir()
    first = rdf(jax_analysis, ju, {})
    first._chunk_bytes = 2 * N * 3 * 4
    first.run(stop=4, checkpoint=str(jpath))
    assert sorted(p.name for p in jpath.parent.iterdir()) == ["state.npz"]
    again = rdf(jax_analysis, ju, {})
    again._chunk_bytes = 2 * N * 3 * 4
    seen = []
    update = again._batched_update
    again._batched_update = lambda c, b: (seen.append(int(b.indices[0]))
                                          or update(c, b))
    again.run(checkpoint=str(jpath))
    assert seen[0] == 0

    path = tmp_path / "port" / "state"
    path.parent.mkdir()
    rdf(analysis, tu, CPU).run(stop=4, checkpoint=str(path))
    assert sorted(p.name for p in path.parent.iterdir()) == ["state"]
    resumed = rdf(analysis, tu, CPU)
    seen = []
    update = resumed._batched_update
    resumed._batched_update = lambda c, b: (seen.append(int(b.indices[0]))
                                            or update(c, b))
    resumed.run(checkpoint=str(path))
    assert seen[0] == 4
    ref = rdf(analysis, tu, CPU).run()
    np.testing.assert_array_equal(resumed.results.counts, ref.results.counts)
    np.testing.assert_array_equal(resumed.results.counts, again.results.counts)


def test_resume_into_a_longer_selection(tmp_path, chunk_frames):
    """A checkpoint of frames 0-5 of a 9-frame selection resumes into the
    whole 12 frames: store buffers restore into their leading prefix."""

    _, tu = _universes()
    path = str(tmp_path / "state")
    for name in ("HydrogenBondAnalysis", "Onsager", "IonPairAnalysis"):
        Path(path).unlink(missing_ok=True)
        first = FACTORIES[name](analysis, tu, CPU)
        _kill_at_chunk(first, 4)
        with pytest.raises(_Killed):
            first.run(stop=9, checkpoint=path)
        resumed = FACTORIES[name](analysis, tu, CPU).run(checkpoint=path)
        ref = FACTORIES[name](analysis, tu, CPU).run()
        assert_same_results(ref.results, resumed.results)


def test_a_shorter_selection_raises_the_store_shape_error(tmp_path,
                                                          chunk_frames):
    _, tu = _universes()
    path = str(tmp_path / "state")
    FACTORIES["HydrogenBondAnalysis"](analysis, tu, CPU).run(
        checkpoint=path)
    short = FACTORIES["HydrogenBondAnalysis"](analysis, tu, CPU)
    with pytest.raises(ValueError, match="incompatible with this run's "
                       "frame selection"):
        short.run(stop=6, checkpoint=path)
    a = FACTORIES["VelocityAutocorrelation"](analysis, tu, CPU)
    a._setup_frames(stop=6)
    a._prepare()
    with pytest.raises(ValueError, match="'_store' \\(shape \\(8, 20, 3\\)"):
        a._restore_store_state({"attr::_store": np.zeros((8, N, 3))})
    with pytest.raises(ValueError, match="buffer shape None"):
        a._restore_store_state({"results::missing": np.zeros(3)})


# -- run_together -----------------------------------------------------------


def _together(tu):
    return [FACTORIES[name](analysis, tu, CPU) for name in (
        "RadialDistributionFunction", "HydrogenBondAnalysis", "Onsager",
        "IonPairAnalysis")]


def _killing_hook(k):
    seen = [0]

    def on_chunk(batch):
        seen[0] += 1
        if seen[0] == k:
            raise _Killed

    return on_chunk


def test_run_together_resumes_store_type_classes(tmp_path, chunk_frames):
    _, tu = _universes()
    ref = run_together(_together(tu))
    path = str(tmp_path / "state")
    with pytest.raises(_Killed):
        run_together(_together(tu), checkpoint=path,
                     on_chunk=_killing_hook(3))
    with np.load(path) as archive:
        # the hook runs before the chunk's save: two chunks were saved
        assert int(archive["__frames_done__"]) == 4
        keys = {name.split("::")[0] for name in archive.files
                if name.startswith("store||")}
        # store state of the store-type analyses, prefixed by position
        assert keys == {"store||1", "store||2", "store||3"}
        assert "store||3::attr::_existence" in archive.files
        assert archive["store||3::attr::_existence"].shape[0] == 4
    chunk_frames["frames"] = 4
    seen = []
    out = run_together(_together(tu), checkpoint=path,
                       on_chunk=lambda b: seen.append(list(b.indices)))
    assert seen[0][0] == 4 and sum(map(len, seen)) == T - 4
    for r, o in zip(ref, out):
        assert_same_results(r.results, o.results)


def test_run_together_refuses_as_jax(tmp_path, chunk_frames):
    ju, tu = _universes()
    path = str(tmp_path / "state")
    refusal = _jax_refuses("DensityProfile", ju, tmp_path / "jax_state")
    group = [FACTORIES["RadialDistributionFunction"](analysis, tu, CPU),
             FACTORIES["DensityProfile"](analysis, tu, CPU)]
    with pytest.raises(ValueError) as err:
        run_together(group, checkpoint=path)
    assert str(err.value) == refusal
    assert not Path(path).exists()


def test_initial_and_checkpoint_together_raise(tmp_path):
    _, tu = _universes()
    with pytest.raises(ValueError, match="initial= and checkpoint="):
        run_together(_together(tu)[:1], initial=[None],
                     checkpoint=str(tmp_path / "state"))


def test_without_checkpoint_nothing_is_written_or_synced(tmp_path,
                                                         chunk_frames,
                                                         monkeypatch):
    """A run without ``checkpoint=`` saves nothing and drains its stores
    only at the end: the queue stays one chunk late."""

    _, tu = _universes()
    saves = []
    monkeypatch.setattr(checkpoint, "save_carry",
                        lambda *a, **k: saves.append(a))
    a = FACTORIES["HydrogenBondAnalysis"](analysis, tu, CPU)
    depth = []
    update = a._batched_update
    a._batched_update = lambda c, b: (
        depth.append(len(a._pending_stores)) or update(c, b))
    a.run()
    assert not saves and depth == [0] + [1] * 5
