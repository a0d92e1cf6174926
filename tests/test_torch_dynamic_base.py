"""The serial ``DynamicAnalysisBase`` and the streaming it gained: column
streaming (``_coord_axes``), tuple extras, the per-analysis axis gather of
``run_together``, and runs that the JAX package began.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis.electrostatics import (  # noqa: E402
    DipoleMoment as JaxDipoleMoment,
)
from mdhelper_tpu.analysis.profile import (  # noqa: E402
    DensityProfile as JaxDensityProfile,
)
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.analysis.base import (  # noqa: E402
    DynamicAnalysisBase,
    SerialAnalysisBase,
)
from mdhelper_tpu_torch.analysis.electrostatics import DipoleMoment  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.profile import (  # noqa: E402
    DensityMap2D,
    DensityProfile,
)
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.testing import water_system  # noqa: E402

BOX = np.array([10.0, 12.0, 14.0])
N_MOL, N_FRAMES, CHUNK = 100, 10, 2
N_ATOMS = 3 * N_MOL


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


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(11)
    frames, topology = water_system(rng, N_MOL, 10.0, N_FRAMES, step=0.7,
                                    charges=True)
    frames = np.mod(frames * (BOX / 10.0), BOX).astype(np.float32)
    dims = np.concatenate([BOX, [90.0] * 3])
    ju = JaxUniverse.from_arrays(frames.astype(np.float64), dims, dt=1.0,
                                 **topology)
    tu = Universe.from_arrays(frames, dims, dt=1.0, **topology)
    return ju, tu, frames


def _chunked(analysis):
    analysis._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    return analysis


def _profile(u, **kwargs):
    cls = JaxDensityProfile if isinstance(u, JaxUniverse) else DensityProfile
    if cls is DensityProfile:
        kwargs["device"] = "cpu"
    return _chunked(cls([u.atoms[0::3], u.atoms[1::3]], axes="z",
                        n_bins=28, verbose=False, **kwargs))


def _dipoles(u, **kwargs):
    cls = JaxDipoleMoment if isinstance(u, JaxUniverse) else DipoleMoment
    if cls is DipoleMoment:
        kwargs["device"] = "cpu"
    return _chunked(cls(u.atoms, unwrap=True, verbose=False, **kwargs))


def _streamed(analysis):
    analysis._setup_frames()
    analysis._prepare()
    return list(analysis._stream_batches())


def test_serial_dynamic_base_streams_as_the_serial_base(system):
    _, tu, _ = system
    dynamic = _chunked(DynamicAnalysisBase(tu.trajectory, False,
                                           device="cpu"))
    serial = _chunked(SerialAnalysisBase(tu.trajectory, device="cpu"))
    assert isinstance(dynamic, SerialAnalysisBase)
    for a, b in zip(_streamed(dynamic), _streamed(serial), strict=True):
        assert torch.equal(a.positions, b.positions)
        assert torch.equal(a.dimensions, b.dimensions)
        np.testing.assert_array_equal(a.indices, b.indices)


def test_parallel_raises(system):
    _, tu, _ = system
    """The bare base declares neither ``_rank_sharded`` nor
    ``_sequential``: ``parallel=True`` raises, naming what a subclass
    must declare."""

    with pytest.raises(NotImplementedError, match="_rank_sharded = True"):
        DynamicAnalysisBase(tu.trajectory, True, device="cpu")


def test_z_profile_streams_one_column(system):
    """Without recentering a z profile reads the z column only, so a chunk
    of the same bytes holds three times the frames; a plane map reads
    two; recentering reads all three."""

    _, tu, frames = system

    def shapes(batches):
        return [tuple(b.positions.shape) for b in batches]

    def analysis(cls, **kwargs):
        return _chunked(cls(tu.atoms, verbose=False, device="cpu",
                            **kwargs))

    z = _streamed(analysis(DensityProfile, axes="z", n_bins=28))
    assert shapes(z) == [(3 * CHUNK, N_ATOMS, 1), (4, N_ATOMS, 1)]
    np.testing.assert_array_equal(z[0].positions[..., 0].numpy(),
                                  frames[:3 * CHUNK, :, 2])
    plane = _streamed(analysis(DensityMap2D, axes="xz", n_bins=8))
    assert shapes(plane) == [(3, N_ATOMS, 2)] * 3 + [(1, N_ATOMS, 2)]
    np.testing.assert_array_equal(plane[1].positions.numpy(),
                                  frames[3:6][:, :, [0, 2]])
    recentered = _streamed(analysis(DensityProfile, axes="z", n_bins=28,
                                    recenter=0))
    assert shapes(recentered) == [(CHUNK, N_ATOMS, 3)] * (N_FRAMES // CHUNK)


def test_run_together_equals_separate_runs(system):
    """A z profile (one column), a dipole analysis (three, unwrapped) and
    an RDF (three) from one stream of all three columns."""

    _, tu, _ = system

    def analyses():
        return [
            _profile(tu),
            _dipoles(tu),
            _chunked(RadialDistributionFunction(
                tu.atoms[0::3], n_bins=30, range=(0.0, 4.0), verbose=False,
                device="cpu")),
        ]

    together = run_together(analyses())
    alone = [a.run() for a in analyses()]
    for p, q in zip(together[0].results.number_densities,
                    alone[0].results.number_densities):
        np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(together[1].results.dipoles,
                                  alone[1].results.dipoles)
    np.testing.assert_array_equal(together[1].results.volumes,
                                  alone[1].results.volumes)
    np.testing.assert_array_equal(together[2].results.counts,
                                  alone[2].results.counts)
    assert together[2].results.counts.sum() > 0


def test_tuple_extras_are_absorbed_one_chunk_late(system):
    """A chunk's (dipoles, volumes) reach _store_chunk as numpy arrays
    after the next chunk's update, and the last one at the drain."""

    _, tu, _ = system
    a = _dipoles(tu)
    events = []
    a._setup_frames()
    a._prepare()
    update = a._update

    def logged_update(carry, positions, dimensions, mask):
        events.append(("update", positions.shape[0]))
        return update(carry, positions, dimensions, mask)

    store = a._store_chunk

    def logged_store(extras, batch):
        assert isinstance(extras, tuple) and len(extras) == 2
        assert all(isinstance(e, np.ndarray) for e in extras)
        assert extras[0].shape == (batch.n_real, 1, 3)
        events.append(("store", int(batch.indices[0])))
        store(extras, batch)

    a._prepare = lambda: None
    a._update = logged_update
    a._store_chunk = logged_store
    a.run()
    n_chunks = N_FRAMES // CHUNK
    expected = [("update", CHUNK)]
    for i in range(1, n_chunks):
        expected += [("update", CHUNK), ("store", (i - 1) * CHUNK)]
    expected.append(("store", (n_chunks - 1) * CHUNK))
    assert events == expected
    assert np.abs(a.results.dipoles).max() > 0


def test_resumes_an_averaged_profile_from_jax(system):
    """JAX folds frames 0-3, the port takes its counts over and folds
    frames 4-9: the counts equal the JAX full run's."""

    ju, tu, _ = system
    head = _profile(ju).run(stop=4)
    carry = jax.tree_util.tree_map(np.asarray, head._carry)
    full = _profile(ju).run()
    (tail,) = run_together([_profile(tu)], start=4, initial=[carry])
    for p, j in zip(tail._carry, full._carry):
        assert p.dtype == torch.int64
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_resumes_an_unwrapping_dipole_run_from_jax(system):
    """JAX unwraps frames 0-4, the port takes its (previous positions,
    image counts) over for frames 5-9: the dipoles equal the port's own
    full run's, and the JAX full run's within the float32 bound."""

    ju, tu, frames = system
    head = _dipoles(ju).run(stop=5)
    carry = jax.tree_util.tree_map(np.asarray, head._carry)
    (tail,) = run_together([_dipoles(tu)], start=5, initial=[carry])
    own = _dipoles(tu).run()
    np.testing.assert_allclose(tail.results.dipoles, own.results.dipoles[5:],
                               rtol=1e-13, atol=1e-12)
    full = _dipoles(ju).run()
    bound = (N_ATOMS + 2) * 2.0**-24 * 0.85 * N_ATOMS * 2 * BOX.max()
    np.testing.assert_allclose(tail.results.dipoles, full.results.dipoles[5:],
                               rtol=0, atol=bound)


@pytest.mark.parametrize("name", ["RadialDensityProfile", "DensityMap2D",
                                  "DensityMap3D"])
def test_resumes_counts_dicts_from_jax(system, name):
    """The ``{"counts", "length"}`` and ``{"counts", "n"}`` carries of the
    radial profile and the maps: JAX folds frames 0-5, the port folds
    frames 6-9 onto its counts, which then equal the JAX full run's."""

    from mdhelper_tpu.analysis import profile as jax_profile
    from mdhelper_tpu_torch.analysis import profile

    ju, tu, _ = system
    kwargs = {
        "RadialDensityProfile": dict(n_bins=24, range=(0.0, 5.0)),
        "DensityMap2D": dict(axes="yz", n_bins=(7, 9)),
        "DensityMap3D": dict(n_bins=5),
    }[name]

    def make(module, u, **extra):
        args = ((u.atoms[0::3],) if name != "RadialDensityProfile"
                else (u.atoms[0::3], np.array([5.0, 6.0, 7.0])))
        return _chunked(getattr(module, name)(*args, verbose=False,
                                              **kwargs, **extra))

    head = make(jax_profile, ju).run(stop=6)
    carry = jax.tree_util.tree_map(np.asarray, head._carry)
    full = make(jax_profile, ju).run()
    (tail,) = run_together([make(profile, tu, device="cpu")], start=6,
                           initial=[carry])
    assert tail._carry["counts"].dtype == torch.int64
    np.testing.assert_array_equal(tail._carry["counts"].numpy(),
                                  np.asarray(full._carry["counts"]))
    for key in set(tail._carry) - {"counts"}:
        np.testing.assert_allclose(tail._carry[key].numpy(),
                                   np.asarray(full._carry[key]), rtol=1e-12)
