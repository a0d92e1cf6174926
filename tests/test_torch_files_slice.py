"""The fused RDF + S(q) + MSD slice from files: ``Universe.from_files``
of a GRO topology and an XTC or DCD trajectory, written by the JAX
package, then ``run_together([RDF, S(q), Onsager])`` on
``u.select_atoms("all")`` and the cross RDF of two selections, against
the JAX classes on the same files (streaming float32, as
``tests/test_torch_slice.py`` runs them): counts equal as integers, S(q)
within ``rtol=1e-4, atol=1e-5`` and the MSDs within ``rtol=1e-6`` (the
gates of that file).  The same run over an ``ArrayReader`` of the
reader's own decoded float32 frames gives the same bits, with the
prefetch on and off; the prefetched stream yields its chunks in order
and raises the reader's errors.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis.multi import run_together as jax_run_together  # noqa: E402
from mdhelper_tpu.analysis.structure import (  # noqa: E402
    RadialDistributionFunction as JaxRDF,
    StructureFactor as JaxSF,
)
from mdhelper_tpu.analysis.transport import Onsager as JaxOnsager  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu.io import dcd as jax_dcd  # noqa: E402
from mdhelper_tpu.io import structure_writers as jax_sw  # noqa: E402
from mdhelper_tpu.io import xtc as jax_xtc  # noqa: E402

from mdhelper_tpu_torch.analysis.base import SerialAnalysisBase  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
    StructureFactor,
)
from mdhelper_tpu_torch.analysis.transport import Onsager  # noqa: E402
from mdhelper_tpu_torch.core.trajectory import ArrayReader  # noqa: E402
from mdhelper_tpu_torch.core.universe import Topology, Universe  # noqa: E402

N_ATOMS, N_FRAMES, CHUNK = 2000, 12, 4
BOX = float(N_ATOMS / 0.8) ** (1 / 3)
R_MAX, N_BINS, N_POINTS = 3.0, 50, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A wrapped float32 random walk (steps well under half a box) as a
    GRO topology with atom names A and B, an XTC and a DCD."""

    rng = np.random.default_rng(2027)
    walk = rng.random((N_ATOMS, 3)) * BOX + np.cumsum(
        rng.normal(0.0, 0.4, (N_FRAMES, N_ATOMS, 3)), axis=0
    )
    traj = np.mod(walk, BOX).astype(np.float32)
    root = tmp_path_factory.mktemp("slice")
    dims = np.array([BOX] * 3 + [90.0] * 3)
    out = {name: str(root / name) for name in ("top.gro", "traj.xtc",
                                               "traj.dcd")}
    names = np.where(np.arange(N_ATOMS) % 2 == 0, "A", "B")
    jax_sw.write_gro(out["top.gro"], traj[0], names=names, dimensions=dims)
    jax_xtc.write_xtc(out["traj.xtc"], traj / 10,
                      np.tile(np.eye(3) * BOX / 10, (N_FRAMES, 1, 1)))
    jax_dcd.write_dcd(out["traj.dcd"], traj, np.tile(dims, (N_FRAMES, 1)))
    return out


def _chunked(analyses):
    for a in analyses:
        a._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    return analyses


def _port_slice(u, prefetch=True):
    group = u.select_atoms("all")
    analyses = _chunked([
        RadialDistributionFunction(group, n_bins=N_BINS, range=(0.0, R_MAX),
                                   exclusion=(1, 1), verbose=False,
                                   device="cpu"),
        StructureFactor(group, n_points=N_POINTS, sort=False, unique=False,
                        method="factor", precision="exact", verbose=False,
                        device="cpu"),
        Onsager(group, unwrap=True, verbose=False, device="cpu"),
    ])
    for a in analyses:
        a._prefetch_batches = prefetch
    return run_together(analyses)


def _jax_slice(u):
    group = u.select_atoms("all")
    analyses = _chunked([
        JaxRDF(group, n_bins=N_BINS, range=(0.0, R_MAX), exclusion=(1, 1),
               verbose=False),
        JaxSF(group, n_points=N_POINTS, sort=False, unique=False,
              method="factor", precision="exact", verbose=False),
        JaxOnsager(group, temperature=300, unwrap=True, verbose=False),
    ])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        return jax_run_together(analyses)


def _assert_msd_close(actual, desired):
    # float32 unwrap sums and two FFT libraries; lag 0 is ~0 up to
    # float64 cancellation, hence the absolute floor.
    np.testing.assert_allclose(
        actual, desired, rtol=1e-6, atol=1e-9 * np.abs(desired).max()
    )


def _decoded(u):
    """An ArrayReader universe over `u`'s reader's own frames, decoded
    and cast to float32 as the stream casts them."""

    pos, dims = u.trajectory.read_frames(np.arange(u.trajectory.n_frames))
    reader = ArrayReader(pos.astype(np.float32), dims,
                         dt=u.trajectory.dt, times=u.trajectory.times)
    topology = Topology(u.atoms.n_atoms, names=u.atoms.names)
    return Universe(topology, reader)


def _same_results(a, b):
    rdf, sf, ons = a
    rdf2, sf2, ons2 = b
    np.testing.assert_array_equal(rdf.results.counts, rdf2.results.counts)
    np.testing.assert_array_equal(sf.results.ssf, sf2.results.ssf)
    np.testing.assert_array_equal(ons.results.msd_self, ons2.results.msd_self)
    np.testing.assert_array_equal(ons.results.msd_cross,
                                  ons2.results.msd_cross)


@pytest.mark.parametrize("trajectory", ["traj.xtc", "traj.dcd"])
def test_files_slice_equals_jax(files, trajectory):
    u = Universe.from_files(files["top.gro"], files[trajectory])
    ju = JaxUniverse.from_files(files["top.gro"], files[trajectory])
    rdf, sf, ons = _port_slice(u)
    jrdf, jsf, jons = _jax_slice(ju)
    assert rdf.results.counts.sum() > 0
    np.testing.assert_array_equal(rdf.results.counts, jrdf.results.counts)
    np.testing.assert_allclose(rdf.results.rdf, jrdf.results.rdf,
                               rtol=1e-12)
    np.testing.assert_allclose(sf.results.ssf, jsf.results.ssf,
                               rtol=1e-4, atol=1e-5)
    _assert_msd_close(ons.results.msd_self, jons.results.msd_self)
    _assert_msd_close(ons.results.msd_cross, jons.results.msd_cross)
    np.testing.assert_allclose(ons.results.times, jons.results.times)
    # the reader's own float32 frames through an ArrayReader, and the
    # stream without the prefetch: the same bits
    _same_results((rdf, sf, ons), _port_slice(_decoded(u)))
    _same_results((rdf, sf, ons), _port_slice(u, prefetch=False))


def test_cross_rdf_of_selections_equals_jax(files):
    u = Universe.from_files(files["top.gro"], files["traj.xtc"])
    ju = JaxUniverse.from_files(files["top.gro"], files["traj.xtc"])
    a, b = u.select_atoms("name A"), u.select_atoms("name B")
    assert (a.n_atoms, b.n_atoms) == (N_ATOMS // 2, N_ATOMS // 2)
    rdf = _chunked([RadialDistributionFunction(
        a, b, n_bins=N_BINS, range=(0.0, R_MAX), verbose=False,
        device="cpu")])[0]
    run_together([rdf], stop=CHUNK)
    ref = _chunked([JaxRDF(ju.select_atoms("name A"),
                           ju.select_atoms("name B"), n_bins=N_BINS,
                           range=(0.0, R_MAX), verbose=False)])[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        ref.run(stop=CHUNK)
    assert rdf.results.counts.sum() > 0
    np.testing.assert_array_equal(rdf.results.counts, ref.results.counts)


class _SlowReader(ArrayReader):
    """An ArrayReader whose reads take turns sleeping, raising at
    `fail_at` (a frame index) when set."""

    fail_at = None

    def read_frames(self, indices):
        import time

        indices = np.asarray(indices)
        time.sleep(0.02 * (indices[0] % 3))
        if self.fail_at is not None and self.fail_at in indices:
            raise OSError(f"frame {self.fail_at} is unreadable")
        return super().read_frames(indices)


def _stream(reader, prefetch):
    base = SerialAnalysisBase(reader, device="cpu")
    base._prefetch_batches = prefetch
    base._chunk_bytes = 2 * reader.n_atoms * 3 * 4
    base._setup_frames(reader)
    return base._stream_batches()


@pytest.mark.parametrize("prefetch", [True, False])
def test_stream_order_and_errors(prefetch):
    import sys

    rng = np.random.default_rng(5)
    frames = rng.random((11, 30, 3)).astype(np.float32)
    reader = _SlowReader(frames, [5.0] * 3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        batches = list(_stream(reader, prefetch))
    finally:
        sys.setswitchinterval(interval)
    assert [list(b.indices) for b in batches] == [
        [0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10]]
    np.testing.assert_array_equal(
        torch.cat([b.positions for b in batches]).numpy(), frames)
    reader.fail_at = 7
    seen = []
    with pytest.raises(OSError, match="frame 7"):
        for batch in _stream(reader, prefetch):
            seen.append(int(batch.indices[0]))
    # the chunk before the bad one: read on the calling thread before
    # the chunk before it is yielded, or on the worker while it is used
    assert seen == ([0, 2, 4] if prefetch else [0, 2])


def test_run_together_prefetches_unless_an_analysis_declines(monkeypatch):
    rng = np.random.default_rng(6)
    u = Universe.from_arrays(rng.random((6, 40, 3)).astype(np.float32) * 5,
                             [5.0] * 3)
    seen = []
    original = SerialAnalysisBase._stream_batches

    def spy(self):
        seen.append(self._prefetch_batches)
        return original(self)

    monkeypatch.setattr(SerialAnalysisBase, "_stream_batches", spy)
    assert SerialAnalysisBase._prefetch_batches is True
    for declines in (False, True):
        analyses = [Onsager(u.atoms, verbose=False, device="cpu"),
                    RadialDistributionFunction(u.atoms, n_bins=4,
                                               range=(0.0, 2.0),
                                               verbose=False, device="cpu")]
        analyses[1]._prefetch_batches = not declines
        run_together(analyses)
    assert seen == [True, False]
