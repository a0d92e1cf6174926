"""The port's fused RDF + S(q) + MSD slice against the JAX package.

The same seeded float32 trajectory goes through
``mdhelper_tpu.analysis.multi.run_together`` and its port.  The JAX
side streams float32 (``_coord_dtype``, set on the base class so the
fused pass's own stream driver takes it too), as it does on the TPU; on
the CPU its RDF then takes the exact XLA sweep, which bins exactly like
the cell kernel.
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

from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
    StructureFactor,
)
from mdhelper_tpu_torch.analysis.transport import Onsager  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

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
def trajectory():
    """A wrapped random walk in float32 (steps well under half a box,
    so the unwrap recovers it)."""

    rng = np.random.default_rng(2026)
    walk = rng.random((N_ATOMS, 3)) * BOX + np.cumsum(
        rng.normal(0.0, 0.4, (N_FRAMES, N_ATOMS, 3)), axis=0
    )
    return np.mod(walk, BOX).astype(np.float32)


def _chunked(analyses, itemsize):
    for a in analyses:
        a._chunk_bytes = CHUNK * N_ATOMS * 3 * itemsize
    return analyses


def _jax_analyses(trajectory):
    u = JaxUniverse.from_arrays(
        trajectory.astype(np.float64), np.array([BOX] * 3 + [90.0] * 3),
        dt=1.0,
    )
    analyses = [
        JaxRDF(u.atoms, n_bins=N_BINS, range=(0.0, R_MAX),
               exclusion=(1, 1), verbose=False),
        JaxSF(u.atoms, n_points=N_POINTS, sort=False, unique=False,
              method="factor", precision="exact", verbose=False),
        JaxOnsager(u.atoms, temperature=300, unwrap=True, verbose=False),
    ]
    return _chunked(analyses, 4)


def _jax_run(trajectory, **kwargs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        return jax_run_together(_jax_analyses(trajectory), **kwargs)


def _port_analyses(trajectory):
    u = Universe.from_arrays(
        trajectory, np.array([BOX] * 3 + [90.0] * 3), dt=1.0
    )
    return _chunked([
        RadialDistributionFunction(u.atoms, n_bins=N_BINS,
                                   range=(0.0, R_MAX), exclusion=(1, 1),
                                   verbose=False, device="cpu"),
        StructureFactor(u.atoms, n_points=N_POINTS, sort=False,
                        unique=False, method="factor", precision="exact",
                        verbose=False, device="cpu"),
        Onsager(u.atoms, unwrap=True, verbose=False, device="cpu"),
    ], 4)


@pytest.fixture(scope="module")
def jax_full(trajectory):
    return _jax_run(trajectory)


def _assert_msd_close(actual, desired):
    # float32 unwrap sums and two FFT libraries; lag 0 is ~0 up to
    # float64 cancellation, hence the absolute floor.
    np.testing.assert_allclose(
        actual, desired, rtol=1e-6, atol=1e-9 * np.abs(desired).max()
    )


def test_slice_matches_jax(trajectory, jax_full):
    rdf, sf, ons = run_together(_port_analyses(trajectory))
    jrdf, jsf, jons = jax_full
    np.testing.assert_array_equal(rdf.results.counts, jrdf.results.counts)
    np.testing.assert_allclose(rdf.results.rdf, jrdf.results.rdf,
                               rtol=1e-12)
    assert rdf.results.counts.sum() > 0
    np.testing.assert_allclose(sf.results.ssf, jsf.results.ssf,
                               rtol=1e-4, atol=1e-5)
    _assert_msd_close(ons.results.msd_self, jons.results.msd_self)
    _assert_msd_close(ons.results.msd_cross, jons.results.msd_cross)
    np.testing.assert_allclose(ons.results.times, jons.results.times)


def test_slice_resumes_from_jax_carry(trajectory, jax_full):
    """JAX folds frames 0-5, the port takes its carry over with
    carry_from_numpy and folds frames 6-11: the carried sums equal the
    JAX full run, and so do the unwrapped positions the port stores."""

    head = _jax_run(trajectory, stop=6)
    carries = [
        jax.tree_util.tree_map(np.asarray, a._carry) for a in head
    ]
    rdf, sf, ons = run_together(
        _port_analyses(trajectory), start=6, initial=carries
    )
    jrdf, jsf, jons = jax_full
    np.testing.assert_array_equal(rdf.results.counts, jrdf.results.counts)
    np.testing.assert_allclose(
        sf._carry["ssf"].numpy(), np.asarray(jsf._carry["ssf"]),
        rtol=1e-4, atol=1e-5 * N_ATOMS * N_FRAMES,
    )
    np.testing.assert_array_equal(ons._positions, jons._positions[6:])
