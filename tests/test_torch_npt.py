"""The port's RDF and Van Hove classes on per-frame (NPT) boxes against
the JAX classes on the CPU, on the same seeded float32 trajectories.

Four frames whose box grows by 5 % in all (orthorhombic, and a 60/60/90
triclinic cell): every frame has its own box, so the kernels' per-frame
geometry (the orthorhombic half thresholds, the triclinic translations)
changes from frame to frame.  The self RDF (``exclusion`` None and (1,
1)) and the Van Hove self and distinct counts equal the JAX classes' as
integers.  A box that shrinks below the grid planned on the first frame
NaN-poisons that frame, and the class raises ``RuntimeError``.  The
card's twins are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.algorithm.topology import (  # noqa: E402
    triclinic_matrices as jax_triclinic_matrices,
)
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis.structure import (  # noqa: E402
    RadialDistributionFunction as JaxRDF,
    VanHoveFunction as JaxVanHove,
)
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
    VanHoveFunction,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N_ATOMS, N_FRAMES, N_BINS, R_MAX = 400, 4, 24, 3.0
BOXES = {
    "orthorhombic": np.array([14.0] * 3 + [90.0] * 3),
    "triclinic": np.array([18.0] * 3 + [60.0, 60.0, 90.0]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def npt_trajectory(dims6, growth=0.05, seed=77):
    """(positions, per-frame dimensions): a random walk in fractional
    coordinates, folded into [0, 1), times each frame's box matrix; the
    lengths scale linearly from 1 to ``1 + growth``."""

    rng = np.random.default_rng(seed)
    frac = rng.random((N_ATOMS, 3)) + np.cumsum(
        rng.normal(0.0, 0.02, (N_FRAMES, N_ATOMS, 3)), axis=0)
    frac = np.mod(frac, 1.0)
    scale = 1.0 + growth * np.arange(N_FRAMES) / (N_FRAMES - 1)
    dims = np.repeat(dims6[None], N_FRAMES, axis=0)
    dims[:, :3] *= scale[:, None]
    h = np.asarray(jax_triclinic_matrices(dims), np.float64)
    traj = np.einsum("fnk,fkj->fnj", frac, h).astype(np.float32)
    if np.allclose(dims6[3:], 90.0):
        edge = np.float32(dims[:, None, :3])
        traj = np.where(traj >= edge, np.float32(0.0), traj)
    return traj, dims


def _universes(traj, dims):
    return (Universe.from_arrays(traj, dims, dt=1.0),
            JaxUniverse.from_arrays(traj.astype(np.float64), dims, dt=1.0))


def _jax_run(analysis):
    analysis._chunk_bytes = N_FRAMES * N_ATOMS * 3 * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        analysis.run()
    return analysis


@pytest.mark.parametrize("exclusion", [None, (1, 1)])
@pytest.mark.parametrize("shape", list(BOXES))
def test_npt_self_rdf_matches_jax(shape, exclusion):
    traj, dims = npt_trajectory(BOXES[shape])
    u, ju = _universes(traj, dims)
    kwargs = dict(n_bins=N_BINS, range=(0.0, R_MAX), exclusion=exclusion,
                  verbose=False)
    rdf = RadialDistributionFunction(u.atoms, device="cpu", **kwargs)
    rdf._chunk_bytes = N_FRAMES * N_ATOMS * 3 * 4
    rdf.run()
    ref = _jax_run(JaxRDF(ju.atoms, **kwargs))
    assert rdf.results.counts.sum() > 0
    np.testing.assert_array_equal(rdf.results.counts, ref.results.counts)
    np.testing.assert_allclose(rdf.results.rdf, ref.results.rdf, rtol=1e-12)


@pytest.mark.parametrize("shape", list(BOXES))
def test_npt_vanhove_matches_jax(shape):
    traj, dims = npt_trajectory(BOXES[shape])
    u, ju = _universes(traj, dims)
    kwargs = dict(n_bins=N_BINS, range=(0.0, R_MAX), verbose=False)
    vh = VanHoveFunction(u.atoms, device="cpu", **kwargs)
    vh._chunk_bytes = N_FRAMES * N_ATOMS * 3 * 4
    vh.run()
    ref = _jax_run(JaxVanHove(ju.atoms, **kwargs))
    for key in ("counts_self", "counts_distinct"):
        np.testing.assert_array_equal(getattr(vh.results, key),
                                      getattr(ref.results, key))
    assert vh.results.counts_self[1].sum() > 0
    assert vh.results.counts_distinct.sum() > 0


@pytest.mark.parametrize("shape", list(BOXES))
def test_npt_shrinking_box_raises(shape):
    traj, dims = npt_trajectory(BOXES[shape], growth=-0.25)
    u = Universe.from_arrays(traj, dims, dt=1.0)
    rdf = RadialDistributionFunction(u.atoms, n_bins=N_BINS,
                                     range=(0.0, R_MAX), verbose=False,
                                     device="cpu")
    with pytest.raises(RuntimeError, match="shrank"):
        rdf.run()
