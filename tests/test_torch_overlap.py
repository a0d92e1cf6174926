"""The port's cross RDF of two overlapping groups against the JAX class on
the CPU (its exact XLA route), on the same seeded float32 trajectory.

The cross kernel applies no identical-atom mask, so an atom in both
groups meets itself at distance 0 and lands in bin 0, as in the JAX
package's brute sweep; an ``exclusion`` drops it when its two group-local
ids are equal.  1,200 atoms, groups ``[0, 800)`` and ``[400, 1200)``, two
frames, in an orthorhombic box (reach-1 grid), a rhombic dodecahedron
(per-block translations), a cube under 3 cutoffs (generalized grid) and
a film in 2-D (``drop_axis``): integer counts equal, ``rdf`` to
``rtol=1e-12`` (both divide the same counts by the same float64
normalization, in another order).  The card's twins are in
``tests/test_torch_cuda.py``.
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
)
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402

N_ATOMS, N_FRAMES, N_BINS, R_MAX = 1200, 2, 30, 3.0
#: (box, drop_axis, the cross sweep mode the plan must run).
SHAPES = {
    "orthorhombic": (np.array([14.0] * 3 + [90.0] * 3), None, "reach1"),
    "triclinic": (np.array([18.0] * 3 + [60.0, 60.0, 90.0]), None, "block"),
    "small_box": (np.array([8.0] * 3 + [90.0] * 3), None, "general"),
    "2d": (np.array([20.0, 20.0, 6.0, 90.0, 90.0, 90.0]), "z", "reach1"),
}
#: (exclusion, range).
OPTIONS = {"plain": (None, (0.0, R_MAX)), "ex22_offset": ((2, 2), (0.5, R_MAX))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trajectory(dims6):
    """Uniform float32 frames at uniform fractional coordinates of the
    box."""

    rng = np.random.default_rng(1200)
    frac = rng.random((N_FRAMES, N_ATOMS, 3))
    h = np.asarray(jax_triclinic_matrices(dims6), np.float64)
    traj = (frac @ h).astype(np.float32)
    # float32 rounding can land a coordinate on the box edge itself.
    if np.allclose(dims6[3:], 90.0):
        traj = np.where(traj >= np.float32(dims6[:3]), np.float32(0.0), traj)
    return traj


def _groups(uu):
    return uu.atoms[0:800], uu.atoms[400:1200]


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_overlapping_cross_rdf_matches_jax(shape, option):
    dims6, drop_axis, mode = SHAPES[shape]
    exclusion, range_ = OPTIONS[option]
    traj = _trajectory(dims6)
    kwargs = dict(n_bins=N_BINS, range=range_, exclusion=exclusion,
                  verbose=False)
    if drop_axis is not None:
        kwargs["drop_axis"] = drop_axis
    u = Universe.from_arrays(traj, dims6, dt=1.0)
    rdf = RadialDistributionFunction(*_groups(u), device="cpu", **kwargs)
    rdf.run()
    plan = rdf._searched_cell_plan()
    assert cch._sweep_mode(plan["n_cells_dim"], plan["reach"],
                           rdf._triclinic, cross=True) == mode
    ju = JaxUniverse.from_arrays(traj.astype(np.float64), dims6, dt=1.0)
    ref = JaxRDF(*_groups(ju), **kwargs)
    ref._chunk_bytes = N_FRAMES * N_ATOMS * 3 * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        ref.run()
    counts = rdf.results.counts
    if range_[0] == 0.0 and exclusion is None:
        # The 400 shared atoms, each meeting itself in each frame.
        assert counts[0] >= 400 * N_FRAMES
    assert counts.sum() > 0
    np.testing.assert_array_equal(counts, ref.results.counts)
    np.testing.assert_allclose(rdf.results.rdf, ref.results.rdf, rtol=1e-12)
