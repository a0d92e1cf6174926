"""The port's Van Hove function G(r, t)
(:class:`mdhelper_tpu_torch.analysis.structure.VanHoveFunction`) and its
self-part histogram against the JAX package on the CPU.

The same seeded float32 trajectory, wrapped into the box, goes through
both.  The JAX side streams float32 (``_coord_dtype``), as it does on
the TPU, so it bins in exact double-float like the port; its CPU route
sweeps the distinct part with the exact XLA histogram, the port with the
cross cell-list kernel's plain version.  Integer counts compare equal;
``gs`` and ``gd`` to ``rtol=1e-12``; ``msd`` and ``alpha2`` to
``rtol=1e-5``, because both sum r^2 in float32, in different orders.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis.structure import (  # noqa: E402
    VanHoveFunction as JaxVanHove,
    _resolve_lag_values as jax_resolve_lag_values,
)
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu.ops.histogram import (  # noqa: E402
    _min_image_distance as jax_min_image_distance,
    displacement_histogram_frame as jax_displacement_histogram_frame,
)

from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
    VanHoveFunction,
    _resolve_lag_values,
)
from mdhelper_tpu_torch.algorithm.topology import (  # noqa: E402
    triclinic_matrices,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.ops.histogram import (  # noqa: E402
    _min_image_distance,
    displacement_histogram_frame,
)

N_ATOMS, N_FRAMES, BOX = 600, 12, 12.0
R_MAX, N_BINS = 3.0, 40
DIMENSIONS = np.array([BOX] * 3 + [90.0] * 3)


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
    """A random walk wrapped into [0, BOX) in float32 (steps well under
    half a box, so minimum-image displacements are the true ones)."""

    rng = np.random.default_rng(2028)
    walk = rng.random((N_ATOMS, 3)) * BOX + np.cumsum(
        rng.normal(0.0, 0.3, (N_FRAMES, N_ATOMS, 3)), axis=0
    )
    traj = np.mod(walk, BOX).astype(np.float32)
    # float32 rounding can land a coordinate on BOX itself.
    return np.where(traj >= np.float32(BOX), np.float32(0.0), traj)


def _jax_vanhove(trajectory, chunk, run_kwargs=None, **kwargs):
    u = JaxUniverse.from_arrays(trajectory.astype(np.float64), DIMENSIONS,
                                dt=0.5)
    vh = JaxVanHove(u.atoms, n_bins=N_BINS, range=(0.0, R_MAX),
                    verbose=False, **kwargs)
    vh._chunk_bytes = chunk * N_ATOMS * 3 * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        vh.run(**(run_kwargs or {}))
    return vh


def _port_vanhove(trajectory, chunk, **kwargs):
    u = Universe.from_arrays(trajectory, DIMENSIONS, dt=0.5)
    vh = VanHoveFunction(u.atoms, n_bins=N_BINS, range=(0.0, R_MAX),
                         verbose=False, device="cpu", **kwargs)
    vh._chunk_bytes = chunk * N_ATOMS * 3 * 4
    return vh


def _assert_same_results(port, ref):
    np.testing.assert_array_equal(port.results.times, ref.results.times)
    np.testing.assert_array_equal(port.results.edges, ref.results.edges)
    if ref._self_part:
        np.testing.assert_array_equal(port.results.counts_self,
                                      ref.results.counts_self)
        np.testing.assert_allclose(port.results.gs, ref.results.gs,
                                   rtol=1e-12)
        np.testing.assert_allclose(port.results.msd, ref.results.msd,
                                   rtol=1e-5)
        np.testing.assert_allclose(port.results.alpha2, ref.results.alpha2,
                                   rtol=1e-5)
    else:
        assert port.results.counts_self is None
    if ref._distinct_part:
        np.testing.assert_array_equal(port.results.counts_distinct,
                                      ref.results.counts_distinct)
        np.testing.assert_allclose(port.results.gd, ref.results.gd,
                                   rtol=1e-12)
        assert port.results.counts_distinct.sum() > 0
    else:
        assert port.results.counts_distinct is None


# Chunks of 5 and 4 frames split the ring across chunk boundaries.
@pytest.mark.parametrize("kwargs, chunk", [
    (dict(lags="log"), 5),
    (dict(lags=[0, 2, 5], n_lags=8), 4),
    (dict(lags="log", distinct_part=False), 5),
    (dict(lags=[1, 3], self_part=False), 4),
], ids=["log", "explicit", "self_only", "distinct_only"])
def test_vanhove_matches_jax(trajectory, kwargs, chunk):
    port = _port_vanhove(trajectory, chunk, **kwargs).run()
    ref = _jax_vanhove(trajectory, chunk, **kwargs)
    _assert_same_results(port, ref)


def test_vanhove_resumes_from_jax_carry(trajectory):
    """JAX folds frames 0-5, the port takes its carry over with
    carry_from_numpy and folds frames 6-11 through run_together: the
    results equal the JAX single pass."""

    kwargs = dict(lags="log", n_lags=6)
    head = _jax_vanhove(trajectory, 4, run_kwargs=dict(stop=6), **kwargs)
    carry = jax.tree_util.tree_map(np.asarray, head._carry)
    port = _port_vanhove(trajectory, 4, **kwargs)
    run_together([port], start=6, initial=[carry])
    ref = _jax_vanhove(trajectory, 4, **kwargs)
    _assert_same_results(port, ref)


def test_vanhove_lag0_distinct_equals_self_rdf(trajectory):
    """At lag 0 every unordered pair is seen in both orders with the
    same d^2: the distinct counts equal the self RDF's with exclusion
    (1, 1), summed over the same frames."""

    u = Universe.from_arrays(trajectory[:3], DIMENSIONS)
    vh = VanHoveFunction(u.atoms, n_bins=N_BINS, range=(0.0, R_MAX),
                         lags=[0], self_part=False, verbose=False,
                         device="cpu").run()
    rdf = RadialDistributionFunction(
        u.atoms, n_bins=N_BINS, range=(0.0, R_MAX), exclusion=(1, 1),
        verbose=False, device="cpu",
    ).run()
    np.testing.assert_array_equal(vh.results.counts_distinct[0],
                                  rdf.results.counts)


@pytest.mark.parametrize("spec, n_lags, n_frames", [
    (None, None, 12), (None, 5, 12), ("log", None, 40), ("log", 6, 12),
    ("log", 64, 104), ([0, 3, 7], None, 12), ([2, 4], 9, 12),
])
def test_resolve_lag_values_matches_jax(spec, n_lags, n_frames):
    values, resolved = _resolve_lag_values(spec, n_lags, n_frames)
    ref_values, ref_resolved = jax_resolve_lag_values(spec, n_lags, n_frames)
    np.testing.assert_array_equal(values, ref_values)
    assert resolved == ref_resolved


def test_bench_lag_grid():
    """The bench's Van Hove grid: 64 ring slots, 21 log lags."""

    values, resolved = _resolve_lag_values("log", 64, 104)
    assert resolved == 64
    assert values.tolist() == [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 13, 16,
                               19, 23, 27, 32, 38, 45, 54, 63]


def test_displacement_histogram_matches_jax(trajectory):
    edges = np.linspace(0.0, R_MAX, N_BINS + 1)
    box = np.float32([BOX] * 3)
    pos, past = trajectory[5], trajectory[1:4]
    port = displacement_histogram_frame(
        torch.from_numpy(pos), torch.from_numpy(past), torch.from_numpy(box),
        edges,
    )
    assert port.shape == (3, N_BINS)
    for k in range(3):
        ref = jax_displacement_histogram_frame(
            jnp.asarray(pos), jnp.asarray(past[k]), jnp.asarray(box),
            jnp.asarray(edges), precision="exact",
        )
        np.testing.assert_array_equal(port[k].numpy(),
                                      np.asarray(ref).astype(np.int64))
    dist = _min_image_distance(torch.from_numpy(pos - past[0]),
                               torch.from_numpy(box))
    ref = jax_min_image_distance(jnp.asarray(pos - past[0]),
                                 jnp.asarray(box))
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("kwargs", [
    # Ranges from r_min > 0 are served since the offset bins were ported
    # (tests/test_torch_rdf_options_classes.py); a reversed one is not.
    # Residue and segment groupings are ported
    # (tests/test_torch_groupings.py); an unknown one is refused.
    dict(grouping="molecules"), dict(range=(3.0, 1.0)),
    dict(self_part=False, distinct_part=False),
])
def test_vanhove_rejects_unported(trajectory, kwargs):
    u = Universe.from_arrays(trajectory, DIMENSIONS)
    with pytest.raises((NotImplementedError, ValueError)):
        VanHoveFunction(u.atoms, device="cpu", **kwargs)


def test_vanhove_rejects_triclinic(trajectory):
    """A monoclinic box whose perpendicular widths are under 3 cutoffs
    runs the per-pair triclinic (tri_pp) sweep; its distinct counts (lags
    0 and 1) equal the JAX class's as integers (the fixture's frames,
    read as fractional coordinates of the tilted cell, stay inside it).
    The self part in such a box is checked against the JAX class in
    tests/test_torch_triclinic.py; two frames and no self part keep the
    JAX compile here to one chunk function of two sweeps."""

    dims = np.array([BOX] * 3 + [90.0, 80.0, 90.0])
    h = np.asarray(triclinic_matrices(dims), np.float64)
    n_atoms, n_frames = 300, 2
    traj = ((trajectory[:n_frames, :n_atoms].astype(np.float64) / BOX)
            @ h).astype(np.float32)
    kwargs = dict(n_bins=N_BINS, range=(0.0, R_MAX + 1.0), lags="log",
                  self_part=False, verbose=False)
    u = Universe.from_arrays(traj, dims, dt=0.5)
    vh = VanHoveFunction(u.atoms, device="cpu", **kwargs)
    assert vh._triclinic
    assert cch.plan_is_tri_pp(vh._searched_cell_plan(), True)
    vh._chunk_bytes = n_frames * n_atoms * 3 * 4
    vh.run()
    ju = JaxUniverse.from_arrays(traj.astype(np.float64), dims, dt=0.5)
    ref = JaxVanHove(ju.atoms, **kwargs)
    ref._chunk_bytes = n_frames * n_atoms * 3 * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        ref.run()
    assert len(vh.results.counts_distinct) == 2
    np.testing.assert_array_equal(vh.results.counts_distinct,
                                  ref.results.counts_distinct)
    assert vh.results.counts_distinct.sum() > 0
