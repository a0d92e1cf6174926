"""The port's cross cell-list pair histogram and cross RDF
(:mod:`mdhelper_tpu_torch.ops.cuda_cell_histogram`,
:class:`mdhelper_tpu_torch.analysis.structure.RadialDistributionFunction`
over two groups) against the JAX package: its Pallas cross kernel in
interpret mode, its exact XLA sweep, its RDF class and a float64 NumPy
oracle.  Counts are compared as integers."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis.multi import run_together as jax_run_together  # noqa: E402
from mdhelper_tpu.analysis.structure import (  # noqa: E402
    RadialDistributionFunction as JaxRDF,
)
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu.ops.histogram import (  # noqa: E402
    radial_histogram_frame as jax_radial_histogram_frame,
)
from mdhelper_tpu.ops.pallas_cell_histogram import (  # noqa: E402
    _neighbor_tables,
    _use_stream_blocks,
    cross_pair_histogram_pallas,
    pallas_cell_plan_search,
)

from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.testing import (  # noqa: E402
    edge_straddle_cross_positions,
    f64_cross_histogram,
)

# The size of tests/test_pallas.py's cross-kernel cases.
N1, N2, R_MAX, N_BINS = 600, 900, 3.5, 96
# Per-frame boxes: two valid frames, then one whose z extent is too
# small for 4 cells of r_max (NaN-poisoned on the (3, 3, 4) grid).
# Small grids keep the interpret-mode Pallas runs short; the Pallas
# kernel needs 128-lane capacities, the port's plain version is faster
# on its own 32-slot granule.
BOXES = np.array([[16.0, 16.0, 16.0], [15.0, 16.0, 15.5],
                  [16.0, 16.0, 13.0]])
DIMS, CAPACITY, PALLAS_CAPACITY = (3, 3, 4), 64, 128
EXCLUSIONS = (None, (1, 1), (2, 3))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frames():
    """Two groups of uniform float32 atoms, each frame wrapped into its
    own box."""

    rng = np.random.default_rng(303)
    p1 = (rng.random((3, N1, 3)) * BOXES[:, None]).astype(np.float32)
    p2 = (rng.random((3, N2, 3)) * BOXES[:, None]).astype(np.float32)
    return p1, p2


@pytest.fixture(scope="module")
def port_counts(frames):
    """The port's counts of all three frames, for each exclusion."""

    p1, p2 = frames
    out = {}
    for exclusion in EXCLUSIONS:
        counts, m1, m2 = cch.cross_pair_histogram(
            torch.from_numpy(p1), torch.from_numpy(p2),
            box=torch.from_numpy(BOXES), r_max=R_MAX, n_cells_dim=DIMS,
            capacity1=CAPACITY, capacity2=CAPACITY, n_bins=N_BINS,
            exclusion=exclusion,
        )
        assert int(m1.max()) <= CAPACITY and int(m2.max()) <= CAPACITY
        out[exclusion] = counts.numpy()
    return out


# Each case runs the Pallas kernel on one frame (interpret mode is
# slow), on the smallest grid that frame allows.
@pytest.mark.parametrize("exclusion, pallas_frame, pallas_dims", [
    (None, 0, (3, 3, 3)), ((1, 1), 1, (3, 3, 3)), ((2, 3), 2, DIMS),
])
def test_cross_reference_equals_pallas_and_xla(frames, port_counts,
                                               exclusion, pallas_frame,
                                               pallas_dims):
    p1, p2 = frames
    port = port_counts[exclusion]
    assert np.isnan(port[2]).all()
    edges = jnp.asarray(np.linspace(0.0, R_MAX, N_BINS + 1))
    for f in range(2):
        xla = jax_radial_histogram_frame(
            jnp.asarray(p1[f]), jnp.asarray(p2[f]), jnp.asarray(BOXES[f]),
            edges, exclusion=exclusion, precision="exact",
        )
        np.testing.assert_array_equal(
            port[f].astype(np.int64), np.asarray(xla).astype(np.int64)
        )
        assert port[f].sum() > 0
    f = pallas_frame
    pallas, _, _ = cross_pair_histogram_pallas(
        jnp.asarray(p1[f]), jnp.asarray(p2[f]), box=tuple(BOXES[f]),
        r_max=R_MAX, n_cells_dim=pallas_dims, capacity1=PALLAS_CAPACITY,
        capacity2=PALLAS_CAPACITY, n_bins=N_BINS, precision="exact",
        exclusion=exclusion,
    )
    np.testing.assert_array_equal(port[f], np.asarray(pallas))


@pytest.mark.parametrize("exclusion", [None, (2, 3)])
def test_cross_reference_equals_f64_oracle(frames, port_counts, exclusion):
    p1, p2 = frames
    np.testing.assert_array_equal(
        port_counts[exclusion][0].astype(np.int64),
        f64_cross_histogram(p1[0], p2[0], 16.0, R_MAX, N_BINS, exclusion),
    )


def test_cross_straddle_fixture():
    """The 90 bin-edge pairs of the straddle fixture, as cross pairs."""

    box, r_max, n_bins = 16.0, 4.0, 16
    a, b = edge_straddle_cross_positions(np.random.default_rng(99), box)
    plan = cch.cell_plan_search(len(a), [box] * 3, r_max, n_atoms2=len(b))
    counts, _, _ = cch.cross_pair_histogram(
        torch.from_numpy(a), torch.from_numpy(b), box=(box,) * 3,
        r_max=r_max, n_cells_dim=plan["n_cells_dim"],
        capacity1=plan["capacity"], capacity2=plan["capacity2"],
        n_bins=n_bins,
    )
    np.testing.assert_array_equal(
        counts[0].numpy().astype(np.int64),
        f64_cross_histogram(a, b, box, r_max, n_bins),
    )


def test_cross_plan_search():
    """The cross plan minimizes n_cells * 27 * cap1 * cap2 over the
    legal grids, and its capacities follow each group's size."""

    box = [16.0, 16.0, 14.0]
    plan = cch.cell_plan_search(N1, box, R_MAX, n_atoms2=N2)
    assert plan["_cost"] == (
        plan["n_cells"] * cch.N_FULL * plan["capacity"] * plan["capacity2"]
    )
    costs = []
    for nx in range(3, 5):
        for ny in range(3, 5):
            for nz in range(3, 5):
                n = nx * ny * nz
                costs.append(
                    n * 27 * cch._capacity(N1, n, 4.0)
                    * cch._capacity(N2, n, 4.0)
                )
    assert plan["_cost"] == min(costs)
    assert plan["capacity2"] == cch._capacity(N2, plan["n_cells"], 4.0)
    assert "capacity2" not in cch.cell_plan_search(N1, box, R_MAX)


@pytest.mark.parametrize("dims", [(3, 3, 3), (3, 4, 5)])
def test_full_table_matches_jax(dims):
    port = cch._full_table(dims)
    jax_full = np.asarray(_neighbor_tables(dims)[0])
    np.testing.assert_array_equal(port, jax_full)
    assert all(len(set(row)) == 27 for row in port)


def test_slot_table_exclusion_ids():
    rng = np.random.default_rng(5)
    pos = torch.from_numpy((rng.random((1, 50, 3)) * 9.0).astype(np.float32))
    table, _, _ = cch._slot_table(pos, (3, 3, 3), 32,
                                  torch.full((1, 3), 3.0), ex=3)
    plain, _, _ = cch._slot_table(pos, (3, 3, 3), 32,
                                  torch.full((1, 3), 3.0))
    torch.testing.assert_close(table[..., 3], torch.floor(plain[..., 3] / 3))
    torch.testing.assert_close(table[..., :3], plain[..., :3])


def test_stream_claim_at_400k():
    """At 400k atoms (density 0.8, r_max 6) the JAX package sends both
    the self and the 50/50 cross sweep to its streaming kernels."""

    n = 400_000
    box = np.array([(n / 0.8) ** (1 / 3)] * 3)
    for plan in (
        pallas_cell_plan_search(n, box, 6.0),
        pallas_cell_plan_search(n // 2, box, 6.0, n_atoms2=n // 2),
    ):
        assert _use_stream_blocks(plan["_tables_bytes"])


def test_cross_wrapper_rejects_bad_inputs():
    pos = torch.zeros((1, 8, 3))
    args = dict(box=(9.0,) * 3, r_max=3.0, n_cells_dim=(3, 3, 3),
                capacity1=32, capacity2=32, n_bins=8)
    with pytest.raises(ValueError):
        cch.cross_pair_histogram(pos.to("meta"), pos.to("meta"), **args)
    with pytest.raises(ValueError):
        cch.cross_pair_histogram(pos, torch.zeros((2, 8, 3)), **args)
    with pytest.raises(ValueError):
        cch.cross_pair_histogram(pos, pos, exclusion=(0, 1), **args)


# -- the cross RDF ---------------------------------------------------------

N_ATOMS, N_FRAMES, CHUNK = 1200, 6, 4
RDF_BOX, RDF_BINS = 14.0, 40


@pytest.fixture(scope="module")
def trajectory():
    rng = np.random.default_rng(2027)
    return (rng.random((N_FRAMES, N_ATOMS, 3)) * RDF_BOX).astype(np.float32)


def _jax_rdf(trajectory, exclusion):
    u = JaxUniverse.from_arrays(
        trajectory.astype(np.float64),
        np.array([RDF_BOX] * 3 + [90.0] * 3), dt=1.0,
    )
    rdf = JaxRDF(u.atoms[0::2], u.atoms[1::2], n_bins=RDF_BINS,
                 range=(0.0, 3.0), exclusion=exclusion, verbose=False)
    rdf._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        jax_run_together([rdf])
    return rdf


@pytest.mark.parametrize("exclusion, entry", [
    (None, "run"), ((2, 3), "run_together"),
])
def test_cross_rdf_matches_jax(trajectory, exclusion, entry):
    u = Universe.from_arrays(
        trajectory, np.array([RDF_BOX] * 3 + [90.0] * 3), dt=1.0
    )
    rdf = RadialDistributionFunction(
        u.atoms[0::2], u.atoms[1::2], n_bins=RDF_BINS, range=(0.0, 3.0),
        exclusion=exclusion, verbose=False, device="cpu",
    )
    rdf._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    if entry == "run":
        rdf.run()
    else:
        run_together([rdf])
    ref = _jax_rdf(trajectory, exclusion)
    assert rdf.results.counts.sum() > 0
    np.testing.assert_array_equal(rdf.results.counts, ref.results.counts)
    np.testing.assert_allclose(rdf.results.rdf, ref.results.rdf,
                               rtol=1e-12)


def test_cross_rdf_rejects_overlapping_groups(trajectory):
    """Overlapping groups were once refused (hence the name); the cross
    kernel's contract covers them, so they are served, and their counts
    (the five shared atoms each meeting itself in bin 0) equal the JAX
    class's."""

    box = np.array([RDF_BOX] * 3 + [90.0] * 3)
    u = Universe.from_arrays(trajectory, box, dt=1.0)
    rdf = RadialDistributionFunction(u.atoms[:10], u.atoms[5:20],
                                     n_bins=RDF_BINS, range=(0.0, 3.0),
                                     verbose=False, device="cpu")
    rdf.run()
    ju = JaxUniverse.from_arrays(trajectory.astype(np.float64), box, dt=1.0)
    ref = JaxRDF(ju.atoms[:10], ju.atoms[5:20], n_bins=RDF_BINS,
                 range=(0.0, 3.0), verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        ref.run()
    assert rdf.results.counts[0] >= 5 * N_FRAMES
    np.testing.assert_array_equal(rdf.results.counts, ref.results.counts)


@pytest.mark.parametrize("item", [
    slice(0, None, 2), slice(3, 17, 5), np.array([5, 1, 9]), 7,
    "mask",
])
def test_atom_group_indexing_matches_jax(trajectory, item):
    u = Universe.from_arrays(trajectory, np.array([RDF_BOX] * 3))
    ju = JaxUniverse.from_arrays(trajectory.astype(np.float64),
                                 np.array([RDF_BOX] * 3))
    if isinstance(item, str):
        item = np.arange(N_ATOMS) % 3 == 1
    group = u.atoms[item]
    np.testing.assert_array_equal(group.ix, ju.atoms[item].ix)
    assert len(group) == group.n_atoms
