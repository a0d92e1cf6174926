"""The port's generalized cell grids -- boxes under 3 cutoffs -- against
the JAX package on the CPU: the deduped neighbour tables, the plan
search over small boxes, the plain versions of the new kernel modes
(generalized half shell, ordered, generalized cross, and the per-pair
27-candidate triclinic ``tri_pp`` mode) against float64 oracles, the
launch arguments those modes pass, and the RDF and Van Hove classes
against the JAX classes in a small cube and a small dodecahedron (the
dodecahedron's self RDF with exclusion None and its Van Hove are in
``tests/test_torch_triclinic.py``).

Counts are compared as integers; ``rdf`` and ``gd`` to ``rtol=1e-12``
(both packages divide the same integer counts by the same float64
normalization, in another order).
"""

import itertools

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
from mdhelper_tpu.ops.pallas_cell_histogram import (  # noqa: E402
    _neighbor_tables_general,
)

from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
    VanHoveFunction,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import _build  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.ops.histogram import _inv3  # noqa: E402
from mdhelper_tpu_torch.testing import (  # noqa: E402
    edge_straddle_cross_positions,
    edge_straddle_positions,
    edge_straddle_triclinic_positions,
    f64_cross_histogram,
    f64_pair_histogram,
    f64_triclinic_pair_histogram,
)

#: a cube of 16 under r_max 6 (2.67 cutoffs; the straddle fixtures'
#: box) and a small xy-square rhombic dodecahedron under r_max 6
#: (perpendicular widths 14.70, 14.70, 12.73: 2.1-2.5 cutoffs).
BOX, R_MAX, N_BINS = 16.0, 6.0, 24
DODECA = np.array([18.0, 18.0, 18.0, 60.0, 60.0, 90.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _h32(dims6):
    return np.asarray(jax_triclinic_matrices(dims6), np.float64).astype(
        np.float32
    )


def _widths(box):
    return cch.triclinic_perpendicular_widths(box).astype(np.float64)


# -- neighbour tables ----------------------------------------------------------

@pytest.mark.parametrize("dims, reach", [
    ((1, 2, 3), (1, 1, 1)), ((4, 1, 2), (1, 1, 1)), ((3, 4, 4), (1, 1, 1)),
    ((1, 3, 5), (2, 2, 2)), ((6, 2, 4), (2, 2, 2)), ((5, 5, 5), (2, 2, 2)),
    ((2, 5, 6), (1, 2, 3)), ((4, 6, 8), (1, 2, 3)), ((7, 3, 1), (3, 1, 2)),
    ((9, 9, 9), (2, 2, 2)),
])
def test_general_tables_match_jax(dims, reach):
    """The deduped full table (home cell in column 0, every distinct
    neighbour once) and the half table (or None) equal the JAX
    package's, row for row, for axes of 1 to 2m + 2 cells."""

    full, half = cch._general_tables(dims, reach)
    ref_full, ref_half = _neighbor_tables_general(dims, reach)
    np.testing.assert_array_equal(full, ref_full)
    assert (half is None) == (ref_half is None)
    if half is not None:
        np.testing.assert_array_equal(half, ref_half)
    assert (full[:, 0] == np.arange(np.prod(dims))).all()
    for row in full:
        assert len(set(row.tolist())) == len(row)


# -- the plan search -----------------------------------------------------------

@pytest.mark.parametrize("cutoffs", [1.0, 1.4, 2.0, 2.5, 2.9])
@pytest.mark.parametrize("n_atoms2", [None, 3000], ids=["self", "cross"])
@pytest.mark.parametrize("shape", ["cube", "brick", "dodeca"])
def test_plan_search_small_boxes(cutoffs, n_atoms2, shape):
    """Boxes of 1 to 2.9 cutoffs get generalized plans with a reach,
    complete sweeps (``_cell_sweep_ok`` on the extents), capacities
    within the ceiling and a plan the kernels can launch."""

    r_max = 5.0
    if shape == "dodeca":
        # scale the dodecahedron so its narrowest width is `cutoffs` r_max
        box = _h32(DODECA) * np.float32(cutoffs * r_max / 12.728)
        extents = _widths(box)
    else:
        scale = np.array([1.0, 1.3, 1.7]) if shape == "brick" else np.ones(3)
        extents = cutoffs * r_max * scale
    plan = cch.cell_plan_search(4000, extents, r_max, n_atoms2=n_atoms2)
    assert cch._generalized(plan["n_cells_dim"], plan["reach"])
    assert plan == {**cch.grid_plan(4000, extents, r_max, plan["n_cells_dim"],
                                    n_atoms2=n_atoms2),
                    "_cost": plan["_cost"]}
    caps = (plan["capacity"], plan.get("capacity2", plan["capacity"]))
    assert max(caps) <= cch._MAX_CAPACITY
    cch._check_launchable(*caps)
    ok = cch._cell_sweep_ok(torch.tensor(extents, dtype=torch.float32)[None],
                            plan["n_cells_dim"], plan["reach"], r_max)
    assert bool(ok.all())


def test_plan_search_capacity_ceiling():
    """A dense small box: the search subdivides instead of planning
    more than the shared-memory ceiling of slots a cell, and a plan the
    kernels cannot launch raises, on the CPU as on the card."""

    plan = cch.cell_plan_search(400_000, [30.0] * 3, 20.0)
    assert plan["capacity"] <= cch._MAX_CAPACITY
    assert plan["n_cells"] > 1
    with pytest.raises(ValueError, match="shared memory"):
        cch.cell_pair_histogram(
            torch.zeros((1, 8, 3)), box=(BOX,) * 3, r_max=R_MAX,
            n_cells_dim=(1, 1, 1), capacity=8192, n_bins=201,
        )


# -- plain versions of the new modes against float64 oracles -------------------

def _fixture(case):
    """(positions, box, plan, oracle) of one straddle case."""

    rng = np.random.default_rng(99)
    if case in ("general", "ordered"):
        pos = edge_straddle_positions(rng, BOX)
        grid = (5, 5, 5) if case == "general" else (1, 2, 6)
        plan = cch.grid_plan(len(pos), (BOX,) * 3, R_MAX, grid)
        return (pos,), (BOX,) * 3, plan, f64_pair_histogram(
            pos, BOX, R_MAX, N_BINS)
    if case == "cross":
        a, b = edge_straddle_cross_positions(rng, BOX)
        plan = cch.grid_plan(len(a), (BOX,) * 3, R_MAX, (2, 5, 6),
                             n_atoms2=len(b))
        return (a, b), (BOX,) * 3, plan, f64_cross_histogram(
            a, b, BOX, R_MAX, N_BINS)
    box = _h32(DODECA)
    pos = edge_straddle_triclinic_positions(rng, box)
    if case == "tri_pp_self":
        plan = cch.grid_plan(len(pos), _widths(box), R_MAX, (2, 5, 6))
        return (pos,), box, plan, f64_triclinic_pair_histogram(
            pos, pos, box, R_MAX, N_BINS, (1, 1))
    plan = cch.grid_plan(300, _widths(box), R_MAX, (2, 5, 6), n_atoms2=90)
    return (pos[:300], pos[300:]), box, plan, f64_triclinic_pair_histogram(
        pos[:300], pos[300:], box, R_MAX, N_BINS)


#: each case's sweep mode and the plain version that runs it.
CASES = {
    "general": ("general", cch.cell_pair_histogram_reference),
    "ordered": ("ordered", cch.cell_pair_histogram_reference),
    "cross": ("general", cch.cross_pair_histogram_reference),
    "tri_pp_self": ("tri_pp", cch.triclinic_cell_pair_histogram_reference),
    "tri_pp_cross": ("tri_pp",
                     cch.triclinic_cross_pair_histogram_reference),
}


def _args(plan, box, cross):
    args = dict(box=box, r_max=R_MAX, n_cells_dim=plan["n_cells_dim"],
                reach=plan["reach"], n_bins=N_BINS)
    if cross:
        return dict(args, capacity1=plan["capacity"],
                    capacity2=plan["capacity2"])
    return dict(args, capacity=plan["capacity"])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_equal_f64_oracle(case):
    """Every new mode's plain version bins the straddle fixture (90
    pairs at the bin edge 1.25 and one float32 ulp either side) like a
    float64 oracle (27-image for tri_pp), as integers."""

    groups, box, plan, oracle = _fixture(case)
    mode, plain = CASES[case]
    cross = len(groups) == 2
    assert cch._sweep_mode(plan["n_cells_dim"], plan["reach"],
                           np.ndim(box) == 2, cross) == mode
    out = plain(*(torch.from_numpy(g) for g in groups),
                **_args(plan, box, cross))
    assert int(out[1].max()) <= plan["capacity"]
    np.testing.assert_array_equal(out[0][0].numpy().astype(np.int64),
                                  oracle)
    assert oracle[5] > 0  # the edge pairs


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_launch_shares_plain_inputs(monkeypatch, case):
    """The arguments each new mode's wrapper passes to its C entry point
    (captured here, with no card): the entry and its signature's count,
    the slot tables, occupancies and neighbour table the plain version
    sweeps, the geometry (box lengths, or the box matrix then its
    float32 inverse, ``(B, 18)``) and the sweep's order flag."""

    groups, box, plan, _ = _fixture(case)
    mode = CASES[case][0]
    cross = len(groups) == 2
    tri = np.ndim(box) == 2
    seen = {}

    def capture(entry, device, *args):
        seen["entry"], seen["args"] = entry, args

    monkeypatch.setattr(cch, "_launch", capture)
    pos = [torch.from_numpy(g) for g in groups]
    args = _args(plan, box, cross)
    common = (args["box"], args["r_max"], args["n_cells_dim"])
    if cross:
        cch._cross_kernel(*pos, *common, args["capacity1"],
                          args["capacity2"], N_BINS, None, tri,
                          reach=plan["reach"])
        box_b, dims, _, _, (t1, o1, _), (t2, o2, _), nbr = cch._cross_inputs(
            *pos, box, plan["n_cells_dim"], plan["capacity"],
            plan["capacity2"], None, tri, plan["reach"], N_BINS)
        tables = [t1, o1, t2, o2, nbr]
    else:
        cch._self_kernel(*pos, *common, args["capacity"], N_BINS, tri,
                         reach=plan["reach"])
        box_b, dims, _, _, (table, occ, _), nbr = cch._self_inputs(
            *pos, box, plan["n_cells_dim"], plan["capacity"], tri,
            plan["reach"], N_BINS)
        tables = [table, occ, nbr]
    entry, got = seen["entry"], seen["args"]
    assert entry == cch._ENTRIES[mode][int(cross)]
    assert len(got) + 1 == len(_build._SIGNATURES[entry])
    n = len(tables)
    for g, want in zip(got[:n], tables):
        torch.testing.assert_close(g, want.to(g.dtype), rtol=0, atol=0)
    full, half = cch._general_tables(dims, plan["reach"])
    want_nbr = half if mode == "general" and not cross else full
    np.testing.assert_array_equal(got[n - 1].numpy(), want_nbr)
    if tri:
        flat = torch.cat((box_b.reshape(-1, 9),
                          _inv3(box_b).reshape(-1, 9)), dim=1)
        torch.testing.assert_close(got[n], flat, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got[n], box_b, rtol=0, atol=0)
        if not cross:
            # the orthorhombic self entry's order flag, after the sizes
            assert got[n + 7] == int(mode == "ordered")


def test_tri_pp_equals_block_sweep_on_a_reach1_grid():
    """On a reach-1 grid of at least 3 cells, forcing the per-pair
    27-image mode gives the per-block translations' counts as integers
    (self, and cross with the (1, 1) exclusion), and forcing a
    generalized orthorhombic reach-2 grid gives the reach-1 counts."""

    rng = np.random.default_rng(12)
    box = _h32(DODECA)
    pos = torch.from_numpy(((0.02 + 0.96 * rng.random((1, 500, 3)))
                            @ box.astype(np.float64)).astype(np.float32))
    grid = dict(r_max=4.0, n_cells_dim=(3, 3, 3), n_bins=32)
    block, _ = cch._self_reference(pos, box, capacity=96, triclinic=True,
                                   **grid)
    per_pair, _ = cch._self_reference(pos, box, capacity=96, triclinic=True,
                                      mode="tri_pp", **grid)
    torch.testing.assert_close(per_pair, block, rtol=0, atol=0)
    assert block.sum() > 0
    other = pos.flip(1)
    cross_block = cch._cross_reference(pos, other, box, capacity1=96,
                                       capacity2=96, exclusion=(1, 1),
                                       triclinic=True, **grid)
    cross_pp = cch._cross_reference(pos, other, box, capacity1=96,
                                    capacity2=96, exclusion=(1, 1),
                                    triclinic=True, mode="tri_pp", **grid)
    torch.testing.assert_close(cross_pp[0], cross_block[0], rtol=0, atol=0)

    cube = torch.from_numpy(
        (rng.random((1, 800, 3)) * 20.0).astype(np.float32))
    reach1 = cch.cell_plan_search(800, [20.0] * 3, 3.0)
    assert reach1["reach"] == (1, 1, 1)
    reach2 = cch.grid_plan(800, [20.0] * 3, 3.0, (9, 9, 9))
    assert reach2["reach"] == (2, 2, 2)
    counts = [cch.cell_pair_histogram_reference(
        cube, box=(20.0,) * 3, r_max=3.0, n_cells_dim=p["n_cells_dim"],
        reach=p["reach"], capacity=p["capacity"], n_bins=32)[0]
        for p in (reach1, reach2)]
    torch.testing.assert_close(counts[0], counts[1], rtol=0, atol=0)


@pytest.mark.parametrize("case", ["general", "ordered", "cross",
                                  "tri_pp_self"])
def test_swept_pairs_counts_table_cell_pairs(case):
    """swept_pairs counts the occupied slot pairs a generalized sweep
    bins: from a NumPy count over all atom pairs of whether the second
    atom's cell is in the first one's neighbour row (the home cell's
    strict triangle in a half-shell sweep, its off-diagonal pairs in an
    ordered one)."""

    groups, box, plan, _ = _fixture(case)
    dims, reach = plan["n_cells_dim"], plan["reach"]
    tri = np.ndim(box) == 2
    mode = cch._sweep_mode(dims, reach, tri, len(groups) == 2)
    full, half = cch._general_tables(dims, reach)
    rows = half if mode == "general" and len(groups) == 1 else full
    listed = np.zeros((np.prod(dims),) * 2, dtype=bool)
    listed[np.arange(len(rows))[:, None], rows] = True

    def cells(p):
        t = torch.from_numpy(p)[None]
        if tri:
            _, xyz = cch._triclinic_wrap_cells(t, torch.from_numpy(box)[None],
                                               dims)
            xyz = xyz[0].numpy()
        else:
            xyz = (p / (np.float32(BOX) / np.float32(dims))).astype(int)
        return (xyz[:, 0] * dims[1] + xyz[:, 1]) * dims[2] + xyz[:, 2]

    c1 = cells(groups[0])
    c2 = cells(groups[-1])
    pairs = listed[c1[:, None], c2[None, :]]
    if len(groups) == 1:
        same = c1[:, None] == c1[None, :]
        off_diagonal = ~np.eye(len(c1), dtype=bool)
        if mode == "general":
            want = (pairs & ~same).sum() + np.triu(same, 1).sum()
        else:
            want = (pairs & off_diagonal).sum()
    else:
        want = pairs.sum()
    got = cch.swept_pairs(*(torch.from_numpy(g) for g in groups), box=box,
                          n_cells_dim=dims, triclinic=tri, reach=reach)
    assert got == int(want)


# -- the analyses against the JAX classes in a small cube ----------------------

CUBE, CUBE_R = 12.0, 5.0  # 2.4 cutoffs
N_ATOMS, N_FRAMES = 300, 4


@pytest.fixture(scope="module")
def cube_trajectory():
    """A random walk wrapped into the cube, float32 (steps well under
    half a box)."""

    rng = np.random.default_rng(2030)
    walk = rng.random((N_ATOMS, 3)) * CUBE + np.cumsum(
        rng.normal(0.0, 0.3, (N_FRAMES, N_ATOMS, 3)), axis=0
    )
    traj = np.mod(walk, CUBE).astype(np.float32)
    return np.where(traj >= np.float32(CUBE), np.float32(0.0), traj)


def _jax_run(analysis):
    analysis._chunk_bytes = N_FRAMES * N_ATOMS * 3 * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        analysis.run()
    return analysis


@pytest.mark.parametrize("kind, exclusion", [
    ("self", None), ("self", (1, 1)), ("cross", None), ("cross", (2, 1)),
], ids=["self", "self_11", "cross", "cross_21"])
def test_small_cube_rdf_matches_jax(cube_trajectory, kind, exclusion):
    dims = np.array([CUBE] * 3 + [90.0] * 3)
    u = Universe.from_arrays(cube_trajectory, dims)
    ju = JaxUniverse.from_arrays(cube_trajectory.astype(np.float64), dims)
    groups = (lambda uu: (uu.atoms,)) if kind == "self" else (
        lambda uu: (uu.atoms[0::2], uu.atoms[1::2])
    )
    kwargs = dict(n_bins=N_BINS, range=(0.0, CUBE_R), exclusion=exclusion,
                  verbose=False)
    rdf = RadialDistributionFunction(*groups(u), device="cpu", **kwargs)
    rdf._chunk_bytes = 2 * N_ATOMS * 3 * 4
    run_together([rdf])
    plan = rdf._searched_cell_plan()
    assert cch._generalized(plan["n_cells_dim"], plan["reach"])
    ref = _jax_run(JaxRDF(*groups(ju), **kwargs))
    assert rdf.results.counts.sum() > 0
    np.testing.assert_array_equal(rdf.results.counts, ref.results.counts)
    np.testing.assert_allclose(rdf.results.rdf, ref.results.rdf,
                               rtol=1e-12)


def test_small_cube_vanhove_matches_jax(cube_trajectory):
    dims = np.array([CUBE] * 3 + [90.0] * 3)
    u = Universe.from_arrays(cube_trajectory, dims, dt=0.5)
    ju = JaxUniverse.from_arrays(cube_trajectory.astype(np.float64), dims,
                                 dt=0.5)
    kwargs = dict(n_bins=N_BINS, range=(0.0, CUBE_R), lags="log",
                  verbose=False)
    vh = VanHoveFunction(u.atoms, device="cpu", **kwargs)
    vh._chunk_bytes = 2 * N_ATOMS * 3 * 4
    vh.run()
    ref = _jax_run(JaxVanHove(ju.atoms, **kwargs))
    np.testing.assert_array_equal(vh.results.counts_self,
                                  ref.results.counts_self)
    np.testing.assert_array_equal(vh.results.counts_distinct,
                                  ref.results.counts_distinct)
    assert vh.results.counts_distinct[-1].sum() > 0
    np.testing.assert_allclose(vh.results.gd, ref.results.gd, rtol=1e-12)
    # Both sum r^2 in float32, in different orders.
    np.testing.assert_allclose(vh.results.msd, ref.results.msd, rtol=1e-5)


@pytest.mark.parametrize("kind, exclusion", [
    ("self", (1, 1)), ("cross", None), ("cross", (2, 1)),
], ids=["self_11", "cross", "cross_21"])
def test_small_dodecahedron_rdf_matches_jax(kind, exclusion):
    """The RDF in the small dodecahedron under r_max 6 (tri_pp; the
    self RDF with exclusion None and the Van Hove there are in
    tests/test_torch_triclinic.py).  One chunk: each JAX chunk shape
    costs an XLA compile of the 27-image sweep."""

    rng = np.random.default_rng(2031)
    h64 = np.asarray(jax_triclinic_matrices(DODECA), np.float64)
    traj = (rng.random((3, N_ATOMS, 3)) @ h64).astype(np.float32)
    u = Universe.from_arrays(traj, DODECA)
    ju = JaxUniverse.from_arrays(traj.astype(np.float64), DODECA)
    groups = (lambda uu: (uu.atoms,)) if kind == "self" else (
        lambda uu: (uu.atoms[0::2], uu.atoms[1::2])
    )
    kwargs = dict(n_bins=N_BINS, range=(0.0, R_MAX), exclusion=exclusion,
                  verbose=False)
    rdf = RadialDistributionFunction(*groups(u), device="cpu", **kwargs)
    rdf.run()
    assert cch.plan_is_tri_pp(rdf._searched_cell_plan(), True)
    ref = _jax_run(JaxRDF(*groups(ju), **kwargs))
    assert rdf.results.counts.sum() > 0
    np.testing.assert_array_equal(rdf.results.counts, ref.results.counts)
    np.testing.assert_allclose(rdf.results.rdf, ref.results.rdf,
                               rtol=1e-12)


def test_tables_have_one_entry_per_cell_pair():
    """Every ordered cell pair within reach appears once in the full
    table and every unordered one once in the half table (the property
    that makes ordered counts single and half-shell counts doubled)."""

    for dims, reach in itertools.product(
        [(5, 5, 5), (2, 5, 6), (7, 3, 1)], [(2, 2, 2), (1, 2, 3)]
    ):
        full, half = cch._general_tables(dims, reach)
        n = int(np.prod(dims))
        pairs = np.stack([np.repeat(np.arange(n), full.shape[1]),
                          full.reshape(-1)], axis=1)
        assert len(np.unique(pairs, axis=0)) == len(pairs)
        if half is not None:
            lo = np.minimum(np.repeat(np.arange(n), half.shape[1]),
                            half.reshape(-1))
            hi = np.maximum(np.repeat(np.arange(n), half.shape[1]),
                            half.reshape(-1))
            unordered = np.stack([lo, hi], axis=1)
            assert len(np.unique(unordered, axis=0)) == len(unordered)
            # with the home cell counted once, the half table covers
            # the full table's pairs
            assert 2 * (half.shape[1] - 1) + 1 == full.shape[1]
