"""The remaining modes of the port's cell-list kernels -- bins from
``r_min > 0`` (the "offset" constants), 2-D grids over two kept axes
(``drop_axis``), the self sweep's ``(e, e)`` and asymmetric ``(e0, e1)``
tile exclusions and fast float32 binning -- against the JAX package on
the CPU: the plain versions against its Pallas kernels in interpret mode
at tiny shapes, and against float64 oracles on bin-edge straddle fixtures
built for an offset grid, a closed last edge and a 2-D grid; the 2-D
tables and plans, the launch arguments of the new modes, and the 2-D
distance against the XLA route's zeroed-coordinate sum.

Counts are compared as integers, fast ones too: both sides bin the same
float32 values in the same order.  The analyses that reach these modes
are held against the JAX classes in
``tests/test_torch_rdf_options_classes.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.algorithm.topology import (  # noqa: E402
    triclinic_matrices as jax_triclinic_matrices,
)
from mdhelper_tpu.ops.histogram import (  # noqa: E402
    _exact_d2_orthorhombic as jax_exact_d2_orthorhombic,
)
from mdhelper_tpu.ops.pallas_cell_histogram import (  # noqa: E402
    _bin_boundary_constants as jax_bin_boundary_constants,
    _neighbor_tables_general,
    cell_pair_histogram_pallas,
    cross_pair_histogram_pallas,
)

from mdhelper_tpu_torch.ops import _build  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.ops.histogram import (  # noqa: E402
    _exact_d2_orthorhombic,
)
from mdhelper_tpu_torch.testing import (  # noqa: E402
    edge_straddle_positions,
    edge_straddle_triclinic_positions,
    f64_histogram,
    f64_triclinic_distances,
)

#: a cube of 12 under r_max 3.5 (reach-1 (3, 3, 3) grid) and 5.0 (an
#: ordered (1, 2, 3) grid); a 16 x 16 x 4 slab gridded over x and y; a
#: small xy-square rhombic dodecahedron (widths 14.70, 14.70, 12.73)
#: under r_max 4 (per-block (3, 3, 3), tri_pp (1, 2, 4)).
CUBE, SLAB = 12.0, (16.0, 16.0, 4.0)
DODECA = np.array([18.0, 18.0, 18.0, 60.0, 60.0, 90.0])
N_ATOMS, N_BINS = 300, 24
#: the Pallas kernels' 128-lane capacity; the port's 32-slot granule.
PALLAS_CAP, CAP = 128, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _h32():
    return np.asarray(jax_triclinic_matrices(DODECA), np.float64).astype(
        np.float32)


def _widths(box):
    return cch.triclinic_perpendicular_widths(box).astype(np.float64)


def _inputs(geometry, n=N_ATOMS, seed=11):
    """float32 positions ``(n, 3)`` inside the geometry's box, and the
    box as the kernels take it."""

    rng = np.random.default_rng(seed)
    if geometry == "tri":
        h = _h32()
        frac = 0.02 + 0.96 * rng.random((n, 3))
        return (frac @ h.astype(np.float64)).astype(np.float32), h
    lengths = np.float32(SLAB if geometry == "slab" else (CUBE,) * 3)
    return (rng.random((n, 3)) * lengths).astype(np.float32), lengths


#: (geometry, grid, r_max, r_min, exclusion, precision, cross) of each
#: case held against the Pallas kernels in interpret mode.
PALLAS_CASES = {
    "tiles_33_half": ("cube", (3, 3, 3), 3.5, 0.0, (3, 3), "exact", False),
    "asym_23_half": ("cube", (3, 3, 3), 3.5, 0.0, (2, 3), "exact", False),
    "asym_32_ordered": ("cube", (1, 2, 3), 5.0, 0.0, (3, 2), "exact",
                        False),
    "offset_self": ("cube", (3, 3, 3), 3.5, 1.2, None, "exact", False),
    "offset_cross_23": ("cube", (3, 3, 3), 3.5, 1.2, (2, 3), "exact",
                        True),
    "axes2_self_asym": ("slab", (4, 4), 3.5, 0.0, (2, 3), "exact", False),
    "axes2_cross_offset": ("slab", (4, 4), 3.5, 0.7, None, "exact", True),
    "fast_self_offset": ("cube", (3, 3, 3), 3.5, 1.2, (3, 3), "fast",
                         False),
    "fast_cross": ("cube", (1, 2, 3), 5.0, 0.0, None, "fast", True),
    "tri_block_tiles_33": ("tri", (3, 3, 3), 4.0, 0.0, (3, 3), "exact",
                           False),
    "tri_block_fast_cross": ("tri", (3, 3, 3), 4.0, 0.5, None, "fast",
                             True),
    "tri_pp_fast_asym": ("tri", (1, 2, 4), 4.0, 0.0, (2, 3), "fast",
                         False),
}


def _port_and_pallas(case):
    """The plain version's and the Pallas kernel's counts of a case."""

    geometry, grid, r_max, r_min, ex, precision, cross = PALLAS_CASES[case]
    pos, box = _inputs(geometry)
    tri = geometry == "tri"
    extents = (_widths(box) if tri
               else np.asarray(box, np.float64)[:len(grid)])
    axes = (0, 1) if len(grid) == 2 else (0, 1, 2)
    plan = cch.grid_plan(N_ATOMS // 2 if cross else N_ATOMS, extents, r_max,
                         grid)
    common = dict(r_max=r_max, r_min=r_min, n_cells_dim=grid,
                  reach=plan["reach"], n_bins=N_BINS, precision=precision)
    port_box = torch.from_numpy(np.asarray(box))
    jax_box = jnp.asarray(box)
    port_axes = {} if tri else dict(axes=axes)
    if cross:
        a, b = pos[:N_ATOMS // 2], pos[N_ATOMS // 2:]
        plain = (cch.triclinic_cross_pair_histogram_reference if tri
                 else cch.cross_pair_histogram_reference)
        port = plain(torch.from_numpy(a), torch.from_numpy(b),
                     box=port_box, capacity1=CAP, capacity2=CAP,
                     exclusion=ex, **port_axes, **common)
        ref = cross_pair_histogram_pallas(
            jnp.asarray(a), jnp.asarray(b), box=jax_box, capacity1=PALLAS_CAP,
            capacity2=PALLAS_CAP, exclusion=ex, axes=axes, **common)
    else:
        plain = (cch.triclinic_cell_pair_histogram_reference if tri
                 else cch.cell_pair_histogram_reference)
        port = plain(torch.from_numpy(pos), box=port_box, capacity=CAP,
                     exclusion=ex, **port_axes, **common)
        ref = cell_pair_histogram_pallas(
            jnp.asarray(pos), box=jax_box, capacity=PALLAS_CAP,
            exclusion=(1, 1) if ex is None else ex, axes=axes, **common)
    assert int(port[1].max()) <= CAP
    return port[0][0].numpy(), np.asarray(ref[0])


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_versions_match_pallas_interpret(case):
    """Every new mode's plain version gives the JAX package's Pallas
    counts (interpret mode) on the same grid, reach and float32 inputs:
    symmetric and asymmetric self tiles on the half shell and the ordered
    sweep, bins from r_min, 2-D grids, fast binning, and the triclinic
    per-block and tri_pp sweeps."""

    port, ref = _port_and_pallas(case)
    assert ref.sum() > 0
    np.testing.assert_array_equal(port.astype(np.int64),
                                  ref.astype(np.int64))


# -- straddle fixtures against float64 oracles --------------------------------

def _straddle(geometry, rng):
    """The bin-edge fixture (90 pairs at 1.25 and one float32 ulp either
    side along x); in the slab its dropped z coordinates are redrawn, so
    only the in-plane distance stays on the edge."""

    if geometry == "tri":
        return edge_straddle_triclinic_positions(rng, _h32()), _h32()
    pos = edge_straddle_positions(rng, 16.0)
    lengths = np.float32((16.0,) * 3)
    if geometry == "slab":
        lengths = np.float32(SLAB)
        pos[:, 2] = (rng.random(len(pos)) * lengths[2]).astype(np.float32)
    return pos, lengths


#: (geometry, grid, (r_min, r_max, n_bins), exclusion, cross): offset
#: grids whose first edge (1.25, 6) or closed last edge (0.5, 1.25) is
#: the fixture's, 2-D grids whose in-plane edge it is, and the tiles.
STRADDLE_CASES = {
    "offset_first_edge": ("cube", (3, 3, 3), (1.25, 6.0, 19), None, False),
    "offset_last_edge": ("cube", (5, 5, 5), (0.5, 1.25, 12), None, False),
    "offset_ordered_asym": ("cube", (1, 2, 6), (1.25, 6.0, 19), (2, 3),
                            False),
    "offset_cross": ("cube", (2, 5, 6), (0.5, 1.25, 12), (2, 3), True),
    "axes2_self": ("slab", (4, 4), (0.0, 4.0, 16), None, False),
    "axes2_self_tiles": ("slab", (4, 4), (0.0, 4.0, 16), (3, 3), False),
    "axes2_ordered_offset": ("slab", (2, 9), (1.25, 6.0, 19), None, False),
    "axes2_cross_last_edge": ("slab", (5, 5), (0.5, 1.25, 12), None, True),
    "tri_block_offset_asym": ("tri", (3, 3, 3), (1.25, 4.0, 11), (2, 3),
                              False),
    "tri_pp_last_edge": ("tri", (1, 2, 4), (0.5, 1.25, 12), (3, 3), False),
}


@pytest.mark.parametrize("case", list(STRADDLE_CASES))
def test_straddle_fixtures_equal_f64_oracle(case):
    """The plain versions bin the straddle pairs like a float64 oracle on
    float64 edges: a pair at exactly r_min is in bin 0 and one ulp below
    is out; a pair at exactly r_max (the closed last edge) is in the last
    bin; a 2-D grid's pairs bin by their in-plane distance; an
    asymmetric tile keeps the identical pairs with i // e0 != i // e1 at
    distance 0, out of an offset range."""

    geometry, grid, (r_min, r_max, n_bins), ex, cross = STRADDLE_CASES[case]
    pos, box = _straddle(geometry, np.random.default_rng(99))
    tri = geometry == "tri"
    axes = (0, 1) if len(grid) == 2 else (0, 1, 2)
    edges = np.linspace(r_min, r_max, n_bins + 1)
    groups = (pos[:300], pos[300:]) if cross else (pos,)
    extents = _widths(box) if tri else np.asarray(box, float)[list(axes)]
    plan = cch.grid_plan(len(groups[0]), extents, r_max, grid,
                         n_atoms2=len(groups[-1]) if cross else None)
    args = dict(box=torch.from_numpy(np.asarray(box)), r_max=r_max,
                r_min=r_min, n_cells_dim=grid, reach=plan["reach"],
                n_bins=n_bins, exclusion=ex)
    if not tri:
        args["axes"] = axes
    tensors = [torch.from_numpy(g) for g in groups]
    if cross:
        plain = (cch.triclinic_cross_pair_histogram_reference if tri
                 else cch.cross_pair_histogram_reference)
        out = plain(*tensors, capacity1=plan["capacity"],
                    capacity2=plan["capacity2"], **args)
    else:
        plain = (cch.triclinic_cell_pair_histogram_reference if tri
                 else cch.cell_pair_histogram_reference)
        out = plain(*tensors, capacity=plan["capacity"], **args)
    mask = ex if cross else (1, 1) if ex is None else ex
    if tri:
        dist = f64_triclinic_distances(groups[0][:, None], groups[-1][None],
                                       box)
        if mask is not None:
            i = np.arange(len(groups[0]))[:, None]
            j = np.arange(len(groups[-1]))[None, :]
            dist[i // mask[0] == j // mask[1]] = np.inf
        oracle = np.histogram(dist, bins=edges)[0]
    else:
        oracle = f64_histogram(groups[0], groups[-1], box, edges, axes=axes,
                               exclusion=mask)
    assert int(out[1].max()) <= plan["capacity"]
    np.testing.assert_array_equal(out[0][0].numpy().astype(np.int64), oracle)
    assert oracle.sum() > 0


# -- 2-D grids: tables, plans, distances --------------------------------------

@pytest.mark.parametrize("dims, reach", [
    ((3, 3), (1, 1)), ((4, 6), (1, 1)), ((1, 5), (1, 2)), ((2, 7), (2, 3)),
    ((6, 6), (2, 2)), ((9, 4), (3, 1)),
])
def test_two_d_tables_match_jax(dims, reach):
    """A 2-D grid runs as (n0, n1, 1) of reach (m0, m1, 0): its deduped
    full and half tables are the JAX package's 2-D tables, entry for
    entry, and its sweep mode is the half shell or, without a half
    table, the ordered sweep."""

    dims3, reach3, order = cch._grid3(dims, reach, axes=(0, 2))
    assert dims3 == (*dims, 1) and reach3 == (*reach, 0)
    assert order == (0, 2, 1)
    full, half = cch._general_tables(dims3, reach3)
    ref_full, ref_half = _neighbor_tables_general(dims, reach)
    np.testing.assert_array_equal(full, ref_full)
    assert (half is None) == (ref_half is None)
    if half is not None:
        np.testing.assert_array_equal(half, ref_half)
    mode = cch._sweep_mode(dims3, reach3, False, cross=False)
    assert mode == ("general" if half is not None else "ordered")


@pytest.mark.parametrize("extents, reach1", [
    ((100.0, 100.0), True), ((20.0, 30.0), False), ((16.0, 48.0), False),
])
@pytest.mark.parametrize("n_atoms2", [None, 4000], ids=["self", "cross"])
def test_two_d_plan_search(extents, reach1, n_atoms2):
    """Two extents plan a 2-D grid: reach 1 where both axes hold 3
    cutoffs (15 A), else a generalized grid; the plan equals grid_plan's
    for its grid, its capacities stay within the ceiling, the kernels
    can launch it and its sweep covers r_max."""

    r_max = 15.0
    plan = cch.cell_plan_search(8000, extents, r_max, n_atoms2=n_atoms2)
    assert len(plan["n_cells_dim"]) == len(plan["reach"]) == 2
    assert (plan["reach"] == (1, 1)) == reach1
    assert plan == {**cch.grid_plan(8000, extents, r_max, plan["n_cells_dim"],
                                    n_atoms2=n_atoms2),
                    "_cost": plan["_cost"]}
    caps = (plan["capacity"], plan.get("capacity2", plan["capacity"]))
    assert max(caps) <= cch._MAX_CAPACITY
    cch._check_launchable(*caps)
    dims3, reach3, _ = cch._grid3(plan["n_cells_dim"], plan["reach"],
                                  axes=(0, 1))
    ok = cch._cell_sweep_ok(
        torch.tensor([*extents, 1.0], dtype=torch.float32)[None], dims3,
        reach3, r_max)
    assert bool(ok.all())


def test_two_d_distance_equals_zeroed_coordinate_sum():
    """On the 2-D straddle fixture the kernels' d^2 -- one df_add of the
    two kept components -- equals, bit for bit in both halves, the JAX
    XLA route's three-component sum of positions whose dropped
    coordinate is zeroed (in a box whose dropped length is the largest),
    for both orders of the kept axes."""

    pos, lengths = _straddle("slab", np.random.default_rng(5))
    a, c = pos[:, None], pos[None]
    for drop in range(3):
        keep = [k for k in range(3) if k != drop]
        port = _exact_d2_orthorhombic(
            torch.from_numpy(a[..., keep + [drop]]),
            torch.from_numpy(c[..., keep + [drop]]),
            torch.from_numpy(lengths[keep + [drop]]), n_axes=2)
        zeroed_a, zeroed_c = a.copy(), c.copy()
        zeroed_a[..., drop] = 0.0
        zeroed_c[..., drop] = 0.0
        box = lengths.copy()
        box[drop] = lengths.max()
        ref = jax_exact_d2_orthorhombic(jnp.asarray(zeroed_a),
                                        jnp.asarray(zeroed_c),
                                        jnp.asarray(box))
        for got, want in zip(port, ref):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- constants, ceilings, launch arguments ------------------------------------

@pytest.mark.parametrize("r_min, r_max, n_bins", [
    (0.0, 6.0, 200), (1.2, 3.7, 45), (2.0, 6.0, 200), (0.5, 1.25, 12),
])
def test_bin_boundary_constants_match_jax(r_min, r_max, n_bins):
    """Both conventions' constants are the JAX package's, bit for bit
    (the offset coefficients split from float64 endpoints)."""

    port = cch._bin_boundary_constants(r_max, n_bins, r_min)
    ref = jax_bin_boundary_constants(r_max, n_bins, r_min)
    assert port[0] == ref[0]
    flat = np.array(jax.tree_util.tree_leaves(port[1:]), np.float32)
    want = np.array(jax.tree_util.tree_leaves(ref[1:]), np.float32)
    np.testing.assert_array_equal(flat.view(np.int32), want.view(np.int32))
    consts = cch._launch_constants(port)
    assert consts[0] == int(r_min > 0.0) and len(consts) == 9


def test_asymmetric_tiles_plan_and_launch_limits():
    """An asymmetric self tile takes 20 bytes a slot: its plans stay
    under a lower capacity ceiling, and a capacity within the 16-byte
    slots' ceiling but over the 20-byte one raises, on the CPU as on the
    card."""

    assert cch._max_capacity(cch._ASYM_SLOT_BYTES) == 3264
    assert cch._max_capacity() == cch._MAX_CAPACITY
    plan = cch.cell_plan_search(400_000, [30.0] * 3, 20.0,
                                slot_bytes=cch._ASYM_SLOT_BYTES)
    assert plan["capacity"] <= 3264
    pos = torch.zeros((1, 8, 3))
    args = dict(box=(40.0,) * 3, r_max=4.0, n_cells_dim=(1, 1, 1),
                capacity=4096, n_bins=20_000)
    cch.cell_pair_histogram(pos, **args)
    cch.cell_pair_histogram(pos, exclusion=(3, 3), **args)
    with pytest.raises(ValueError, match="shared memory"):
        cch.cell_pair_histogram(pos, exclusion=(2, 3), **args)


@pytest.mark.parametrize("kwargs", [
    dict(range_=(3.0, 1.0)), dict(precision="double"),
    dict(axes=(0, 1)), dict(n_cells_dim=(3, 3), axes=(0, 0)),
    dict(n_cells_dim=(3, 3), axes=(0, 1), reach=(1, 1, 1)),
])
def test_wrappers_reject_bad_options(kwargs):
    args = dict(box=(12.0,) * 3, r_max=3.5, n_cells_dim=(3, 3, 3),
                capacity=64, n_bins=8)
    r_min, r_max = kwargs.pop("range_", (0.0, 3.5))
    args.update(r_min=r_min, r_max=r_max, **kwargs)
    with pytest.raises(ValueError):
        cch.cell_pair_histogram(torch.zeros((1, 8, 3)), **args)


@pytest.mark.parametrize("case", ["asym", "axes2", "offset_fast"])
def test_kernel_launch_arguments_of_new_modes(monkeypatch, case):
    """What the wrappers pass their C entry points (captured, no card):
    a 2-D grid's slot table and box with the kept axes first and its
    component count; an asymmetric tile's 16-byte slot table and its
    second ids as the side table, with the tile flags; the fast flag and
    the offset constants."""

    seen = {}

    def capture(entry, device, *args):
        seen["entry"], seen["args"] = entry, args

    monkeypatch.setattr(cch, "_launch", capture)
    pos, lengths = _inputs("slab")
    p = torch.from_numpy(pos)[None]
    kwargs = dict(exclusion=None, r_min=0.0, precision="exact")
    if case == "asym":
        grid, axes, kwargs["exclusion"] = (3, 3, 3), None, (2, 3)
    elif case == "axes2":
        grid, axes = (4, 4), (0, 2)
    else:
        grid, axes = (3, 3, 3), None
        kwargs.update(r_min=0.7, precision="fast")
    cch._self_kernel(p, lengths, 3.5, grid, CAP, N_BINS, False, axes=axes,
                     **kwargs)
    entry, got = seen["entry"], seen["args"]
    assert entry == "cell_pair_histogram_launch"
    assert len(got) + 1 == len(_build._SIGNATURES[entry])
    box, dims, _, _, (table, occ, _), nbr = cch._self_inputs(
        p, lengths, grid, CAP, False, None, N_BINS, axes=axes,
        exclusion=kwargs["exclusion"])
    tiles, asym, side, fast, offset = got[12:17]
    np.testing.assert_array_equal(got[1].numpy(), occ.numpy())
    np.testing.assert_array_equal(got[2].numpy(), nbr.numpy())
    if case == "asym":
        assert (tiles, asym) == (1, 1) and table.shape[-1] == 5
        torch.testing.assert_close(got[0], table[..., :4], rtol=0, atol=0)
        torch.testing.assert_close(side, table[..., 4], rtol=0, atol=0)
    else:
        assert (tiles, asym, side) == (0, 0, None)
        torch.testing.assert_close(got[0], table, rtol=0, atol=0)
    if case == "axes2":
        # x, z kept, y dropped: the slot table and box hold x, z, y
        assert got[11] == 2 and dims == (4, 4, 1)
        torch.testing.assert_close(got[3], torch.from_numpy(
            lengths[[0, 2, 1]])[None], rtol=0, atol=0)
        # every slot holds an atom's x, z, y
        rows = (table[0, :, None, :3] == p[0][None, :, [0, 2, 1]])
        assert bool(rows.all(dim=-1).any(dim=-1).all())
    else:
        assert got[11] == 3
    assert fast == int(case == "offset_fast")
    consts = cch._launch_constants(cch._bin_boundary_constants(
        3.5, N_BINS, kwargs["r_min"]))
    assert (offset, *got[17:]) == consts
