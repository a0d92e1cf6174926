"""The port's triclinic path against the JAX package on the CPU: the box
matrices, perpendicular widths, image tables and double-float shift
table (bit for bit), the 27-image exact binning, the triclinic kernels'
plain versions (against a float64 27-image oracle), and the triclinic
RDF (self and cross) and Van Hove classes (integer counts equal).

Inputs are made with numpy from a seed and the same float32 arrays go
through both packages.  The JAX classes stream float32
(``_coord_dtype``), as on the TPU; on the CPU they take the exact XLA
27-image sweep, the port its triclinic cell-list kernels' plain
versions.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
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
from mdhelper_tpu.ops.histogram import (  # noqa: E402
    _exact_bin_indices as jax_exact_bin_indices,
    _min_image_distance as jax_min_image_distance,
    displacement_histogram_frame as jax_displacement_histogram_frame,
)
from mdhelper_tpu.ops.pallas_cell_histogram import (  # noqa: E402
    _image_shift_table as jax_image_shift_table,
    _neighbor_tables,
    _triclinic_wrap_cells as jax_triclinic_wrap_cells,
    triclinic_perpendicular_widths as jax_perpendicular_widths,
)

from mdhelper_tpu_torch.algorithm.topology import (  # noqa: E402
    triclinic_matrices,
)
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
    VanHoveFunction,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import _build  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.ops.histogram import (  # noqa: E402
    _exact_bin_indices,
    _min_image_distance,
    displacement_histogram_frame,
)
from mdhelper_tpu_torch.testing import (  # noqa: E402
    edge_straddle_triclinic_positions,
    f64_triclinic_pair_histogram,
)

#: the tilted cell of tests/test_pallas.py's triclinic kernel cases.
DIMS6 = np.array([16.0, 15.0, 14.0, 80.0, 95.0, 100.0])
#: a GROMACS xy-square rhombic dodecahedron, scaled down (widths 14.70,
#: 14.70 and 12.73: 3 cells of r_max 4 on every axis).
DODECA = np.array([18.0, 18.0, 18.0, 60.0, 60.0, 90.0])
#: the chip's dodecahedra: 100k atoms at density 0.8, and 400k.
FULL_BOXES = (
    np.array([56.12, 56.12, 56.12, 60.0, 60.0, 90.0]),
    np.array([89.09, 89.09, 89.09, 60.0, 60.0, 90.0]),
)
R_MAX, N_BINS = 3.0, 48


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


def _interior(rng, shape, dims6):
    """float32 positions at fractional coordinates in [0.02, 0.98) (the
    fold is then the identity in both packages)."""

    h64 = np.asarray(jax_triclinic_matrices(dims6), np.float64)
    return ((0.02 + 0.96 * rng.random(shape)) @ h64).astype(np.float32)


# -- box geometry, bit for bit -----------------------------------------------

@pytest.mark.parametrize("dims6", [DIMS6, DODECA, *FULL_BOXES],
                         ids=["dims6", "dodeca", "dodeca100k", "dodeca400k"])
def test_box_geometry_matches_jax(dims6):
    """triclinic_matrices (NumPy and torch float64, then float32) and
    the perpendicular widths of the float32 matrix are bit-equal to the
    JAX package's."""

    ref = _h32(dims6)
    ref_jnp = np.asarray(
        jax_triclinic_matrices(jnp.asarray(dims6))
    ).astype(np.float32)
    np.testing.assert_array_equal(ref, ref_jnp)
    np.testing.assert_array_equal(
        triclinic_matrices(dims6).astype(np.float32), ref
    )
    port_t = triclinic_matrices(torch.from_numpy(np.stack([dims6] * 2)))
    assert port_t.dtype == torch.float64
    np.testing.assert_array_equal(port_t.to(torch.float32).numpy()[1], ref)

    widths = np.asarray(jax_perpendicular_widths(ref))
    np.testing.assert_array_equal(cch.triclinic_perpendicular_widths(ref),
                                  widths)
    torch_widths = cch.triclinic_perpendicular_widths(torch.from_numpy(ref))
    np.testing.assert_array_equal(torch_widths.numpy(), widths)
    jnp_widths = np.asarray(jax_perpendicular_widths(jnp.asarray(ref)))
    np.testing.assert_array_equal(torch_widths.numpy(), jnp_widths)


def test_image_shift_table_matches_jax():
    """Each frame's 27 double-float lattice translations equal the JAX
    package's table, hi and lo, bit for bit."""

    dims = [DIMS6, DODECA, *FULL_BOXES]
    boxes = np.stack([_h32(d) for d in dims])
    hi, lo = cch._image_shift_table(torch.from_numpy(boxes))
    assert hi.shape == lo.shape == (len(dims), 27, 3)
    for f, box in enumerate(boxes):
        ref_hi, ref_lo = jax_image_shift_table(jnp.asarray(box))
        np.testing.assert_array_equal(hi[f].numpy(), np.asarray(ref_hi))
        np.testing.assert_array_equal(lo[f].numpy(), np.asarray(ref_lo))


@pytest.mark.parametrize("dims", [(3, 3, 3), (3, 4, 5), (7, 7, 6)])
def test_image_tables_match_jax(dims):
    """The image rows line up with the port's neighbour tables entry for
    entry, as the JAX package's ``full_img`` and ``half_img`` do with
    its ``full`` and ``half`` tables."""

    full, full_img, half, half_img = _neighbor_tables(dims)
    np.testing.assert_array_equal(cch._full_table(dims), np.asarray(full))
    np.testing.assert_array_equal(cch._half_table(dims), np.asarray(half))
    np.testing.assert_array_equal(cch._full_images(dims), full_img)
    np.testing.assert_array_equal(cch._half_images(dims), half_img)
    assert (cch._half_images(dims)[:, 0] == 13).all()  # the zero image


# -- the brute-force oracle and the fold ---------------------------------------

def test_exact_bins_and_displacements_match_jax():
    """The 27-image exact bins of a pair block (some positions outside
    the cell) and of elementwise displacements, and the float32
    minimum-image lengths, against the JAX package's."""

    rng = np.random.default_rng(17)
    box = _h32(DIMS6)
    p1 = _interior(rng, (150, 3), DIMS6)
    p2 = _interior(rng, (170, 3), DIMS6)
    p2[::3] += np.float32(1.0) * box[2] - box[0]  # outside the cell
    edges = np.linspace(0.0, R_MAX, N_BINS + 1)
    port = _exact_bin_indices(torch.from_numpy(p1), torch.from_numpy(p2),
                              torch.from_numpy(box), edges)
    ref = jax_exact_bin_indices(jnp.asarray(p1), jnp.asarray(p2),
                                jnp.asarray(box), jnp.asarray(edges),
                                N_BINS)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert (port.numpy() < N_BINS).sum() > 100

    past = p2[:150][None].repeat(2, axis=0)
    past[1] = p1 + rng.normal(0.0, 0.8, p1.shape).astype(np.float32)
    port = displacement_histogram_frame(
        torch.from_numpy(p1), torch.from_numpy(past),
        torch.from_numpy(box), edges,
    )
    for k in range(2):
        ref = jax_displacement_histogram_frame(
            jnp.asarray(p1), jnp.asarray(past[k]), jnp.asarray(box),
            jnp.asarray(edges), precision="exact",
        )
        np.testing.assert_array_equal(port[k].numpy(),
                                      np.asarray(ref).astype(np.int64))
    dist = _min_image_distance(torch.from_numpy(p1 - past[1]),
                               torch.from_numpy(box))
    ref = jax_min_image_distance(jnp.asarray(p1 - past[1]), jnp.asarray(box))
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref), rtol=1e-6)


def test_wrap_cells_fold_and_grid():
    """The elementwise fold is the identity inside the cell and puts
    atoms in the JAX package's cells; atoms moved by whole lattice
    vectors fold back next to where they were, into the same cells."""

    rng = np.random.default_rng(8)
    box = _h32(DODECA)
    dims = (3, 3, 3)
    pos = _interior(rng, (400, 3), DODECA)
    wrapped, cells = cch._triclinic_wrap_cells(
        torch.from_numpy(pos)[None], torch.from_numpy(box)[None], dims
    )
    np.testing.assert_array_equal(wrapped[0].numpy(), pos)
    _, ref_cells = jax_triclinic_wrap_cells(jnp.asarray(pos),
                                            jnp.asarray(box), dims)
    np.testing.assert_array_equal(cells[0].numpy(), np.asarray(ref_cells))

    shift = rng.integers(-2, 3, (400, 3)).astype(np.float32) @ box
    moved, moved_cells = cch._triclinic_wrap_cells(
        torch.from_numpy(pos + shift)[None], torch.from_numpy(box)[None],
        dims,
    )
    np.testing.assert_allclose(moved[0].numpy(), pos, atol=1e-4)
    np.testing.assert_array_equal(moved_cells.numpy(), cells.numpy())


# -- the triclinic kernels' plain versions ------------------------------------

def _straddle(rng):
    box = _h32(DODECA)
    return edge_straddle_triclinic_positions(rng, box), box, 4.0, 16


@pytest.mark.parametrize("case", [
    "straddle_self", "straddle_cross", "dims6_self", "dims6_cross_21",
])
def test_triclinic_references_equal_f64_oracle(case):
    """Both plain versions bin like a float64 27-image oracle: on the
    bin-edge straddle fixture (90 pairs at the edge 1.25 and one ulp
    either side), self and as cross pairs, and on the tilted cell of
    tests/test_pallas.py, self and with a (2, 1) exclusion."""

    rng = np.random.default_rng(21)
    if case.startswith("straddle"):
        pos, box, r_max, n_bins = _straddle(rng)
    else:
        box, r_max, n_bins = _h32(DIMS6), R_MAX, 64
        pos = _interior(rng, (700, 3), DIMS6)
    widths = cch.triclinic_perpendicular_widths(box).astype(np.float64)
    if case.endswith("self"):
        plan = cch.cell_plan_search(len(pos), widths, r_max)
        counts, occ = cch.triclinic_cell_pair_histogram(
            torch.from_numpy(pos), box=box, r_max=r_max,
            n_cells_dim=plan["n_cells_dim"], capacity=plan["capacity"],
            n_bins=n_bins,
        )
        assert int(occ.max()) <= plan["capacity"]
        oracle = f64_triclinic_pair_histogram(pos, pos, box, r_max, n_bins,
                                              exclusion=(1, 1))
    else:
        split = 300 if case.startswith("straddle") else 400
        p1, p2 = pos[:split], pos[split:]
        exclusion = None if case.startswith("straddle") else (2, 1)
        plan = cch.cell_plan_search(len(p1), widths, r_max,
                                    n_atoms2=len(p2))
        counts, _, _ = cch.triclinic_cross_pair_histogram(
            torch.from_numpy(p1), torch.from_numpy(p2), box=box,
            r_max=r_max, n_cells_dim=plan["n_cells_dim"],
            capacity1=plan["capacity"], capacity2=plan["capacity2"],
            n_bins=n_bins, exclusion=exclusion,
        )
        oracle = f64_triclinic_pair_histogram(p1, p2, box, r_max, n_bins,
                                              exclusion)
    np.testing.assert_array_equal(counts[0].numpy().astype(np.int64),
                                  oracle)
    assert oracle.sum() > 0


def test_triclinic_poison_per_frame():
    """A frame whose c-vector shrank below the planned grid comes back
    NaN from both sweeps (strictly: the grid has 3 cells on that axis,
    which an orthorhombic sweep would let pass); the other frame is
    counted."""

    rng = np.random.default_rng(22)
    box = _h32(DIMS6)
    bad = box.copy()
    bad[2] *= np.float32(0.5)
    boxes = np.stack([box, bad])
    pos = _interior(rng, (2, 300, 3), DIMS6)
    widths = cch.triclinic_perpendicular_widths(box).astype(np.float64)
    plan = cch.cell_plan_search(300, widths, R_MAX, n_atoms2=300)
    assert plan["n_cells_dim"][2] == 3
    args = dict(box=boxes, r_max=R_MAX, n_cells_dim=plan["n_cells_dim"],
                n_bins=N_BINS)
    self_counts, _ = cch.triclinic_cell_pair_histogram(
        torch.from_numpy(pos), capacity=plan["capacity"], **args
    )
    cross_counts, _, _ = cch.triclinic_cross_pair_histogram(
        torch.from_numpy(pos), torch.from_numpy(pos[:, ::-1].copy()),
        capacity1=plan["capacity"], capacity2=plan["capacity2"],
        exclusion=(1, 1), **args,
    )
    for counts in (self_counts, cross_counts):
        assert torch.isfinite(counts[0]).all() and counts[0].sum() > 0
        assert torch.isnan(counts[1]).all()


@pytest.mark.parametrize("sweep", ["self", "cross"])
def test_kernel_launch_shares_plain_inputs(monkeypatch, sweep):
    """The kernel and its plain version take one slot table, shift table
    and image table, so they agree as integers whatever the cell
    assignment: the arguments the CUDA wrapper would pass to its C entry
    point (captured here, with no card) are the tables the plain version
    sweeps, in the order and number of the entry point's signature."""

    rng = np.random.default_rng(3)
    box = torch.from_numpy(_h32(DODECA))
    # Unwrapped input: the fold moves every atom.
    pos = torch.from_numpy(_interior(rng, (1, 300, 3), DODECA)) + box[2]
    seen = {}

    def capture(entry, device, *args):
        seen["entry"], seen["args"] = entry, args

    monkeypatch.setattr(cch, "_launch", capture)
    grid = dict(r_max=4.0, n_cells_dim=(3, 3, 3), n_bins=16)
    if sweep == "self":
        cch._self_kernel(pos, box, capacity=64, triclinic=True, **grid)
        box_b, dims, _, _, (table, occ, _), nbr = cch._self_inputs(
            pos, box, (3, 3, 3), 64, True
        )
        tables = [table, occ, nbr]
        images = cch._half_images(dims)
    else:
        cch._cross_kernel(pos, pos, box, capacity1=64, capacity2=64,
                          exclusion=(1, 1), triclinic=True, **grid)
        box_b, dims, _, _, (t1, o1, _), (t2, o2, _), nbr = cch._cross_inputs(
            pos, pos, box, (3, 3, 3), 64, 64, (1, 1), True
        )
        tables = [t1, o1, t2, o2, nbr]
        images = cch._full_images(dims)
    entry, args = seen["entry"], seen["args"]
    assert entry == f"triclinic_{'cell' if sweep == 'self' else 'cross'}" \
        "_pair_histogram_launch"
    assert len(args) + 1 == len(_build._SIGNATURES[entry])
    n = len(tables)
    for got, want in zip(args[:n], tables):
        torch.testing.assert_close(got, want.to(got.dtype), rtol=0, atol=0)
    np.testing.assert_array_equal(args[n].numpy(), images)
    shift_hi, shift_lo = cch._image_shift_table(box_b)
    torch.testing.assert_close(args[n + 1], shift_hi, rtol=0, atol=0)
    torch.testing.assert_close(args[n + 2], shift_lo, rtol=0, atol=0)


@pytest.mark.parametrize("triclinic", [False, True])
def test_swept_pairs_counts_neighbour_cell_pairs(triclinic):
    """swept_pairs counts the occupied slot pairs of the half shell (and
    of the full shell for two groups): every atom pair whose cells are
    neighbours, by a NumPy count over all pairs."""

    rng = np.random.default_rng(6)
    dims = (3, 4, 3)
    if triclinic:
        box = _h32(DODECA)
        pos = _interior(rng, (200, 3), DODECA)
        _, cells = cch._triclinic_wrap_cells(
            torch.from_numpy(pos)[None], torch.from_numpy(box)[None], dims
        )
        cells = cells[0].numpy()
    else:
        box = np.float32([12.0, 14.0, 13.0])
        pos = (rng.random((200, 3)) * box).astype(np.float32)
        cells = (pos / (box / np.float32(dims))).astype(int)
    offset = (cells[:, None] - cells[None]) % np.array(dims)
    near = np.all((offset <= 1) | (offset == np.array(dims) - 1), axis=-1)
    half = int(np.triu(near, 1).sum())
    args = dict(box=box, n_cells_dim=dims, triclinic=triclinic)
    assert cch.swept_pairs(torch.from_numpy(pos), **args) == half
    p = torch.from_numpy(pos)
    assert cch.swept_pairs(p[:80], p[80:], **args) == int(
        near[:80, 80:].sum()
    )


# -- the analyses against the JAX classes -------------------------------------

# One chunk: each JAX chunk shape costs an XLA compile of the 27-image
# sweep (most of these tests' time).
N_ATOMS, N_FRAMES, CHUNK = 500, 3, 3


@pytest.fixture(scope="module")
def trajectory():
    """A random walk in fractional coordinates, wrapped into the
    dodecahedron, as float32 positions (steps well under half a
    cell)."""

    rng = np.random.default_rng(2029)
    h64 = np.asarray(jax_triclinic_matrices(DODECA), np.float64)
    frac = rng.random((N_ATOMS, 3)) + np.cumsum(
        rng.normal(0.0, 0.02, (N_FRAMES, N_ATOMS, 3)), axis=0
    )
    return (np.mod(frac, 1.0) @ h64).astype(np.float32)


def _jax_run(analysis, chunk=CHUNK):
    analysis._chunk_bytes = chunk * N_ATOMS * 3 * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        analysis.run()
    return analysis


@pytest.mark.parametrize("kind, exclusion", [
    ("self", None), ("self", (1, 1)), ("cross", (2, 1)),
], ids=["self", "self_11", "cross_21"])
def test_triclinic_rdf_matches_jax(trajectory, kind, exclusion):
    u = Universe.from_arrays(trajectory, DODECA, dt=1.0)
    ju = JaxUniverse.from_arrays(trajectory.astype(np.float64), DODECA,
                                 dt=1.0)
    groups = (lambda uu: (uu.atoms,)) if kind == "self" else (
        lambda uu: (uu.atoms[0::2], uu.atoms[1::2])
    )
    kwargs = dict(n_bins=N_BINS, range=(0.0, 4.0), exclusion=exclusion,
                  verbose=False)
    rdf = RadialDistributionFunction(*groups(u), device="cpu", **kwargs)
    rdf._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    run_together([rdf])
    ref = _jax_run(JaxRDF(*groups(ju), **kwargs))
    assert rdf._triclinic and rdf.results.counts.sum() > 0
    np.testing.assert_array_equal(rdf.results.counts, ref.results.counts)
    np.testing.assert_allclose(rdf.results.rdf, ref.results.rdf,
                               rtol=1e-12)


def test_triclinic_vanhove_matches_jax(trajectory):
    u = Universe.from_arrays(trajectory, DODECA, dt=0.5)
    ju = JaxUniverse.from_arrays(trajectory.astype(np.float64), DODECA,
                                 dt=0.5)
    kwargs = dict(n_bins=N_BINS, range=(0.0, 4.0), lags="log",
                  verbose=False)
    vh = VanHoveFunction(u.atoms, device="cpu", **kwargs)
    vh._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    vh.run()
    ref = _jax_run(JaxVanHove(ju.atoms, **kwargs))
    np.testing.assert_array_equal(vh.results.counts_self,
                                  ref.results.counts_self)
    np.testing.assert_array_equal(vh.results.counts_distinct,
                                  ref.results.counts_distinct)
    assert vh.results.counts_distinct[-1].sum() > 0
    np.testing.assert_allclose(vh.results.gd, ref.results.gd, rtol=1e-12)
    np.testing.assert_allclose(vh.results.msd, ref.results.msd, rtol=1e-5)


@pytest.mark.parametrize("cls", [RadialDistributionFunction,
                                 VanHoveFunction])
def test_narrow_triclinic_box_not_ported(trajectory, cls):
    """Perpendicular widths under 3 cutoffs (12.73 A against 3 x 4.5)
    take the per-pair 27-candidate mode (tri_pp) on a generalized grid:
    the self RDF (exclusion None) and the Van Hove (self and distinct
    parts) equal the JAX classes as integers.  Two frames in one chunk:
    the JAX Van Hove's compile grows with its lags.  Other RDF variants
    in such boxes: tests/test_torch_generalized.py."""

    traj = trajectory[:2]
    u = Universe.from_arrays(traj, DODECA, dt=1.0)
    ju = JaxUniverse.from_arrays(traj.astype(np.float64), DODECA, dt=1.0)
    kwargs = dict(n_bins=N_BINS, range=(0.0, 4.5), verbose=False)
    if cls is VanHoveFunction:
        kwargs["lags"] = "log"
    port = cls(u.atoms, device="cpu", **kwargs)
    assert cch.plan_is_tri_pp(port._searched_cell_plan(), True)
    port._chunk_bytes = len(traj) * N_ATOMS * 3 * 4
    port.run()
    ref = _jax_run((JaxVanHove if cls is VanHoveFunction else JaxRDF)(
        ju.atoms, **kwargs), chunk=len(traj))
    names = (["counts_self", "counts_distinct"] if cls is VanHoveFunction
             else ["counts"])
    for name in names:
        got = getattr(port.results, name)
        np.testing.assert_array_equal(got, getattr(ref.results, name))
        assert got.sum() > 0
    if cls is RadialDistributionFunction:
        np.testing.assert_allclose(port.results.rdf, ref.results.rdf,
                                   rtol=1e-12)
