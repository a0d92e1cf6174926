"""The port's bond-orientational order (``analysis/steinhardt.py``) and
spherical harmonics (``algorithm/spherical.py``) against the JAX
package's.

The same seeded float32 atoms go through
``mdhelper_tpu.analysis.steinhardt`` (streaming float32: ``_coord_dtype``
on its base class, on the CPU) and its port (``device="cpu"``), in chunks
of 2 frames of 5 (a short last chunk), in an orthorhombic box and a
triclinic one, on ``u.atoms`` and on a subset group.  Neighbor counts are
integers and must be equal.  Tolerances, with their reasons:

* q_l, the averaged q_l and Q_l within ``QL_ATOL`` (about 17 eps32):
  float32 harmonics summed over about 20 neighbors in another order (the
  port over each neighbor list, the JAX package over dense rows);
* w_l and the averaged w_l within ``WL_ATOL``: the cubic invariant over
  ``|q_lm|^3`` amplifies those errors where q_l is small;
* q_tet within ``QTET_ATOL`` (about 17 eps32): float32 cosines of the
  same neighbors, squared and summed in another order;
* the harmonics equal the JAX function's bit for bit in numpy and within
  4 eps of each dtype in torch; the Wigner symbols and invariants (host
  numpy copies) equal.

Straddle fixtures put neighbors at the cutoff and 1 ulp either side: their
counts equal the JAX package's and a float64 oracle's.  A simple cubic
lattice ties its six nearest neighbors, of which the tetrahedral order
takes four, lower indices first (as ``lax.top_k``): the port equals the
JAX class there and that rule's float64 oracle.  An FCC crystal gives the
literature values the JAX package's tests check.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = jax.numpy
torch = pytest.importorskip("torch")

from mdhelper_tpu import Q_ as JQ  # noqa: E402
from mdhelper_tpu.algorithm import spherical as jax_spherical  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import steinhardt as jax_steinhardt  # noqa: E402
from mdhelper_tpu.analysis.multi import run_together as jax_run_together  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.algorithm import spherical  # noqa: E402
from mdhelper_tpu_torch.analysis import steinhardt  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import histogram  # noqa: E402
from mdhelper_tpu_torch.ops.histogram import (  # noqa: E402
    _row_blocks,
    _sweep_elements,
)

EPS32 = float(np.finfo(np.float32).eps)
QL_ATOL, WL_ATOL, QTET_ATOL = 2e-6, 1e-5, 2e-6
N, T, CHUNK = 240, 5, 2
BOX = 13.0
TRICLINIC = [BOX] * 3 + [80.0, 75.0, 70.0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_streams_float32(monkeypatch):
    monkeypatch.setattr(jax_base.SerialAnalysisBase, "_coord_dtype",
                        np.float32)


def _universes(frames, dims, dt=1.0, **topology):
    return (JaxUniverse.from_arrays(frames.astype(np.float64), dims, dt=dt,
                                    **topology),
            Universe.from_arrays(frames, dims, dt=dt, **topology))


@pytest.fixture(scope="module")
def fluid():
    """Uniform float32 atoms about the density of water's atoms, in the
    cube and in a triclinic cell, names A and B alternating."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices

    rng = np.random.default_rng(2035)
    frames = (rng.random((T, N, 3)) * BOX).astype(np.float32)
    h = np.asarray(triclinic_matrices(np.asarray(TRICLINIC, float)[None]))[0]
    tri = ((rng.random((T, N, 3)) @ h)).astype(np.float32)
    names = dict(names=np.tile(np.array(["A", "B"], object), N // 2))
    return {
        "ortho": _universes(frames, np.array([BOX] * 3 + [90.0] * 3),
                            dt=0.5, **names),
        "triclinic": _universes(tri, np.asarray(TRICLINIC), dt=0.5,
                                **names),
    }


def _chunked(analyses):
    for a in analyses:
        a._chunk_bytes = CHUNK * len(a._atom_indices) * 3 * 4
    return analyses


def _group(u, subset):
    return u.select_atoms("name A") if subset else u.atoms


# (box, subset, cutoff, degrees, averaged, wl)
STEINHARDT_CASES = {
    "q46_all": ("ortho", False, 3.5, (4, 6), True, True),
    "q2468": ("ortho", False, 3.0, (2, 4, 6, 8), False, True),
    "subset": ("ortho", True, 4.0, (4, 6), True, False),
    "triclinic": ("triclinic", False, 3.5, (4, 6), True, True),
    "triclinic_subset": ("triclinic", True, 4.5, (6,), True, True),
}


@pytest.mark.parametrize("case", list(STEINHARDT_CASES))
def test_steinhardt_matches_jax(fluid, case):
    box, subset, cutoff, degrees, averaged, wl = STEINHARDT_CASES[case]
    ju, tu = fluid[box]
    kwargs = dict(averaged=averaged, wl=wl, verbose=False)
    ref, = jax_run_together(_chunked([jax_steinhardt.SteinhardtOrderParameter(
        _group(ju, subset), cutoff, degrees, **kwargs)]))
    ours, = run_together(_chunked([steinhardt.SteinhardtOrderParameter(
        _group(tu, subset), cutoff, degrees, device="cpu", **kwargs)]))
    np.testing.assert_array_equal(ours.results.n_neighbors,
                                  ref.results.n_neighbors)
    assert ours.results.n_neighbors.min() >= 0
    assert ours.results.n_neighbors.max() > 4
    keys = ["ql", "ql_mean", "Ql"]
    keys += ["wl"] if wl else []
    keys += ["ql_avg"] if averaged else []
    keys += ["wl_avg"] if wl and averaged else []
    for key in keys:
        tol = WL_ATOL if key.startswith("wl") else QL_ATOL
        np.testing.assert_allclose(ours.results[key], ref.results[key],
                                   rtol=0, atol=tol)
    assert set(ours.results) == set(ref.results)
    np.testing.assert_array_equal(ours.results.times, ref.results.times)


TETRA_CASES = {
    "all": ("ortho", False, 4),
    "subset_k6": ("ortho", True, 6),
    "triclinic": ("triclinic", False, 4),
    "triclinic_subset": ("triclinic", True, 3),
}


@pytest.mark.parametrize("case", list(TETRA_CASES))
def test_tetrahedral_matches_jax(fluid, case):
    box, subset, k = TETRA_CASES[case]
    ju, tu = fluid[box]
    ref, = jax_run_together(_chunked([jax_steinhardt.TetrahedralOrderParameter(
        _group(ju, subset), n_neighbors=k, verbose=False)]))
    ours, = run_together(_chunked([steinhardt.TetrahedralOrderParameter(
        _group(tu, subset), n_neighbors=k, verbose=False, device="cpu")]))
    for key in ("q_tet", "q_tet_mean"):
        np.testing.assert_allclose(ours.results[key], ref.results[key],
                                   rtol=0, atol=QTET_ATOL)
    np.testing.assert_array_equal(ours.results.times, ref.results.times)


@pytest.mark.parametrize("box", ["ortho", "triclinic"])
def test_small_row_blocks_match_jax(monkeypatch, fluid, box):
    """Neighbor sweeps in many row blocks (a 4,096-element budget) give the
    JAX package's neighbor counts, q_l and q_tet."""

    monkeypatch.setattr(histogram, "_sweep_elements", lambda device: 1 << 12)
    assert len(_row_blocks(N, N, "cpu")) > 1
    ju, tu = fluid[box]
    ref = jax_run_together(_chunked([
        jax_steinhardt.SteinhardtOrderParameter(ju.atoms, 3.5, (4, 6),
                                                verbose=False),
        jax_steinhardt.TetrahedralOrderParameter(ju.atoms, verbose=False)]))
    ours = run_together(_chunked([
        steinhardt.SteinhardtOrderParameter(tu.atoms, 3.5, (4, 6),
                                            verbose=False, device="cpu"),
        steinhardt.TetrahedralOrderParameter(tu.atoms, verbose=False,
                                             device="cpu")]))
    np.testing.assert_array_equal(ours[0].results.n_neighbors,
                                  ref[0].results.n_neighbors)
    np.testing.assert_allclose(ours[0].results.ql, ref[0].results.ql,
                               rtol=0, atol=QL_ATOL)
    np.testing.assert_allclose(ours[1].results.q_tet, ref[1].results.q_tet,
                               rtol=0, atol=QTET_ATOL)


def test_order_pair_runs_together(fluid):
    """bench.py's order pair through run_together gives each class's own
    run() results."""

    _, tu = fluid["ortho"]

    def make():
        return [steinhardt.SteinhardtOrderParameter(
                    tu.atoms, 3.5, (4, 6), averaged=True, wl=True,
                    verbose=False, device="cpu"),
                steinhardt.TetrahedralOrderParameter(tu.atoms, verbose=False,
                                                     device="cpu")]

    fused = run_together(_chunked(make()))
    for a, alone in zip(fused, _chunked(make())):
        alone.run()
        for key, value in alone.results.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(a.results[key], value)


def _fcc(nc=3, a=1.0):
    basis = np.array([[0, 0, 0], [0, 0.5, 0.5], [0.5, 0, 0.5],
                      [0.5, 0.5, 0]]) * a
    cells = np.array([[i, j, k] for i in range(nc) for j in range(nc)
                      for k in range(nc)], dtype=float) * a
    pos = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3)
    return pos.astype(np.float32)[None], [nc * a] * 3 + [90.0] * 3


def test_fcc_literature_values():
    """tests/test_analysis_steinhardt.py's FCC values, in float32."""

    pos, box = _fcc()
    u = Universe.from_arrays(pos, box)
    sop = steinhardt.SteinhardtOrderParameter(
        u.atoms, 0.85, (4, 6), wl=True, averaged=True, verbose=False,
        device="cpu").run()
    ql = sop.results.ql[0]
    assert (sop.results.n_neighbors == 12).all()
    np.testing.assert_allclose(ql[0], 0.190941, atol=2e-5)
    np.testing.assert_allclose(ql[1], 0.574524, atol=2e-5)
    np.testing.assert_allclose(sop.results.wl[0, 0], -0.159317, atol=2e-5)
    np.testing.assert_allclose(sop.results.wl[0, 1], -0.013161, atol=2e-5)
    # a perfect crystal: averaging changes nothing; Q_l is the local order
    np.testing.assert_allclose(sop.results.ql_avg[0], ql, atol=QL_ATOL)
    np.testing.assert_allclose(sop.results.wl_avg[0], sop.results.wl[0],
                               atol=WL_ATOL)
    np.testing.assert_allclose(sop.results.Ql[0], ql.mean(axis=-1),
                               atol=QL_ATOL)
    # an FCC site's four nearest of twelve tied neighbours
    tet = steinhardt.TetrahedralOrderParameter(u.atoms, verbose=False,
                                               device="cpu").run()
    assert np.isfinite(tet.results.q_tet).all()


def _straddle_frames(cutoff):
    """Centers at the corners of an 8 A grid, each with one neighbor along
    +x at the float32 cutoff's nearest and 1 ulp either side (exact
    differences, far from every other atom)."""

    c = np.float32(cutoff)
    dists = [np.nextafter(c, np.float32(0)), c, np.nextafter(c, np.float32(9))]
    pos = []
    for k, d in enumerate(dists):
        base = np.float32(8.0 * k + 1.0)
        pos += [(0.0, base, 1.0), (d, base, 1.0)]
    return np.asarray(pos, np.float32)[None], 8.0 * len(dists) + 8.0


@pytest.mark.parametrize("cutoff", [2.5, 3.1, 3.5])
def test_straddle_neighbors_match_jax_and_f64(cutoff):
    frames, side = _straddle_frames(cutoff)
    ju, tu = _universes(frames, np.array([side] * 3 + [90.0] * 3))
    ref = jax_steinhardt.SteinhardtOrderParameter(ju.atoms, cutoff,
                                                  verbose=False).run()
    ours = steinhardt.SteinhardtOrderParameter(tu.atoms, cutoff,
                                               verbose=False,
                                               device="cpu").run()
    d = frames[0, 1::2, 0].astype(np.float64)
    expected = np.repeat((d * d <= cutoff * cutoff).astype(np.int64), 2)
    np.testing.assert_array_equal(ours.results.n_neighbors[0], expected)
    np.testing.assert_array_equal(ref.results.n_neighbors[0], expected)
    assert 0 < expected.sum() < len(expected)


def _tetra_oracle(pos, box, k, lowest=True):
    """float64 q_tet with the k nearest neighbors, ties taken by the lower
    index (or the higher one)."""

    delta = pos[None, :, :].astype(np.float64) - pos[:, None, :]
    delta -= box * np.round(delta / box)
    d2 = (delta**2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    n = len(pos)
    idx = np.arange(n)
    key = np.lexsort((idx[None, :].repeat(n, 0) * (1 if lowest else -1),
                      d2), axis=1)[:, :k]
    u = np.take_along_axis(delta, key[..., None], 1)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    g = np.einsum("ika,ila->ikl", u, u)
    iu, ju = np.triu_indices(k, 1)
    return 1.0 - 9.0 / (2.0 * k * (k - 1)) * ((g[:, iu, ju] + 1 / 3) ** 2
                                               ).sum(-1)


def test_tied_shell_takes_lower_indices():
    """A simple cubic lattice (spacing 2 A, exact): six neighbors tie at
    2 A and k = 4 takes four of them.  The port equals the JAX class and
    the lower-index oracle; the higher-index choice would differ."""

    g = np.arange(4, dtype=np.float32) * 2.0
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    ju, tu = _universes(pos[None], np.array([8.0] * 3 + [90.0] * 3))
    ref = jax_steinhardt.TetrahedralOrderParameter(ju.atoms,
                                                   verbose=False).run()
    ours = steinhardt.TetrahedralOrderParameter(tu.atoms, verbose=False,
                                                device="cpu").run()
    lower = _tetra_oracle(pos, 8.0, 4)
    higher = _tetra_oracle(pos, 8.0, 4, lowest=False)
    np.testing.assert_allclose(ours.results.q_tet[0], lower, rtol=0,
                               atol=QTET_ATOL)
    np.testing.assert_allclose(ref.results.q_tet[0], ours.results.q_tet[0],
                               rtol=0, atol=QTET_ATOL)
    assert np.abs(higher - lower).max() > 0.1


def test_spherical_matches_jax():
    rng = np.random.default_rng(4)
    u = rng.normal(size=(500, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    degrees = (1, 2, 4, 6, 8)
    ref = jax_spherical.real_sph_harm(degrees, u)
    np.testing.assert_array_equal(spherical.real_sph_harm(degrees, u), ref)
    for dtype, eps in ((torch.float64, np.finfo(np.float64).eps),
                       (torch.float32, EPS32)):
        got = spherical.real_sph_harm(degrees, torch.as_tensor(u, dtype=dtype))
        assert got.dtype == dtype
        expected = ref if dtype == torch.float64 else np.asarray(
            jax_spherical.real_sph_harm(degrees, jnp.asarray(u, jnp.float32),
                                        xp=jnp))
        np.testing.assert_allclose(got.numpy(), expected, rtol=0,
                                   atol=64 * eps)
    assert spherical.sph_harm_columns(degrees) == \
        jax_spherical.sph_harm_columns(degrees)
    for l in (2, 4, 6):
        block = rng.normal(size=(7, 2 * l + 1))
        np.testing.assert_array_equal(spherical.complex_from_real(l, block),
                                      jax_spherical.complex_from_real(l, block))
        np.testing.assert_array_equal(spherical.invariant_ql(l, block),
                                      jax_spherical.invariant_ql(l, block))
        np.testing.assert_array_equal(spherical.invariant_wl(l, block),
                                      jax_spherical.invariant_wl(l, block))
        assert spherical.wigner_3j_lll(l) == jax_spherical.wigner_3j_lll(l)
    assert spherical.wigner_3j(2, 3, 4, 1, -2, 1) == \
        jax_spherical.wigner_3j(2, 3, 4, 1, -2, 1)


def test_block_sizes():
    """The row blocks that every dense sweep of the port takes: contiguous,
    covering all rows, each ``(rows, n_cols, 3)`` intermediate within the
    device's budget (one row at the least), the CPU's budget below the
    card's."""

    cpu, card = _sweep_elements("cpu"), _sweep_elements("cuda")
    assert cpu < card
    for device, budget in (("cpu", cpu), ("cuda", card)):
        for n_rows, n_cols in ((5, 5), (100, 100), (9000, 9000),
                               (100_000, 100_000), (3000, 6000),
                               (1, 1), (0, 10)):
            blocks = _row_blocks(n_rows, n_cols, device)
            assert [lo for lo, _ in blocks] == \
                ([0] + [hi for _, hi in blocks[:-1]])[:len(blocks)]
            assert (blocks[-1][1] if blocks else 0) == n_rows
            sizes = [hi - lo for lo, hi in blocks]
            assert all(s > 0 for s in sizes)
            assert max(sizes, default=1) == 1 or \
                max(sizes) * n_cols * 3 <= budget
            # as few blocks as the budget allows
            assert len(blocks) == -(-n_rows // max(
                1, budget // (3 * n_cols)))


def test_validation_and_units(fluid):
    ju, tu = fluid["ortho"]
    boxless_j, boxless_t = _universes(
        np.zeros((1, 6, 3), np.float32) + np.arange(6, dtype=np.float32)[
            :, None], np.zeros(6))
    cases = [
        ("SteinhardtOrderParameter", (ju.atoms, 0.0), (tu.atoms, 0.0), {},
         "'cutoff' must be positive"),
        ("SteinhardtOrderParameter", (ju.atoms, 3.0, ()),
         (tu.atoms, 3.0, ()), {}, "'degrees'"),
        ("SteinhardtOrderParameter", (ju.atoms, 3.0, (0, 4)),
         (tu.atoms, 3.0, (0, 4)), {}, "'degrees'"),
        ("SteinhardtOrderParameter", (ju.atoms[:1], 3.0),
         (tu.atoms[:1], 3.0), {}, "at least 2 atoms"),
        ("SteinhardtOrderParameter", (boxless_j.atoms, 3.0),
         (boxless_t.atoms, 3.0), {}, "periodic box"),
        ("TetrahedralOrderParameter", (ju.atoms,), (tu.atoms,),
         dict(n_neighbors=1), "at least 2"),
        ("TetrahedralOrderParameter", (ju.atoms[:4],), (tu.atoms[:4],), {},
         "more atoms than"),
        ("TetrahedralOrderParameter", (boxless_j.atoms,),
         (boxless_t.atoms,), {}, "periodic box"),
    ]
    for name, jargs, targs, kwargs, match in cases:
        with pytest.raises(ValueError, match=match):
            getattr(jax_steinhardt, name)(*jargs, verbose=False, **kwargs)
        with pytest.raises(ValueError, match=match):
            getattr(steinhardt, name)(*targs, device="cpu", **kwargs)
    for name, args in (("SteinhardtOrderParameter", (tu.atoms, 3.0)),
                       ("TetrahedralOrderParameter", (tu.atoms,))):
        with pytest.raises(NotImplementedError, match="item 10"):
            getattr(steinhardt, name)(*args, parallel=True, device="cpu")
    # A Quantity cutoff, and times from the trajectory's dt (no time step
    # of the class's own, as in the JAX class).
    ref = jax_steinhardt.SteinhardtOrderParameter(
        ju.atoms, JQ(0.35, "nm"), verbose=False).run(stop=2)
    ours = steinhardt.SteinhardtOrderParameter(
        tu.atoms, Q_(0.35, "nm"), verbose=False, device="cpu").run(stop=2)
    np.testing.assert_array_equal(ours.results.n_neighbors,
                                  ref.results.n_neighbors)
    np.testing.assert_array_equal(ours.results.times, [0.0, 0.5])
