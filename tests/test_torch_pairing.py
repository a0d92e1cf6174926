"""The port's IonPairAnalysis against the JAX package's and float64 oracles.

The same seeded float32 trajectories go through
``mdhelper_tpu.analysis.pairing`` (streaming float32: ``_coord_dtype`` on
its base class, on the CPU) and its port (``device="cpu"``), in chunks of
2 frames of 7 (a short last chunk).

* Atom groupings: counts, partners (the coordination times the frame
  count), free fractions and ``pair_counts`` equal the JAX class's as
  integers, in a cube and a triclinic cell, for two ion groups, a subset
  group, the like-ion case (one group twice: unordered pairs, a symmetric
  ``pair_counts``) and partially overlapping groups (ordered pairs).  The
  squared norm is formed as XLA's CPU backend forms it
  (``ops/histogram.py::_norm2``), so pairs at a few ulps of the cutoff in
  random directions decide as in the JAX class; along a box axis (exact
  differences and folds) pairs one float32 ulp either side of the cutoff
  and on it also equal a float64 oracle, in the cube and in a triclinic
  cell whose first edge is a power of two.
* Residue centers: the JAX class's compiled update rounds a center
  otherwise than the port's fixed-order reduction (ROADMAP Queue 3, item
  12), so counts are equal on an ionic-liquid fixture whose center
  distances stay at least 4 eps32 max|r| clear of the cutoff (checked
  here), and equal a float64 oracle of the centers there.
* Lifetimes: c(t) and S(t) within 1e-12 of the JAX class's and of the
  port's ``existence_lifetimes`` of the float64 oracle's existence series.
* Validation errors, units and reduced units, ``parallel=True``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu import Q_ as JQ  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import pairing as jax_pairing  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.algorithm.topology import (  # noqa: E402
    triclinic_matrices,
)
from mdhelper_tpu_torch.analysis import pairing  # noqa: E402
from mdhelper_tpu_torch.analysis.base import existence_lifetimes  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.testing import ionic_liquid  # noqa: E402

T, CHUNK, N1, N2 = 7, 2, 60, 50
BOX = 14.0
TRICLINIC = [BOX] * 3 + [80.0, 75.0, 70.0]
CUT = 3.5
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_streams_float32(monkeypatch):
    monkeypatch.setattr(jax_base.SerialAnalysisBase, "_coord_dtype",
                        np.float32)


def _universes(frames, dims, **topology):
    return (JaxUniverse.from_arrays(frames.astype(np.float64), dims,
                                    **topology),
            Universe.from_arrays(frames, dims, **topology))


def _wrap_triclinic(frames, dims):
    h = triclinic_matrices(np.asarray(dims, float)[None])[0]
    frac = frames.astype(np.float64) @ np.linalg.inv(h)
    return ((frac - np.floor(frac)) @ h).astype(np.float32)


@pytest.fixture(scope="module")
def ions():
    """``{box: (jax universe, port universe)}``: 110 ions on a random walk
    in the cube, and wrapped into a triclinic cell."""

    rng = np.random.default_rng(2057)
    start = rng.random((N1 + N2, 3)) * BOX
    walk = start + np.cumsum(rng.normal(0.0, 0.4, (T, N1 + N2, 3)), axis=0)
    frames = np.mod(walk, BOX).astype(np.float32)
    cube = np.array([BOX] * 3 + [90.0] * 3)
    tri = _wrap_triclinic(frames, TRICLINIC)
    return {
        "cube": (*_universes(frames, cube), frames, cube),
        "triclinic": (*_universes(tri, np.asarray(TRICLINIC)), tri,
                      np.asarray(TRICLINIC)),
    }


def _run(cls, *args, **kwargs):
    a = cls(*args, verbose=False, **kwargs)
    a._chunk_bytes = CHUNK * len(a._atom_indices) * 3 * 4
    return a.run()


def assert_equal_pairing(ref, out, n_frames=T):
    """Integers as integers: counts, partners, free counts and pair
    counts; the lifetime functions within 1e-12."""

    np.testing.assert_array_equal(out.results.counts, ref.results.counts)
    assert out.results.mean_count == ref.results.mean_count
    for r, o in zip(ref.results.coordination, out.results.coordination):
        np.testing.assert_array_equal(np.rint(o * n_frames),
                                      np.rint(r * n_frames))
        np.testing.assert_array_equal(o, r)
    np.testing.assert_array_equal(out.results.free_fractions,
                                  ref.results.free_fractions)
    if "pair_counts" in ref.results:
        np.testing.assert_array_equal(out.results.pair_counts,
                                      ref.results.pair_counts)
        assert out.results.pair_counts.dtype == np.int64
    if "lifetime" in ref.results:
        np.testing.assert_allclose(out.results.lifetime,
                                   ref.results.lifetime, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(out.results.survival,
                                   ref.results.survival, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_array_equal(out.results.lifetime_times,
                                      ref.results.lifetime_times)


# (selections of the two groups, keyword arguments)
CASES = {
    "cations_anions": (lambda u: (u.atoms[:N1], u.atoms[N1:]),
                       dict(pair_counts=True, lifetimes=True)),
    "subset": (lambda u: (u.atoms[5:40:3], u.atoms[N1 + 7:]),
               dict(pair_counts=True)),
    "like_ions": (lambda u: (u.atoms[:N1], u.atoms[:N1]),
                  dict(pair_counts=True, lifetimes=True)),
    "overlapping": (lambda u: (u.atoms[:70], u.atoms[40:]),
                    dict(pair_counts=True)),
}


@pytest.mark.parametrize("box", ["cube", "triclinic"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_atoms_equal_jax(ions, box, case):
    ju, tu, frames, dims = ions[box]
    select, kwargs = CASES[case]
    ref = _run(jax_pairing.IonPairAnalysis, *select(ju), CUT, **kwargs)
    out = _run(pairing.IonPairAnalysis, *select(tu), CUT, device="cpu",
               **kwargs)
    assert_equal_pairing(ref, out)
    if case == "like_ions":
        assert out._symmetric
        pc = out.results.pair_counts
        np.testing.assert_array_equal(pc, pc.T)
        assert not np.diagonal(pc).any()
    if case in ("like_ions", "overlapping"):
        # against the float64 oracle: both orders of every pair, self
        # pairs excluded
        g1, g2 = out._groups
        for t in range(T):
            pos = frames[t].astype(np.float64)
            w = _oracle_within(pos[g1.ix], pos[g2.ix], dims)
            w &= g1.ix[:, None] != g2.ix[None, :]
            half = 2 if case == "like_ions" else 1
            assert out.results.counts[t] * half == w.sum()
    if case == "overlapping":
        assert out._not_self is not None and not out._symmetric


def _oracle_within(p1, p2, dims, cutoff=CUT):
    """float64 (N1, N2) contacts under the minimum image of `dims` (the 27
    images of a triclinic cell)."""

    h = triclinic_matrices(np.asarray(dims, float)[None])[0]
    delta = p2[None, :, :] - p1[:, None, :]
    frac = delta @ np.linalg.inv(h)
    base = (frac - np.round(frac)) @ h
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], dtype=float) @ h
    d2 = ((base[..., None, :] + shifts) ** 2).sum(-1).min(-1)
    return d2 <= cutoff * cutoff


@pytest.mark.parametrize("box", ["cube", "triclinic"])
def test_atoms_equal_f64_oracle(ions, box):
    ju, tu, frames, dims = ions[box]
    out = _run(pairing.IonPairAnalysis, tu.atoms[:N1], tu.atoms[N1:], CUT,
               pair_counts=True, lifetimes=True, device="cpu")
    h = []
    pair = np.zeros((N1, N2), dtype=np.int64)
    for t in range(T):
        pos = frames[t].astype(np.float64)
        w = _oracle_within(pos[:N1], pos[N1:], dims)
        assert out.results.counts[t] == w.sum()
        np.testing.assert_array_equal(
            out.results.free_fractions[t],
            [(w.sum(1) == 0).sum() / N1, (w.sum(0) == 0).sum() / N2])
        pair += w
        h.append(w.ravel())
    np.testing.assert_array_equal(out.results.pair_counts, pair)
    c, s = existence_lifetimes(np.stack(h), device="cpu")
    np.testing.assert_allclose(out.results.lifetime, c, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(out.results.survival, s, rtol=1e-12,
                               atol=1e-12)


# -- straddle fixtures ------------------------------------------------------

SLOT = 8.0
STRADDLE_BOX = 64.0
# a triclinic cell whose first edge is a power of two: a displacement
# along x folds exactly (1/64 and its products are exact)
STRADDLE_TRICLINIC = [STRADDLE_BOX, 60.0, 62.0, 80.0, 75.0, 90.0]


def _straddle_system(axis_only, seed=2063):
    """``(frames, n_pairs)``: pairs in slots 8 A apart (every other pair
    farther than the cutoff plus 1 A), one pair a slot, group 1 the
    first atoms.  Along x: ``p1.x = -1.75``, ``p2.x = 1.75 + k 2^-22``
    for k in (-1, 0, 1) (or mirrored), so ``p2 - p1 = 3.5 + k ulp``
    exactly; otherwise a random direction at 3.5 +- a few ulps."""

    rng = np.random.default_rng(seed)
    slots = np.stack(np.meshgrid(np.arange(1, 7), np.arange(1, 7),
                                 indexing="ij"), -1).reshape(-1, 2) * SLOT
    n = len(slots)
    frames = []
    for t in range(3):
        p1 = np.zeros((n, 3), dtype=np.float32)
        p2 = np.zeros((n, 3), dtype=np.float32)
        p1[:, 1:] = slots
        p2[:, 1:] = slots
        if axis_only:
            k = np.float32(t - 1) * np.float32(2.0**-22)
            sign = np.where(np.arange(n) % 2, 1.0, -1.0).astype(np.float32)
            p1[:, 0] = -1.75 * sign
            p2[:, 0] = (np.float32(1.75) + k) * sign
            assert (p2[:, 0].astype(np.float64) - p1[:, 0]
                    == (3.5 + float(k)) * sign).all()
        else:
            u = rng.normal(size=(n, 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            d = 3.5 + rng.integers(-3, 4, n) * 2.0**-22
            p1[:] = p1 + 20.0
            p2[:] = (p1.astype(np.float64) + d[:, None] * u).astype(
                np.float32)
        frames.append(np.concatenate((p1, p2)))
    return np.stack(frames), n


@pytest.mark.parametrize("box", ["cube", "triclinic", "cube_random"])
def test_straddle_pairs_equal_jax_and_f64(box):
    frames, n = _straddle_system(axis_only=box != "cube_random")
    dims = (np.asarray(STRADDLE_TRICLINIC) if box == "triclinic"
            else np.array([STRADDLE_BOX] * 3 + [90.0] * 3))
    ju, tu = _universes(frames, dims)
    kw = dict(pair_counts=True, lifetimes=True)
    ref = _run(jax_pairing.IonPairAnalysis, ju.atoms[:n], ju.atoms[n:],
               CUT, **kw)
    out = _run(pairing.IonPairAnalysis, tu.atoms[:n], tu.atoms[n:], CUT,
               device="cpu", **kw)
    assert_equal_pairing(ref, out, n_frames=3)
    if box == "cube_random":
        # ties in every direction: some pairs decide by the fused norm
        assert 0 < out.results.counts.sum() < 3 * n
        return
    # one ulp under the cutoff: every pair; on it: every pair; over: none
    np.testing.assert_array_equal(out.results.counts, [n, n, 0])
    for t in range(3):
        pos = frames[t].astype(np.float64)
        w = _oracle_within(pos[:n], pos[n:], dims)
        assert out.results.counts[t] == w.sum()


def test_like_ions_on_the_cutoff_symmetric():
    """The same group twice, pairs on the cutoff and an ulp either side,
    in both orders: the contact matrix stays symmetric, so the halved
    counts are whole pairs, and equal the JAX class's."""

    frames, n = _straddle_system(axis_only=True)
    for dims in (np.array([STRADDLE_BOX] * 3 + [90.0] * 3),
                 np.asarray(STRADDLE_TRICLINIC)):
        ju, tu = _universes(frames, dims)
        ref = _run(jax_pairing.IonPairAnalysis, ju.atoms, ju.atoms, CUT,
                   pair_counts=True)
        out = _run(pairing.IonPairAnalysis, tu.atoms, tu.atoms, CUT,
                   pair_counts=True, device="cpu")
        assert_equal_pairing(ref, out, n_frames=3)
        pc = out.results.pair_counts
        np.testing.assert_array_equal(pc, pc.T)
        np.testing.assert_array_equal(out.results.counts, [n, n, 0])


# -- residue centers ------------------------------------------------------------


@pytest.fixture(scope="module")
def liquid():
    frames, topology, box = ionic_liquid(np.random.default_rng(2069), 32, T)
    dims = np.array([box] * 3 + [90.0] * 3)
    return frames, topology, dims


def _centers_f64(frame, topology, ix):
    res = topology["resindices"][ix]
    m = topology["masses"][ix]
    ids, inv = np.unique(res, return_inverse=True)
    total = np.zeros((len(ids), 3))
    np.add.at(total, inv, m[:, None] * frame[ix].astype(np.float64))
    return total / np.bincount(inv, weights=m)[:, None]


@pytest.mark.parametrize("cutoff", [6.4, 8.0])
def test_residue_centers_equal_jax_and_f64(liquid, cutoff):
    frames, topology, dims = liquid
    ju, tu = _universes(frames, dims, **topology)
    n_cat = 5 * 32
    cat = np.arange(n_cat)
    an = np.arange(n_cat, frames.shape[1])
    kw = dict(pair_counts=True, lifetimes=True)
    ref = _run(jax_pairing.IonPairAnalysis, ju.atoms[cat], ju.atoms[an],
               cutoff, "residues", **kw)
    out = _run(pairing.IonPairAnalysis, tu.atoms[cat], tu.atoms[an],
               cutoff, "residues", device="cpu", **kw)
    # the fixture keeps every center distance clear of the cutoff
    margin = 4 * EPS32 * float(np.abs(frames).max())
    for t in range(T):
        c1 = _centers_f64(frames[t], topology, cat)
        c2 = _centers_f64(frames[t], topology, an)
        delta = c2[None] - c1[:, None]
        delta -= dims[:3] * np.round(delta / dims[:3])
        d = np.sqrt((delta**2).sum(-1))
        assert np.abs(d - cutoff).min() > margin
        w = d <= cutoff
        assert out.results.counts[t] == w.sum()
    assert_equal_pairing(ref, out)
    assert out.results.counts.min() > 0


def test_mixed_groupings_equal_jax(liquid):
    frames, topology, dims = liquid
    ju, tu = _universes(frames, dims, **topology)
    n_cat = 5 * 32
    ref = _run(jax_pairing.IonPairAnalysis, ju.atoms[:n_cat],
               ju.atoms[n_cat:], 5.0, ("residues", "atoms"))
    out = _run(pairing.IonPairAnalysis, tu.atoms[:n_cat], tu.atoms[n_cat:],
               5.0, ("residues", "atoms"), device="cpu")
    assert_equal_pairing(ref, out)


# -- options and errors ---------------------------------------------------------


def test_units_and_reduced(ions):
    ju, tu = ions["cube"][:2]
    a = _run(pairing.IonPairAnalysis, tu.atoms[:N1], tu.atoms[N1:],
             Q_(0.35, "nm"), lifetimes=True, device="cpu")
    b = _run(pairing.IonPairAnalysis, tu.atoms[:N1], tu.atoms[N1:], CUT,
             device="cpu")
    np.testing.assert_array_equal(a.results.counts, b.results.counts)
    ref = _run(jax_pairing.IonPairAnalysis, ju.atoms[:N1], ju.atoms[N1:],
               JQ(0.35, "nm"), lifetimes=True)
    assert set(a.results.units) == set(ref.results.units)
    for key in ref.results.units:
        assert str(a.results.units[key]) == str(ref.results.units[key])
    red = _run(pairing.IonPairAnalysis, tu.atoms[:N1], tu.atoms[N1:], CUT,
               reduced=True, lifetimes=True, device="cpu")
    assert "units" not in red.results
    np.testing.assert_array_equal(red.results.counts, b.results.counts)


def test_validation(ions):
    tu = ions["cube"][1]
    g1, g2 = tu.atoms[:N1], tu.atoms[N1:]
    with pytest.raises(ValueError, match="cutoff"):
        pairing.IonPairAnalysis(g1, g2, -1.0, device="cpu")
    with pytest.raises(ValueError, match="groupings"):
        pairing.IonPairAnalysis(g1, g2, CUT, "molecules", device="cpu")
    with pytest.raises(ValueError, match="groupings"):
        pairing.IonPairAnalysis(g1, g2, CUT, ("atoms",), device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        pairing.IonPairAnalysis(g1[:0], g2, CUT, device="cpu")
    # parallel=True is taken (ROADMAP Queue 1, item 10b-2)
    assert pairing.IonPairAnalysis(g1, g2, CUT, parallel=True,
                                   device="cpu")._parallel
