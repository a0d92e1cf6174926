"""The port's bonded distributions against the JAX package's.

Seeded float32 chains (``testing.polymer_chains``: 24 chains of 12
monomers, bonds of about 1 A, wrapped atom by atom) go through
``mdhelper_tpu.analysis.bonded`` (streaming float32: ``_coord_dtype`` on
its base class) and its port (``device="cpu"``), in chunks of 2 frames of
7 (a short last chunk), in the cube and wrapped into a triclinic cell, on
a subset of the chains (the terms of the topology's bonds within it).

* Bond lengths bin exactly: counts equal the JAX package's as integers,
  and a float64 oracle's (``numpy.histogram`` of the float64
  minimum-image lengths of the float32 coordinates).  On the straddle
  fixture (bonds at the edge 1.25 and one float32 ulp on either side) the
  port equals the float64 oracle and the JAX package's
  ``displacement_histogram_frame`` called alone; the JAX class does not
  (ROADMAP Queue 3, item 16).
* Angles and dihedrals are float32 in both packages, and ``arccos`` /
  ``arctan2`` round otherwise in torch and XLA, so a value within a few
  ulps of an edge can change bins.  On terms whose float64 values lie at
  least 1e-3 degrees from every edge (``explicit angles=``/``dihedrals=``
  lists) the counts equal the JAX package's and the float64 oracle's; on
  all the terms the sum of |count differences| stays within
  ``_delta_bound`` (two for each value within its float32 margin of an
  edge, at least 2) of both.  The margin
  (``testing.float32_angle_margin``) is a first-order bound on the
  rounding of the fold, the cosine or the normals, ``arccos`` or
  ``atan2`` and the conversion to degrees, a few 1e-4 degrees for most
  values; the port's float32 values lie within it of the float64 oracle.
* Means and standard deviations: the port sums in float64, the JAX
  package each frame in float32; within ``rtol=1e-6`` of the JAX class.
  Angles sum their float32 values: within 2e-7 (mean) and 2e-6 (std) of
  the float64 oracle, the float32 values' own rounding.  Lengths sum the
  float64 roots of the exact squared lengths they were binned from:
  within 1e-12 (mean) and 1e-10 (std) of the float64 oracle.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import bonded as jax_bonded  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.algorithm.topology import (  # noqa: E402
    triclinic_matrices,
)
from mdhelper_tpu_torch.analysis import bonded  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.testing import (  # noqa: E402
    edge_straddle_positions,
    float32_angle_margin,
    polymer_chains,
)

N_CHAINS, N_MONO, T, CHUNK = 24, 12, 7, 2
BOX = 14.0
ORTHO = np.array([BOX] * 3 + [90.0] * 3)
TRICLINIC = np.array([BOX, BOX, BOX, 80.0, 75.0, 70.0])
#: the subset: chains 3-18
SUBSET = slice(3 * N_MONO, 19 * N_MONO)
EDGE_MARGIN = 1e-3  # degrees


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


def _bonds():
    return np.array([(c * N_MONO + i, c * N_MONO + i + 1)
                     for c in range(N_CHAINS) for i in range(N_MONO - 1)])


def _universes(frames, dims, **topology):
    return (JaxUniverse.from_arrays(frames.astype(np.float64), dims,
                                    **topology),
            Universe.from_arrays(frames, dims, **topology))


@pytest.fixture(scope="module")
def chains():
    """``{box: (frames, jax universe, port universe)}``."""

    frames, unwrapped = polymer_chains(np.random.default_rng(2041), N_CHAINS,
                                       N_MONO, T, BOX, stiffness=0.5)
    h = triclinic_matrices(TRICLINIC[None])[0]
    frac = unwrapped @ np.linalg.inv(h)
    tri = ((frac - np.floor(frac)) @ h).astype(np.float32)
    out = {}
    for name, f, dims in (("ortho", frames, ORTHO),
                          ("triclinic", tri, TRICLINIC)):
        out[name] = (f, *_universes(f, dims, bonds=_bonds()))
    return out


def _min_image64(v, dims):
    """float64 minimum images (the 27-image search in a triclinic cell) in
    the box rounded to float32, the box the classes fold by."""

    if np.allclose(dims[3:], 90.0):
        box = np.float32(dims[:3]).astype(np.float64)
        return v - box * np.round(v / box)
    h = triclinic_matrices(np.asarray(dims, float)[None])[0]
    h = h.astype(np.float32).astype(np.float64)
    frac = v @ np.linalg.inv(h)
    base = (frac - np.round(frac)) @ h
    best, best_d2 = base.copy(), (base**2).sum(-1)
    for s in np.array(np.meshgrid(*[[-1, 0, 1]] * 3)).T.reshape(-1, 3):
        cand = base + s.astype(float) @ h
        d2 = (cand**2).sum(-1)
        take = d2 < best_d2
        best[take], best_d2 = cand[take], np.minimum(best_d2, d2)
    return best


def _oracle_values(kind, frames, terms, dims, *, with_margin=False):
    """float64 lengths, angles or dihedrals (degrees) of the float32
    `frames` ``(T, N, 3)`` for `terms` ``(M, k)``, shape ``(T, M)``; with
    `with_margin`, also each angle's or dihedral's float32 margin
    (``testing.float32_angle_margin``: the fold rounds by ``u`` of the raw
    vector in the cube, by ``4 kappa u`` of the raw and folded vectors in
    the triclinic cell)."""

    p = frames.astype(np.float64)[:, terms]
    raws, folds = [], []

    def mi(v):
        folded = _min_image64(v.reshape(-1, 3), dims).reshape(v.shape)
        raws.append(v)
        folds.append(folded)
        return folded

    if kind == "length":
        return np.linalg.norm(mi(p[..., 0, :] - p[..., 1, :]), axis=-1)
    if kind == "angle":
        v1 = mi(p[..., 0, :] - p[..., 1, :])
        v2 = mi(p[..., 2, :] - p[..., 1, :])
        cos = (v1 * v2).sum(-1) / np.sqrt((v1 * v1).sum(-1)
                                          * (v2 * v2).sum(-1))
        values = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    else:
        b1 = mi(p[..., 1, :] - p[..., 0, :])
        b2 = mi(p[..., 2, :] - p[..., 1, :])
        b3 = mi(p[..., 3, :] - p[..., 2, :])
        n1, n2 = np.cross(b1, b2), np.cross(b2, b3)
        m1 = np.cross(n1, b2 / np.linalg.norm(b2, axis=-1)[..., None])
        values = np.degrees(np.arctan2((m1 * n2).sum(-1),
                                       (n1 * n2).sum(-1)))
    if not with_margin:
        return values
    u = 2.0**-24
    if np.allclose(dims[3:], 90.0):
        fold_eps = u
    else:
        h = triclinic_matrices(np.asarray(dims, float)[None])[0]
        fold_eps = 4.0 * np.linalg.cond(h.astype(np.float32)
                                        .astype(np.float64)) * u
    return values, float32_angle_margin(
        kind, np.stack(raws, axis=-2), np.stack(folds, axis=-2), values,
        fold_eps)


CLASSES = {
    "length": ("BondLengthDistribution", "bonds",
               dict(n_bins=60, range=(0.0, 3.0))),
    "angle": ("BondAngleDistribution", "angles", dict(n_bins=90)),
    "dihedral": ("DihedralDistribution", "dihedrals", dict(n_bins=72)),
}


def _pair(universes, kind, group=slice(None), **kwargs):
    """(jax result, port result) of `kind` on the atoms `group`, in chunks
    of CHUNK frames."""

    name, _, options = CLASSES[kind]
    options = {**options, **kwargs}
    out = []
    for module, u, device in ((jax_bonded, universes[1], {}),
                              (bonded, universes[2], {"device": "cpu"})):
        a = getattr(module, name)(u.atoms[group], verbose=False, **options,
                                  **device)
        a._chunk_bytes = CHUNK * len(a._atom_indices) * 3 * 4
        out.append(a.run())
    return out


def _terms(kind, bonds):
    if kind == "length":
        return bonds
    derive = bonded.derive_angles if kind == "angle" else (
        bonded.derive_dihedrals)
    return derive(bonds)


def _delta_bound(values, edges, margin):
    """Two for each value within its float32 `margin` of an edge (its bin
    may differ, moving one count between two bins), at least 2."""

    near = np.abs(values.ravel()[:, None] - edges[None, :]).min(axis=1)
    return max(2, 2 * int((near < margin.ravel()).sum()))


def _subset_bonds(universe):
    bonds = universe._topology.bonds
    ix = universe.atoms[SUBSET].ix
    return bonds[np.isin(bonds, ix).all(axis=1)]


@pytest.mark.parametrize("box", ["ortho", "triclinic"])
@pytest.mark.parametrize("kind", ["length", "angle", "dihedral"])
def test_subset_matches_jax_and_f64(chains, box, kind):
    frames, ju, tu = chains[box]
    ref, port = _pair((frames, ju, tu), kind, SUBSET)
    terms = _terms(kind, _subset_bonds(tu))
    np.testing.assert_array_equal(port._terms, ref._terms)
    np.testing.assert_array_equal(port._atom_indices, ref._atom_indices)
    np.testing.assert_array_equal(port.results.edges, ref.results.edges)
    np.testing.assert_array_equal(port.results.bins, ref.results.bins)
    if kind == "length":
        values = _oracle_values(kind, frames, terms, tu.dimensions)
    else:
        values, margin = _oracle_values(kind, frames, terms, tu.dimensions,
                                        with_margin=True)
    oracle = np.histogram(values, bins=port.results.edges)[0]
    if kind == "length":
        np.testing.assert_array_equal(port.results.counts, ref.results.counts)
        np.testing.assert_array_equal(port.results.counts, oracle)
    else:
        bound = _delta_bound(values, port.results.edges, margin)
        assert np.abs(port.results.counts - ref.results.counts).sum() <= bound
        assert np.abs(port.results.counts - oracle).sum() <= bound
    assert port.results.counts.sum() == values.size
    np.testing.assert_allclose(port.results.probability,
                               ref.results.probability, rtol=1e-6,
                               atol=1e-6 * ref.results.probability.max())
    if kind != "dihedral":
        np.testing.assert_allclose(port.results.mean, ref.results.mean,
                                   rtol=1e-6)
        np.testing.assert_allclose(port.results.std, ref.results.std,
                                   rtol=1e-6)
        exact = kind == "length"
        np.testing.assert_allclose(port.results.mean, values.mean(),
                                   rtol=1e-12 if exact else 2e-7)
        np.testing.assert_allclose(port.results.std, values.std(),
                                   rtol=1e-10 if exact else 2e-6)
    assert set(port.results.units) == set(ref.results.units)


@pytest.mark.parametrize("box", ["ortho", "triclinic"])
@pytest.mark.parametrize("kind", ["angle", "dihedral"])
def test_terms_clear_of_edges_bin_equal(chains, box, kind):
    """Explicit term lists whose float64 values stay EDGE_MARGIN degrees
    from every edge in every frame: counts equal the JAX package's and the
    float64 oracle's."""

    frames, ju, tu = chains[box]
    _, keyword, options = CLASSES[kind]
    terms = _terms(kind, tu._topology.bonds)
    edges = np.linspace(-180.0 if kind == "dihedral" else 0.0, 180.0,
                        options["n_bins"] + 1)
    values = _oracle_values(kind, frames, terms, tu.dimensions)
    near = np.abs(values[..., None] - edges).min(axis=(0, 2))
    clear = terms[near >= EDGE_MARGIN]
    assert len(clear) > 0.8 * len(terms)
    ref, port = _pair((frames, ju, tu), kind, **{keyword: clear})
    oracle = np.histogram(_oracle_values(kind, frames, clear,
                                         tu.dimensions), bins=edges)[0]
    np.testing.assert_array_equal(port.results.counts, ref.results.counts)
    np.testing.assert_array_equal(port.results.counts, oracle)


@pytest.mark.parametrize("box", ["ortho", "triclinic"])
@pytest.mark.parametrize("kind", ["angle", "dihedral"])
def test_float32_values_within_margin(chains, box, kind):
    """The float32 angles and dihedrals the port bins lie within their
    ``float32_angle_margin`` of the float64 oracle's values, on every term
    (the premise of ``_delta_bound``)."""

    from mdhelper_tpu_torch.analysis.structure import _frame_boxes

    frames, _, tu = chains[box]
    name, keyword, options = CLASSES[kind]
    terms = _terms(kind, tu._topology.bonds)
    a = getattr(bonded, name)(tu.atoms, verbose=False, device="cpu",
                              **options, **{keyword: terms})
    a._prepare()
    dims = torch.tensor(np.array([tu.dimensions] * len(frames)),
                        dtype=torch.float64)
    pos = torch.from_numpy(frames)
    ends = [pos[:, terms[:, c]] for c in range(terms.shape[1])]
    port = a._values_fn()(
        ends, _frame_boxes(dims, a._triclinic)[0][:, None])[1].double()
    values, margin = _oracle_values(kind, frames, terms, tu.dimensions,
                                    with_margin=True)
    err = np.abs(port.numpy() - values)
    if kind == "dihedral":
        err = np.minimum(err, 360.0 - err)
    assert (err <= margin).all(), (err / margin).max()
    assert np.median(margin) < 1e-3


def test_bond_lengths_on_straddle_fixture():
    """Bonds at the edge 1.25 (10 bins on [0, 2.5]) and one float32 ulp
    either side: counts equal the float64 oracle's as integers.  The JAX
    class bins most of them below the edge: inside its compiled per-frame
    map XLA's CPU backend contracts the double-float products and sums
    into fused multiply-adds, which breaks their error terms (ROADMAP
    Queue 3, item 16); its function called alone bins them as the port
    does."""

    from mdhelper_tpu.ops.histogram import (
        displacement_histogram_frame as jax_displacement_histogram_frame,
    )

    frames = np.stack([edge_straddle_positions(np.random.default_rng(seed),
                                               BOX) for seed in (404, 405)])
    # each anchor-partner pair in both directions
    bonds = np.stack([np.arange(90), 300 + np.arange(90)], axis=1)
    bonds = np.concatenate([bonds, bonds[:, ::-1]])
    dims = ORTHO
    ju, tu = _universes(frames, dims, bonds=bonds)
    ref, port = _pair((frames, ju, tu), "length", n_bins=10,
                      range=(0.0, 2.5))
    oracle = np.histogram(_oracle_values("length", frames, bonds, dims),
                          bins=port.results.edges)[0]
    np.testing.assert_array_equal(port.results.counts, oracle)
    assert port.results.counts[4] > 0 and port.results.counts[5] > 0
    alone = sum(np.asarray(jax_displacement_histogram_frame(
        jnp.asarray(f[bonds[:, 0]]), jnp.asarray(f[bonds[:, 1]]),
        jnp.asarray([BOX] * 3, jnp.float32), jnp.asarray(ref.results.edges),
        precision="exact")) for f in frames)
    np.testing.assert_array_equal(port.results.counts, alone)


def test_derived_terms_match_jax():
    rng = np.random.default_rng(5)
    bonds = np.concatenate([_bonds(), rng.integers(0, 200, (40, 2))])
    bonds = bonds[bonds[:, 0] != bonds[:, 1]]
    np.testing.assert_array_equal(bonded.derive_angles(bonds),
                                  jax_bonded.derive_angles(bonds))
    np.testing.assert_array_equal(bonded.derive_dihedrals(bonds),
                                  jax_bonded.derive_dihedrals(bonds))
    assert bonded.derive_angles(np.array([(5, 6)])).shape == (0, 3)
    assert bonded.derive_dihedrals(np.array([(0, 1), (1, 2)])).shape == (0, 4)


@pytest.mark.parametrize("kind", ["length", "angle", "dihedral"])
def test_explicit_terms_and_reduced_units(chains, kind):
    """Explicit terms on a bond-less topology (absolute indices of a
    subset) and ``reduced=True``, as the JAX classes take them."""

    frames, _, tu = chains["ortho"]
    _, keyword, _ = CLASSES[kind]
    terms = _terms(kind, _bonds())[::3]
    ju, tu = _universes(frames, ORTHO)
    ref, port = _pair((frames, ju, tu), kind, **{keyword: terms},
                      reduced=True)
    assert "units" not in port.results and "units" not in ref.results
    if kind == "length":
        bound = 0
    else:
        values, margin = _oracle_values(kind, frames, terms, ORTHO,
                                        with_margin=True)
        bound = _delta_bound(values, port.results.edges, margin)
    assert np.abs(port.results.counts - ref.results.counts).sum() <= bound


def test_validation():
    frames = np.zeros((1, 4, 3), np.float32)
    ju, tu = _universes(frames, ORTHO)
    for module, u, device in ((jax_bonded, ju, {}),
                              (bonded, tu, {"device": "cpu"})):
        for name in ("BondLengthDistribution", "BondAngleDistribution",
                     "DihedralDistribution"):
            with pytest.raises(ValueError, match="No bonded terms"):
                getattr(module, name)(u.atoms, verbose=False, **device)
    with pytest.raises(NotImplementedError, match="item 10"):
        bonded.BondLengthDistribution(tu.atoms, bonds=[[0, 1]],
                                      parallel=True, device="cpu")
