"""Center-of-mass groupings in the port's analyses against the JAX package.

One seeded molecular system goes through both packages: 60 molecules of
1, 3 and 4 atoms (the 4-atom ones a bonded chain) with mixed masses, their
residue labels a permutation of 0..59 (so ascending-label order is not
the order of appearance), two segments, every atom wrapped into the box
(molecules straddle its faces), and one 3-atom molecule within a few ulps
of the box edge in every frame.  The JAX side streams float32
(``_coord_dtype``), as the port does.

* The port's center-of-mass reduction equals the JAX package's
  ``_com_positions`` bit for bit (residues and segments, whole, interleaved
  and partial groups).
* RDF and Van Hove counts equal the JAX classes' as integers: self and
  cross sweeps, mixed groupings, entity-index exclusion tiles, interleaved
  labels, partial residues, a triclinic box.
* S(q) and the ISF agree within the S(q) gate (``rtol=1e-4, atol=1e-5``).
* ``Onsager(groupings="residues", unwrap=True)`` with bonds agrees with
  the JAX class within ``rtol=1e-8`` (float64 FFTs of the same float32
  entity positions; lag 0 is 0 up to float64 cancellation, hence the
  absolute floor of 1e-9 of the largest value that
  ``tests/test_torch_slice.py`` uses).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import structure as jax_structure  # noqa: E402
from mdhelper_tpu.analysis.transport import Onsager as JaxOnsager  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.algorithm.topology import (  # noqa: E402
    triclinic_vectors,
)
from mdhelper_tpu_torch.analysis import structure  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.transport import Onsager  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N_MOL, N_FRAMES, CHUNK = 60, 8, 3
SIZES = (1, 3, 4)
BOX = 11.0
ORTHO = np.array([BOX] * 3 + [90.0] * 3)
TRICLINIC = np.array([BOX, BOX, BOX, 70.0, 80.0, 90.0])
R_MAX, N_BINS = 3.5, 35
GATE = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def molecular_system(dims, seed=2031):
    """``(float32 frames, topology keywords)`` of the module's system in a
    box of parameters `dims`: rigid molecules on a random walk of 0.25 A
    steps with 0.03 A intramolecular jitter, each atom wrapped into the
    cell (fractional coordinates in [0, 1))."""

    rng = np.random.default_rng(seed)
    sizes = np.resize(SIZES, N_MOL)
    mol = np.repeat(np.arange(N_MOL), sizes)
    n_atoms = len(mol)
    first = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    # Chains: each atom after a molecule's first bonds to the one before.
    rank = np.arange(n_atoms) - first[mol]
    bonds = np.stack([np.flatnonzero(rank > 0) - 1,
                      np.flatnonzero(rank > 0)], axis=1)
    offsets = rng.normal(0.0, 1.0, (n_atoms, 3))
    offsets /= np.linalg.norm(offsets, axis=1, keepdims=True)
    offsets[rank == 0] = 0.0
    offsets = np.cumsum(offsets, axis=0)
    offsets -= offsets[first[mol]]  # each chain from its first atom
    h = triclinic_vectors(dims)
    centers = rng.random((N_MOL, 3)) @ h + np.cumsum(
        rng.normal(0.0, 0.25, (N_FRAMES, N_MOL, 3)), axis=0)
    centers[:, 2, 0] = 0.2 + 0.01 * np.arange(N_FRAMES)  # straddles x = 0
    pos = centers[:, mol] + offsets + rng.normal(
        0.0, 0.03, (N_FRAMES, n_atoms, 3))
    frac = pos @ np.linalg.inv(h)
    pos = ((frac - np.floor(frac)) @ h).astype(np.float32)
    # Molecule 1 (3 atoms) a few ulps under the box edge in x.
    edge = np.float32(BOX)
    for k, atom in enumerate(np.flatnonzero(mol == 1)):
        pos[:, atom, 0] = np.nextafter(edge, np.float32(0.0))
        for _ in range(k):
            pos[:, atom, 0] = np.nextafter(pos[:, atom, 0], np.float32(0.0))
    topology = dict(
        masses=rng.choice([1.008, 12.011, 14.007, 15.999, 22.99], n_atoms),
        resindices=rng.permutation(N_MOL)[mol],
        segindices=mol % 2,
        bonds=bonds,
    )
    return pos, topology


@pytest.fixture(scope="module")
def systems():
    """``{"ortho": ..., "triclinic": ...}`` of ``(jax universe, port
    universe, frames)``."""

    out = {}
    for name, dims in (("ortho", ORTHO), ("triclinic", TRICLINIC)):
        frames, topology = molecular_system(dims)
        out[name] = (
            JaxUniverse.from_arrays(frames.astype(np.float64), dims, dt=0.5,
                                    **topology),
            Universe.from_arrays(frames, dims, dt=0.5, **topology),
            frames,
        )
    return out


def _width(analysis, universe):
    idx = analysis._atom_indices
    return universe.atoms.n_atoms if idx is None else len(idx)


def _run_jax(analysis, **frames):
    analysis._chunk_bytes = CHUNK * _width(analysis, analysis.universe) * 12
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        return analysis.run(**frames)


def _run_port(analysis, **frames):
    analysis._chunk_bytes = CHUNK * _width(analysis, analysis.universe) * 12
    return analysis.run(**frames)


GROUPS = {
    "all": lambda u: u.atoms,
    # Residue members interleaved in group order.
    "interleaved": lambda u: u.atoms[
        np.random.default_rng(5).permutation(u.atoms.n_atoms)],
    # Some atoms of most residues: their centers of mass use those atoms.
    "partial": lambda u: u.atoms[::2],
    "even": lambda u: u.atoms[np.flatnonzero(
        u._topology.resindices % 2 == 0)],
    "odd": lambda u: u.atoms[np.flatnonzero(
        u._topology.resindices % 2 == 1)],
}


@pytest.mark.parametrize("grouping", ["residues", "segments"])
@pytest.mark.parametrize("group", ["all", "interleaved", "partial"])
def test_com_positions_equal_jax_bits(systems, grouping, group):
    ju, tu, frames = systems["ortho"]
    jg, tg = GROUPS[group](ju), GROUPS[group](tu)
    seg, n = jax_structure._group_segment_ids(jg, grouping)
    ref = np.asarray(jax_structure._com_positions(
        jnp.asarray(frames[:, jg.ix]), jnp.asarray(jg.masses),
        jnp.asarray(seg), n))
    reduce, n_port = structure._com_reducer(tg, grouping, "cpu")
    out = reduce(torch.from_numpy(frames[:, tg.ix])).numpy()
    assert n_port == n and out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    # Centers of molecules on the edge stay in [0, L].
    assert out.min() >= 0.0 and out.max() <= np.float32(BOX)


RDF_CASES = {
    "self": (dict(groupings="residues"), "all", None, "ortho"),
    "self_excl": (dict(groupings="residues", exclusion=(1, 1)), "all", None,
                  "ortho"),
    "self_tiles": (dict(groupings="residues", exclusion=(3, 3)), "all", None,
                   "ortho"),
    "segments": (dict(groupings="segments", range=(0.0, 5.0)), "all", None,
                 "ortho"),
    "mixed": (dict(groupings=("residues", "atoms")), "all", "all", "ortho"),
    "mixed_excl": (dict(groupings=("atoms", "residues"), exclusion=(1, 1)),
                   "all", "all", "ortho"),
    "cross": (dict(groupings="residues"), "even", "odd", "ortho"),
    "interleaved": (dict(groupings="residues", exclusion=(2, 2)),
                    "interleaved", None, "ortho"),
    "partial": (dict(groupings="residues", exclusion=(1, 1)), "partial",
                None, "ortho"),
    "triclinic": (dict(groupings="residues", exclusion=(1, 1)), "all", None,
                  "triclinic"),
}


@pytest.mark.parametrize("case", list(RDF_CASES))
def test_rdf_counts_equal_jax(systems, case):
    kwargs, g1, g2, box = RDF_CASES[case]
    ju, tu, _ = systems[box]
    options = dict(n_bins=N_BINS, range=(0.0, R_MAX), verbose=False)
    options.update(kwargs)

    def groups(u):
        ag1 = GROUPS[g1](u)
        # ag2 is ag1 for "all" x "all": one group, two groupings.
        return ag1, (None if g2 is None else ag1 if g2 == g1
                     else GROUPS[g2](u))

    # One chunk in the triclinic box: the JAX class's 27-image sweep
    # takes most of this file's time to compile and run.
    frames = dict(stop=CHUNK) if box == "triclinic" else {}
    ref = _run_jax(jax_structure.RadialDistributionFunction(
        *groups(ju), **options), **frames)
    port = _run_port(structure.RadialDistributionFunction(
        *groups(tu), device="cpu", **options), **frames)
    assert (port._n1, port._n2) == (ref._n1, ref._n2)
    np.testing.assert_array_equal(port.results.counts, ref.results.counts)
    assert port.results.counts.sum() > 0
    np.testing.assert_allclose(port.results.rdf, ref.results.rdf,
                               rtol=1e-12)


@pytest.mark.parametrize("group", ["all", "interleaved"])
def test_vanhove_counts_equal_jax(systems, group):
    ju, tu, _ = systems["ortho"]
    options = dict(n_bins=N_BINS, range=(0.0, R_MAX), grouping="residues",
                   n_lags=6, lags="log", verbose=False)
    ref = _run_jax(jax_structure.VanHoveFunction(GROUPS[group](ju),
                                                 **options))
    port = _run_port(structure.VanHoveFunction(GROUPS[group](tu),
                                               device="cpu", **options))
    assert port._n == ref._n == N_MOL
    for key in ("counts_self", "counts_distinct"):
        np.testing.assert_array_equal(port.results[key], ref.results[key])
        assert port.results[key][1:].sum() > 0
    for key in ("gs", "gd"):
        np.testing.assert_allclose(port.results[key], ref.results[key],
                                   rtol=1e-12)
    np.testing.assert_allclose(port.results.msd, ref.results.msd, rtol=1e-5)


SQ_CASES = {
    "factor": (dict(method="factor"), ["all"], "residues"),
    "direct": (dict(method="direct"), ["all"], "residues"),
    "pair": (dict(method="direct", mode="pair"), ["even", "odd"],
             ("residues", "atoms")),
    "partial": (dict(method="auto", mode="partial"), ["even", "odd"],
                "residues"),
}


@pytest.mark.parametrize("case", list(SQ_CASES))
def test_structure_factor_matches_jax(systems, case):
    kwargs, names, groupings = SQ_CASES[case]
    ju, tu, _ = systems["ortho"]
    options = dict(n_points=5, sort=False, unique=False, precision="exact",
                   verbose=False, **kwargs)

    def groups(u):
        return [GROUPS[name](u) for name in names]

    ref = _run_jax(jax_structure.StructureFactor(groups(ju), groupings,
                                                 **options))
    port = _run_port(structure.StructureFactor(groups(tu), groupings,
                                               device="cpu", **options))
    assert port._N == ref._N
    np.testing.assert_allclose(port.results.ssf, ref.results.ssf, **GATE)


@pytest.mark.parametrize("fft", [False, True], ids=["ring", "time_fft"])
def test_isf_matches_jax(systems, fft):
    ju, tu, _ = systems["ortho"]
    options = dict(n_points=4, sort=False, unique=False, n_lags=5,
                   incoherent=not fft, fft=fft, precision="exact",
                   verbose=False)
    ref = _run_jax(jax_structure.IntermediateScatteringFunction(
        ju.atoms, "residues", **options))
    port = _run_port(structure.IntermediateScatteringFunction(
        tu.atoms, "residues", device="cpu", **options))
    assert port._N == ref._N == N_MOL
    np.testing.assert_allclose(port.results.cisf, ref.results.cisf, **GATE)
    if not fft:
        assert port._carry["ring_pos"].shape[1] == N_MOL
        np.testing.assert_allclose(port.results.iisf, ref.results.iisf,
                                   **GATE)
        np.testing.assert_allclose(port.results.iisf[0], 1.0, rtol=1e-6)


def _assert_msd_close(actual, desired):
    np.testing.assert_allclose(
        actual, desired, rtol=1e-8, atol=1e-9 * np.abs(desired).max())


@pytest.mark.parametrize("split", [None, 80], ids=["one_group", "two_groups"])
def test_onsager_residues_unwrap_matches_jax(systems, split):
    """Groups that start at atom 0 and run contiguously: the JAX class's
    entity gather of a subset with ``unwrap=True`` picks the right atoms
    only then (ROADMAP Queue 3, item 7)."""

    ju, tu, _ = systems["ortho"]

    def groups(u):
        return u.atoms if split is None else [u.atoms[:split],
                                              u.atoms[split:]]

    ref = _run_jax(JaxOnsager(groups(ju), "residues", unwrap=True,
                              verbose=False))
    port = _run_port(Onsager(groups(tu), "residues", unwrap=True,
                             verbose=False, device="cpu"))
    assert port._Ns == ref._Ns
    _assert_msd_close(port.results.msd_self, ref.results.msd_self)
    _assert_msd_close(port.results.msd_cross, ref.results.msd_cross)


def test_fused_grouped_path_matches_jax(systems):
    """The slice's main path on the molecular system: RDF, S(q) and the
    Onsager MSD of residue centers, fused through run_together."""

    from mdhelper_tpu.analysis.multi import run_together as jax_run_together

    ju, tu, _ = systems["ortho"]

    def analyses(u, module, onsager, **device):
        return [
            module.RadialDistributionFunction(
                u.atoms, n_bins=N_BINS, range=(0.0, R_MAX),
                exclusion=(1, 1), groupings="residues", verbose=False,
                **device),
            module.StructureFactor(u.atoms, groupings="residues",
                                   n_points=5, sort=False, unique=False,
                                   method="factor", precision="exact",
                                   verbose=False, **device),
            onsager(u.atoms, groupings="residues", unwrap=True,
                    verbose=False, **device),
        ]

    chunk = CHUNK * tu.atoms.n_atoms * 12
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        refs = analyses(ju, jax_structure, JaxOnsager)
        for a in refs:
            a._chunk_bytes = chunk
        jax_run_together(refs)
    ports = analyses(tu, structure, Onsager, device="cpu")
    for a in ports:
        a._chunk_bytes = chunk
    rdf, sf, ons = run_together(ports)
    np.testing.assert_array_equal(rdf.results.counts, refs[0].results.counts)
    np.testing.assert_allclose(sf.results.ssf, refs[1].results.ssf, **GATE)
    _assert_msd_close(ons.results.msd_self, refs[2].results.msd_self)


@pytest.mark.parametrize("make", [
    lambda u: structure.RadialDistributionFunction(
        u.atoms, groupings="molecules", device="cpu"),
    lambda u: structure.RadialDistributionFunction(
        u.atoms, groupings=("residues", "fragments"), device="cpu"),
    lambda u: structure.StructureFactor(u.atoms, "segments", device="cpu"),
    lambda u: structure.StructureFactor([u.atoms[:9], u.atoms[9:]],
                                        ["residues"], device="cpu"),
    lambda u: structure.VanHoveFunction(u.atoms, grouping="segment",
                                        device="cpu"),
    lambda u: Onsager(u.atoms, "molecules", device="cpu"),
    lambda u: Onsager([u.atoms[:9], u.atoms[9:]], ["residues"],
                      device="cpu"),
], ids=["rdf", "rdf_pair", "sq_segments", "sq_count", "vanhove",
        "onsager", "onsager_count"])
def test_invalid_groupings_raise_value_error(systems, make):
    with pytest.raises(ValueError):
        make(systems["ortho"][1])
