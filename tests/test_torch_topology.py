"""The port's topology layer against the JAX package's on the CPU:
``Topology``, ``Universe``, ``AtomGroup`` (attributes, residue and segment
groupings, bonds, fragments and the current-frame reductions), the bond
graph's connected components, the minimum image, ``wrap`` and the bonded
``unwrap_edge`` in both of its forms, in orthorhombic and triclinic boxes.

Both packages get the same seeded arrays.  Every attribute and reduction
is compared bit for bit (the port's float32 frames against the JAX
package's float64 copies of them), and the same ``ValueError``s are raised.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

from mdhelper_tpu.algorithm import topology as jax_topology  # noqa: E402
from mdhelper_tpu.algorithm import utility as jax_utility  # noqa: E402
from mdhelper_tpu.core.trajectory import ArrayReader as JaxReader  # noqa: E402
from mdhelper_tpu.core.universe import (  # noqa: E402
    Topology as JaxTopology,
    Universe as JaxUniverse,
)

from mdhelper_tpu_torch.algorithm import topology  # noqa: E402
from mdhelper_tpu_torch.algorithm import utility  # noqa: E402
from mdhelper_tpu_torch.core.trajectory import ArrayReader  # noqa: E402
from mdhelper_tpu_torch.core.universe import Topology, Universe  # noqa: E402

N_MOL, BOX = 45, 9.0
BOXES = {
    "ortho": np.array([BOX, BOX + 1.0, BOX + 2.0, 90.0, 90.0, 90.0]),
    "triclinic": np.array([BOX, BOX, BOX, 60.0, 60.0, 90.0]),
}


def molecules(dims, seed=7):
    """``(float32 positions, topology keywords)``: N_MOL molecules of 1, 3
    and 4 atoms (a star, a chain and a branched tree, bonds listed in
    shuffled order), each atom wrapped into the cell, so that molecules
    straddle its faces; charges, types, names and labels mixed."""

    rng = np.random.default_rng(seed)
    sizes = np.resize((1, 3, 4, 3), N_MOL)
    mol = np.repeat(np.arange(N_MOL), sizes)
    first = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    rank = np.arange(len(mol)) - first[mol]
    # Atom k > 0 bonds to atom (k - 1) // 2 of its molecule: a chain of
    # three, a tree of four.
    child = np.flatnonzero(rank > 0)
    bonds = np.stack([first[mol[child]] + (rank[child] - 1) // 2, child],
                     axis=1)
    bonds = bonds[rng.permutation(len(bonds))]
    bonds[::2] = bonds[::2, ::-1]
    h = topology.triclinic_vectors(dims)
    steps = rng.normal(0.0, 1.0, (len(mol), 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    pos = (rng.random((N_MOL, 3)) @ h)[mol]
    for k in range(1, 4):
        anchor = np.minimum(first[mol] + (k - 1) // 2, len(mol) - 1)
        pos = np.where((rank == k)[:, None], pos[anchor] + 1.1 * steps, pos)
    frac = pos @ np.linalg.inv(h)
    pos = ((frac - np.floor(frac)) @ h).astype(np.float32)
    n = len(mol)
    attrs = dict(
        masses=rng.choice([1.008, 12.011, 15.999], n),
        charges=rng.choice([-1.0, 0.0, 0.5], n),
        types=rng.choice(["C", "O", "H"], n),
        names=rng.choice(["C1", "OW", "HW"], n),
        resindices=rng.permutation(N_MOL)[mol],
        segindices=(mol % 3 == 0).astype(int),
        resids=mol + 10,
        resnames=rng.choice(["SOL", "ION"], N_MOL)[mol],
        segids=np.where(mol % 3 == 0, "A", "B"),
        bonds=bonds,
    )
    return pos, attrs


@pytest.fixture(scope="module", params=list(BOXES))
def pair(request):
    """``(jax universe, port universe, dims)`` over one frame."""

    dims = BOXES[request.param]
    pos, attrs = molecules(dims)
    return (JaxUniverse.from_arrays(pos.astype(np.float64), dims, **attrs),
            Universe.from_arrays(pos, dims, **attrs), dims)


def _groups(u):
    rng = np.random.default_rng(3)
    n = u.atoms.n_atoms
    return {
        "all": u.atoms,
        "shuffled": u.atoms[rng.permutation(n)],
        "subset": u.atoms[rng.choice(n, n // 2, replace=False)],
        "slice": u.atoms[10:70],
    }


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype == object or b.dtype == object:
        assert a.tolist() == b.tolist()
    else:
        np.testing.assert_array_equal(a, b)


ATTRIBUTES = ("ix", "n_atoms", "masses", "charges", "types", "names",
              "resnames", "segids", "resindices", "segindices", "n_residues",
              "n_segments", "bonds", "dimensions")


@pytest.mark.parametrize("name", ["all", "shuffled", "subset", "slice"])
def test_atom_group_equals_jax(pair, name):
    ju, tu, _ = pair
    jg, tg = _groups(ju)[name], _groups(tu)[name]
    for attr in ATTRIBUTES:
        _equal(getattr(tg, attr), getattr(jg, attr))
    _equal(tg.positions, jg.positions)
    for grouping in ("residues", "segments"):
        jsub, tsub = getattr(jg, grouping), getattr(tg, grouping)
        assert [s.index for s in tsub] == [s.index for s in jsub]
        for js, ts in zip(jsub, tsub):
            _equal(ts.atoms.ix, js.atoms.ix)
    assert [f.ix.tolist() for f in tg.fragments] == [
        f.ix.tolist() for f in jg.fragments]
    # The reductions, bit for bit on the same float64 values.
    for method in ("center_of_mass", "center_of_geometry"):
        _equal(getattr(tg, method)(), getattr(jg, method)())
    for method in ("total_charge", "total_mass", "radius_of_gyration"):
        assert getattr(tg, method)() == getattr(jg, method)()


def test_universe_and_group_algebra_equal_jax(pair):
    ju, tu, _ = pair
    for attr in ("bonds", "dimensions"):
        _equal(getattr(tu, attr), getattr(ju, attr))
    for grouping in ("residues", "segments"):
        assert [s.atoms.ix.tolist() for s in getattr(tu, grouping)] == [
            s.atoms.ix.tolist() for s in getattr(ju, grouping)]
    jg, tg = _groups(ju), _groups(tu)
    _equal((tg["slice"] + tg["subset"]).ix, (jg["slice"] + jg["subset"]).ix)
    _equal(tg["slice"].union(tg["subset"]).ix,
           jg["slice"].union(jg["subset"]).ix)
    _equal(tg["all"].indices, jg["all"].indices)
    _equal(tg["all"][[3, 1, 2]].ix, jg["all"][[3, 1, 2]].ix)


def test_topology_defaults_equal_jax():
    jt, tt = JaxTopology(7), Topology(7)
    for attr in ("masses", "charges", "types", "names", "resindices",
                 "segindices", "resids", "resnames", "segids", "bonds",
                 "n_residues", "n_segments", "n_atoms"):
        _equal(getattr(tt, attr), getattr(jt, attr))
        assert np.asarray(getattr(tt, attr)).dtype == np.asarray(
            getattr(jt, attr)).dtype
    flat = dict(bonds=[0, 1, 1, 2])
    _equal(Topology(3, **flat).bonds, JaxTopology(3, **flat).bonds)


@pytest.mark.parametrize("attr", ["masses", "charges", "types", "names",
                                  "resindices", "segindices", "resids",
                                  "resnames", "segids"])
def test_topology_length_errors_equal_jax(attr):
    for make in (JaxTopology, Topology):
        with pytest.raises(ValueError, match="length does not match"):
            make(4, **{attr: np.zeros(3)})


def test_universe_atom_count_mismatch_raises_as_jax():
    pos = np.zeros((2, 5, 3), np.float32)
    for top, reader, universe in (
            (JaxTopology, JaxReader, JaxUniverse),
            (Topology, ArrayReader, Universe)):
        with pytest.raises(ValueError, match="Topology has 4 atoms"):
            universe(top(4), reader(pos))
    with pytest.raises(ValueError):
        Universe.from_arrays(pos, masses=np.ones(4))


def test_masses_keyword_reaches_the_topology():
    pos = np.zeros((1, 3, 3), np.float32)
    u = Universe.from_arrays(pos, masses=[1.0, 2.0, 3.0])
    _equal(u.atoms[1:].masses, [2.0, 3.0])
    assert u.atoms.positions.dtype == np.float32


@pytest.mark.parametrize("seed", range(4))
def test_find_connected_nodes_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    graph = {int(i): [] for i in rng.permutation(n)}
    for a, b in rng.integers(0, n, (30, 2)):
        if a != b:
            graph[int(a)].append(int(b))
            graph[int(b)].append(int(a))
    assert utility.find_connected_nodes(graph) == (
        jax_utility.find_connected_nodes(graph))
    visited, group = dict.fromkeys(graph, False), []
    ref_visited, ref_group = dict.fromkeys(graph, False), []
    start = next(iter(graph))
    utility.depth_first_search(graph, start, visited, group)
    jax_utility.depth_first_search(graph, start, ref_visited, ref_group)
    assert (group, visited) == (ref_group, ref_visited)


@pytest.mark.parametrize("dims", [
    np.array([9.0, 10.0, 11.0]), np.array([9.0, 0.0, 11.0, 90, 90, 90]),
    BOXES["ortho"], BOXES["triclinic"],
    np.array([8.0, 9.0, 10.0, 70.0, 80.0, 100.0])])
def test_minimize_vectors_and_wrap_equal_jax(dims):
    vecs = np.random.default_rng(1).normal(0.0, 12.0, (200, 3))
    _equal(topology.minimize_vectors(vecs, dims),
           jax_topology.minimize_vectors(vecs, dims))
    _equal(topology.minimize_vectors(vecs[0], dims),
           jax_topology.minimize_vectors(vecs[0], dims))
    if len(dims) == 3:
        _equal(topology.wrap(vecs, dims, in_place=False),
               jax_topology.wrap(vecs, dims, in_place=False))
        mine, ref = vecs.copy(), vecs.copy()
        assert topology.wrap(mine, dims) is None
        jax_topology.wrap(ref, dims)
        _equal(mine, ref)


@pytest.mark.parametrize("name", ["all", "shuffled", "subset"])
def test_unwrap_edge_group_equals_jax(pair, name):
    ju, tu, _ = pair
    ref = jax_topology.unwrap_edge(group=_groups(ju)[name])
    out = topology.unwrap_edge(group=_groups(tu)[name])
    assert out.dtype == np.float64
    _equal(out, ref)
    if name == "all":
        # Molecules straddled the faces: some atoms moved.
        assert (out != _groups(tu)[name].positions).any()


@pytest.mark.parametrize("masses", ["atoms", "molecules", None])
def test_unwrap_edge_arrays_equal_jax(pair, masses):
    ju, tu, dims = pair
    pos = tu.atoms.positions
    kwargs = dict(positions=pos, bonds=tu.bonds,
                  dimensions=dims[:3] if dims[3] == 90.0 else dims)
    if masses == "atoms":
        kwargs["masses"] = tu.atoms.masses
    elif masses == "molecules":
        kwargs["masses"] = [f.masses for f in tu.atoms.fragments]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_topology.unwrap_edge(**kwargs)
    if masses is None:
        with pytest.warns(UserWarning, match="No masses specified"):
            out = topology.unwrap_edge(**kwargs)
    else:
        out = topology.unwrap_edge(**kwargs)
    _equal(out, ref)


def test_unwrap_edge_errors_equal_jax():
    pos = np.zeros((3, 3))
    cases = [dict(), dict(positions=pos), dict(positions=pos, bonds=[[0, 1]]),
             dict(positions=pos, bonds=[[0, 1]], dimensions=[5.0] * 3,
                  masses=np.ones(4))]
    for kwargs in cases:
        for unwrap in (topology.unwrap_edge, jax_topology.unwrap_edge):
            with pytest.raises(ValueError):
                unwrap(**kwargs)


def test_unwrap_edge_of_a_long_chain_equals_jax():
    """A 300-atom chain: 299 generations of the walk."""

    n, box = 300, 7.0
    rng = np.random.default_rng(11)
    steps = rng.normal(0.0, 1.0, (n, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    pos = np.mod(np.cumsum(steps, axis=0), box)
    bonds = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    dims = np.array([box] * 3 + [90.0] * 3)
    ju = JaxUniverse.from_arrays(pos, dims, bonds=bonds)
    tu = Universe.from_arrays(pos, dims, bonds=bonds)
    _equal(topology.unwrap_edge(group=tu.atoms),
           jax_topology.unwrap_edge(group=ju.atoms))
