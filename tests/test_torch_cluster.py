"""The port's ClusterSizeDistribution against the JAX package's.

The same seeded float32 waters (``testing.water_system``: bench.py's
3-site geometry, molecules walking and wrapped atom by atom) go through
``mdhelper_tpu.analysis.cluster`` (streaming float32: ``_coord_dtype`` on
its base class, on the CPU) and its port (``device="cpu"``), in chunks of
2 frames of 5 (a short last chunk), in an orthorhombic box and a
triclinic one, on ``u.atoms`` and on a subset group.  The labels of the
components' fixpoint are unique for each partition, so the cluster
counts, the largest clusters and the size histogram must be equal as
integers; the distribution and the averages follow from them (equal to
1e-12).  Straddle fixtures put pairs at the cutoff and 1 and 2 ulps on
either side of it: their clusters equal the JAX package's and those of
a float64 oracle (scipy's connected components of the exact contact
map of the float32 positions).
"""

import numpy as np
import pytest
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu import Q_ as JQ  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import cluster as jax_cluster  # noqa: E402
from mdhelper_tpu.analysis.multi import run_together as jax_run_together  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.analysis import cluster  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import histogram  # noqa: E402
from mdhelper_tpu_torch.testing import water_system  # noqa: E402

N_MOL, T, CHUNK = 90, 5, 2
BOX = 20.0
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


def _universes(frames, dims, topology, dt=1.0):
    return (JaxUniverse.from_arrays(frames.astype(np.float64), dims, dt=dt,
                                    **topology),
            Universe.from_arrays(frames, dims, dt=dt, **topology))


@pytest.fixture(scope="module")
def waters():
    """``{box: (jax universe, port universe)}``: the waters in the cube
    and wrapped into a triclinic cell, with segments of 10 molecules."""

    frames, topology = water_system(np.random.default_rng(2032), N_MOL, BOX,
                                    T, step=0.5)
    topology["segindices"] = np.repeat(np.arange(N_MOL // 10), 30)
    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices

    h = np.asarray(triclinic_matrices(np.asarray(TRICLINIC, float)[None]))[0]
    frac = frames.astype(np.float64) @ np.linalg.inv(h)
    tri = ((frac - np.floor(frac)) @ h).astype(np.float32)
    return {
        "ortho": _universes(frames, np.array([BOX] * 3 + [90.0] * 3),
                            topology),
        "triclinic": _universes(tri, np.asarray(TRICLINIC), topology),
    }


def _chunked(analyses, n_atoms):
    for a in analyses:
        a._chunk_bytes = CHUNK * n_atoms * 3 * 4
    return analyses


def _group(u, which):
    return u.atoms if which == "all" else u.atoms[:3 * (N_MOL // 2)]


# (box, group, grouping, criterion, cutoff): cutoffs that leave several
# clusters a frame at this density.
CASES = {
    "atoms": ("ortho", "all", "atoms", "closest", 1.3),
    "residues": ("ortho", "all", "residues", "closest", 2.2),
    "residues_com": ("ortho", "all", "residues", "com", 3.2),
    "segments": ("ortho", "all", "segments", "closest", 0.8),
    "subset": ("ortho", "subset", "residues", "closest", 2.2),
    "triclinic_atoms": ("triclinic", "all", "atoms", "closest", 1.3),
    "triclinic_residues": ("triclinic", "all", "residues", "closest", 2.2),
    "triclinic_subset_com": ("triclinic", "subset", "residues", "com", 3.2),
}


def _pair(waters, case, **extra):
    box, which, grouping, criterion, cutoff = CASES[case]
    ju, tu = waters[box]
    kwargs = dict(criterion=criterion, verbose=False, **extra)
    jg, tg = _group(ju, which), _group(tu, which)
    ref, = jax_run_together(_chunked([jax_cluster.ClusterSizeDistribution(
        jg, cutoff, grouping, **kwargs)], jg.n_atoms))
    ours, = run_together(_chunked([cluster.ClusterSizeDistribution(
        tg, cutoff, grouping, device="cpu", **kwargs)], tg.n_atoms))
    return ref, ours


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_sizes_match_jax(waters, case):
    ref, ours = _pair(waters, case)
    for key in ("n_clusters", "largest", "size_counts", "sizes"):
        np.testing.assert_array_equal(ours.results[key], ref.results[key])
    # not all one cluster, not all singletons
    assert (ours.results.n_clusters > 1).all()
    assert (ours.results.largest > 1).all()
    for key in ("size_distribution", "number_average", "weight_average"):
        np.testing.assert_allclose(ours.results[key], ref.results[key],
                                   rtol=1e-12, atol=0)
    np.testing.assert_array_equal(ours.results.times, ref.results.times)
    assert ours.results.units == {"results.times": ours.results.units[
        "results.times"]}


@pytest.mark.parametrize("case", ["residues", "triclinic_atoms"])
def test_small_row_blocks_match_jax(monkeypatch, waters, case):
    """A contact map built from many row blocks (a 4,096-element sweep
    budget) gives the JAX package's clusters as integers."""

    monkeypatch.setattr(histogram, "_sweep_elements", lambda device: 1 << 12)
    assert len(histogram._row_blocks(N_MOL, N_MOL, "cpu")) > 1
    ref, ours = _pair(waters, case)
    for key in ("n_clusters", "largest", "size_counts", "sizes"):
        np.testing.assert_array_equal(ours.results[key], ref.results[key])


def test_run_equals_run_together(waters):
    """run() and run_together store the same series."""

    _, ours = _pair(waters, "residues")
    alone = cluster.ClusterSizeDistribution(
        waters["ortho"][1].atoms, 2.2, "residues", verbose=False,
        device="cpu").run()
    for key in ("n_clusters", "largest", "size_counts"):
        np.testing.assert_array_equal(alone.results[key], ours.results[key])


def test_cutoff_quantity_and_time_step(waters):
    """A Quantity cutoff converts to Angstrom, as in the JAX class; the
    class reads no time step of its own: the times follow the
    trajectory's ``dt`` (the JAX class's rule)."""

    frames, topology = water_system(np.random.default_rng(5), 30, 12.0, 3)
    dims = np.array([12.0] * 3 + [90.0] * 3)
    ju, tu = _universes(frames, dims, topology, dt=0.25)
    ref = jax_cluster.ClusterSizeDistribution(
        ju.atoms, JQ(0.22, "nm"), "residues", verbose=False).run()
    ours = cluster.ClusterSizeDistribution(
        tu.atoms, Q_(0.22, "nm"), "residues", verbose=False,
        device="cpu").run()
    assert ours._cutoff == pytest.approx(2.2, rel=1e-15)
    np.testing.assert_array_equal(ours.results.n_clusters,
                                  ref.results.n_clusters)
    np.testing.assert_allclose(ours.results.times, 0.25 * np.arange(3),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(ours.results.times, ref.results.times)


def _straddle_universes(cutoff):
    """Pairs along x at the float32 nearest the cutoff and 1 and 2 ulps on
    either side of it, each pair 8 A from the next along y (exact float32
    differences, no image fold), two frames (the second reversed)."""

    c = np.float32(cutoff)
    dists = [c]
    for _ in range(2):
        dists = ([np.nextafter(dists[0], np.float32(0))] + dists
                 + [np.nextafter(dists[-1], np.float32(10))])
    n = len(dists)
    pos = np.zeros((2 * n, 3), np.float32)
    pos[0::2, 1] = pos[1::2, 1] = 8.0 * np.arange(n) + 1.0
    pos[0::2, 2] = pos[1::2, 2] = 1.0
    pos[1::2, 0] = dists
    frames = np.stack((pos, pos[::-1].copy()))
    return _universes(frames, np.array([8.0 * n, 8.0 * n, 8.0 * n, 90.0,
                                        90.0, 90.0]), {}), frames


def _f64_clusters(pos, box, cutoff):
    """(n_clusters, largest, size histogram) of the exact contact map."""

    d = pos[:, None, :].astype(np.float64) - pos[None, :, :]
    d -= box * np.round(d / box)
    contact = (d * d).sum(-1) <= cutoff * cutoff
    n = len(pos)
    rows, cols = np.nonzero(contact)
    n_cl, labels = connected_components(
        coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n)),
        directed=False)
    sizes = np.bincount(labels)
    return n_cl, sizes.max(), np.bincount(sizes, minlength=n + 1)[1:]


@pytest.mark.parametrize("cutoff", [2.5, 2.7, 3.5])
def test_straddle_pairs_match_jax_and_f64(cutoff):
    (ju, tu), frames = _straddle_universes(cutoff)
    ref = jax_cluster.ClusterSizeDistribution(ju.atoms, cutoff,
                                              verbose=False).run()
    ours = cluster.ClusterSizeDistribution(tu.atoms, cutoff, verbose=False,
                                           device="cpu").run()
    box = np.float64(tu.dimensions[0])
    hist = 0
    for t, pos in enumerate(frames):
        n_cl, largest, h = _f64_clusters(pos, box, cutoff)
        assert ours.results.n_clusters[t] == ref.results.n_clusters[t] == n_cl
        assert ours.results.largest[t] == ref.results.largest[t] == largest
        hist = hist + h
    np.testing.assert_array_equal(ours.results.size_counts, hist)
    np.testing.assert_array_equal(ref.results.size_counts, hist)
    # pairs on both sides of the cutoff, in both frames
    assert 0 < hist[1] < 2 * 5 and hist[0] > 0


def test_label_components_is_the_min_label_fixpoint():
    """Every node's label is the smallest node of its component, on a
    chain (the diameter case) and on random graphs."""

    rng = np.random.default_rng(8)
    for n, p in ((64, None), (50, 0.03), (80, 0.01)):
        if p is None:
            rows = np.arange(n - 1)
            cols = rows + 1
            order = rng.permutation(n)
            rows, cols = order[rows], order[cols]
        else:
            rows, cols = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
        rows = np.concatenate((rows, cols, np.arange(n)))
        cols = np.concatenate((cols, rows[:len(cols)], np.arange(n)))
        labels = cluster._label_components(torch.as_tensor(rows),
                                           torch.as_tensor(cols), n).numpy()
        _, comp = connected_components(
            coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n)),
            directed=False)
        expected = np.array([np.flatnonzero(comp == comp[i]).min()
                             for i in range(n)])
        np.testing.assert_array_equal(labels, expected)


def test_validation_matches_jax(waters):
    ju, tu = waters["ortho"]
    for args, kwargs, match in (
            ((1.0, "molecules"), {}, "Invalid grouping"),
            ((1.0,), dict(criterion="nearest"), "Invalid criterion"),
            ((0.0,), {}, "'cutoff' must be positive"),
    ):
        with pytest.raises(ValueError, match=match):
            jax_cluster.ClusterSizeDistribution(ju.atoms, *args,
                                                verbose=False, **kwargs)
        with pytest.raises(ValueError, match=match):
            cluster.ClusterSizeDistribution(tu.atoms, *args, device="cpu",
                                            **kwargs)
    with pytest.raises(NotImplementedError, match="item 10"):
        cluster.ClusterSizeDistribution(tu.atoms, 2.0, parallel=True,
                                        device="cpu")
