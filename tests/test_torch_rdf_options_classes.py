"""The port's RDF and Van Hove options that reach the remaining kernel
modes -- self ``exclusion=(e, e)`` and asymmetric ``(e0, e1)`` tiles,
``range=(r_min > 0, r_max)`` and the 2-D ``drop_axis`` RDF -- against
the JAX classes on the CPU (their exact XLA route), on the same seeded
float32 trajectories: integer counts equal, ``rdf``, ``gs`` and ``gd``
to ``rtol=1e-12`` (both divide the same counts by the same float64
normalization, in another order).  Two frames, one chunk: each JAX
analysis compiles its own XLA program (a few seconds, about 6 in a
triclinic box).  The kernel modes themselves are held against the JAX
kernels in ``tests/test_torch_rdf_options.py``.
"""

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

from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
    VanHoveFunction,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402

N_ATOMS, N_FRAMES, N_BINS = 300, 2, 24
#: a cube of 12 (r_max 3.5: a reach-1 half shell; 5: an ordered small
#: box), a 20 x 20 x 6 film (2-D grids of r_max 4: reach 1; of 7:
#: generalized), and a small xy-square rhombic dodecahedron (r_max 4:
#: per-block; 6: tri_pp).
CUBE = np.array([12.0] * 3 + [90.0] * 3)
FILM = np.array([20.0, 20.0, 6.0, 90.0, 90.0, 90.0])
DODECA = np.array([18.0] * 3 + [60.0, 60.0, 90.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trajectory(dims6, seed=41, n_frames=N_FRAMES):
    """Uniform float32 frames in the box (at uniform fractional
    coordinates of a triclinic one)."""

    rng = np.random.default_rng(seed)
    frac = rng.random((n_frames, N_ATOMS, 3))
    h = np.asarray(jax_triclinic_matrices(dims6), np.float64)
    traj = (frac @ h).astype(np.float32)
    # float32 rounding can land a coordinate on the box edge itself.
    if np.allclose(dims6[3:], 90.0):
        traj = np.where(traj >= np.float32(dims6[:3]), np.float32(0.0), traj)
    return traj


def _universes(dims6, seed=41):
    traj = _trajectory(dims6, seed)
    return (Universe.from_arrays(traj, dims6, dt=0.5),
            JaxUniverse.from_arrays(traj.astype(np.float64), dims6, dt=0.5))


def _jax_run(analysis):
    analysis._chunk_bytes = N_FRAMES * N_ATOMS * 3 * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        analysis.run()
    return analysis


def _rdfs(dims6, groups, **kwargs):
    """The port's RDF (through run_together) and the JAX class's."""

    u, ju = _universes(dims6)
    kwargs = dict(n_bins=N_BINS, verbose=False, **kwargs)
    rdf = RadialDistributionFunction(*groups(u), device="cpu", **kwargs)
    rdf._chunk_bytes = N_FRAMES * N_ATOMS * 3 * 4
    run_together([rdf])
    return rdf, _jax_run(JaxRDF(*groups(ju), **kwargs))


def _assert_same_rdf(rdf, ref):
    assert rdf.results.counts.sum() > 0
    np.testing.assert_array_equal(rdf.results.counts, ref.results.counts)
    np.testing.assert_allclose(rdf.results.rdf, ref.results.rdf, rtol=1e-12)


def _self(uu):
    return (uu.atoms,)


def _halves(uu):
    return (uu.atoms[0::2], uu.atoms[1::2])


#: (box, r_max, exclusion, the sweep mode the plan must run).
TILE_CASES = {
    "half_33": (CUBE, 3.5, (3, 3), "reach1"),
    "half_23": (CUBE, 3.5, (2, 3), "reach1"),
    "ordered_33": (CUBE, 5.0, (3, 3), "ordered"),
    "ordered_32": (CUBE, 5.0, (3, 2), "ordered"),
    "block_23": (DODECA, 4.0, (2, 3), "block"),
    "tri_pp_33": (DODECA, 6.0, (3, 3), "tri_pp"),
}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_self_rdf_tiles_match_jax(case):
    """Self-RDF tile exclusions: symmetric (3, 3) (the intramolecular
    pairs of a 3-site water model) and asymmetric tiles with their
    diagonal add-back, on the half shell and the ordered sweep,
    orthorhombic and triclinic (per-block and tri_pp), equal the JAX
    class, normalization ``n2 - e1`` included."""

    dims6, r_max, exclusion, mode = TILE_CASES[case]
    rdf, ref = _rdfs(dims6, _self, range=(0.0, r_max), exclusion=exclusion)
    plan = rdf._searched_cell_plan()
    assert cch._sweep_mode(plan["n_cells_dim"], plan["reach"],
                           rdf._triclinic, cross=False) == mode
    if exclusion[0] != exclusion[1]:
        # the wider slots' ceiling planned this grid
        assert rdf._slot_bytes == cch._ASYM_SLOT_BYTES
    _assert_same_rdf(rdf, ref)


@pytest.mark.parametrize("kind, exclusion", [
    ("self", None), ("self", (2, 3)), ("cross", None), ("cross", (2, 3)),
], ids=["self", "self_23", "cross", "cross_23"])
def test_offset_range_rdf_matches_jax(kind, exclusion):
    """range[0] > 0: no identical pairs in bin 0 (exclusion None) and no
    asymmetric diagonal add-back; the offset edges of the JAX class."""

    groups = _self if kind == "self" else _halves
    rdf, ref = _rdfs(CUBE, groups, range=(1.2, 3.7), exclusion=exclusion)
    np.testing.assert_array_equal(rdf.results.edges, ref.results.edges)
    _assert_same_rdf(rdf, ref)


#: (box, r_max, drop_axis, kind, exclusion, r_min): 2-D RDFs on a
#: reach-1 grid and a generalized one, self and cross.
DROP_CASES = {
    "reach1_self": (FILM, 4.0, "z", "self", (1, 1), 0.0),
    "reach1_cross": (FILM, 4.0, 2, "cross", None, 0.0),
    "general_self": (FILM, 7.0, "z", "self", None, 0.0),
    "general_cross_23": (FILM, 7.0, "z", "cross", (2, 3), 0.0),
    "reach1_x_self_offset_tiles": (
        np.array([6.0, 20.0, 20.0, 90.0, 90.0, 90.0]), 4.0, "x", "self",
        (3, 3), 0.8),
}


@pytest.mark.parametrize("case", list(DROP_CASES))
def test_drop_axis_rdf_matches_jax(case):
    """The 2-D RDF over the two kept axes (the in-plane g(r) of a film):
    counts of the in-plane distance, normalized by the kept area and the
    ring areas, equal the JAX class's zeroed-coordinate route on 2-D
    plans of reach 1 and generalized, self and cross."""

    dims6, r_max, drop, kind, exclusion, r_min = DROP_CASES[case]
    groups = _self if kind == "self" else _halves
    rdf, ref = _rdfs(dims6, groups, range=(r_min, r_max), drop_axis=drop,
                     exclusion=exclusion)
    plan = rdf._searched_cell_plan()
    assert len(plan["n_cells_dim"]) == 2
    assert (plan["reach"] == (1, 1)) == case.startswith("reach1")
    _assert_same_rdf(rdf, ref)


def test_drop_axis_rejects_triclinic_and_bad_options():
    u, _ = _universes(DODECA)
    with pytest.raises(ValueError, match="orthorhombic"):
        RadialDistributionFunction(u.atoms, drop_axis="z", device="cpu")
    u, _ = _universes(CUBE)
    with pytest.raises(ValueError):
        RadialDistributionFunction(u.atoms, drop_axis="w", device="cpu")
    with pytest.raises(ValueError):
        RadialDistributionFunction(u.atoms, range=(4.0, 2.0), device="cpu")


def test_vanhove_offset_range_matches_jax():
    """VanHoveFunction(range=(r_min > 0, r_max)): the self part on offset
    edges and the distinct part through the cross sweep's offset bins
    equal the JAX class (mirrors tests/test_analysis_vanhove.py's
    offset-range case)."""

    rng = np.random.default_rng(2032)
    walk = rng.random((N_ATOMS, 3)) * 12.0 + np.cumsum(
        rng.normal(0.0, 0.6, (3, N_ATOMS, 3)), axis=0)
    traj = np.mod(walk, 12.0).astype(np.float32)
    traj = np.where(traj >= np.float32(12.0), np.float32(0.0), traj)
    kwargs = dict(n_bins=N_BINS, range=(1.2, 3.6), verbose=False)
    vh = VanHoveFunction(Universe.from_arrays(traj, CUBE, dt=0.5).atoms,
                         device="cpu", **kwargs)
    vh._chunk_bytes = 3 * N_ATOMS * 3 * 4
    vh.run()
    ju = JaxUniverse.from_arrays(traj.astype(np.float64), CUBE, dt=0.5)
    ref = JaxVanHove(ju.atoms, **kwargs)
    ref._chunk_bytes = 3 * N_ATOMS * 3 * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        ref.run()
    np.testing.assert_array_equal(vh.results.edges, ref.results.edges)
    for key in ("counts_self", "counts_distinct"):
        np.testing.assert_array_equal(getattr(vh.results, key),
                                      getattr(ref.results, key))
    assert vh.results.counts_self[1].sum() > 0
    assert vh.results.counts_distinct.sum() > 0
    for key in ("gs", "gd"):
        np.testing.assert_allclose(getattr(vh.results, key),
                                   getattr(ref.results, key), rtol=1e-12)
