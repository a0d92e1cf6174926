"""The port's direct S(q) routes against the JAX package's StructureFactor.

The same seeded float32 trajectory goes through both packages; the JAX
side streams float32 (``_coord_dtype``, as ``tests/test_torch_slice.py``
sets it), as it does on the TPU.  Every S(q) is held to the gate of the
slice (``rtol=1e-4, atol=1e-5``): the direct method in both precisions,
the split of a lattice grid with spherical-surface extras under
``method="auto"``, explicit off-lattice wavevectors, ``mode="pair"`` and
``"partial"``, the direct method fused with the RDF and Onsager in
``run_together``, and a run resumed from a JAX carry.  The wavevector
grid with surfaces is equal bit for bit.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.algorithm.utility import (  # noqa: E402
    get_closest_factors as jax_closest_factors,
)
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import structure as jax_structure  # noqa: E402
from mdhelper_tpu.analysis.multi import run_together as jax_run_together  # noqa: E402
from mdhelper_tpu.analysis.transport import Onsager as JaxOnsager  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.algorithm.utility import get_closest_factors  # noqa: E402
from mdhelper_tpu_torch.analysis import structure  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.transport import Onsager  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N_ATOMS, N_FRAMES, CHUNK = 600, 6, 2
BOX = float(N_ATOMS / 0.8) ** (1 / 3)
N_POINTS = 5
GATE = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trajectory():
    """A wrapped random walk in float32."""

    rng = np.random.default_rng(2027)
    walk = rng.random((N_ATOMS, 3)) * BOX + np.cumsum(
        rng.normal(0.0, 0.3, (N_FRAMES, N_ATOMS, 3)), axis=0
    )
    return np.mod(walk, BOX).astype(np.float32)


@pytest.fixture(scope="module")
def universes(trajectory):
    dims = np.array([BOX] * 3 + [90.0] * 3)
    return (
        JaxUniverse.from_arrays(trajectory.astype(np.float64), dims, dt=1.0),
        Universe.from_arrays(trajectory, dims, dt=1.0),
    )


def _chunked(analyses):
    for a in analyses:
        a._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    return analyses


def _jax_run(analyses, **kwargs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        return jax_run_together(_chunked(analyses), **kwargs)


def _pair(universes, groups=lambda u: u.atoms, **kwargs):
    """Run the JAX StructureFactor and the port's with the same
    arguments; return both."""

    ju, tu = universes
    kwargs = dict(n_points=N_POINTS, verbose=False, **kwargs)
    jsf, = _jax_run([jax_structure.StructureFactor(groups(ju), **kwargs)])
    tsf, = run_together(_chunked(
        [structure.StructureFactor(groups(tu), device="cpu", **kwargs)]
    ))
    return jsf, tsf


def _assert_ssf_close(tsf, jsf):
    np.testing.assert_allclose(tsf.results.wavenumbers,
                               jsf.results.wavenumbers, rtol=1e-12)
    assert tsf.results.ssf.shape == jsf.results.ssf.shape
    np.testing.assert_allclose(tsf.results.ssf, jsf.results.ssf, **GATE)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_direct_matches_jax(universes, precision):
    jsf, tsf = _pair(universes, method="direct", precision=precision,
                     sort=False, unique=False)
    assert tsf._factor is None
    _assert_ssf_close(tsf, jsf)


def test_auto_splits_surfaces_like_jax(universes):
    """Lattice grid plus 2 x 8 surface points: the lattice part goes
    through the factorized sums, the extras through the direct ones, and
    the result equals the JAX package's and the port's own direct run."""

    kwargs = dict(n_surfaces=2, n_surface_points=8, sort=False,
                  unique=False)
    jsf, tsf = _pair(universes, **kwargs)
    assert tsf._factor is not None and tsf._factor_split is not None
    assert len(tsf._factor_split["qs_rest"]) == 16
    assert jsf._factor_split is not None
    _assert_ssf_close(tsf, jsf)
    direct, = run_together(_chunked([structure.StructureFactor(
        universes[1].atoms, n_points=N_POINTS, method="direct",
        verbose=False, device="cpu", **kwargs)]))
    np.testing.assert_allclose(tsf.results.ssf, direct.results.ssf, **GATE)


def test_explicit_off_lattice_wavevectors(universes):
    """Random wavevectors: no lattice plan, everything direct; sorted and
    averaged over equal wavenumbers (the defaults)."""

    rng = np.random.default_rng(5)
    qs = rng.random((40, 3)) * 2.5
    qs = np.vstack((qs, qs[:5] * [-1, 1, 1]))  # equal |q|, other vector
    jsf, tsf = _pair(universes, wavevectors=qs)
    assert tsf._factor is None
    assert len(tsf.results.wavenumbers) == 40
    _assert_ssf_close(tsf, jsf)


@pytest.mark.parametrize("mode", ["pair", "partial"])
def test_pair_and_partial_modes_match_jax(universes, mode):
    def groups(u):
        return [u.atoms[0::2], u.atoms[1::2]]

    jsf, tsf = _pair(universes, groups=groups, mode=mode, sort=False,
                     unique=False, q_max=2.0)
    expected = ((0, 1),) if mode == "pair" else ((0, 0), (0, 1), (1, 1))
    assert tsf.results.pairs == expected
    _assert_ssf_close(tsf, jsf)
    if mode == "partial":
        total, = run_together(_chunked([structure.StructureFactor(
            universes[1].atoms, n_points=N_POINTS, sort=False, unique=False,
            q_max=2.0, verbose=False, device="cpu")]))
        np.testing.assert_allclose(tsf.results.ssf.sum(axis=0),
                                   total.results.ssf[0], **GATE)


def test_run_together_direct_matches_jax(universes):
    ju, tu = universes
    jrdf, jsf, jons = _jax_run([
        jax_structure.RadialDistributionFunction(
            ju.atoms, n_bins=40, range=(0.0, 3.0), exclusion=(1, 1),
            verbose=False),
        jax_structure.StructureFactor(
            ju.atoms, n_points=N_POINTS, method="direct", sort=False,
            unique=False, verbose=False),
        JaxOnsager(ju.atoms, temperature=300, unwrap=True, verbose=False),
    ])
    rdf, sf, ons = run_together(_chunked([
        structure.RadialDistributionFunction(
            tu.atoms, n_bins=40, range=(0.0, 3.0), exclusion=(1, 1),
            verbose=False, device="cpu"),
        structure.StructureFactor(
            tu.atoms, n_points=N_POINTS, method="direct", sort=False,
            unique=False, verbose=False, device="cpu"),
        Onsager(tu.atoms, unwrap=True, verbose=False, device="cpu"),
    ]))
    np.testing.assert_array_equal(rdf.results.counts, jrdf.results.counts)
    _assert_ssf_close(sf, jsf)
    np.testing.assert_allclose(ons.results.msd_self, jons.results.msd_self,
                               rtol=1e-6,
                               atol=1e-9 * np.abs(jons.results.msd_self).max())


def test_direct_resumes_from_jax_carry(universes):
    """JAX folds frames 0-3 (direct, exact), the port takes its carry
    over with carry_from_numpy and folds frames 4-5: the carried sums
    equal a JAX run over all frames."""

    ju, tu = universes
    kwargs = dict(n_points=N_POINTS, method="direct", sort=False,
                  unique=False, verbose=False)
    full, = _jax_run([jax_structure.StructureFactor(ju.atoms, **kwargs)])
    head, = _jax_run([jax_structure.StructureFactor(ju.atoms, **kwargs)],
                     stop=4)
    carry = jax.tree_util.tree_map(np.asarray, head._carry)
    sf, = run_together(
        _chunked([structure.StructureFactor(tu.atoms, device="cpu",
                                            **kwargs)]),
        start=4, initial=[carry],
    )
    np.testing.assert_allclose(
        sf._carry["ssf"].numpy(), np.asarray(full._carry["ssf"]),
        rtol=1e-4, atol=1e-5 * N_ATOMS * N_FRAMES,
    )


@pytest.mark.parametrize("n_surface_points", [8, 6, 12, 7])
def test_wavevector_grid_with_surfaces_bit_equal(n_surface_points):
    dims = np.array([BOX] * 3)
    ours = structure._wavevector_grid(dims, 6, 3, n_surface_points)
    theirs = jax_structure._wavevector_grid(dims, 6, 3, n_surface_points)
    assert ours.shape == (6**3 + 3 * n_surface_points, 3)
    np.testing.assert_array_equal(ours, theirs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(
            structure._wavevector_grid(dims, 6),
            jax_structure._wavevector_grid(dims, 6))


def test_wavevector_grid_non_cubic_ignores_surfaces():
    dims = np.array([BOX, BOX * 1.5, BOX])
    with pytest.warns(UserWarning, match="cubic"):
        ours = structure._wavevector_grid(dims, 4, 2, 8)
    with pytest.warns(UserWarning, match="cubic"):
        theirs = jax_structure._wavevector_grid(dims, 4, 2, 8)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("value", [1, 2, 7, 8, 12, 36, 60, 64, 97, 360,
                                   1001])
@pytest.mark.parametrize("n_factors", [2, 3])
def test_get_closest_factors_matches_jax(value, n_factors):
    for reverse in (False, True):
        np.testing.assert_array_equal(
            get_closest_factors(value, n_factors, reverse=reverse),
            jax_closest_factors(value, n_factors, reverse=reverse))


def test_structure_factor_argument_errors(universes):
    u = universes[1]
    make = structure.StructureFactor
    with pytest.raises(NotImplementedError):
        make(u.atoms, method="mesh", device="cpu")
    # "residues" is ported (tests/test_torch_groupings.py); "segments" is
    # refused, as the JAX class refuses it.
    with pytest.raises(ValueError):
        make(u.atoms, groupings="segments", device="cpu")
    with pytest.raises(ValueError):
        make(u.atoms, groupings="molecules", device="cpu")
    with pytest.raises(ValueError):
        make(u.atoms, form="complex", device="cpu")
    with pytest.raises(ValueError):
        make(u.atoms, mode="triplet", device="cpu")
    with pytest.raises(ValueError):
        make([u.atoms[:10], u.atoms[10:20], u.atoms[20:]], mode="pair",
             device="cpu")
    with pytest.raises(ValueError):
        make(u.atoms[:10], device="cpu")
    # The factor method refuses an off-lattice set without a split.
    off = make(u.atoms, wavevectors=np.full((3, 3), 0.123), method="factor",
               device="cpu")
    with pytest.raises(ValueError):
        off.run()
