"""The port's unit-bearing options and post-hoc methods against the JAX
package, and against numpy float64 oracles where the JAX class is at
fault.

The system is a 1:1 electrolyte of 240 ions (charges +1 and -1
alternating, masses 22.99 and 35.45), each an independent random walker
of N(0, 0.3) A steps per frame and axis, wrapped into a 12 A cube as
float32, over 21 frames; residues pair consecutive ions of one sign (so a
residue carries +2 or -2).  The JAX side streams float32
(``_coord_dtype``), as the port does.  Tolerances:

* closed forms of the same float64 inputs (the module functions, the
  RDF's post-hoc methods, the unit conversions): ``rtol=1e-12``;
* ``"linear"`` fits and everything derived from the MSDs of the same
  stored float32 positions (float64 FFTs in two libraries):
  ``rtol=1e-8``; ``"log"`` fits with ``enforce_linear=True`` go through
  ``scipy.optimize.curve_fit``, which stops at a relative step of
  ``xtol=1.49e-8``, so ``rtol=1e-7``;
* centered runs (and residue centers, see
  ``test_onsager_posthoc_matches_jax``): the JAX class subtracts a float32
  center from float32
  positions, rounding each centered coordinate (at most 12 A) to a float32
  ulp, 9.5e-7 A, where the port subtracts in float64.  An MSD of 0.09-2 A^2
  moves by about 2 |dr| 1e-6 A, a few 1e-6 of it, so ``rtol=1e-5``;
* S(q) rows and what is recombined from them: the S(q) gate,
  ``rtol=1e-4, atol=1e-5``;
* histogram counts: equal as integers.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu import Q_ as JQ  # noqa: E402
from mdhelper_tpu.algorithm import correlation as jcorr  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import structure as jstructure  # noqa: E402
from mdhelper_tpu.analysis import transport as jtransport  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.algorithm import correlation as tcorr  # noqa: E402
from mdhelper_tpu_torch.analysis import structure  # noqa: E402
from mdhelper_tpu_torch.analysis import transport  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N_IONS, N_FRAMES, BOX, STEP, DT, CHUNK = 240, 21, 12.0, 0.3, 0.5, 5
DIMS = np.array([BOX] * 3 + [90.0] * 3)
#: CODATA 2018: e (C), N_A (1/mol), R (kJ/(mol K)).
E_CHARGE, AVOGADRO, GAS_R = 1.602176634e-19, 6.02214076e23, 8.314462618e-3
CLOSED = dict(rtol=1e-12)
GATE = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def electrolyte_frames(seed=2032, n=N_IONS, n_frames=N_FRAMES):
    rng = np.random.default_rng(seed)
    walk = rng.random((n, 3)) * BOX + np.cumsum(
        rng.normal(0.0, STEP, (n_frames, n, 3)), axis=0)
    return np.mod(walk, BOX).astype(np.float32)


def electrolyte_topology(n=N_IONS):
    ix = np.arange(n)
    return dict(charges=np.where(ix % 2 == 0, 1.0, -1.0),
                masses=np.where(ix % 2 == 0, 22.99, 35.45),
                resindices=(ix // 4) * 2 + ix % 2)


@pytest.fixture(scope="module")
def system():
    """``(jax universe, port universe, float32 frames)``."""

    frames = electrolyte_frames()
    topology = electrolyte_topology()
    return (JaxUniverse.from_arrays(frames.astype(np.float64), DIMS, dt=DT,
                                    **topology),
            Universe.from_arrays(frames, DIMS, dt=DT, **topology),
            frames)


def _width(analysis):
    idx = analysis._atom_indices
    return analysis.universe.atoms.n_atoms if idx is None else len(idx)


def _run(analysis, jax_class):
    analysis._chunk_bytes = CHUNK * _width(analysis) * 12
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if not jax_class:
            return analysis.run()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype",
                       np.float32)
            return analysis.run()


def assert_units_equal(port, ref):
    """Entry by entry: the same keys, and each unit's scale factor,
    dimension vector and string (the engines' objects are distinct
    types)."""

    def key_of(unit):
        if hasattr(unit, "magnitude"):  # a Quantity, as 1 / Unit makes
            return (unit.magnitude, *key_of(unit.units))
        return unit.factor, unit.dims, str(unit)

    assert port.keys() == ref.keys()
    for key in ref:
        assert key_of(port[key]) == key_of(ref[key]), key


def assert_same_nans(port, ref):
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))


# -- module functions ---------------------------------------------------------


def _msd_series(n_groups, n_blocks, n_t, seed):
    """Synthetic self and cross displacements: noisy lines, the cross
    ones with negative stretches, a nan, and one series negative at every
    lag (no fit)."""

    rng = np.random.default_rng(seed)
    t = np.arange(n_t) * DT
    n_pairs = n_groups * (n_groups + 1) // 2
    self_ = (0.1 + rng.random((n_groups, n_blocks, 1))) * t * (
        1 + 0.05 * rng.normal(size=(n_groups, n_blocks, n_t)))
    cross = (rng.normal(size=(n_pairs, n_blocks, 1)) * t
             + rng.normal(0, 0.3, (n_pairs, n_blocks, n_t)))
    cross[0] = np.abs(cross[0]) + t
    cross[-1, 0] = -1.0 - t
    cross[1, -1, 3] = np.nan
    return t, cross, self_


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("scale, enforce_linear, window", [
    ("linear", True, (1, None)),
    ("linear", True, (2, 11)),
    ("log", True, (1, None)),
    ("log", False, (1, 9)),
])
def test_transport_functions_match_jax(n_blocks, scale, enforce_linear,
                                       window):
    t, cross, self_ = _msd_series(3, n_blocks, 13, seed=n_blocks)
    if n_blocks == 1:
        cross, self_ = cross[:, 0], self_[:, 0]
    args = (t, cross, self_, np.array([40, 70, 130]), DIMS[:3], 2.4943,
            window[0], window[1], scale)
    kwargs = dict(start_self=None if window[0] == 1 else 3,
                  enforce_linear=enforce_linear)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jtransport.calculate_transport_coefficients(*args, **kwargs)
        got = transport.calculate_transport_coefficients(*args, **kwargs)
    tol = dict(rtol=1e-7) if scale == "log" and enforce_linear else CLOSED
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.shape[0] == n_blocks
        assert_same_nans(g, r)
        np.testing.assert_allclose(g, r, **tol)
    L_ij = got[0]
    np.testing.assert_array_equal(L_ij, np.swapaxes(L_ij, 1, 2))
    assert np.isnan(L_ij[0, 2, 2]) and np.isnan(L_ij).sum() < L_ij.size
    z, rho = np.array([1.0, -1.0, 2.0]), np.array([0.02, 0.03, 0.01])
    finite = np.nan_to_num(L_ij)
    for reduced in (False, True):
        for name, fn_args in (
                ("calculate_conductivity", (finite, z)),
                ("calculate_nernst_einstein_conductivity", (got[1], z)),
                ("calculate_electrophoretic_mobility", (finite, z, rho))):
            np.testing.assert_allclose(
                getattr(transport, name)(*fn_args, reduced=reduced),
                getattr(jtransport, name)(*fn_args, reduced=reduced),
                **CLOSED)
    np.testing.assert_allclose(
        transport.calculate_transference_number(finite, z),
        jtransport.calculate_transference_number(finite, z), **CLOSED)


def test_transport_function_errors_match_jax():
    t, cross, self_ = _msd_series(2, 1, 8, seed=5)
    for fn in (transport, jtransport):
        with pytest.raises(ValueError, match="invalid shapes"):
            fn.calculate_transport_coefficients(
                t, cross[:, 0, 0], self_[:, 0, 0], [1, 1], DIMS[:3], 1.0)
        with pytest.raises(ValueError, match="Invalid scale"):
            fn.calculate_transport_coefficients(
                t, cross, self_, [1, 1], DIMS[:3], 1.0, scale="cubic")


@pytest.mark.parametrize("shape, axis, kwargs, cross", [
    ((12, 3), 0, {}, False),
    ((12, 5, 3), 0, dict(vector=True), False),
    ((12, 5, 3), 0, dict(average=True), False),
    ((2, 9, 4, 3), 1, dict(double=True, vector=True, average=True), False),
    ((12, 3), 0, {}, True),
    ((12, 5, 3), 0, dict(double=True, vector=True), True),
    ((2, 9, 4, 3), 1, dict(average=True), True),
])
def test_correlation_shift_matches_jax(shape, axis, kwargs, cross):
    rng = np.random.default_rng(11)
    a = rng.normal(size=shape)
    b = rng.normal(size=shape) if cross else None
    np.testing.assert_allclose(
        tcorr.correlation_shift(a, b, axis, **kwargs),
        jcorr.correlation_shift(a, b, axis, **kwargs), **CLOSED)


@pytest.mark.parametrize("shape, axis, average, cross", [
    ((15, 3), 0, True, False),
    ((15, 6, 3), 0, False, False),
    ((15, 6, 3), 0, True, True),
    ((2, 11, 6, 3), 1, True, False),
    ((2, 11, 3), 1, True, True),
])
def test_msd_shift_matches_jax_and_fft(shape, axis, average, cross):
    rng = np.random.default_rng(12)
    a = np.cumsum(rng.normal(size=shape), axis=axis)
    b = np.cumsum(rng.normal(size=shape), axis=axis) if cross else None
    got = tcorr.msd_shift(a, b, axis, average=average)
    np.testing.assert_allclose(
        got, jcorr.msd_shift(a, b, axis, average=average), **CLOSED)
    fft = tcorr.msd_fft(torch.from_numpy(a),
                        None if b is None else torch.from_numpy(b), axis,
                        average=average).numpy()
    np.testing.assert_allclose(got, fft, rtol=1e-10,
                               atol=1e-10 * np.abs(got).max())
    np.testing.assert_allclose(
        transport.msd_shift(a, b, axis, average=average), got, **CLOSED)


def _damped_rdf(r):
    return 1 + 1.5 * np.exp(-0.6 * (r - 1)) * np.cos(5.0 * (r - 1))


@pytest.mark.parametrize("fn", ["zeroth_order_hankel_transform",
                                "radial_fourier_transform"])
def test_radial_transforms_match_jax(fn):
    r = np.linspace(0.05, 8.0, 160)
    q = np.concatenate(([0.0], np.linspace(0.2, 12.0, 57)))
    f = _damped_rdf(r) - 1
    np.testing.assert_allclose(getattr(structure, fn)(r, f, q),
                               getattr(jstructure, fn)(r, f, q), **CLOSED)


@pytest.mark.parametrize("n_dims, threshold, n_coord_nums", [
    (3, 0.1, 2), (2, 0.1, 3), (3, 0.6, 4), (3, 10.0, 2)])
def test_coordination_numbers_match_jax(n_dims, threshold, n_coord_nums):
    r = np.linspace(0.025, 7.975, 160)
    g = _damped_rdf(r)
    kw = dict(n_coord_nums=n_coord_nums, n_dims=n_dims, threshold=threshold)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = jstructure.calculate_coordination_numbers(r, g, 0.033, **kw)
        got = structure.calculate_coordination_numbers(r, g, 0.033, **kw)
    assert_same_nans(got, ref)
    np.testing.assert_allclose(got, ref, **CLOSED)
    if threshold > 5:
        assert np.isnan(got).all() and len(caught) == 2
    else:
        assert np.isfinite(got[:2]).all()


@pytest.mark.parametrize("equal, formalism, n_dims, q", [
    (True, "FZ", 3, None),
    (False, "AL", 3, None),
    (False, "general", 3, "grid"),
    (False, "FZ", 2, "grid"),
    (False, "AL", 2, None),
])
def test_structure_factor_from_rdf_matches_jax(equal, formalism, n_dims, q):
    r = np.linspace(0.025, 7.975, 160)
    g = _damped_rdf(r)
    q = np.linspace(0.0, 10.0, 41) if q == "grid" else None
    args = (r, g, equal, 0.033, 0.4, 0.6, q)
    kw = dict(n_dims=n_dims, formalism=formalism, n_q=200)
    q_ref, s_ref = jstructure.calculate_structure_factor(*args, **kw)
    q_got, s_got = structure.calculate_structure_factor(*args, **kw)
    np.testing.assert_array_equal(q_got, q_ref)
    np.testing.assert_allclose(s_got, s_ref, **CLOSED)


def test_structure_factor_errors_match_jax():
    r = np.linspace(0.025, 7.975, 160)
    for module in (structure, jstructure):
        with pytest.raises(ValueError, match="formalism"):
            module.calculate_structure_factor(r, _damped_rdf(r), False, 0.1,
                                              formalism="XY")
        with pytest.raises(ValueError, match="dimensions"):
            module.calculate_structure_factor(r, _damped_rdf(r), True, 0.1,
                                              n_dims=4)


@pytest.mark.parametrize("dims, exclusion, split", [
    (DIMS, None, 120),
    (DIMS, (1, 1), None),
    (DIMS, (2, 3), None),
    (np.array([BOX, BOX, BOX, 70.0, 80.0, 65.0]), None, 120),
])
def test_radial_histogram_matches_jax(system, dims, exclusion, split):
    frames = system[2]
    pos1 = frames[3]
    pos2 = frames[3] if split is None else frames[3][split:]
    pos1 = pos1 if split is None else pos1[:split]
    args = (pos1, pos2, 50, (0.0, 5.0), dims)
    ref = jstructure.radial_histogram(*args, exclusion=exclusion)
    got = structure.radial_histogram(*args, exclusion=exclusion,
                                     device="cpu")
    assert got.dtype == np.int64 and got.sum() > 0
    np.testing.assert_array_equal(got, ref)


# -- RDF ------------------------------------------------------------------


RDF_CASES = {
    "cross": lambda u: ((u.atoms[0::2], u.atoms[1::2]), dict()),
    "self_counts": lambda u: ((u.atoms,), dict(norm=None)),
    "self_reduced": lambda u: ((u.atoms,), dict(norm="density",
                                                exclusion=(1, 1),
                                                reduced=True)),
    "residues": lambda u: ((u.atoms,), dict(groupings="residues",
                                            exclusion=(1, 1))),
}


@pytest.fixture(scope="module")
def rdf_runs(system):
    ju, u, _ = system
    out = {}
    for name, case in RDF_CASES.items():
        (jgroups, kw), (groups, _) = case(ju), case(u)
        common = dict(n_bins=70, range=(0.0, 3.5), verbose=False)
        ref = _run(jstructure.RadialDistributionFunction(
            *jgroups, **common, **kw), True)
        got = _run(structure.RadialDistributionFunction(
            *groups, **common, **kw, device="cpu"), False)
        out[name] = got, ref
    return out


@pytest.mark.parametrize("name", RDF_CASES)
def test_rdf_posthoc_matches_jax(rdf_runs, name):
    got, ref = rdf_runs[name]
    np.testing.assert_array_equal(got.results.counts, ref.results.counts)
    np.testing.assert_allclose(got._get_rdf(), ref._get_rdf(), **CLOSED)
    rho = N_IONS / 2 / BOX**3
    reduced = name == "self_reduced"
    temperature = 2.5 if reduced else 300
    for rdf in (got, ref):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rdf.calculate_coordination_numbers(rho, threshold=0.05)
        rdf.calculate_pmf(temperature)
        rdf.calculate_structure_factor(rho, 0.5, 0.5, formalism="AL")
        rdf.results.al = rdf.results.ssf
        rdf.calculate_structure_factor(rho, n_q=50)
    for key in ("coordination_numbers", "pmf", "wavenumbers", "ssf", "al"):
        assert_same_nans(got.results[key], ref.results[key])
        np.testing.assert_allclose(got.results[key], ref.results[key],
                                   **CLOSED)
    # -kT ln g is +inf exactly where g(r) = 0 (the cross RDF's first bins).
    empty = got._get_rdf() == 0
    np.testing.assert_array_equal(np.isposinf(got.results.pmf), empty)
    assert empty.any() or name != "cross"
    assert_units_equal(got.results.units, ref.results.units)
    if not reduced:
        got.calculate_pmf(Q_(300.0, "K"))
        np.testing.assert_allclose(got.results.pmf, ref.results.pmf,
                                   **CLOSED)
    else:
        for rdf, q in ((got, Q_), (ref, JQ)):
            with pytest.raises(ValueError, match="cannot have units"):
                rdf.calculate_pmf(q(300.0, "K"))


def test_rdf_n_batches_warns_like_jax(system):
    ju, u, _ = system
    for cls, universe, kw in (
            (jstructure.RadialDistributionFunction, ju, {}),
            (structure.RadialDistributionFunction, u, dict(device="cpu"))):
        with pytest.warns(UserWarning, match="n_batches is accepted for API "
                          "compatibility but has no effect"):
            cls(universe.atoms, n_bins=10, range=(0.0, 3.0), n_batches=4,
                verbose=False, **kw)


# -- S(q) -----------------------------------------------------------------


def rocksalt_frames(n_side=6, spacing=2.0, n_frames=3, seed=2033):
    """A jittered rock-salt lattice (charges alternating in x + y + z):
    charge order that screens S_ZZ at low q."""

    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    sites = (grid + 0.5) * spacing
    frames = sites + rng.normal(0.0, 0.12, (n_frames,) + sites.shape)
    charges = np.where(grid.sum(axis=1) % 2 == 0, 1.0, -1.0)
    box = n_side * spacing
    return np.mod(frames, box).astype(np.float32), charges, box


@pytest.fixture(scope="module")
def sq_runs(system):
    ju, u, _ = system
    out = {}
    for name, groupings in (("atoms", "atoms"), ("residues", "residues")):
        pair = []
        for universe, module, kw in ((u, structure, dict(device="cpu")),
                                     (ju, jstructure, {})):
            sf = module.StructureFactor(
                [universe.atoms[0::2], universe.atoms[1::2]], groupings,
                mode="partial", n_points=6, method="factor",
                precision="exact", verbose=False, **kw)
            pair.append(_run(sf, module is jstructure))
        out[name] = tuple(pair)
    frames, charges, box = rocksalt_frames()
    dims = np.array([box] * 3 + [90.0] * 3)
    pair = []
    for cls, module, kw in ((Universe, structure, dict(device="cpu")),
                            (JaxUniverse, jstructure, {})):
        universe = cls.from_arrays(
            frames if cls is Universe else frames.astype(np.float64), dims,
            charges=charges)
        cations = universe.atoms[np.flatnonzero(charges > 0)]
        anions = universe.atoms[np.flatnonzero(charges < 0)]
        sf = module.StructureFactor([cations, anions], mode="partial",
                                    n_points=8, method="factor",
                                    precision="exact", verbose=False, **kw)
        pair.append(_run(sf, module is jstructure))
    out["rocksalt"] = tuple(pair)
    return out


@pytest.mark.parametrize("name", ["atoms", "residues"])
def test_sq_recombinations_match_jax(sq_runs, name):
    got, ref = sq_runs[name]
    np.testing.assert_allclose(got.results.ssf, ref.results.ssf, **GATE)
    assert_units_equal(got.results.units, ref.results.units)
    n_q = len(ref.results.wavenumbers)
    form = 1 + np.linspace(0.0, 1.0, n_q)
    cases = [([1.0, 1.0], "none"), ([0.6, -0.3], "b2"),
             ([0.6, -0.3], "b_mean_sq"), (np.stack([form, 2 * form]), "b2")]
    for weights, normalization in cases:
        np.testing.assert_allclose(
            got.calculate_weighted_sum(weights, normalization=normalization),
            ref.calculate_weighted_sum(weights, normalization=normalization),
            **GATE)
    np.testing.assert_allclose(
        got.calculate_weighted_sum([1.0, 1.0], normalization="none"),
        got.results.ssf.sum(axis=0), **CLOSED)
    z = 2.0 if name == "residues" else 1.0
    topology = got.calculate_charge_structure_factor()
    np.testing.assert_allclose(topology,
                               ref.calculate_charge_structure_factor(),
                               **GATE)
    np.testing.assert_array_equal(
        got.calculate_charge_structure_factor([z, -z]), topology)
    for sf in (got, ref):
        with pytest.raises(ValueError, match="Invalid normalization"):
            sf.calculate_weighted_sum([1.0, 1.0], normalization="b3")
        with pytest.raises(ValueError, match="shape"):
            sf.calculate_weighted_sum([1.0, 1.0, 1.0])


def test_screening_length_matches_jax(sq_runs):
    got, ref = sq_runs["rocksalt"]
    lengths = [sf.calculate_screening_length() for sf in (got, ref)]
    # The fit's input agrees within the S(q) gate; so does its output.
    np.testing.assert_allclose(lengths[0], lengths[1], rtol=1e-4)
    np.testing.assert_allclose(got.results.charge_ssf_fit,
                               ref.results.charge_ssf_fit, rtol=1e-4)
    assert 0 < lengths[0] < 12.0
    assert_units_equal(got.results.units, ref.results.units)
    # The same window, its edge given in 1/nm.
    q_max = 1.0001 * float(got.results.charge_ssf_fit_q[-1])
    assert got.calculate_screening_length(
        q_max=Q_(q_max * 10, "1/nm")) == pytest.approx(lengths[0], rel=1e-9)
    # The random walkers are not screened: S_ZZ is flat, and the fit
    # refuses it in both packages.
    for sf in sq_runs["atoms"]:
        sf.results.charge_ssf = None
        with pytest.raises(ValueError, match="no q\\^2 suppression"):
            sf.calculate_screening_length()


def test_recombination_needs_partial_mode_like_jax(system):
    ju, u, _ = system
    for module, universe, kw in ((structure, u, dict(device="cpu")),
                                 (jstructure, ju, {})):
        sf = module.StructureFactor(universe.atoms, n_points=3,
                                    verbose=False, **kw)
        sf.results.ssf = np.ones((1, 4))
        with pytest.raises(ValueError, match="mode='partial'"):
            sf.calculate_weighted_sum([1.0])
        with pytest.raises(ValueError, match="mode='partial'"):
            sf.calculate_charge_structure_factor()


# -- Onsager --------------------------------------------------------------


def _posthoc(ons, scale="log"):
    """Every post-hoc method of `ons`; its results by name."""

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ons.calculate_transport_coefficients(scale=scale)
        ons.calculate_ionicity()
        ons.calculate_electrophoretic_mobility()
        ons.calculate_transference_number()
    keys = ("msd_self", "msd_cross", "times", "L_ij", "L_ii_self", "D_i",
            "conductivities", "ne_conductivities", "ionicity",
            "haven_ratios", "electrophoretic_mobilities",
            "transference_numbers")
    return {k: np.asarray(ons.results[k]) for k in keys}


#: (groups, groupings, temperature, keywords) of each Onsager case held
#: against the JAX class: the whole system with unwrap=True, or groups
#: with unwrap=False (where the JAX class gathers the right atoms).
ONSAGER_CASES = {
    "atoms_unwrap": ("all", "atoms", 300, dict(unwrap=True)),
    "atoms_shift_blocks_reduced": ("all", "atoms", 2.5, dict(
        unwrap=True, fft=False, n_blocks=2, reduced=True)),
    "ions_charges_units": ("ions", "atoms", "350 K", dict(
        charges="e", dimensions="nm", n_blocks=2)),
    "ions_residues": ("ions", "residues", 300, dict()),
    "ions_center": ("ions", "atoms", 300, dict(center=True)),
    "ions_center_wrap_shift": ("ions", "atoms", 300, dict(
        center=True, center_wrap=True, fft=False)),
}


def _onsager(module, universe, q, case):
    groups, groupings, temperature, kw = ONSAGER_CASES[case]
    kw = dict(kw)
    if kw.get("charges") == "e":
        kw["charges"] = q([2.0, -1.0], "elementary_charge")
    if kw.get("dimensions") == "nm":
        kw["dimensions"] = q(np.full(3, BOX / 10), "nm")
    if temperature == "350 K":
        temperature = q(350.0, "K")
    groups = (universe.atoms if groups == "all"
              else [universe.atoms[0::2], universe.atoms[1::2]])
    extra = dict(device="cpu") if module is transport else {}
    return module.Onsager(groups, groupings, temperature, verbose=False,
                          **kw, **extra)


@pytest.fixture(scope="module")
def onsager_runs(system):
    ju, u, _ = system
    out = {}
    for case in ONSAGER_CASES:
        got = _run(_onsager(transport, u, Q_, case), False)
        ref = _run(_onsager(jtransport, ju, JQ, case), True)
        out[case] = got, ref
    return out


@pytest.mark.parametrize("scale", ["log", "linear"])
@pytest.mark.parametrize("case", ONSAGER_CASES)
def test_onsager_posthoc_matches_jax(system, onsager_runs, case, scale):
    got, ref = onsager_runs[case]
    port, jax_ = _posthoc(got, scale), _posthoc(ref, scale)
    centered = ONSAGER_CASES[case][3].get("center", False)
    residues = ONSAGER_CASES[case][1] == "residues"
    if residues:
        # The port's residue centers are the numpy float32 fixed-order
        # ones bit for bit; the JAX class's are too, except in the last
        # frame, a chunk of one frame, whose centers XLA rounds otherwise
        # (by one float32 ulp, 9.5e-7 A at 12 A, for about a third of
        # them).  A group sum of 60 centers moves by up to 60 of those
        # ulps, and at the last lag, whose one window ends in that frame,
        # its cross displacement by 2 |dS| 6e-5 A over values of about
        # 100 A^2: a few 1e-6 of it, hence rtol=1e-5.
        np.testing.assert_array_equal(
            got._positions, _oracle_residue_centers(system[2], got.universe))
        differ = (got._positions != ref._positions).any(axis=(1, 2))
        assert not differ[:-1].any()
    for key, value in jax_.items():
        scale_of = np.nanmax(np.abs(value), initial=0.0)
        if centered:
            tol = dict(rtol=1e-5, atol=1e-9 * scale_of)
        elif residues:
            tol = dict(rtol=1e-5, atol=1e-9 * scale_of)
        elif scale == "log" and key not in ("msd_self", "msd_cross",
                                            "times"):
            tol = dict(rtol=1e-7, atol=1e-12 * scale_of)
        else:
            # Lag 0 is 0 up to float64 cancellation: an absolute floor.
            tol = dict(rtol=1e-8, atol=1e-9 * scale_of)
        assert port[key].shape == value.shape, key
        assert_same_nans(port[key], value)
        np.testing.assert_allclose(port[key], value, err_msg=key, **tol)
    assert np.isfinite(port["D_i"]).all()
    assert_units_equal(got.results.units, ref.results.units)
    np.testing.assert_array_equal(got._charges, ref._charges)
    np.testing.assert_allclose(got._kBT, ref._kBT, **CLOSED)
    np.testing.assert_allclose(got._rhos, ref._rhos, **CLOSED)


def _oracle_residue_centers(frames, universe):
    """float32 centers of mass of each group's residues (labels
    ascending), each atom's position times its float32 mass summed in
    atom order from 0, over the masses summed the same way."""

    masses = universe.atoms.masses.astype(np.float32)
    labels = universe.atoms.resindices
    out = []
    for sign in (0, 1):
        atoms = np.arange(sign, N_IONS, 2)
        for label in np.unique(labels[atoms]):
            total = np.zeros((len(frames), 3), np.float32)
            mass = np.float32(0.0)
            for atom in atoms[labels[atoms] == label]:
                total = total + frames[:, atom] * masses[atom]
                mass = mass + masses[atom]
            out.append(total / mass)
    return np.stack(out, axis=1)


def test_onsager_argument_errors_match_jax(system):
    ju, u, _ = system
    for module, universe, q in ((transport, u, Q_), (jtransport, ju, JQ)):
        extra = dict(device="cpu") if module is transport else {}
        ions = [universe.atoms[0::2], universe.atoms[1::2]]
        with pytest.raises(TypeError, match="cannot have units"):
            module.Onsager(ions, temperature=q(300.0, "K"), reduced=True,
                           verbose=False, **extra)
        with pytest.raises(TypeError, match="cannot have units"):
            module.Onsager(ions, charges=q([1.0, -1.0], "e"), reduced=True,
                           verbose=False, **extra)
        with pytest.raises(ValueError, match="number of group charges"):
            module.Onsager(ions, charges=[1.0], verbose=False, **extra)
        ons = module.Onsager(ions, verbose=False, **extra)
        with pytest.raises(RuntimeError, match="before"):
            ons.calculate_conductivity()


def test_onsager_takes_time_step_quantities(system, onsager_runs):
    """``dt`` as a Quantity: the port converts it; the JAX class takes
    ``dt or trajectory.dt``, and a scalar Quantity has no truth value
    there (``Quantity.__len__`` of a float), so it raises TypeError."""

    ju, u, _ = system
    ons = _run(transport.Onsager(u.atoms, dt=Q_(500.0, "fs"), unwrap=True,
                                 verbose=False, device="cpu"), False)
    ref = onsager_runs["atoms_unwrap"][1]
    np.testing.assert_allclose(ons.results.times, ref.results.times,
                               **CLOSED)
    np.testing.assert_allclose(ons.results.msd_self, ref.results.msd_self,
                               rtol=1e-8, atol=1e-9)
    with pytest.raises(TypeError):
        jtransport.Onsager(ju.atoms, dt=JQ(500.0, "fs"), verbose=False)


def test_single_ion_conductivity_is_nernst_einstein(system):
    """One group of one ion: the group sum is the ion, so L_00 equals
    L_00^self and kappa equals kappa_NE up to rounding (the ideal,
    uncorrelated case), for any charge."""

    _, u, _ = system
    ons = _run(transport.Onsager(u.atoms[7:8], unwrap=True, charges=[-3.0],
                                 verbose=False, device="cpu"), False)
    ons.calculate_transport_coefficients(scale="linear")
    ons.calculate_ionicity()
    np.testing.assert_allclose(ons.results.conductivities,
                               ons.results.ne_conductivities, rtol=1e-10)
    np.testing.assert_allclose(ons.results.ionicity, 1.0, rtol=1e-10)


def _oracle_unwrap(frames):
    """Image-flag unwrap of float32 frames in numpy, with the stream's
    float32 arithmetic (a step of half a box or more is a crossing)."""

    box = np.float32(BOX)
    images = np.zeros(frames.shape[1:], dtype=np.int32)
    out = np.empty_like(frames)
    prev = frames[0]
    for t, pos in enumerate(frames):
        delta = pos - prev
        images -= np.where(np.abs(delta) >= box / np.float32(2),
                           np.sign(delta), 0).astype(np.int32)
        out[t] = pos + images.astype(np.float32) * box
        prev = pos
    return out


def _oracle_msd(a, b):
    """float64 direct-lag mean of (a(t + m) - a(t)) . (b(t + m) - b(t))
    over origins t (and the particle axis, if any), by lag m."""

    n_t = len(a)
    return np.array([
        ((a[m:] - a[:n_t - m]) * (b[m:] - b[:n_t - m])).sum(-1).mean()
        for m in range(n_t)
    ])


def test_kappa_ne_is_codata_hand_formula(system):
    """kappa_NE of the subset electrolyte (unwrap=True, centered) against
    e^2 N_A sum_i z_i^2 N_i D_i / (V R T) with the CODATA constants and
    the run's own D_i (an error of a power of ten in the shared conversion
    shows here); and its D_i against a float64 oracle of the walk."""

    _, u, frames = system
    ions = [u.atoms[0::2], u.atoms[1::2]]
    ons = _run(transport.Onsager(ions, temperature=300, unwrap=True,
                                 center=True, charges=[1.0, -1.0],
                                 verbose=False, device="cpu"), False)
    ons.calculate_transport_coefficients(scale="linear")
    ons.calculate_nernst_einstein_conductivity()
    D = ons.results.D_i[0]
    hand = (E_CHARGE**2 * AVOGADRO * (N_IONS / 2) * D.sum()
            / (BOX**3 * GAS_R * 300))
    np.testing.assert_allclose(ons.results.ne_conductivities, [hand],
                               rtol=1e-10)
    unwrapped = _oracle_unwrap(frames).astype(np.float64)
    masses = u.atoms.masses
    centered = unwrapped - (masses[:, None] * unwrapped).sum(1, keepdims=True
                                                             ) / masses.sum()
    times = DT * np.arange(N_FRAMES)
    for i, group in enumerate((slice(0, None, 2), slice(1, None, 2))):
        msd = _oracle_msd(centered[:, group], centered[:, group]) / 6
        np.testing.assert_allclose(ons.results.msd_self[i, 0], msd,
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(D[i], np.polyfit(times[1:], msd[1:], 1)[0],
                                   rtol=1e-8)
    assert np.all(np.abs(D / (STEP**2 / (2 * DT)) - 1) < 0.15)


# -- ISF and Van Hove -----------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_vanhove_units_match_jax(system, reduced):
    ju, u, _ = system
    common = dict(n_bins=20, range=(0.0, 3.0), n_lags=5,
                  distinct_part=False, reduced=reduced, verbose=False)
    ref = _run(jstructure.VanHoveFunction(ju.atoms, dt=0.25, **common), True)
    got = _run(structure.VanHoveFunction(u.atoms, dt=Q_(0.25, "ps"),
                                         **common, device="cpu"), False)
    assert_units_equal(got.results.units, ref.results.units)
    assert bool(got.results.units) is not reduced
    np.testing.assert_allclose(got.results.times, ref.results.times,
                               **CLOSED)
    np.testing.assert_array_equal(got.results.counts_self,
                                  ref.results.counts_self)


def test_isf_units_match_jax(system):
    ju, u, _ = system
    common = dict(n_points=3, n_lags=6, incoherent=True, verbose=False)
    ref = _run(jstructure.IntermediateScatteringFunction(
        ju.atoms, dt=0.25, **common), True)
    got = _run(structure.IntermediateScatteringFunction(
        u.atoms, dt=Q_(250.0, "fs"), **common, device="cpu"), False)
    assert_units_equal(got.results.units, ref.results.units)
    got.calculate_dynamic_structure_factor(t_max=Q_(1.0, "ps"))
    ref.calculate_dynamic_structure_factor(t_max=1.0)
    assert_units_equal(got.results.units, ref.results.units)
    assert {"results.dsf", "results.idsf"} <= set(got.results.units)
    np.testing.assert_allclose(got.results.angular_frequencies,
                               ref.results.angular_frequencies, **CLOSED)
    np.testing.assert_allclose(got.results.dsf, ref.results.dsf, **GATE)
