"""The port's IntermediateScatteringFunction against the JAX package's.

The same seeded float32 random walk goes through both packages; the JAX
side streams float32 (``_coord_dtype``, as ``tests/test_torch_direct_sq.py``
sets it).  Twelve frames in chunks of four, so that the lag ring spans
chunks.  Every F(q, t), coherent and incoherent, is held to the S(q) gate
(``rtol=1e-4, atol=1e-5``) in each route (the lag ring, the time FFT, the
factorized, direct and split sums), mode, lag grid, through
``run_together`` beside an RDF, and resumed from a JAX carry; so are the
dynamic structure factors.  The errors are raised as the JAX class raises
them, and ``correlation_fft`` equals the JAX function's to float64
rounding.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.algorithm import correlation as jax_correlation  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import structure as jax_structure  # noqa: E402
from mdhelper_tpu.analysis.multi import run_together as jax_run_together  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.algorithm import correlation  # noqa: E402
from mdhelper_tpu_torch.analysis import structure  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N_ATOMS, N_FRAMES, CHUNK = 600, 12, 4
BOX = float(N_ATOMS / 0.8) ** (1 / 3)
N_POINTS, N_LAGS = 5, 8
GATE = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def universes():
    """A wrapped random walk in float32, in both packages."""

    rng = np.random.default_rng(2027)
    walk = rng.random((N_ATOMS, 3)) * BOX + np.cumsum(
        rng.normal(0.0, 0.3, (N_FRAMES, N_ATOMS, 3)), axis=0
    )
    traj = np.mod(walk, BOX).astype(np.float32)
    dims = np.array([BOX] * 3 + [90.0] * 3)
    return (
        JaxUniverse.from_arrays(traj.astype(np.float64), dims, dt=0.5),
        Universe.from_arrays(traj, dims, dt=0.5),
    )


def _chunked(analyses):
    for a in analyses:
        a._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    return analyses


def _jax_run(analyses, **kwargs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        return jax_run_together(_chunked(analyses), **kwargs)


def _all_atoms(u):
    return u.atoms


def _halves(u):
    return [u.atoms[0::2], u.atoms[1::2]]


def _options(**kwargs):
    options = dict(n_points=N_POINTS, n_lags=N_LAGS, sort=False,
                   unique=False, verbose=False)
    options.update(kwargs)
    return options


def _pair(universes, groups=_all_atoms, **kwargs):
    """Run the JAX ISF and the port's with the same arguments."""

    ju, tu = universes
    options = _options(**kwargs)
    jisf, = _jax_run([
        jax_structure.IntermediateScatteringFunction(groups(ju), **options)
    ])
    tisf, = run_together(_chunked([
        structure.IntermediateScatteringFunction(groups(tu), device="cpu",
                                                 **options)
    ]))
    return jisf, tisf


def _assert_isf_close(tisf, jisf):
    for key in ("times", "wavenumbers"):
        np.testing.assert_allclose(tisf.results[key], jisf.results[key],
                                   rtol=1e-12)
    assert tisf.results.pairs == jisf.results.pairs
    for key in ("cisf", "iisf"):
        assert (key in tisf.results) == (key in jisf.results)
        if key in jisf.results:
            assert tisf.results[key].shape == jisf.results[key].shape
            np.testing.assert_allclose(tisf.results[key],
                                       jisf.results[key], **GATE)


# (groups, options, route: time FFT?, factorized?, split?)
CASES = {
    "ring": (_all_atoms, dict(fft=False), (False, True, False)),
    "time_fft": (_all_atoms, dict(), (True, True, False)),
    "incoherent": (_all_atoms, dict(incoherent=True), (False, True, False)),
    "direct": (_all_atoms, dict(incoherent=True, method="direct"),
               (False, False, False)),
    "direct_time_fft": (_all_atoms, dict(method="direct"),
                        (True, False, False)),
    "split": (_all_atoms, dict(incoherent=True, n_surfaces=2,
                               n_surface_points=8), (False, True, True)),
    "split_time_fft": (_all_atoms, dict(n_surfaces=2, n_surface_points=8),
                       (True, True, True)),
    "log": (_all_atoms, dict(incoherent=True, lags="log", n_lags=12),
            (False, True, False)),
    "subset": (_all_atoms, dict(incoherent=True, lags=[0, 2, 5]),
               (False, True, False)),
    "subset_no_n_lags": (_all_atoms, dict(incoherent=True, lags=[1, 3, 6],
                                          n_lags=None), (False, True, False)),
    "pair": (_halves, dict(mode="pair", incoherent=True),
             (False, True, False)),
    "partial_ring": (_halves, dict(mode="partial", fft=False, q_max=2.0),
                     (False, True, False)),
    "partial_time_fft": (_halves, dict(mode="partial", method="direct",
                                       q_max=2.0), (True, False, False)),
    "sorted_unique": (_all_atoms, dict(incoherent=True, sort=True,
                                       unique=True), (False, True, False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_isf_matches_jax(universes, case):
    groups, kwargs, (time_fft, factor, split) = CASES[case]
    jisf, tisf = _pair(universes, groups=groups, **kwargs)
    assert tisf._time_fft == time_fft == jisf._time_fft
    assert (tisf._factor is not None) == factor
    assert (tisf._factor_split is not None) == split
    _assert_isf_close(tisf, jisf)
    if "iisf" in tisf.results and 0 in tisf._lag_values:
        # Zero displacements: every term is 1 (a group's row holds its
        # share of the atoms).
        np.testing.assert_array_equal(tisf.results.iisf[0].sum(axis=0), 1.0)


def test_log_grid_rows_equal_dense_rows(universes):
    """Each lag's sums are taken alone, so a log grid's rows are the dense
    grid's rows at its lags, bit for bit."""

    tu = universes[1]
    runs = {}
    for lags in (None, "log"):
        runs[lags], = run_together(_chunked([
            structure.IntermediateScatteringFunction(
                tu.atoms, device="cpu",
                **_options(incoherent=True, fft=False, lags=lags, n_lags=12))
        ]))
    lags = runs["log"]._lag_values
    assert len(lags) < 12
    for key in ("cisf", "iisf"):
        np.testing.assert_array_equal(runs["log"].results[key],
                                      runs[None].results[key][lags])


@pytest.fixture(scope="module")
def dense_runs(universes):
    """A dense incoherent run in both packages."""

    return _pair(universes, incoherent=True)


@pytest.mark.parametrize("t_max, window", [(None, None), (2.5, "hann")])
def test_dynamic_structure_factor_matches_jax(dense_runs, t_max, window):
    jisf, tisf = dense_runs
    for isf in dense_runs:
        isf.calculate_dynamic_structure_factor(t_max=t_max, window=window)
    n_t = N_LAGS if t_max is None else int(round(t_max / 0.5)) + 1
    assert tisf.results.dsf.shape == (n_t // 2 + 1, 1, N_POINTS**3)
    np.testing.assert_allclose(tisf.results.angular_frequencies,
                               jisf.results.angular_frequencies, rtol=1e-12)
    for key, ref in (("dsf", "cisf"), ("idsf", "iisf")):
        np.testing.assert_allclose(tisf.results[key], jisf.results[key],
                                   **GATE)
        # The sum rule over one period of the two-sided spectrum.
        s = tisf.results[key]
        period = s[0] + 2 * s[1:(n_t + 1) // 2].sum(axis=0)
        if n_t % 2 == 0:
            period = period + s[n_t // 2]
        d_omega = tisf.results.angular_frequencies[1]
        np.testing.assert_allclose(period * d_omega, tisf.results[ref][0],
                                   rtol=1e-10, atol=1e-12)


def test_run_together_with_rdf_matches_jax(universes):
    ju, tu = universes
    rdf_options = dict(n_bins=12, range=(0.0, 4.0), exclusion=(1, 1),
                       verbose=False)
    jrdf, jisf = _jax_run([
        jax_structure.RadialDistributionFunction(ju.atoms, **rdf_options),
        jax_structure.IntermediateScatteringFunction(
            ju.atoms, **_options(incoherent=True)),
    ])
    rdf, isf = run_together(_chunked([
        structure.RadialDistributionFunction(tu.atoms, device="cpu",
                                             **rdf_options),
        structure.IntermediateScatteringFunction(
            tu.atoms, device="cpu", **_options(incoherent=True)),
    ]))
    np.testing.assert_array_equal(rdf.results.counts, jrdf.results.counts)
    _assert_isf_close(isf, jisf)
    solo, = run_together(_chunked([structure.IntermediateScatteringFunction(
        tu.atoms, device="cpu", **_options(incoherent=True))]))
    np.testing.assert_array_equal(isf.results.cisf, solo.results.cisf)
    np.testing.assert_array_equal(isf.results.iisf, solo.results.iisf)


@pytest.mark.parametrize("route", ["ring", "time_fft"])
def test_resumes_from_jax_carry(universes, route):
    """JAX folds the first chunk, the port takes its carry (ring) or its rho
    store (time FFT) and folds the rest: the result equals a JAX run over
    every frame.  Each run caps its ring at its own frame count, so the
    ring of the resumed runs holds one chunk."""

    ju, tu = universes
    kwargs = (dict(incoherent=True, n_lags=CHUNK) if route == "ring"
              else dict(method="direct"))
    full, = _jax_run([jax_structure.IntermediateScatteringFunction(
        ju.atoms, **_options(**kwargs))])
    head, = _jax_run([jax_structure.IntermediateScatteringFunction(
        ju.atoms, **_options(**kwargs))], stop=CHUNK)
    if route == "ring":
        initial = jax.tree_util.tree_map(np.asarray, head._carry)
    else:
        initial = {"rho": head._rho[:head._store_offset]}
    isf, = run_together(_chunked([structure.IntermediateScatteringFunction(
        tu.atoms, device="cpu", **_options(**kwargs))]),
        start=CHUNK, initial=[initial])
    assert isf._time_fft == (route == "time_fft")
    if route == "ring":
        assert int(isf._carry["frame"]) == N_FRAMES
    _assert_isf_close(isf, full)


def test_carry_shape_mismatch_raises(universes):
    """A JAX ring of another length is refused, not silently reindexed."""

    ju, tu = universes
    head, = _jax_run([jax_structure.IntermediateScatteringFunction(
        ju.atoms, **_options(incoherent=True, n_lags=4))], stop=CHUNK)
    with pytest.raises(ValueError, match="leaf"):
        run_together(_chunked([structure.IntermediateScatteringFunction(
            tu.atoms, device="cpu", **_options(incoherent=True))]),
            start=CHUNK,
            initial=[jax.tree_util.tree_map(np.asarray, head._carry)])


def _raises_like_jax(universes, error, run_kwargs=None, post=None,
                     **kwargs):
    """Both classes raise `error` on construction, run or `post`."""

    ju, tu = universes
    run_kwargs = run_kwargs or {}
    for make, u, extra in (
            (jax_structure.IntermediateScatteringFunction, ju, {}),
            (structure.IntermediateScatteringFunction, tu,
             {"device": "cpu"})):
        with pytest.raises(error):
            isf = make(u.atoms, **_options(**kwargs), **extra)
            isf.run(**run_kwargs)
            if post is not None:
                post(isf)


@pytest.mark.parametrize("case", [
    "uneven_frames", "fft_incoherent", "lag_past_ring", "lags_negative",
    "lags_name", "dsf_log_grid", "dsf_window"])
def test_errors_raised_as_jax_raises_them(universes, case):
    if case == "uneven_frames":
        _raises_like_jax(universes, ValueError,
                         run_kwargs=dict(frames=[0, 1, 3, 4]))
    elif case == "fft_incoherent":
        _raises_like_jax(universes, ValueError, fft=True, incoherent=True)
    elif case == "lag_past_ring":
        _raises_like_jax(universes, ValueError, lags=[0, 8])
    elif case == "lags_negative":
        _raises_like_jax(universes, ValueError, lags=[-1, 2])
    elif case == "lags_name":
        _raises_like_jax(universes, ValueError, lags="linear")
    elif case == "dsf_log_grid":
        _raises_like_jax(
            universes, ValueError, lags="log", n_lags=12,
            post=lambda a: a.calculate_dynamic_structure_factor())
    else:
        _raises_like_jax(
            universes, ValueError,
            post=lambda a: a.calculate_dynamic_structure_factor(
                window="box"))


@pytest.mark.parametrize("kwargs", [
    # groupings="residues" (tests/test_torch_groupings.py) and
    # method="mesh" (tests/test_torch_mesh.py) are ported.
    dict(shard="q"), dict(shard="frames"), dict(parallel=True)])
def test_unported_options_raise(universes, kwargs):
    with pytest.raises(NotImplementedError):
        structure.IntermediateScatteringFunction(
            universes[1].atoms, device="cpu", **kwargs)


def test_dsf_before_run_raises(universes):
    isf = structure.IntermediateScatteringFunction(universes[1].atoms,
                                                   device="cpu")
    with pytest.raises(RuntimeError):
        isf.calculate_dynamic_structure_factor()


def _series(seed):
    rng = np.random.default_rng(seed)
    return {
        "real": rng.normal(size=(37, 5)),
        "complex": rng.normal(size=(37, 4)) + 1j * rng.normal(size=(37, 4)),
        "vector": rng.normal(size=(2, 37, 6, 3)),
        "one": rng.normal(size=37),
    }


CORRELATIONS = {
    "acf": ("real", False, {}),
    "acf_one": ("one", False, {}),
    "acf_double": ("real", False, dict(double=True)),
    "acf_average": ("real", False, dict(average=True)),
    "ccf_double": ("real", True, dict(double=True)),
    "ccf_two_sided": ("real", True, {}),
    "complex_acf": ("complex", False, {}),
    "complex_ccf_double": ("complex", True, dict(double=True)),
    "complex_ccf_two_sided": ("complex", True, {}),
    "vector_average": ("vector", False, dict(vector=True, average=True)),
    "vector_ccf_double": ("vector", True, dict(vector=True, double=True)),
}


@pytest.mark.parametrize("case", list(CORRELATIONS))
def test_correlation_fft_matches_jax(case):
    kind, cross, kwargs = CORRELATIONS[case]
    arrays = (_series(0)[kind],) + ((_series(1)[kind],) if cross else ())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = correlation.correlation_fft(*arrays, **kwargs)
        theirs = np.asarray(
            jax_correlation.correlation_fft(*arrays, **kwargs))
    assert ours.dtype == (torch.complex128 if kind == "complex"
                          else torch.float64)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-12,
                               atol=1e-12 * np.abs(theirs).max())


def test_correlation_fft_keeps_float32():
    series = _series(0)["real"].astype(np.float32)
    ours = correlation.correlation_fft(torch.from_numpy(series))
    assert ours.dtype == torch.float32
    ref = correlation.correlation_fft(series.astype(np.float64))
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_trig_sums_take_displacements_of_either_sign():
    """The lag launch's input: displacement frames anywhere in +-L, fast
    phases, within 1e-4 of the mean amplitude of a float64 sum (the
    tolerance of tests/test_pallas.py); a workspace is not needed on the
    CPU and changes nothing."""

    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(9)
    frames = ((rng.random((3, 700, 3)) - rng.random((3, 700, 3)))
              * BOX).astype(np.float32)
    qs = structure._wavevector_grid([BOX] * 3, 4)
    pos = torch.from_numpy(frames)
    cos, sin = ck.trig_sums(qs, pos, precision="fast")
    again = ck.trig_sums(qs, pos, precision="fast",
                         workspace=ck.trig_workspace(3, 700, len(qs), "cpu"))
    phases = frames.astype(np.float64) @ qs.T
    oc, osn = np.cos(phases).sum(axis=1), np.sin(phases).sum(axis=1)
    tol = 1e-4 * np.hypot(oc, osn).mean()
    assert np.abs(cos.numpy() - oc).max() <= tol
    assert np.abs(sin.numpy() - osn).max() <= tol
    assert torch.equal(cos, again[0]) and torch.equal(sin, again[1])
