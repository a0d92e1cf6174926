"""The port's free-energy estimators against the JAX package's.

Both are host float64 numpy/scipy (the port's module is a copy with its
own units), so on the same seeded samples every result agrees within
``rtol=1e-12`` (the iterative solvers take the same steps), and the
estimates stay within the JAX tests' bounds of the analytic answers of
exactly samplable Gaussian and harmonic systems.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from mdhelper_tpu import Q_ as JQ  # noqa: E402
from mdhelper_tpu.analysis import free_energy as jax_fe  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.analysis import free_energy as fe  # noqa: E402


def _gaussian(a, mu, n, rng):
    """Samples from p(x) ~ exp(-a (x - mu)^2)."""

    return rng.normal(mu, np.sqrt(0.5 / a), size=n)


def _u(a, mu, x):
    return a * (x - mu) ** 2


def _windows(a, centers, kappa, n, rng):
    """Exact samples from U0 = a x^2 / 2 under biases kappa (x - c)^2 / 2."""

    prec = a + kappa
    return [rng.normal(kappa * c / prec, np.sqrt(1.0 / prec), size=n)
            for c in centers]


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, equal_nan=True)


def test_fep_and_bar_match_jax_and_analytic():
    a0, mu0, a1, mu1 = 0.5, 0.0, 2.0, 0.4
    exact = 0.5 * np.log(a1 / a0)
    rng = np.random.default_rng(7)
    x0 = _gaussian(a0, mu0, 20_000, rng)
    x1 = _gaussian(a1, mu1, 20_000, rng)
    w_f = _u(a1, mu1, x0) - _u(a0, mu0, x0)
    w_r = _u(a0, mu0, x1) - _u(a1, mu1, x1)
    _close(fe.fep(w_f), jax_fe.fep(w_f))
    _close(fe.bar(w_f, w_r), jax_fe.bar(w_f, w_r))
    assert fe.bar(w_f, w_r) == pytest.approx(exact, abs=0.015)
    with pytest.raises(ValueError, match="forward and reverse"):
        fe.bar([1.0, 2.0], [])


@pytest.mark.parametrize("unsampled", [False, True])
def test_mbar_matches_jax_and_analytic(unsampled):
    a_k = np.array([0.5, 1.0, 2.0, 4.0])
    mu_k = np.array([0.0, 0.3, 0.5, 0.6])
    exact = 0.5 * np.log(a_k / np.pi)
    exact -= exact[0]
    rng = np.random.default_rng(11)
    n_k = np.array([6000, 6000, 0 if unsampled else 6000, 6000])
    x_n = np.concatenate([_gaussian(a, mu, n, rng)
                          for a, mu, n in zip(a_k, mu_k, n_k)])
    u_kn = np.stack([_u(a, mu, x_n) for a, mu in zip(a_k, mu_k)])
    ref = jax_fe.mbar(u_kn, n_k)
    out = fe.mbar(u_kn, n_k)
    assert set(out) == set(ref)
    for key in ref:
        if key != "units":
            _close(out[key], ref[key])
    assert out.converged
    np.testing.assert_allclose(out.free_energies, exact, atol=0.04)
    with pytest.raises(ValueError):
        fe.mbar(u_kn, n_k[:2])


def test_wham_and_bin_bias_match_jax():
    a, kappa = 1.2, 12.0
    centers = np.linspace(-2.0, 2.0, 11)
    rng = np.random.default_rng(5)
    series = _windows(a, centers, kappa, 8000, rng)
    edges = np.linspace(-2.2, 2.2, 45)
    counts = np.stack([np.histogram(s, bins=edges)[0] for s in series]
                      ).astype(np.float64)
    for period in (None, 4.4):
        _close(fe.harmonic_bin_bias(edges, centers, kappa, period=period),
               jax_fe.harmonic_bin_bias(edges, centers, kappa,
                                        period=period))
    bias = fe.harmonic_bin_bias(edges, centers, kappa)
    ref = jax_fe.wham(counts, bias)
    out = fe.wham(counts, bias)
    for key in ("pmf", "free_energies", "converged"):
        _close(out[key], ref[key])
    mids = 0.5 * (edges[1:] + edges[:-1])
    exact = 0.5 * a * mids**2
    ok = np.isfinite(out.pmf) & (np.abs(mids) < 1.8)
    np.testing.assert_allclose(out.pmf[ok] - out.pmf[ok].min(),
                               exact[ok] - exact[ok].min(), atol=0.1)
    with pytest.raises(ValueError):
        fe.wham(counts[:, :3], bias)


@pytest.mark.parametrize("method", ["mbar", "wham"])
@pytest.mark.parametrize("units", ["reduced", "kelvin", "quantity",
                                   "periodic"])
def test_umbrella_sampling_matches_jax(method, units, tmp_path):
    a, kappa = 1.5, 15.0
    centers = np.linspace(-1.8, 1.8, 9)
    rng = np.random.default_rng(9)
    series = _windows(a, centers, kappa, 2000, rng)
    kwargs = {
        "reduced": dict(temperature=1.0, reduced=True),
        "kelvin": dict(temperature=300.0),
        "quantity": dict(temperature=Q_(300.0, "K")),
        "periodic": dict(temperature=1.0, reduced=True, period=5.0),
    }[units]
    jkw = dict(kwargs)
    if units == "quantity":
        jkw["temperature"] = JQ(300.0, "K")
    ref = jax_fe.UmbrellaSampling(series, centers, kappa, method=method,
                                  **jkw).run(n_bins=24, range=(-2.0, 2.0))
    out = fe.UmbrellaSampling(series, centers, kappa, method=method,
                              **kwargs).run(n_bins=24, range=(-2.0, 2.0))
    assert set(out.results) == set(ref.results)
    for key in out.results:
        if key == "units":
            assert {k: str(v) for k, v in out.results.units.items()} == {
                k: str(v) for k, v in ref.results.units.items()}
        else:
            _close(out.results[key], ref.results[key])
    out.save(str(tmp_path / "us"))
    saved = np.load(str(tmp_path / "us.npz"), allow_pickle=True)
    _close(saved["pmf"], out.results.pmf)


def test_umbrella_sampling_validation():
    for args, kwargs, error, match in (
            (([[0.0]], [0.0], 1.0), dict(method="tram"), ValueError,
             "Invalid method"),
            (([[]], [0.0], 1.0), {}, ValueError, "at least one sample"),
            (([[0.0], [0.1]], [0.0], 1.0), {}, ValueError, "bias centers"),
            (([[0.0]], [0.0], -1.0), {}, ValueError, "non-negative"),
            (([[0.0]], [0.0], 1.0), dict(temperature=Q_(1.0, "K")),
             TypeError, "cannot have units")):
        options = dict(temperature=1.0, reduced=True)
        options.update(kwargs)
        with pytest.raises(error, match=match):
            fe.UmbrellaSampling(*args, **options)
    us = fe.UmbrellaSampling([[0.0, 0.1]], [0.0], 1.0, temperature=1.0,
                             reduced=True)
    with pytest.raises(ValueError, match="No samples"):
        us.run(n_bins=4, range=(5.0, 6.0))
