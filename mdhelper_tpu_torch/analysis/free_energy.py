r"""
Free-energy estimators
======================

Equilibrium free-energy differences and potentials of mean force from
biased or multi-state sampling (beyond the reference, which stops at
Boltzmann-inversion PMFs — ``analysis/structure.py:925`` `calculate_pmf`
and the density-profile inversion): exponential averaging (Zwanzig
FEP), the Bennett acceptance ratio (BAR), the multistate Bennett
acceptance ratio (MBAR) and binned WHAM, plus an
:class:`UmbrellaSampling` convenience class that turns per-window
reaction-coordinate series + harmonic bias parameters into a PMF.

All estimators work on REDUCED potentials :math:`u = \beta U`
(dimensionless), the standard convention; :class:`UmbrellaSampling`
handles the :math:`\beta` bookkeeping from a temperature (or
``reduced=True`` LJ units) like the rest of the analysis layer.

The solvers are host-side float64 NumPy/SciPy, a copy of
:mod:`mdhelper_tpu.analysis.free_energy` with the port's units: an MBAR
iteration is one ``(K, N)`` matrix pass, milliseconds on the host at the
typical ``K <= 100`` windows, and the estimators need float64
conditioning (overlap matrices near-singular at poor window spacing).

References (methods, not code): Zwanzig, J. Chem. Phys. 22, 1420
(1954); Bennett, J. Comput. Phys. 22, 245 (1976); Shirts & Chodera,
J. Chem. Phys. 129, 124105 (2008) (MBAR); Kumar et al.,
J. Comput. Chem. 13, 1011 (1992) (WHAM).
"""

from typing import Sequence, Union

import numpy as np
from scipy.optimize import brentq, minimize
from scipy.special import log_ndtr, logsumexp

from .. import Q_, ureg
from ..algorithm.unit import strip_unit
from .base import Hash, SerialAnalysisBase

__all__ = [
    "fep",
    "bar",
    "mbar",
    "wham",
    "harmonic_bin_bias",
    "UmbrellaSampling",
]


def _log_gauss_cdf_diff(z1, z2):
    """``ln(Phi(z2) - Phi(z1))`` elementwise for ``z2 >= z1``,
    overflow-safe in both tails (works through z ~ +-40 where the
    direct CDF difference underflows)."""

    # Reflect to the left tail, where log_ndtr is accurate.
    flip = (z1 + z2) > 0
    a = np.where(flip, -z2, z1)
    b = np.where(flip, -z1, z2)
    lb = log_ndtr(b)
    la = log_ndtr(a)
    with np.errstate(invalid="ignore"):
        out = lb + np.log1p(-np.exp(np.minimum(la - lb, 0.0)))
    return np.where(la == lb, -np.inf, out)


def harmonic_bin_bias(
    edges: np.ndarray,
    centers: np.ndarray,
    beta_springs: np.ndarray,
    *,
    period: float = None,
) -> np.ndarray:
    r"""Bin-AVERAGED reduced harmonic-bias energies for binned WHAM.

    Binned WHAM evaluated with bin-center bias energies carries a
    systematic :math:`(\kappa d w)^2 / 24` discretization error (the
    bias gradient :math:`\kappa d` is steep in the window wings); the
    exact cure is to use the bin average of the Boltzmann factor,

    .. math::

       c_{kb} = -\ln \frac{1}{w_b} \int_{b} e^{-\frac{\beta\kappa_k}
       {2} (x - x^0_k)^2} \mathrm{d}x,

    which is an error-function difference for harmonic biases —
    evaluated here in log space so it stays finite ~40 bias standard
    deviations from the window center.

    Parameters
    ----------
    edges : array-like, shape ``(B + 1,)``
        Bin edges.
    centers : array-like, shape ``(K,)``
        Bias centers :math:`x^0_k`.
    beta_springs : array-like, shape ``(K,)`` or scalar
        Reduced spring constants :math:`\beta \kappa_k`.
    period : `float`, keyword-only, optional
        Coordinate periodicity; each (window, bin) pair integrates the
        harmonic image nearest the bin midpoint.

    Returns
    -------
    bias_kb : `numpy.ndarray`, shape ``(K, B)``
        Reduced bin-averaged bias energies, ready for :func:`wham`.
    """

    edges = np.asarray(edges, dtype=np.float64)
    centers = np.asarray(centers, dtype=np.float64).reshape(-1)
    bk = np.broadcast_to(
        np.asarray(beta_springs, dtype=np.float64), centers.shape
    )
    widths = np.diff(edges)
    mids = 0.5 * (edges[:-1] + edges[1:])

    eff_centers = centers[:, None] + np.zeros_like(mids)[None, :]
    if period is not None:
        eff_centers = eff_centers + period * np.round(
            (mids[None, :] - eff_centers) / period
        )

    if (bk < 0).any():
        raise ValueError("Spring constants must be non-negative.")
    out = np.empty((centers.size, mids.size))
    for k in range(centers.size):
        if bk[k] == 0:
            out[k] = 0.0
            continue
        s = np.sqrt(bk[k])
        z1 = s * (edges[:-1] - eff_centers[k])
        z2 = s * (edges[1:] - eff_centers[k])
        log_avg = (
            0.5 * np.log(2.0 * np.pi / bk[k])
            + _log_gauss_cdf_diff(z1, z2)
            - np.log(widths)
        )
        out[k] = -log_avg
    return out


def fep(delta_u: np.ndarray) -> float:
    r"""Zwanzig exponential-averaging (free-energy perturbation)
    estimate of a reduced free-energy difference.

    .. math::

       \Delta f = -\ln \left\langle e^{-\Delta u} \right\rangle_0

    Parameters
    ----------
    delta_u : array-like
        Reduced potential-energy differences
        :math:`u_1(x_n) - u_0(x_n)` evaluated on samples
        :math:`x_n` drawn from state 0.

    Returns
    -------
    delta_f : `float`
        Reduced free-energy difference :math:`f_1 - f_0`.
    """

    delta_u = np.asarray(delta_u, dtype=np.float64).reshape(-1)
    if delta_u.size == 0:
        raise ValueError("'delta_u' must contain at least one sample.")
    return -(logsumexp(-delta_u) - np.log(delta_u.size))


def bar(
    delta_u_forward: np.ndarray,
    delta_u_reverse: np.ndarray,
    *,
    tol: float = 1e-12,
    max_iter: int = 500,
) -> float:
    r"""Bennett acceptance ratio estimate of a reduced free-energy
    difference from forward and reverse work samples.

    Solves the implicit BAR equation

    .. math::

       \sum_{n \in F} \frac{1}{1 + e^{M + \Delta u^F_n - \Delta f}}
       = \sum_{n \in R} \frac{1}{1 + e^{-M + \Delta u^R_n + \Delta f}},
       \qquad M = \ln (N_F / N_R)

    by bracketed root finding (the left-minus-right residual is
    strictly increasing in :math:`\Delta f`).

    Parameters
    ----------
    delta_u_forward : array-like
        :math:`u_1(x_n) - u_0(x_n)` on samples from state 0.
    delta_u_reverse : array-like
        :math:`u_0(x_n) - u_1(x_n)` on samples from state 1.
    tol : `float`, keyword-only, default :code:`1e-12`
        Root-find tolerance on :math:`\Delta f`.
    max_iter : `int`, keyword-only, default 500
        Maximum bracket-expansion + bisection iterations.

    Returns
    -------
    delta_f : `float`
        Reduced free-energy difference :math:`f_1 - f_0`.
    """

    w_f = np.asarray(delta_u_forward, dtype=np.float64).reshape(-1)
    w_r = np.asarray(delta_u_reverse, dtype=np.float64).reshape(-1)
    if w_f.size == 0 or w_r.size == 0:
        raise ValueError(
            "BAR requires samples in both the forward and reverse "
            "directions."
        )
    m = np.log(w_f.size / w_r.size)

    def fermi(x):
        # 1 / (1 + exp(x)), overflow-safe.
        out = np.empty_like(x)
        pos = x >= 0
        out[pos] = np.exp(-x[pos]) / (1.0 + np.exp(-x[pos]))
        out[~pos] = 1.0 / (1.0 + np.exp(x[~pos]))
        return out

    def residual(df):
        return fermi(m + w_f - df).sum() - fermi(-m + w_r + df).sum()

    # Initial guess from the two one-sided FEP estimates (forward
    # estimates f1-f0 directly, reverse estimates f0-f1), then expand
    # the bracket until the residual changes sign.
    forward, reverse = fep(w_f), -fep(w_r)
    lo, hi = min(forward, reverse), max(forward, reverse)
    span = max(1.0, hi - lo)
    lo, hi = lo - span, hi + span
    for _ in range(max_iter):
        if residual(lo) * residual(hi) <= 0:
            break
        span *= 2.0
        lo -= span
        hi += span
    else:
        raise RuntimeError("BAR bracket expansion failed to converge.")
    return brentq(residual, lo, hi, xtol=tol, maxiter=max_iter)


def _mbar_log_denominator(u_kn, n_k, f_k):
    """``d_n = logsumexp_k(ln N_k + f_k - u_kn)`` — the MBAR mixture
    log-denominator, shape ``(N,)``."""

    return logsumexp(
        np.log(n_k)[:, None] + f_k[:, None] - u_kn, axis=0
    )


def mbar(
    u_kn: np.ndarray,
    n_k: np.ndarray,
    *,
    tol: float = 1e-10,
    max_iter: int = 1000,
    uncertainties: bool = True,
    initial_f_k: np.ndarray = None,
) -> Hash:
    r"""Multistate Bennett acceptance ratio: reduced free energies of
    :math:`K` thermodynamic states from samples pooled across all of
    them.

    Minimizes the convex MBAR objective

    .. math::

       F(\mathbf f) = \frac{1}{N}\sum_n \ln \sum_k N_k
       e^{f_k - u_{kn}} - \sum_k \frac{N_k}{N} f_k

    (whose stationary point is the MBAR self-consistency equations)
    with L-BFGS in float64, anchored at :math:`f_0 = 0`.

    Parameters
    ----------
    u_kn : array-like, shape ``(K, N)``
        Reduced potential of every pooled sample ``n`` evaluated in
        every state ``k`` (samples concatenated state-major:
        ``n_k[0]`` samples from state 0 first, etc.; the estimator
        itself is permutation-invariant).
    n_k : array-like, shape ``(K,)``
        Number of samples drawn from each state (``sum(n_k) == N``;
        states with ``n_k == 0`` are valid *unsampled* targets).
    tol : `float`, keyword-only, default :code:`1e-10`
        Gradient tolerance of the L-BFGS solve.
    max_iter : `int`, keyword-only, default 1000
        Maximum L-BFGS iterations.
    uncertainties : `bool`, keyword-only, default :code:`True`
        Also estimate the asymptotic covariance of the free energies
        (SVD form of the MBAR covariance; Shirts & Chodera appendix D)
        and store pairwise uncertainties vs state 0.
    initial_f_k : array-like, keyword-only, optional
        Warm-start free energies (e.g. from a previous solve).

    Returns
    -------
    results : :class:`mdhelper_tpu_torch.analysis.base.Hash`
        ``results.free_energies`` — reduced :math:`f_k` with
        :math:`f_0 = 0`; ``results.log_denominators`` — the per-sample
        mixture log-denominators :math:`d_n` (the reusable piece for
        reweighted expectations and PMFs);
        ``results.uncertainties`` — ``d(f_k - f_0)`` when requested;
        ``results.n_iterations``, ``results.converged``.
    """

    u_kn = np.asarray(u_kn, dtype=np.float64)
    n_k = np.asarray(n_k, dtype=np.float64).reshape(-1)
    if u_kn.ndim != 2 or u_kn.shape[0] != n_k.size:
        raise ValueError(
            "'u_kn' must have shape (K, N) with K == len(n_k); got "
            f"{u_kn.shape} and K={n_k.size}."
        )
    n_total = u_kn.shape[1]
    if n_k.sum() != n_total:
        raise ValueError(
            f"sum(n_k) = {int(n_k.sum())} != N = {n_total}."
        )
    if (n_k < 0).any() or n_k.max() <= 0:
        raise ValueError("'n_k' needs at least one sampled state.")

    sampled = n_k > 0
    u_s = u_kn[sampled]
    n_s = n_k[sampled]
    k_s = int(sampled.sum())

    def objective(f):
        d_n = _mbar_log_denominator(u_s, n_s, f)
        value = d_n.mean() - (n_s / n_total) @ f
        # W_nk = exp(ln N_k + f_k - u_kn - d_n); grad = col-means - N_k/N
        log_w = np.log(n_s)[:, None] + f[:, None] - u_s - d_n[None]
        grad = np.exp(log_w).sum(axis=1) / n_total - n_s / n_total
        return value, grad

    if initial_f_k is not None:
        f0 = np.asarray(initial_f_k, np.float64).reshape(-1)[sampled]
        f0 = f0 - f0[0]
    else:
        f0 = np.zeros(k_s)
    # Anchor f_0 = 0: optimize the K-1 tail (the objective is
    # invariant under a uniform shift, which L-BFGS dislikes).
    def tail_objective(f_tail):
        f = np.concatenate([[0.0], f_tail])
        value, grad = objective(f)
        return value, grad[1:]

    if k_s == 1:
        f_solved = np.zeros(1)
        converged, n_it = True, 0
    else:
        res = minimize(
            tail_objective,
            f0[1:],
            jac=True,
            method="L-BFGS-B",
            options={"maxiter": max_iter, "gtol": tol, "ftol": 0.0},
        )
        f_solved = np.concatenate([[0.0], res.x])
        converged, n_it = bool(res.success), int(res.nit)

    # Free energies of UNSAMPLED states by reweighting; d_n from the
    # sampled mixture only.
    d_n = _mbar_log_denominator(u_s, n_s, f_solved)
    f_k = np.empty(n_k.size)
    f_k[sampled] = f_solved
    if (~sampled).any():
        f_k[~sampled] = -(
            logsumexp(-u_kn[~sampled] - d_n[None], axis=1)
        )
    # Re-anchor at state 0 — shifting f_k and d_n TOGETHER keeps the
    # gauge consistent (W_nk = exp(f_k - u_kn - d_n) is invariant), so
    # the returned log_denominators remain usable for external
    # reweighting and the covariance weights still column-sum to 1
    # even when state 0 is an unsampled target.
    shift = f_k[0]
    f_k = f_k - shift
    d_n = d_n - shift

    results = Hash(
        free_energies=f_k,
        log_denominators=d_n,
        n_iterations=n_it,
        converged=converged,
        units={"results.free_energies": ureg.dimensionless},
    )

    if uncertainties:
        # Shirts & Chodera (2008) appendix D, SVD form: with
        # W in R^{N x K} (all K states), Theta = V S (I - S V^T diag(N)
        # V S)^+ S V^T, d(f_i - f_j)^2 = Th_ii + Th_jj - 2 Th_ij.
        log_w_full = -u_kn - d_n[None] + f_k[:, None]  # (K, N)
        w = np.exp(log_w_full).T  # (N, K), columns sum to ~1
        u_svd, s_svd, vt = np.linalg.svd(w, full_matrices=False)
        s_mat = np.diag(s_svd)
        inner = np.eye(n_k.size) - s_mat @ vt @ np.diag(n_k) @ vt.T @ s_mat
        theta = vt.T @ s_mat @ np.linalg.pinv(inner) @ s_mat @ vt
        d2 = np.maximum(
            np.diag(theta)[None, :]
            + np.diag(theta)[:, None]
            - 2.0 * theta,
            0.0,
        )
        results.uncertainties = np.sqrt(d2[0])
        results.covariance = theta

    return results


def wham(
    counts_kb: np.ndarray,
    bias_kb: np.ndarray,
    n_k: np.ndarray = None,
    *,
    tol: float = 1e-10,
    max_iter: int = 100_000,
) -> Hash:
    r"""Binned weighted-histogram analysis (WHAM) over :math:`K`
    biased windows and :math:`B` reaction-coordinate bins.

    Iterates the coupled WHAM equations in log space until the window
    free energies are stationary:

    .. math::

       p_b \propto \frac{\sum_k h_{kb}}
       {\sum_k N_k e^{f_k - c_{kb}}},
       \qquad
       e^{-f_k} = \sum_b e^{-c_{kb}} p_b

    Parameters
    ----------
    counts_kb : array-like, shape ``(K, B)``
        Per-window histogram of the reaction coordinate.
    bias_kb : array-like, shape ``(K, B)``
        Reduced bias energy of window ``k`` in bin ``b``.  For steep
        biases pass BIN-AVERAGED values
        (:math:`c_{kb} = -\ln \langle e^{-\beta W_k}\rangle_b`, e.g.
        :func:`harmonic_bin_bias`) rather than bin-center evaluations
        :math:`\beta W_k(x_b)` — the latter carry a systematic
        :math:`(\partial_x \beta W \cdot w)^2 / 24` discretization
        error in the window wings.
    n_k : array-like, shape ``(K,)``, optional
        Samples per window; defaults to ``counts_kb.sum(axis=1)``.
    tol : `float`, keyword-only, default :code:`1e-10`
        Max-abs change in :math:`f_k` per iteration at convergence.
    max_iter : `int`, keyword-only, default 100000
        Iteration cap.

    Returns
    -------
    results : :class:`mdhelper_tpu_torch.analysis.base.Hash`
        ``results.pmf`` — reduced PMF :math:`-\ln p_b` shifted to
        min 0 (NaN for empty bins); ``results.probabilities``;
        ``results.free_energies`` — per-window :math:`f_k`;
        ``results.n_iterations``, ``results.converged``.
    """

    counts = np.asarray(counts_kb, dtype=np.float64)
    bias = np.asarray(bias_kb, dtype=np.float64)
    if counts.shape != bias.shape or counts.ndim != 2:
        raise ValueError(
            "'counts_kb' and 'bias_kb' must share a (K, B) shape; got "
            f"{counts.shape} and {bias.shape}."
        )
    n_k = (
        counts.sum(axis=1)
        if n_k is None
        else np.asarray(n_k, dtype=np.float64).reshape(-1)
    )
    if n_k.size != counts.shape[0]:
        raise ValueError("'n_k' must have one entry per window.")

    total_b = counts.sum(axis=0)  # (B,)
    occupied = total_b > 0
    if not occupied.any():
        raise ValueError(
            "Every bin is empty — no samples fall inside the binning "
            "range."
        )
    # No clamp: fractional (weighted-histogram) totals in (0, 1) are
    # legitimate and must enter the log as-is.
    log_total = np.where(
        occupied, np.log(np.where(occupied, total_b, 1.0)), -np.inf
    )
    # Windows without any in-range samples contribute nothing to the
    # equations; solve over the active subset and report NaN free
    # energies for the rest.
    active = n_k > 0
    if not active.any():
        raise ValueError("Every window has zero samples.")
    log_n_a = np.log(n_k[active])
    bias_a = bias[active]

    f_a = np.zeros(int(active.sum()))
    converged = False
    for iteration in range(1, max_iter + 1):
        # log p_b (unnormalized)
        log_denom = logsumexp(
            log_n_a[:, None] + f_a[:, None] - bias_a, axis=0
        )
        log_p = log_total - log_denom
        f_new = -logsumexp(-bias_a + log_p[None, :], axis=1)
        f_new = f_new - f_new[0]
        delta = np.abs(f_new - f_a).max()
        f_a = f_new
        if delta < tol:
            converged = True
            break

    log_denom = logsumexp(
        log_n_a[:, None] + f_a[:, None] - bias_a, axis=0
    )
    log_p = log_total - log_denom
    log_p = log_p - logsumexp(log_p[occupied])
    p = np.where(occupied, np.exp(log_p), 0.0)
    pmf = np.where(occupied, -log_p, np.nan)
    pmf = pmf - np.nanmin(pmf)

    f_k = np.full(counts.shape[0], np.nan)
    f_k[active] = f_a

    return Hash(
        pmf=pmf,
        probabilities=p,
        free_energies=f_k,
        n_iterations=iteration,
        converged=converged,
        units={"results.pmf": ureg.dimensionless},
    )


class UmbrellaSampling:
    r"""Potential of mean force along a scalar reaction coordinate
    from harmonically biased (umbrella-sampling) windows.

    Each window :math:`k` carries a reaction-coordinate time series
    :math:`x^{(k)}_n` sampled under the bias
    :math:`W_k(x) = \tfrac12 \kappa_k (x - x^0_k)^2` (minimum-image
    wrapped when ``period`` is given — dihedral coordinates).  The PMF
    is estimated with MBAR (default; unbinned, with per-state
    uncertainties) or binned WHAM.

    Beyond the reference: mdhelper stops at Boltzmann-inversion PMFs
    of unbiased densities (``analysis/profile.py`` and
    ``analysis/structure.py:925``); biased-sampling reweighting is new
    capability.

    Parameters
    ----------
    series : sequence of array-like
        Per-window reaction-coordinate series (lengths may differ).
    centers : array-like
        Bias centers :math:`x^0_k`, one per window.
    spring_constants : `float` or array-like
        Bias spring constants :math:`\kappa_k` (kJ/mol/units²; kT
        units when ``reduced=True``).  Scalars broadcast.
    temperature : `float` or `pint.Quantity`, keyword-only
        System temperature (K), or the reduced temperature
        :math:`T^* = k_\mathrm B T / \epsilon` when ``reduced=True``.
    reduced : `bool`, keyword-only, default :code:`False`
        Whether inputs are in reduced (LJ) units.
    period : `float`, keyword-only, optional
        Periodicity of the coordinate (e.g. :math:`360` for a
        dihedral in degrees); bias displacements are minimum-image
        wrapped.
    method : `str`, keyword-only, default ``"mbar"``
        ``"mbar"`` or ``"wham"``.

    Attributes
    ----------
    results : :class:`mdhelper_tpu_torch.analysis.base.Hash`
        After :meth:`run`: ``results.bin_centers``, ``results.pmf``
        (kJ/mol; kT when ``reduced=True``), ``results.window_free_
        energies`` (reduced), ``results.units``, and (MBAR)
        ``results.pmf_uncertainties``.

    Examples
    --------
    >>> us = UmbrellaSampling(series, centers, 10.0, temperature=300)
    >>> us.run(n_bins=50)
    >>> us.results.pmf  # kJ/mol, min 0
    """

    def __init__(
        self,
        series: Sequence[np.ndarray],
        centers: np.ndarray,
        spring_constants: Union[float, np.ndarray],
        *,
        temperature: Union[float, "Q_"],
        reduced: bool = False,
        period: float = None,
        method: str = "mbar",
    ) -> None:
        if method not in ("mbar", "wham"):
            raise ValueError(
                f"Invalid method '{method}'. Valid values: 'mbar', "
                "'wham'."
            )
        self._series = [
            np.asarray(s, dtype=np.float64).reshape(-1) for s in series
        ]
        if any(s.size == 0 for s in self._series):
            raise ValueError("Every window needs at least one sample.")
        self._centers = np.asarray(
            centers, dtype=np.float64
        ).reshape(-1)
        if len(self._series) != self._centers.size:
            raise ValueError(
                "The number of series does not match the number of "
                "bias centers."
            )
        self._springs = np.broadcast_to(
            np.asarray(spring_constants, dtype=np.float64),
            self._centers.shape,
        ).copy()
        if (self._springs < 0).any():
            raise ValueError(
                "Spring constants must be non-negative."
            )
        self._period = None if period is None else float(period)
        self._method = method
        self._reduced = reduced

        temperature, unit_ = strip_unit(temperature, "kelvin")
        if reduced:
            if not isinstance(unit_, (str, type(None))):
                raise TypeError(
                    "'temperature' cannot have units when "
                    "reduced=True."
                )
            self._kBT = float(temperature)
        else:
            self._kBT = (
                ureg.avogadro_constant
                * ureg.boltzmann_constant
                * temperature
                * ureg.kelvin
            ).m_as(ureg.kilojoule / ureg.mole)

        self.results = Hash(units={})

    def _displacement(self, x, center):
        d = x - center
        if self._period is not None:
            d -= self._period * np.round(d / self._period)
        return d

    def run(
        self,
        n_bins: int = 100,
        range: tuple = None,
    ) -> "UmbrellaSampling":
        """Estimate the PMF.

        Parameters
        ----------
        n_bins : `int`, default 100
            Number of reaction-coordinate bins for the reported PMF
            (and for the WHAM solve).
        range : `tuple`, optional
            ``(min, max)`` of the binning; defaults to the pooled
            sample range.

        Returns
        -------
        self : :class:`UmbrellaSampling`
        """

        x_n = np.concatenate(self._series)
        n_k = np.array([s.size for s in self._series])
        if range is None:
            lo, hi = float(x_n.min()), float(x_n.max())
            pad = 1e-9 * max(1.0, abs(hi - lo))
            range_ = (lo - pad, hi + pad)
        else:
            range_ = (float(range[0]), float(range[1]))
        edges = np.linspace(range_[0], range_[1], n_bins + 1)
        centers_b = 0.5 * (edges[:-1] + edges[1:])

        # Reduced bias energies of every pooled sample in every window.
        beta_springs = self._springs / self._kBT
        disp = np.stack(
            [self._displacement(x_n, c) for c in self._centers]
        )
        u_kn = 0.5 * beta_springs[:, None] * disp**2

        self.results.bin_centers = centers_b
        self.results.units["results.pmf"] = (
            ureg.dimensionless
            if self._reduced
            else ureg.kilojoule / ureg.mole
        )

        # Samples outside the binning range never enter a bin (they
        # would otherwise pile into the edge bins and fake deep
        # minima there); MBAR still uses them for the window free
        # energies, and WHAM runs the consistent truncated-domain
        # equations on in-range counts.  The right edge is CLOSED,
        # matching np.histogram's last bin (so both methods bin
        # boundary samples identically).
        in_range = (x_n >= edges[0]) & (x_n <= edges[-1])
        if not in_range.any():
            raise ValueError(
                f"No samples fall inside range {range_} — check the "
                "coordinate units/wrapping."
            )

        if self._method == "wham":
            counts = np.stack(
                [
                    np.histogram(s, bins=edges)[0].astype(np.float64)
                    for s in self._series
                ]
            )
            # Bin-AVERAGED bias Boltzmann factors (erf integrals):
            # bin-center evaluation carries a (kappa d w)^2 / 24
            # systematic error in the window wings.
            bias_kb = harmonic_bin_bias(
                edges, self._centers, beta_springs,
                period=self._period,
            )
            solved = wham(counts, bias_kb)
            pmf = solved.pmf
            self.results.window_free_energies = solved.free_energies
            self.results.converged = solved.converged
        else:
            solved = mbar(u_kn, n_k, uncertainties=False)
            d_n = solved.log_denominators
            # Unbiased (zero-potential beyond the bias) reweighting:
            # ln p_b = logsumexp over samples in bin b of -d_n.
            bin_idx = np.digitize(x_n[in_range], edges) - 1
            np.clip(bin_idx, 0, n_bins - 1, out=bin_idx)
            log_p = np.full(n_bins, -np.inf)
            neg_d = -d_n[in_range]
            for b in np.unique(bin_idx):
                log_p[b] = logsumexp(neg_d[bin_idx == b])
            occupied = np.isfinite(log_p)
            log_p -= logsumexp(log_p[occupied])
            pmf = np.where(occupied, -log_p, np.nan)
            pmf -= np.nanmin(pmf)
            # Per-bin statistical uncertainty from effective counts:
            # d(pmf_b) ~ 1/sqrt(n_eff_b) with Kish effective sample
            # sizes of the per-bin weights.
            w = np.exp(neg_d - logsumexp(neg_d))
            n_eff = np.zeros(n_bins)
            for b in np.unique(bin_idx):
                wb = w[bin_idx == b]
                s = wb.sum()
                n_eff[b] = (s * s / (wb * wb).sum()) if s > 0 else 0.0
            with np.errstate(divide="ignore"):
                self.results.pmf_uncertainties = np.where(
                    n_eff > 0, 1.0 / np.sqrt(np.maximum(n_eff, 1e-300)),
                    np.nan,
                ) * (1.0 if self._reduced else self._kBT)
            self.results.window_free_energies = (
                solved.free_energies
            )
            self.results.converged = solved.converged

        self.results.pmf = pmf * (
            1.0 if self._reduced else self._kBT
        )
        return self

    # The analysis-layer persistence convention (saves EVERY results
    # entry incl. convergence flags and units metadata, with the same
    # archive/compress options); only touches self.results, so the
    # unbound base method applies directly.
    save = SerialAnalysisBase.save
