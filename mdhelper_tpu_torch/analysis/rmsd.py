r"""
Structural superposition
========================

RMSD time series, per-atom RMSF, and the principal and time-lagged
independent components of the aligned coordinates, with optimal
(weighted) superposition, ported from :mod:`mdhelper_tpu.analysis.rmsd`.

The optimal rotation comes from the quaternion (Davenport/Theobald)
formulation: a frame's ``3 x 3`` weighted covariance feeds a symmetric
``4 x 4`` eigenproblem whose top eigenvector is the rotation's
quaternion.  A chunk's frames are fitted together: one batched
``torch.linalg.eigh`` of ``(B, 4, 4)`` a chunk (on a GPU it checks its
status on the host once a call, so never once a frame).

The fit runs in float64: the streamed float32 coordinates are cast, and
the center, covariance, eigenproblem and aligned coordinates are
float64.  The RMSD is taken from the aligned coordinates,
:math:`\sum_i w_i |R\,p_i - q_i|^2 / W`.  The JAX package takes it from
the top eigenvalue, :math:`(G_p + G_q - 2\lambda_{\max}) / W`, in the
stream dtype; that difference cancels (for a 30 A protein at 0.1 A RMSD
it is about 1e-4 of :math:`G_p`), which moves a float32 RMSD by about
1e-3 A, and in float64 still leaves a few multiples of
:math:`\sqrt{\epsilon_{64} G_p / W}` (1e-7 A at a 17 A radius of
gyration) at RMSD 0.  The float64 fit matches a float64 oracle to about
1e-12.  RMSF and PCA accumulate float64 moments on the device, TICA also
its lagged moments from a lag ring that stays on the device across
chunks.  Their conclusions (``eigh`` of the ``3N x 3N`` covariance, the
sign rule, the whitening) run in float64 on the analysis's device.

Superposition assumes whole (unwrapped) structures: fold molecules
before aligning; minimum-image conventions do not apply to rigid-body
fits.
"""

import numpy as np
import torch

from .. import ureg
from .base import DynamicAnalysisBase

#: cap on one ``transform()`` read (float64 frames at the universe's full
#: atom width, as the JAX package caps its host reads).
_TRANSFORM_BLOCK_BYTES = 2**28

__all__ = ["PrincipalComponentAnalysis", "RMSD", "RMSF", "TICA"]


def _stack(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _davenport_k(c):
    r"""Symmetric ``(..., 4, 4)`` Davenport matrix of the ``(..., 3, 3)``
    weighted covariance :math:`C = \sum_i w_i p_i q_i^T`."""

    c11, c12, c13 = c[..., 0, 0], c[..., 0, 1], c[..., 0, 2]
    c21, c22, c23 = c[..., 1, 0], c[..., 1, 1], c[..., 1, 2]
    c31, c32, c33 = c[..., 2, 0], c[..., 2, 1], c[..., 2, 2]
    return _stack([
        [c11 + c22 + c33, c23 - c32, c31 - c13, c12 - c21],
        [c23 - c32, c11 - c22 - c33, c12 + c21, c13 + c31],
        [c31 - c13, c12 + c21, -c11 + c22 - c33, c23 + c32],
        [c12 - c21, c13 + c31, c23 + c32, -c11 - c22 + c33],
    ])


def _rotation_from_quaternion(q):
    """``(..., 4)`` scalar-first unit quaternions to ``(..., 3, 3)``
    proper rotation matrices."""

    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _stack([
        [qw * qw + qx * qx - qy * qy - qz * qz,
         2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz),
         qw * qw - qx * qx + qy * qy - qz * qz,
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy),
         2 * (qy * qz + qw * qx),
         qw * qw - qx * qx - qy * qy + qz * qz],
    ])


def _sign_rule(vecs):
    """Columns of `vecs` with each one's largest-magnitude entry made
    positive (the first such entry on a tie)."""

    peaks = vecs.abs().argmax(dim=0)
    signs = torch.sign(vecs[peaks, torch.arange(vecs.shape[1],
                                                device=vecs.device)])
    return vecs * torch.where(signs == 0, 1.0, signs)


class _SuperpositionBase(DynamicAnalysisBase):
    """Reference handling and the batched float64 fit of a chunk."""

    def __init__(self, group, reference=None, *, align: bool = True,
                 weights=None, reduced: bool = False, parallel: bool = False,
                 verbose: bool = True, device=None) -> None:
        self.group = group
        self.universe = group.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device)
        if group.n_atoms < 3:
            raise ValueError(
                "'group' must contain at least 3 atoms for a rigid-body "
                "fit."
            )
        self._align = bool(align)
        self._reduced = reduced
        self._atom_indices = group.ix
        if weights is None:
            w = np.ones(group.n_atoms)
        elif isinstance(weights, str):
            if weights != "mass":
                raise ValueError(
                    "'weights' must be None, 'mass', or an array."
                )
            w = np.asarray(group.masses, dtype=np.float64)
        else:
            w = np.asarray(weights, dtype=np.float64)
            if w.shape != (group.n_atoms,):
                raise ValueError(
                    "'weights' must have one value per group atom."
                )
        if not (w >= 0).all() or w.sum() == 0:
            raise ValueError(
                "'weights' must be non-negative with positive sum."
            )
        self._weights = w
        self._reference_spec = reference

    def _resolve_reference(self) -> None:
        ref = self._reference_spec
        if ref is None:
            ref = 0
        if isinstance(ref, (int, np.integer)):
            positions, _ = self._trajectory.read_frames([int(ref)])
            ref = positions[0][self._atom_indices]
        ref = np.asarray(ref, dtype=np.float64)
        if ref.shape != (len(self._atom_indices), 3):
            raise ValueError(
                "'reference' must be a frame index or an "
                f"({len(self._atom_indices)}, 3) coordinate array."
            )
        w = self._weights
        self._w_total = float(w.sum())
        com = (w[:, None] * ref).sum(axis=0) / self._w_total
        self._ref_centered = ref - com
        self._ref_com = com

    def _fit_fn(self):
        """``fit(positions (B, N, 3)) -> (rmsd (B,), rotations (B, 3, 3),
        aligned (B, N, 3))`` in float64: each frame centered on its
        weighted center, rotated onto the centered reference (with
        ``align``), and its RMSD."""

        device = self._device
        dtype = torch.float64
        align = self._align
        w = torch.as_tensor(self._weights, device=device, dtype=dtype)
        ref = torch.as_tensor(self._ref_centered, device=device, dtype=dtype)
        w_total = self._w_total

        def fit(positions):
            x = positions.to(dtype)
            com = torch.einsum("n,bnd->bd", w, x) / w_total
            pc = x - com[:, None, :]
            if not align:
                diff = pc - ref
                ss = torch.einsum("n,bnd->b", w, diff * diff)
                rot = torch.eye(3, dtype=dtype, device=device)
                return (torch.sqrt(torch.clamp(ss / w_total, min=0.0)),
                        rot.expand(len(x), 3, 3), pc)
            c = torch.einsum("bnd,ne->bde", pc * w[:, None], ref)
            _, vecs = torch.linalg.eigh(_davenport_k(c))
            rot = _rotation_from_quaternion(vecs[..., :, -1])
            aligned = torch.einsum("bnd,bed->bne", pc, rot)
            diff = aligned - ref
            ss = torch.einsum("n,bnd->b", w, diff * diff)
            return torch.sqrt(ss / w_total), rot, aligned

        return fit

    def _project_aligned(self, comps: np.ndarray,
                         mean_x: np.ndarray) -> np.ndarray:
        """Re-read the analyzed frames in blocks of at most
        ``_TRANSFORM_BLOCK_BYTES`` (float64 frames at the universe's
        width), align each block on the device in float64, and project
        the mean-centered flattened coordinates onto the ``(3N, k)``
        component columns."""

        device = self._device
        fit = self._fit_fn()
        comps = torch.as_tensor(comps, device=device)
        mean_x = torch.as_tensor(mean_x, device=device)
        frames = np.asarray(self.frames)
        n_universe = self.universe.atoms.n_atoms
        block = max(1, int(_TRANSFORM_BLOCK_BYTES
                           // max(n_universe * 24, 1)))
        out = []
        for lo in range(0, len(frames), block):
            positions, _ = self._trajectory.read_frames(frames[lo:lo + block])
            positions = torch.as_tensor(
                np.asarray(positions)[:, self._atom_indices], device=device)
            aligned = fit(positions)[2].reshape(len(positions), -1)
            out.append(((aligned - mean_x) @ comps).cpu().numpy())
        return np.concatenate(out) if out else np.empty((0, comps.shape[1]))


class RMSD(_SuperpositionBase):
    r"""Root-mean-square deviation from a reference structure.

    Per frame the optimally superposed (weighted) RMSD

    .. math::

       \mathrm{RMSD}(t) = \min_{R} \sqrt{\frac{\sum_i w_i
       |R\,(\mathbf{r}_i(t) - \mathbf{r}_\mathrm{com}) -
       (\mathbf{r}_i^\mathrm{ref} -
       \mathbf{r}_\mathrm{com}^\mathrm{ref})|^2}{\sum_i w_i}}

    by the quaternion eigenvalue method (the optimal rotation is reported
    too).

    Parameters
    ----------
    group : `AtomGroup`
        Atoms to fit.
    reference : `int` or array-like, optional
        Reference frame index (default 0) or explicit ``(N, 3)``
        coordinates.
    align : `bool`, keyword-only, default True
        Remove the optimal rigid-body rotation (and the COM shift).  With
        ``align=False`` the RMSD is computed after centering only.
    weights : `None`, ``"mass"`` or array-like, keyword-only
        Fit weights.
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    parallel : `bool`, keyword-only, default False
        Not ported (``True`` raises `NotImplementedError`).
    device : optional
        Device the chunks are folded on (default: the first CUDA device,
        which must exist; ``"cpu"`` for the CPU).

    Results
    -------
    ``results.rmsd``
        Per-frame RMSD (Angstrom), shape ``(n_frames,)``.
    ``results.rotations``
        Optimal mobile-to-reference rotation matrices, ``(n_frames, 3,
        3)`` (identity with ``align=False``).
    ``results.times``
        Frame times (ps).
    """

    def _prepare(self) -> None:
        self._resolve_reference()
        self.results.rmsd = np.empty(self.n_frames)
        self.results.rotations = np.empty((self.n_frames, 3, 3))
        self.results.times = self.frames * self._trajectory.dt
        if not self._reduced:
            self.results.units = {
                "results.times": ureg.picosecond,
                "results.rmsd": ureg.angstrom,
            }
        self._store_offset = 0
        self._carry = ()
        fit = self._fit_fn()

        def update(carry, positions, dimensions, mask):
            del dimensions, mask
            rmsd, rot, _ = fit(positions)
            return carry, (rmsd, rot.contiguous())

        self._update = update

    def _store_chunk(self, extras, batch) -> None:
        rmsd, rot = extras
        n = batch.n_real
        lo = self._store_offset
        self.results.rmsd[lo:lo + n] = rmsd[:n]
        self.results.rotations[lo:lo + n] = rot[:n]
        self._store_offset += n


class RMSF(_SuperpositionBase):
    r"""Per-atom root-mean-square fluctuation about the (aligned) mean
    structure,

    .. math::

       \mathrm{RMSF}_i = \sqrt{\bigl\langle |\mathbf{r}_i -
       \langle\mathbf{r}_i\rangle|^2 \bigr\rangle},

    with every frame optimally superposed onto the reference first
    (``align=True``).  One pass: float64 sums of the aligned positions
    and of their squares stay on the device (:math:`\langle |r -
    \langle r\rangle|^2\rangle = \langle |r|^2\rangle - |\langle r
    \rangle|^2`).

    Parameters are those of :class:`RMSD`; ``weights`` affect the
    superposition only (fluctuations are per atom, unweighted).

    Results
    -------
    ``results.rmsf``
        Per-atom RMSF (Angstrom), shape ``(N,)``.
    ``results.mean_positions``
        The aligned average structure in the reference's centered frame,
        shape ``(N, 3)``.
    """

    def _prepare(self) -> None:
        self._resolve_reference()
        n = len(self._atom_indices)
        self.results.units = (
            {} if self._reduced else {"results.rmsf": ureg.angstrom}
        )
        device = self._device
        self._carry = {
            "sum": torch.zeros((n, 3), dtype=torch.float64, device=device),
            "sumsq": torch.zeros(n, dtype=torch.float64, device=device),
            "count": 0,
        }
        fit = self._fit_fn()

        def update(carry, positions, dimensions, mask):
            del dimensions, mask
            aligned = fit(positions)[2]
            return {
                "sum": carry["sum"] + aligned.sum(dim=0),
                "sumsq": carry["sumsq"] + (aligned * aligned).sum(dim=(0, 2)),
                "count": carry["count"] + len(aligned),
            }

        self._update = update

    def _conclude(self) -> None:
        total = self._carry["sum"].cpu().numpy()
        sumsq = self._carry["sumsq"].cpu().numpy()
        count = float(self._carry["count"])
        mean = total / count
        var = sumsq / count - (mean * mean).sum(axis=1)
        self.results.rmsf = np.sqrt(np.maximum(var, 0.0))
        self.results.mean_positions = mean


class PrincipalComponentAnalysis(_SuperpositionBase):
    r"""Principal component analysis of the (aligned) coordinate
    covariance -- the collective-motion decomposition (the
    ``MDAnalysis.analysis.pca`` analogue).

    Every frame is optimally superposed onto the reference (``align=True``),
    flattened to a ``3N`` vector, and accumulated into float64 first and
    second moments on the device (a chunk's second moments are one
    ``(3N, B) @ (B, 3N)`` float64 product); the covariance

    .. math::

       C = \langle (\mathbf{x} - \langle\mathbf{x}\rangle)
       (\mathbf{x} - \langle\mathbf{x}\rangle)^T \rangle

    is eigendecomposed in float64 at the conclusion.  The moments take
    ``(3N)^2`` float64 on the device (104 MB at N = 1,200).

    Parameters are those of :class:`RMSD` (``weights`` affect the
    superposition only; the covariance is unweighted, MDAnalysis
    semantics).

    Results
    -------
    ``results.variance``
        Eigenvalues (Angstrom^2), descending, shape ``(3N,)``.
    ``results.cumulated_variance``
        Normalized cumulative variance (the fraction the first ``k``
        components explain).
    ``results.p_components``
        Eigenvectors as columns, shape ``(3N, 3N)``; sign convention: the
        largest-magnitude entry of each component is positive.
    ``results.mean_positions``
        The aligned average structure, shape ``(N, 3)``.

    Use :meth:`transform` to project the trajectory onto the leading
    components after :meth:`run`.
    """

    def _prepare(self) -> None:
        self._resolve_reference()
        n3 = 3 * len(self._atom_indices)
        self.results.units = (
            {} if self._reduced
            else {"results.variance": ureg.angstrom**2}
        )
        device = self._device
        self._carry = {
            "sum": torch.zeros(n3, dtype=torch.float64, device=device),
            "m2": torch.zeros((n3, n3), dtype=torch.float64, device=device),
            "count": 0,
        }
        fit = self._fit_fn()

        def update(carry, positions, dimensions, mask):
            del dimensions, mask
            x = fit(positions)[2].reshape(len(positions), -1)
            return {
                "sum": carry["sum"] + x.sum(dim=0),
                "m2": carry["m2"].addmm_(x.T, x),
                "count": carry["count"] + len(x),
            }

        self._update = update

    def _conclude(self) -> None:
        count = float(self._carry["count"])
        mean = self._carry["sum"] / count
        cov = self._carry["m2"] / count - torch.outer(mean, mean)
        vals, vecs = torch.linalg.eigh(cov)
        vals, vecs = vals.flip(0), vecs.flip(1)
        variance = vals.clamp(min=0.0).cpu().numpy()
        self.results.variance = variance
        total_var = variance.sum()
        self.results.cumulated_variance = (
            np.cumsum(variance) / total_var if total_var
            else np.zeros_like(variance)
        )
        self.results.p_components = _sign_rule(vecs).cpu().numpy()
        self.results.mean_positions = mean.cpu().numpy().reshape(-1, 3)

    def transform(self, n_components: int = None) -> np.ndarray:
        """Project the analyzed trajectory onto the leading
        `n_components` (default: all) principal components: re-reads the
        same frames, aligns each to the reference, and returns
        ``(n_frames, n_components)``."""

        if "p_components" not in self.results:
            raise RuntimeError("Call run() before transform().")
        k = (self.results.p_components.shape[1] if n_components is None
             else int(n_components))
        return self._project_aligned(
            self.results.p_components[:, :k],
            self.results.mean_positions.reshape(-1),
        )


class TICA(_SuperpositionBase):
    r"""Time-lagged independent component analysis of the (aligned)
    coordinates -- the slow-collective-motion decomposition
    (Molgedey-Schuster; the pyEMMA ``tica`` analogue).

    With :math:`\mathbf{x}_t` the aligned, flattened ``3N`` coordinates,
    TICA solves the symmetrized generalized eigenproblem

    .. math::

       \tfrac{1}{2}\bigl(C_\tau + C_\tau^T\bigr)\,\mathbf{u}
       = \lambda\, C_0\, \mathbf{u},
       \qquad
       C_\tau = \bigl\langle (\mathbf{x}_t - \boldsymbol{\mu})
       (\mathbf{x}_{t+\tau} - \boldsymbol{\mu})^T
       \bigr\rangle_t

    (:math:`\boldsymbol{\mu}` and :math:`C_0` over all analyzed frames;
    :math:`C_\tau` over the :math:`T - \tau` lagged pairs).  Eigenvalues
    are autocorrelations of the component projections at lag
    :math:`\tau`, so implied timescales follow as :math:`t_i = -\tau\,
    \Delta t / \ln\lambda_i`.

    The trajectory streams once, in time order.  The last ``lag`` aligned
    frames stay on the device across chunks (the lag ring); a chunk's
    lagged pairs are one float64 product: the ring's frames are put
    before the chunk's, and row ``t`` pairs with row ``t + lag``.  The
    instantaneous and lagged second moments take ``2 (3N)^2`` float64 on
    the device.

    Parameters are those of :class:`RMSD`, plus:

    lag : `int`, keyword-only, default 1
        Lag :math:`\tau` in analyzed-frame steps (the selected frames must
        be evenly spaced).
    rcond : `float`, keyword-only, default 1e-8
        Whitening cutoff: :math:`C_0` eigenvalues below ``rcond`` times
        the largest are dropped (alignment leaves about 6 near-null
        modes that would otherwise amplify noise).

    Results
    -------
    ``results.eigenvalues``
        Lag-:math:`\tau` autocorrelations :math:`\lambda_i`, descending,
        shape ``(k,)`` (``k`` = retained whitened rank).
    ``results.timescales``
        Implied timescales :math:`-\tau\,\Delta t/\ln\lambda_i` (ps;
        ``inf`` where :math:`\lambda_i \ge 1`, ``nan`` where
        :math:`\lambda_i \le 0`).
    ``results.tica_components``
        Component columns in coordinate space, shape ``(3N, k)``,
        normalized to unit instantaneous variance (:math:`\mathbf{u}^T
        C_0 \mathbf{u} = 1`); sign convention: the largest-magnitude entry
        of each column is positive.
    ``results.mean_positions``
        The aligned average structure, shape ``(N, 3)``.
    ``results.rank``
        Retained whitened rank ``k``.

    Use :meth:`transform` to project the trajectory onto the leading
    components after :meth:`run`.
    """

    _sequential = True

    def __init__(self, group, reference=None, *, lag: int = 1,
                 rcond: float = 1e-8, **kwargs) -> None:
        super().__init__(group, reference, **kwargs)
        if int(lag) < 1:
            raise ValueError("'lag' must be a positive frame count.")
        self._lag = int(lag)
        self._rcond = float(rcond)

    def _prepare(self) -> None:
        from .base import _check_even_frame_spacing

        self._resolve_reference()
        if self._lag >= self.n_frames:
            raise ValueError(
                f"lag ({self._lag}) must be below the analyzed frame "
                f"count ({self.n_frames})."
            )
        # The ring pairs frames a fixed number of steps apart.
        self._frame_step = _check_even_frame_spacing(self.frames)
        n3 = 3 * len(self._atom_indices)
        self.results.units = (
            {} if self._reduced
            else {"results.timescales": ureg.picosecond}
        )
        device = self._device
        lag = self._lag

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float64, device=device)

        self._carry = {
            "ring": zeros(0, n3), "frame": 0,
            "sum": zeros(n3), "m2": zeros(n3, n3),
            "sum_a": zeros(n3), "sum_b": zeros(n3), "mab": zeros(n3, n3),
        }
        fit = self._fit_fn()

        def update(carry, positions, dimensions, mask):
            del dimensions, mask
            x = fit(positions)[2].reshape(len(positions), -1)
            # the ring's frames (up to `lag`, oldest first), then the chunk
            ext = torch.cat([carry["ring"], x])
            a, b = ext[:-lag], ext[lag:]
            return {
                "ring": ext[-lag:],
                "frame": carry["frame"] + len(x),
                "sum": carry["sum"] + x.sum(dim=0),
                "m2": carry["m2"].addmm_(x.T, x),
                "sum_a": carry["sum_a"] + a.sum(dim=0),
                "sum_b": carry["sum_b"] + b.sum(dim=0),
                "mab": carry["mab"].addmm_(a.T, b),
            }

        self._update = update

    def _conclude(self) -> None:
        carry = self._carry
        count = float(carry["frame"])
        pairs = max(count - self._lag, 0.0)
        if pairs < 1:
            raise RuntimeError(
                "No lagged pairs were accumulated (lag >= analyzed "
                "frames)."
            )
        mean = carry["sum"] / count
        c0 = carry["m2"] / count - torch.outer(mean, mean)
        # C_tau = <(a - mu)(b - mu)^T> over the pairs
        ctau = (carry["mab"] / pairs
                - torch.outer(mean, carry["sum_b"] / pairs)
                - torch.outer(carry["sum_a"] / pairs, mean)
                + torch.outer(mean, mean))
        ctau = (ctau + ctau.T) / 2

        # whiten C0, truncated (alignment leaves near-null modes)
        vals0, vecs0 = torch.linalg.eigh(c0)
        keep = vals0 > self._rcond * max(float(vals0[-1]), 0.0)
        if not bool(keep.any()):
            raise RuntimeError(
                "The instantaneous covariance has no retained modes "
                "(frozen coordinates?)."
            )
        whiten = vecs0[:, keep] / torch.sqrt(vals0[keep])
        m = whiten.T @ ctau @ whiten
        lam, y = torch.linalg.eigh((m + m.T) / 2)
        lam, y = lam.flip(0), y.flip(1)
        comps = _sign_rule(whiten @ y).cpu().numpy()  # u^T C0 u = 1
        lam = lam.cpu().numpy()

        lag_time = self._lag * self._frame_step * self._trajectory.dt
        with np.errstate(divide="ignore", invalid="ignore"):
            timescales = np.where(
                lam >= 1.0, np.inf,
                -lag_time / np.log(np.where(lam > 0, lam, np.nan)),
            )
        self.results.eigenvalues = lam
        self.results.timescales = timescales
        self.results.tica_components = comps
        self.results.mean_positions = mean.cpu().numpy().reshape(-1, 3)
        self.results.rank = comps.shape[1]

    def transform(self, n_components: int = None) -> np.ndarray:
        """Project the analyzed trajectory onto the leading
        `n_components` (default: all retained) independent components:
        re-reads the same frames, aligns each to the reference, and
        returns ``(n_frames, n_components)``."""

        if "tica_components" not in self.results:
            raise RuntimeError("Call run() before transform().")
        k = (self.results.tica_components.shape[1] if n_components is None
             else int(n_components))
        return self._project_aligned(
            self.results.tica_components[:, :k],
            self.results.mean_positions.reshape(-1),
        )
