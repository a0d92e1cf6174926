r"""
Orientational order
===================

Nematic order parameter, orientational relaxation and orientation
profiles of linear entities (liquid crystals, rod-like molecules,
polymer segments, water dipoles), ported from
:mod:`mdhelper_tpu.analysis.orientation`.

Per frame the molecular axes :math:`\hat{u}_i` (minimum-image
normalized vectors between two index-matched atom groups) form the
traceless symmetric order tensor

.. math::

   Q_{ab} = \frac{1}{N}\sum_i \frac{3 u_{ia} u_{ib} -
   \delta_{ab}}{2},

whose largest eigenvalue is the nematic scalar :math:`P_2` and whose
corresponding eigenvector is the director.  The tensors of a chunk's
frames are one float32 ``einsum`` on the device; their
eigen-decomposition, the director's sign rule and the relaxation
functions :math:`C_1(t)`, :math:`C_2(t)` (through
:func:`~mdhelper_tpu_torch.algorithm.correlation.correlation_fft`, with
the outer-product identity for :math:`C_2`) come at the conclusion.  The
JAX package's host pipeline is not ported.
"""

import numpy as np
import torch

from .. import ureg
from ..algorithm.correlation import correlation_fft
from ..ops.histogram import _image_shift, _min_image_vectors, _norm2, _root
from ..ops.pbc import wrap_positions
from ..ops.profiles import axis_histogram_batch
from .base import DynamicAnalysisBase
from .structure import _frame_boxes

__all__ = ["NematicOrderParameter", "OrientationProfile"]


def _compact_pair_columns(begins, ends):
    """Validation + streamed-column compaction for the axis-vector
    classes: both groups must share a universe, match in length, be
    non-empty, and pair distinct atoms (a zero-length axis has no
    orientation).  Returns ``(atom_indices, b_col, e_col)``."""

    if begins.universe is not ends.universe:
        raise ValueError(
            "'begins' and 'ends' must belong to the same universe."
        )
    if begins.n_atoms != ends.n_atoms:
        raise ValueError(
            "'begins' and 'ends' must have the same number of "
            "atoms."
        )
    if begins.n_atoms == 0:
        raise ValueError("Empty axis groups.")
    if (np.asarray(begins.ix) == np.asarray(ends.ix)).any():
        raise ValueError(
            "'begins' and 'ends' pair an atom with itself; each "
            "axis needs two distinct atoms."
        )
    involved = np.unique(np.concatenate([begins.ix, ends.ix]))
    b_col = np.searchsorted(involved, begins.ix)
    e_col = np.searchsorted(involved, ends.ix)
    return involved, b_col, e_col


class NematicOrderParameter(DynamicAnalysisBase):
    r"""Nematic order parameter :math:`P_2`, director, and
    orientational relaxation :math:`C_1(t)` / :math:`C_2(t)`.

    Parameters
    ----------
    begins, ends : `AtomGroup`
        Index-matched groups defining the molecular axes
        :math:`\hat{u}_i \propto \mathbf{r}_{\mathrm{ends},i} -
        \mathbf{r}_{\mathrm{begins},i}` (minimum image).
    acf : `bool`, keyword-only, default False
        Store per-frame axes and compute the orientational
        relaxation functions :math:`C_1(t) = \langle \hat{u}(0)
        \cdot \hat{u}(t) \rangle` and :math:`C_2(t)` (memory:
        ``n_frames x N x 3`` floats on the host).
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    parallel : `bool`, keyword-only, default False
        Not ported (``True`` raises `NotImplementedError`).
    device : optional
        Device the chunks are folded on (default: the first CUDA
        device, which must exist; ``"cpu"`` for the CPU).

    Results
    -------
    ``results.Q``
        Per-frame order tensors, shape ``(n_frames, 3, 3)``.
    ``results.P2``
        Per-frame nematic scalar (largest eigenvalue of `Q`).
    ``results.director``
        Per-frame director (eigenvector of the largest eigenvalue,
        first non-zero component positive), shape ``(n_frames, 3)``.
    ``results.P2_mean``
        Nematic scalar of the time-averaged order tensor.
    ``results.acf_times``, ``results.C1``, ``results.C2``
        (only with ``acf=True``) lag times and the orientational
        relaxation functions (both normalized to 1 at :math:`t=0`).
    ``results.times``
        Frame times (ps).
    """

    def __init__(
        self,
        begins,
        ends,
        *,
        acf: bool = False,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
    ) -> None:
        (
            self._atom_indices, self._b_col, self._e_col
        ) = _compact_pair_columns(begins, ends)
        self.universe = begins.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device)
        self._begins_ix = begins.ix
        self._ends_ix = ends.ix
        self._acf = bool(acf)
        self._reduced = reduced
        self._setup_periodic_box()

    def _prepare(self) -> None:
        self.results.Q = np.empty((self.n_frames, 3, 3))
        self.results.times = self.frames * self._trajectory.dt
        if not self._reduced:
            self.results.units = {"results.times": ureg.picosecond}
        if self._acf:
            self._axes = np.empty((self.n_frames, len(self._begins_ix), 3))
        self._store_offset = 0
        # Everything is stored; the carry holds nothing.
        self._carry = {}
        device = self._device
        b_col = torch.as_tensor(self._b_col, device=device)
        e_col = torch.as_tensor(self._e_col, device=device)
        eye = torch.eye(3, dtype=torch.float32, device=device)
        triclinic = self._triclinic
        store_axes = self._acf

        def update(carry, positions, dimensions, mask):
            del mask
            boxes = _frame_boxes(dimensions, triclinic)[0][:, None]
            v = _min_image_vectors(positions[:, e_col] - positions[:, b_col],
                                   boxes)
            u = v / _root(_norm2(v))[..., None]
            outer = torch.einsum("bia,bic->bac", u, u) / u.shape[1]
            Q = (3.0 * outer - eye) / 2.0
            return carry, ((Q, u) if store_axes else (Q,))

        self._update = update

    def _store_chunk(self, extras, batch) -> None:
        n_real = batch.n_real
        lo = self._store_offset
        self.results.Q[lo:lo + n_real] = extras[0][:n_real]
        if self._acf:
            self._axes[lo:lo + n_real] = extras[1][:n_real]
        self._store_offset += n_real

    def _conclude(self) -> None:
        Q = self.results.Q
        evals, evecs = np.linalg.eigh(Q)
        self.results.P2 = evals[:, -1]
        directors = evecs[:, :, -1]
        # the sign convention: positive first non-zero component
        flip = np.sign(
            np.where(
                np.abs(directors[:, 0]) > 1e-12,
                directors[:, 0],
                np.where(
                    np.abs(directors[:, 1]) > 1e-12,
                    directors[:, 1],
                    directors[:, 2],
                ),
            )
        )
        self.results.director = directors * flip[:, None]
        mean_evals = np.linalg.eigvalsh(Q.mean(axis=0))
        self.results.P2_mean = float(mean_evals[-1])
        if self._acf:
            self._conclude_acf()

    def _conclude_acf(self) -> None:
        u = torch.as_tensor(self._axes, device=self._device)  # (T, N, 3)
        T = u.shape[0]
        # C1: vector ACF, averaged over entities
        c1 = correlation_fft(u, axis=0, average=True,
                             vector=True).cpu().numpy()
        self.results.C1 = c1 / c1[0]
        # C2 via the outer-product identity: six unique components
        # with multiplicity weights (xx, yy, zz, xy, xz, yz)
        sqrt2 = np.sqrt(2.0)
        prods = torch.stack(
            [
                u[..., 0] * u[..., 0],
                u[..., 1] * u[..., 1],
                u[..., 2] * u[..., 2],
                sqrt2 * u[..., 0] * u[..., 1],
                sqrt2 * u[..., 0] * u[..., 2],
                sqrt2 * u[..., 1] * u[..., 2],
            ],
            dim=-1,
        )  # (T, N, 6)
        cos2 = correlation_fft(prods, axis=0, average=True,
                               vector=True).cpu().numpy()
        self.results.C2 = (3.0 * cos2 - 1.0) / 2.0
        self.results.acf_times = np.arange(T) * self._uniform_lag_dt(
            "Orientational relaxation"
        )
        if not self._reduced:
            self.results.units["results.acf_times"] = ureg.picosecond


class OrientationProfile(DynamicAnalysisBase):
    r"""Axis-resolved orientational order of molecular vectors --
    :math:`P_1(z) = \langle \cos\theta \rangle` and :math:`P_2(z) =
    \langle (3\cos^2\theta - 1)/2 \rangle` binned along a box axis.

    :math:`\theta` is the angle between each entity's axis
    :math:`\hat{u}_i` (minimum-image normalized vector from `begins`
    to `ends`) and a fixed lab direction (`director`, defaulting to
    the profiled axis).  Entities bin at their minimum-image bond
    midpoint, wrapped into each frame's box.  Each chunk bins its
    frames' entities once
    (:func:`~mdhelper_tpu_torch.ops.profiles.axis_histogram_batch`):
    int64 counts and float64 sums of :math:`\cos\theta` and
    :math:`\cos^2\theta`.  Bond folding and wrapping use each frame's own
    box (NPT-safe); only the bin grid is the initialization-time cell
    (orthorhombic only).

    Parameters
    ----------
    begins, ends : `AtomGroup`
        Index-matched groups defining the molecular axes.
    axis : `str`, default :code:`"z"`
        Profiled box axis (``"x"``, ``"y"`` or ``"z"``).
    n_bins : `int`, default 100
        Bins along the axis.
    director : array-like, keyword-only, optional
        Lab reference direction (normalized internally); defaults to
        the unit vector of `axis`.
    reduced : `bool`, keyword-only, default :code:`False`
        Reduced (LJ) units.
    parallel : `bool`, keyword-only, default :code:`False`
        Not ported (``True`` raises `NotImplementedError`).
    device : optional
        Device the chunks are folded on (default: the first CUDA
        device, which must exist; ``"cpu"`` for the CPU).

    Results
    -------
    ``results.bins``
        Bin centers (Å).
    ``results.counts``
        Per-bin entity counts summed over frames.
    ``results.p1``, ``results.p2``
        Orientational order profiles (NaN in empty bins).
    """

    def __init__(
        self,
        begins,
        ends,
        axis: str = "z",
        n_bins: int = 100,
        *,
        director=None,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
    ) -> None:
        (
            self._atom_indices, self._b_col, self._e_col
        ) = _compact_pair_columns(begins, ends)
        self.universe = begins.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device)
        self._setup_periodic_box()
        if self._triclinic:
            raise ValueError(
                "OrientationProfile needs an orthorhombic cell."
            )
        self._require_box("OrientationProfile")
        if axis not in ("x", "y", "z"):
            raise ValueError("axis must be 'x', 'y' or 'z'.")
        self._axis = "xyz".index(axis)
        if int(n_bins) < 1:
            raise ValueError("'n_bins' must be positive.")
        self._n_bins = int(n_bins)
        if director is None:
            director = np.eye(3)[self._axis]
        director = np.asarray(director, dtype=np.float64).reshape(3)
        norm = np.linalg.norm(director)
        if norm == 0:
            raise ValueError("'director' must be non-zero.")
        self._director = director / norm
        self._reduced = reduced
        self._dimensions = np.asarray(
            self.universe.dimensions[:3], dtype=np.float64
        )

    def _prepare(self) -> None:
        length = self._dimensions[self._axis]
        self._edges = np.linspace(0.0, length, self._n_bins + 1)
        self.results.bins = (self._edges[:-1] + self._edges[1:]) / 2
        if not self._reduced:
            self.results.units = {"results.bins": ureg.angstrom}
        device = self._device
        self._carry = {
            "n": torch.zeros(self._n_bins, dtype=torch.int64, device=device),
            "cos": torch.zeros(self._n_bins, dtype=torch.float64,
                               device=device),
            "cos2": torch.zeros(self._n_bins, dtype=torch.float64,
                                device=device),
        }
        b_col = torch.as_tensor(self._b_col, device=device)
        e_col = torch.as_tensor(self._e_col, device=device)
        edges = torch.as_tensor(self._edges, dtype=torch.float32,
                                device=device)
        director = torch.as_tensor(self._director, dtype=torch.float32,
                                   device=device)
        ax = self._axis

        def update(carry, positions, dimensions, mask):
            # Each frame's box folds and wraps its bonds (an NPT frame
            # with its own box); only the bin grid is the cell at start.
            box = dimensions[:, None, :3].to(positions.dtype)
            b_pos = positions[:, b_col]
            delta = positions[:, e_col] - b_pos
            v = delta - box * _image_shift(delta, box)
            norm = _root(_norm2(v))
            # A zero-length bond (coincident float32 coordinates) keeps a
            # finite cos and bins nowhere (a NaN coordinate).
            valid = norm > 0
            u = v / torch.clamp(norm, min=torch.finfo(v.dtype).tiny)[..., None]
            cos = (u[..., 0] * director[0] + u[..., 1] * director[1]
                   + u[..., 2] * director[2])
            mid = wrap_positions(b_pos + 0.5 * v, box)
            coord = torch.where(valid, mid[..., ax], torch.nan)
            return {
                "n": carry["n"] + axis_histogram_batch(coord, mask, edges),
                "cos": carry["cos"] + axis_histogram_batch(
                    coord, mask, edges, weights=cos),
                "cos2": carry["cos2"] + axis_histogram_batch(
                    coord, mask, edges, weights=cos * cos),
            }

        self._update = update

    def _conclude(self) -> None:
        n = self._carry["n"].cpu().numpy().astype(np.float64)
        c1 = self._carry["cos"].cpu().numpy()
        c2 = self._carry["cos2"].cpu().numpy()
        self.results.counts = n
        with np.errstate(divide="ignore", invalid="ignore"):
            self.results.p1 = np.where(n > 0, c1 / n, np.nan)
            self.results.p2 = np.where(
                n > 0, (3.0 * c2 / n - 1.0) / 2.0, np.nan
            )
