r"""
Native contacts
===============

Fraction of native contacts :math:`q(t)` between two groups relative to
a reference structure, ported from :mod:`mdhelper_tpu.analysis.contacts`.

The reference pair list (all inter-group pairs within `radius` in the
reference structure) is found once on the host in float64, as the JAX
package finds it (a periodic KD-tree, or the 27-image fold in a
triclinic cell: :mod:`mdhelper_tpu_torch.analysis.cluster`).  A chunk's
``q`` is then one gather, minimum-image fold, compare and reduce over
its ``(B, P)`` pairs on the analysis's device.

Methods (MDAnalysis semantics), in float32 as the JAX package's update
forms them: the threshold is ``float32(lambda_) * float32(r0)``, and
distances are float32 minimum-image lengths (squared norm in the fused
form of :func:`~mdhelper_tpu_torch.ops.histogram._norm2`, a correctly
rounded root).

- ``"hard"`` -- :math:`q = \langle r_{ij} < \lambda\,r_{ij}^0 \rangle`
  (a contact is kept while shorter than ``lambda_`` times its
  reference length; ``lambda_ = 1.8`` default).
- ``"radius"`` -- :math:`q = \langle r_{ij} < \text{radius} \rangle`.
- ``"soft"`` -- Best-Hummer smooth switching
  :math:`q = \bigl\langle 1 / (1 + e^{\beta (r_{ij} - \lambda
  r_{ij}^0)}) \bigr\rangle` (float32 ``exp``).

For ``"hard"`` and ``"radius"`` the count of kept contacts is exact and
``q`` is that count times the float32 ``1 / P``, the one rounding of the
JAX package's float32 mean; ``"soft"`` averages its float32 values in
float64.
"""

from numbers import Real

import numpy as np
import torch

from .. import ureg
from ..algorithm.unit import strip_unit
from ..ops.histogram import _min_image_vectors, _norm2, _root
from .base import DynamicAnalysisBase
from .structure import _frame_boxes

__all__ = ["NativeContacts"]


class NativeContacts(DynamicAnalysisBase):
    r"""Fraction of native contacts :math:`q(t)`.

    Parameters
    ----------
    group_a, group_b : `AtomGroup`
        The two groups whose inter-group contacts are tracked (e.g. the
        two halves of an interface, or a ligand and a binding site).
        Identical-atom pairs are dropped when the groups overlap.
    radius : `float` or unit-bearing quantity, default 4.5
        Contact-definition cutoff (Angstrom) applied to the REFERENCE
        structure (and the per-frame cutoff for ``method="radius"``).
    reference : `int` or pair of array-like, optional
        Reference frame index (default 0) or explicit ``(positions_a,
        positions_b)`` coordinates.
    method : `str`, keyword-only, default ``"hard"``
        ``"hard"``, ``"soft"`` or ``"radius"`` (see the module notes).
    lambda_ : `float`, keyword-only, default 1.8
        Tolerance factor on the reference distances (``"hard"`` /
        ``"soft"``).
    beta : `float`, keyword-only, default 5.0
        Softness (1/Angstrom) of the ``"soft"`` switching function.
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    parallel : `bool`, keyword-only, default False
        Shard the frames over the ranks of :mod:`torch.distributed` (a
        world of one without a process group): q(t) of each rank's real
        frames is gathered in frame order.
    device : optional
        Device the chunks are folded on (default: the first CUDA device,
        which must exist; ``"cpu"`` for the CPU).

    Results
    -------
    ``results.q``
        Fraction of native contacts per frame, shape ``(n_frames,)``.
    ``results.n_native``
        Number of reference contacts :math:`P`.
    ``results.pairs``
        The reference pair list as group-local ``(P, 2)`` indices into
        `group_a` / `group_b`.
    ``results.r0``
        Reference contact distances (Angstrom), shape ``(P,)``.
    ``results.times``
        Frame times (ps).
    """

    _checkpointable_stores = True
    _rank_sharded = True

    def _result_stores(self) -> dict:
        return {"q": 0}

    def __init__(self, group_a, group_b=None, radius=4.5, *, reference=None,
                 method: str = "hard", lambda_: float = 1.8,
                 beta: float = 5.0, reduced: bool = False,
                 parallel: bool = False, verbose: bool = True,
                 device=None, **kwargs) -> None:
        if group_b is None:
            group_b = group_a
        self.group_a = group_a
        self.group_b = group_b
        self.universe = group_a.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device, **kwargs)
        if not isinstance(radius, Real):
            radius = strip_unit(radius, "angstrom")[0]
        if radius <= 0:
            raise ValueError("'radius' must be positive.")
        if method not in ("hard", "soft", "radius"):
            raise ValueError(
                "Invalid method. Valid values: 'hard', 'soft', 'radius'."
            )
        if lambda_ <= 0 or beta <= 0:
            raise ValueError("'lambda_' and 'beta' must be positive.")
        self._radius = float(radius)
        self._method = method
        self._lambda = float(lambda_)
        self._beta = float(beta)
        self._reduced = reduced
        self._reference_spec = reference

        involved = np.unique(np.concatenate([group_a.ix, group_b.ix]))
        self._atom_indices = involved
        self._a_col = np.searchsorted(involved, group_a.ix)
        self._b_col = np.searchsorted(involved, group_b.ix)
        self._setup_periodic_box()
        self._require_box("Native contacts")

    def _resolve_reference(self) -> None:
        from ..algorithm.topology import minimize_vectors
        from .cluster import _periodic_contact_pairs, _triclinic_contact_pairs

        ref = self._reference_spec
        if ref is None:
            ref = 0
        if isinstance(ref, (int, np.integer)):
            positions, dims = self._trajectory.read_frames([int(ref)])
            ref_a = np.asarray(positions[0][self.group_a.ix], np.float64)
            ref_b = np.asarray(positions[0][self.group_b.ix], np.float64)
            ref_dims = np.asarray(dims[0], dtype=np.float64)
        else:
            ref_a, ref_b = (np.asarray(r, dtype=np.float64) for r in ref)
            ref_dims = np.asarray(self.universe.dimensions, dtype=np.float64)
        if ref_a.shape != (self.group_a.n_atoms, 3) or (
            ref_b.shape != (self.group_b.n_atoms, 3)
        ):
            raise ValueError(
                "'reference' coordinates must match the group sizes."
            )
        # Inter-group contacts from one search over the concatenated
        # points, kept where the pair is (a, b).
        n_a = len(ref_a)
        pts = np.concatenate([ref_a, ref_b])
        if self._triclinic:
            rows, cols = _triclinic_contact_pairs(pts, ref_dims,
                                                  self._radius)
        else:
            rows, cols = _periodic_contact_pairs(pts, ref_dims[:3],
                                                 self._radius)
        # rows < cols always: (a, b) pairs have their a first.
        keep_ab = (rows < n_a) & (cols >= n_a)
        a_idx = rows[keep_ab]
        b_idx = cols[keep_ab] - n_a
        # Same-atom pairs (overlapping groups) never count.
        same = self.group_a.ix[a_idx] == self.group_b.ix[b_idx]
        a_idx, b_idx = a_idx[~same], b_idx[~same]
        if len(a_idx) == 0:
            raise ValueError(
                "No native contacts within 'radius' in the reference "
                "structure."
            )
        vec = np.asarray(minimize_vectors(ref_b[b_idx] - ref_a[a_idx],
                                          ref_dims))
        self._pair_a = a_idx
        self._pair_b = b_idx
        self._r0 = np.linalg.norm(vec, axis=1)

    def _prepare(self) -> None:
        self._resolve_reference()
        self.results.q = np.empty(self.n_frames)
        self.results.n_native = len(self._r0)
        self.results.pairs = np.stack([self._pair_a, self._pair_b], axis=1)
        self.results.r0 = self._r0.copy()
        self.results.times = self.frames * self._trajectory.dt
        if not self._reduced:
            self.results.units = {
                "results.times": ureg.picosecond,
                "results.r0": ureg.angstrom,
            }
        self._store_offset = 0
        self._carry = ()

        device = self._device
        a_cols = torch.as_tensor(self._a_col[self._pair_a], device=device)
        b_cols = torch.as_tensor(self._b_col[self._pair_b], device=device)
        n_pairs = len(self._r0)

        def f32(x):
            return torch.as_tensor(np.float32(x), device=device)

        method = self._method
        if method == "radius":
            thresh = f32(self._radius)
        else:
            thresh = f32(self._lambda) * torch.as_tensor(
                self._r0.astype(np.float32), device=device)
        beta = f32(self._beta)
        inv_p = f32(np.float32(1.0) / np.float32(n_pairs))
        triclinic = self._triclinic

        def update(carry, positions, dimensions, mask):
            del mask
            box = _frame_boxes(dimensions, triclinic)[0][:, None]
            r = _root(_norm2(_min_image_vectors(
                positions[:, b_cols] - positions[:, a_cols], box)))
            if method == "soft":
                values = 1.0 / (1.0 + torch.exp(beta * (r - thresh)))
                q = values.double().mean(dim=1)
            else:
                # an exact count, then the float32 mean's one rounding
                count = (r < thresh).sum(dim=1).to(torch.float32)
                q = count * inv_p
            return carry, q

        self._update = update

    def _store_chunk(self, extras, batch) -> None:
        n = batch.n_real
        lo = self._store_offset
        self.results.q[lo:lo + n] = np.asarray(extras, np.float64)[:n]
        self._store_offset += n

    def _conclude(self) -> None:
        pass
