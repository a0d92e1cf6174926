r"""
Hydrogen-bond analysis
======================

Geometric hydrogen-bond detection per frame -- the MDAnalysis
``HydrogenBondAnalysis`` criterion (donor-acceptor distance AND
donor-hydrogen-acceptor angle), ported from
:mod:`mdhelper_tpu.analysis.hbonds`.

Criterion (defaults follow the MDAnalysis convention):

* :math:`d(D, A) \le d_\mathrm{DA}` (default 3.0 Angstrom), and
* :math:`\angle(D, H, A) \ge \theta_\mathrm{DHA}` (default 150 deg),
* the acceptor is not the donor itself.

Donor-hydrogen pairs are fixed index lists (from the topology's bonds),
so each frame is a column gather and a dense ``(n_DH, n_A)``
minimum-image sweep (orthorhombic or triclinic cells), in row blocks of
D-H pairs.  The angle test ``num <= cos_cut * sqrt(den2)`` is a tie test
that one ulp of the root decides, so the root is correctly rounded
(:func:`~mdhelper_tpu_torch.ops.histogram._root`), as XLA's is.  The
JAX package's host KD-tree pipeline is not ported.
"""

from numbers import Real

import numpy as np
import torch

from .. import ureg
from ..algorithm.unit import strip_unit
from ..ops.histogram import (
    _min_image_vectors,
    _norm2,
    _root,
    _row_blocks,
)
from .base import DynamicAnalysisBase, existence_lifetimes
from .structure import _frame_boxes

__all__ = ["HydrogenBondAnalysis"]

class HydrogenBondAnalysis(DynamicAnalysisBase):
    r"""Per-frame hydrogen-bond counts and donor-hydrogen occupancies.

    Parameters
    ----------
    universe : `Universe`
        Universe with positions and (unless `donor_hydrogen_pairs` is
        given) topology bonds to pair hydrogens with their donors.
    hydrogens_sel : `str`, keyword-only, default ``"name H*"``
        Selection for hydrogen atoms.
    acceptors_sel : `str`, keyword-only, default ``"name O* N* F*"``
        Selection for acceptor atoms.
    donors_sel : `str`, keyword-only, optional
        Restrict donors to this selection (by default any heavy atom
        bonded to a selected hydrogen donates).
    donor_hydrogen_pairs : array-like, keyword-only, optional
        Explicit ``(n, 2)`` absolute ``(donor, hydrogen)`` atom-index
        pairs; overrides the bond-derived pairing (for topologies
        without bonds).
    d_a_cutoff : `float`, keyword-only, default 3.0
        Donor-acceptor distance cutoff (Angstrom).
    d_h_a_angle_cutoff : `float`, keyword-only, default 150.0
        Donor-hydrogen-acceptor angle cutoff (degrees).
    pair_counts : `bool`, keyword-only, default False
        Accumulate the full ``(n_DH, n_A)`` per-pair bond-count matrix.
    lifetimes : `bool`, keyword-only, default False
        Store the per-frame bond-existence matrix (``n_frames x n_DH x
        n_A`` bools on the host) and compute the intermittent
        hydrogen-bond time-correlation function :math:`c(t) = \langle
        h(0)h(t) \rangle / \langle h \rangle` (Luzar & Chandler 1996)
        over all pairs ever bonded, and the continuous survival.
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    parallel : `bool`, keyword-only, default False
        Not ported (``True`` raises `NotImplementedError`).
    device : optional
        Device the chunks are folded on (default: the first CUDA
        device, which must exist; ``"cpu"`` for the CPU).

    Results
    -------
    ``results.pairs``
        ``(n_DH, 2)`` absolute ``(donor, hydrogen)`` indices.
    ``results.acceptors``
        ``(n_A,)`` absolute acceptor indices.
    ``results.counts``
        Per-frame hydrogen-bond count, shape ``(n_frames,)``.
    ``results.mean_count``
        Time-averaged count.
    ``results.occupancies``
        Fraction of frames each donor-hydrogen pair donates to *any*
        acceptor, shape ``(n_DH,)``.
    ``results.pair_counts``
        (only with ``pair_counts=True``) per-(D-H, A) bonded-frame
        counts, shape ``(n_DH, n_A)``.
    ``results.lifetime``, ``results.lifetime_times``
        (only with ``lifetimes=True``) intermittent bond correlation
        :math:`c(t)` (normalized to :math:`c(0) = 1`) and its lag
        times (ps).
    ``results.survival``
        (only with ``lifetimes=True``) continuous bond survival
        :math:`S(t)`, from the bonded run lengths.
    ``results.times``
        Frame times (ps).
    """

    def __init__(
        self,
        universe,
        *,
        hydrogens_sel: str = "name H*",
        acceptors_sel: str = "name O* N* F*",
        donors_sel: str = None,
        donor_hydrogen_pairs=None,
        d_a_cutoff: float = 3.0,
        d_h_a_angle_cutoff: float = 150.0,
        pair_counts: bool = False,
        lifetimes: bool = False,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
    ) -> None:
        self.universe = universe
        super().__init__(universe.trajectory, parallel, verbose,
                         device=device)

        if not isinstance(d_a_cutoff, Real):
            d_a_cutoff = strip_unit(d_a_cutoff, "angstrom")[0]
        if d_a_cutoff <= 0:
            raise ValueError("'d_a_cutoff' must be positive.")
        if not 0 < d_h_a_angle_cutoff <= 180:
            raise ValueError(
                "'d_h_a_angle_cutoff' must be in (0, 180] degrees."
            )
        self._d_a_cutoff = float(d_a_cutoff)
        self._angle_cutoff = float(d_h_a_angle_cutoff)

        acceptors = universe.select_atoms(acceptors_sel)
        if acceptors.n_atoms == 0:
            raise ValueError(f"No acceptors match '{acceptors_sel}'.")
        self._acceptor_ix = acceptors.ix

        if donor_hydrogen_pairs is not None:
            pairs = np.asarray(
                donor_hydrogen_pairs, dtype=np.int64
            ).reshape(-1, 2)
        else:
            hydrogens = universe.select_atoms(hydrogens_sel)
            if hydrogens.n_atoms == 0:
                raise ValueError(f"No hydrogens match '{hydrogens_sel}'.")
            bonds = universe._topology.bonds
            if bonds is None or len(bonds) == 0:
                raise ValueError(
                    "The topology has no bonds to pair hydrogens "
                    "with donors; pass 'donor_hydrogen_pairs'."
                )
            h_set = set(int(i) for i in hydrogens.ix)
            donor_ok = None
            if donors_sel is not None:
                donor_ok = set(
                    int(i) for i in universe.select_atoms(donors_sel).ix
                )
            pairs = []
            for a, b in np.asarray(bonds, dtype=np.int64):
                a, b = int(a), int(b)
                for d, h in ((a, b), (b, a)):
                    if h in h_set and d not in h_set and (
                        donor_ok is None or d in donor_ok
                    ):
                        pairs.append((d, h))
            pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        if pairs.size == 0:
            raise ValueError("No donor-hydrogen pairs found.")
        self._pairs = pairs
        self._pair_counts = bool(pair_counts)
        self._lifetimes = bool(lifetimes)
        self._reduced = reduced

        # Stream only the involved atoms' columns.
        involved = np.unique(
            np.concatenate([pairs.ravel(), self._acceptor_ix])
        )
        self._atom_indices = involved
        self._d_col = np.searchsorted(involved, pairs[:, 0])
        self._h_col = np.searchsorted(involved, pairs[:, 1])
        self._a_col = np.searchsorted(involved, self._acceptor_ix)

        self._setup_periodic_box()

    def _prepare(self) -> None:
        n_dh = len(self._pairs)
        n_a = len(self._acceptor_ix)
        self.results.pairs = self._pairs.copy()
        self.results.acceptors = self._acceptor_ix.copy()
        self.results.counts = np.empty(self.n_frames, dtype=int)
        self.results.times = self.frames * self._trajectory.dt
        if not self._reduced:
            self.results.units = {"results.times": ureg.picosecond}
        self._store_offset = 0
        if self._lifetimes:
            self._existence = np.zeros(
                (self.n_frames, n_dh, n_a), dtype=bool
            )
        device = self._device
        self._carry = {
            "bonded_frames": torch.zeros(n_dh, dtype=torch.float64,
                                         device=device),
        }
        if self._pair_counts:
            self._carry["pair_counts"] = torch.zeros(
                (n_dh, n_a), dtype=torch.float64, device=device
            )
        self._make_update()

    def _make_update(self) -> None:
        device = self._device
        d_col = torch.as_tensor(self._d_col, device=device)
        h_col = torch.as_tensor(self._h_col, device=device)
        a_col = torch.as_tensor(self._a_col, device=device)
        # absolute indices for the donor == acceptor exclusion
        not_self = torch.as_tensor(
            self._pairs[:, 0][:, None] != self._acceptor_ix[None, :],
            device=device)
        n_a = len(self._a_col)
        blocks = _row_blocks(len(self._d_col), n_a, device)
        cut2 = torch.tensor(self._d_a_cutoff * self._d_a_cutoff,
                            dtype=torch.float32, device=device)
        cmax = torch.tensor(float(np.cos(np.radians(self._angle_cutoff))),
                            dtype=torch.float32, device=device)
        triclinic = self._triclinic
        track_pairs = self._pair_counts
        lifetimes = self._lifetimes

        def hbonds_frame(pos, box):
            D = pos[d_col]
            H = pos[h_col]
            A = pos[a_col]
            vHD = _min_image_vectors(D - H, box)
            hd2 = _norm2(vHD)
            out = []
            for lo, hi in blocks:
                d, h = D[lo:hi], H[lo:hi]
                vDA = _min_image_vectors(A[None, :, :] - d[:, None, :], box)
                within = _norm2(vDA) <= cut2
                vHA = _min_image_vectors(A[None, :, :] - h[:, None, :], box)
                v = vHD[lo:hi, None, :]
                num = (v[..., 0] * vHA[..., 0] + v[..., 1] * vHA[..., 1]
                       + v[..., 2] * vHA[..., 2])
                den2 = hd2[lo:hi, None] * _norm2(vHA)
                # angle(D,H,A) >= cutoff  <=>  cos(angle) <= cos(cutoff),
                # compared multiplicatively to avoid the division
                # (den2 > 0 guards the A == H degenerate column).
                angle_ok = (num <= cmax * _root(den2)) & (den2 > 0)
                out.append(within & angle_ok & not_self[lo:hi])
            return torch.cat(out)

        def update(carry, positions, dimensions, mask):
            del mask
            boxes = _frame_boxes(dimensions, triclinic)[0]
            hb = torch.stack([hbonds_frame(pos, box)
                              for pos, box in zip(positions, boxes)])
            new = {
                "bonded_frames": carry["bonded_frames"]
                + hb.any(dim=2).sum(dim=0).to(torch.float64),
            }
            if track_pairs:
                new["pair_counts"] = carry["pair_counts"] + hb.sum(
                    dim=0).to(torch.float64)
            counts = hb.sum(dim=(1, 2))
            if lifetimes:
                return new, (counts, hb)
            return new, counts

        self._update = update

    def _store_chunk(self, extras, batch) -> None:
        if self._lifetimes:
            counts, hb = extras
        else:
            counts, hb = extras, None
        n_real = batch.n_real
        lo = self._store_offset
        self.results.counts[lo:lo + n_real] = counts[:n_real]
        if hb is not None:
            self._existence[lo:lo + n_real] = hb[:n_real]
        self._store_offset += n_real

    def _conclude(self) -> None:
        self.results.mean_count = float(self.results.counts.mean())
        bonded = self._carry["bonded_frames"].cpu().numpy()
        self.results.occupancies = bonded / self.n_frames
        if self._pair_counts:
            self.results.pair_counts = self._carry[
                "pair_counts"].cpu().numpy().astype(np.int64)
        if self._lifetimes:
            self._conclude_lifetimes()

    def _conclude_lifetimes(self) -> None:
        """Intermittent bond correlation c(t) and continuous survival S(t)
        over every (D-H, A) pair ever bonded
        (:func:`~mdhelper_tpu_torch.analysis.base.existence_lifetimes`,
        correlated on the analysis's device)."""

        T = self.n_frames
        h = self._existence.reshape(T, -1)
        # lag grid: stride-aware and uniformity-checked (the correlator
        # and the run-length survival assume even spacing)
        lag_dt = self._uniform_lag_dt("Hydrogen-bond lifetimes")
        self.results.lifetime_times = np.arange(T) * lag_dt
        self.results.lifetime, self.results.survival = (
            existence_lifetimes(h, device=self._device)
        )
        if not self._reduced:
            self.results.units["results.lifetime_times"] = ureg.picosecond
