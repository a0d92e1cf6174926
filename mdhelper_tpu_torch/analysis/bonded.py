r"""
Bonded-structure distributions
==============================

Bond-length, bond-angle and dihedral distributions from the topology's
connectivity, ported from :mod:`mdhelper_tpu.analysis.bonded`.

A term list is a fixed ``(M, k)`` table of atom indices, so a chunk of
``B`` frames is one gather of the involved atoms' columns into ``(B, M,
3)`` displacements and one set of elementwise tensor ops over all of
them (no loop over frames).  Vectors fold to their minimum images in
orthorhombic and triclinic cells
(:func:`~mdhelper_tpu_torch.ops.histogram._min_image_vectors`, the
27-image search in a triclinic one).

* Bond lengths bin exactly (the elementwise search of
  :func:`~mdhelper_tpu_torch.ops.histogram.displacement_histogram_frame`,
  double-float squared distances against the float64 edges), as the JAX
  package bins float32 streams (``precision="exact"``): counts equal its
  counts as integers.
* Angles and dihedrals are float32 (``arccos`` and ``arctan2`` of float32
  vectors, squared norms and dot products in the fused form of
  :func:`~mdhelper_tpu_torch.ops.histogram._norm2`) and bin as the JAX
  package's ``_bin_distances`` does: against the float64 ``linspace``
  edges rounded to float32, ``searchsorted(side="right") - 1``, the last
  edge in the last bin, out-of-range values dropped.  ``arccos`` and
  ``arctan2`` round differently on each device, so a value within an ulp
  of an edge can change bins.
* Moments (mean, standard deviation) sum in float64 (the JAX package
  sums each frame in float32): for angles the float32 values, for
  lengths the float64 roots of the double-float squared lengths that were
  binned, so each bond is folded once.
"""

import numpy as np
import torch

from .. import ureg
from ..ops.histogram import (
    _dot3,
    _exact_bin_indices,
    _min_image_vectors,
    _norm2,
    _root,
)
from ..ops.profiles import _bin_indices, bin_counts
from .base import DynamicAnalysisBase
from .structure import _frame_boxes

__all__ = [
    "derive_angles",
    "derive_dihedrals",
    "BondLengthDistribution",
    "BondAngleDistribution",
    "DihedralDistribution",
]


def derive_angles(bonds: np.ndarray) -> np.ndarray:
    """All angle triples ``(i, j, k)`` (vertex ``j``) implied by a bond
    list: every unordered pair of bonds sharing an atom, by vertex, then
    neighbours in ascending order."""

    bonds = np.asarray(bonds, dtype=np.int64).reshape(-1, 2)
    neighbors = {}
    for a, b in bonds:
        neighbors.setdefault(int(a), []).append(int(b))
        neighbors.setdefault(int(b), []).append(int(a))
    triples = []
    for j, nbrs in sorted(neighbors.items()):
        nbrs = sorted(set(nbrs))
        for x in range(len(nbrs)):
            for y in range(x + 1, len(nbrs)):
                triples.append((nbrs[x], j, nbrs[y]))
    return np.asarray(triples, dtype=np.int64).reshape(-1, 3)


def derive_dihedrals(bonds: np.ndarray) -> np.ndarray:
    """All proper-dihedral quadruples ``(i, j, k, l)`` implied by a bond
    list: every bond ``(j, k)`` extended by distinct neighbours ``i`` of
    ``j`` and ``l`` of ``k``."""

    bonds = np.asarray(bonds, dtype=np.int64).reshape(-1, 2)
    neighbors = {}
    for a, b in bonds:
        neighbors.setdefault(int(a), set()).add(int(b))
        neighbors.setdefault(int(b), set()).add(int(a))
    quads = []
    for j, k in sorted((int(a), int(b)) for a, b in bonds):
        for i in sorted(neighbors[j] - {k}):
            for l in sorted(neighbors[k] - {j}):
                if i != l:
                    quads.append((i, j, k, l))
    return np.asarray(quads, dtype=np.int64).reshape(-1, 4)


def _group_terms(group, derive=None):
    """The topology's bonds with both ends in `group` (through `derive`
    to angles or dihedrals when given)."""

    topo_bonds = group.universe._topology.bonds
    bonds = topo_bonds[np.isin(topo_bonds, group.ix).all(axis=1)]
    return bonds if derive is None else derive(bonds)


class _BondedBase(DynamicAnalysisBase):
    """A fixed ``(M, k)`` atom-index term list, the streamed columns
    restricted to the involved atoms, and an int64 histogram carry (with
    float64 first and second moments where the subclass keeps them)."""

    #: keep ``m1``, ``m2`` and ``n`` for the mean and standard deviation.
    _moments = True
    _rank_sharded = True

    def __init__(self, group, terms, n_bins, range, *, reduced, parallel,
                 verbose, device, **kwargs):
        self.group = group
        self.universe = group.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device, **kwargs)
        terms = np.asarray(terms, dtype=np.int64)
        if terms.size == 0:
            raise ValueError(
                "No bonded terms: the topology has no bonds within "
                "the group (pass bonds=/angles= explicitly)."
            )
        self._terms = terms
        self._n_bins = int(n_bins)
        self._range = tuple(range)
        self._reduced = reduced
        # Stream only the involved atoms' columns; term indices become
        # column positions.
        unique, inverse = np.unique(terms, return_inverse=True)
        self._atom_indices = unique
        self._cols = inverse.reshape(terms.shape)
        self._setup_periodic_box()

    def _prepare(self) -> None:
        self.results.edges = np.linspace(*self._range, self._n_bins + 1)
        self.results.bins = (
            self.results.edges[:-1] + self.results.edges[1:]
        ) / 2
        device = self._device
        self._carry = {
            "counts": torch.zeros(self._n_bins, dtype=torch.int64,
                                  device=device),
        }
        if self._moments:
            for key in ("m1", "m2", "n"):
                self._carry[key] = torch.zeros((), dtype=torch.float64,
                                               device=device)
        cols = torch.as_tensor(self._cols, device=device)
        values = self._values_fn()
        triclinic = self._triclinic
        moments = self._moments

        def update(carry, positions, dimensions, mask):
            # a box a frame, broadcast over the chunk's (B, M) terms
            box = _frame_boxes(dimensions, triclinic)[0][:, None]
            ends = [positions[:, cols[:, c]] for c in range(cols.shape[1])]
            # a rank's padded tail (mask 0) counts nothing
            real = (mask > 0)[:, None]
            counts, x = values(ends, box, real)
            out = {"counts": carry["counts"] + counts}
            if moments:
                x = torch.where(real, x.double(), 0.0)
                out["m1"] = carry["m1"] + x.sum()
                out["m2"] = carry["m2"] + (x * x).sum()
                out["n"] = carry["n"] + mask.sum() * x.shape[1]
            return out

        self._update = update

    def _values_fn(self):
        """``values(ends, box, real=None) -> (counts (n_bins,), values (B,
        M))`` of one chunk: `ends` holds the ``(B, M, 3)`` positions of
        each column of the term table, `box` the chunk's boxes ``(B, 1,
        3)`` or ``(B, 1, 3, 3)``, `real` ``(B, 1)`` the frames that count
        (None: all)."""

        raise NotImplementedError

    def _float32_bins_fn(self):
        """``bins(x) -> int64 counts (n_bins,)`` of float32 values against
        the float64 edges rounded to float32 (the JAX
        ``_bin_distances``)."""

        edges = torch.as_tensor(self.results.edges.astype(np.float32),
                                device=self._device)
        n_bins = self._n_bins

        def bins(x, real=None):
            idx, ok = _bin_indices(x, edges)
            return bin_counts(idx, ok if real is None else ok & real,
                              n_bins)

        return bins

    def _conclude(self) -> None:
        counts = self._carry["counts"].cpu().numpy()
        self.results.counts = counts.astype(np.int64)
        widths = np.diff(self.results.edges)
        total = counts.sum()
        # Probability density over the analyzed range.
        self.results.probability = (
            counts / (total * widths) if total else counts.astype(float)
        )
        if self._moments:
            n = float(self._carry["n"])
            mean = float(self._carry["m1"]) / n
            var = float(self._carry["m2"]) / n - mean**2
            self.results.mean = mean
            self.results.std = float(np.sqrt(max(var, 0.0)))


class BondLengthDistribution(_BondedBase):
    r"""Histogram of bonded pair distances (minimum image).

    Parameters
    ----------
    group : `AtomGroup`
        Atoms considered; by default every topology bond with both
        endpoints in the group contributes.
    n_bins : `int`, default 201
        Number of bins.
    range : array-like, default ``(0.0, 3.0)``
        Length range (Angstrom).
    bonds : array-like, keyword-only, optional
        Explicit ``(M, 2)`` absolute atom-index pairs (overrides the
        topology).
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units (omits ``results.units``).
    parallel : `bool`, keyword-only, default False
        Shard the frames over the ranks of :mod:`torch.distributed` (a
        world of one without a process group): the counts and moments of
        each rank's real frames (mask 1) add up over the ranks.
    device : optional
        Device the chunks are folded on (default: the first CUDA device,
        which must exist; ``"cpu"`` for the CPU).

    Results: ``results.bins``/``edges``, raw ``results.counts``,
    ``results.probability`` (density over the range), ``results.mean``
    and ``results.std`` (exact moments, not re-binned).
    """

    def __init__(self, group, n_bins: int = 201, range: tuple = (0.0, 3.0),
                 *, bonds=None, reduced: bool = False,
                 parallel: bool = False, verbose: bool = True,
                 device=None, **kwargs) -> None:
        if bonds is None:
            bonds = _group_terms(group)
        super().__init__(group, bonds, n_bins, range, reduced=reduced,
                         parallel=parallel, verbose=verbose, device=device,
                         **kwargs)

    def _prepare(self) -> None:
        super()._prepare()
        if not self._reduced:
            self.results.units = {
                "results.bins": ureg.angstrom,
                "results.edges": ureg.angstrom,
                "results.mean": ureg.angstrom,
                "results.std": ureg.angstrom,
            }

    def _values_fn(self):
        edges = self.results.edges
        n_bins = self._n_bins

        def values(ends, box, real=None):
            p1, p2 = (p.to(torch.float32) for p in ends)
            idx, d2 = _exact_bin_indices(p1, p2, box.to(torch.float32),
                                         edges, elementwise=True,
                                         with_d2=True)
            # the spill index n_bins holds the out-of-range bonds, and
            # those of frames that do not count
            if real is not None:
                idx = torch.where(real, idx, n_bins)
            counts = torch.bincount(idx.reshape(-1),
                                    minlength=n_bins + 1)[:n_bins]
            return counts, torch.sqrt(d2[0].double() + d2[1].double())

        return values


class BondAngleDistribution(_BondedBase):
    r"""Histogram of bond angles :math:`\theta_{ijk}` (degrees, vertex
    :math:`j`), with the angle triples derived from the bond connectivity
    by default (:func:`derive_angles`).

    Parameters mirror :class:`BondLengthDistribution` (`angles` overrides
    the derived triples); `range` is in degrees (default the full ``(0,
    180)``).  The angles are float32 (see the module notes).

    Results: ``results.bins``/``edges`` (degrees), ``results.counts``,
    ``results.probability``, ``results.mean``/``std`` (degrees).
    """

    def __init__(self, group, n_bins: int = 181,
                 range: tuple = (0.0, 180.0), *, angles=None,
                 reduced: bool = False, parallel: bool = False,
                 verbose: bool = True, device=None, **kwargs) -> None:
        if angles is None:
            angles = _group_terms(group, derive_angles)
        super().__init__(group, angles, n_bins, range, reduced=reduced,
                         parallel=parallel, verbose=verbose, device=device,
                         **kwargs)

    def _prepare(self) -> None:
        super()._prepare()
        if not self._reduced:
            self.results.units = {
                "results.bins": ureg.degree,
                "results.edges": ureg.degree,
                "results.mean": ureg.degree,
                "results.std": ureg.degree,
            }

    def _values_fn(self):
        degrees = torch.tensor(np.float32(180.0 / np.pi), device=self._device)
        bins = self._float32_bins_fn()

        def values(ends, box, real=None):
            pi, pj, pk = ends
            v1 = _min_image_vectors(pi - pj, box)
            v2 = _min_image_vectors(pk - pj, box)
            cos = _dot3(v1, v2) / _root(_norm2(v1) * _norm2(v2))
            theta = torch.arccos(cos.clamp(-1.0, 1.0)) * degrees
            return bins(theta, real), theta

        return values


class DihedralDistribution(_BondedBase):
    r"""Histogram of proper dihedral (torsion) angles
    :math:`\phi_{ijkl}` in degrees over ``(-180, 180]`` (IUPAC sign
    convention: the angle from the ``i-j-k`` plane to the ``j-k-l`` plane,
    positive clockwise looking down ``j -> k``), with the quadruples
    derived from the bond connectivity by default
    (:func:`derive_dihedrals`).

    Parameters mirror :class:`BondLengthDistribution` (`dihedrals`
    overrides the derived quadruples).  Results:
    ``results.bins``/``edges`` (degrees), ``results.counts``,
    ``results.probability``.
    """

    _moments = False

    def __init__(self, group, n_bins: int = 181,
                 range: tuple = (-180.0, 180.0), *, dihedrals=None,
                 reduced: bool = False, parallel: bool = False,
                 verbose: bool = True, device=None, **kwargs) -> None:
        if dihedrals is None:
            dihedrals = _group_terms(group, derive_dihedrals)
        super().__init__(group, dihedrals, n_bins, range, reduced=reduced,
                         parallel=parallel, verbose=verbose, device=device,
                         **kwargs)

    def _prepare(self) -> None:
        super()._prepare()
        if not self._reduced:
            self.results.units = {
                "results.bins": ureg.degree,
                "results.edges": ureg.degree,
            }

    def _values_fn(self):
        degrees = torch.tensor(np.float32(180.0 / np.pi), device=self._device)
        bins = self._float32_bins_fn()

        def values(ends, box, real=None):
            p0, p1, p2, p3 = ends
            b1 = _min_image_vectors(p1 - p0, box)
            b2 = _min_image_vectors(p2 - p1, box)
            b3 = _min_image_vectors(p3 - p2, box)
            n1 = torch.linalg.cross(b1, b2)
            n2 = torch.linalg.cross(b2, b3)
            m1 = torch.linalg.cross(n1, b2 / _root(_norm2(b2))[..., None])
            phi = torch.atan2(_dot3(m1, n2), _dot3(n1, n2)) * degrees
            return bins(phi, real), phi

        return values
