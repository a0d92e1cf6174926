"""
Test inputs and float64 oracles
===============================

NumPy helpers shared by the port's tests and ``chip_smoke.py``: the
bin-edge straddle fixtures and the float64 all-pairs histograms the
cell-list kernels are held against.
"""

import itertools

import numpy as np

__all__ = [
    "edge_straddle_positions",
    "edge_straddle_cross_positions",
    "edge_straddle_triclinic_positions",
    "f64_pair_histogram",
    "f64_cross_histogram",
    "f64_histogram",
    "f64_triclinic_distances",
    "f64_triclinic_pair_histogram",
]


def edge_straddle_positions(rng, box):
    """float32 positions ``(390, 3)`` in a cubic box of side ``box``
    (at least 4): 300 uniform atoms, and 90 partners placed along x at
    the bin edge 1.25 from the first 90 of them -- 30 exactly at it, 30
    one float32 ulp below and 30 one ulp above (the construction of
    ``tests/test_analysis_structure.py``).  The 90 anchors sit at least
    2 from the upper x face, so their partners stay wrapped."""

    pos = (rng.random((300, 3)) * box).astype(np.float32)
    pos[:90, 0] = pos[:90, 0] * np.float32((box - 2.0) / box)
    seps = np.float32(
        [1.25, np.nextafter(1.25, 0, dtype=np.float32),
         np.nextafter(1.25, 2, dtype=np.float32)]
    )
    partners = np.concatenate(
        [pos[30 * i:30 * (i + 1)] + np.array([s, 0, 0], np.float32)
         for i, s in enumerate(seps)]
    ).astype(np.float32)
    return np.concatenate((pos, partners))


def edge_straddle_cross_positions(rng, box):
    """The straddle fixture split into two disjoint groups: the 300
    uniform atoms (group 1) and the 90 partners (group 2), so the 90
    bin-edge pairs are cross pairs."""

    pos = edge_straddle_positions(rng, box)
    return pos[:300], pos[300:]


def edge_straddle_triclinic_positions(rng, box):
    """The straddle construction in a triclinic cell: float32 positions
    ``(390, 3)`` for the lower-triangular box matrix ``box`` (rows are
    the box vectors; ``box[0, 0]`` at least 4), 300 atoms at fractional
    coordinates in [0.05, 0.95) and 90 partners displaced along x from
    the first 90 -- 30 at 1.25, 30 one float32 ulp below and 30 one ulp
    above.  An x displacement moves only the first fractional
    coordinate, and the anchors leave room for it, so every atom stays
    inside the cell, away from its faces (the kernels' fold is then the
    identity)."""

    h = np.asarray(box, dtype=np.float64)
    frac = 0.05 + 0.9 * rng.random((300, 3))
    frac[:90, 0] = 0.05 + (0.9 - 2.0 / h[0, 0]) * rng.random(90)
    pos = (frac @ h).astype(np.float32)
    seps = np.float32(
        [1.25, np.nextafter(1.25, 0, dtype=np.float32),
         np.nextafter(1.25, 2, dtype=np.float32)]
    )
    partners = np.concatenate(
        [pos[30 * i:30 * (i + 1)] + np.array([s, 0, 0], np.float32)
         for i, s in enumerate(seps)]
    ).astype(np.float32)
    return np.concatenate((pos, partners))


def f64_triclinic_distances(pos1, pos2, box):
    """float64 minimum-image lengths of ``pos1 - pos2`` (float32 arrays
    of broadcast-compatible shapes ``(..., 3)``) over the 27 images of
    the float32 box matrix ``box`` (rows are the box vectors): enough
    for positions inside the primary cell."""

    d = pos1.astype(np.float64) - pos2.astype(np.float64)
    rows = np.asarray(box, dtype=np.float64)
    best = None
    for w in itertools.product((-1, 0, 1), repeat=3):
        d2 = ((d - np.asarray(w, np.float64) @ rows) ** 2).sum(-1)
        best = d2 if best is None else np.minimum(best, d2)
    return np.sqrt(best)


def f64_triclinic_pair_histogram(pos1, pos2, box, r_max, n_bins,
                                 exclusion=None):
    """float64 histogram on ``[0, r_max]`` of every pair (i of
    ``pos1``, j of ``pos2``) under the 27-image minimum image of the
    float32 box matrix ``box``; ``exclusion=(e0, e1)`` drops pairs with
    ``i // e0 == j // e1`` (``(1, 1)`` with ``pos2 is pos1`` is the self
    histogram of ordered pairs)."""

    dist = f64_triclinic_distances(pos1[:, None], pos2[None], box)
    if exclusion is not None:
        e0, e1 = exclusion
        same = (np.arange(len(pos1))[:, None] // e0
                == np.arange(len(pos2))[None, :] // e1)
        dist[same] = np.inf
    return np.histogram(dist, bins=n_bins, range=(0.0, r_max))[0]


def f64_pair_histogram(pos, box, r_max, n_bins):
    """float64 minimum-image histogram on ``[0, r_max]`` of all ordered
    pairs of the float32 positions ``pos`` ``(N, 3)`` (self pairs
    dropped), in a cubic box of side ``box``.  Any box size: each pair
    counts once, at its minimum image, even where ``r_max`` exceeds half
    the box -- the convention of the cell kernels' generalized sweeps."""

    p64 = pos.astype(np.float64)
    d = p64[:, None] - p64[None]
    d -= box * np.round(d / box)
    dist = np.sqrt((d**2).sum(-1))
    dist[np.arange(len(pos)), np.arange(len(pos))] = np.inf
    return np.histogram(dist, bins=n_bins, range=(0.0, r_max))[0]


def f64_histogram(pos1, pos2, lengths, edges, *, axes=(0, 1, 2),
                  exclusion=None):
    """float64 histogram (``numpy.histogram`` on the float64 `edges`: bin
    k is ``[e_k, e_{k+1})``, the last bin closed) of the minimum-image
    distances of every pair (i of ``pos1``, j of ``pos2``; float32
    arrays) over the coordinate columns `axes` of an orthorhombic box of
    `lengths` ``(3,)`` -- two columns for a 2-D histogram.
    ``exclusion=(e0, e1)`` drops pairs with ``i // e0 == j // e1``
    (``(1, 1)`` with ``pos2`` equal to ``pos1`` drops the identical
    pairs; an asymmetric tile keeps those with ``i // e0 != i // e1``, at
    distance 0)."""

    cols = list(axes)
    lengths = np.asarray(lengths, np.float64)[cols]
    d = (pos1.astype(np.float64)[:, None, cols]
         - pos2.astype(np.float64)[None, :, cols])
    d -= lengths * np.round(d / lengths)
    dist = np.sqrt((d**2).sum(-1))
    if exclusion is not None:
        e0, e1 = exclusion
        same = (np.arange(len(pos1))[:, None] // e0
                == np.arange(len(pos2))[None, :] // e1)
        dist[same] = np.inf
    return np.histogram(dist, bins=np.asarray(edges, np.float64))[0]


def f64_cross_histogram(pos1, pos2, box, r_max, n_bins, exclusion=None):
    """float64 minimum-image histogram on ``[0, r_max]`` of every pair
    (i of ``pos1``, j of ``pos2``) of float32 positions in a cubic box
    of side ``box``; ``exclusion=(e0, e1)`` drops pairs with
    ``i // e0 == j // e1``."""

    d = pos1.astype(np.float64)[:, None] - pos2.astype(np.float64)[None]
    d -= box * np.round(d / box)
    dist = np.sqrt((d**2).sum(-1))
    if exclusion is not None:
        e0, e1 = exclusion
        same = (np.arange(len(pos1))[:, None] // e0
                == np.arange(len(pos2))[None, :] // e1)
        dist[same] = np.inf
    return np.histogram(dist, bins=n_bins, range=(0.0, r_max))[0]
