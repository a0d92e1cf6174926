"""
Test inputs and float64 oracles
===============================

NumPy helpers shared by the port's tests and ``chip_smoke.py``: the
bin-edge straddle fixtures and the float64 all-pairs histograms the
cell-list kernels are held against, a float32 model of the tri_pp
kernels' candidate screen, a trajectory of 3-site water molecules
(optionally with SPC/E charges), one of linear polymer chains, and the
float32 error margin of bond angles and dihedrals.
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
    "float32_angle_margin",
    "SCREEN_EPS",
    "SPCE_CHARGES",
    "fma32",
    "polymer_chains",
    "tri27_screen",
    "water_system",
]

#: the cell kernels' screen bound factor, 2^-18 (``kScreen`` of
#: ``csrc/cell_bin.cuh``).
SCREEN_EPS = np.float32(2.0**-18)


def fma32(x, y, z):
    """float32 ``x * y + z`` rounded once (as ``__fmaf_rn``), through
    float64: the product of two floats is exact there, and the sum
    rounds twice only when float64 cannot hold it, which the screens'
    bound does not mind."""

    f64 = np.float64
    return (np.asarray(x, f64) * np.asarray(y, f64)
            + np.asarray(z, f64)).astype(np.float32)


def tri27_screen(pos1, pos2, box, inv, cut):
    """The float32 screen of ``Tri27Image::exact`` (``csrc/cell_bin.cuh``),
    operation for operation in numpy float32, for pairs of broadcast
    ``(..., 3)`` float32 positions in the lower-triangular float32 box
    matrix `box` with its float32 inverse `inv`.  Returns ``(passed,
    kept, n0)``: whether the pair may lie at or below `cut` (else the
    kernel skips it), the ``(..., 27)`` candidates whose double-float d^2
    the kernel evaluates (index ``9 (sx + 1) + 3 (sy + 1) + sz + 1`` of
    the shift ``n0 + (sx, sy, sz)``), and the base image multiples."""

    f32 = np.float32
    pos1, pos2 = np.asarray(pos1, f32), np.asarray(pos2, f32)
    box, inv = np.asarray(box, f32), np.asarray(inv, f32)
    s = [pos1[..., k] - pos2[..., k] for k in range(3)]
    n0 = [np.rint((s[0] * inv[0, k] + s[1] * inv[1, k]) + s[2] * inv[2, k])
          for k in range(3)]
    reach = [np.abs(n) + f32(1.0) for n in n0]
    mag, base = [], []
    for k in range(3):
        m, b = np.abs(s[k]), s[k]
        for j in range(k, 3):
            m = m + reach[j] * np.abs(box[j, k])
            b = b - n0[j] * box[j, k]
        mag.append(m)
        base.append(b)
    eps = SCREEN_EPS * fma32(mag[2], mag[2],
                             fma32(mag[1], mag[1], mag[0] * mag[0]))
    f = [None] * 27
    for iz in range(3):
        sz = f32(iz - 1)
        c2 = base[2] - sz * box[2, 2]
        sq2 = c2 * c2
        for iy in range(3):
            sy = f32(iy - 1)
            c1 = (base[1] - sy * box[1, 1]) - sz * box[2, 1]
            sq12 = fma32(c1, c1, sq2)
            b0 = (base[0] - sy * box[1, 0]) - sz * box[2, 0]
            for ix in range(3):
                c0 = b0 - f32(ix - 1) * box[0, 0]
                f[9 * ix + 3 * iy + iz] = fma32(c0, c0, sq12)
    f = np.stack(f, axis=-1)
    fmin = f.min(axis=-1)
    passed = ~((fmin - eps) > f32(cut))
    keep = fmin + f32(2.0) * eps
    return passed, f <= keep[..., None], np.stack(n0, axis=-1)


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


#: SPC/E partial charges of a water's O and H atoms (e).
SPCE_CHARGES = (-0.8476, 0.4238, 0.4238)


def water_system(rng, n_mol, box, n_frames, step=0.3, jitter=0.02,
                 charges=False):
    """``(frames, topology)`` of `n_mol` rigid 3-site waters in the cube of
    side `box`: float32 frames ``(n_frames, 3 n_mol, 3)`` and the keywords
    of ``Universe.from_arrays`` (masses O 15.999, H 1.008; one residue a
    molecule; O-H bonds, listed as ``bench.py`` lists them; with
    `charges`, the SPC/E charges O -0.8476, H +0.4238).

    As ``bench.py``'s ``make_water_frame``: oxygens at uniform centers,
    each hydrogen 0.96 A from its oxygen in a random direction.  Each
    molecule then takes a rigid N(0, `step`) A step a frame on every axis,
    every atom moves by N(0, `jitter`) A about its place in the molecule,
    and every atom is wrapped into ``[0, box)`` on its own, so molecules
    straddle the faces."""

    centers = rng.random((n_mol, 3)) * box
    arms = rng.standard_normal((2, n_mol, 3))
    arms *= 0.96 / np.linalg.norm(arms, axis=-1, keepdims=True)
    body = np.stack((np.zeros((n_mol, 3)), arms[0], arms[1]), axis=1)
    frames = np.empty((n_frames, 3 * n_mol, 3), dtype=np.float32)
    for t in range(n_frames):
        if t:
            centers += rng.normal(0.0, step, (n_mol, 3))
        pos = (centers[:, None] + body).reshape(-1, 3)
        pos += rng.normal(0.0, jitter, pos.shape)
        frames[t] = np.mod(pos, box)
    oxygen = 3 * np.arange(n_mol)
    bonds = np.empty((2 * n_mol, 2), dtype=np.int64)
    bonds[0::2] = np.stack((oxygen, oxygen + 1), axis=1)
    bonds[1::2] = np.stack((oxygen, oxygen + 2), axis=1)
    topology = dict(
        masses=np.tile([15.999, 1.008, 1.008], n_mol),
        names=np.tile(np.array(["O", "H1", "H2"], dtype=object), n_mol),
        resindices=np.repeat(np.arange(n_mol), 3),
        bonds=bonds,
    )
    if charges:
        topology["charges"] = np.tile(SPCE_CHARGES, n_mol)
    return frames, topology


def polymer_chains(rng, n_chains, n_monomers, n_frames, box, *, bond=1.0,
                   stiffness=0.0, memory=0.95, drift=0.5, start=None):
    """``(frames, unwrapped)`` of `n_chains` linear chains of `n_monomers`
    monomers, one after another, in the cube of side `box`: float32
    ``frames`` ``(n_frames, n_chains * n_monomers, 3)`` wrapped atom by atom
    into ``[0, box)``, and the float64 ``unwrapped`` positions.

    A chain's conformation (each monomer's place relative to its first)
    is a Gaussian walk whose bonds are ``stiffness`` times the bond before
    plus ``sqrt(1 - stiffness^2)`` times a fresh N(0, ``bond / sqrt(3)``)
    step an axis: bonds of about `bond` A whose correlation falls as
    ``stiffness^s`` along the contour.  From frame to frame the
    conformation is ``memory`` times the last one plus ``sqrt(1 -
    memory^2)`` times a fresh such walk (the same distribution, decorrelating
    as ``memory^t``), while the first monomer, from a uniform start in the
    box (or `start`, ``(n_chains, 3)``), takes a N(0, `drift`) step an
    axis."""

    def walk():
        steps = rng.normal(0.0, bond / np.sqrt(3.0),
                           (n_chains, n_monomers - 1, 3))
        bonds = np.empty_like(steps)
        carry = np.zeros((n_chains, 3))
        mix = np.sqrt(1.0 - stiffness**2)
        for k in range(n_monomers - 1):
            carry = stiffness * carry + (mix if k else 1.0) * steps[:, k]
            bonds[:, k] = carry
        return np.concatenate((np.zeros((n_chains, 1, 3)),
                               np.cumsum(bonds, axis=1)), axis=1)

    heads = (rng.random((n_chains, 3)) * box if start is None
             else np.asarray(start, dtype=float))
    conformation = walk()
    unwrapped = np.empty((n_frames, n_chains * n_monomers, 3))
    for t in range(n_frames):
        if t:
            heads = heads + rng.normal(0.0, drift, heads.shape)
            conformation = (memory * conformation
                            + np.sqrt(1.0 - memory**2) * walk())
        unwrapped[t] = (heads[:, None] + conformation).reshape(-1, 3)
    frames = np.mod(unwrapped, box).astype(np.float32)
    return frames, unwrapped


def float32_angle_margin(kind, raw, folded, values, fold_eps):
    r"""Degrees within which float32 evaluations of bond angles (`kind`
    ``"angle"``) or dihedrals (``"dihedral"``) may lie from their float64
    `values` ``(...)``: a first-order bound on the rounding, with its
    constants rounded up.

    `raw` and `folded` ``(..., k, 3)`` are the float64 displacement vectors
    of each term before and after the minimum-image fold (``v1 = i - j``,
    ``v2 = k - j`` for an angle; ``b1, b2, b3`` for a dihedral).
    `fold_eps` times ``(|raw| + |folded|)`` bounds the absolute float32
    error of a folded vector: ``u = 2^-24`` where the fold subtracts exact
    multiples of float32 box lengths (only the coordinate difference
    rounds), ``4 kappa u`` through a triclinic box's float32 fractional
    fold (``kappa`` the box matrix's condition number: the fractional
    coordinates, three-term products with the float32 inverse, round
    within ``4u`` of ``|raw|``, and the folded vector, three-term
    products with the box, within ``2u`` of ``|folded|``, each magnified
    by at most ``kappa``).

    * An angle turns by at most each vector's relative error ``e_i``, and
      its cosine (fused dot product, squared norms, root and quotient)
      rounds by at most ``8u``, which ``arccos`` multiplies by
      ``1 / sin(theta)`` (taken no smaller than ``4 sqrt(u)``, where the
      arccos error is of order the square root of the cosine's):
      ``e_1 + e_2 + 8u / sin(theta)``.
    * A dihedral is the signed angle between the normals ``n1 = b1 x b2``
      and ``n2 = b2 x b3``, each of which turns by at most ``(2u + e_i +
      e_j) / sin`` of the bond angle between its factors (taken no smaller
      than ``sqrt(u)``); ``m1``, the two dot products and ``atan2``'s
      argument add ``8u``.
    * ``arccos`` and ``atan2`` round their result within a few ulps, and
      so does the conversion to degrees: 8 float32 ulps of the value.
    """

    u = 2.0**-24
    length = np.linalg.norm(folded, axis=-1)
    eps = fold_eps * (np.linalg.norm(raw, axis=-1) + length) / length

    def sine(a, b):
        return (np.linalg.norm(np.cross(a, b), axis=-1)
                / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)))

    if kind == "angle":
        s = np.maximum(sine(folded[..., 0, :], folded[..., 1, :]),
                       4.0 * np.sqrt(u))
        rad = eps[..., 0] + eps[..., 1] + 8.0 * u / s
    else:
        b1, b2, b3 = (folded[..., i, :] for i in range(3))
        s1 = np.maximum(sine(b1, b2), np.sqrt(u))
        s2 = np.maximum(sine(b2, b3), np.sqrt(u))
        rad = ((2.0 * u + eps[..., 0] + eps[..., 1]) / s1
               + (2.0 * u + eps[..., 1] + eps[..., 2]) / s2 + 8.0 * u)
    ulps = np.spacing(np.abs(np.asarray(values, np.float32)))
    return np.degrees(rad) + 8.0 * ulps.astype(np.float64)
