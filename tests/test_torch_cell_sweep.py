"""CPU models of the cell kernels' per-pair arithmetic (``csrc/cell_bin.cuh``)
against the port's plain versions, in numpy and torch only:

* the division-free orthorhombic image multiple -- ``m = (s > T) - (s <
  -T)`` with ``T`` the largest float whose ``fl(T / L) <= 0.5`` -- equals
  ``rint(fl(s / L))`` on every float within 64 ulps of ``+-L / 2`` for a
  few hundred box lengths, and the fast component and d^2 it gives equal
  the plain version's bit for bit on per-frame boxes;
* ``two_prod`` by one fused multiply-add (the exact float64 product minus
  ``p``, rounded once, as the FMA rounds it) equals Dekker's
  ``ops/doublefloat.py::two_prod`` bit for bit, on random and adversarial
  inputs;
* the float32 screens: of an orthorhombic pair (a pair it rules out lies
  beyond the last bin boundary), and of the tri_pp search (the
  double-float minimum over the candidates it keeps equals the full
  27-way ``df_min`` of ``_exact_d2_triclinic``, on random pairs and on
  built near-ties in skewed boxes, and a pair it rules out lies beyond
  the boundary).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mdhelper_tpu_torch.algorithm.topology import (  # noqa: E402
    triclinic_matrices,
)
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.ops.doublefloat import (  # noqa: E402
    df_add,
    df_lt,
    df_square,
    df_sub,
    df_sum3,
    two_diff,
    two_prod,
)
from mdhelper_tpu_torch.ops.histogram import (  # noqa: E402
    _exact_d2_orthorhombic,
    _exact_d2_triclinic,
    _inv3,
)
from mdhelper_tpu_torch.testing import (  # noqa: E402
    SCREEN_EPS,
    fma32,
    tri27_screen,
)

F32 = np.float32


def half_threshold(length):
    """``cellbin::half_threshold``: from ``L / 2`` up while
    ``fl(next / L) <= 0.5``."""

    length = F32(length)
    t = F32(0.5) * length
    for _ in range(8):
        nxt = np.nextafter(t, F32(np.inf))
        if nxt / length > F32(0.5):
            break
        t = nxt
    return t


def image_multiple(s, t):
    return np.where(s > t, F32(1.0), np.where(s < -t, F32(-1.0), F32(0.0)))


def _bits(x):
    return np.asarray(x, F32).view(np.int32)


def _lengths(rng):
    """A few hundred float32 box lengths: uniform, powers of two and
    their neighbours, and awkward significands."""

    uniform = rng.uniform(1.0, 500.0, 200)
    powers = 2.0 ** np.arange(-2, 10)
    odd = np.array([3.0, 6.0, 14.0, 18.42, 39.685, 50.0, 79.37, 100.0,
                    12.5, 56.12, 89.09, 44.54, 20.67, 1.0 + 2**-23])
    out = np.concatenate([uniform, powers, odd]).astype(F32)
    return np.concatenate([out, np.nextafter(out, F32(0)),
                           np.nextafter(out, F32(np.inf))])


def test_half_threshold_gives_rint_of_the_quotient():
    """Every float within 64 ulps of +-L / 2 (and 0, +-L) gets the image
    multiple rint(fl(s / L)) from the threshold, for each length."""

    lengths = _lengths(np.random.default_rng(11))
    assert lengths.size > 600
    steps = np.arange(-64, 65, dtype=np.int32)
    for length in lengths:
        t = half_threshold(length)
        assert t / length <= F32(0.5) < np.nextafter(t, F32(np.inf)) / length
        mid = (F32(0.5) * length).view(np.int32)
        s = (mid + steps).view(F32)
        s = np.concatenate([s, -s, [F32(0.0), length, -length]]).astype(F32)
        want = np.rint(s / length)
        np.testing.assert_array_equal(image_multiple(s, t), want)
        # the fast component delta - L m, bit for bit
        np.testing.assert_array_equal(_bits(s - length * image_multiple(s, t)),
                                      _bits(s - length * want))


def test_threshold_image_matches_plain_on_per_frame_boxes():
    """Per-frame (NPT) boxes: the fast d^2 the kernels form with each
    frame's thresholds equals the plain version's (``rint(delta / L)``)
    bit for bit, and the exact image multiples are the plain version's."""

    rng = np.random.default_rng(12)
    boxes = (np.array([14.0, 15.0, 16.0]) * (1.0 + 0.05 * np.arange(
        6)[:, None] / 5)).astype(F32)
    for box in boxes:
        p1 = (rng.random((4000, 3)) * box).astype(F32)
        p2 = (rng.random((4000, 3)) * box).astype(F32)
        delta = p1 - p2
        comps = [delta[:, k] - box[k] * image_multiple(
            delta[:, k], half_threshold(box[k])) for k in range(3)]
        model = (comps[0] * comps[0] + comps[1] * comps[1]) + comps[2] * comps[2]
        plain = cch._fast_d2_orthorhombic(torch.from_numpy(p1),
                                          torch.from_numpy(p2),
                                          torch.from_numpy(box))
        np.testing.assert_array_equal(_bits(model), _bits(plain.numpy()))
        for k in range(3):
            np.testing.assert_array_equal(
                image_multiple(delta[:, k], half_threshold(box[k])),
                np.rint(delta[:, k] / box[k]))


def fma_two_prod(a, b):
    """``cellbin::exact_prod``: p = fl(a b), e = fma(a, b, -p) -- the
    float64 product of two floats is exact, so is its difference from p,
    and the cast rounds once as the FMA does."""

    a, b = np.asarray(a, F32), np.asarray(b, F32)
    p = a * b
    e = (a.astype(np.float64) * b.astype(np.float64)
         - p.astype(np.float64)).astype(F32)
    return p, e


def test_fma_two_prod_equals_dekker():
    rng = np.random.default_rng(13)
    random = (rng.standard_normal(200_000)
              * 10.0 ** rng.uniform(-12, 12, 200_000)).astype(F32)
    mantissas = np.array([1.0, 1.5, 1.9999999, 1.0000001, 1.00024414,
                          1.99975586, 4097.0 / 4096.0], F32)
    exponents = 2.0 ** np.arange(-40, 41, 4)
    edge = (mantissas[:, None] * exponents[None]).ravel().astype(F32)
    ints = np.arange(0, 30_000, 7, dtype=np.int64)
    squares = (ints * ints).astype(F32)
    special = np.array([0.0, -0.0, 1.0, -1.0, 2.0**-40, 2.0**40], F32)
    pool = np.concatenate([random, edge, -edge, squares, special])
    a = pool
    b = rng.permutation(pool)
    a = np.concatenate([a, edge, squares[:50], special])
    b = np.concatenate([b, edge[::-1], np.full(50, F32(2.25e-4)), special[::-1]])
    prod = np.abs(a.astype(np.float64) * b.astype(np.float64))
    # the magnitudes the kernels see (coordinates, box entries, bin
    # constants and multiples): no product under or over float32's range
    keep = (prod == 0) | ((prod > 2.0**-100) & (prod < 2.0**100))
    a, b = a[keep], b[keep]
    assert a.size > 200_000
    p, e = fma_two_prod(a, b)
    dp, de = two_prod(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_bits(p), _bits(dp.numpy()))
    np.testing.assert_array_equal(_bits(e), _bits(de.numpy()))


def _boundary(r):
    """A last bin boundary (r^2 as a double-float) and the kernels' cut,
    the float above its high word."""

    hi = F32(r) * F32(r)
    return (torch.tensor(hi), torch.tensor(F32(0.0))), np.nextafter(
        hi, F32(np.inf))


def test_orthorhombic_screen_rules_out_only_far_pairs():
    """A pair whose fast d^2 minus eps (2^-18 sum_k (2 L_k)^2) exceeds
    the cut lies strictly beyond the boundary in double-float; pairs
    straddling r_max pass."""

    rng = np.random.default_rng(14)
    box = np.array([14.0, 15.5, 50.0], F32)
    r_max = 6.0
    p1 = (rng.random((60_000, 3)) * box).astype(F32)
    direction = rng.standard_normal((60_000, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    radius = r_max + rng.uniform(-1e-4, 1e-4, 60_000)
    p2 = np.mod(p1 + direction * radius[:, None], box).astype(F32)
    p2 = np.where(p2 >= box, F32(0.0), p2)
    eps = SCREEN_EPS * F32(4.0 * float(np.sum(box.astype(np.float64) ** 2)))
    delta = p1 - p2
    comps = [delta[:, k] - box[k] * image_multiple(
        delta[:, k], half_threshold(box[k])) for k in range(3)]
    f = fma32(comps[2], comps[2], fma32(comps[1], comps[1],
                                         comps[0] * comps[0]))
    bound, cut = _boundary(r_max)
    out = (f - eps) > cut
    d2 = _exact_d2_orthorhombic(torch.from_numpy(p1), torch.from_numpy(p2),
                                torch.from_numpy(box))
    beyond = df_lt(bound, d2).numpy()
    assert np.all(beyond[out])
    # the pairs within the boundary, and those just beyond it, pass
    assert (~out).sum() > 1000 and np.all(~out[~beyond])


def _candidates(p1, p2, box, n0):
    """Every candidate's double-float d^2, ``(..., 27)`` hi and lo, in
    the screen's index order, with the plain version's arithmetic."""

    s = [two_diff(p1[..., k], p2[..., k]) for k in range(3)]
    his, los = [], []
    for q in range(27):
        shift = (q // 9 - 1, (q // 3) % 3 - 1, q % 3 - 1)
        m = [n0[..., j] + float(shift[j]) for j in range(3)]
        comps = []
        for k in range(3):
            t = two_prod(m[k], box[k, k])
            for j in range(k + 1, 3):
                t = df_add(t, two_prod(m[j], box[j, k]))
            comps.append(df_square(df_sub(s[k], t)))
        hi, lo = df_sum3(*comps)
        his.append(hi)
        los.append(lo)
    return torch.stack(his, -1), torch.stack(los, -1)


def _screened_min(hi, lo, kept):
    """The lexicographic minimum over the kept candidates (the kernel's
    df_min in ascending index)."""

    best_hi = torch.full(hi.shape[:-1], float("inf"))
    best_lo = torch.zeros(hi.shape[:-1])
    for q in range(27):
        k = torch.from_numpy(kept[..., q])
        take = k & df_lt((hi[..., q], lo[..., q]), (best_hi, best_lo))
        best_hi = torch.where(take, hi[..., q], best_hi)
        best_lo = torch.where(take, lo[..., q], best_lo)
    return best_hi, best_lo


#: skewed cells: the xy-square rhombic dodecahedron (alpha = beta = 60),
#: a monoclinic tilt, and a general triclinic cell.
TRI_BOXES = {
    "dodecahedron": np.array([18.0] * 3 + [60.0, 60.0, 90.0]),
    "monoclinic": np.array([20.0, 17.0, 15.0, 90.0, 110.0, 90.0]),
    "triclinic": np.array([16.0, 15.0, 14.0, 80.0, 95.0, 100.0]),
}


def _tri_pairs(rng, h, n):
    """Random pairs in the cell, and built near-ties: partners half a
    lattice vector (or half a sum or difference of two) away, plus a few
    ulps of noise, where two images are nearly equally near."""

    frac = rng.random((n, 3))
    p2 = frac @ h
    half = []
    for i in range(3):
        half.append(0.5 * h[i])
        for j in range(i + 1, 3):
            half += [0.5 * (h[i] + h[j]), 0.5 * (h[i] - h[j])]
    half.append(0.5 * (h[0] + h[1] + h[2]))
    half = np.array(half)
    pick = half[rng.integers(0, len(half), n)]
    noise = rng.standard_normal((n, 3)) * 1e-6 * np.abs(h).max()
    tie = p2 + pick + noise
    uniform = rng.random((n, 3)) @ h
    p1 = np.where(np.arange(n)[:, None] % 2 == 0, tie, uniform)
    return p1.astype(F32), p2.astype(F32)


@pytest.mark.parametrize("name", list(TRI_BOXES))
def test_tri27_screen_keeps_the_minimum(name):
    rng = np.random.default_rng(15)
    h = triclinic_matrices(TRI_BOXES[name]).astype(F32)
    box = torch.from_numpy(h)
    inv = _inv3(box)
    p1, p2 = _tri_pairs(rng, h.astype(np.float64), 4000)
    r_max = 6.0
    bound, cut = _boundary(r_max)
    passed, kept, n0 = tri27_screen(p1, p2, h, inv.numpy(), cut)
    t1, t2 = torch.from_numpy(p1), torch.from_numpy(p2)
    full = _exact_d2_triclinic(t1, t2, box, inv)
    hi, lo = _candidates(t1, t2, box, torch.from_numpy(n0))
    # the full minimum of these candidates is the plain version's
    np.testing.assert_array_equal(
        _bits(_screened_min(hi, lo, np.ones_like(kept))[0].numpy()),
        _bits(full[0].numpy()))
    best = _screened_min(hi, lo, kept)
    p = passed
    np.testing.assert_array_equal(_bits(best[0].numpy()[p]),
                                  _bits(full[0].numpy()[p]))
    np.testing.assert_array_equal(_bits(best[1].numpy()[p]),
                                  _bits(full[1].numpy()[p]))
    # a pair ruled out lies strictly beyond the boundary
    assert np.all(df_lt(bound, full).numpy()[~passed])
    assert passed.sum() > 100 and (~passed).sum() > 100
    # the near-ties keep two or more candidates; most pairs keep one
    n_kept = kept.sum(axis=-1)
    assert n_kept[passed].min() >= 1
    assert (n_kept[::2] >= 2).mean() > 0.5
    assert np.median(n_kept[1::2][passed[1::2]]) == 1


def test_tri27_screen_out_of_range_exit():
    """Far pairs in a large cell are ruled out before any double-float
    candidate; all of them lie beyond the boundary."""

    rng = np.random.default_rng(16)
    h = triclinic_matrices(np.array([60.0] * 3 + [60.0, 60.0, 90.0]))
    h = h.astype(F32)
    box = torch.from_numpy(h)
    inv = _inv3(box)
    p1 = (rng.random((3000, 3)) @ h.astype(np.float64)).astype(F32)
    p2 = (rng.random((3000, 3)) @ h.astype(np.float64)).astype(F32)
    bound, cut = _boundary(4.0)
    passed, _, _ = tri27_screen(p1, p2, h, inv.numpy(), cut)
    full = _exact_d2_triclinic(torch.from_numpy(p1), torch.from_numpy(p2),
                               box, inv)
    assert (~passed).mean() > 0.9
    assert np.all(df_lt(bound, full).numpy()[~passed])
