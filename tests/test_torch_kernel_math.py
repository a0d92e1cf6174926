"""CPU models of the arithmetic of the trig-sums and brute pair-histogram
kernels (``csrc/trig_sums.cu``, ``csrc/pair_histogram.cu``) against the
port's plain versions, in numpy and torch only:

* (a) the exact d^2 cut of the brute kernel (``cuda_kernels._fast_d2_cut``)
  bins exactly the floats the plain ``_fast_bin_index`` bins, on every
  float32 d^2 within 64 ulps of it, for many ``(r_max, n_bins)``;
* (b) the plain fast d^2 is bitwise symmetric in its two atoms, in the
  box and up to two boxes outside it, so one d^2 serves both orders; and
  the kernel's counting rule over unordered pairs (0, 1 or 2 a pair, the
  diagonal once) gives the plain version's integers, asymmetric
  exclusions included;
* (c) the turns from the product by ``fl(1 / 2pi_hi)``, with the IEEE
  division only near a half-integer, equal ``rint(fl(x / 2pi_hi))``;
* (d) the FMA error term equals Dekker's ``two_prod`` on the trig sums'
  magnitudes, and the kernel's whole exact phase equals the plain
  ``_exact_phases`` bit for bit;
* (e) the exact sums' accumulation (two_sum a staging step, folded into
  float64, slices added in order) matches ``math.fsum`` rounded to
  float32;
* (f) the plain fast binning takes correctly rounded roots: torch's
  float32 ``sqrt`` on the CPU is not always correctly rounded (about
  0.7 % of inputs on an AVX-512 build come out an ulp off), so
  ``_fast_bin_index`` and ``_min_image_distance`` take the root in
  float64 and round it.  On float32 squared distances at bin edges,
  those where torch's and numpy's roots disagree among them, the index
  equals the JAX package's ``_fast_index_from_dist(jnp.sqrt(d2))``; and
  the fast sweeps on pairs built one ulp from the edges count what the
  JAX RDF class counts.  The (f) tests import JAX.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mdhelper_tpu_torch.ops import scattering as sc  # noqa: E402
from mdhelper_tpu_torch.ops.doublefloat import two_prod  # noqa: E402
from mdhelper_tpu_torch.testing import edge_straddle_positions  # noqa: E402

F32 = np.float32
TWO_PI_HI, TWO_PI_LO = F32(sc._TWO_PI_HI), F32(sc._TWO_PI_LO)
#: the kernel's tie margin, 2^-20 (kTieMargin).
TIE_MARGIN = F32(2.0**-20)


def _bits(x):
    return np.asarray(x, F32).view(np.int32)


# (a) the exact d^2 cut ------------------------------------------------------

def _cut_cases(rng):
    fixed = [(6.0, 200), (7.0, 150), (4.0, 16), (5.0, 77), (15.0, 201),
             (3.0, 1), (1e-3, 1), (50.0, 1), (6.0, 57_856), (15.0, 57_856),
             (0.7, 3), (1e4, 10_000)]
    r_max = rng.uniform(0.5, 40.0, 150)
    n_bins = rng.integers(1, 60_000, 150)
    return fixed + list(zip(r_max.tolist(), n_bins.tolist()))


def test_d2_cut_equals_plain_bin_index():
    steps = np.arange(-64, 65, dtype=np.int32)
    for r_max, n_bins in _cut_cases(np.random.default_rng(21)):
        consts = cch._bin_boundary_constants(r_max, n_bins)
        cut = ck._fast_d2_cut(consts[1], n_bins)
        assert cut.dtype == F32 and np.isfinite(cut)
        d2 = (cut.view(np.int32) + steps).view(F32)
        # (a NaN d^2 fails the cut's compare; the plain version's cast of
        # a NaN estimate is undefined, so it is left out here)
        d2 = np.concatenate([d2[d2 >= 0], [F32(0.0), F32(np.inf)]]
                            ).astype(F32)
        t = torch.from_numpy(d2)
        idx = cch._fast_bin_index(t, cch._device_constants(consts, "cpu"),
                                  n_bins).numpy()
        # The plain formula with an IEEE sqrt, as the card's torch.sqrt and
        # the kernel's __fsqrt_rn take it; the plain version's root is
        # correctly rounded too.
        root = np.sqrt(d2)
        ieee = np.minimum(root * consts[1], F32(n_bins)).astype(np.int32)
        np.testing.assert_array_equal(ieee < n_bins, d2 <= cut,
                                      err_msg=f"{r_max}, {n_bins}")
        np.testing.assert_array_equal(idx < n_bins, d2 <= cut,
                                      err_msg=f"{r_max}, {n_bins}")
        np.testing.assert_array_equal(idx, ieee)
        # the kernel's index behind the cut, without the clamp
        inside = d2 <= cut
        np.testing.assert_array_equal(
            (root[inside] * consts[1]).astype(np.int32), ieee[inside])


# (b) one d^2 for both orders -------------------------------------------------

def _d2(p1, p2, box):
    return cch._fast_d2_orthorhombic(
        torch.from_numpy(p1)[:, None, :], torch.from_numpy(p2)[None, :, :],
        torch.from_numpy(np.asarray(box, F32))).numpy()


@pytest.mark.parametrize("fixture", ["straddle", "unwrapped", "brick"])
def test_fast_d2_is_symmetric(fixture):
    rng = np.random.default_rng(22)
    if fixture == "straddle":
        box = F32([16.0] * 3)
        pos = edge_straddle_positions(rng, 16.0)
    else:
        box = F32([16.0] * 3 if fixture == "unwrapped" else [9.5, 13.25, 31.0])
        pos = ((rng.random((500, 3)) * 5 - 2) * box).astype(F32)
        assert (pos < 0).any() and (pos >= 2 * box).any()
    d2 = _d2(pos, pos, box)
    np.testing.assert_array_equal(_bits(d2), _bits(d2.T))
    assert (d2.diagonal() == 0).all()


def _pair_rule_counts(pos, box, r_max, n_bins, exclusion):
    """The kernel's counting over unordered pairs: i < j adds the orders
    its exclusion keeps, (i/e0 != j/e1) + (j/e0 != i/e1), i == j once
    unless i/e0 == i/e1."""

    consts = cch._bin_boundary_constants(r_max, n_bins)
    cut = ck._fast_d2_cut(consts[1], n_bins)
    n = len(pos)
    d2 = _d2(pos, pos, box)
    ids = np.arange(n)
    e0, e1 = exclusion or (n + 1, n + 2)
    keep = (ids[:, None] // e0 != ids[None, :] // e1).astype(np.int64)
    if exclusion is None:
        keep[:] = 1
    weight = np.where(ids[:, None] < ids[None, :], keep + keep.T,
                      np.where(ids[:, None] == ids[None, :], keep, 0))
    inside = (d2 <= cut) & (weight > 0)
    idx = (np.sqrt(d2[inside]) * consts[1]).astype(np.int64)
    return np.bincount(idx, weights=weight[inside],
                       minlength=n_bins).astype(np.int64)


@pytest.mark.parametrize("exclusion", [None, (1, 1), (4, 4), (2, 3), (3, 2)])
def test_unordered_pair_rule_equals_plain(exclusion):
    rng = np.random.default_rng(23)
    for pos, box, r_max, n_bins in (
            ((rng.random((700, 3)) * 16.0).astype(F32), 16.0, 5.0, 77),
            (edge_straddle_positions(rng, 16.0), 16.0, 4.0, 16),
            (((rng.random((400, 3)) * 5 - 2) * 16.0).astype(F32), 16.0,
             5.0, 77)):
        plain = ck.pair_histogram_reference(torch.from_numpy(pos),
                                            (box,) * 3, r_max, n_bins,
                                            exclusion=exclusion)
        np.testing.assert_array_equal(
            _pair_rule_counts(pos, (box,) * 3, r_max, n_bins, exclusion),
            plain.numpy())
        assert int(plain.sum()) > 0


# (c) the turns without a division --------------------------------------------

def kernel_turns(x):
    """``exact_phase``'s turns: rint(fl(x * inv)), and rint(fl(x / 2pi_hi))
    where 0.5 - |y - rint(y)| <= 2^-20 |y|; also which took the division."""

    x = np.asarray(x, F32)
    inv = F32(1.0) / TWO_PI_HI
    y = x * inv
    turns = np.rint(y)
    near = F32(0.5) - np.abs(y - turns) <= np.abs(y) * TIE_MARGIN
    return np.where(near, np.rint(x / TWO_PI_HI), turns), near


def test_turns_rule_equals_division_near_half_integers():
    k = np.arange(0, 1592)
    assert ((k[-1] + 0.5) * float(TWO_PI_HI)) < 1e4
    centres = ((k + 0.5) * np.float64(TWO_PI_HI)).astype(F32)
    steps = np.arange(-8, 9, dtype=np.int32)
    x = (centres.view(np.int32)[:, None] + steps).view(F32).ravel()
    x = np.concatenate([x, -x, [F32(0.0), F32(-0.0)]]).astype(F32)
    turns, near = kernel_turns(x)
    want = np.rint(x / TWO_PI_HI)
    np.testing.assert_array_equal(_bits(turns), _bits(want))
    assert near.any() and not near.all()
    # the margin: |fl(x * inv) - fl(x / c)| < 2^-22 |fl(x * inv)|
    y = x * (F32(1.0) / TWO_PI_HI)
    q = x / TWO_PI_HI
    assert (np.abs(y.astype(np.float64) - q)
            < 2.0**-22 * np.abs(y.astype(np.float64)) + 1e-300).all()


def test_turns_rule_on_random_phases():
    rng = np.random.default_rng(24)
    x = (rng.uniform(-1e4, 1e4, 2_000_000)).astype(F32)
    turns, near = kernel_turns(x)
    np.testing.assert_array_equal(_bits(turns), _bits(np.rint(x / TWO_PI_HI)))
    # the division is rare: about 2^-18 |y| of the terms
    assert near.mean() < 1e-2


# (d) error-free products and the whole exact phase ---------------------------

def fma_prod(a, b):
    """``dfloat::exact_prod``: p = fl(a b), e = fma(a, b, -p) (the float64
    product of two floats is exact, and so is its difference from p)."""

    a, b = np.asarray(a, F32), np.asarray(b, F32)
    p = a * b
    e = (a.astype(np.float64) * b.astype(np.float64)
         - p.astype(np.float64)).astype(F32)
    return p, e


def _trig_magnitudes(rng, n):
    q = (rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-3, 2, n))
    r = rng.uniform(-1e4, 1e4, n) * 10.0 ** rng.uniform(-6, 0, n)
    zeros = np.array([0.0, -0.0, 1.0, -1.0, 2.5e-3, 97.0])
    q = np.concatenate([q, np.repeat(zeros, len(zeros))]).astype(F32)
    r = np.concatenate([r, np.tile(zeros, len(zeros))]).astype(F32)
    return q, r


def test_fma_prod_equals_dekker_on_trig_magnitudes():
    rng = np.random.default_rng(25)
    q, r = _trig_magnitudes(rng, 300_000)
    turns = rng.integers(-2**24, 2**24, 100_000).astype(F32)
    a = np.concatenate([q, turns, turns[:10] * 0]).astype(F32)
    b = np.concatenate([r, np.full(turns.size + 10, TWO_PI_HI)]).astype(F32)
    p, e = fma_prod(a, b)
    dp, de = two_prod(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_bits(p), _bits(dp.numpy()))
    np.testing.assert_array_equal(_bits(e), _bits(de.numpy()))


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _df_add(x, y):
    s, e = _two_sum(x[0], y[0])
    return _two_sum(s, (e + x[1]) + y[1])


def kernel_exact_phase(qs, pos, qs_lo=None):
    """A numpy model of ``exact_phase`` in csrc/trig_sums.cu, ``(N_q, N)``."""

    phase = None
    for k in range(3):
        hi, lo = fma_prod(qs[:, None, k], pos[None, :, k])
        if qs_lo is not None:
            lo = lo + qs_lo[:, None, k] * pos[None, :, k]
        phase = (hi, lo) if phase is None else _df_add(phase, (hi, lo))
    turns, _ = kernel_turns(phase[0])
    c_hi, c_lo = fma_prod(turns, np.full_like(turns, TWO_PI_HI))
    return _df_add(phase, (-c_hi, -(c_lo + turns * TWO_PI_LO)))


@pytest.mark.parametrize("with_lo", [False, True])
def test_kernel_exact_phase_bit_equal_to_plain(with_lo):
    rng = np.random.default_rng(26)
    # a 500 A box, q up to 8 per A: phases of thousands of radians; one
    # atom at the origin and one wavevector with a zero component
    pos = (rng.random((400, 3)) * 500.0).astype(F32)
    pos[0] = 0.0
    q64 = rng.random((120, 3)) * 8.0 - 4.0
    q64[0, 1] = 0.0
    qs = q64.astype(F32)
    lo = (q64 - qs).astype(F32) if with_lo else None
    hi_m, lo_m = kernel_exact_phase(qs, pos, lo)
    hi_p, lo_p = sc._exact_phases(
        torch.from_numpy(qs), torch.from_numpy(pos),
        None if lo is None else torch.from_numpy(lo))
    np.testing.assert_array_equal(_bits(hi_m), _bits(hi_p.numpy()))
    np.testing.assert_array_equal(_bits(lo_m), _bits(lo_p.numpy()))


# (e) the exact sums' accumulation --------------------------------------------

def kernel_sum(terms, stage=ck._TRIG_STAGE, split=ck._TRIG_SLICE_ATOMS):
    """A numpy model of the exact kernel's sums of ``terms`` ``(M, N)``:
    two_sum and a float32 compensation over each staging step, folded
    into a float64 accumulator a slice (the step's sum, then its
    compensation), the slices added in order; rounded to float32."""

    m, n = terms.shape
    steps = -(-n // stage)
    padded = np.zeros((m, steps * stage), F32)
    padded[:, :n] = terms
    padded = padded.reshape(m, steps, stage)
    s = np.zeros((m, steps), F32)
    c = np.zeros((m, steps), F32)
    for k in range(stage):
        s, e = _two_sum(s, padded[:, :, k])
        c = c + e
    per_slice = split // stage
    total = np.zeros(m)
    for first in range(0, steps, per_slice):
        acc = np.zeros(m)
        for step in range(first, min(steps, first + per_slice)):
            acc = acc + s[:, step].astype(np.float64)
            acc = acc + c[:, step].astype(np.float64)
        total = total + acc
    return total.astype(F32)


@pytest.mark.parametrize("n_atoms, weighted", [(100_000, False),
                                               (20_011, True)])
def test_compensated_sums_match_fsum(n_atoms, weighted):
    rng = np.random.default_rng(27)
    n_sums = 96
    phases = rng.uniform(-300.0, 300.0, (n_sums, n_atoms)).astype(F32)
    terms = np.cos(phases)
    if weighted:
        terms = terms * rng.uniform(0.0, 9.0, n_atoms).astype(F32)
    # a few sums near zero (a pair of opposite terms each)
    terms[:8, 1::2] = -terms[:8, 0:-1:2]
    want = np.array([math.fsum(row.astype(np.float64)) for row in terms]
                    ).astype(F32)
    np.testing.assert_array_equal(_bits(kernel_sum(terms)), _bits(want))
    # the plain version's float64 sum rounds to the same floats
    plain = torch.from_numpy(terms).sum(dim=-1, dtype=torch.float64)
    np.testing.assert_array_equal(_bits(plain.to(torch.float32).numpy()),
                                  _bits(want))


# (f) correctly rounded roots in the plain fast binning ------------------------

def _edge_d2(r_max, n_bins, spread=4):
    """float32 squared distances within `spread` ulps of each bin edge's
    square, and the binning constants."""

    consts = cch._bin_boundary_constants(r_max, n_bins)
    edges = np.arange(1, n_bins + 1) / np.float64(consts[1])
    centre = (edges * edges).astype(F32).view(np.int32)
    steps = np.arange(-spread, spread + 1, dtype=np.int32)
    return consts, (centre[:, None] + steps).ravel().view(F32)


@pytest.mark.parametrize("r_max, n_bins",
                         [(6.0, 57_856), (15.0, 20_000), (6.0, 200),
                          (5.0, 77), (2.0, 3)])
def test_fast_bin_index_equals_jax_at_edges(r_max, n_bins):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mdhelper_tpu.ops import pallas_cell_histogram as jax_cells

    consts, d2 = _edge_d2(r_max, n_bins)
    jax_consts = jax_cells._bin_boundary_constants(r_max, n_bins)
    assert jax_consts[:2] == consts[:2]
    ref = np.asarray(jax_cells._fast_index_from_dist(
        jnp.sqrt(jnp.asarray(d2)), jax_consts, n_bins))
    got = cch._fast_bin_index(torch.from_numpy(d2),
                              cch._device_constants(consts, "cpu"),
                              n_bins).numpy()
    np.testing.assert_array_equal(got, np.minimum(ref, n_bins))
    # and, by themselves, the squares on which torch's float32 root and
    # numpy's disagree
    disagree = torch.sqrt(torch.from_numpy(d2)).numpy() != np.sqrt(d2)
    np.testing.assert_array_equal(got[disagree],
                                  np.minimum(ref, n_bins)[disagree])


#: the edge-pair fixture: 4,096 bins on [0, 4] (a float32 inverse width
#: of 1024, edges at k / 1024 exactly), one pair at each site of a 6^3
#: lattice 12.5 A apart in a 75 A cube, so only the 216 pairs are in range.
EDGE_R, EDGE_BINS, EDGE_BOX, EDGE_SITES = 4.0, 4096, 75.0, 6


def _edge_pairs(rng, tries=1000, steps=17):
    """(positions (432, 3) float32, pairs at which torch's float32 root
    bins otherwise): for each lattice site, a partner whose float32
    squared distance (as the plain sweeps form it) has a correctly
    rounded root within one ulp of a bin edge, binned by that root as
    the float64 distance of the float32 positions bins it; partners at
    which torch's own float32 root crosses the edge are taken first."""

    spacing = EDGE_BOX / EDGE_SITES
    grid = np.stack(np.meshgrid(*[np.arange(EDGE_SITES)] * 3,
                                indexing="ij"), -1).reshape(-1, 3)
    sites = (spacing / 2 + spacing * grid).astype(F32)
    u = rng.normal(size=(len(sites), tries, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    length = rng.integers(EDGE_BINS // 4, EDGE_BINS, (len(sites), tries))
    partner = sites[:, None].astype(np.float64) + u * (length / 1024)[..., None]
    # walk z across the edge in steps of 2^-19 A
    partner = (partner[:, :, None] + np.stack(
        [np.zeros(steps), np.zeros(steps),
         (np.arange(steps) - steps // 2) * 2.0**-19], -1)).reshape(
             len(sites), -1, 3).astype(F32)
    base = np.broadcast_to(sites[:, None], partner.shape)
    d2 = cch._fast_d2_orthorhombic(
        torch.from_numpy(np.ascontiguousarray(base)),
        torch.from_numpy(partner),
        torch.full((3,), EDGE_BOX, dtype=torch.float32)).numpy()
    inv = F32(EDGE_BINS / EDGE_R)
    root = np.sqrt(d2)
    idx = (root * inv).astype(np.int64)
    flips = ((np.nextafter(root, F32(np.inf)) * inv).astype(np.int64) != idx) | (
        (np.nextafter(root, F32(0)) * inv).astype(np.int64) != idx)
    exact = np.sqrt(((partner.astype(np.float64)
                      - base.astype(np.float64)) ** 2).sum(-1)) * 1024
    agree = ((np.floor(exact) == idx) & (exact < EDGE_BINS)
             & (np.abs(exact - np.round(exact)) > 1e-9))
    torch_idx = (torch.sqrt(torch.from_numpy(d2)).numpy() * inv).astype(
        np.int64)
    score = (flips & agree) * (1 + (torch_idx != idx))
    pick = score.argmax(axis=1)
    assert (score[np.arange(len(sites)), pick] > 0).all()
    chosen = partner[np.arange(len(sites)), pick]
    bites = int((score[np.arange(len(sites)), pick] == 2).sum())
    return np.concatenate([sites, chosen]).astype(F32), bites


def test_fast_sweeps_on_edge_pairs_equal_jax_rdf():
    pytest.importorskip("jax")
    from mdhelper_tpu.analysis import base as jax_base
    from mdhelper_tpu.analysis.structure import RadialDistributionFunction
    from mdhelper_tpu.core.universe import Universe

    # (pairs that torch's float32 root bins otherwise: 4 on an AVX-512
    # build; none where it is correctly rounded)
    pos, _ = _edge_pairs(np.random.default_rng(61))
    dims = np.array([EDGE_BOX] * 3 + [90.0] * 3)
    universe = Universe.from_arrays(pos[None].astype(np.float64), dims)
    rdf = RadialDistributionFunction(universe.atoms, n_bins=EDGE_BINS,
                                     range=(0.0, EDGE_R), exclusion=(1, 1),
                                     verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        rdf.run()
    ref = np.asarray(rdf.results.counts)
    assert ref.sum() == 2 * len(pos) // 2

    box = torch.full((3,), EDGE_BOX, dtype=torch.float32)
    plan = cch.cell_plan_search(len(pos), np.full(3, EDGE_BOX), EDGE_R)
    cells, _ = cch.cell_pair_histogram(
        torch.from_numpy(pos)[None], box=box, r_max=EDGE_R,
        n_cells_dim=plan["n_cells_dim"], reach=plan["reach"],
        capacity=plan["capacity"], n_bins=EDGE_BINS, exclusion=(1, 1),
        precision="fast")
    brute = ck.pair_histogram(torch.from_numpy(pos), box, EDGE_R,
                              EDGE_BINS, exclusion=(1, 1))
    np.testing.assert_array_equal(cells[0].numpy(), ref)
    np.testing.assert_array_equal(brute.numpy(), ref)
