"""The port's HydrogenBondAnalysis against the JAX package's.

The same seeded float32 waters (``testing.water_system``: bench.py's
3-site geometry at liquid density, molecules walking and wrapped atom by
atom) go through ``mdhelper_tpu.analysis.hbonds`` (streaming float32:
``_coord_dtype`` on its base class, on the CPU) and its port
(``device="cpu"``), in chunks of 2 frames of 7 (a short last chunk), in an
orthorhombic box and a triclinic one, on the whole universe and with the
donors or the acceptors restricted to a subset.  Counts, occupancies and
pair counts are integers (and their quotients by the frame count) and must
be equal; the lifetime and survival functions of the same existence
series within 1e-12.

Straddle fixtures place the acceptor at the donor-acceptor cutoff and 1
ulp on either side (D-H-A collinear), and at D-H-A angles of the float32
angle cutoff and 1 ulp on either side, each geometry exact in float32 (the
hydrogen at the origin of its plane, the donor 1 A along -x): their bonds
equal the JAX package's and those of a float64 oracle (distance and
``arccos`` of the exact float32 positions).  (An angle at the float32
cutoff itself is a tie inside the float32 evaluation's roundings, for the
JAX package too, and is not among them.)  The angle test is a tie test
that one ulp of the root flips: the port takes the correctly rounded
root, as XLA does.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu import Q_ as JQ  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import hbonds as jax_hbonds  # noqa: E402
from mdhelper_tpu.analysis.multi import run_together as jax_run_together  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.analysis import base, hbonds  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import histogram  # noqa: E402
from mdhelper_tpu_torch.testing import water_system  # noqa: E402

N_MOL, T, CHUNK = 100, 7, 2
BOX = 14.5
TRICLINIC = [BOX] * 3 + [80.0, 75.0, 70.0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_streams_float32(monkeypatch):
    monkeypatch.setattr(jax_base.SerialAnalysisBase, "_coord_dtype",
                        np.float32)


def _universes(frames, dims, topology, dt=1.0):
    return (JaxUniverse.from_arrays(frames.astype(np.float64), dims, dt=dt,
                                    **topology),
            Universe.from_arrays(frames, dims, dt=dt, **topology))


@pytest.fixture(scope="module")
def waters():
    """``{box: (jax universe, port universe)}``: the waters in the cube
    and wrapped into a triclinic cell."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices

    frames, topology = water_system(np.random.default_rng(2033), N_MOL, BOX,
                                    T, step=0.2)
    h = np.asarray(triclinic_matrices(np.asarray(TRICLINIC, float)[None]))[0]
    frac = frames.astype(np.float64) @ np.linalg.inv(h)
    tri = ((frac - np.floor(frac)) @ h).astype(np.float32)
    return {
        "ortho": _universes(frames, np.array([BOX] * 3 + [90.0] * 3),
                            topology),
        "triclinic": _universes(tri, np.asarray(TRICLINIC), topology),
    }


def _chunked(analyses, u):
    for a in analyses:
        a._chunk_bytes = CHUNK * len(a._atom_indices) * 3 * 4
    return analyses


# (box, keyword arguments)
CASES = {
    "ortho": ("ortho", dict(hydrogens_sel="name H*",
                            acceptors_sel="name O*")),
    "counts": ("ortho", dict(pair_counts=True, lifetimes=True)),
    "donor_subset": ("ortho", dict(donors_sel="resid 1:40",
                                   pair_counts=True)),
    "acceptor_subset": ("ortho", dict(acceptors_sel="name O and resid 30:90",
                                      lifetimes=True)),
    "explicit_pairs": ("ortho", dict(
        donor_hydrogen_pairs=np.stack((3 * np.arange(0, N_MOL, 2),
                                       3 * np.arange(0, N_MOL, 2) + 2), 1),
        d_a_cutoff=3.3, d_h_a_angle_cutoff=130.0)),
    "triclinic": ("triclinic", dict(pair_counts=True, lifetimes=True)),
    "triclinic_subset": ("triclinic", dict(donors_sel="resid 20:70",
                                           d_h_a_angle_cutoff=140.0)),
}


def _pair(waters, case, runner="together"):
    box, kwargs = CASES[case]
    ju, tu = waters[box]
    ref, = jax_run_together(_chunked([jax_hbonds.HydrogenBondAnalysis(
        ju, verbose=False, **kwargs)], ju))
    ours = hbonds.HydrogenBondAnalysis(tu, verbose=False, device="cpu",
                                       **kwargs)
    if runner == "together":
        ours, = run_together(_chunked([ours], tu))
    else:
        _chunked([ours], tu)
        ours.run()
    return ref, ours


@pytest.mark.parametrize("case", list(CASES))
def test_hbonds_match_jax(waters, case):
    ref, ours = _pair(waters, case)
    np.testing.assert_array_equal(ours.results.pairs, ref.results.pairs)
    np.testing.assert_array_equal(ours.results.acceptors,
                                  ref.results.acceptors)
    np.testing.assert_array_equal(ours.results.counts, ref.results.counts)
    assert ours.results.counts.min() > 0
    np.testing.assert_array_equal(ours.results.occupancies,
                                  ref.results.occupancies)
    assert ours.results.mean_count == ref.results.mean_count
    np.testing.assert_array_equal(ours.results.times, ref.results.times)
    if ref.results.pair_counts is not None:
        np.testing.assert_array_equal(ours.results.pair_counts,
                                      ref.results.pair_counts)
    if ref.results.lifetime is not None:
        for key in ("lifetime", "survival"):
            np.testing.assert_allclose(ours.results[key], ref.results[key],
                                       rtol=0, atol=1e-12)
        np.testing.assert_array_equal(ours.results.lifetime_times,
                                      ref.results.lifetime_times)
        assert set(ours.results.units) == set(ref.results.units)


@pytest.mark.parametrize("case", ["counts", "triclinic"])
def test_small_row_blocks_match_jax(monkeypatch, waters, case):
    """A donor sweep in many row blocks (a 4,096-element budget) gives the
    JAX package's bonds as integers."""

    monkeypatch.setattr(histogram, "_sweep_elements", lambda device: 1 << 12)
    assert len(histogram._row_blocks(N_MOL, N_MOL, "cpu")) > 1
    ref, ours = _pair(waters, case)
    for key in ("counts", "occupancies", "pair_counts"):
        if ref.results[key] is not None:
            np.testing.assert_array_equal(ours.results[key],
                                          ref.results[key])


def test_run_equals_run_together(waters):
    _, together = _pair(waters, "counts")
    _, alone = _pair(waters, "counts", runner="run")
    for key in ("counts", "occupancies", "pair_counts", "lifetime"):
        np.testing.assert_array_equal(alone.results[key],
                                      together.results[key])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_existence_lifetimes_match_jax(seed):
    """The lifetime engine on random existence series (runs of every
    length, channels never set, one frame) against the JAX function."""

    rng = np.random.default_rng(seed)
    for shape, p in (((40, 7), 0.6), ((25, 12), 0.2), ((1, 3), 0.5),
                     ((30, 4), 0.0)):
        h = rng.random(shape) < p
        h[:, 0] = False
        c, s = base.existence_lifetimes(h, device="cpu")
        jc, js = jax_base.existence_lifetimes(h)
        np.testing.assert_allclose(c, jc, rtol=0, atol=1e-12)
        np.testing.assert_allclose(s, js, rtol=0, atol=1e-12)


def test_lifetimes_need_uniform_frames(waters):
    """Non-uniform frame selections raise in the conclusion, as in the JAX
    class; a stride scales the lag times."""

    ju, tu = waters["ortho"]
    for cls, u, kwargs in ((jax_hbonds.HydrogenBondAnalysis, ju, {}),
                           (hbonds.HydrogenBondAnalysis, tu,
                            dict(device="cpu"))):
        with pytest.raises(ValueError, match="uniformly spaced"):
            cls(u, lifetimes=True, verbose=False, **kwargs).run(
                frames=[0, 1, 3])
    ref = jax_hbonds.HydrogenBondAnalysis(ju, lifetimes=True,
                                          verbose=False).run(step=2)
    ours = hbonds.HydrogenBondAnalysis(tu, lifetimes=True, verbose=False,
                                       device="cpu").run(step=2)
    np.testing.assert_array_equal(ours.results.lifetime_times,
                                  ref.results.lifetime_times)
    np.testing.assert_array_equal(ours.results.lifetime_times,
                                  2.0 * np.arange(4))


def test_time_step_and_quantity_cutoff(waters):
    """The class reads no time step of its own: times follow the
    trajectory's ``dt`` (the JAX class's rule); a Quantity cutoff converts
    to Angstrom."""

    frames, topology = water_system(np.random.default_rng(6), 60, 12.0, 3)
    ju, tu = _universes(frames, np.array([12.0] * 3 + [90.0] * 3),
                        topology, dt=0.5)
    ref = jax_hbonds.HydrogenBondAnalysis(
        ju, d_a_cutoff=JQ(0.32, "nm"), lifetimes=True, verbose=False).run()
    ours = hbonds.HydrogenBondAnalysis(
        tu, d_a_cutoff=Q_(0.32, "nm"), lifetimes=True, verbose=False,
        device="cpu").run()
    assert ours._d_a_cutoff == pytest.approx(3.2, rel=1e-15)
    np.testing.assert_array_equal(ours.results.counts, ref.results.counts)
    np.testing.assert_array_equal(ours.results.times, 0.5 * np.arange(3))
    np.testing.assert_array_equal(ours.results.lifetime_times,
                                  ref.results.lifetime_times)


def _straddle_system():
    """``(frames, topology, expected)``: exact D-H-A geometries, one a
    plane z = 10 k (the hydrogen at x = y = 0, the donor at x = -1), each
    farther than any cutoff from the others.  Distances: collinear, the
    acceptor at x = 3 and 1 ulp either side (bonded, bonded, not).
    Angles: the acceptor at (ax, ay) with the D-H-A angle 1 ulp of the
    float32 150 degrees either side of it, for several ay (the acceptor
    within 3 A of the donor).  (The float32
    150 degrees itself lies 0.3 ulp under 150 degrees, inside the few
    roundings of the criterion's float32 evaluation, as in the JAX
    package: a tie no float32 test decides as float64 does.)"""

    f32 = np.float32
    three = f32(3.0)
    accept = [np.nextafter(three, f32(0)), three,
              np.nextafter(three, f32(9))]
    places = [(f32(d - 1.0), f32(0.0)) for d in accept]
    theta = f32(np.radians(150.0))
    for ay in (0.5, 0.7, 0.8, 0.9):
        for step in (f32(0), f32(9)):
            th = float(np.nextafter(theta, step))
            ay = f32(ay)
            places.append((f32(-float(ay) * np.cos(th) / np.sin(th)), ay))
    n = len(places)
    pos = np.zeros((3 * n, 3), f32)
    for k, (ax, ay) in enumerate(places):
        z = f32(10.0 * k)
        pos[3 * k] = (-1.0, 0.0, z)      # donor
        pos[3 * k + 1] = (0.0, 0.0, z)   # hydrogen
        pos[3 * k + 2] = (ax, ay, z)     # acceptor
    frames = np.stack((pos, pos))
    topology = dict(
        names=np.tile(np.array(["N", "H", "O"], object), n),
        resindices=np.repeat(np.arange(n), 3),
        bonds=np.stack((3 * np.arange(n), 3 * np.arange(n) + 1), 1))
    return frames, topology, 10.0 * n + 20.0


def _f64_bonds(pos, cutoff=3.0, angle=150.0):
    """Bonded (D-H, A) pairs of exact float32 positions in float64."""

    d, h, a = (pos[i::3].astype(np.float64) for i in range(3))
    vda = a[None, :] - d[:, None]
    vhd = (d - h)[:, None]
    vha = a[None, :] - h[:, None]
    cos = (vhd * vha).sum(-1) / np.sqrt((vhd**2).sum(-1) * (vha**2).sum(-1))
    ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    return (np.sqrt((vda**2).sum(-1)) <= cutoff) & (ang >= angle)


def test_straddle_geometries_match_jax_and_f64():
    frames, topology, side = _straddle_system()
    ju, tu = _universes(frames, np.array([side] * 3 + [90.0] * 3),
                        topology)
    kwargs = dict(hydrogens_sel="name H", acceptors_sel="name O",
                  pair_counts=True, verbose=False)
    ref = jax_hbonds.HydrogenBondAnalysis(ju, **kwargs).run()
    ours = hbonds.HydrogenBondAnalysis(tu, device="cpu", **kwargs).run()
    expected = _f64_bonds(frames[0])
    np.testing.assert_array_equal(ours.results.pair_counts,
                                  2 * expected.astype(np.int64))
    np.testing.assert_array_equal(ref.results.pair_counts,
                                  ours.results.pair_counts)
    diagonal = np.diag(expected)
    # distances: in, in, out; angles: under the cutoff, then over it
    assert list(diagonal[:3]) == [True, True, False]
    assert list(diagonal[3:]) == [False, True] * 4
    assert not (expected & ~np.eye(len(expected), dtype=bool)).any()


def test_validation_matches_jax(waters):
    ju, tu = waters["ortho"]
    bare_j, bare_t = _universes(
        np.zeros((1, 6, 3), np.float32) + np.arange(6, dtype=np.float32)[
            :, None],
        np.array([10.0] * 3 + [90.0] * 3),
        dict(names=np.array(["O", "H", "H", "O", "H", "H"], object)))
    cases = [
        (ju, tu, dict(d_a_cutoff=0.0), "'d_a_cutoff' must be positive"),
        (ju, tu, dict(d_h_a_angle_cutoff=0.0), "'d_h_a_angle_cutoff'"),
        (ju, tu, dict(d_h_a_angle_cutoff=181.0), "'d_h_a_angle_cutoff'"),
        (ju, tu, dict(acceptors_sel="name X"), "No acceptors match"),
        (ju, tu, dict(hydrogens_sel="name X"), "No hydrogens match"),
        (ju, tu, dict(donors_sel="name X"), "No donor-hydrogen pairs"),
        (bare_j, bare_t, {}, "no bonds"),
    ]
    for jax_u, port_u, kwargs, match in cases:
        with pytest.raises(ValueError, match=match):
            jax_hbonds.HydrogenBondAnalysis(jax_u, verbose=False, **kwargs)
        with pytest.raises(ValueError, match=match):
            hbonds.HydrogenBondAnalysis(port_u, device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match="item 10"):
        hbonds.HydrogenBondAnalysis(tu, parallel=True, device="cpu")
