"""The port's FlowProfile against the JAX package's and a float64 oracle.

The same seeded float32 positions and velocities (thermal velocities at
about 300 K for masses 1-40 u, a Couette profile u_x = rate (z - L/2) and
a uniform drift) go through ``mdhelper_tpu.analysis.flow.FlowProfile``
(streaming float32: ``_coord_dtype`` on its base class, on the CPU) and
its port (``device="cpu"``), in chunks of 4 frames of 14.

* Counts are integers and equal the JAX package's, on straddle fixtures
  too: coordinates one float32 ulp either side of interior edges, of the
  box floor and of the box length (the float64 ``numpy.linspace`` edges
  rounded to float32, not the ``i * (L * (1/n))`` float32 edges of the
  density profiles).
* The port forms the centered moments from the float32 velocities in
  float64 and sums them with ``bincount``; it equals a numpy float64
  oracle of the same estimator within ``rtol=1e-10``.  The JAX class forms
  and sums them in float32 (its per-frame histograms accumulate in the
  stream dtype), so its streaming velocities and temperatures sit within
  ``JAX_RTOL`` of the port's: a bin's float32 sums of ~N/n_bins terms of
  thermal size carry relative errors of a few 1e-7, and the drift-removed
  kinetic energy cancels about a third of its sum.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import flow as jax_flow  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.analysis import flow  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N, T, CHUNK = 900, 14, 4
BOX = np.array([9.0, 10.0, 12.3])
N_BINS = 24
RATE = 0.05  # 1/ps
K_B = 0.8314462621026538  # u A^2 ps^-2 K^-1
JAX_RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_streams_float32(monkeypatch):
    monkeypatch.setattr(jax_base.SerialAnalysisBase, "_coord_dtype",
                        np.float32)


def couette_frames(rng, n_frames, n_atoms, box, masses, rate, kelvin=300.0,
                   drift=(0.3, -0.2, 0.1)):
    """float32 positions (uniform, then a small random walk; some outside
    the box) and velocities: Maxwell-Boltzmann at `kelvin` plus u_x = rate
    (z - L_z / 2) plus a uniform drift."""

    pos = rng.random((n_atoms, 3)) * box
    pos = pos + np.cumsum(rng.normal(0.0, 0.2, (n_frames, n_atoms, 3)),
                          axis=0)
    sigma = np.sqrt(K_B * kelvin / masses)[None, :, None]
    vel = rng.standard_normal((n_frames, n_atoms, 3)) * sigma
    vel[..., 0] += rate * (np.mod(pos[..., 2], box[2]) - box[2] / 2)
    vel += np.asarray(drift)
    return pos.astype(np.float32), vel.astype(np.float32)


def _pair(pos, vel, dims, masses, dt=0.5):
    ju = JaxUniverse.from_arrays(pos.astype(np.float64), dims, dt=dt,
                                 velocities=vel.astype(np.float64),
                                 masses=masses)
    tu = Universe.from_arrays(pos, dims, dt=dt, velocities=vel,
                              masses=masses)
    return ju, tu


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(11)
    masses = rng.uniform(1.0, 40.0, N)
    pos, vel = couette_frames(rng, T, N, BOX, masses, RATE)
    return pos, vel, np.concatenate([BOX, [90.0] * 3]), masses


@pytest.fixture(scope="module")
def universes(system):
    return _pair(*system)


def _run(a, runner="run"):
    a._chunk_bytes = CHUNK * len(a._atom_indices) * 4 * 4
    if runner == "together":
        return run_together([a])[0]
    return a.run()


def oracle_sums(pos, vel, masses, lengths, axis, n_bins, length):
    """The estimator's per-bin sums in float64 from the float32 inputs:
    the coordinate wrapped in float32 with each frame's length (``x -
    floor(x / L) L`` rounded once, as XLA fuses it), binned in float32
    against the float64 linspace edges rounded to float32."""

    edges = np.linspace(0.0, length, n_bins + 1).astype(np.float32)
    sums = {k: np.zeros(n_bins) for k in ("n", "m", "mw2", "boost")}
    sums["mw"] = np.zeros((n_bins, 3))
    sums["drift"] = np.zeros((n_bins, 3))
    m64 = masses.astype(np.float64)
    for f in range(len(pos)):
        L = np.float32(lengths[f])
        x = pos[f, :, axis]
        if L > 0:
            x = (x.astype(np.float64) - np.float64(L)
                 * np.floor(x / L)).astype(np.float32)
        idx = np.searchsorted(edges, x, side="right") - 1
        idx[x == edges[-1]] = n_bins - 1
        ok = (x >= edges[0]) & (x <= edges[-1])
        idx = np.clip(idx, 0, n_bins - 1)[ok]
        v = vel[f].astype(np.float64)
        u = (m64[:, None] * v).sum(0) / m64.sum()
        w = v - u
        mw = m64[:, None] * w
        mw2 = (mw * w).sum(-1)
        m_f = np.bincount(idx, m64[ok], n_bins)
        mw_f = np.stack([np.bincount(idx, mw[ok, a], n_bins)
                         for a in range(3)], 1)
        sums["n"] += np.bincount(idx, minlength=n_bins)
        sums["m"] += m_f
        sums["mw"] += mw_f
        sums["mw2"] += np.bincount(idx, mw2[ok], n_bins)
        sums["drift"] += u[None, :] * m_f[:, None]
        sums["boost"] += 2.0 * (mw_f * u).sum(-1) + (u * u).sum() * m_f
    return sums


def _carry_sums(prof):
    c = {k: v.numpy() for k, v in prof._carry.items()}
    return {
        "n": c["n"], "m": c["m"], "mw2": c["mw2"], "boost": c["boost"],
        "mw": np.stack([c["mwx"], c["mwy"], c["mwz"]], 1),
        "drift": np.stack([c["driftx"], c["drifty"], c["driftz"]], 1),
    }


def _assert_oracle(prof, want):
    got = _carry_sums(prof)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-10,
                                   atol=1e-10 * np.abs(value).max(),
                                   err_msg=key)


CASES = {
    "atoms": (slice(None), dict()),
    "subset": (slice(5, 800, 3), dict(axis="z", n_bins=17)),
    "x_raw": (slice(None), dict(axis="x", n_bins=N_BINS,
                                remove_drift=False)),
    "reduced": (slice(100, 700), dict(axis="y", n_bins=N_BINS,
                                      reduced=True)),
}


@pytest.mark.parametrize("runner", ["run", "together"])
@pytest.mark.parametrize("case", list(CASES))
def test_flow_matches_jax_and_oracle(universes, system, case, runner):
    ju, tu = universes
    sel, kwargs = CASES[case]
    kwargs = {"n_bins": N_BINS, **kwargs}
    ref = _run(jax_flow.FlowProfile(ju.atoms[sel], verbose=False, **kwargs))
    out = _run(flow.FlowProfile(tu.atoms[sel], verbose=False, device="cpu",
                                **kwargs), runner)
    np.testing.assert_array_equal(out.results.counts, ref.results.counts)
    for key in ("bins", "number_density"):
        np.testing.assert_allclose(out.results[key], ref.results[key],
                                   rtol=1e-12, err_msg=key)
    for key in ("mass_density", "velocity", "temperature"):
        np.testing.assert_allclose(out.results[key], ref.results[key],
                                   rtol=JAX_RTOL, err_msg=key)
    pos, vel, dims, masses = system
    idx = np.arange(N)[sel]
    axis = "xyz".index(kwargs.get("axis", "z"))
    want = oracle_sums(pos[:, idx], vel[:, idx], masses[idx],
                       np.full(T, BOX[axis]), axis, kwargs["n_bins"],
                       BOX[axis])
    _assert_oracle(out, want)
    assert ("units" in out.results) == ("units" in ref.results)


def test_recovers_shear_rate_and_temperature(universes):
    _, tu = universes
    out = _run(flow.FlowProfile(tu.atoms, n_bins=N_BINS, verbose=False,
                                device="cpu"))
    rate = out.calculate_shear_rate("x")
    assert abs(rate - RATE) < 0.2 * RATE
    assert str(out.results.units["results.shear_rate"]) == "1 / picosecond"
    temperature = out.results.temperature
    assert np.all(np.abs(temperature / 300.0 - 1) < 0.25)
    assert abs(np.average(temperature, weights=out.results.counts) / 300.0
               - 1) < 0.05
    with pytest.raises(ValueError, match="component"):
        out.calculate_shear_rate("w")
    with pytest.raises(ValueError, match="Fewer than two"):
        out.calculate_shear_rate(window=slice(0, 1))
    assert np.isfinite(out.calculate_shear_rate("y", window=slice(3, 20)))


def test_straddle_counts_match_jax_and_f32_edges():
    """Coordinates one float32 ulp either side of interior edges, at the
    box floor (0 and -ulp, which wraps to L - ulp or L) and at the box
    length: counts equal the JAX package's and a float32 binning against
    the float64 linspace edges rounded to float32."""

    length = 12.3
    edges = np.linspace(0.0, length, N_BINS + 1).astype(np.float32)
    coords = [np.float32(0.0), -np.float32(1e-7)]
    for e in edges[1:-1:3]:
        coords += [np.nextafter(e, np.float32(-1)), e,
                   np.nextafter(e, np.float32(99))]
    coords += [np.nextafter(np.float32(length), np.float32(0)),
               np.float32(length)]
    n = len(coords)
    pos = np.zeros((2, n, 3), np.float32)
    pos[..., 2] = coords
    vel = np.ones_like(pos)
    dims = np.concatenate([BOX, [90.0] * 3])
    ju, tu = _pair(pos, vel, dims, np.ones(n))
    ref = _run(jax_flow.FlowProfile(ju.atoms, n_bins=N_BINS, verbose=False))
    out = _run(flow.FlowProfile(tu.atoms, n_bins=N_BINS, verbose=False,
                                device="cpu"))
    np.testing.assert_array_equal(out.results.counts, ref.results.counts)
    want = oracle_sums(pos, vel, np.ones(n), np.full(2, length), 2, N_BINS,
                       length)["n"]
    np.testing.assert_array_equal(out.results.counts, want)
    # the float32 edges of the density profiles would bin some otherwise
    from mdhelper_tpu_torch.ops.profiles import linspace_edges_f32

    assert not np.array_equal(linspace_edges_f32(length, N_BINS), edges)


def test_out_of_box_straddles_wrap_as_jax():
    """Coordinates a few ulps either side of an interior edge plus k box
    lengths (k = 1, -1, 2, -3, 5): XLA wraps them with one rounding (a
    fused multiply-add), which puts a few hundred of them an ulp away from
    the separately rounded wrap; the port's counts equal the JAX
    package's."""

    length, n_bins = np.float32(12.3), N_BINS
    edges = np.linspace(0.0, 12.3, n_bins + 1).astype(np.float32)
    xs = []
    for e in edges[1:-1]:
        for k in (1, -1, 2, -3, 5):
            v = np.float32(e + k * length)
            for _ in range(4):
                v = np.nextafter(v, np.float32(-1e9))
            for _ in range(9):
                xs.append(v)
                v = np.nextafter(v, np.float32(1e9))
    xs = np.asarray(xs, np.float32)
    plain = xs - length * np.floor(xs / length)
    fused = (xs.astype(np.float64) - np.float64(length)
             * np.floor(xs / length)).astype(np.float32)
    assert np.sum(plain != fused) > 100
    n = len(xs)
    pos = np.zeros((1, n, 3), np.float32)
    pos[0, :, 2] = xs
    ju, tu = _pair(pos, np.ones_like(pos), np.concatenate([BOX, [90.0] * 3]),
                   np.ones(n))
    ref = _run(jax_flow.FlowProfile(ju.atoms, n_bins=n_bins, verbose=False))
    out = _run(flow.FlowProfile(tu.atoms, n_bins=n_bins, verbose=False,
                                device="cpu"))
    np.testing.assert_array_equal(out.results.counts, ref.results.counts)
    want = oracle_sums(pos, np.ones_like(pos), np.ones(n), [length], 2,
                       n_bins, 12.3)["n"]
    np.testing.assert_array_equal(out.results.counts, want)


def test_npt_frames_wrap_with_their_own_box(system):
    pos, vel, _, masses = system
    lengths = BOX[2] * (1 + 0.02 * np.sin(np.arange(T)))
    dims = np.tile(np.concatenate([BOX, [90.0] * 3]), (T, 1))
    dims[:, 2] = lengths
    ju = JaxUniverse.from_arrays(pos.astype(np.float64), dims, dt=0.5,
                                 velocities=vel.astype(np.float64),
                                 masses=masses)
    tu = Universe.from_arrays(pos, dims, dt=0.5, velocities=vel,
                              masses=masses)
    ref = _run(jax_flow.FlowProfile(ju.atoms, n_bins=N_BINS, verbose=False))
    out = _run(flow.FlowProfile(tu.atoms, n_bins=N_BINS, verbose=False,
                                device="cpu"))
    np.testing.assert_array_equal(out.results.counts, ref.results.counts)
    want = oracle_sums(pos, vel, masses, lengths, 2, N_BINS, lengths[0])
    _assert_oracle(out, want)


def test_trr_route_equals_array_route(tmp_path, system):
    """The positions+velocities payload from a TRR (float32 sections in nm
    and nm/ps, scaled by 10 on reading) equals the ArrayReader route on the
    data the TRR reader returns, both streamed as float32."""

    from mdhelper_tpu_torch.core.trajectory import TRRReader
    from mdhelper_tpu_torch.core.universe import Topology
    from mdhelper_tpu_torch.io.trr import write_trr

    pos, vel, dims, masses = system
    path = str(tmp_path / "flow.trr")
    write_trr(path, pos / 10.0, np.diag(BOX / 10.0),
              velocities=vel / 10.0, dt=0.5)
    reader = TRRReader(path)
    frames = np.arange(T)
    p, v, d = reader.read_frames_with_velocities(frames)
    trr_u = Universe(Topology(N, masses=masses), reader)
    arr_u = Universe.from_arrays(p, d, dt=0.5, velocities=v, masses=masses)
    a = _run(flow.FlowProfile(trr_u.atoms, n_bins=N_BINS, verbose=False,
                              device="cpu"))
    b = _run(flow.FlowProfile(arr_u.atoms, n_bins=N_BINS, verbose=False,
                              device="cpu"))
    for key in ("counts", "velocity", "temperature", "mass_density"):
        np.testing.assert_array_equal(a.results[key], b.results[key])
    np.testing.assert_allclose(v, vel, rtol=1e-6, atol=1e-6)


def test_validation(universes, system):
    _, tu = universes
    pos, vel, dims, masses = system
    bare = Universe.from_arrays(pos, dims, masses=masses)
    with pytest.raises(ValueError, match="velocities"):
        flow.FlowProfile(bare.atoms, device="cpu")
    with pytest.raises(ValueError, match="Empty"):
        flow.FlowProfile(tu.atoms[:0], device="cpu")
    tri = Universe.from_arrays(pos, [12.0] * 3 + [80.0, 90.0, 90.0],
                               velocities=vel, masses=masses)
    with pytest.raises(ValueError, match="orthorhombic"):
        flow.FlowProfile(tri.atoms, device="cpu")
    with pytest.raises(ValueError, match="axis"):
        flow.FlowProfile(tu.atoms, axis="w", device="cpu")
    with pytest.raises(ValueError, match="n_bins"):
        flow.FlowProfile(tu.atoms, n_bins=0, device="cpu")
    # parallel=True is taken (ROADMAP Queue 1, item 10b-1)
    assert flow.FlowProfile(tu.atoms, parallel=True, device="cpu")._parallel
    with pytest.raises(RuntimeError, match="run"):
        flow.FlowProfile(tu.atoms, device="cpu").calculate_shear_rate()
    no_box = Universe.from_arrays(pos, None, velocities=vel, masses=masses)
    with pytest.raises(ValueError, match="periodic box"):
        flow.FlowProfile(no_box.atoms, device="cpu")
