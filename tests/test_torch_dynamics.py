"""The port's velocity dynamics against the JAX package's.

The same seeded float32 trajectory (positions on a wrapped random walk,
velocities an AR(1) series, so the ACFs decay over a few frames) goes
through ``mdhelper_tpu.analysis.dynamics`` (streaming float32:
``_coord_dtype`` on its base class, on the CPU) and its port
(``device="cpu"``), in chunks of 4 frames of 18 (a short last chunk), on
the whole universe and on subsets.

* ``VelocityAutocorrelation``: both correlate the same float32 velocities
  in float64; the ACF and the VDOS agree within ``rtol=1e-10`` with the
  JAX class and with a numpy float64 oracle.
* ``ElectricCurrentAutocorrelation``: the port sums the current
  ``sum_i q_i v_i`` in float64 and equals a numpy float64 oracle within
  ``rtol=1e-10``; the JAX class sums it in float32, where the +-1 charges
  cancel (the current is about sqrt(N) |v|, each float32 partial sum up
  to N |v|), so its current is off by up to ~1e-5 of the current's scale,
  and the test holds the two within ``CURRENT_RTOL`` of it.
* ``SurvivalProbability``: memberships and per-frame counts equal the JAX
  package's as integers (slab, sphere and shell zones; orthorhombic and
  triclinic boxes; straddle fixtures one float32 ulp either side of the
  slab bounds and of the shell radius, and 20,000 points within a few
  1e-7 of a sphere's radius, where the squared norm must be formed with
  XLA's fused multiply-adds), and the lifetime functions of the same
  series agree within 1e-12.
* ``OverlapFunction``: each frame's Q is the float32 count over N rounded
  as ``jnp.mean`` rounds it (a product by the float32 1/N), so Q and chi4
  equal the JAX package's bit for bit in an orthorhombic box (atoms and
  residue centers, dense and log lags); in a triclinic cell the JAX fold
  takes two float32 matrix products that round otherwise (ROADMAP Queue
  3, item 12), and Q stays within one overlap in N of it.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu import Q_ as JQ  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import dynamics as jax_dynamics  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.analysis import dynamics  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N, T, CHUNK, BOX = 240, 18, 4, 11.0
TRICLINIC = [BOX] * 3 + [80.0, 75.0, 70.0]
CURRENT_RTOL = 1e-4


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


def velocity_frames(rng, n_frames, n_atoms, rho=0.7):
    """float32 AR(1) velocities: v_t = rho v_{t-1} + sqrt(1 - rho^2) xi."""

    v = np.empty((n_frames, n_atoms, 3))
    v[0] = rng.standard_normal((n_atoms, 3))
    for t in range(1, n_frames):
        v[t] = rho * v[t - 1] + np.sqrt(1 - rho * rho) * rng.standard_normal(
            (n_atoms, 3))
    return (2.0 * v).astype(np.float32)


def _system(seed=7, n_frames=T, dims=None, step=0.3):
    rng = np.random.default_rng(seed)
    steps = rng.normal(0.0, step, (n_frames, N, 3))
    steps[0] = rng.random((N, 3)) * BOX
    pos = np.mod(np.cumsum(steps, axis=0), BOX).astype(np.float32)
    vel = velocity_frames(rng, n_frames, N)
    topology = dict(
        masses=rng.uniform(1.0, 20.0, N),
        charges=np.tile([1.0, -1.0], N // 2),
        resindices=np.repeat(np.arange(N // 4), 4),
    )
    dims = np.array([BOX] * 3 + [90.0] * 3) if dims is None else dims
    return pos, vel, dims, topology


def _pair(pos, vel, dims, topology, dt=0.5):
    ju = JaxUniverse.from_arrays(pos.astype(np.float64), dims, dt=dt,
                                 velocities=vel.astype(np.float64),
                                 **topology)
    tu = Universe.from_arrays(pos, dims, dt=dt, velocities=vel, **topology)
    return ju, tu


@pytest.fixture(scope="module")
def system():
    return _system()


@pytest.fixture(scope="module")
def universes(system):
    return _pair(*system)


def _chunked(a, width=3):
    a._chunk_bytes = CHUNK * len(a._atom_indices) * width * 4
    return a


def _run(a):
    return _chunked(a).run()


def _oracle_per_atom_acf(v):
    """float64 triangular-normalized per-atom vector ACFs ``(T, N)``."""

    v = v.astype(np.float64)
    n_t = len(v)
    return np.stack([(v[:n_t - t] * v[t:]).sum(-1).sum(0) / (n_t - t)
                     for t in range(n_t)])


SUBSETS = {"atoms": slice(None), "subset": slice(3, 200, 2)}


@pytest.mark.parametrize("subset", list(SUBSETS))
@pytest.mark.parametrize("n_blocks", [1, 4])
def test_vacf_matches_jax_and_oracle(universes, system, subset, n_blocks):
    ju, tu = universes
    sel = SUBSETS[subset]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = _run(jax_dynamics.VelocityAutocorrelation(
            ju.atoms[sel], n_blocks=n_blocks, verbose=False))
        out = _run(dynamics.VelocityAutocorrelation(
            tu.atoms[sel], n_blocks=n_blocks, verbose=False, device="cpu"))
    for key in ("vacf", "acf", "times", "vdos", "frequencies"):
        np.testing.assert_allclose(out.results[key], ref.results[key],
                                   rtol=1e-10, atol=1e-12, err_msg=key)
    v = system[1][:, np.arange(N)[sel]]
    per_block = T // n_blocks
    per_atom = np.mean([_oracle_per_atom_acf(v[b * per_block:(b + 1)
                                                * per_block])
                        for b in range(n_blocks)], axis=0)
    np.testing.assert_allclose(out.results.vacf, per_atom.mean(1),
                               rtol=1e-10)
    masses = system[3]["masses"][np.arange(N)[sel]]
    half = per_atom @ masses
    half[0] *= 0.5
    np.testing.assert_allclose(out.results.vdos,
                               2 * 0.5 * np.fft.rfft(half).real, rtol=1e-10,
                               atol=1e-9)
    assert set(out.results.units) == set(ref.results.units)


def test_vacf_blocks_warn_and_store_on_device(universes):
    _, tu = universes
    vacf = dynamics.VelocityAutocorrelation(tu.atoms, n_blocks=4,
                                            verbose=False, device="cpu")
    with pytest.warns(UserWarning, match="last 2 frame"):
        _run(vacf)
    assert vacf._store.dtype == torch.float64
    assert tuple(vacf._store.shape) == (T, N, 3)
    # atom blocks of the correlation: one atom a block gives the same ACF
    vacf._chunk_bytes = 1
    np.testing.assert_allclose(vacf._per_atom_acf(T // 4).mean(1).numpy(),
                               vacf.results.vacf, rtol=1e-13)


def _current_oracle(vel, charges):
    return np.einsum("n,bnd->bd", charges, vel.astype(np.float64))


@pytest.mark.parametrize("subset", list(SUBSETS))
@pytest.mark.parametrize("n_blocks", [1, 3])
def test_current_acf_matches_oracle_and_jax(universes, system, subset,
                                            n_blocks):
    ju, tu = universes
    sel = SUBSETS[subset]
    ref = _run(jax_dynamics.ElectricCurrentAutocorrelation(
        ju.atoms[sel], 300.0, n_blocks=n_blocks, verbose=False))
    out = _run(dynamics.ElectricCurrentAutocorrelation(
        tu.atoms[sel], 300.0, n_blocks=n_blocks, verbose=False,
        device="cpu"))
    idx = np.arange(N)[sel]
    current = _current_oracle(system[1][:, idx], system[3]["charges"][idx])
    np.testing.assert_allclose(out.results.current, current, rtol=1e-10,
                               atol=1e-12)
    scale = np.abs(current).max()
    np.testing.assert_allclose(out.results.current, ref.results.current,
                               rtol=0, atol=CURRENT_RTOL * scale)
    for key in ("acf", "running_conductivity"):
        np.testing.assert_allclose(
            out.results[key], ref.results[key], rtol=0,
            atol=CURRENT_RTOL * np.abs(ref.results[key]).max(), err_msg=key)
    np.testing.assert_allclose(out.results.conductivity,
                               ref.results.conductivity,
                               rtol=CURRENT_RTOL * 10)
    np.testing.assert_allclose(out.results.times, ref.results.times)
    # the float64 oracle's Green-Kubo integral through the port's function
    from mdhelper_tpu_torch.analysis.thermodynamics import (
        calculate_ionic_conductivity,
    )

    per_block = T // n_blocks
    want = np.mean([calculate_ionic_conductivity(
        current[b * per_block:(b + 1) * per_block], BOX**3, 300.0, 0.5,
        device="cpu").conductivity for b in range(n_blocks)])
    np.testing.assert_allclose(out.results.conductivity, want, rtol=1e-10)
    assert {k: str(v) for k, v in out.results.units.items()} == {
        k: str(v) for k, v in ref.results.units.items()}


def test_current_acf_reduced_and_charges(universes):
    ju, tu = universes
    charges = np.linspace(-1.0, 1.0, N)
    ref = _run(jax_dynamics.ElectricCurrentAutocorrelation(
        ju.atoms, 1.5, charges=charges, reduced=True, verbose=False))
    out = _run(dynamics.ElectricCurrentAutocorrelation(
        tu.atoms, 1.5, charges=charges, reduced=True, verbose=False,
        device="cpu"))
    assert "units" not in out.results and "units" not in ref.results
    scale = np.abs(ref.results.current).max()
    np.testing.assert_allclose(out.results.current, ref.results.current,
                               rtol=0, atol=CURRENT_RTOL * scale)
    q = _run(dynamics.ElectricCurrentAutocorrelation(
        tu.atoms, Q_(300.0, "K"), charges=Q_(charges, "e"), verbose=False,
        device="cpu"))
    p = _run(dynamics.ElectricCurrentAutocorrelation(
        tu.atoms, 300.0, charges=charges, verbose=False, device="cpu"))
    np.testing.assert_array_equal(q.results.acf, p.results.acf)


def _membership_pair(ju, tu, group_sel, zone_of, **kwargs):
    jz = zone_of(ju)
    tz = zone_of(tu)
    ref = _run(jax_dynamics.SurvivalProbability(
        ju.atoms[group_sel], jz, verbose=False, **kwargs))
    out = _run(dynamics.SurvivalProbability(
        tu.atoms[group_sel], tz, verbose=False, device="cpu", **kwargs))
    return ref, out


ZONES = {
    "slab": lambda u: ("slab", "z", 2.5, 7.25),
    "slab_x": lambda u: ("slab", "x", 0.0, 5.0),
    "sphere": lambda u: ("sphere", [1.0, 10.5, 5.5], 4.0),
    "shell": lambda u: ("shell", u.atoms[1::4], 1.6),
}


# (zone, box); slab zones need an orthorhombic cell (test_validation)
ZONE_BOXES = [(zone, "ortho") for zone in ZONES] + [
    ("sphere", "triclinic"), ("shell", "triclinic")]


@pytest.mark.parametrize("zone,box", ZONE_BOXES)
@pytest.mark.parametrize("subset", list(SUBSETS))
def test_survival_matches_jax(system, zone, box, subset):
    pos, vel, dims, topology = system
    if box == "triclinic":
        dims = np.asarray(TRICLINIC)
    ju, tu = _pair(pos, vel, dims, topology)
    ref, out = _membership_pair(ju, tu, SUBSETS[subset], ZONES[zone])
    np.testing.assert_array_equal(out._membership, ref._membership)
    np.testing.assert_array_equal(out.results.n_in_zone,
                                  ref.results.n_in_zone)
    assert 0 < out.results.n_in_zone.sum() < out._membership.size
    for key in ("intermittent", "survival", "times"):
        np.testing.assert_allclose(out.results[key], ref.results[key],
                                   rtol=1e-12, atol=1e-12, err_msg=key)


def test_survival_straddles_match_jax_and_f64():
    """Coordinates one float32 ulp either side of the slab bounds, and
    partners one ulp either side of the shell radius (along x from the
    origin, exact in float32), count as a float64 test of the float32
    inputs says and as the JAX package counts them."""

    lo, hi, r = np.float32(2.5), np.float32(7.25), np.float32(1.5)
    z = []
    for edge in (lo, hi):
        z += [np.nextafter(edge, np.float32(-1)), edge,
              np.nextafter(edge, np.float32(20))]
    n_g = len(z)
    pos = np.zeros((2, 2 * n_g, 3), np.float32)
    pos[:, :n_g, 1] = np.arange(n_g) * 1.6 + 0.5
    pos[:, :n_g, 2] = z
    # shell partners at r - ulp, r, r + ulp along x
    gaps = [np.nextafter(r, np.float32(0)), r, np.nextafter(r, np.float32(9))]
    for i in range(n_g):
        pos[:, n_g + i] = pos[:, i]
        pos[:, n_g + i, 0] = gaps[i % 3]
    dims = np.array([BOX] * 3 + [90.0] * 3)
    vel = np.zeros_like(pos)
    ju, tu = _pair(pos, vel, dims, {})
    sel = slice(0, n_g)
    for zone_of, want in (
            (lambda u: ("slab", "z", 2.5, 7.25),
             (np.asarray(z, np.float64) >= 2.5)
             & (np.asarray(z, np.float64) < 7.25)),
            (lambda u: ("shell", u.atoms[n_g:], 1.5),
             np.array([np.float64(g) <= 1.5 for g in gaps] * 2))):
        ref, out = _membership_pair(ju, tu, sel, zone_of)
        np.testing.assert_array_equal(out._membership, ref._membership)
        np.testing.assert_array_equal(out._membership[0], want)
        assert 0 < want.sum() < len(want)


def test_survival_near_radius_norms_fuse_as_xla():
    """20,000 points within a few 1e-7 of a sphere's radius in random
    directions: XLA's CPU backend forms the squared norm with fused
    multiply-adds, which decides a few hundred of them otherwise than the
    separately rounded sum; the port's memberships equal the JAX
    package's."""

    rng = np.random.default_rng(1)
    n = 20_000
    center = np.array([5.0, 5.0, 5.0], np.float32)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (center + d * (1.7 * (1 + rng.normal(0.0, 3e-7, (n, 1))))
           ).astype(np.float32)
    ju, tu = _pair(np.stack([pts, pts]), np.zeros((2, n, 3), np.float32),
                   np.array([11.0] * 3 + [90.0] * 3), {})
    ref, out = _membership_pair(ju, tu, slice(None),
                                lambda u: ("sphere", center, 1.7))
    np.testing.assert_array_equal(out._membership, ref._membership)
    # the separately rounded sum, (x^2 + y^2) + z^2 in float32
    d32 = pts - center
    plain = ((d32[:, 0] * d32[:, 0] + d32[:, 1] * d32[:, 1])
             + d32[:, 2] * d32[:, 2]) <= np.float32(1.7 * 1.7)
    assert np.sum(plain != ref._membership[0]) > 50


def test_survival_quantities_and_units(universes):
    _, tu = universes
    a = _run(dynamics.SurvivalProbability(
        tu.atoms, ("sphere", Q_(np.array([1.0, 10.5, 5.5]), "angstrom"),
                   Q_(0.4, "nm")), verbose=False, device="cpu"))
    b = _run(dynamics.SurvivalProbability(
        tu.atoms, ("sphere", [1.0, 10.5, 5.5], 4.0), verbose=False,
        device="cpu"))
    np.testing.assert_array_equal(a._membership, b._membership)
    assert str(b.results.units["results.times"]) == "picosecond"
    c = _run(dynamics.SurvivalProbability(
        tu.atoms, ("slab", "z", 2.0, 6.0), reduced=True, verbose=False,
        device="cpu"))
    assert "units" not in c.results
    assert c._coord_axes == [2]


def _overlap_oracle(pos, box, a, lags):
    """float64 counts of the float32 minimum-image displacements' lengths
    below `a` (orthorhombic), Q as float32(count) * float32(1/N)."""

    n_t, n = pos.shape[:2]
    inv_n = np.float32(1.0) / np.float32(n)
    q1 = np.zeros(len(lags))
    q2 = np.zeros(len(lags))
    origins = np.zeros(len(lags))
    for t in range(n_t):
        for k, lag in enumerate(lags):
            if lag > t:
                continue
            d = pos[t] - pos[t - lag]
            d = d - np.float32(box) * np.round(d / np.float32(box))
            r = np.sqrt((d.astype(np.float64) ** 2).sum(-1))
            q = np.float64(np.float32(np.float32((r < a).sum()) * inv_n))
            q1[k] += q
            q2[k] += q * q
            origins[k] += 1
    return q1 / origins, n * (q2 / origins - (q1 / origins) ** 2)


OVERLAP_CASES = {
    "atoms": dict(a=0.45),
    "residues": dict(a=0.3, grouping="residues"),
    "log": dict(a=0.45, lags="log", n_lags=14),
    "explicit": dict(a=Q_(0.05, "nm"), lags=[0, 1, 5, 9], n_lags=12),
}


@pytest.mark.parametrize("case", list(OVERLAP_CASES))
def test_overlap_matches_jax_bit_for_bit(universes, system, case):
    ju, tu = universes
    kwargs = dict(OVERLAP_CASES[case])
    jkw = dict(kwargs)
    if isinstance(kwargs["a"], type(Q_(1.0, "nm"))):
        jkw["a"] = JQ(0.05, "nm")
    ref = _run(jax_dynamics.OverlapFunction(ju.atoms, verbose=False, **jkw))
    out = _run(dynamics.OverlapFunction(tu.atoms, verbose=False,
                                        device="cpu", **kwargs))
    for key in ("Q", "chi4", "origins", "times"):
        np.testing.assert_array_equal(out.results[key], ref.results[key],
                                      err_msg=key)
    if case == "atoms":
        q, chi4 = _overlap_oracle(system[0], BOX, 0.45, np.arange(T))
        np.testing.assert_array_equal(out.results.Q, q)
        np.testing.assert_allclose(out.results.chi4, chi4, rtol=1e-12,
                                   atol=1e-12)
        assert np.all(out.results.Q[0] == 1.0) and 0 < out.results.Q[-1] < 1


def test_overlap_triclinic_and_subset(system):
    pos, vel, _, topology = system
    ju, tu = _pair(pos, vel, np.asarray(TRICLINIC), topology)
    ref = _run(jax_dynamics.OverlapFunction(ju.atoms[::3], 0.45,
                                            verbose=False))
    out = _run(dynamics.OverlapFunction(tu.atoms[::3], 0.45, verbose=False,
                                        device="cpu"))
    n = len(tu.atoms[::3])
    np.testing.assert_allclose(out.results.Q, ref.results.Q, rtol=0,
                               atol=1.01 / n)
    np.testing.assert_array_equal(out.results.origins, ref.results.origins)


def test_overlap_dt_quantity(universes):
    """A scalar Quantity dt is taken (the JAX class raises, ROADMAP Queue 3
    item 9)."""

    ju, tu = universes
    out = _run(dynamics.OverlapFunction(tu.atoms, 0.45, dt=Q_(2.0, "fs"),
                                        verbose=False, device="cpu"))
    np.testing.assert_allclose(out.results.times, np.arange(T) * 0.002)
    with pytest.raises(TypeError):
        jax_dynamics.OverlapFunction(ju.atoms, 0.45, dt=JQ(2.0, "fs"),
                                     verbose=False)


def test_velocity_pass_fuses_and_mixed_payloads_raise(universes):
    _, tu = universes
    make = [
        lambda: dynamics.VelocityAutocorrelation(tu.atoms, verbose=False,
                                                 device="cpu"),
        lambda: dynamics.ElectricCurrentAutocorrelation(
            tu.atoms[::2], 300.0, verbose=False, device="cpu"),
    ]
    fused = run_together([_chunked(m()) for m in make])
    for a, m in zip(fused, make):
        alone = _run(m())
        for key in ("acf", "times"):
            np.testing.assert_array_equal(a.results[key], alone.results[key])
    with pytest.raises(ValueError, match="same coordinate payload"):
        run_together([make[0](), dynamics.OverlapFunction(
            tu.atoms, 0.45, verbose=False, device="cpu")])


def test_validation(universes, system):
    ju, tu = universes
    pos, _, dims, topology = system
    bare = Universe.from_arrays(pos, dims, **topology)
    for cls, args in ((dynamics.VelocityAutocorrelation, ()),
                      (dynamics.ElectricCurrentAutocorrelation, (300.0,))):
        with pytest.raises(ValueError, match="no velocities"):
            cls(bare.atoms, *args, device="cpu")
        with pytest.raises(ValueError, match="n_blocks"):
            cls(tu.atoms, *args, n_blocks=0, device="cpu")
        # parallel=True is taken (ROADMAP Queue 1, item 10b-1)
        assert cls(tu.atoms, *args, parallel=True, device="cpu")._parallel
    with pytest.raises(ValueError, match="Too few frames"):
        _run(dynamics.VelocityAutocorrelation(tu.atoms, n_blocks=10,
                                              verbose=False, device="cpu"))
    with pytest.raises(ValueError, match="one value per atom"):
        dynamics.ElectricCurrentAutocorrelation(tu.atoms, 300.0,
                                                charges=[1.0], device="cpu")
    with pytest.warns(UserWarning, match="All charges are zero"):
        dynamics.ElectricCurrentAutocorrelation(
            tu.atoms, 300.0, charges=np.zeros(N), device="cpu")
    tri = Universe.from_arrays(pos, np.asarray(TRICLINIC), **topology)
    for zone, match in (
            (("slab", "z", 1.0, 2.0), "orthorhombic"),
            (("slab", "w", 1.0, 2.0), "Slab axis"),
            (("slab", "z", 2.0, 1.0), "lo < hi"),
            (("sphere", [1.0, 2.0], 1.0), "shape"),
            (("sphere", [1.0, 2.0, 3.0], -1.0), "positive"),
            (("shell", [1, 2], 1.0), "AtomGroup"),
            (("shell", tu.atoms, 0.0), "positive"),
            (("cube", 1.0), "Unknown zone"),
            ((), "zone must be")):
        u = tri if match == "orthorhombic" else tu
        with pytest.raises(ValueError, match=match):
            dynamics.SurvivalProbability(u.atoms, zone, device="cpu")
    assert dynamics.SurvivalProbability(tu.atoms, ("slab", "z", 1.0, 2.0),
                                        parallel=True, device="cpu")._parallel
    with pytest.raises(ValueError, match="'a' must be positive"):
        dynamics.OverlapFunction(tu.atoms, -1.0, device="cpu")
    with pytest.raises(ValueError, match="grouping"):
        dynamics.OverlapFunction(tu.atoms, grouping="molecules",
                                 device="cpu")
    with pytest.raises(ValueError, match="periodic box"):
        dynamics.OverlapFunction(
            Universe.from_arrays(pos, None, **topology).atoms,
            device="cpu")
    with pytest.raises(ValueError, match="evenly spaced"):
        dynamics.OverlapFunction(tu.atoms, verbose=False,
                                 device="cpu").run(frames=[0, 1, 3])
