"""The port's mesh (Kaiser-Bessel NUFFT) S(q) route against the JAX
package's.

``mdhelper_tpu_torch.ops.mesh_scattering`` spreads each atom over its
window's support with ``index_add_`` (on the CPU here), and
``mesh_trig_sums_plain`` forms the grid by the JAX package's dense chain
in a fixed order.  Tolerances, with their reasons:

* against a float64 oracle of the sums, the JAX test's bounds
  (``tests/test_mesh_scattering.py``): median error / sqrt(N) below 1e-5,
  largest below 1e-4, and rho(0) the sum of the weights exactly;
* against the JAX function, and the scatter route against the in-order
  one, within ``1e-5 sqrt(N)``: the windows' ``i0`` (XLA's against
  torch's) and the grids' summation orders differ by float32 roundings;
* ``StructureFactor(method="mesh")`` against the JAX class within the
  S(q) gate (``rtol=1e-4, atol=1e-5``), and against the port's direct
  sums within the JAX package's mesh-vs-direct gate (``rtol=5e-4,
  atol=1e-5``); the ISF's mesh route against the JAX class's within the
  S(q) gate.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = jax.numpy
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import structure as jax_structure  # noqa: E402
from mdhelper_tpu.analysis.multi import run_together as jax_run_together  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu.ops import mesh_scattering as jax_mesh  # noqa: E402

from mdhelper_tpu_torch.analysis import structure  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import mesh_scattering  # noqa: E402

GATE = dict(rtol=1e-4, atol=1e-5)
MESH_GATE = dict(rtol=5e-4, atol=1e-5)
N_ATOMS, N_FRAMES, CHUNK, N_POINTS = 900, 6, 2, 6
BOX = 16.0


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


def _plan_kwargs(n_points, box):
    plan = mesh_scattering.mesh_plan(n_points, [box] * 3)
    return dict(n_points=n_points, mesh=plan["mesh"], width=plan["width"],
                beta=plan["beta"], box=plan["box"], deconv=plan["deconv"])


def _oracle(pos, box, n_points, weights=None):
    """float64 (cos, sin) sums of every grid wavevector, C order."""

    k = np.arange(n_points)
    nn = np.stack(np.meshgrid(k, k, k, indexing="ij"), -1).reshape(-1, 3)
    phase = (2 * np.pi * nn / box) @ pos.astype(np.float64).T
    w = np.ones(len(pos)) if weights is None else weights.astype(np.float64)
    return (np.cos(phase) * w).sum(1), (np.sin(phase) * w).sum(1)


ROUTES = {"scatter": mesh_scattering.mesh_trig_sums,
          "in-order": mesh_scattering.mesh_trig_sums_plain}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("weighted", [False, True])
def test_mesh_sums_match_f64_oracle(route, weighted):
    rng = np.random.default_rng(13)
    n, box, n_points = 1500, 20.0, 10
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32) if weighted else None
    cos, sin = ROUTES[route](
        torch.from_numpy(pos), **_plan_kwargs(n_points, box),
        weights=None if w is None else torch.from_numpy(w))
    assert cos.shape == sin.shape == (n_points,) * 3
    assert cos.dtype == torch.float32
    c = cos.double().numpy().reshape(-1)
    s = sin.double().numpy().reshape(-1)
    oc, os_ = _oracle(pos, box, n_points, w)
    err = np.hypot(c - oc, s - os_)
    assert np.median(err[1:]) / np.sqrt(n) < 1e-5
    assert err[1:].max() / np.sqrt(n) < 1e-4
    # rho(0) is set to the sum of the weights.
    total = n if w is None else torch.from_numpy(w).sum().item()
    assert c[0] == total and s[0] == 0.0
    if w is not None:
        assert np.isclose(c[0], w.astype(np.float64).sum(), rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_mesh_sums_match_jax(weighted):
    """Both routes against the JAX function, and the scatter route against
    the in-order one, within 1e-5 sqrt(N); positions outside the box and
    negative ones wrap as in the JAX function."""

    rng = np.random.default_rng(5)
    n, box, n_points = 800, 14.0, 6
    pos = ((rng.random((n, 3)) * 3 - 1) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32) if weighted else None
    kwargs = _plan_kwargs(n_points, box)
    jc, js = jax_mesh.mesh_trig_sums(
        jnp.asarray(pos), weights=None if w is None else jnp.asarray(w),
        atom_chunk=256, **kwargs)
    tol = 1e-5 * np.sqrt(n)
    got = {}
    for route, fn in ROUTES.items():
        c, s = fn(torch.from_numpy(pos),
                  weights=None if w is None else torch.from_numpy(w),
                  **kwargs)
        got[route] = (c.numpy(), s.numpy())
        assert np.abs(got[route][0] - np.asarray(jc)).max() < tol
        assert np.abs(got[route][1] - np.asarray(js)).max() < tol
    for a, b in zip(got["scatter"], got["in-order"]):
        assert np.abs(a - b).max() < tol


def test_mesh_batch_equals_frames():
    """A batch of frames gives each frame's sums, bit for bit on the CPU
    (each frame's adds keep their order)."""

    rng = np.random.default_rng(6)
    frames = torch.from_numpy((rng.random((3, 400, 3)) * 12.0).astype(
        np.float32))
    w = torch.from_numpy(rng.random((3, 400)).astype(np.float32))
    kwargs = _plan_kwargs(5, 12.0)
    for route, fn in ROUTES.items():
        bc, bs = fn(frames, weights=w, **kwargs)
        assert bc.shape == (3, 5, 5, 5)
        for f in range(3):
            c, s = fn(frames[f], weights=w[f], **kwargs)
            assert torch.equal(bc[f], c) and torch.equal(bs[f], s), route


def test_mesh_plan_is_the_jax_plan():
    for n_points, box in ((6, [14.0] * 3), (24, [50.0, 51.0, 52.0])):
        ours = mesh_scattering.mesh_plan(n_points, box)
        ref = jax_mesh.mesh_plan(n_points, box)
        assert ours.keys() == ref.keys()
        for key in ours:
            np.testing.assert_array_equal(ours[key], ref[key])


@pytest.fixture(scope="module")
def trajectory():
    rng = np.random.default_rng(2031)
    walk = rng.random((N_ATOMS, 3)) * BOX + np.cumsum(
        rng.normal(0.0, 0.3, (N_FRAMES, N_ATOMS, 3)), axis=0)
    return np.mod(walk, BOX).astype(np.float32)


@pytest.fixture(scope="module")
def universes(trajectory):
    """3-atom residues of masses 16, 1, 1, in the cube."""

    dims = np.array([BOX] * 3 + [90.0] * 3)
    topology = dict(resindices=np.repeat(np.arange(N_ATOMS // 3), 3),
                    masses=np.tile([16.0, 1.0, 1.0], N_ATOMS // 3))
    return (
        JaxUniverse.from_arrays(trajectory.astype(np.float64), dims, dt=1.0,
                                **topology),
        Universe.from_arrays(trajectory, dims, dt=1.0, **topology),
    )


def _chunked(analyses, n=N_ATOMS):
    for a in analyses:
        a._chunk_bytes = CHUNK * n * 3 * 4
    return analyses


def _run_jax(analyses, **kwargs):
    return jax_run_together(_chunked(analyses), **kwargs)


def _run(analyses, **kwargs):
    return run_together(_chunked(analyses), **kwargs)


@pytest.mark.parametrize("groupings", ["atoms", "residues"])
@pytest.mark.parametrize("unique", [True, False])
def test_mesh_structure_factor_matches_jax(universes, groupings, unique):
    ju, tu = universes
    kwargs = dict(groupings=groupings, n_points=N_POINTS, unique=unique,
                  verbose=False)
    ref, = _run_jax([jax_structure.StructureFactor(ju.atoms, method="mesh",
                                                   **kwargs)])
    mesh, direct = _run([
        structure.StructureFactor(tu.atoms, method="mesh", device="cpu",
                                  **kwargs),
        structure.StructureFactor(tu.atoms, method="direct", device="cpu",
                                  **kwargs),
    ])
    np.testing.assert_array_equal(mesh.results.wavenumbers,
                                  ref.results.wavenumbers)
    np.testing.assert_allclose(mesh.results.ssf, ref.results.ssf, **GATE)
    np.testing.assert_allclose(mesh.results.ssf, direct.results.ssf,
                               **MESH_GATE)


def test_mesh_structure_factor_q_max_and_order(universes):
    """A q_max subset of the grid and the sorted, unique wavenumbers: the
    mesh indexes each wavevector's grid point."""

    ju, tu = universes
    kwargs = dict(n_points=N_POINTS, q_max=1.5, method="mesh",
                  verbose=False)
    ref, = _run_jax([jax_structure.StructureFactor(ju.atoms, **kwargs)])
    sf, = _run([structure.StructureFactor(tu.atoms, device="cpu",
                                          **kwargs)])
    assert sf.results.wavenumbers.max() <= 1.5
    np.testing.assert_array_equal(sf.results.wavenumbers,
                                  ref.results.wavenumbers)
    np.testing.assert_allclose(sf.results.ssf, ref.results.ssf, **GATE)


@pytest.mark.parametrize("options", [
    dict(incoherent=True, n_lags=4),
    dict(n_lags=4),
    dict(mode="partial", n_lags=3, incoherent=True),
])
def test_mesh_isf_matches_jax(universes, options):
    """The ISF's mesh route (each group's sums gridded, the self part's
    displacements too) against the JAX class's, on the ring and the time
    FFT."""

    ju, tu = universes
    j_groups = ((ju.atoms[0::2], ju.atoms[1::2])
                if options.get("mode") else ju.atoms)
    t_groups = ((tu.atoms[0::2], tu.atoms[1::2])
                if options.get("mode") else tu.atoms)
    kwargs = dict(n_points=N_POINTS, method="mesh", verbose=False,
                  **options)
    ref, = _run_jax([jax_structure.IntermediateScatteringFunction(
        j_groups, **kwargs)])
    isf, = _run([structure.IntermediateScatteringFunction(
        t_groups, device="cpu", **kwargs)])
    np.testing.assert_array_equal(isf.results.wavenumbers,
                                  ref.results.wavenumbers)
    np.testing.assert_allclose(isf.results.cisf, ref.results.cisf, **GATE)
    if options.get("incoherent"):
        np.testing.assert_allclose(isf.results.iisf, ref.results.iisf,
                                   **GATE)
        # F_s(q, 0) = 1 on the mesh too (the groups' rows sum to it).
        np.testing.assert_allclose(isf.results.iisf[0].sum(axis=0), 1.0,
                                   rtol=1e-5)


def _raises_like_jax(ju, tu, groups, **kwargs):
    """Both classes raise ValueError with the same message at run()."""

    with pytest.raises(ValueError) as ref:
        jax_structure.StructureFactor(groups(ju), verbose=False,
                                      **kwargs).run()
    with pytest.raises(ValueError) as ours:
        structure.StructureFactor(groups(tu), verbose=False, device="cpu",
                                  **kwargs).run()
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("case", ["surfaces", "off_grid", "negative",
                                  "two_groups", "pair_mode"])
def test_mesh_value_errors_match_jax(universes, case):
    ju, tu = universes
    atoms = (lambda u: u.atoms)
    halves = (lambda u: (u.atoms[0::2], u.atoms[1::2]))
    step = 2 * np.pi / BOX
    if case == "surfaces":
        _raises_like_jax(ju, tu, atoms, method="mesh", n_points=4,
                         n_surfaces=2)
    elif case == "off_grid":
        _raises_like_jax(ju, tu, atoms, method="mesh",
                         wavevectors=np.array([[1.3 * step, 0.0, 0.0]]))
    elif case == "negative":
        _raises_like_jax(ju, tu, atoms, method="mesh",
                         wavevectors=np.array([[-step, 0.0, 0.0],
                                               [step, step, 0.0]]))
    elif case == "two_groups":
        _raises_like_jax(ju, tu, halves, method="mesh", n_points=4,
                         mode="partial")
    else:
        _raises_like_jax(ju, tu, atoms, method="mesh", n_points=4,
                         mode="pair")


def test_mesh_resumes_from_jax_carry(universes):
    """JAX folds frames 0-3 on the mesh, the port takes its ssf carry over
    (carry_from_numpy) and folds frames 4-5: the carried sums equal a JAX
    run over all frames within the gate."""

    ju, tu = universes
    kwargs = dict(n_points=N_POINTS, method="mesh", sort=False,
                  unique=False, verbose=False)
    full, = _run_jax([jax_structure.StructureFactor(ju.atoms, **kwargs)])
    head, = _run_jax([jax_structure.StructureFactor(ju.atoms, **kwargs)],
                     stop=4)
    carry = jax.tree_util.tree_map(np.asarray, head._carry)
    sf, = _run([structure.StructureFactor(tu.atoms, device="cpu",
                                          **kwargs)],
               start=4, initial=[carry])
    np.testing.assert_allclose(
        sf._carry["ssf"].numpy(), np.asarray(full._carry["ssf"]),
        rtol=1e-4, atol=1e-5 * N_ATOMS * N_FRAMES)


def test_mesh_isf_resumes_from_jax_ring(universes):
    """The ISF's mesh ring resumes from the JAX class's carry (each run
    caps its ring at its own frame count: the ring holds one chunk)."""

    ju, tu = universes
    kwargs = dict(n_points=N_POINTS, method="mesh", n_lags=CHUNK,
                  incoherent=True, verbose=False)
    full, = _run_jax([jax_structure.IntermediateScatteringFunction(
        ju.atoms, **kwargs)])
    head, = _run_jax([jax_structure.IntermediateScatteringFunction(
        ju.atoms, **kwargs)], stop=CHUNK)
    isf, = _run([structure.IntermediateScatteringFunction(
        tu.atoms, device="cpu", **kwargs)], start=CHUNK,
        initial=[jax.tree_util.tree_map(np.asarray, head._carry)])
    np.testing.assert_allclose(isf.results.cisf, full.results.cisf, **GATE)
    np.testing.assert_allclose(isf.results.iisf, full.results.iisf, **GATE)
