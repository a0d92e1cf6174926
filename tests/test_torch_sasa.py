"""The port's Shrake-Rupley SASA against the JAX package's and float64
oracles.

The same seeded float32 coordinates go through
``mdhelper_tpu.analysis.sasa`` (streaming float32: ``_coord_dtype`` on its
base class, on the CPU) and its port (``device="cpu"``), in chunks of 2
frames.

* XLA's CPU backend forms the JAX class's point test ``|R_i s_p -
  r_ij|^2 < R_j^2`` with a fused multiply-add for ``R_i s_p - r_ij`` and
  the fused squared norm; the port forms them so
  (``ops/doublefloat.py::fma32``, ``ops/histogram.py::_norm2``), and its
  per-atom candidate and free-point counts equal the JAX class's: random
  liquids in a cube, a triclinic cell and without a box, a subset group,
  and a fixture of points placed on occluder surfaces (which the plain
  float32 form decides otherwise).  The float32 area ``w f R R`` XLA
  associates as its constants allow (``(w f)(R R)`` with distinct radii,
  ``w (f (R R))`` with equal ones); the port takes ``(w f)(R R)``, so
  areas agree within two float32 roundings.
* Against the float64 oracle of ``tests/test_analysis_sasa.py`` (all
  pairs, no budget): a free-point count may differ only by the points
  within a float32 margin of an occluding sphere (``|pd^2 - R_j^2| <=
  16 eps32 (R_i + |r_ij|)^2``), and the areas by those points' area.
* Analytic cases: an isolated atom has every point free (area ``4 pi
  R^2`` to float32 rounding), two spheres' caps, a buried atom, occlusion
  across the periodic boundary, the 27-image triclinic oracle.
* ``max_occluders``: a cluster that overflows K = 4 escalates to 8 and 16
  frame by frame (the overflow surfaces a chunk late, and the retry keeps
  no truncated chunk), and the retry count resets across runs.
* The reach warning, radii from names, types, dicts and arrays,
  validation errors, units and reduced units, ``parallel=True``.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import sasa as jax_sasa  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.algorithm.topology import (  # noqa: E402
    triclinic_matrices,
)
from mdhelper_tpu_torch.analysis import sasa  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

CHUNK = 2
EPS32 = float(np.finfo(np.float32).eps)
TRICLINIC = [13.0, 13.0, 13.0, 80.0, 95.0, 100.0]


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


def _universes(frames, dims, **topology):
    frames = np.asarray(frames, dtype=np.float32)
    topology.setdefault("types",
                        np.array(["A"] * frames.shape[1], dtype=object))
    return (JaxUniverse.from_arrays(frames.astype(np.float64), dims,
                                    **topology),
            Universe.from_arrays(frames, dims, **topology))


def _run(cls, group, **kwargs):
    a = cls(group, verbose=False, **kwargs)
    a._chunk_bytes = CHUNK * len(a._atom_indices) * 3 * 4
    return a.run()


def _pair(frames, dims, **kwargs):
    """``(JAX class, port)`` run on the same float32 frames."""

    topology = kwargs.pop("topology", {})
    ju, tu = _universes(frames, dims, **topology)
    select = kwargs.pop("select", slice(None))
    return (_run(jax_sasa.SolventAccessibleSurfaceArea, ju.atoms[select],
                 **kwargs),
            _run(sasa.SolventAccessibleSurfaceArea, tu.atoms[select],
                 device="cpu", **kwargs))


def _free_points(analysis):
    """Per-atom free-point counts from the float32 areas ``(w f)(R R)``."""

    r = analysis._inflated.astype(np.float32)
    weight = np.float32(4 * np.pi / analysis._n_points)
    return np.rint(analysis.results.areas.astype(np.float32)
                   / weight / (r * r)).astype(np.int64)


def assert_equal_sasa(ref, out):
    """Candidate and free-point counts equal; areas, the float32 product
    of those counts, within two float32 roundings (XLA associates ``w f R
    R`` as its constants allow)."""

    np.testing.assert_array_equal(out.results.n_neighbors,
                                  ref.results.n_neighbors)
    np.testing.assert_array_equal(_free_points(out), _free_points(ref))
    np.testing.assert_allclose(out.results.areas, ref.results.areas,
                               rtol=2 * EPS32, atol=0)
    np.testing.assert_allclose(out.results.total_areas,
                               ref.results.total_areas, rtol=2 * EPS32)


def _liquid(seed, n_frames, n, box):
    rng = np.random.default_rng(seed)
    pos = rng.random((n_frames, n, 3)) * box
    return pos.astype(np.float32), rng.uniform(1.0, 2.0, n)


def test_sphere_points_equal_jax():
    for n in (1, 7, 960):
        np.testing.assert_array_equal(sasa.sphere_points(n),
                                      jax_sasa.sphere_points(n))
    with pytest.raises(ValueError, match="positive"):
        sasa.sphere_points(0)


@pytest.mark.parametrize("box", ["cube", "triclinic", "none", "subset"])
def test_liquid_equals_jax(box):
    frames, radii = _liquid(2081, 5, 90, 13.0)
    kw = dict(probe_radius=1.4, n_points=120)
    if box == "triclinic":
        h = triclinic_matrices(np.asarray(TRICLINIC, float)[None])[0]
        frames = (np.random.default_rng(2083).random(frames.shape)
                  @ h).astype(np.float32)
        dims = np.asarray(TRICLINIC)
    elif box == "none":
        dims = None
    else:
        dims = np.array([13.0] * 3 + [90.0] * 3)
    if box == "subset":
        kw["select"] = slice(10, 70)
        radii = radii[10:70]
    ref, out = _pair(frames, dims, radii=radii, **kw)
    assert_equal_sasa(ref, out)
    assert out.results.n_neighbors.max() > 3
    assert out._active_budget == 89 if box != "subset" else 59


def _tie_fixture(seed=2087, n_points=60, n_pairs=240):
    """Atom pairs far apart, each occluder placed so that one test point
    of its partner lies on the occluder's inflated sphere (in exact
    arithmetic): the float32 test decides those points by its roundings."""

    rng = np.random.default_rng(seed)
    sphere = sasa.sphere_points(n_points)
    r_c, r_o = 1.70 + 1.4, 1.52 + 1.4
    pos = []
    for k in range(n_pairs):
        center = 20.0 * np.array([k % 8, k // 8 % 6, k // 48]) + 5.0
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        pos += [center, center + r_c * sphere[rng.integers(n_points)]
                - r_o * u]
    names = np.array(["C", "O"] * n_pairs, dtype=object)
    return np.array(pos, dtype=np.float32)[None], names


def test_points_on_occluder_surfaces_equal_jax():
    frames, names = _tie_fixture()
    dims = np.array([170.0, 130.0, 110.0, 90.0, 90.0, 90.0])
    ref, out = _pair(frames, dims, n_points=60,
                     topology=dict(names=names))
    assert_equal_sasa(ref, out)
    # the plain float32 form decides some of those points otherwise
    fused = sasa._point_distances2
    try:
        sasa._point_distances2 = lambda r, s, rel: (
            (r[:, None, None, None] * s[None, :, None, :]
             - rel[:, None, :, :]) ** 2).sum(-1)
        _, tu = _universes(frames, dims, names=names)
        other = _run(sasa.SolventAccessibleSurfaceArea, tu.atoms,
                     n_points=60, device="cpu")
    finally:
        sasa._point_distances2 = fused
    assert (_free_points(other) != _free_points(ref)).any()


def test_point_distances_equal_the_fused_ops():
    """``_point_distances2`` rounds as ``_norm2(fma32(R_i, s_p, -r_ij))``
    (and so as XLA's fused form), bit for bit."""

    from mdhelper_tpu_torch.ops.doublefloat import fma32
    from mdhelper_tpu_torch.ops.histogram import _norm2

    rng = np.random.default_rng(2113)
    r_i = torch.as_tensor(rng.uniform(2.0, 4.0, 30), dtype=torch.float32)
    sphere = torch.as_tensor(sasa.sphere_points(97), dtype=torch.float32)
    rel = torch.as_tensor(rng.normal(0.0, 3.0, (30, 11, 3)),
                          dtype=torch.float32)
    ref = _norm2(fma32(r_i[:, None, None, None], sphere[None, :, None, :],
                       -rel[:, None, :, :]))
    out = sasa._point_distances2(r_i, sphere, rel)
    assert out.dtype == torch.float32
    assert torch.equal(out, ref)


def _oracle(pos, box, radii, probe, n_points):
    """The float64 oracle of ``tests/test_analysis_sasa.py`` (all pairs,
    minimum image of an orthorhombic box, no budget), with the free
    counts and the points of each atom within a float32 margin of an
    occluder's sphere."""

    sphere = jax_sasa.sphere_points(n_points)
    inflated = np.asarray(radii, dtype=np.float64) + probe
    n = len(pos)
    free = np.empty(n, dtype=np.int64)
    near = np.empty(n, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    for i in range(n):
        delta = pos - pos[i]
        if box is not None:
            periodic = box > 0
            delta[:, periodic] -= box[periodic] * np.round(
                delta[:, periodic] / box[periodic])
        d2 = (delta**2).sum(axis=1)
        touch = inflated[i] + inflated
        cand = (d2 < touch**2) & (np.arange(n) != i)
        counts[i] = cand.sum()
        rel = delta[cand]
        rj2 = inflated[cand] ** 2
        q = inflated[i] * sphere
        dd = q[:, None, :] - rel[None, :, :]
        pd2 = (dd**2).sum(axis=-1)
        free[i] = int((~(pd2 < rj2[None, :]).any(axis=1)).sum())
        scale = (inflated[i] + np.sqrt((rel**2).sum(-1))) ** 2
        near[i] = int((np.abs(pd2 - rj2) <= 16 * EPS32 * scale).any(
            axis=1).sum())
    return free, near, counts, inflated


def test_liquid_within_float32_margin_of_f64_oracle():
    box = np.array([9.0, 10.0, 11.0])
    frames, radii = _liquid(2089, 3, 64, box)
    _, tu = _universes(frames, np.concatenate([box, [90.0] * 3]))
    out = _run(sasa.SolventAccessibleSurfaceArea, tu.atoms,
               probe_radius=1.4, n_points=240, radii=radii, device="cpu")
    r32 = out._inflated.astype(np.float32)
    weight = np.float32(4 * np.pi / 240)
    for f in range(3):
        free, near, counts, inflated = _oracle(
            frames[f].astype(np.float64), box, radii, 1.4, 240)
        np.testing.assert_array_equal(out.results.n_neighbors[f], counts)
        port_free = np.rint(out.results.areas[f].astype(np.float32)
                            / weight / (r32 * r32))
        assert (np.abs(port_free - free) <= near).all()
        expected = 4 * np.pi / 240 * free * inflated**2
        bound = 4 * np.pi / 240 * near * inflated**2 + 1e-6 * expected
        assert (np.abs(out.results.areas[f] - expected) <= bound).all()


def test_isolated_atom_full_sphere():
    ref, out = _pair(np.array([[[5.0, 5.0, 5.0]]]),
                     np.array([10.0] * 3 + [90.0] * 3), probe_radius=1.4,
                     n_points=128, radii=np.array([1.6]))
    assert_equal_sasa(ref, out)
    w, r = np.float32(4 * np.pi / 128), np.float32(3.0)
    assert out.results.areas[0, 0] == (w * np.float32(128)) * (r * r)
    np.testing.assert_allclose(out.results.areas[0, 0], 4 * np.pi * 9.0,
                               rtol=4 * EPS32)
    assert (out.results.n_neighbors == 0).all()


def test_two_spheres_analytic_cap():
    R, d = 2.0, 1.5
    _, tu = _universes(np.array([[[5.0, 5.0, 5.0], [5.0, 5.0, 5.0 + d]]]),
                       np.array([30.0] * 3 + [90.0] * 3))
    out = _run(sasa.SolventAccessibleSurfaceArea, tu.atoms,
               probe_radius=0.5, n_points=8192, radii=np.full(2, R - 0.5),
               device="cpu")
    expected = 4 * np.pi * R**2 * (1 + d / (2 * R)) / 2
    np.testing.assert_allclose(out.results.areas[0], expected, rtol=3e-3)
    assert (out.results.n_neighbors[0] == 1).all()


def test_buried_atom_zero_area():
    ref, out = _pair(np.array([[[5.0, 5.0, 5.0], [5.2, 5.0, 5.0]]]),
                     np.array([20.0] * 3 + [90.0] * 3), probe_radius=0.0,
                     n_points=256, radii=np.array([0.5, 5.0]))
    assert_equal_sasa(ref, out)
    assert out.results.areas[0, 0] == 0.0 and out.results.areas[0, 1] > 0


def test_occlusion_across_the_boundary():
    box = np.array([10.0] * 3 + [90.0] * 3)
    kw = dict(probe_radius=1.0, n_points=512, radii=np.array([1.5, 1.5]))
    wrapped = _pair(np.array([[[9.5, 5.0, 5.0], [1.7, 5.0, 5.0]]]), box,
                    **kw)
    free = _pair(np.array([[[5.0, 5.0, 5.0], [7.2, 5.0, 5.0]]]), box, **kw)
    for ref, out in (wrapped, free):
        assert_equal_sasa(ref, out)
    np.testing.assert_allclose(wrapped[1].results.areas,
                               free[1].results.areas, rtol=1e-6)
    assert (wrapped[1].results.areas < 4 * np.pi * 2.5**2 - 1e-3).all()


def test_zero_length_box_is_aperiodic():
    frames = np.array([[[0.0, 0.0, 0.0], [50.0, 0.0, 0.0]]])
    for dims in (None, np.zeros(6)):
        ref, out = _pair(frames, dims, probe_radius=1.4, n_points=128,
                         radii=np.array([1.5, 1.5]))
        assert_equal_sasa(ref, out)
        np.testing.assert_allclose(out.results.areas[0],
                                   4 * np.pi * 2.9**2, rtol=4 * EPS32)


def test_triclinic_equals_27_image_oracle():
    dims = np.array([12.0, 12.0, 12.0, 80.0, 95.0, 100.0])
    n = 40
    rng = np.random.default_rng(2099)
    h = triclinic_matrices(dims[None])[0]
    pos = (rng.random((n, 3)) @ h).astype(np.float32)
    radii = rng.uniform(1.2, 1.8, n)
    _, tu = _universes(pos[None], dims)
    out = _run(sasa.SolventAccessibleSurfaceArea, tu.atoms,
               probe_radius=1.0, n_points=200, radii=radii, device="cpu")
    shift = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                      for k in (-1, 0, 1)], dtype=np.float64) @ h
    all_pos = (pos.astype(np.float64)[None] + shift[:, None]).reshape(-1, 3)
    free, near, _, inflated = _oracle(all_pos, None, np.tile(radii, 27),
                                      1.0, 200)
    center = slice(13 * n, 14 * n)
    weight = 4 * np.pi / 200
    expected = weight * free[center] * inflated[center] ** 2
    bound = weight * near[center] * inflated[center] ** 2 + 1e-6 * expected
    assert (np.abs(out.results.areas[0] - expected) <= bound).all()


def _cluster_frames():
    """Five frames of 30 atoms 10 A apart (no candidates), but: frame 1
    crams 7 atoms into a 0.3 A knot (6 candidates each: over K = 4),
    frame 3 crams 12 (11 each: over K = 8) and frame 4 crams 20 (19 each:
    over K = 16)."""

    rng = np.random.default_rng(2111)
    grid = 10.0 * np.stack(np.unravel_index(np.arange(30), (4, 4, 2)), -1)
    frames = np.repeat(grid[None] + 5.0, 5, axis=0)
    for f, knot in ((1, 7), (3, 12), (4, 20)):
        frames[f, :knot] = 25.0 + 0.3 * rng.random((knot, 3))
    return frames.astype(np.float32)


def test_overflow_escalates_frame_by_frame():
    frames = _cluster_frames()
    dims = np.array([80.0] * 3 + [90.0] * 3)
    _, tu = _universes(frames, dims)
    kw = dict(probe_radius=1.0, n_points=64, radii=np.full(30, 1.5),
              device="cpu")
    with pytest.warns(UserWarning, match="max_occluders") as caught:
        a = sasa.SolventAccessibleSurfaceArea(tu.atoms, max_occluders=4,
                                              verbose=False, **kw)
        a._chunk_bytes = 30 * 3 * 4      # one frame a chunk
        a.run(stop=4)
    assert [str(w.message).split("=")[-1] for w in caught
            if "max_occluders" in str(w.message)] == ["8.", "16."]
    assert a._max_occluders == 16 and a._active_budget == 16
    assert a._occluder_retries == 0 and not a._pending_stores
    ref = _run(sasa.SolventAccessibleSurfaceArea, tu.atoms,
               max_occluders=20, **kw)
    np.testing.assert_array_equal(a.results.areas, ref.results.areas[:4])
    np.testing.assert_array_equal(a.results.n_neighbors,
                                  ref.results.n_neighbors[:4])
    assert (a.results.n_neighbors[[0, 2]] == 0).all()
    assert a.results.n_neighbors[1, :7].tolist() == [6] * 7
    assert a.results.n_neighbors[3, :12].tolist() == [11] * 12
    # two escalations are the limit: K = 2 -> 4 -> 8 still overflows
    b = sasa.SolventAccessibleSurfaceArea(tu.atoms, max_occluders=2,
                                          verbose=False, **kw)
    with pytest.warns(UserWarning, match="max_occluders"):
        with pytest.raises(sasa.OccluderOverflow, match="budget of 8"):
            b.run(stop=4)


def test_retry_count_resets_across_runs():
    frames = _cluster_frames()
    dims = np.array([80.0] * 3 + [90.0] * 3)
    _, tu = _universes(frames, dims)
    kw = dict(probe_radius=1.0, n_points=64, radii=np.full(30, 1.5),
              device="cpu")
    a = sasa.SolventAccessibleSurfaceArea(tu.atoms, max_occluders=2,
                                          verbose=False, **kw)
    with pytest.warns(UserWarning, match="max_occluders"):
        a.run(frames=[1])            # 2 -> 4 -> 8
    assert a._max_occluders == 8 and a._occluder_retries == 0
    with pytest.warns(UserWarning, match="max_occluders"):
        a.run(frames=[4])            # 8 -> 16 -> 32: two retries again
    assert a._max_occluders == 29    # at most every other atom
    ref = _run(sasa.SolventAccessibleSurfaceArea, tu.atoms,
               max_occluders=20, **kw)
    np.testing.assert_array_equal(a.results.areas[0], ref.results.areas[4])


def test_reach_warning():
    pos = np.array([[[1.0, 1.0, 1.0], [4.0, 4.0, 4.0]]])
    kw = dict(probe_radius=1.4, n_points=64, radii=np.array([1.5, 1.5]),
              device="cpu")
    for dims in ([6.0] * 3 + [90.0] * 3, [7.0, 7.0, 7.0, 60.0, 60.0, 80.0]):
        _, tu = _universes(pos, np.asarray(dims))
        with pytest.warns(UserWarning, match="occluder reach"):
            _run(sasa.SolventAccessibleSurfaceArea, tu.atoms, **kw)
    _, tu = _universes(pos, np.array([20.0] * 3 + [90.0] * 3))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _run(sasa.SolventAccessibleSurfaceArea, tu.atoms, **kw)


def test_radii_from_names_types_dicts_and_arrays():
    pos = np.array([[[2.0, 2.0, 2.0], [30.0, 30.0, 30.0]]])
    dims = np.array([60.0] * 3 + [90.0] * 3)
    names = np.array(["OW", "CL"], dtype=object)
    for kw in (dict(), dict(radii={"CL": 1.75}),
               dict(radii=np.array([1.2, 1.9]))):
        ref, out = _pair(pos, dims, n_points=96,
                         topology=dict(names=names), **kw)
        assert_equal_sasa(ref, out)
    np.testing.assert_allclose(out._inflated, [2.6, 3.3])
    # placeholder names: the types resolve the radii
    ref, out = _pair(pos, dims, n_points=96, topology=dict(
        names=np.array(["X", "X"], dtype=object),
        types=np.array(["O", "S"], dtype=object)))
    assert_equal_sasa(ref, out)
    np.testing.assert_allclose(out._inflated, [1.52 + 1.4, 1.80 + 1.4])


def test_validation_errors():
    _, tu = _universes(np.array([[[1.0, 1.0, 1.0]]]),
                       np.array([5.0] * 3 + [90.0] * 3))
    cls = sasa.SolventAccessibleSurfaceArea
    one = dict(radii=np.array([1.0]), device="cpu")
    with pytest.raises(ValueError, match="probe_radius"):
        cls(tu.atoms, probe_radius=-1.0, **one)
    with pytest.raises(ValueError, match="n_points"):
        cls(tu.atoms, n_points=0, **one)
    with pytest.raises(ValueError, match="entries"):
        cls(tu.atoms, radii=np.array([1.0, 2.0]), device="cpu")
    with pytest.raises(ValueError, match="positive"):
        cls(tu.atoms, radii=np.array([-1.0]), device="cpu")
    with pytest.raises(ValueError, match="max_occluders"):
        cls(tu.atoms, max_occluders=0, **one)
    with pytest.raises(ValueError, match="at least 1"):
        cls(tu.atoms[:0], device="cpu")
    # parallel=True is taken (ROADMAP Queue 1, item 10b-2)
    assert cls(tu.atoms, parallel=True, **one)._parallel


def test_units_and_reduced():
    from mdhelper_tpu_torch import Q_

    pos = np.array([[[1.0, 1.0, 1.0]]])
    ju, tu = _universes(pos, np.array([5.0] * 3 + [90.0] * 3))
    ref = _run(jax_sasa.SolventAccessibleSurfaceArea, ju.atoms,
               radii=np.array([1.0]))
    out = _run(sasa.SolventAccessibleSurfaceArea, tu.atoms,
               radii=np.array([1.0]), device="cpu")
    assert set(out.results.units) == set(ref.results.units)
    for key in ref.results.units:
        assert str(out.results.units[key]) == str(ref.results.units[key])
    nm = _run(sasa.SolventAccessibleSurfaceArea, tu.atoms,
              probe_radius=Q_(0.14, "nm"), radii=np.array([1.0]),
              device="cpu")
    np.testing.assert_array_equal(nm.results.areas, out.results.areas)
    red = _run(sasa.SolventAccessibleSurfaceArea, tu.atoms,
               radii=np.array([1.0]), reduced=True, device="cpu")
    assert "units" not in red.results


def test_escalation_resumes_from_its_checkpoint(tmp_path):
    """With ``checkpoint=``, the store is drained before each save, so an
    overflowing chunk is never saved: the escalated retry resumes from the
    last chunk that held, and equals the uninterrupted run."""

    frames = _cluster_frames()
    _, tu = _universes(frames, np.array([80.0] * 3 + [90.0] * 3))
    kw = dict(probe_radius=1.0, n_points=64, radii=np.full(30, 1.5),
              device="cpu")
    a = sasa.SolventAccessibleSurfaceArea(tu.atoms, max_occluders=4,
                                          verbose=False, **kw)
    a._chunk_bytes = 30 * 3 * 4
    streamed = []
    update = a._batched_update
    a._batched_update = lambda c, b: (streamed.append(int(b.indices[0]))
                                      or update(c, b))
    with pytest.warns(UserWarning, match="max_occluders"):
        a.run(stop=4, checkpoint=str(tmp_path / "state"))
    # K = 4 overflows at frame 1, K = 8 at frame 3: each retry starts
    # where the last save left off
    assert streamed == [0, 1, 1, 2, 3, 3]
    ref = _run(sasa.SolventAccessibleSurfaceArea, tu.atoms,
               max_occluders=20, **kw)
    np.testing.assert_array_equal(a.results.areas, ref.results.areas[:4])
