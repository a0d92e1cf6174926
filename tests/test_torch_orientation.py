"""The port's NematicOrderParameter and OrientationProfile against the JAX
package's.

The same seeded float32 waters (``testing.water_system``: bench.py's
3-site geometry, molecules walking and wrapped atom by atom) go through
``mdhelper_tpu.analysis.orientation`` (streaming float32: ``_coord_dtype``
on its base class, on the CPU) and its port (``device="cpu"``), in chunks
of 2 frames of 7 (a short last chunk), with the H1-H2 and O-H1 axes of
every molecule and of a subset of them, in an orthorhombic box and (the
nematic order) a triclinic one.  Tolerances, with their reasons:

* order tensors within ``Q_ATOL`` (8 eps32): each element is a float32
  sum of N products of unit-vector components over N, summed in another
  order;
* P2 within ``Q_ATOL``, directors within ``Q_ATOL / gap`` (the eigenvector
  moves by the tensor's error over the eigenvalue gap, which the test
  reads), P2_mean within ``Q_ATOL``;
* C1 and C2 (correlations of the stored float32 axes) within ``ACF_ATOL``;
* profile counts equal (integers); P1 and P2 profiles within
  ``PROFILE_ATOL``: the JAX class sums cos and cos^2 in float32 a frame,
  the port in float64.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import orientation as jax_orientation  # noqa: E402
from mdhelper_tpu.analysis.multi import run_together as jax_run_together  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.analysis import orientation  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.testing import water_system  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
Q_ATOL = 8 * EPS32
ACF_ATOL = 1e-6
PROFILE_ATOL = 1e-6
N_MOL, T, CHUNK = 120, 7, 2
BOX = 15.0
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
    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices

    frames, topology = water_system(np.random.default_rng(2034), N_MOL, BOX,
                                    T, step=0.2)
    h = np.asarray(triclinic_matrices(np.asarray(TRICLINIC, float)[None]))[0]
    frac = frames.astype(np.float64) @ np.linalg.inv(h)
    tri = ((frac - np.floor(frac)) @ h).astype(np.float32)
    return {
        "ortho": _universes(frames, np.array([BOX] * 3 + [90.0] * 3),
                            topology, dt=0.5),
        "triclinic": _universes(tri, np.asarray(TRICLINIC), topology,
                                dt=0.5),
    }


def _chunked(analyses):
    for a in analyses:
        a._chunk_bytes = CHUNK * len(a._atom_indices) * 3 * 4
    return analyses


def _axes(u, axis, subset):
    names = {"HH": ("H1", "H2"), "OH": ("O", "H1")}[axis]
    sel = " and resid 1:60" if subset else ""
    return (u.select_atoms(f"name {names[0]}{sel}"),
            u.select_atoms(f"name {names[1]}{sel}"))


NEMATIC_CASES = {
    "HH": ("ortho", "HH", False),
    "OH_subset": ("ortho", "OH", True),
    "triclinic_HH": ("triclinic", "HH", False),
    "triclinic_OH_subset": ("triclinic", "OH", True),
}


@pytest.mark.parametrize("case", list(NEMATIC_CASES))
def test_nematic_matches_jax(waters, case):
    box, axis, subset = NEMATIC_CASES[case]
    ju, tu = waters[box]
    ref, = jax_run_together(_chunked([jax_orientation.NematicOrderParameter(
        *_axes(ju, axis, subset), acf=True, verbose=False)]))
    ours, = run_together(_chunked([orientation.NematicOrderParameter(
        *_axes(tu, axis, subset), acf=True, verbose=False, device="cpu")]))
    np.testing.assert_allclose(ours.results.Q, ref.results.Q, rtol=0,
                               atol=Q_ATOL)
    np.testing.assert_allclose(ours.results.P2, ref.results.P2, rtol=0,
                               atol=Q_ATOL)
    evals = np.linalg.eigvalsh(ref.results.Q)
    gap = (evals[:, 2] - evals[:, 1]).min()
    np.testing.assert_allclose(ours.results.director, ref.results.director,
                               rtol=0, atol=Q_ATOL / gap)
    assert abs(ours.results.P2_mean - ref.results.P2_mean) <= Q_ATOL
    for key in ("C1", "C2"):
        np.testing.assert_allclose(ours.results[key], ref.results[key],
                                   rtol=0, atol=ACF_ATOL)
    np.testing.assert_array_equal(ours.results.acf_times,
                                  ref.results.acf_times)
    np.testing.assert_array_equal(ours.results.acf_times,
                                  0.5 * np.arange(T))
    np.testing.assert_array_equal(ours.results.times, ref.results.times)
    # the sign rule: the first non-zero component is positive
    assert (ours.results.director[:, 0] > 0).all()


def test_nematic_float64_oracle(waters):
    """The order tensors against a float64 numpy oracle of the same float32
    coordinates (minimum-image H1-H2 axes in the cube)."""

    _, tu = waters["ortho"]
    ours = orientation.NematicOrderParameter(
        *_axes(tu, "HH", False), verbose=False, device="cpu").run()
    b, e = _axes(tu, "HH", False)
    for t in range(T):
        tu.trajectory[t]
        v = e.positions.astype(np.float64) - b.positions
        v -= BOX * np.round(v / BOX)
        u = v / np.linalg.norm(v, axis=1, keepdims=True)
        Q = (3 * np.einsum("ia,ib->ab", u, u) / len(u) - np.eye(3)) / 2
        np.testing.assert_allclose(ours.results.Q[t], Q, rtol=0, atol=Q_ATOL)


def test_nematic_needs_uniform_frames(waters):
    ju, tu = waters["ortho"]
    for cls, u, kwargs in ((jax_orientation.NematicOrderParameter, ju, {}),
                           (orientation.NematicOrderParameter, tu,
                            dict(device="cpu"))):
        with pytest.raises(ValueError, match="uniformly spaced"):
            cls(*_axes(u, "HH", False), acf=True, verbose=False,
                **kwargs).run(frames=[0, 2, 3])


PROFILE_CASES = {
    "z_OH": ("z", "OH", False, 12, None),
    "x_HH_subset": ("x", "HH", True, 7, None),
    "y_director": ("y", "OH", False, 10, (1.0, 2.0, -0.5)),
}


@pytest.mark.parametrize("case", list(PROFILE_CASES))
def test_orientation_profile_matches_jax(waters, case):
    axis, pair, subset, n_bins, director = PROFILE_CASES[case]
    ju, tu = waters["ortho"]
    kwargs = dict(axis=axis, n_bins=n_bins, director=director, verbose=False)
    ref, = jax_run_together(_chunked([jax_orientation.OrientationProfile(
        *_axes(ju, pair, subset), **kwargs)]))
    ours, = run_together(_chunked([orientation.OrientationProfile(
        *_axes(tu, pair, subset), device="cpu", **kwargs)]))
    np.testing.assert_array_equal(ours.results.bins, ref.results.bins)
    np.testing.assert_array_equal(ours.results.counts, ref.results.counts)
    assert ours.results.counts.sum() == T * _axes(tu, pair, subset)[0].n_atoms
    for key in ("p1", "p2"):
        np.testing.assert_allclose(ours.results[key], ref.results[key],
                                   rtol=0, atol=PROFILE_ATOL)


def test_zero_length_axes_bin_nowhere():
    """An axis whose two atoms share float32 coordinates in a frame counts
    in no bin of that frame, in both packages."""

    frames, topology = water_system(np.random.default_rng(9), 20, 10.0, 3)
    frames[1, 4] = frames[1, 3]      # molecule 1: H1 on its O
    ju, tu = _universes(frames, np.array([10.0] * 3 + [90.0] * 3), topology)
    ref = jax_orientation.OrientationProfile(
        *_axes(ju, "OH", False), n_bins=5, verbose=False).run()
    ours = orientation.OrientationProfile(
        *_axes(tu, "OH", False), n_bins=5, verbose=False,
        device="cpu").run()
    assert ours.results.counts.sum() == 3 * 20 - 1
    np.testing.assert_array_equal(ours.results.counts, ref.results.counts)
    np.testing.assert_allclose(ours.results.p1, ref.results.p1, rtol=0,
                               atol=PROFILE_ATOL)


def test_validation_matches_jax(waters):
    ju, tu = waters["ortho"]
    jt, tt = waters["triclinic"]
    other_j, other_t = _universes(
        np.zeros((1, 3, 3), np.float32), np.array([5.0] * 3 + [90.0] * 3), {})
    cases = [
        (lambda u, o: (u.atoms[0:3], o.atoms[0:3]), {}, "same universe"),
        (lambda u, o: (u.atoms[0:3], u.atoms[3:5]), {}, "same number"),
        (lambda u, o: (u.atoms[0:0], u.atoms[0:0]), {}, "Empty axis"),
        (lambda u, o: (u.atoms[0:3], u.atoms[2::-1]), {}, "with itself"),
    ]
    for groups, kwargs, match in cases:
        for jax_cls, cls in (
                (jax_orientation.NematicOrderParameter,
                 orientation.NematicOrderParameter),
                (jax_orientation.OrientationProfile,
                 orientation.OrientationProfile)):
            with pytest.raises(ValueError, match=match):
                jax_cls(*groups(ju, other_j), verbose=False, **kwargs)
            with pytest.raises(ValueError, match=match):
                cls(*groups(tu, other_t), device="cpu", **kwargs)
    for u_j, u_t, kwargs, match in (
            (jt, tt, {}, "orthorhombic"),
            (ju, tu, dict(axis="w"), "axis must be"),
            (ju, tu, dict(n_bins=0), "'n_bins' must be positive"),
            (ju, tu, dict(director=(0, 0, 0)), "'director' must be"),
    ):
        with pytest.raises(ValueError, match=match):
            jax_orientation.OrientationProfile(*_axes(u_j, "OH", False),
                                               verbose=False, **kwargs)
        with pytest.raises(ValueError, match=match):
            orientation.OrientationProfile(*_axes(u_t, "OH", False),
                                           device="cpu", **kwargs)
    for cls in (orientation.NematicOrderParameter,
                orientation.OrientationProfile):
        with pytest.raises(NotImplementedError, match="item 10"):
            cls(*_axes(tu, "OH", False), parallel=True, device="cpu")
