"""The port's NativeContacts and contact-pair helpers against the JAX
package's.

Seeded float32 coordinates (a compact cluster of 120 atoms jittering
about a reference structure, wrapped into the box) go through
``mdhelper_tpu.analysis.contacts`` (streaming float32: ``_coord_dtype``
on its base class) and its port (``device="cpu"``), in chunks of 2 frames
of 7, in the cube and in a triclinic cell, for two overlapping subsets
of the atoms and for one group against itself.

* The reference pairs (found in float64 on the host by the same scipy
  KD-tree, or the 27-image fold in a triclinic cell) and their lengths
  ``r0`` equal the JAX package's exactly, also for pairs one float64 ulp
  either side of ``radius`` in an explicit reference.
* ``hard`` and ``radius``: q equals the JAX class's bit for bit.  Its
  float32 ``mean`` of 0/1 values is the exact count times the float32
  ``1 / P`` (XLA turns the division into that product; for some P the
  two differ, which the test shows), and the port takes that product.
* ``soft`` (float32 ``exp`` in both; the port averages in float64):
  within 2e-6 of the JAX class.
* The three contact-pair helpers of ``analysis.cluster`` equal the JAX
  package's on wrapped, unwrapped and partly aperiodic points.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu import Q_ as JQ  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import cluster as jax_cluster  # noqa: E402
from mdhelper_tpu.analysis import contacts as jax_contacts  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.algorithm.topology import (  # noqa: E402
    triclinic_matrices,
)
from mdhelper_tpu_torch.analysis import cluster, contacts  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N, T, CHUNK = 120, 7, 2
BOX = 16.0
ORTHO = np.array([BOX] * 3 + [90.0] * 3)
TRICLINIC = np.array([BOX, BOX, BOX, 75.0, 80.0, 70.0])


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


def _wrap(x, dims):
    h = triclinic_matrices(np.asarray(dims, float)[None])[0]
    frac = x @ np.linalg.inv(h)
    return (frac - np.floor(frac)) @ h


@pytest.fixture(scope="module")
def systems():
    """``{box: (jax universe, port universe)}``: 120 atoms of a cluster of
    radius about 7 A centered near a corner (so contacts cross faces),
    jittering by 0.6 A a frame about frame 0."""

    rng = np.random.default_rng(3001)
    base = rng.normal(size=(N, 3)) * 3.5 + 1.0
    frames = base + rng.normal(size=(T, N, 3)) * 0.6
    out = {}
    for name, dims in (("ortho", ORTHO), ("triclinic", TRICLINIC)):
        f = _wrap(frames, dims).astype(np.float32)
        out[name] = (JaxUniverse.from_arrays(f.astype(np.float64), dims),
                     Universe.from_arrays(f, dims))
    return out


GROUPS = {
    "overlap": (slice(0, 80), slice(40, 120)),
    "self": (slice(20, 100), None),
}


def _pair(universes, groups, **kwargs):
    out = []
    for module, u, device in ((jax_contacts, universes[0], {}),
                              (contacts, universes[1], {"device": "cpu"})):
        a_sel, b_sel = groups
        a = module.NativeContacts(
            u.atoms[a_sel], None if b_sel is None else u.atoms[b_sel],
            verbose=False, **kwargs, **device)
        a._chunk_bytes = CHUNK * len(a._atom_indices) * 3 * 4
        out.append(a.run())
    return out


def _same_reference(ref, port):
    np.testing.assert_array_equal(port.results.pairs, ref.results.pairs)
    np.testing.assert_array_equal(port.results.r0, ref.results.r0)
    assert port.results.n_native == ref.results.n_native


@pytest.mark.parametrize("box", ["ortho", "triclinic"])
@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("method", ["hard", "radius", "soft"])
def test_q_matches_jax(systems, box, groups, method):
    ref, port = _pair(systems[box], GROUPS[groups], radius=4.5,
                      method=method)
    _same_reference(ref, port)
    if method == "soft":
        np.testing.assert_allclose(port.results.q, ref.results.q, rtol=0,
                                   atol=2e-6)
    else:
        np.testing.assert_array_equal(port.results.q, ref.results.q)
        assert port.results.q.min() < 1.0
    np.testing.assert_array_equal(port.results.times, ref.results.times)
    assert set(port.results.units) == set(ref.results.units)


def test_mean_is_the_product_by_the_float32_reciprocal(systems):
    """The JAX class's q is count * float32(1 / P), and for this P that
    differs from the float32 count / P in some frame."""

    ref, port = _pair(systems["ortho"], GROUPS["overlap"], radius=4.5,
                      method="hard", lambda_=1.2)
    p = ref.results.n_native
    counts = np.rint(ref.results.q * p).astype(np.float32)
    product = counts * (np.float32(1.0) / np.float32(p))
    np.testing.assert_array_equal(ref.results.q, product)
    np.testing.assert_array_equal(port.results.q, product)
    assert (product != counts / np.float32(p)).any()


def test_reference_pairs_at_the_radius(systems):
    """An explicit float64 reference with pairs along x at the radius and
    one float64 ulp either side (the pair at the radius counts, the KD-tree
    takes distances <= r): equal reference sets, equal q."""

    ju, tu = systems["ortho"]
    radius = 4.5
    seps = [np.nextafter(radius, 0.0), radius, np.nextafter(radius, 9.0)]
    ref_a = np.tile([[2.0, 3.0, 4.0]], (20, 1)) + np.arange(20)[:, None] * [
        0.0, 0.0, 0.75]
    ref_b = ref_a.copy()
    ref_b[:, 0] += np.array((seps * 7)[:20])  # 2 + sep is exact
    assert set(ref_b[:, 0] - ref_a[:, 0]) == set(seps)
    out = []
    for module, u, device in ((jax_contacts, ju, {}),
                              (contacts, tu, {"device": "cpu"})):
        a = module.NativeContacts(u.atoms[:20], u.atoms[20:40], radius,
                                  reference=(ref_a, ref_b), verbose=False,
                                  **device)
        out.append(a.run())
    _same_reference(*out)
    np.testing.assert_array_equal(out[1].results.q, out[0].results.q)
    got = set(map(tuple, out[1].results.pairs))
    for i in range(20):
        sep = ref_b[i, 0] - ref_a[i, 0]
        assert ((i, i) in got) == (sep <= radius)


@pytest.mark.parametrize("method", ["hard", "soft"])
def test_explicit_reference_units_and_reduced(systems, method):
    """A reference frame other than 0, a unit-bearing radius, lambda and
    beta, and reduced units."""

    ju, tu = systems["triclinic"]
    out = []
    for module, u, q, device in ((jax_contacts, ju, JQ, {}),
                                 (contacts, tu, Q_, {"device": "cpu"})):
        a = module.NativeContacts(u.atoms[::2], u.atoms[1::2],
                                  q(0.5, "nanometer"), reference=3,
                                  method=method, lambda_=1.3, beta=3.0,
                                  reduced=True, verbose=False, **device)
        out.append(a.run(step=2))
    ref, port = out
    _same_reference(ref, port)
    assert "units" not in port.results and "units" not in ref.results
    np.testing.assert_allclose(port.results.q, ref.results.q, rtol=0,
                               atol=0 if method == "hard" else 2e-6)


def test_validation(systems):
    ju, tu = systems["ortho"]
    far = np.array([[[0, 0, 0], [5, 0, 0], [0, 5, 0], [0, 0, 5]]],
                   np.float32)
    for module, u, device, cls in (
            (jax_contacts, ju, {}, JaxUniverse),
            (contacts, tu, {"device": "cpu"}, Universe)):
        make = module.NativeContacts
        with pytest.raises(ValueError, match="radius"):
            make(u.atoms, radius=-1, verbose=False, **device)
        with pytest.raises(ValueError, match="method"):
            make(u.atoms, method="fuzzy", verbose=False, **device)
        with pytest.raises(ValueError, match="positive"):
            make(u.atoms, lambda_=0.0, verbose=False, **device)
        with pytest.raises(ValueError, match="match the group"):
            make(u.atoms[:3], u.atoms[3:6],
                 reference=(np.zeros((2, 3)), np.zeros((3, 3))),
                 verbose=False, **device).run()
        uf = cls.from_arrays(far.astype(
            np.float64 if cls is JaxUniverse else np.float32), ORTHO)
        with pytest.raises(ValueError, match="No native contacts"):
            make(uf.atoms[:2], uf.atoms[2:], 1.0, verbose=False,
                 **device).run()
        boxless = cls.from_arrays(far.astype(
            np.float64 if cls is JaxUniverse else np.float32), np.zeros(6))
        with pytest.raises(ValueError, match="periodic box"):
            make(boxless.atoms, verbose=False, **device)
    # parallel=True is taken (ROADMAP Queue 1, item 10b-2)
    assert contacts.NativeContacts(tu.atoms, parallel=True,
                                   device="cpu")._parallel


def test_contact_pair_helpers_match_jax():
    rng = np.random.default_rng(17)
    pts = rng.normal(size=(300, 3)) * 6.0  # unwrapped, negatives too
    for box in (np.array([BOX] * 3), np.array([BOX, BOX, 0.0]),
                np.zeros(3)):
        for port, ref in zip(cluster._wrap_periodic_axes(pts, box),
                             jax_cluster._wrap_periodic_axes(pts, box)):
            np.testing.assert_array_equal(port, ref)
        for port, ref in zip(cluster._periodic_contact_pairs(pts, box, 2.5),
                             jax_cluster._periodic_contact_pairs(pts, box,
                                                                 2.5)):
            np.testing.assert_array_equal(port, ref)
    wrapped = _wrap(pts, TRICLINIC)
    for block in (64, 1024):
        port = cluster._triclinic_contact_pairs(wrapped, TRICLINIC, 3.0,
                                                block=block)
        ref = jax_cluster._triclinic_contact_pairs(wrapped, TRICLINIC, 3.0,
                                                   block=block)
        assert len(port[0]) > 100
        for p, r in zip(port, ref):
            np.testing.assert_array_equal(p, r)
