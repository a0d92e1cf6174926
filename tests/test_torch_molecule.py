"""The port's molecule, accelerated, unwrap, pbc and utility functions
against the JAX package's.

The same seeded float32 inputs go through ``mdhelper_tpu`` and its port:

* ``center_of_mass`` and ``radius_of_gyration`` of an atom group (a
  subset of a universe of 30 molecules, equal-sized residues and ragged
  segments, mass-weighted) in every grouping, with ``images`` and
  ``raw``, and of arrays given directly (one group, ``n_groups``, ragged
  lists), as NumPy arrays (the port's NumPy results equal the JAX
  package's, which are NumPy too, within 1e-12 relative: the same NumPy
  calls, a summation order apart where the port's einsum promotes) and as
  tensors against JAX arrays (float64, within 1e-12 relative);
* every name of ``algorithm.accelerated`` on CPU tensors against JAX
  arrays, and on NumPy inputs placed on the CPU (their default is the
  card) against the JAX package's NumPy results (float64: within 1e-12
  of the largest value; the
  ``*_parallel_*`` names are aliases, the ``*_inplace_*`` ones fill the
  given buffer);
* ``topology.unwrap`` over a wrapped random walk: the NumPy branch in
  place and as a copy equals the JAX package's bit for bit, and the torch
  branch equals the JAX-array branch bit for bit;
* ``ops.pbc.min_image_displacement`` (float32, bit for bit) and
  ``com_shift_scan`` (float32 and float64, within 2 eps of the largest
  coordinate);
* ``utility.replicate`` (bit for bit) and ``utility.rebin`` (with and
  without a factor, every last-axis length from 1 to 40; the JAX package
  finds the divisors with sympy, the port by trial division).

Validation errors are those the JAX tests check.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.algorithm import accelerated as jax_acc  # noqa: E402
from mdhelper_tpu.algorithm import molecule as jax_molecule  # noqa: E402
from mdhelper_tpu.algorithm import topology as jax_topology  # noqa: E402
from mdhelper_tpu.algorithm import utility as jax_utility  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu.ops import pbc as jax_pbc  # noqa: E402

from mdhelper_tpu_torch.algorithm import accelerated, molecule  # noqa: E402
from mdhelper_tpu_torch.algorithm import topology, utility  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import pbc  # noqa: E402

RTOL = 1e-12
BOX = 12.0


def _close(port, ref, rtol=RTOL):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(ref)).max())


@pytest.fixture(scope="module")
def universes():
    """30 molecules of 4 atoms (residues) in 3 segments of unequal size,
    float32 positions in the BOX cube, masses of 1-16 u; (jax, port)."""

    rng = np.random.default_rng(101)
    n_mol, per = 30, 4
    n = n_mol * per
    frames = (rng.random((2, n, 3)) * BOX).astype(np.float32)
    topology_attrs = dict(
        masses=rng.choice([1.008, 12.011, 14.007, 15.999], n),
        resindices=np.repeat(np.arange(n_mol), per),
        segindices=np.repeat([0, 1, 2], [40, 48, 32]),
    )
    dims = np.array([BOX] * 3 + [90.0] * 3)
    return (JaxUniverse.from_arrays(frames.astype(np.float64), dims,
                                    **topology_attrs),
            Universe.from_arrays(frames, dims, **topology_attrs))


def _subset(u):
    # residues 2-27 and the atoms of segment 1 within them: a subset that
    # cuts segment boundaries but keeps residues whole
    return u.atoms[8:112]


@pytest.mark.parametrize("grouping", [None, "residues", "segments"])
@pytest.mark.parametrize("images", [False, True])
def test_center_of_mass_of_groups(universes, grouping, images):
    ju, tu = universes
    kwargs = {}
    if images:
        count = _subset(tu).n_atoms
        kwargs["images"] = np.random.default_rng(3).integers(
            -2, 3, (count, 3))
    ref = jax_molecule.center_of_mass(_subset(ju), grouping, **kwargs)
    port = molecule.center_of_mass(_subset(tu), grouping, **kwargs)
    assert isinstance(port, np.ndarray)
    _close(port, ref)
    ref_raw = jax_molecule.center_of_mass(_subset(ju), grouping, raw=True,
                                          **kwargs)
    port_raw = molecule.center_of_mass(_subset(tu), grouping, raw=True,
                                       **kwargs)
    for p, r in zip(port_raw, ref_raw):
        if isinstance(r, list):  # ragged segments: one array a segment
            assert len(p) == len(r)
            for pp, rr in zip(p, r):
                _close(pp, rr)
        else:
            _close(p, r)


@pytest.mark.parametrize("grouping", [None, "residues", "segments"])
@pytest.mark.parametrize("components", [False, True])
def test_radius_of_gyration_of_groups(universes, grouping, components):
    ju, tu = universes
    images = np.random.default_rng(4).integers(-1, 2,
                                               (_subset(tu).n_atoms, 3))
    for kwargs in ({}, {"images": images}):
        ref = jax_molecule.radius_of_gyration(_subset(ju), grouping,
                                              components=components,
                                              **kwargs)
        port = molecule.radius_of_gyration(_subset(tu), grouping,
                                           components=components, **kwargs)
        _close(port, ref)


def test_images_need_dimensions(universes):
    """``images`` with explicit ``dimensions`` unwraps by them; a group
    without a box raises as in the JAX package."""

    ju, tu = universes
    images = np.ones((_subset(tu).n_atoms, 3), dtype=int)
    dims = np.array([10.0, 11.0, 13.0])
    _close(molecule.center_of_mass(_subset(tu), images=images,
                                   dimensions=dims),
           jax_molecule.center_of_mass(_subset(ju), images=images,
                                       dimensions=dims))

    class NoBox:
        ix = np.arange(3)
        positions = np.zeros((3, 3))
        masses = np.ones(3)
        dimensions = None

    for module in (molecule, jax_molecule):
        with pytest.raises(ValueError, match="dimensions"):
            module.center_of_mass(NoBox(), images=np.zeros((3, 3)))


def _arrays():
    rng = np.random.default_rng(7)
    masses = rng.random((6, 10)) + 0.5
    positions = (rng.random((6, 10, 3)) * 20).astype(np.float32)
    return masses, positions


@pytest.mark.parametrize("components", [False, True])
def test_arrays_given_directly(components):
    masses, positions = _arrays()
    cases = [
        dict(masses=masses[0], positions=positions[0]),
        dict(masses=masses, positions=positions),
        dict(masses=masses.ravel(), positions=positions.reshape(-1, 3),
             n_groups=6),
        dict(masses=[masses[0, :4], masses[1, :7]],
             positions=[positions[0, :4], positions[1, :7]]),
    ]
    for kwargs in cases:
        _close(molecule.center_of_mass(**kwargs),
               jax_molecule.center_of_mass(**kwargs))
    # radius_of_gyration takes n_groups for groups already shaped (as the
    # JAX tests call it); flat arrays with n_groups fail in both packages
    cases[2] = dict(masses=masses, positions=positions, n_groups=6)
    for kwargs in cases:
        _close(molecule.radius_of_gyration(components=components, **kwargs),
               jax_molecule.radius_of_gyration(components=components,
                                               **kwargs))


@pytest.mark.parametrize("components", [False, True])
def test_tensors_against_jax_arrays(components):
    """Tensors give tensors on their device, JAX arrays JAX arrays; the
    values agree (float64 masses promote the float32 positions)."""

    masses, positions = _arrays()
    for m, p, n_groups in ((masses[0], positions[0], None),
                           (masses, positions, None),
                           (masses.ravel(), positions.reshape(-1, 3), 6)):
        port = molecule.center_of_mass(masses=torch.as_tensor(m),
                                       positions=torch.as_tensor(p),
                                       n_groups=n_groups)
        ref = jax_molecule.center_of_mass(masses=jnp.asarray(m),
                                          positions=jnp.asarray(p),
                                          n_groups=n_groups)
        assert isinstance(port, torch.Tensor)
        assert port.dtype == torch.float64
        _close(port, ref)
    for m, p, n_groups in ((masses[0], positions[0], None),
                           (masses, positions, None),
                           (masses, positions, 6)):
        port = molecule.radius_of_gyration(
            masses=torch.as_tensor(m), positions=torch.as_tensor(p),
            n_groups=n_groups, components=components)
        ref = jax_molecule.radius_of_gyration(
            masses=jnp.asarray(m), positions=jnp.asarray(p),
            n_groups=n_groups, components=components)
        assert isinstance(port, torch.Tensor)
        _close(port, ref)


def test_molecule_validation():
    for module in (molecule, jax_molecule):
        with pytest.raises(ValueError, match="Invalid grouping"):
            module.center_of_mass(grouping="molecules")
        with pytest.raises(ValueError, match="must be provided"):
            module.center_of_mass()
        with pytest.raises(ValueError, match="Invalid grouping"):
            module.radius_of_gyration(grouping="chains")
        with pytest.raises(ValueError, match="incompatible"):
            module.center_of_mass(masses=[[1.0], [1.0, 2.0]],
                                  positions=[[0.0, 0.0, 0.0]] * 3)


# -- accelerated --------------------------------------------------------

def _acc_inputs():
    rng = np.random.default_rng(11)
    return {
        "a": rng.normal(size=3), "b": rng.normal(size=3),
        "qs": rng.normal(size=(7, 3)), "rs": rng.normal(size=(50, 3)) * 4,
        "x": rng.normal(size=40) * 3, "y": rng.normal(size=25) * 3,
        "xs": rng.normal(size=(6, 30)) * 3,
    }


ACCELERATED = {
    "dot_1d_1d": ("a", "b"),
    "delta_fourier_transform_1d_1d": ("a", "b"),
    "delta_fourier_transform_sum_2d_2d": ("qs", "rs"),
    "inner_2d_2d": ("qs", "rs"),
    "pythagorean_trigonometric_identity_1d": ("x",),
    "pythagorean_trigonometric_identity_1d_1d": ("x", "y"),
    "cosine_sum_1d": ("x",),
    "cosine_sum_2d": ("xs",),
    "sine_sum_1d": ("x",),
    "sine_sum_2d": ("xs",),
}


def _numpy_on_cpu(monkeypatch):
    """NumPy inputs go to the first CUDA device; here they are placed on
    the CPU instead, so the NumPy-in, NumPy-out branch runs without a
    card (``tests/test_torch_cuda.py`` runs it on the card)."""

    monkeypatch.setattr(accelerated, "require_cuda",
                        lambda: torch.device("cpu"))


@pytest.mark.parametrize("name", sorted(ACCELERATED))
def test_accelerated_matches_jax(monkeypatch, name):
    data = _acc_inputs()
    args = [data[k] for k in ACCELERATED[name]]
    port = getattr(accelerated, name)(*[torch.as_tensor(a) for a in args])
    assert isinstance(port, torch.Tensor)
    assert port.device == torch.device("cpu")
    _close(port, np.asarray(getattr(jax_acc, name)(
        *[jnp.asarray(a) for a in args])))
    ref = np.asarray(getattr(jax_acc, name)(*args))
    _numpy_on_cpu(monkeypatch)
    port = getattr(accelerated, name)(*args)
    assert isinstance(port, np.ndarray)
    assert port.dtype == ref.dtype
    _close(port, ref)


def test_accelerated_names_aliases_and_buffers(monkeypatch):
    assert set(accelerated.__all__) == set(jax_acc.__all__)
    for name in jax_acc.__all__:
        if "_parallel_" in name:
            serial = name.replace("_parallel", "")
            assert getattr(accelerated, name) is getattr(accelerated, serial)
    _numpy_on_cpu(monkeypatch)
    xs = _acc_inputs()["xs"]
    for fn in ("cosine_sum", "sine_sum"):
        for suffix in ("inplace_2d", "inplace_parallel_2d"):
            for data in (xs, torch.as_tensor(xs)):
                out = np.zeros(len(xs))
                assert getattr(accelerated, f"{fn}_{suffix}")(data,
                                                             out) is None
                _close(out, np.asarray(getattr(jax_acc, f"{fn}_2d")(xs)))


# -- unwrap, pbc, utility ------------------------------------------------

def _walk(seed=5, n_frames=6, n=40):
    """A random walk of `n` atoms wrapped into a (10, 11, 12) box: float32
    frames, with steps of up to 6 A so some cross half a box."""

    rng = np.random.default_rng(seed)
    box = np.array([10.0, 11.0, 12.0], dtype=np.float32)
    steps = rng.uniform(-6.0, 6.0, (n_frames, n, 3))
    steps[0] = rng.random((n, 3)) * box
    return np.mod(np.cumsum(steps, axis=0), box).astype(np.float32), box


@pytest.mark.parametrize("thresholds", [None, 4.0])
def test_unwrap_numpy_in_place_and_copy(thresholds):
    frames, box = _walk()
    state = {}
    for name, fn in (("port", topology.unwrap),
                     ("jax", jax_topology.unwrap)):
        old, images = frames[0].copy(), np.zeros(frames[0].shape, int)
        out = []
        for f in frames[1:]:
            pos = f.copy()
            assert fn(pos, old, box, thresholds=thresholds,
                      images=images) is None
            out.append(pos)
        copies = []
        old_c = frames[0].copy()
        images_c = np.zeros(frames[0].shape, int)
        for f in frames[1:]:
            new, old_c, images_c = fn(f, old_c, box, thresholds=thresholds,
                                      images=images_c, in_place=False)
            copies.append(new)
        state[name] = (np.array(out), images, np.array(copies), images_c)
    for port, ref in zip(state["port"], state["jax"]):
        assert port.dtype == ref.dtype
        np.testing.assert_array_equal(port, ref)
    assert np.abs(state["port"][1]).max() > 0  # some atoms crossed


def test_unwrap_tensors_against_jax_arrays():
    frames, box = _walk(seed=6)
    old_t = torch.as_tensor(frames[0])
    old_j = jnp.asarray(frames[0])
    images_t = images_j = None
    for f in frames[1:]:
        new_t, old_t, images_t = topology.unwrap(
            torch.as_tensor(f), old_t, torch.as_tensor(box),
            images=images_t, in_place=True)
        new_j, old_j, images_j = jax_topology.unwrap(
            jnp.asarray(f), old_j, jnp.asarray(box), images=images_j)
        np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
        np.testing.assert_array_equal(images_t.numpy(), np.asarray(images_j))
    assert images_t.dtype == torch.int64


def test_min_image_displacement_matches_jax():
    rng = np.random.default_rng(8)
    delta = (rng.uniform(-30.0, 30.0, (500, 3))).astype(np.float32)
    # half-box ties: round half to even in both
    delta[:6] = np.array([[5.0, -5.5, 6.0]] * 6, dtype=np.float32)
    box = np.array([10.0, 11.0, 12.0], dtype=np.float32)
    port = pbc.min_image_displacement(torch.as_tensor(delta),
                                      torch.as_tensor(box))
    ref = jax_pbc.min_image_displacement(jnp.asarray(delta),
                                         jnp.asarray(box))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_com_shift_scan_matches_jax(dtype):
    rng = np.random.default_rng(9)
    unwrapped = (rng.normal(size=(5, 60, 3)) * 30).astype(dtype)
    masses = rng.random(60) + 1.0
    port = pbc.com_shift_scan(torch.as_tensor(unwrapped), masses)
    ref = np.asarray(jax_pbc.com_shift_scan(jnp.asarray(unwrapped),
                                            jnp.asarray(masses)))
    assert port.numpy().dtype == ref.dtype
    eps = np.finfo(dtype).eps
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=2 * eps * np.abs(unwrapped).max())
    # the drift is gone: the mass-weighted centers are 0
    com = np.einsum("a,tad->td", masses, port.numpy()) / masses.sum()
    assert np.abs(com).max() < 8 * eps * np.abs(unwrapped).max()


def test_replicate_matches_jax():
    rng = np.random.default_rng(10)
    for cell_pos in (rng.random((4, 3)), rng.random(3)):
        dims = np.array([1.5, 2.0, 2.5])
        for n_cells in ([1, 1, 1], [3, 2, 4], np.array([2, 5, 1])):
            np.testing.assert_array_equal(
                utility.replicate(dims, cell_pos, n_cells),
                jax_utility.replicate(dims, cell_pos, n_cells))


def test_rebin_matches_jax():
    rng = np.random.default_rng(12)
    for length in range(1, 41):
        x = rng.normal(size=(3, length))
        try:
            ref = jax_utility.rebin(x)
        except ValueError:
            with pytest.raises(ValueError, match="No factor"):
                utility.rebin(x)
            continue
        np.testing.assert_array_equal(utility.rebin(x), ref)
    x = rng.normal(size=(2, 5, 12))
    for factor in (1, 2, 3, 4, 6, 12):
        np.testing.assert_array_equal(utility.rebin(x, factor),
                                      jax_utility.rebin(x, factor))
