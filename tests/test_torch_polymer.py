"""The port's polymer analyses against the JAX package's classes.

The same seeded chains (``testing.polymer_chains``: Gaussian walks of
about 1 A bonds that relax from frame to frame, drifting through a 20 A
cube, wrapped atom by atom) go through ``mdhelper_tpu.analysis.polymer``
(streaming float32: ``_coord_dtype`` set on its base class, on the CPU)
and its port (``device="cpu"``: the trig sums' plain version), in chunks
of 5 frames of 12 (a short last chunk).  Tolerances, with their reasons:

* ``atol_r = 4 eps32 max|r|`` for float32 results built from the
  coordinates: both packages sum float32 products of the same float32
  inputs, in other orders, and the chain centers (Gyradius) and the Rouse
  rows, which sum to zero, cancel numbers of the coordinates' size, so
  the error scales with max |r|, not with the result.
* Asphericity and acylindricity within ``SHAPE_ATOL`` A^2: the closed-form
  eigenvalues take an arccos, whose slope near +-1 turns an eps32 error
  of its argument into about sqrt(eps32) of the spread p.
* Correlations of the same stored float64 series (end-to-end ACFs) within
  1e-12; normalized Rouse ACFs within ``4 atol_r / min |X_p|``.
* Gram-matrix carries (persistence length, internal distances): float32
  Gram sums in JAX, float64 in the port: within 1e-6 of their scale.
* Single-chain S(q): the JAX class sums cos^2 + sin^2 over chains in
  float32, the port in float64: ``rtol 1e-5`` of the largest value; the
  port against a float64 numpy oracle on the same float32 positions and
  float32-rounded wavevectors within ``1e-6`` of the largest value (the
  exact sums' float32 cosine).
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = jax.numpy
torch = pytest.importorskip("torch")

from mdhelper_tpu import Q_ as JQ  # noqa: E402
from mdhelper_tpu.algorithm.topology import (  # noqa: E402
    triclinic_matrices as jax_triclinic_matrices,
)
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import polymer as jax_polymer  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu.ops import histogram as jax_histogram  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.analysis import polymer  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    _wavevector_grid,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import histogram  # noqa: E402
from mdhelper_tpu_torch.testing import polymer_chains  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
BOX = 20.0
M, NP, T, CHUNK = 5, 8, 12, 5
SHAPE_ATOL = 1e-3


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


def _chain_topology(lengths):
    """Masses (1 to 2 along each chain), one segment a chain, one residue
    an atom, and the backbone bonds of chains of `lengths` atoms."""

    masses, segs, bonds, start = [], [], [], 0
    for c, n in enumerate(lengths):
        masses.append(np.linspace(1.0, 2.0, n))
        segs.append(np.full(n, c))
        bonds.append(np.stack((np.arange(start, start + n - 1),
                               np.arange(start + 1, start + n)), axis=1))
        start += n
    n_atoms = start
    return dict(masses=np.concatenate(masses),
                segindices=np.concatenate(segs),
                resindices=np.arange(n_atoms), bonds=np.concatenate(bonds))


def _universes(frames, dims, topology):
    jax_u = JaxUniverse.from_arrays(frames.astype(np.float64), dims, dt=1.0,
                                    **topology)
    port_u = Universe.from_arrays(frames, dims, dt=1.0, **topology)
    return jax_u, port_u


def _ragged_chains(rng, lengths, n_frames, box, **kwargs):
    """polymer_chains of mixed lengths: one call a length, concatenated."""

    parts = [polymer_chains(rng, 1, n, n_frames, box, **kwargs)
             for n in lengths]
    return (np.concatenate([p[0] for p in parts], axis=1),
            np.concatenate([p[1] for p in parts], axis=1))


@pytest.fixture(scope="module")
def chains():
    """``(jax universe, port universe, unwrapped)``: M chains of NP atoms
    in the cube, with segments, per-atom residues and backbone bonds."""

    rng = np.random.default_rng(2026)
    frames, unwrapped = polymer_chains(rng, M, NP, T, BOX, stiffness=0.5,
                                       memory=0.8, drift=0.6)
    dims = np.array([BOX] * 3 + [90.0] * 3)
    return (*_universes(frames, dims, _chain_topology([NP] * M)), unwrapped)


@pytest.fixture(scope="module")
def ragged():
    """Three chains of 8 atoms, then two of 6 (segments, bonds)."""

    lengths = [8, 8, 8, 6, 6]
    frames, unwrapped = _ragged_chains(np.random.default_rng(7), lengths, T,
                                       BOX, stiffness=0.3)
    dims = np.array([BOX] * 3 + [90.0] * 3)
    return (*_universes(frames, dims, _chain_topology(lengths)), unwrapped)


@pytest.fixture(scope="module")
def residues():
    """Four chains of 6 two-atom monomers (masses 12 and 1, the second
    atom 0.5 A from the first): one residue a monomer, one segment a
    chain, bonds within monomers and between their first atoms."""

    rng = np.random.default_rng(11)
    n_chains, n_p = 4, 6
    _, heavy = polymer_chains(rng, n_chains, n_p, T, BOX, stiffness=0.4)
    arm = rng.normal(size=(n_chains * n_p, 3))
    arm *= 0.5 / np.linalg.norm(arm, axis=-1, keepdims=True)
    unwrapped = np.stack((heavy, heavy + arm), axis=2).reshape(T, -1, 3)
    frames = np.mod(unwrapped, BOX).astype(np.float32)
    n_mono = n_chains * n_p
    first = 2 * np.arange(n_mono)
    backbone = first.reshape(n_chains, n_p)
    bonds = np.concatenate([
        np.stack((first, first + 1), axis=1),
        np.stack((backbone[:, :-1].ravel(), backbone[:, 1:].ravel()), axis=1),
    ])
    topology = dict(masses=np.tile([12.0, 1.0], n_mono),
                    resindices=np.repeat(np.arange(n_mono), 2),
                    segindices=np.repeat(np.arange(n_chains), 2 * n_p),
                    bonds=bonds)
    dims = np.array([BOX] * 3 + [90.0] * 3)
    return (*_universes(frames, dims, topology), unwrapped)


def _boxed(unwrapped, dims):
    """Port and JAX universes of `unwrapped` wrapped into `dims`: a
    triclinic cell (fractional wrap), per-frame boxes ``(T, 3)``, or a
    slab with a zero length (that axis left as it is)."""

    dims = np.asarray(dims, dtype=float)
    if dims.ndim == 2:
        wrapped = unwrapped - dims[:, None, :] * np.floor(
            unwrapped / dims[:, None, :])
    elif len(dims) == 6:
        h = np.asarray(jax_triclinic_matrices(dims[None]))[0]
        frac = unwrapped.reshape(-1, 3) @ np.linalg.inv(h)
        wrapped = ((frac - np.floor(frac)) @ h).reshape(unwrapped.shape)
    else:
        wrapped = unwrapped.copy()
        periodic = dims > 0
        wrapped[..., periodic] -= dims[periodic] * np.floor(
            unwrapped[..., periodic] / dims[periodic])
    return _universes(wrapped.astype(np.float32), dims,
                      _chain_topology([NP] * M))


@pytest.fixture(scope="module")
def boxes(chains):
    """The chains in a triclinic cell, in per-frame (NPT) boxes and in a
    slab whose z length is zero."""

    unwrapped = chains[2]
    npt = np.column_stack([np.linspace(BOX, 1.6 * BOX, T),
                           np.linspace(BOX, 1.4 * BOX, T), np.full(T, BOX)])
    return {
        "triclinic": _boxed(unwrapped, [BOX, BOX, BOX, 80.0, 75.0, 70.0]),
        "npt": _boxed(unwrapped, npt),
        "slab": _boxed(unwrapped, [BOX, BOX, 0.0]),
    }


def _run(module, cls, groups, chunk=CHUNK, **kwargs):
    """One run of `cls` of `module` (the port on the CPU) in chunks of
    `chunk` frames."""

    extra = {"device": "cpu"} if module is polymer else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = getattr(module, cls)(groups, verbose=False, **kwargs, **extra)
        n_atoms = sum(g.n_atoms for g in
                      (groups if isinstance(groups, list) else [groups]))
        a._chunk_bytes = chunk * n_atoms * 3 * 4
        return a.run()


def _pair(system, cls, groups, **kwargs):
    jax_u, port_u = system[:2]
    return (_run(jax_polymer, cls, groups(jax_u), **kwargs),
            _run(polymer, cls, groups(port_u), **kwargs))


def _all(u):
    return u.atoms


def _two(u):
    return [u.atoms[:3 * NP], u.atoms[3 * NP:]]


def _subset(u):
    return u.atoms[NP:4 * NP]


def _ragged_groups(u):
    return [u.atoms[:24], u.atoms[24:]]


def _atol_r(system):
    """4 eps32 max|r|: the float32 summation-order bound of the module
    docstring, over the coordinates the classes see (wrapped or
    unwrapped)."""

    return 4 * EPS32 * max(BOX, float(np.abs(system[2]).max()))


GYRADIUS_CASES = {
    "atoms": ("chains", _all, {}),
    "shape_unwrap": ("chains", _all, dict(shape=True, unwrap=True)),
    "components_unwrap": ("chains", _all, dict(components=True, unwrap=True)),
    "given": ("chains", _all, dict(n_chains=M, n_monomers=NP)),
    "two_groups_unwrap": ("chains", _two, dict(unwrap=True)),
    "subset_unwrap": ("chains", _subset, dict(unwrap=True, shape=True)),
    "ragged_given_unwrap": ("ragged", _ragged_groups,
                            dict(n_chains=[3, 2], n_monomers=[8, 6],
                                 unwrap=True)),
    "residues_unwrap": ("residues", _all,
                        dict(groupings="residues", unwrap=True, shape=True)),
    "residues_given": ("residues", lambda u: [u.atoms[:24], u.atoms[24:]],
                       dict(groupings=("residues", "atoms"), n_chains=[2, 2],
                            n_monomers=[6, 12])),
}


@pytest.mark.parametrize("case", list(GYRADIUS_CASES))
def test_gyradius_matches_jax(request, case):
    name, groups, kwargs = GYRADIUS_CASES[case]
    system = request.getfixturevalue(name)
    j, p = _pair(system, "Gyradius", groups, **kwargs)
    atol = _atol_r(system)
    assert p.results.gyradii.shape == j.results.gyradii.shape
    np.testing.assert_allclose(p.results.gyradii, j.results.gyradii,
                               rtol=0, atol=atol)
    if kwargs.get("shape"):
        for key in ("asphericity", "acylindricity"):
            np.testing.assert_allclose(p.results[key], j.results[key],
                                       rtol=0, atol=SHAPE_ATOL)
        np.testing.assert_allclose(p.results.shape_anisotropy,
                                   j.results.shape_anisotropy, rtol=0,
                                   atol=SHAPE_ATOL / BOX)
    assert set(p.results.units) == set(j.results.units)


def test_gyradius_shape_is_closed_form():
    """The closed-form invariants against numpy's eigenvalues in float64
    (a rod, a sphere-like and random tensors), and the components and
    shape options exclude each other."""

    rng = np.random.default_rng(3)
    a = rng.normal(size=(50, 3, 3))
    tensors = np.concatenate((a @ np.swapaxes(a, 1, 2),
                              np.diag([4.0, 1e-9, 1e-9])[None],
                              np.eye(3)[None]))
    b, c, kappa2 = polymer._shape_descriptors(torch.as_tensor(tensors))
    lam = np.linalg.eigvalsh(tensors)[:, ::-1]
    np.testing.assert_allclose(b.numpy(), lam[:, 0] - 0.5 * (lam[:, 1]
                                                             + lam[:, 2]),
                               atol=1e-7 * lam.max())
    np.testing.assert_allclose(c.numpy(), lam[:, 1] - lam[:, 2],
                               atol=1e-7 * lam.max())
    assert abs(float(kappa2[-2]) - 1.0) < 1e-8
    assert abs(float(kappa2[-1])) < 1e-12
    u = Universe.from_arrays(np.zeros((1, 4, 3), np.float32), [5.0] * 3)
    with pytest.raises(ValueError, match="mutually exclusive"):
        polymer.Gyradius(u.atoms, n_chains=1, n_monomers=4, shape=True,
                         components=True, device="cpu")


E2E_CASES = {
    "atoms": ("chains", _all, {}),
    "unwrap_two_blocks": ("chains", _all, dict(unwrap=True, n_blocks=2)),
    "shift_unwrap": ("chains", _all, dict(unwrap=True, fft=False)),
    "two_groups_given_unwrap": ("chains", _two,
                                dict(n_chains=[3, 2], n_monomers=NP,
                                     unwrap=True)),
    "subset": ("chains", _subset, dict(n_blocks=2)),
    "residues_unwrap": ("residues", _all,
                        dict(groupings="residues", unwrap=True)),
}


@pytest.mark.parametrize("case", list(E2E_CASES))
def test_end_to_end_vector_matches_jax(request, case):
    """Of atoms, the stored end-to-end vectors are the JAX package's bits
    (the same float32 ends and unwraps) and the ACFs of the same float64
    unit vectors agree within 1e-12.  Residue centers of mass round
    otherwise in the JAX package's compiled update (an ulp here and there):
    vectors within atol_r, ACFs within 4 atol_r / min |R|."""

    name, groups, kwargs = E2E_CASES[case]
    system = request.getfixturevalue(name)
    j, p = _pair(system, "EndToEndVector", groups, **kwargs)
    np.testing.assert_array_equal(p.results.times, j.results.times)
    if kwargs.get("groupings") != "residues":
        np.testing.assert_array_equal(p._e2e, j._e2e)
        atol = 1e-12
    else:
        atol = _atol_r(system)
        np.testing.assert_allclose(p._e2e, j._e2e, rtol=0, atol=atol)
        atol = 4 * atol / np.linalg.norm(j._e2e, axis=-1).min()
    np.testing.assert_allclose(p.results.acf, j.results.acf, rtol=0,
                               atol=atol)


ROUSE_CASES = {
    "atoms": ("chains", _all, {}),
    "wrapped": ("chains", _all, dict(unwrap=False, n_modes=3)),
    "two_blocks_shift": ("chains", _all,
                         dict(n_blocks=2, fft=False, n_modes=4)),
    "two_groups": ("chains", _two, dict(n_modes=5)),
    "subset": ("chains", _subset, {}),
    "ragged_given": ("ragged", _ragged_groups,
                     dict(n_chains=[3, 2], n_monomers=[8, 6])),
    "residues": ("residues", _all, dict(groupings="residues")),
}


@pytest.mark.parametrize("case", list(ROUSE_CASES))
def test_rouse_modes_match_jax(request, case):
    """Amplitudes within atol_r (the rows sum to zero: the error follows
    max |r|); mean-square amplitudes within 2 max|X| atol_r; normalized
    ACFs within 4 atol_r / min|X_p| (the lag-0 normalization)."""

    name, groups, kwargs = ROUSE_CASES[case]
    system = request.getfixturevalue(name)
    j, p = _pair(system, "RouseModes", groups, **kwargs)
    atol = _atol_r(system)
    for pa, ja in zip(p._amps, j._amps):
        np.testing.assert_allclose(pa, ja, rtol=0, atol=atol)
    msa = j.results.mean_square_amplitudes
    np.testing.assert_allclose(p.results.mean_square_amplitudes, msa,
                               rtol=0, atol=2 * np.sqrt(msa.max()) * atol)
    np.testing.assert_allclose(p.results.acf, j.results.acf, rtol=0,
                               atol=4 * atol / np.sqrt(msa.min()))
    np.testing.assert_array_equal(p.results.times, j.results.times)


PERSISTENCE_CASES = {
    "atoms": ("chains", _all, {}),
    "unwrap": ("chains", _all, dict(unwrap=True)),
    "two_groups": ("chains", _two, {}),
    "subset_given": ("chains", _subset, dict(n_chains=3, n_monomers=NP)),
    "residues_unwrap": ("residues", _all,
                        dict(groupings="residues", unwrap=True)),
    "ragged": ("ragged", _ragged_groups, {}),
    "triclinic": ("triclinic", _all, {}),
    "npt": ("npt", _all, {}),
    "slab": ("slab", _all, {}),
}


def _system(request, name):
    if name in ("triclinic", "npt", "slab"):
        jax_u, port_u = request.getfixturevalue("boxes")[name]
        return jax_u, port_u, request.getfixturevalue("chains")[2]
    return request.getfixturevalue(name)


@pytest.mark.parametrize("case", list(PERSISTENCE_CASES))
def test_persistence_length_matches_jax(request, case):
    """Bond autocorrelations within 1e-6 (unit vectors, float32 Gram sums
    in JAX, float64 in the port), mean bond lengths within rtol 1e-6, and
    the fitted persistence lengths within rtol 1e-5."""

    name, groups, kwargs = PERSISTENCE_CASES[case]
    j, p = _pair(_system(request, name), "PersistenceLength", groups,
                 **kwargs)
    assert len(p.results.bond_acf) == len(j.results.bond_acf)
    for pa, ja in zip(p.results.bond_acf, j.results.bond_acf):
        np.testing.assert_allclose(pa, ja, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p.results.bond_lengths,
                               j.results.bond_lengths, rtol=1e-6)
    for a in (j, p):
        a.calculate_persistence_length()
    np.testing.assert_allclose(p.results.persistence_lengths,
                               j.results.persistence_lengths, rtol=1e-5)
    for pf, jf in zip(p.results.fit, j.results.fit):
        np.testing.assert_allclose(pf, jf, rtol=1e-5, atol=1e-8)


MSID_CASES = {
    "atoms": ("chains", _all, {}),
    "given": ("chains", _all, dict(n_chains=M, n_monomers=NP)),
    "subset": ("chains", _subset, {}),
    "residues": ("residues", _all, dict(groupings="residues")),
    "ragged": ("ragged", _ragged_groups, {}),
    "triclinic": ("triclinic", _all, {}),
    "npt": ("npt", _all, {}),
    "slab": ("slab", _all, {}),
}


@pytest.mark.parametrize("case", list(MSID_CASES))
def test_internal_distances_match_jax(request, case):
    """MSID(s) within 1e-6 of its largest value (float32 Gram sums in JAX,
    float64 in the port); ragged groups give lists as in the JAX class."""

    name, groups, kwargs = MSID_CASES[case]
    j, p = _pair(_system(request, name), "MeanSquareInternalDistance",
                 groups, **kwargs)
    assert type(p.results.msid) is type(j.results.msid)
    for pm, jm, ps, js in zip(p.results.msid, j.results.msid,
                              p.results.separations, j.results.separations):
        np.testing.assert_array_equal(ps, js)
        np.testing.assert_allclose(pm, jm, rtol=0, atol=1e-6 * jm.max())


def _oracle_scsf(frames, qs32, n_chains, n_monomers):
    """float64 single-chain S(q) of float32 positions ``(T, N, 3)`` on
    float32-rounded wavevectors, before the wavenumber average."""

    raw = np.zeros(len(qs32))
    q = qs32.astype(np.float64)
    for frame in frames.astype(np.float64):
        for chain in frame.reshape(n_chains, n_monomers, 3):
            phases = q @ chain.T
            raw += np.cos(phases).sum(1) ** 2 + np.sin(phases).sum(1) ** 2
    return raw / (n_chains * n_monomers * len(frames))


@pytest.fixture(scope="module")
def far(chains):
    """The chains' unwrapped positions moved 1,000 A out along each axis
    (pre-unwrapped input far from the origin), in float32."""

    frames = (chains[2] + 1000.0).astype(np.float32)
    dims = np.array([BOX] * 3 + [90.0] * 3)
    return (*_universes(frames, dims, _chain_topology([NP] * M)),
            frames)


SCSF_CASES = {
    "atoms": ("chains", dict(n_points=4), True),
    "unwrap": ("chains", dict(n_points=4, unwrap=True), False),
    "far": ("far", dict(n_points=4), True),
    "residues_unwrap": ("residues", dict(grouping="residues", n_points=3,
                                         unwrap=True), False),
    "subset_given": ("chains", dict(n_points=3, n_chains=3, n_monomers=NP,
                                    unwrap=True), False),
    "fast": ("chains", dict(n_points=3, precision="fast"), False),
    "exact_dimensions": ("chains", dict(n_points=3, precision="exact",
                                        dimensions=[BOX, BOX, 2 * BOX]),
                         False),
}


@pytest.mark.parametrize("case", list(SCSF_CASES))
def test_single_chain_structure_factor_matches_jax(request, case):
    """Against the JAX class within rtol 1e-5 of the largest value; the
    cases on the given float32 positions also against the float64 oracle
    within 1e-6 of it, on wavevectors rounded to float32 as both classes
    round them.  At 1,000 A from the origin a float32 phase q . r of some
    600 rad is 3e-5 rad off: only the exact phases meet the oracle."""

    name, kwargs, oracle = SCSF_CASES[case]
    system = request.getfixturevalue(name)
    groups = _subset if "n_chains" in kwargs else _all
    j, p = _pair(system, "SingleChainStructureFactor", groups, **kwargs)
    np.testing.assert_array_equal(p.results.wavenumbers,
                                  j.results.wavenumbers)
    scale = np.abs(j.results.scsf).max()
    np.testing.assert_allclose(p.results.scsf, j.results.scsf, rtol=0,
                               atol=1e-5 * scale)
    if oracle:
        frames = p._trajectory.read_frames(np.arange(T))[0]
        qs32 = p._wavevectors.astype(np.float32)
        raw = _oracle_scsf(frames, qs32, M, NP)
        ref = np.array([raw[p._q_group == k].mean()
                        for k in range(len(p.results.wavenumbers))])
        np.testing.assert_allclose(p.results.scsf, ref, rtol=0,
                                   atol=1e-6 * scale)


def test_single_chain_structure_factor_blocks(chains, monkeypatch):
    """Launch blocks of chain-frames sized to the workspace: with room for
    7 chain-frames a launch, every launch takes at most 7 (float32
    wavevectors, exact), and the sums equal one block's within 1e-14."""

    _, u, _ = chains
    ref = _run(polymer, "SingleChainStructureFactor", u.atoms, n_points=3,
               unwrap=True)
    calls = []
    wrapped = polymer.trig_sums

    def recording(qs, positions, *args, **kwargs):
        calls.append((qs.dtype, positions.shape, kwargs["precision"]))
        return wrapped(qs, positions, *args, **kwargs)

    monkeypatch.setattr(polymer, "trig_sums", recording)
    n_q = 27
    monkeypatch.setattr(polymer.SingleChainStructureFactor,
                        "_workspace_bytes", 7 * 2 * n_q * 8)
    blocked = _run(polymer, "SingleChainStructureFactor", u.atoms,
                   n_points=3, unwrap=True)
    assert {c[0] for c in calls} == {torch.float32}
    assert {c[2] for c in calls} == {"exact"}
    assert max(c[1][0] for c in calls) == 7
    assert sum(c[1][0] for c in calls) == T * M
    np.testing.assert_allclose(blocked.results.scsf, ref.results.scsf,
                               rtol=1e-14)


def test_guinier_radius_matches_jax():
    """The JAX test's ideal chains (40 of 20 monomers, 60 A box): the
    Guinier radius and its window as the JAX class's, and near the
    real-space radius of gyration."""

    rng = np.random.default_rng(101)
    m, n_p, box, n_frames = 40, 20, 60.0, 4
    steps = rng.normal(size=(n_frames, m, n_p - 1, 3))
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    starts = rng.random((n_frames, m, 1, 3)) * box
    chains = np.concatenate([starts, starts + np.cumsum(steps, axis=2)],
                            axis=2)
    frames = chains.reshape(n_frames, m * n_p, 3).astype(np.float32)
    jax_u, port_u = _universes(frames, np.array([box] * 3), {})
    kwargs = dict(n_chains=m, n_monomers=n_p, n_points=5)
    j = _run(jax_polymer, "SingleChainStructureFactor", jax_u.atoms, **kwargs)
    p = _run(polymer, "SingleChainStructureFactor", port_u.atoms, **kwargs)
    rg_j, rg_p = j.calculate_guinier_radius(), p.calculate_guinier_radius()
    assert rg_p == pytest.approx(rg_j, rel=1e-6)
    np.testing.assert_array_equal(p.results.guinier_fit_q,
                                  j.results.guinier_fit_q)
    com = chains.mean(axis=2, keepdims=True)
    assert rg_p == pytest.approx(
        np.sqrt(((chains - com) ** 2).sum(axis=-1).mean()), rel=0.12)
    assert "results.guinier_radius" in p.results.units
    with pytest.raises(RuntimeError, match="run"):
        polymer.SingleChainStructureFactor(
            port_u.atoms, device="cpu", **kwargs).calculate_guinier_radius()


@pytest.fixture(scope="module")
def relaxing():
    """Six stiff chains of 10 monomers whose conformations decorrelate as
    0.85^t over 40 frames: end-to-end, Rouse and bond correlations that
    the fits resolve."""

    frames, unwrapped = polymer_chains(np.random.default_rng(5), 6, 10, 40,
                                       BOX, stiffness=0.7, memory=0.85,
                                       drift=0.3)
    dims = np.array([BOX] * 3 + [90.0] * 3)
    return (*_universes(frames, dims, _chain_topology([10] * 6)), unwrapped)


@pytest.mark.parametrize("cls", ["EndToEndVector", "RouseModes"])
def test_relaxation_times_match_jax(relaxing, cls):
    """calculate_relaxation_time on two blocks (and, for the Rouse modes,
    three modes) as the JAX class's, within rtol 1e-5 (fits of ACFs
    equal within their tolerances above)."""

    kwargs = dict(n_blocks=2, unwrap=True)
    if cls == "RouseModes":
        kwargs["n_modes"] = 3
    j, p = _pair(relaxing, cls, _all, chunk=8, **kwargs)
    for a in (j, p):
        a.calculate_relaxation_time()
    assert np.all(np.isfinite(p.results.relaxation_times))
    np.testing.assert_allclose(p.results.relaxation_times,
                               j.results.relaxation_times, rtol=1e-5)
    assert "results.relaxation_times" in p.results.units


def test_calculate_relaxation_time_matches_jax():
    times = np.arange(50.0)
    for acf in (np.exp(-times / 5.0), np.exp(-(times / 7.0) ** 0.6)):
        assert polymer.calculate_relaxation_time(times, acf) == (
            pytest.approx(jax_polymer.calculate_relaxation_time(times, acf),
                          rel=1e-10))


def test_trio_runs_together(chains):
    """bench.py's config-5 trio through run_together gives each class's
    own run() results (the extras stored from one stream)."""

    _, u, _ = chains
    kwargs = dict(n_chains=M, n_monomers=NP, verbose=False, device="cpu")
    make = [
        lambda: polymer.Gyradius(u.atoms, **kwargs),
        lambda: polymer.EndToEndVector(u.atoms, **kwargs),
        lambda: polymer.RouseModes(u.atoms, n_modes=4, **kwargs),
    ]
    fused = [f() for f in make]
    for a in fused:
        a._chunk_bytes = CHUNK * u.atoms.n_atoms * 12
    run_together(fused)
    for f, a in zip(make, fused):
        alone = f()
        alone._chunk_bytes = a._chunk_bytes
        alone.run()
        for key, value in alone.results.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(a.results[key], value)


def test_time_step_quantities(chains):
    """``dt`` as a Quantity: the port converts it; the JAX classes take
    ``dt or trajectory.dt``, and a scalar Quantity has no truth value
    there (``Quantity.__len__`` of a float), so they raise TypeError."""

    jax_u, u, _ = chains
    for cls in ("EndToEndVector", "RouseModes"):
        a = _run(polymer, cls, u.atoms, dt=Q_(500.0, "fs"))
        np.testing.assert_allclose(a.results.times, 0.5 * np.arange(T),
                                   rtol=1e-15)
        b = _run(polymer, cls, u.atoms, dt=2.0)
        np.testing.assert_array_equal(b.results.times, 2.0 * np.arange(T))
        with pytest.raises(TypeError):
            getattr(jax_polymer, cls)(jax_u.atoms, dt=JQ(500.0, "fs"),
                                      verbose=False)


def test_parallel_runs_serially_or_raises(chains):
    """EndToEndVector and RouseModes take ``parallel`` and ignore it, as
    the JAX classes do, and accept and ignore the JAX runtime's other
    keywords (ROADMAP Queue 1, item 10b-2); the four classes on the
    sharded base run ``parallel=True`` (item 10b-1) as a world of one
    without a process group, equal to their serial runs."""

    _, u, _ = chains
    for cls in ("EndToEndVector", "RouseModes"):
        a = _run(polymer, cls, u.atoms, parallel=True)
        b = _run(polymer, cls, u.atoms)
        np.testing.assert_array_equal(a.results.acf, b.results.acf)
        c = _run(polymer, cls, u.atoms, mesh=None)
        np.testing.assert_array_equal(c.results.acf, b.results.acf)
    for cls, key in (("Gyradius", "gyradii"),
                     ("SingleChainStructureFactor", "scsf"),
                     ("PersistenceLength", "bond_lengths"),
                     ("MeanSquareInternalDistance", "msid")):
        a = _run(polymer, cls, u.atoms, parallel=True)
        b = _run(polymer, cls, u.atoms)
        assert a._mesh.world == 1
        np.testing.assert_array_equal(a.results[key], b.results[key])


def test_validation_matches_jax(chains):
    """The classes refuse what the JAX classes refuse, with the same
    messages."""

    jax_u, u, _ = chains
    cases = [
        ("Gyradius", dict(groupings="segments"), "Invalid grouping"),
        ("Gyradius", dict(groupings=("atoms", "atoms")), "number of grouping"),
        ("Gyradius", dict(n_chains=[5, 5], n_monomers=NP),
         "chain/monomer counts"),
        ("RouseModes", dict(n_modes=NP), "'n_modes' must be between"),
        ("PersistenceLength", dict(n_chains=20, n_monomers=2),
         "at least 3"),
        ("MeanSquareInternalDistance", dict(n_chains=40, n_monomers=1),
         "at least 2"),
        ("SingleChainStructureFactor", dict(precision="double"),
         "Invalid precision"),
        ("SingleChainStructureFactor", dict(dimensions=[BOX, BOX]),
         "length 3"),
    ]
    for cls, kwargs, match in cases:
        with pytest.raises(ValueError, match=match):
            getattr(jax_polymer, cls)(jax_u.atoms, verbose=False, **kwargs)
        with pytest.raises(ValueError, match=match):
            getattr(polymer, cls)(u.atoms, device="cpu", **kwargs)
    boxless = Universe.from_arrays(np.zeros((1, 6, 3), np.float32))
    with pytest.raises(ValueError, match="box dimensions"):
        polymer.PersistenceLength(boxless.atoms, n_chains=2, n_monomers=3,
                                  unwrap=True, device="cpu")
    with pytest.raises(RuntimeError, match="run"):
        polymer.PersistenceLength(
            u.atoms, device="cpu").calculate_persistence_length()


def test_wavevectors_are_the_jax_grid(chains):
    _, u, _ = chains
    a = polymer.SingleChainStructureFactor(u.atoms, n_points=5,
                                           device="cpu")
    np.testing.assert_array_equal(a._wavevectors,
                                  _wavevector_grid([BOX] * 3, 5))
    np.testing.assert_array_equal(
        a._wavevectors, np.asarray(jax_polymer._wavevector_grid(
            np.array([BOX] * 3), 5)))



@pytest.mark.parametrize("dims", [[20.0, 21.0, 22.0, 90.0, 90.0, 90.0],
                                  [20.0, 21.0, 22.0, 80.0, 75.0, 70.0],
                                  [20.0, 21.0, 0.0, 90.0, 90.0, 90.0]],
                         ids=["orthorhombic", "triclinic", "slab"])
def test_min_image_vectors_equal_jax(dims):
    """The folded bonds and their lengths agree with the JAX package's,
    one box at a time and with per-frame boxes broadcast over a batch of
    frames as the polymer classes pass them (which equals the former
    bit for bit)."""

    rng = np.random.default_rng(9)
    delta = (rng.normal(size=(3, 4, 7, 3)) * 15.0).astype(np.float32)
    triclinic = dims[3] != 90.0
    frames = np.array([dims, dims, dims], dtype=np.float64)
    frames[1, :3] *= 1.05
    frames[2, :2] *= 0.9
    boxes = (np.asarray(jax_triclinic_matrices(frames)) if triclinic
             else frames[:, :3]).astype(np.float32)
    ref = np.stack([np.asarray(jax_histogram._min_image_vectors(
        jnp.asarray(d), jnp.asarray(b))) for d, b in zip(delta, boxes)])
    one_by_one = np.stack([histogram._min_image_vectors(
        torch.from_numpy(d), torch.from_numpy(b)).numpy()
        for d, b in zip(delta, boxes)])
    batched = histogram._min_image_vectors(
        torch.from_numpy(delta), torch.from_numpy(boxes)[:, None, None])
    np.testing.assert_array_equal(batched.numpy(), one_by_one)
    # A triclinic fold is two float32 matrix products, which XLA's CPU dot
    # rounds in another order than the port's elementwise rows: within
    # 4 eps32 of the longest box edge; an orthorhombic fold is exact.
    atol = 4 * EPS32 * float(frames[:, :3].max()) if triclinic else 0.0
    np.testing.assert_allclose(one_by_one, ref, rtol=0, atol=atol)
    lengths = histogram._min_image_distance(
        torch.from_numpy(delta), torch.from_numpy(boxes)[:, None, None])
    ref_lengths = np.stack([np.asarray(jax_histogram._min_image_distance(
        jnp.asarray(d), jnp.asarray(b))) for d, b in zip(delta, boxes)])
    np.testing.assert_allclose(lengths.numpy(), ref_lengths, rtol=0,
                               atol=atol)
