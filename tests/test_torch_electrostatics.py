"""The port's dipole moments, permittivity and dielectric spectrum against
the JAX package's.

The same seeded float32 trajectory of SPC/E waters (10 x 12 x 14 A box,
molecules split across its faces) goes through
``mdhelper_tpu.analysis.electrostatics`` (streaming float32 on the CPU)
and its port.  The JAX package sums float32 products of float32 charges
in float32, the port float64 products of the float64 charges in float64,
so the dipoles are held:

* to the JAX package's within the float32 summation bound ``(n + 2) u
  sum_i |q_i| |r_i|`` a component (``u = 2^-24``, ``n`` atoms a group);
* to a numpy float64 sum over the same float32 (unwrapped) positions
  within ``rtol=1e-12``, with an absolute floor of ``1e-13 sum_i |q_i|
  |r_i|`` for components that cancel to near zero.

The permittivity and dielectric spectrum functions take the same dipole
series in both packages and agree within ``rtol=1e-10``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import electrostatics as jax_es  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.algorithm.topology import unwrap_edge  # noqa: E402
from mdhelper_tpu_torch.analysis import electrostatics  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.testing import water_system  # noqa: E402

BOX = np.array([10.0, 12.0, 14.0])
N_MOL, N_FRAMES, CHUNK = 100, 9, 2
U32 = 2.0**-24


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


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(77)
    frames, topology = water_system(rng, N_MOL, 10.0, N_FRAMES, step=0.8,
                                    charges=True)
    frames = np.mod(frames * (BOX / 10.0), BOX).astype(np.float32)
    dims = np.concatenate([BOX, [90.0] * 3])
    ju = JaxUniverse.from_arrays(frames.astype(np.float64), dims, dt=0.25,
                                 **topology)
    tu = Universe.from_arrays(frames, dims, dt=0.25, **topology)
    return ju, tu, frames, topology


#: per-atom charges with a net -0.4 e on every molecule.
CHARGED = np.tile([-1.0, 0.3, 0.3], N_MOL)

DIPOLE_CASES = {
    "atoms": (lambda u: u.atoms, {}),
    "unwrap": (lambda u: u.atoms, dict(unwrap=True)),
    "neutralize": (lambda u: [u.atoms],
                   dict(charges=[CHARGED], neutralize=True, unwrap=True)),
    "subset_groups": (lambda u: [u.atoms[:150], u.atoms[151:]],
                      dict(charges=[0.5, -0.25])),
    "scaled_box": (lambda u: u.atoms,
                   dict(unwrap=True, dimensions=[10.0, 12.0, 14.0],
                        scales=(1.0, 2.0, 1.0))),
    "average": (lambda u: [u.atoms[0::3], u.atoms[1::3]],
                dict(average=True)),
}


def _run(cls, groups, kwargs, **extra):
    a = cls(groups, verbose=False, **kwargs, **extra)
    a._chunk_bytes = CHUNK * 3 * N_MOL * 3 * 4
    return a.run()


def _oracle(analysis, frames, box):
    """float64 dipoles ``(T, G, 3)`` of the float32 positions, unwrapped
    in float32 by image counts from the molecules made whole at the first
    frame when the analysis unwraps, and ``sum_i |q_i| |r_i|`` ``(G,
    3)``."""

    charges = analysis._effective_charges()
    ix = np.concatenate([g.ix for g in analysis._groups])
    pos = frames[:, ix]
    if analysis._unwrap:
        analysis.universe.trajectory[0]
        prev = np.concatenate([unwrap_edge(group=g)
                               for g in analysis._groups]).astype(np.float32)
        box = np.asarray(box, np.float32)
        images = np.zeros(prev.shape, np.int32)
        out = np.empty_like(pos)
        for t in range(len(pos)):
            delta = pos[t] - prev
            images -= np.where(np.abs(delta) >= box / np.float32(2),
                               np.sign(delta), 0).astype(np.int32)
            prev = pos[t]
            out[t] = pos[t] + images.astype(np.float32) * box
        pos = out
    dipoles, scales = [], []
    for s, q in zip(analysis._slices, charges):
        p64 = pos[:, s].astype(np.float64)
        dipoles.append((q[:, None] * p64).sum(1))
        scales.append(np.abs(q[:, None] * p64).sum(1).max(0))
    return np.stack(dipoles, axis=1), np.stack(scales)


@pytest.mark.parametrize("case", list(DIPOLE_CASES))
def test_dipoles_equal_jax_and_f64_oracle(system, case):
    ju, tu, frames, _ = system
    groups, kwargs = DIPOLE_CASES[case]
    j = _run(jax_es.DipoleMoment, groups(ju), kwargs)
    p = _run(electrostatics.DipoleMoment, groups(tu), kwargs, device="cpu")
    box = BOX * np.asarray(kwargs.get("scales", 1.0))
    oracle, scale = _oracle(p, frames, box)
    n = max(int(n) for n in p._Ns)
    if kwargs.get("average"):
        oracle = oracle.mean(axis=0)
        np.testing.assert_allclose(p.results.volumes, BOX.prod(),
                                   rtol=1e-12)
    else:
        np.testing.assert_allclose(p.results.volumes,
                                   np.full(N_FRAMES, BOX.prod()), rtol=1e-12)
        np.testing.assert_array_equal(p.results.times, j.results.times)
    np.testing.assert_allclose(p.results.dipoles, oracle, rtol=1e-12,
                               atol=1e-13 * scale.max())
    np.testing.assert_allclose(p.results.dipoles, j.results.dipoles,
                               rtol=0, atol=(n + 2) * U32 * scale.max())
    assert np.abs(p.results.dipoles).max() > 1.0


def test_unwrap_makes_molecules_whole(system):
    """With unwrap=True every molecule's dipole is a small 3-site one: the
    O-H vectors (0.96 A, stretched at most 1.4 times) stay within 1.5 A
    whatever the box faces do, so a molecule's |M| <= 2 * 0.4238 * 1.5."""

    _, tu, _, _ = system
    per_mol = [tu.atoms[3 * i:3 * i + 3] for i in range(0, N_MOL, 10)]
    whole = _run(electrostatics.DipoleMoment, per_mol, dict(unwrap=True),
                 device="cpu")
    wrapped = _run(electrostatics.DipoleMoment, per_mol, {}, device="cpu")
    norms = np.linalg.norm(whole.results.dipoles, axis=-1)
    assert norms.max() <= 2 * 0.4238 * 1.5
    assert np.linalg.norm(wrapped.results.dipoles, axis=-1).max() > 2.0


def test_permittivity_equals_jax(system):
    ju, tu, _, _ = system
    j = _run(jax_es.DipoleMoment, ju.atoms, dict(unwrap=True))
    p = _run(electrostatics.DipoleMoment, tu.atoms, dict(unwrap=True),
             device="cpu")
    j.calculate_relative_permittivity(300.0)
    p.calculate_relative_permittivity(300.0)
    M = p.results.dipoles[:, 0]
    expected = jax_es.calculate_relative_permittivity(
        M, 300.0, p.results.volumes.mean())
    np.testing.assert_allclose(p.results.dielectric, expected, rtol=1e-12)
    # The JAX class's float32 dipoles move the fluctuation slightly.
    np.testing.assert_allclose(p.results.dielectric, j.results.dielectric,
                               rtol=1e-4)
    for reduced in (False, True):
        np.testing.assert_allclose(
            electrostatics.calculate_relative_permittivity(
                M, 1.3, p.results.volumes, reduced=reduced),
            jax_es.calculate_relative_permittivity(
                M, 1.3, p.results.volumes, reduced=reduced),
            rtol=1e-12)


@pytest.mark.parametrize("t_max", [None, 1.0])
@pytest.mark.parametrize("reduced", [False, True])
def test_dielectric_spectrum_equals_jax(t_max, reduced):
    rng = np.random.default_rng(3)
    # An Ornstein-Uhlenbeck dipole series (Debye relaxation).
    M = np.zeros((400, 3))
    for t in range(1, len(M)):
        M[t] = 0.9 * M[t - 1] + rng.normal(size=3)
    args = (M, 300.0, 3000.0, 0.1)
    ref = jax_es.calculate_dielectric_spectrum(*args, t_max=t_max,
                                               reduced=reduced)
    out = electrostatics.calculate_dielectric_spectrum(
        *args, t_max=t_max, reduced=reduced, device="cpu")
    for key in ("frequencies", "acf", "epsilon"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-10,
                                   atol=1e-12 * np.abs(ref[key]).max())
    np.testing.assert_allclose(out.delta_epsilon, ref.delta_epsilon,
                               rtol=1e-12)
    assert (out.units is None) == reduced
    with pytest.raises(ValueError, match="zero variance"):
        electrostatics.calculate_dielectric_spectrum(np.ones((10, 3)),
                                                     *args[1:], device="cpu")


def test_permittivity_guards(system):
    _, tu, frames, topology = system
    averaged = _run(electrostatics.DipoleMoment, tu.atoms,
                    dict(average=True), device="cpu")
    with pytest.raises(RuntimeError, match="averaged"):
        averaged.calculate_relative_permittivity(300.0)
    subset = _run(electrostatics.DipoleMoment, tu.atoms[:30], {},
                  device="cpu")
    with pytest.raises(RuntimeError, match="not all atoms"):
        subset.calculate_relative_permittivity(300.0)
    # One residue an atom: every residue is charged.
    ions = Universe.from_arrays(frames, np.concatenate([BOX, [90.0] * 3]),
                                charges=topology["charges"],
                                masses=topology["masses"])
    charged = _run(electrostatics.DipoleMoment, ions.atoms, {},
                   device="cpu")
    assert not charged._all_neutral
    with pytest.raises(RuntimeError, match="non-neutral"):
        charged.calculate_relative_permittivity(300.0)
    neutralized = _run(electrostatics.DipoleMoment, ions.atoms,
                       dict(neutralize=True), device="cpu")
    neutralized.calculate_relative_permittivity(300.0)
    assert neutralized.results.dielectric == 1.0


def test_parallel_raises(system):
    """``parallel=True`` (ROADMAP Queue 1, item 10b-1) no longer raises:
    without a process group it runs as a world of one, ``unwrap=True``
    too, and equals the serial run."""

    _, tu, _, _ = system
    for unwrap in (False, True):
        a, b = (electrostatics.DipoleMoment(
            tu.atoms, unwrap=unwrap, parallel=parallel, verbose=False,
            device="cpu").run() for parallel in (True, False))
        assert a._mesh.world == 1
        np.testing.assert_array_equal(a.results.dipoles, b.results.dipoles)
