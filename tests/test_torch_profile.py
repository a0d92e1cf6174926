"""The port's density profiles against the JAX package's classes.

The same seeded float32 trajectory of SPC/E-charged waters in a 10 x 12
x 14 A box (two of whose axes have float32 edges that ``torch.linspace``
misses) goes through ``mdhelper_tpu.analysis.profile`` (streaming float32,
``_coord_dtype`` set on the base class, on the CPU) and its port.  Counts
must be equal as integers (the number densities are then equal floats);
charge densities, potentials and PMFs within ``rtol=1e-10``.

With ``recenter`` the recentering group's center of mass is a float32
sum in an order XLA picks in the JAX package, and a float64 sum rounded
once in the port; the port's counts equal a numpy oracle of its own
arithmetic exactly, and the JAX package's within one entity moved by one
bin a frame.  The radial profile is also held against a float64 numpy
oracle.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import profile as jax_profile  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.analysis import profile  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops.profiles import linspace_edges_f32  # noqa: E402
from mdhelper_tpu_torch.testing import fma32, water_system  # noqa: E402

BOX = np.array([10.0, 12.0, 14.0])
N_MOL, N_FRAMES, CHUNK = 120, 7, 2


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


@pytest.fixture(scope="module")
def system():
    """``(jax universe, port universe, float32 frames, topology)``: waters
    of a 10 A cube stretched to the box, wrapped atom by atom."""

    rng = np.random.default_rng(2026)
    frames, topology = water_system(rng, N_MOL, 10.0, N_FRAMES, step=0.6,
                                    charges=True)
    frames = np.mod(frames * (BOX / 10.0), BOX).astype(np.float32)
    dims = np.concatenate([BOX, [90.0] * 3])
    ju = JaxUniverse.from_arrays(frames.astype(np.float64), dims, dt=0.5,
                                 **topology)
    tu = Universe.from_arrays(frames, dims, dt=0.5, **topology)
    return ju, tu, frames, topology


def _run(cls, args, kwargs, device=True):
    if device:
        kwargs = dict(kwargs, device="cpu")
    with warnings.catch_warnings():
        # Groups of mixed charges warn that no charge density follows.
        warnings.simplefilter("ignore")
        a = cls(*args, verbose=False, **kwargs)
        a._chunk_bytes = CHUNK * 3 * N_MOL * 3 * 4
        return a.run()


def _pair(system, cls_name, groups, kwargs):
    """The JAX and the port's runs of one class on the groups picked by
    ``groups(universe)``."""

    ju, tu, _, _ = system
    jax_kwargs = {k: (v(ju) if callable(v) else v)
                  for k, v in kwargs.items()}
    port_kwargs = {k: (v(tu) if callable(v) else v)
                   for k, v in kwargs.items()}
    j = _run(getattr(jax_profile, cls_name), (groups(ju),), jax_kwargs,
             device=False)
    p = _run(getattr(profile, cls_name), (groups(tu),), port_kwargs)
    return j, p


def _species(u):
    return [u.atoms[0::3], u.atoms[1::3]]


DENSITY_CASES = {
    "atoms": (_species, dict(n_bins=(20, 21, 22))),
    "subset": (lambda u: u.atoms[::5], dict(axes="z", n_bins=30)),
    "residues": (lambda u: u.atoms, dict(groupings="residues", axes="xz",
                                         n_bins=(16, 25))),
    "per_frame": (_species, dict(axes="y", n_bins=24, average=False)),
    "scaled": (_species, dict(axes=(2, 0), n_bins=18,
                              scales=(1.0, 1.0, 2.0), charges=[-1.0, 2.0])),
    "dimensions": (_species, dict(axes="z", n_bins=40,
                                  dimensions=[10.0, 12.0, 14.0])),
}


@pytest.mark.parametrize("case", list(DENSITY_CASES))
def test_density_profile_equals_jax(system, case):
    groups, kwargs = DENSITY_CASES[case]
    j, p = _pair(system, "DensityProfile", groups, kwargs)
    for a in range(len(p._axes)):
        np.testing.assert_array_equal(p.results.number_densities[a],
                                      j.results.number_densities[a])
        assert p.results.number_densities[a].sum() > 0
        np.testing.assert_allclose(p.results.bins[a], j.results.bins[a],
                                   rtol=0, atol=0)
        if j.results.charge_densities is None:
            assert p.results.charge_densities is None
        else:
            np.testing.assert_allclose(p.results.charge_densities[a],
                                       j.results.charge_densities[a],
                                       rtol=1e-10, atol=0)
    if not p._average:
        np.testing.assert_array_equal(p.results.times, j.results.times)


def test_density_profile_integrates_to_the_atom_count(system):
    """The number densities of a z profile sum, over the bins, to
    N n_bins / V: every wrapped atom lands in a bin."""

    _, tu, _, _ = system
    p = _run(profile.DensityProfile, (_species(tu),),
             dict(axes="z", n_bins=50))
    total = sum(d.sum() for d in p.results.number_densities[0])
    np.testing.assert_allclose(total, 2 * N_MOL * 50 / BOX.prod(),
                               rtol=1e-12)


def test_potential_and_pmf_equal_jax(system):
    j, p = _pair(system, "DensityProfile", _species,
                 dict(axes="z", n_bins=35))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for a in (j, p):
            a.calculate_potential_profile(78.0, "z")
            a.calculate_pmf(300.0)
    np.testing.assert_allclose(p.results.potentials[0],
                               j.results.potentials[0], rtol=1e-10, atol=0)
    for pmf, ref in zip(p.results.pmf, j.results.pmf):
        np.testing.assert_allclose(pmf, ref, rtol=1e-10, atol=0)
    for a in (j, p):
        a.calculate_potential_profile(78.0, 2, method="matrix", pbc=True,
                                      sigma_q=0.0)
        a.calculate_pmf(1.5, reference_densities=[0.01, 0.02])
    np.testing.assert_allclose(p.results.potentials[0],
                               j.results.potentials[0], rtol=1e-10, atol=0)
    for pmf, ref in zip(p.results.pmf, j.results.pmf):
        np.testing.assert_allclose(pmf, ref, rtol=1e-10, atol=0)
    assert str(p.results.units["results.potentials"]) == "volt"


@pytest.mark.parametrize("method", ["integral", "matrix"])
@pytest.mark.parametrize("reduced", [False, True])
def test_calculate_potential_profile_equals_jax(method, reduced):
    z = np.linspace(0.05, 9.95, 100)
    rho = 0.01 * np.sin(2 * np.pi * z / 10.0) + 0.002 * np.cos(z)
    kwargs = dict(method=method, reduced=reduced, dV=0.3)
    ref = jax_profile.calculate_potential_profile(z, rho, 10.0, 2.0,
                                                  **kwargs)
    out = profile.calculate_potential_profile(z, rho, 10.0, 2.0, **kwargs)
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=0)


@pytest.mark.parametrize("V0", [0.5, -2.0])
def test_integral_potential_with_offset_keeps_parity(V0):
    """method="integral" with V0 != 0 hands V0 to scipy's
    cumulative_trapezoid as ``initial``, which scipy >= 1.12 accepts only
    as None or 0: where this scipy rejects it, both packages raise its
    ValueError; where it takes it, both give the same profile (ROADMAP
    Queue 3, item 11)."""

    from scipy.integrate import cumulative_trapezoid

    z = np.linspace(0.05, 9.95, 100)
    rho = 0.01 * np.sin(2 * np.pi * z / 10.0)
    try:
        cumulative_trapezoid(rho, z, initial=V0)
        scipy_rejects = False
    except ValueError:
        scipy_rejects = True
    outcomes = []
    for module in (jax_profile, profile):
        try:
            outcomes.append(module.calculate_potential_profile(
                z, rho, 10.0, 2.0, method="integral", V0=V0))
        except ValueError as err:
            outcomes.append(err)
    if scipy_rejects:
        assert all(isinstance(o, ValueError) for o in outcomes)
        assert str(outcomes[0]) == str(outcomes[1])
    else:
        np.testing.assert_allclose(outcomes[1], outcomes[0], rtol=1e-10)


def _f32_coms(frames, seg, n, masses):
    """float32 centers of mass as the port reduces them: weighted float32
    positions summed member by member in atom order, from 0."""

    m = masses.astype(np.float32)
    weighted = frames * m[None, :, None]
    total = np.zeros((len(frames), n, frames.shape[-1]), np.float32)
    mass = np.zeros(n, np.float32)
    order = np.argsort(seg, kind="stable")
    rank = np.zeros(len(seg), dtype=int)
    for s in range(n):
        members = order[seg[order] == s]
        rank[members] = np.arange(len(members))
    for k in range(rank.max() + 1):
        sel = rank == k
        np.add.at(total, (slice(None), seg[sel]), weighted[:, sel])
        np.add.at(mass, seg[sel], m[sel])
    return total / mass[None, :, None]


def _oracle_entities(frames, topology, ix, grouping):
    if grouping == "atoms":
        return frames[:, ix]
    _, seg = np.unique(topology["resindices"][ix], return_inverse=True)
    return _f32_coms(frames[:, ix], seg, seg.max() + 1,
                     topology["masses"][ix])


def _oracle_recentered_counts(frames, topology, groups, grouping, rec,
                              target, n_bins):
    """The port's recentering in numpy: per frame, the float32 image-count
    unwrap of the entities, the float64 center of mass of group `rec`
    rounded to float32, the float32 shift and wrap, and ``numpy.histogram``
    on the float32 edges; counts ``[axis][group, bin]``."""

    f32 = np.float32
    box = BOX.astype(f32)
    ents = [_oracle_entities(frames, topology, g, grouping) for g in groups]
    sizes = [e.shape[1] for e in ents]
    ent = np.concatenate(ents, axis=1)
    lo = int(np.sum(sizes[:rec]))
    rec_ix = groups[rec]
    if grouping == "atoms":
        masses = topology["masses"][rec_ix]
        first = frames[0, np.concatenate(groups)]
    else:
        _, seg = np.unique(topology["resindices"][rec_ix],
                           return_inverse=True)
        masses = np.bincount(seg, weights=topology["masses"][rec_ix])
        first = np.concatenate([
            _f64_coms(frames[0, g], topology, g) for g in groups
        ]).astype(f32)
    prev = first.astype(f32)
    images = np.zeros(ent.shape[1:], np.int32)
    edges = [linspace_edges_f32(BOX[a], n_bins) for a in range(3)]
    counts = [np.zeros((len(groups), n_bins), np.int64) for _ in range(3)]
    for t in range(len(ent)):
        delta = ent[t] - prev
        images = images - np.where(np.abs(delta) >= box / f32(2),
                                   np.sign(delta), 0).astype(np.int32)
        prev = ent[t]
        unwrapped = ent[t] + images.astype(f32) * box
        rec_pos = unwrapped[lo:lo + sizes[rec]].astype(np.float64)
        com = ((masses[:, None] * rec_pos).sum(0) / masses.sum()).astype(f32)
        shifted = unwrapped - (com - target.astype(f32))
        # the port's wrap: the product and the difference rounded once
        wrapped = fma32(-np.floor(shifted / box), box, shifted)
        start = 0
        for g, size in enumerate(sizes):
            for a in range(3):
                counts[a][g] += np.histogram(
                    wrapped[start:start + size, a], bins=edges[a])[0]
            start += size
    return counts


def _f64_coms(positions, topology, ix):
    _, seg = np.unique(topology["resindices"][ix], return_inverse=True)
    m = topology["masses"][ix]
    com = np.zeros((seg.max() + 1, 3))
    np.add.at(com, seg, m[:, None] * positions.astype(np.float64))
    return com / np.bincount(seg, weights=m)[:, None]


RECENTER_CASES = {
    "index": (dict(recenter=0), "atoms", 0, None),
    "group_target": (dict(recenter=lambda u: (u.atoms[1::3], (4.0, 5.0,
                                                              6.0))),
                     "atoms", 1, np.array([4.0, 5.0, 6.0])),
    "residues": (dict(recenter=1, groupings="residues"), "residues", 1,
                 None),
}


@pytest.mark.parametrize("case", list(RECENTER_CASES))
def test_recentered_profile(system, case):
    kwargs, grouping, rec, target = RECENTER_CASES[case]
    _, tu, frames, topology = system
    n_bins = 20
    if grouping == "atoms":
        groups = _species
        index_groups = [np.arange(0, 3 * N_MOL, 3), np.arange(1, 3 * N_MOL, 3)]
    else:
        def groups(u):
            return [u.atoms[:150], u.atoms[150:]]
        index_groups = [np.arange(150), np.arange(150, 3 * N_MOL)]
    j, p = _pair(system, "DensityProfile", groups,
                 dict(kwargs, n_bins=n_bins))
    target = BOX / 2 if target is None else target
    oracle = _oracle_recentered_counts(frames, topology, index_groups,
                                       grouping, rec, target, n_bins)
    volume = BOX.prod()
    for a in range(3):
        scale = n_bins / volume / N_FRAMES
        counts = p.results.number_densities[a] / scale
        np.testing.assert_array_equal(np.round(counts), oracle[a])
        np.testing.assert_allclose(counts, oracle[a], rtol=1e-12)
        jax_counts = np.round(j.results.number_densities[a] / scale)
        assert jax_counts.sum() == oracle[a].sum()
        # Each entity the float32 center sums move crosses one edge: two
        # bins change by one.  At most one such entity a frame.
        assert np.abs(jax_counts - oracle[a]).sum() <= 2 * N_FRAMES


def _rdp_oracle(frames, topology, group_ix, grouping, center, edges,
                geometry, axis):
    """float64 histogram of the minimum-image distances of the float32
    entities from the float32 center (a fixed float point, or the float32
    center of mass of the atoms indexed by the integers `center`) in each
    frame's box: full 3-D (spherical) or with the axis dropped
    (cylindrical)."""

    ent = _oracle_entities(frames, topology, group_ix, grouping)
    if center.dtype.kind == "f":
        centers = np.broadcast_to(center.astype(np.float32),
                                  (len(frames), 3))
    else:
        centers = _f32_coms(frames[:, center], np.zeros(len(center), int),
                            1, topology["masses"][center])[:, 0]
    box = BOX.astype(np.float32).astype(np.float64)
    d = ent.astype(np.float64) - centers[:, None].astype(np.float64)
    d -= box * np.round(d / box)
    if geometry == "cylindrical":
        d[..., axis] = 0.0
    return np.histogram(np.sqrt((d**2).sum(-1)), bins=edges)[0]


RADIAL_CASES = {
    "spherical_point": (dict(center=np.array([5.0, 6.0, 7.0])), "atoms"),
    "cylindrical_point": (dict(center=np.array([2.0, 11.5, 0.0]),
                               geometry="cylindrical"), "atoms"),
    "spherical_com": (dict(center=lambda u: u.atoms[30:33]), "atoms"),
    "cylindrical_com_residues": (
        dict(center=lambda u: u.atoms[:6], geometry="cylindrical", axis="x",
             groupings="residues"), "residues"),
}


@pytest.mark.parametrize("case", list(RADIAL_CASES))
def test_radial_profile_equals_jax_and_f64_oracle(system, case):
    kwargs, grouping = RADIAL_CASES[case]
    _, _, frames, topology = system
    j, p = _pair(system, "RadialDensityProfile", _species,
                 dict(kwargs, n_bins=40, range=(0.0, 6.0)))
    assert p.results.counts.dtype == np.int64
    np.testing.assert_array_equal(p.results.counts, j.results.counts)
    np.testing.assert_allclose(p.results.number_densities,
                               j.results.number_densities, rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(p.results.charge_densities,
                               j.results.charge_densities, rtol=1e-10,
                               atol=1e-300)
    center = kwargs["center"]
    center = (np.arange(30, 33) if case == "spherical_com"
              else np.arange(6) if callable(center) else center)
    axis = p._axis
    for g, start in enumerate((0, 1)):
        ix = np.arange(start, 3 * N_MOL, 3)
        oracle = _rdp_oracle(frames, topology, ix, grouping, center,
                             p.results.edges, p._geometry, axis)
        np.testing.assert_array_equal(p.results.counts[g], oracle)
        assert oracle.sum() > 0
    for a in (j, p):
        a.calculate_pmf(300.0)
    np.testing.assert_allclose(p.results.pmf, j.results.pmf, rtol=1e-10,
                               atol=0)


MAP_CASES = {
    "2d_atoms": ("DensityMap2D", _species, dict(axes="xz", n_bins=(16, 9))),
    "2d_residues": ("DensityMap2D", lambda u: u.atoms,
                    dict(axes="yz", n_bins=12, groupings="residues")),
    "3d_atoms": ("DensityMap3D", _species, dict(n_bins=(5, 6, 7))),
    "3d_residues": ("DensityMap3D", lambda u: [u.atoms[:90], u.atoms[150:]],
                    dict(n_bins=6, groupings="residues")),
}


@pytest.mark.parametrize("case", list(MAP_CASES))
def test_density_maps_equal_jax(system, case):
    cls, groups, kwargs = MAP_CASES[case]
    j, p = _pair(system, cls, groups, kwargs)
    assert p.results.counts.dtype == np.int64
    np.testing.assert_array_equal(p.results.counts, j.results.counts)
    np.testing.assert_array_equal(p.results.number_densities,
                                  j.results.number_densities)
    if j.results.charge_densities is None:
        assert p.results.charge_densities is None
    else:
        np.testing.assert_allclose(p.results.charge_densities,
                                   j.results.charge_densities, rtol=1e-10,
                                   atol=1e-12)
    n_entities = sum(
        (g.n_atoms if kwargs.get("groupings", "atoms") == "atoms"
         else len(np.unique(g.resindices)))
        for g in (groups(system[1]) if isinstance(groups(system[1]), list)
                  else [groups(system[1])]))
    assert p.results.counts.sum() == n_entities * N_FRAMES


@pytest.mark.parametrize("cls", ["DensityProfile", "RadialDensityProfile",
                                 "DensityMap2D", "DensityMap3D"])
def test_parallel_raises(system, cls):
    """``parallel=True`` (ROADMAP Queue 1, item 10b-1) no longer raises:
    without a process group it runs as a world of one and equals the
    serial run."""

    _, tu, _, _ = system
    args = (tu.atoms,) + ((np.zeros(3),) if cls == "RadialDensityProfile"
                          else ())
    runs = [getattr(profile, cls)(*args, parallel=parallel, verbose=False,
                                  device="cpu").run()
            for parallel in (True, False)]
    assert runs[0]._mesh.world == 1 and runs[1]._mesh is None
    for key in ("number_densities", "counts"):
        if key in runs[1].results:
            for got, want in zip(runs[0].results[key], runs[1].results[key]):
                np.testing.assert_array_equal(got, want)
