"""``parallel=True`` over ranks for the aggregates, order, interfaces,
molecules, bonded distributions, native contacts, ion pairing and SASA,
against the port's serial runs and the JAX package's sharded runs; TICA on
one rank; and the roster of every public analysis class.

One job of three gloo ranks on the CPU (``testing.spawn_ranks``, as in
``tests/test_torch_parallel.py``) runs every case of ``CASES`` over two
frame selections and four fused passes, and saves each rank's results.
The fixtures are small (60 waters, a corrugated slab, a 10-atom
"protein", 6 chains of 10), 11 frames each, streamed in chunks of 6
frames: a multiple of the three ranks, so that the last chunk of 11
frames (5) leaves rank 2 one frame and one padded frame under mask 0
("tail"), and the last chunk of the first 7 frames (1) leaves ranks 1
and 2 no frame at all ("empty").  Each case is held:

* rank against rank: identical;
* against the port's serial run in this process: integer counts, the
  gathered stores and what the conclusion makes of them equal, float64
  frame sums within rtol 1e-12 (only the order of the rank sums
  differs), the PCA's leading components within 1e-9;
* against the JAX package's ``parallel=True`` run on its 8 virtual CPU
  devices, within the tolerances of the port's per-class tests (their
  helpers and constants, imported);
* with no process group, ``parallel=True`` equals the serial run bit for
  bit.

The job also forces an occluder overflow on rank 1 alone, which every
rank must escalate together, and runs TICA, which is refused over the
three ranks and runs on one.
"""

import json
import os
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import mdhelper_tpu.analysis.base as jax_base  # noqa: E402
import test_torch_bonded as per_bonded  # noqa: E402
import test_torch_interface as per_interface  # noqa: E402
import test_torch_orientation as per_orientation  # noqa: E402
import test_torch_pairing as per_pairing  # noqa: E402
import test_torch_sasa as per_sasa  # noqa: E402
import test_torch_steinhardt as per_steinhardt  # noqa: E402
from mdhelper_tpu.analysis import bonded as jax_bonded  # noqa: E402
from mdhelper_tpu.analysis import cluster as jax_cluster  # noqa: E402
from mdhelper_tpu.analysis import contacts as jax_contacts  # noqa: E402
from mdhelper_tpu.analysis import hbonds as jax_hbonds  # noqa: E402
from mdhelper_tpu.analysis import interface as jax_interface  # noqa: E402
from mdhelper_tpu.analysis import orientation as jax_orientation  # noqa: E402
from mdhelper_tpu.analysis import pairing as jax_pairing  # noqa: E402
from mdhelper_tpu.analysis import rmsd as jax_rmsd  # noqa: E402
from mdhelper_tpu.analysis import sasa as jax_sasa  # noqa: E402
from mdhelper_tpu.analysis import steinhardt as jax_steinhardt  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu_torch.testing import spawn_ranks  # noqa: E402

WORLD = 3

#: The cases, run by the ranks and by this process alike (the ranks import
#: no test module, and so no JAX).  Each factory takes the library whose
#: classes it builds (``PORT`` here, the JAX package's in the tests).
CASES = '''
import types

import numpy as np

from mdhelper_tpu_torch.analysis import (
    bonded,
    cluster,
    contacts,
    hbonds,
    interface,
    orientation,
    pairing,
    rmsd,
    sasa,
    steinhardt,
)
from mdhelper_tpu_torch.core.universe import Universe
from mdhelper_tpu_torch.testing import polymer_chains, water_system

PORT = types.SimpleNamespace(
    bonded=bonded, cluster=cluster, contacts=contacts, hbonds=hbonds,
    interface=interface, orientation=orientation, pairing=pairing,
    rmsd=rmsd, sasa=sasa, steinhardt=steinhardt,
    opts={"verbose": False, "device": "cpu"})
N_FRAMES = 11
#: frames a chunk (see the module docstring) and the frame selections:
#: every frame, and the first 7.
CHUNK = 6
SELECTIONS = {"tail": None, "empty": 7}
WATER_BOX = 12.0
SLAB_BOX = np.array([12.0, 12.0, 18.0])
N_SURF, N_ION = 240, 30
CELLS, XI = (16, 16, 32), 1.2
PROTEIN_BOX, N_PROTEIN = 30.0, 10
POLYMER_BOX, N_CHAINS, N_MONO = 14.0, 6, 10


def slab_frames(rng):
    """tests/test_torch_interface.py's slab: N_SURF sites between z 5 and
    13, both surfaces corrugated, then N_ION ions uniform in the box."""

    out = np.empty((N_FRAMES, N_SURF + N_ION, 3))
    for t in range(N_FRAMES):
        x = rng.uniform(0, SLAB_BOX[0], N_SURF)
        y = rng.uniform(0, SLAB_BOX[1], N_SURF)
        zeta = np.sin(2 * np.pi * x / SLAB_BOX[0] + t)
        z = zeta + rng.uniform(5.0, 13.0, N_SURF)
        out[t, :N_SURF] = np.stack((x, y, z), axis=-1)
        out[t, N_SURF:] = rng.random((N_ION, 3)) * SLAB_BOX
    out[:, :5, 1] -= SLAB_BOX[1]
    return out.astype(np.float32)


def protein_frames(rng):
    """A rigid 10-atom body with two internal modes and noise, rotated
    and moved at random each frame, among 20 loose atoms."""

    base = rng.normal(size=(N_PROTEIN, 3)) * 4.0
    modes = rng.normal(size=(2, N_PROTEIN, 3))
    frames = rng.random((N_FRAMES, 30, 3)) * PROTEIN_BOX
    for t in range(N_FRAMES):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        local = (base + np.einsum("m,mnd->nd", rng.normal(size=2), modes)
                 + rng.normal(size=(N_PROTEIN, 3)) * 0.05)
        frames[t, 10:20] = local @ q.T + 10.0 + rng.normal(size=3)
    return frames.astype(np.float32)


def inputs():
    """Every fixture's float32 frames and topology, made alike by every
    rank and the tests."""

    water, water_top = water_system(np.random.default_rng(2033), 60,
                                    WATER_BOX, N_FRAMES, step=0.2)
    chains, _ = polymer_chains(np.random.default_rng(2041), N_CHAINS,
                               N_MONO, N_FRAMES, POLYMER_BOX, stiffness=0.5)
    return {
        "water": (water, [WATER_BOX] * 3 + [90.0] * 3, water_top),
        "slab": (slab_frames(np.random.default_rng(17)),
                 list(SLAB_BOX) + [90.0] * 3, {}),
        "protein": (protein_frames(np.random.default_rng(4242)),
                    [PROTEIN_BOX] * 3 + [90.0] * 3,
                    {"masses": np.random.default_rng(5).choice(
                        [12.011, 14.007, 15.999], 30)}),
        "polymer": (chains, [POLYMER_BOX] * 3 + [90.0] * 3, {
            "bonds": np.array([(c * N_MONO + i, c * N_MONO + i + 1)
                               for c in range(N_CHAINS)
                               for i in range(N_MONO - 1)])}),
    }


def universes(data, cls=Universe, dtype=np.float32):
    return {name: cls.from_arrays(frames.astype(dtype), dims, dt=0.5,
                                  **topology)
            for name, (frames, dims, topology) in data.items()}


def chunked(a):
    """`a` streaming CHUNK frames a chunk of its own atoms (known once it
    is prepared)."""

    prepare = a._prepare

    def prepared():
        prepare()
        idx = a._effective_atom_indices()
        n = a._trajectory.n_atoms if idx is None else len(idx)
        a._chunk_bytes = CHUNK * n * 3 * 4

    a._prepare = prepared
    return a


def oxygens(u):
    return u.atoms[0::3]


def clusters(u, lib=PORT, **kw):
    return lib.cluster.ClusterSizeDistribution(u.atoms, 2.0, "residues",
                                               **lib.opts, **kw)


def hbond_pairs(u, lib=PORT, **kw):
    return lib.hbonds.HydrogenBondAnalysis(u, pair_counts=True,
                                           lifetimes=True, **lib.opts, **kw)


def nematic(u, lib=PORT, **kw):
    return lib.orientation.NematicOrderParameter(
        u.atoms[0::3], u.atoms[1::3], acf=True, **lib.opts, **kw)


def orient_profile(u, lib=PORT, **kw):
    return lib.orientation.OrientationProfile(
        u.atoms[0::3], u.atoms[1::3], "z", 6, **lib.opts, **kw)


def steinhardt_q(u, lib=PORT, **kw):
    return lib.steinhardt.SteinhardtOrderParameter(
        oxygens(u), 3.5, (4, 6), averaged=True, wl=True, **lib.opts, **kw)


def tetrahedral(u, lib=PORT, **kw):
    return lib.steinhardt.TetrahedralOrderParameter(oxygens(u), **lib.opts,
                                                    **kw)


def bond_lengths(u, lib=PORT, **kw):
    return lib.bonded.BondLengthDistribution(u.atoms, 60, (0.0, 3.0),
                                             **lib.opts, **kw)


def bond_angles(u, lib=PORT, **kw):
    return lib.bonded.BondAngleDistribution(u.atoms, 90, **lib.opts, **kw)


def dihedrals(u, lib=PORT, **kw):
    return lib.bonded.DihedralDistribution(u.atoms, 72, **lib.opts, **kw)


def native(u, lib=PORT, **kw):
    return lib.contacts.NativeContacts(oxygens(u), radius=4.5, **lib.opts,
                                       **kw)


def ion_pairs(u, lib=PORT, **kw):
    return lib.pairing.IonPairAnalysis(oxygens(u), u.atoms[1::3], 2.2,
                                       pair_counts=True, lifetimes=True,
                                       **lib.opts, **kw)


def surface_area(u, lib=PORT, **kw):
    return lib.sasa.SolventAccessibleSurfaceArea(
        u.atoms[:60], n_points=24, radii=np.tile([1.52, 1.1, 1.1], 20),
        **lib.opts, **kw)


def willard_chandler(u, lib=PORT, **kw):
    return lib.interface.WillardChandlerInterface(
        u.atoms[:N_SURF], xi=XI, n_cells=CELLS, **lib.opts, **kw)


def intrinsic(u, lib=PORT, **kw):
    return lib.interface.IntrinsicDensityProfile(
        u.atoms[:N_SURF], [u.atoms[:N_SURF:2], u.atoms[N_SURF:]], xi=XI,
        n_cells=CELLS, n_bins=30, **lib.opts, **kw)


def protein(u):
    return u.atoms[10:20]


def rmsd_case(u, lib=PORT, **kw):
    return lib.rmsd.RMSD(protein(u), weights="mass", **lib.opts, **kw)


def rmsf_case(u, lib=PORT, **kw):
    return lib.rmsd.RMSF(protein(u), **lib.opts, **kw)


def pca_case(u, lib=PORT, **kw):
    return lib.rmsd.PrincipalComponentAnalysis(protein(u), **lib.opts, **kw)


def tica_case(u, lib=PORT, **kw):
    return lib.rmsd.TICA(protein(u), lag=2, **lib.opts, **kw)


#: name: (factory, fixture, {result key (or private store): how the ranks
#: are held to the serial run: "equal"; "f64" (float64 sums, and per-frame
#: float64 values that a batched reduction makes, whose order follows the
#: chunk's shape: rtol 1e-12); "unit" (such values of order 1, rotation
#: matrices: atol 1e-12); "scaled" (eigenvalues of such sums, within 1e-12
#: of the largest); or "lead" (the two leading columns within 1e-9)})
PARALLEL = {
    "clusters": (clusters, "water", {
        "size_counts": "equal", "n_clusters": "equal", "largest": "equal",
        "size_distribution": "equal", "weight_average": "equal"}),
    "hbonds": (hbond_pairs, "water", {
        "counts": "equal", "occupancies": "equal", "pair_counts": "equal",
        "_existence": "equal", "lifetime": "equal", "survival": "equal"}),
    "nematic": (nematic, "water", {
        "Q": "equal", "P2": "equal", "director": "equal", "_axes": "equal",
        "C1": "equal", "C2": "equal", "P2_mean": "f64"}),
    "orient_profile": (orient_profile, "water", {
        "counts": "equal", "p1": "f64", "p2": "f64"}),
    "steinhardt": (steinhardt_q, "water", {
        "ql": "equal", "ql_mean": "equal", "Ql": "equal",
        "n_neighbors": "equal", "wl": "equal", "ql_avg": "equal",
        "wl_avg": "equal"}),
    "tetrahedral": (tetrahedral, "water", {"q_tet": "equal",
                                           "q_tet_mean": "equal"}),
    "willard_chandler": (willard_chandler, "slab", {
        "density_field": "f64", "levels": "equal", "heights": "equal",
        "interface_width": "equal"}),
    "intrinsic": (intrinsic, "slab", {"counts": "equal",
                                      "number_densities": "f64"}),
    "rmsd": (rmsd_case, "protein", {"rmsd": "f64", "rotations": "unit"}),
    "rmsf": (rmsf_case, "protein", {"rmsf": "f64",
                                    "mean_positions": "f64"}),
    "pca": (pca_case, "protein", {"variance": "scaled",
                                  "p_components": "lead",
                                  "mean_positions": "f64"}),
    "bond_lengths": (bond_lengths, "polymer", {"counts": "equal",
                                               "mean": "f64", "std": "f64"}),
    "bond_angles": (bond_angles, "polymer", {"counts": "equal",
                                             "mean": "f64", "std": "f64"}),
    "dihedrals": (dihedrals, "polymer", {"counts": "equal"}),
    "native": (native, "water", {"q": "equal"}),
    "ion_pairs": (ion_pairs, "water", {
        "counts": "equal", "free_fractions": "equal",
        "coordination": "equal", "pair_counts": "equal",
        "_existence": "equal", "lifetime": "equal", "survival": "equal"}),
    "sasa": (surface_area, "water", {"areas": "equal",
                                     "total_areas": "equal",
                                     "n_neighbors": "equal"}),
}

#: one fused pass a fixture: name: cases
FUSED = {
    "water": ("clusters", "hbonds", "nematic", "orient_profile",
              "steinhardt", "tetrahedral", "native", "ion_pairs", "sasa"),
    "slab": ("willard_chandler", "intrinsic"),
    "protein": ("rmsd", "rmsf", "pca"),
    "polymer": ("bond_lengths", "bond_angles", "dihedrals"),
}


def fused_analyses(name, us, **kw):
    """The fused pass `name`'s analyses, in chunks of CHUNK frames of the
    shared stream (every atom)."""

    u = us[name]
    analyses = [PARALLEL[case][0](u, **kw) for case in FUSED[name]]
    for a in analyses:
        a._chunk_bytes = CHUNK * u.atoms.n_atoms * 3 * 4
    return analyses


def arrays_of(analysis, keys):
    """``{key or key:i: array}`` of `analysis`'s results (a list result one
    entry an element) and private stores."""

    out = {}
    for key in keys:
        value = (getattr(analysis, key) if key.startswith("_")
                 else analysis.results[key])
        if isinstance(value, list):
            for i, v in enumerate(value):
                out[f"{key}:{i}"] = np.asarray(v)
        else:
            out[key] = np.asarray(value)
    return out
'''

#: What every rank runs (after ``spawn_ranks``'s prelude and CASES).
RANK_CODE = '''
import json
import warnings

from mdhelper_tpu_torch.analysis.multi import run_together

warnings.simplefilter("ignore")
us = universes(inputs())
saved, notes = {}, {}
for name, (factory, fixture, keys) in PARALLEL.items():
    for selection, stop in SELECTIONS.items():
        a = chunked(factory(us[fixture], parallel=True)).run(stop=stop)
        for key, value in arrays_of(a, keys).items():
            saved[f"{name}/{selection}:{key}"] = value
        notes[f"{name}/{selection}"] = {
            "shards": a._mesh.size, "rows": [len(r) for r in a._rank_rows]}
for name, cases in FUSED.items():
    done = run_together(fused_analyses(name, us, parallel=True),
                        parallel=True)
    for case, a in zip(cases, done):
        for key, value in arrays_of(a, PARALLEL[case][2]).items():
            saved[f"fused_{name}/{case}:{key}"] = value

# An occluder overflow on rank 1 alone, in the first run: every rank must
# escalate once, together.
crowded = chunked(surface_area(us["water"], parallel=True))
make, runs = crowded._make_update, []


def make_crowded():
    make()
    runs.append(crowded._active_budget)
    if RANK == 1 and len(runs) == 1:
        update = crowded._update

        def bumped(carry, positions, dimensions, mask):
            carry, (areas, counts) = update(carry, positions, dimensions,
                                            mask)
            return carry, (areas, counts + 10_000)

        crowded._update = bumped


crowded._make_update = make_crowded
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    crowded.run()
for key, value in arrays_of(crowded, PARALLEL["sasa"][2]).items():
    saved[f"overflow:{key}"] = value
notes["overflow"] = {
    "runs": len(runs),
    "warned": sum("re-running" in str(w.message) for w in caught)}

try:
    tica_case(us["protein"], parallel=True).run()
    notes["tica"] = None
except Exception as err:  # the type and message are what is tested
    notes["tica"] = [type(err).__name__, str(err)]

np.savez(os.path.join(WORKDIR, f"rank{RANK}.npz"), **saved)
with open(os.path.join(WORKDIR, f"rank{RANK}.json"), "w") as f:
    json.dump(notes, f)
'''

_cases = {}
exec(CASES, _cases)
PARALLEL, FUSED = _cases["PARALLEL"], _cases["FUSED"]
SELECTIONS = _cases["SELECTIONS"]
JAX = types.SimpleNamespace(
    bonded=jax_bonded, cluster=jax_cluster, contacts=jax_contacts,
    hbonds=jax_hbonds, interface=jax_interface, orientation=jax_orientation,
    pairing=jax_pairing, rmsd=jax_rmsd, sasa=jax_sasa,
    steinhardt=jax_steinhardt, opts={"verbose": False})
RUNS = [(name, sel) for name in PARALLEL for sel in SELECTIONS]
FUSED_RUNS = [(f, case) for f, cases in FUSED.items() for case in cases]
#: the superposition classes, which the per-class tests hold to the JAX
#: classes streaming float64 (their CPU default)
FLOAT64_JAX = ("rmsd", "rmsf", "pca", "tica")


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


@pytest.fixture(scope="module")
def data():
    return _cases["inputs"]()


@pytest.fixture(scope="module")
def universes(data):
    return _cases["universes"](data)


@pytest.fixture(scope="module")
def jax_universes(data):
    return _cases["universes"](data, JaxUniverse, np.float64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's saved arrays and notes."""

    workdir = tmp_path_factory.mktemp("roster")
    spawn_ranks(CASES + RANK_CODE, WORLD, str(workdir), timeout=240)
    return [
        (dict(np.load(workdir / f"rank{r}.npz")),
         json.loads((workdir / f"rank{r}.json").read_text()))
        for r in range(WORLD)
    ]


@pytest.fixture(scope="module")
def serial(universes):
    """The port's serial run of every case and selection, as arrays."""

    out = {}
    for name, sel in RUNS:
        factory, fixture, keys = PARALLEL[name]
        a = _quiet(lambda: _cases["chunked"](factory(
            universes[fixture])).run(stop=SELECTIONS[sel]))
        out[name, sel] = _cases["arrays_of"](a, keys)
    return out


def _held(got, want, kind, what):
    if kind == "equal":
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif kind == "f64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=what)
    elif kind == "unit":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=what)
    elif kind == "scaled":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0,
                                   atol=1e-9, err_msg=what)


@pytest.mark.parametrize("name,sel", RUNS)
def test_every_rank_holds_the_same_results(ranks, name, sel):
    first = ranks[0][0]
    keys = [k for k in first if k.startswith(f"{name}/{sel}:")]
    assert keys
    for arrays, _ in ranks[1:]:
        for key in keys:
            np.testing.assert_array_equal(arrays[key], first[key],
                                          err_msg=key)


@pytest.mark.parametrize("name,sel", RUNS)
def test_ranks_match_serial(ranks, serial, name, sel):
    """Counts and stores equal the serial run's, float64 frame sums within
    rtol 1e-12; rank 2 streamed a padded frame in the tail selection, and
    ranks 1 and 2 nothing of the last chunk in the empty one."""

    kinds = PARALLEL[name][2]
    arrays, _ = ranks[0]
    for key, value in serial[name, sel].items():
        _held(arrays[f"{name}/{sel}:{key}"], value,
              kinds[key.split(":")[0]], f"{name}/{sel}:{key}")
    rows = [n[f"{name}/{sel}"]["rows"] for _, n in ranks]
    assert all(n[f"{name}/{sel}"]["shards"] == WORLD for _, n in ranks)
    assert rows == ([[2, 2], [2, 2], [2, 1]] if sel == "tail"
                    else [[2, 1], [2], [2]])


@pytest.mark.parametrize("fused,case", FUSED_RUNS)
def test_fused_pass_over_ranks_equals_serial(ranks, serial, fused, case):
    kinds = PARALLEL[case][2]
    for arrays, _ in ranks:
        for key, value in serial[case, "tail"].items():
            _held(arrays[f"fused_{fused}/{case}:{key}"], value,
                  kinds[key.split(":")[0]], f"fused {case}:{key}")


def _jax_run(name, jax_universes, **kw):
    """The JAX package's run of case `name` (``parallel=True`` on its 8
    virtual devices unless `kw` says otherwise), streaming float32 but
    for the superposition classes."""

    factory, fixture, _ = PARALLEL.get(
        name, (_cases.get(f"{name}_case"), "protein", None))
    dtype = np.float64 if name in FLOAT64_JAX else np.float32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", dtype)
        return _quiet(lambda: factory(jax_universes[fixture], lib=JAX,
                                      **{"parallel": True, **kw}).run())


def _with_rank_results(analysis, arrays, keys):
    """`analysis` (the port's serial run of a case) with the results the
    ranks saved (`arrays`, keyed as :func:`arrays_of` keys them) in place
    of its own."""

    for key in keys:
        if key.startswith("_"):
            continue
        if isinstance(analysis.results[key], list):
            analysis.results[key] = [
                arrays[f"{key}:{i}"]
                for i in range(len(analysis.results[key]))]
        else:
            analysis.results[key] = arrays[key]
    return analysis


def _to_jax(name, got, ref, data):
    """`got` (an analysis holding case `name`'s results of the ranks)
    against the JAX package's run `ref`, within the tolerances of the
    port's per-class tests."""

    o, r = got.results, ref.results

    def eq(*keys):
        for key in keys:
            np.testing.assert_array_equal(o[key], r[key], err_msg=key)

    def near(key, atol, rtol=0.0):
        np.testing.assert_allclose(o[key], r[key], rtol=rtol, atol=atol,
                                   err_msg=key)

    if name == "clusters":
        eq("n_clusters", "largest", "size_counts")
        near("size_distribution", 0.0, 1e-12)
    elif name == "hbonds":
        eq("counts", "occupancies", "pair_counts")
        near("lifetime", 1e-12)
        near("survival", 1e-12)
    elif name == "nematic":
        near("Q", per_orientation.Q_ATOL)
        near("P2", per_orientation.Q_ATOL)
        near("C1", per_orientation.ACF_ATOL)
        near("C2", per_orientation.ACF_ATOL)
    elif name == "orient_profile":
        eq("counts")
        near("p1", per_orientation.PROFILE_ATOL)
        near("p2", per_orientation.PROFILE_ATOL)
    elif name == "steinhardt":
        eq("n_neighbors")
        for key in ("ql", "ql_mean", "Ql", "ql_avg"):
            near(key, per_steinhardt.QL_ATOL)
        for key in ("wl", "wl_avg"):
            near(key, per_steinhardt.WL_ATOL)
    elif name == "tetrahedral":
        near("q_tet", per_steinhardt.QTET_ATOL)
    elif name == "willard_chandler":
        field = r.density_field
        near("density_field", per_interface.FIELD_RTOL * np.abs(field).max())
        near("levels", 0.0, per_interface.LEVEL_RTOL)
        h, rh = o.heights, np.asarray(r.heights)
        np.testing.assert_array_equal(np.isnan(h), np.isnan(rh))
        np.testing.assert_allclose(h, rh, rtol=0,
                                   atol=per_interface.HEIGHT_ATOL)
        near("interface_width", 0.0, 1e-3)
    elif name == "intrinsic":
        c, rc = o.counts, r.counts
        assert np.abs(c - rc).max() <= per_interface.COUNT_ATOL
        np.testing.assert_array_equal(c.sum(-1), rc.sum(-1))
        scale = np.abs(r.number_densities).max()
        near("number_densities", per_interface.COUNT_ATOL * scale / 50)
    elif name == "rmsd":
        # frame 0 is the reference: RMSD 0, within 1e-6 of the JAX
        # fit's (tests/test_torch_rmsd.py)
        near("rmsd", 1e-6)
        np.testing.assert_allclose(o.rmsd[1:], r.rmsd[1:], rtol=0,
                                   atol=1e-9)
        near("rotations", 1e-9)
    elif name == "rmsf":
        near("rmsf", 1e-9)
        near("mean_positions", 1e-9)
    elif name == "pca":
        near("variance", 1e-9 * np.abs(r.variance).max())
        np.testing.assert_allclose(o.p_components[:, :2],
                                   r.p_components[:, :2], rtol=0, atol=1e-7)
    elif name in ("bond_lengths", "bond_angles", "dihedrals"):
        kind = {"bond_lengths": "length", "bond_angles": "angle",
                "dihedrals": "dihedral"}[name]
        frames, dims, topology = data["polymer"]
        terms = topology["bonds"]
        if kind != "length":
            terms = getattr(per_bonded.bonded, "derive_angles"
                            if kind == "angle" else "derive_dihedrals")(
                terms)
        if kind == "length":
            eq("counts")
        else:
            values, margin = per_bonded._oracle_values(
                kind, frames, terms, np.asarray(dims), with_margin=True)
            bound = per_bonded._delta_bound(values, r.edges, margin)
            assert np.abs(o.counts - r.counts).sum() <= bound
        if kind != "dihedral":
            near("mean", 0.0, 1e-6)
            near("std", 0.0, 1e-6)
    elif name == "native":
        eq("q")
    elif name == "ion_pairs":
        per_pairing.assert_equal_pairing(ref, got, n_frames=11)
    elif name == "sasa":
        per_sasa.assert_equal_sasa(ref, got)
    else:
        raise AssertionError(name)


@pytest.mark.parametrize("name", list(PARALLEL))
def test_ranks_match_jax_sharded_run(ranks, universes, jax_universes, data,
                                     name):
    factory, fixture, keys = PARALLEL[name]
    arrays = {key.split(":", 1)[1]: value
              for key, value in ranks[0][0].items()
              if key.startswith(f"{name}/tail:")}
    source = _quiet(lambda: _cases["chunked"](factory(
        universes[fixture])).run())
    got = _with_rank_results(source, arrays, keys)
    _to_jax(name, got, _jax_run(name, jax_universes), data)


@pytest.mark.parametrize("name", list(PARALLEL))
def test_parallel_without_process_group_equals_serial(universes, serial,
                                                      name):
    factory, fixture, keys = PARALLEL[name]
    a = _quiet(lambda: _cases["chunked"](factory(
        universes[fixture], parallel=True)).run())
    assert a._mesh.world == 1 and a._mesh.grouped is False
    got = _cases["arrays_of"](a, keys)
    for key, value in serial[name, "tail"].items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_overflow_on_one_rank_escalates_every_rank(ranks, serial):
    """Rank 1's first run overflows its occluder budget: every rank
    escalates once (two runs, one warning each) and the result equals the
    serial run's."""

    for arrays, notes in ranks:
        assert notes["overflow"] == {"runs": 2, "warned": 1}
        for key, value in serial["sasa", "tail"].items():
            np.testing.assert_array_equal(arrays[f"overflow:{key}"], value,
                                          err_msg=key)


def test_tica_is_refused_over_three_ranks(ranks):
    for _, notes in ranks:
        assert notes["tica"][0] == "NotImplementedError"
        assert "Order-dependent analyses" in notes["tica"][1]


def test_tica_runs_on_one_rank(universes, jax_universes):
    """TICA takes ``parallel=True`` and, on one rank, equals its serial
    run bit for bit and the JAX package's ``parallel=True`` run (which it
    runs unsharded) within tests/test_torch_rmsd.py's 1e-8."""

    u = universes["protein"]
    one = _quiet(lambda: _cases["chunked"](_cases["tica_case"](
        u, parallel=True)).run())
    assert one._mesh.world == 1
    alone = _quiet(lambda: _cases["chunked"](_cases["tica_case"](u)).run())
    for key in ("eigenvalues", "tica_components", "mean_positions"):
        np.testing.assert_array_equal(one.results[key], alone.results[key])
    ref = _jax_run("tica", jax_universes)
    np.testing.assert_allclose(one.results.eigenvalues,
                               ref.results.eigenvalues, rtol=0, atol=1e-8)


#: The JAX package's roster (``__graft_entry__.py:871-962``): every public
#: analysis class and its multi-chip status, copied here.  ``verified``
#: classes shard the frames, ``sequential`` ones stream in order on one
#: device, ``host`` ones stream nothing.
JAX_ROSTER = {
    "RadialDistributionFunction": "verified",
    "StructureFactor": "verified",
    "IntermediateScatteringFunction": "verified",
    "VanHoveFunction": "sequential",
    "Onsager": "sequential",
    "DensityProfile": "verified",
    "RadialDensityProfile": "verified",
    "DensityMap2D": "verified",
    "DensityMap3D": "verified",
    "DipoleMoment": "verified",
    "Gyradius": "verified",
    "EndToEndVector": "verified",
    "RouseModes": "verified",
    "PersistenceLength": "verified",
    "MeanSquareInternalDistance": "verified",
    "SingleChainStructureFactor": "verified",
    "ConstantVolumeHeatCapacity": "host",
    "UmbrellaSampling": "host",
    "ClusterSizeDistribution": "verified",
    "HydrogenBondAnalysis": "verified",
    "NematicOrderParameter": "verified",
    "OrientationProfile": "verified",
    "VelocityAutocorrelation": "verified",
    "ElectricCurrentAutocorrelation": "verified",
    "SurvivalProbability": "verified",
    "OverlapFunction": "sequential",
    "FlowProfile": "verified",
    "SteinhardtOrderParameter": "verified",
    "TetrahedralOrderParameter": "verified",
    "SolventAccessibleSurfaceArea": "verified",
    "NativeContacts": "verified",
    "IonPairAnalysis": "verified",
    "RMSD": "verified",
    "RMSF": "verified",
    "PrincipalComponentAnalysis": "verified",
    "TICA": "sequential",
    "WillardChandlerInterface": "verified",
    "IntrinsicDensityProfile": "verified",
    "BondLengthDistribution": "verified",
    "BondAngleDistribution": "verified",
    "DihedralDistribution": "verified",
}

#: ``verified`` classes whose ``parallel`` both packages pop and run
#: serially (the stored vectors are one pass in order), and the ISF, whose
#: frame-parallel route (the time FFT) is set per instance.
SERIAL_IN_BOTH = ("EndToEndVector", "RouseModes")


def test_roster_matches_jax():
    """Every public analysis class of the port is ``_rank_sharded``,
    ``_sequential`` or host-only as the JAX roster marks it, and the
    roster names every one of them."""

    import inspect

    import mdhelper_tpu_torch.analysis as package
    from mdhelper_tpu_torch.analysis.base import SerialAnalysisBase

    found = {}
    for module in package.__all__:
        mod = getattr(package, module)
        if not inspect.ismodule(mod):
            continue
        for name in getattr(mod, "__all__", ()):
            obj = getattr(mod, name)
            if inspect.isclass(obj) and name[0].isupper() and (
                    issubclass(obj, SerialAnalysisBase)
                    or name in JAX_ROSTER):
                found[name] = obj
    assert set(found) - {"DynamicAnalysisBase", "SerialAnalysisBase",
                         "ParallelAnalysisBase", "NumbaAnalysisBase",
                         "JittedAnalysisBase"} == set(JAX_ROSTER)
    for name, status in JAX_ROSTER.items():
        cls = found[name]
        if status == "host":
            assert not issubclass(cls, SerialAnalysisBase), name
        elif status == "sequential":
            assert cls._sequential and not cls._rank_sharded, name
        elif name == "IntermediateScatteringFunction":
            # the time FFT shards the frames, the lag ring is sequential
            assert not cls._sequential, name
        elif name in SERIAL_IN_BOTH:
            assert not cls._rank_sharded and not cls._sequential, name
        else:
            assert cls._rank_sharded and not cls._sequential, name
