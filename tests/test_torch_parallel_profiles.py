"""``parallel=True`` over ranks for the profile family, the dipole moment,
the polymer classes, the flow profile and the velocity stream, against
the port's serial runs and the JAX package's sharded runs.

One job of three gloo ranks on the CPU (``testing.spawn_ranks``, as in
``tests/test_torch_parallel.py``) runs every case of ``CASES`` over two
frame selections and four fused passes, and saves each rank's results.
The inputs are the awkward sizes of ``tests/test_multihost.py`` (37
atoms, 11 frames) and the drifting fixture of
``tests/test_analysis_profile.py`` (24 atoms carried 3.5 box lengths
along z, wrapped), streamed in chunks of 6 frames: a multiple of the
three ranks, so that the last chunk of 11 frames (5) leaves rank 2 one
frame and one padded frame under mask 0 ("tail"), and the last chunk of
the first 7 frames (1) leaves ranks 1 and 2 no frame at all ("empty").
(Chunks of 4 frames would shrink to 3 under three ranks, which never
pad.)  Each case is held:

* rank against rank: identical;
* against the port's serial run in this process: integer counts and the
  gathered stores (and all that the conclusion makes of them) equal,
  float64 frame sums within rtol 1e-12 (only the order of the rank sums
  differs);
* against the JAX package's ``parallel=True`` run on its 8 virtual CPU
  devices, streaming float32, within the tolerances the port's per-class
  tests use against the JAX classes (``TO_JAX``);
* with no process group, ``parallel=True`` equals the serial run bit for
  bit, except the recentered profile, which takes the pre-pass route of
  the JAX package's ``parallel=True`` and is held to it.

The fused recentered profile is held to the numpy unwrap, shift and wrap
of ``tests/test_analysis_profile.py`` and to its standalone run; the JAX
package's fused pass, which drops the shift, is pinned beside it (ROADMAP
Queue 3, item 19).
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
from mdhelper_tpu.analysis import dynamics as jax_dynamics  # noqa: E402
from mdhelper_tpu.analysis import electrostatics as jax_es  # noqa: E402
from mdhelper_tpu.analysis import flow as jax_flow  # noqa: E402
from mdhelper_tpu.analysis import multi as jax_multi  # noqa: E402
from mdhelper_tpu.analysis import polymer as jax_polymer  # noqa: E402
from mdhelper_tpu.analysis import profile as jax_profile  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.testing import spawn_ranks  # noqa: E402

WORLD = 3
EPS32 = float(np.finfo(np.float32).eps)

#: The cases, run by the ranks and by this process alike (the ranks import
#: no test module, and so no JAX).  Each factory takes the library whose
#: classes it builds (``PORT`` here, the JAX package's in the tests).
CASES = '''
import types

import numpy as np

from mdhelper_tpu_torch.analysis import (
    dynamics,
    electrostatics,
    flow,
    polymer,
    profile,
)
from mdhelper_tpu_torch.core.universe import Universe

PORT = types.SimpleNamespace(
    dynamics=dynamics, electrostatics=electrostatics, flow=flow,
    polymer=polymer, profile=profile,
    opts={"verbose": False, "device": "cpu"})
BOX_B = 10.0
DIMS_D = np.array([10.0, 12.0, 14.0])
#: frames a chunk (see the module docstring) and the frame selections:
#: every frame, and the first 7.
CHUNK = 6
SELECTIONS = {"tail": None, "empty": 7}
#: the polymer classes' chains: the first 36 atoms as 4 chains of 9.
CHAINS = {"n_chains": 4, "n_monomers": 9}
T_KELVIN = 300.0


def universes(data, cls=Universe):
    topology = {key: data[key] for key in ("masses", "charges",
                                          "resindices")}
    return {
        "b": cls.from_arrays(data["b"], [BOX_B] * 3 + [90.0] * 3, dt=0.5,
                             velocities=data["v"], **topology),
        "d": cls.from_arrays(data["d"], list(DIMS_D) + [90.0] * 3, dt=1.0),
    }


def chunked(a):
    """`a` streaming CHUNK frames a chunk of its own atoms and columns
    (known once it is prepared)."""

    prepare = a._prepare

    def prepared():
        prepare()
        idx = a._effective_atom_indices()
        n = a._trajectory.n_atoms if idx is None else len(idx)
        columns = (a._payload_width() if a._coord_axes is None
                   else len(a._coord_axes))
        a._chunk_bytes = CHUNK * n * columns * 4

    a._prepare = prepared
    return a


def ions(u):
    return [u.atoms[0::2], u.atoms[1::2]]


def dp(u, lib=PORT, **kw):
    return lib.profile.DensityProfile(ions(u), axes="z", n_bins=8,
                                      **lib.opts, **kw)


def dp_frames(u, lib=PORT, **kw):
    return lib.profile.DensityProfile(u.atoms, axes="xz", n_bins=(5, 7),
                                      average=False, **lib.opts, **kw)


def dp_residues(u, lib=PORT, **kw):
    return lib.profile.DensityProfile(u.atoms, groupings="residues",
                                      axes="yz", n_bins=6, **lib.opts, **kw)


def dp_recenter(u, lib=PORT, **kw):
    return lib.profile.DensityProfile(u.atoms, axes="z", n_bins=23,
                                      recenter=0, **lib.opts, **kw)


def dp_recenter_groups(u, lib=PORT, **kw):
    return lib.profile.DensityProfile(
        [u.atoms[12:], u.atoms[:12]], axes="yz", n_bins=(9, 23),
        recenter=(1, (5.0, 6.0, 4.0)), average=False, **lib.opts, **kw)


def rdp(u, lib=PORT, **kw):
    return lib.profile.RadialDensityProfile(
        ions(u), u.atoms[:3], n_bins=10, range=(0.0, 5.0), **lib.opts, **kw)


def rdp_cylinder(u, lib=PORT, **kw):
    return lib.profile.RadialDensityProfile(
        u.atoms, [5.0, 5.0, 5.0], n_bins=8, range=(0.0, 4.0),
        geometry="cylindrical", axis="z", groupings="residues",
        **lib.opts, **kw)


def map2d(u, lib=PORT, **kw):
    return lib.profile.DensityMap2D(u.atoms, axes="xz", n_bins=(6, 5),
                                    **lib.opts, **kw)


def map3d(u, lib=PORT, **kw):
    return lib.profile.DensityMap3D(ions(u), n_bins=4, **lib.opts, **kw)


def dipole(u, lib=PORT, **kw):
    return lib.electrostatics.DipoleMoment([u.atoms[:20], u.atoms[20:]],
                                           **lib.opts, **kw)


def survival_slab(u, lib=PORT, **kw):
    return lib.dynamics.SurvivalProbability(u.atoms, ("slab", "z", 2.0, 6.0),
                                            **lib.opts, **kw)


def survival_shell(u, lib=PORT, **kw):
    return lib.dynamics.SurvivalProbability(
        u.atoms[:20], ("shell", u.atoms[20:], 2.0), **lib.opts, **kw)


def gyradius(u, lib=PORT, **kw):
    return lib.polymer.Gyradius(u.atoms[:36], shape=True, **CHAINS,
                                **lib.opts, **kw)


def scsf(u, lib=PORT, **kw):
    return lib.polymer.SingleChainStructureFactor(
        u.atoms[:36], n_points=3, **CHAINS, **lib.opts, **kw)


def persistence(u, lib=PORT, **kw):
    return lib.polymer.PersistenceLength(u.atoms[:36], **CHAINS,
                                         **lib.opts, **kw)


def msid(u, lib=PORT, **kw):
    return lib.polymer.MeanSquareInternalDistance(u.atoms[:36], **CHAINS,
                                                  **lib.opts, **kw)


def vacf(u, lib=PORT, **kw):
    return lib.dynamics.VelocityAutocorrelation(u.atoms, **lib.opts, **kw)


def vacf_blocks(u, lib=PORT, **kw):
    return lib.dynamics.VelocityAutocorrelation(u.atoms, n_blocks=2,
                                                **lib.opts, **kw)


def ecacf(u, lib=PORT, **kw):
    return lib.dynamics.ElectricCurrentAutocorrelation(
        u.atoms, T_KELVIN, **lib.opts, **kw)


def flow_profile(u, lib=PORT, **kw):
    return lib.flow.FlowProfile(u.atoms, axis="z", n_bins=6, **lib.opts,
                                **kw)


#: name: (factory, trajectory, {result key (or private store): how the
#: ranks are held to the serial run: "equal" or "f64" (rtol 1e-12)})
PARALLEL = {
    "dp": (dp, "b", {"number_densities": "equal",
                     "charge_densities": "equal"}),
    "dp_frames": (dp_frames, "b", {"number_densities": "equal",
                                   "times": "equal"}),
    "dp_residues": (dp_residues, "b", {"number_densities": "equal"}),
    "dp_recenter": (dp_recenter, "d", {"number_densities": "equal"}),
    "dp_recenter_groups": (dp_recenter_groups, "d",
                           {"number_densities": "equal"}),
    "rdp": (rdp, "b", {"counts": "equal", "number_densities": "equal",
                       "charge_densities": "equal"}),
    "rdp_cylinder": (rdp_cylinder, "b", {"counts": "equal",
                                         "number_densities": "equal"}),
    "map2d": (map2d, "b", {"counts": "equal", "number_densities": "equal"}),
    "map3d": (map3d, "b", {"counts": "equal", "number_densities": "equal"}),
    "dipole": (dipole, "b", {"dipoles": "equal", "volumes": "equal"}),
    "survival_slab": (survival_slab, "b", {
        "_membership": "equal", "n_in_zone": "equal",
        "intermittent": "equal", "survival": "equal"}),
    "survival_shell": (survival_shell, "b", {
        "_membership": "equal", "n_in_zone": "equal",
        "intermittent": "equal", "survival": "equal"}),
    "gyradius": (gyradius, "b", {
        "gyradii": "equal", "asphericity": "equal", "acylindricity": "equal",
        "shape_anisotropy": "equal"}),
    "scsf": (scsf, "b", {"scsf": "f64", "wavenumbers": "equal"}),
    "persistence": (persistence, "b", {"bond_acf": "f64",
                                       "bond_lengths": "f64"}),
    "msid": (msid, "b", {"msid": "f64", "separations": "equal"}),
    "vacf": (vacf, "b", {"vacf": "equal", "vdos": "equal",
                         "times": "equal"}),
    "vacf_blocks": (vacf_blocks, "b", {"vacf": "equal", "acf": "equal",
                                       "vdos": "equal"}),
    "ecacf": (ecacf, "b", {"current": "equal", "acf": "equal",
                           "running_conductivity": "equal",
                           "conductivity": "equal"}),
    "flow": (flow_profile, "b", {"counts": "equal",
                                 "number_density": "equal",
                                 "mass_density": "f64", "velocity": "f64",
                                 "temperature": "f64"}),
}

#: one fused pass a payload (and one on the drifting fixture, for the
#: recentered profiles): name: (trajectory, payload width, cases)
FUSED = {
    "positions": ("b", 3, ("dp", "dp_frames", "rdp", "map3d", "dipole",
                           "survival_shell", "gyradius", "scsf", "msid")),
    "recentered": ("d", 3, ("dp_recenter", "dp_recenter_groups")),
    "velocities": ("b", 3, ("vacf", "ecacf")),
    "flow": ("b", 6, ("flow",)),
}


def fused_analyses(name, us, **kw):
    """The fused pass `name`'s analyses, in chunks of CHUNK frames of the
    shared stream (every atom and column of the payload)."""

    traj, width, cases = FUSED[name]
    u = us[traj]
    analyses = [PARALLEL[case][0](u, **kw) for case in cases]
    for a in analyses:
        a._chunk_bytes = CHUNK * u.atoms.n_atoms * width * 4
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

import torch

from mdhelper_tpu_torch.analysis.base import SerialAnalysisBase
from mdhelper_tpu_torch.analysis.multi import run_together

warnings.simplefilter("ignore")
us = universes(dict(np.load(os.path.join(WORKDIR, "inputs.npz"))))
saved, notes = {}, {}
for name, (factory, traj, keys) in PARALLEL.items():
    for selection, stop in SELECTIONS.items():
        a = chunked(factory(us[traj], parallel=True)).run(stop=stop)
        for key, value in arrays_of(a, keys).items():
            saved[f"{name}/{selection}:{key}"] = value
        notes[f"{name}/{selection}"] = {
            "shards": a._mesh.size, "rows": [len(r) for r in a._rank_rows]}
for name, (traj, _, cases) in FUSED.items():
    done = run_together(fused_analyses(name, us, parallel=True),
                        parallel=True)
    for case, a in zip(cases, done):
        for key, value in arrays_of(a, PARALLEL[case][2]).items():
            saved[f"fused_{name}/{case}:{key}"] = value

# A nested carry: sums at every depth, "max" for a subtree, a replicated
# leaf kept, a non-tensor leaf kept.
nested = SerialAnalysisBase(us["b"].trajectory, device="cpu")
nested._carry_reductions = {"peak": "max", "same": "replicated"}
r = float(RANK + 1)
carry = {
    "gram": (torch.full((2, 2), r, dtype=torch.float64),
             [torch.tensor([r, 2 * r])]),
    "peak": {"inner": (torch.tensor([r, -r]), torch.tensor(r))},
    "same": torch.tensor([r]),
    "label": "kept",
}
out = nested._reduce_rank_carry(carry)
saved["nested:gram0"] = out["gram"][0].numpy()
saved["nested:gram1"] = out["gram"][1][0].numpy()
saved["nested:peak0"] = out["peak"]["inner"][0].numpy()
saved["nested:peak1"] = out["peak"]["inner"][1].numpy()
saved["nested:same"] = out["same"].numpy()
notes["nested"] = {"label": out["label"],
                   "types": [type(out["gram"]).__name__,
                             type(out["gram"][1]).__name__]}

np.savez(os.path.join(WORKDIR, f"rank{RANK}.npz"), **saved)
with open(os.path.join(WORKDIR, f"rank{RANK}.json"), "w") as f:
    json.dump(notes, f)
'''

_cases = {}
exec(CASES, _cases)
PARALLEL, FUSED = _cases["PARALLEL"], _cases["FUSED"]
SELECTIONS = _cases["SELECTIONS"]
PORT = _cases["PORT"]
JAX = types.SimpleNamespace(dynamics=jax_dynamics, electrostatics=jax_es,
                            flow=jax_flow, polymer=jax_polymer,
                            profile=jax_profile, opts={"verbose": False})
RECENTERED = ("dp_recenter", "dp_recenter_groups")
RUNS = [(name, sel) for name in PARALLEL for sel in SELECTIONS]
FUSED_RUNS = [(f, case) for f, (_, _, cases) in FUSED.items()
              for case in cases]


def _inputs():
    rng = np.random.default_rng(42)
    b = (rng.random((11, 37, 3)) * _cases["BOX_B"]).astype(np.float32)
    rng = np.random.default_rng(5)
    v = (2.0 * rng.standard_normal((11, 37, 3))).astype(np.float32)
    # tests/test_analysis_profile.py's drifting fixture, at 11 frames
    dims = _cases["DIMS_D"]
    rng = np.random.default_rng(41)
    base = rng.random((1, 24, 3)) * 4 + 1
    drift = (np.linspace(0, 3.5 * dims[2], 11)[:, None, None]
             * np.array([0, 0, 1.0]))
    d = ((base + drift) % dims).astype(np.float32)
    return {"b": b, "v": v, "d": d,
            "masses": np.random.default_rng(3).uniform(1.0, 20.0, 37),
            "charges": np.tile([1.0, -1.0], 19)[:37],
            "resindices": np.arange(37) // 4}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def universes(inputs):
    return _cases["universes"](inputs)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    """Each rank's saved arrays and notes."""

    workdir = tmp_path_factory.mktemp("ranks")
    np.savez(workdir / "inputs.npz", **inputs)
    spawn_ranks(CASES + RANK_CODE, WORLD, str(workdir), timeout=240)
    return [
        (dict(np.load(workdir / f"rank{r}.npz")),
         json.loads((workdir / f"rank{r}.json").read_text()))
        for r in range(WORLD)
    ]


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


@pytest.fixture(scope="module")
def serial(universes):
    """The port's serial run of every case and selection, as arrays."""

    out = {}
    for name, sel in RUNS:
        factory, traj, keys = PARALLEL[name]
        a = _quiet(lambda: _cases["chunked"](factory(universes[traj])).run(
            stop=SELECTIONS[sel]))
        out[name, sel] = _cases["arrays_of"](a, keys)
    return out


@pytest.fixture(scope="module")
def jax_universes(inputs):
    data = {key: (value.astype(np.float64)
                  if value.dtype == np.float32 else value)
            for key, value in inputs.items()}
    return _cases["universes"](data, JaxUniverse)


def _jax_run(name, jax_universes, **kw):
    """The JAX package's run of case `name` (``parallel=True`` on its 8
    virtual devices unless `kw` says otherwise), streaming float32."""

    factory, traj, _ = PARALLEL[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        return _quiet(lambda: factory(jax_universes[traj], lib=JAX,
                                      **{"parallel": True, **kw}).run())


def _held(got, want, kind, what):
    if kind == "equal":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=what)


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
    want = serial[name, sel]
    arrays, notes = ranks[0]
    for key, value in want.items():
        _held(arrays[f"{name}/{sel}:{key}"], value,
              kinds[key.split(":")[0]], f"{name}/{sel}:{key}")
    rows = [n[f"{name}/{sel}"]["rows"] for _, n in ranks]
    assert all(n[f"{name}/{sel}"]["shards"] == WORLD for _, n in ranks)
    # frames of each rank's blocks (rank 2's last block of 2: one padded)
    assert rows == ([[2, 2], [2, 2], [2, 1]] if sel == "tail"
                    else [[2, 1], [2], [2]])


def _counts(dp):
    """A DensityProfile's time-averaged densities as counts."""

    volume = np.prod(dp._dimensions)
    return [np.rint(d * dp.n_frames * volume / n)
            for d, n in zip(dp.results.number_densities, dp._n_bins)]


def _to_jax(name, got, ref):
    """`got` (case `name`'s arrays of the ranks) against the JAX package's
    run `ref`, within the tolerances of the port's per-class tests."""

    def arr(key):
        return got[key]

    def eq(key, jkey=None):
        np.testing.assert_array_equal(arr(key), np.asarray(
            ref.results[jkey or key]), err_msg=key)

    def near(key, rtol=0.0, atol=0.0, jkey=None):
        np.testing.assert_allclose(arr(key), np.asarray(
            ref.results[jkey or key]), rtol=rtol, atol=atol, err_msg=key)

    box = _cases["BOX_B"]
    if name.startswith("dp"):
        for i, want in enumerate(ref.results.number_densities):
            np.testing.assert_array_equal(got[f"number_densities:{i}"],
                                          want)
    elif name.startswith("rdp"):
        eq("counts")
        near("number_densities", rtol=1e-12)
    elif name.startswith("map"):
        eq("counts")
        eq("number_densities")
    elif name == "dipole":
        # the float32 summation bound (n + 2) u sum |q| |r| of
        # tests/test_torch_electrostatics.py, with |r| <= the box
        scale = 20 * np.sqrt(3) * box
        near("dipoles", atol=22 * 2.0**-24 * scale)
        near("volumes", rtol=1e-12)
    elif name.startswith("survival"):
        eq("n_in_zone")
        for key in ("intermittent", "survival"):
            near(key, rtol=1e-12, atol=1e-12)
    elif name == "gyradius":
        near("gyradii", atol=4 * EPS32 * box)
        for key in ("asphericity", "acylindricity"):
            near(key, atol=1e-3)
        near("shape_anisotropy", atol=1e-3 / box)
    elif name == "scsf":
        scale = np.abs(ref.results.scsf).max()
        near("scsf", atol=1e-5 * scale)
        eq("wavenumbers")
    elif name == "persistence":
        np.testing.assert_allclose(got["bond_acf:0"],
                                   ref.results.bond_acf[0], atol=1e-6)
        near("bond_lengths", rtol=1e-6)
    elif name == "msid":
        near("msid", atol=1e-6 * np.abs(ref.results.msid).max())
    elif name.startswith("vacf"):
        for key in ("vacf", "vdos"):
            near(key, rtol=1e-10, atol=1e-12)
    elif name == "ecacf":
        # the JAX class sums the current in float32 (CURRENT_RTOL of
        # tests/test_torch_dynamics.py)
        near("current", atol=1e-4 * np.abs(ref.results.current).max())
        near("acf", atol=1e-4 * np.abs(ref.results.acf).max())
    elif name == "flow":
        eq("counts")
        for key in ("mass_density", "velocity", "temperature"):
            want = np.asarray(ref.results[key])
            near(key, rtol=2e-5, atol=2e-5 * np.nanmax(np.abs(want)))
    else:
        raise AssertionError(name)


@pytest.mark.parametrize("name", list(PARALLEL))
def test_ranks_match_jax_sharded_run(ranks, jax_universes, name):
    got = {key.split(":", 1)[1]: value
           for key, value in ranks[0][0].items()
           if key.startswith(f"{name}/tail:")}
    _to_jax(name, got, _jax_run(name, jax_universes))


@pytest.mark.parametrize("name", list(PARALLEL))
def test_parallel_without_process_group_equals_serial(universes, serial,
                                                      jax_universes, name):
    """A world of one on the CPU: bit for bit the serial run, but for the
    recentered profiles, whose pre-pass route is the JAX package's
    ``parallel=True`` route and equals its counts."""

    factory, traj, keys = PARALLEL[name]
    a = _quiet(lambda: _cases["chunked"](factory(universes[traj],
                                                 parallel=True)).run())
    assert a._mesh.world == 1 and a._mesh.grouped is False
    got = _cases["arrays_of"](a, keys)
    if name in RECENTERED:
        assert a._frame_shifts is not None
        _to_jax(name, got, _jax_run(name, jax_universes))
        return
    for key, value in serial[name, "tail"].items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("fused,case", FUSED_RUNS)
def test_fused_pass_over_ranks_equals_serial(ranks, serial, fused, case):
    """Each analysis of a fused pass over the ranks against its serial run
    alone; the recentered profiles against their standalone
    ``parallel=True`` runs over the same ranks."""

    kinds = PARALLEL[case][2]
    for arrays, _ in ranks:
        for key, value in serial[case, "tail"].items():
            got = arrays[f"fused_{fused}/{case}:{key}"]
            if case in RECENTERED:
                np.testing.assert_array_equal(
                    got, arrays[f"{case}/tail:{key}"], err_msg=key)
            else:
                _held(got, value, kinds[key.split(":")[0]], key)


def _oracle_counts(traj, n_bins):
    """tests/test_analysis_profile.py's numpy pipeline: float64 unwrap of
    every atom, the shift of their mean to the box centre, the wrap, and
    z histograms summed over the frames."""

    dims = _cases["DIMS_D"]
    traj = traj.astype(np.float64)
    counts = np.zeros(n_bins)
    prev = traj[0].copy()
    images = np.zeros_like(prev)
    for pos in traj:
        delta = pos - prev
        images -= np.where(np.abs(delta) >= dims / 2, np.sign(delta), 0.0)
        prev = pos.copy()
        unwrapped = pos + images * dims
        shifted = unwrapped - (unwrapped.mean(axis=0) - dims / 2)
        shifted -= np.floor(shifted / dims) * dims
        counts += np.histogram(shifted[:, 2], n_bins, (0, dims[2]))[0]
    return counts


def test_fused_recentered_profile_equals_oracle_and_standalone(
        ranks, universes, inputs):
    """The recentered profile of a fused ``parallel=True`` pass, over the
    ranks and in a world of one, equals the numpy unwrap, shift and wrap
    and its standalone run as integers."""

    oracle = _oracle_counts(inputs["d"], 23)
    u = universes["d"]
    alone = _quiet(lambda: _cases["dp_recenter"](u, parallel=True).run())
    fused = _quiet(lambda: run_together(
        _cases["fused_analyses"]("recentered", universes, parallel=True),
        parallel=True))[0]
    for dp in (alone, fused):
        np.testing.assert_array_equal(_counts(dp)[0][0], oracle)
    np.testing.assert_array_equal(fused.results.number_densities[0],
                                  alone.results.number_densities[0])
    scale = 23 / (np.prod(_cases["DIMS_D"]) * 11)
    for arrays, _ in ranks:
        np.testing.assert_allclose(
            arrays["fused_recentered/dp_recenter:number_densities:0"][0],
            oracle * scale, rtol=1e-12, atol=0)


def test_jax_fused_pass_drops_the_recentering(jax_universes, inputs):
    """ROADMAP Queue 3, item 19: the JAX package's fused ``parallel=True``
    pass returns a ``parallel=True`` recentered profile without the
    recentering (its fused pass streams through a bare base without
    ``_host_transform``): the unrecentered profile, not the oracle's.  The
    port applies the shift (the test above)."""

    u = jax_universes["d"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        fused, = _quiet(lambda: jax_multi.run_together(
            [_cases["dp_recenter"](u, lib=JAX, parallel=True)],
            parallel=True))
        plain = _quiet(lambda: jax_profile.DensityProfile(
            u.atoms, axes="z", n_bins=23, verbose=False,
            parallel=True).run())
    np.testing.assert_array_equal(fused.results.number_densities[0],
                                  plain.results.number_densities[0])
    oracle = _oracle_counts(inputs["d"], 23)
    assert not np.array_equal(_counts(fused)[0][0], oracle)


def test_nested_carry_reduces_at_every_depth(ranks):
    """``_reduce_rank_carry`` on a dict of tuples, lists and dicts: every
    tensor leaf summed over the three ranks (values 1, 2, 3), the "max"
    subtree reduced by its maximum, the replicated leaf and the string
    kept, the containers' types kept."""

    for arrays, notes in ranks:
        np.testing.assert_array_equal(arrays["nested:gram0"],
                                      np.full((2, 2), 6.0))
        np.testing.assert_array_equal(arrays["nested:gram1"], [6.0, 12.0])
        np.testing.assert_array_equal(arrays["nested:peak0"], [3.0, -1.0])
        np.testing.assert_array_equal(arrays["nested:peak1"], 3.0)
        assert notes["nested"] == {"label": "kept",
                                   "types": ["tuple", "list"]}
    for rank, (arrays, _) in enumerate(ranks):
        np.testing.assert_array_equal(arrays["nested:same"], [rank + 1.0])


def test_host_transform_rounds_once(universes):
    """The pre-pass shift is subtracted in float64 from the float32
    positions as read and rounded once to float32."""

    a = _cases["dp_recenter"](universes["d"], parallel=True)
    a._setup_frames()
    a._prepare()
    positions = np.asarray(universes["d"].trajectory.read_frames(
        np.arange(3))[0])[:, :, [2]]
    got = a._host_transform(positions, np.arange(3))
    want = (positions.astype(np.float64)
            - a._frame_shifts[:3, None, [2]]).astype(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
