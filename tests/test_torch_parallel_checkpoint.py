"""``checkpoint=`` over ranks: ``run()`` and ``run_together()`` killed
after a chunk and resumed, over three gloo ranks and across world sizes.

A checkpoint over ranks holds the whole job's state at a chunk boundary
(the carry reduced over the ranks, the stores gathered in frame order,
the frames done), so it is the file a serial run writes at that frame,
and it resumes over any number of ranks.  One job of three gloo ranks on
the CPU (``testing.spawn_ranks``) runs each case of ``KILLS``: a run
killed right after its ``after``-th save (the save raises, on every
rank alike), then a fresh run of the same analyses resuming from the
file, held to the uninterrupted run over the ranks.  The cases cover a
store-type class (``HydrogenBondAnalysis`` with its bond-existence
matrix), a carry class (``OrientationProfile``) and a fused pass of
both with ``ClusterSizeDistribution``; ranks given one shared path (rank
0 writes it) and ranks given their own; and a straddling resume: killed
at frame 6 in chunks of 6, resumed in chunks of 9, whose grid from frame
0 would split at 9 (the port's resumed stream starts at the checkpoint's
frame, so no chunk holds a frame twice), ending on a chunk that leaves
rank 2 no frame.  The 17 frames in chunks of 6 leave a padded tail on
rank 2 in every resume.

Across world sizes: a file that this process writes serially resumes
over the three ranks, and a file that the ranks write resumes serially
here; the ranks' file holds what the serial run's holds at that frame.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mdhelper_tpu_torch.testing import spawn_ranks  # noqa: E402

WORLD = 3

CASES = '''
import contextlib
import warnings

import numpy as np

from mdhelper_tpu_torch.analysis import base as runtime
from mdhelper_tpu_torch.analysis import cluster, hbonds, orientation
from mdhelper_tpu_torch.analysis.multi import run_together
from mdhelper_tpu_torch.core.universe import Universe
from mdhelper_tpu_torch.testing import water_system

N_FRAMES, BOX = 17, 12.0
OPTS = {"verbose": False, "device": "cpu"}


def water():
    frames, topology = water_system(np.random.default_rng(2033), 60, BOX,
                                    N_FRAMES, step=0.2)
    return Universe.from_arrays(frames, [BOX] * 3 + [90.0] * 3, dt=0.5,
                                **topology)


def hbond_case(u, **kw):
    return hbonds.HydrogenBondAnalysis(u, pair_counts=True, lifetimes=True,
                                       **OPTS, **kw)


def profile_case(u, **kw):
    return orientation.OrientationProfile(u.atoms[0::3], u.atoms[1::3],
                                          "z", 6, **OPTS, **kw)


def cluster_case(u, **kw):
    return cluster.ClusterSizeDistribution(u.atoms, 2.0, "residues", **OPTS,
                                           **kw)


#: name: (factories, fused); the results each is held on, and how:
#: "equal", or "f64" (float64 sums, within rtol 1e-12: the resumed chunks
#: group the frames otherwise)
RUNS = {
    "store": ((hbond_case,), False),
    "carry": ((profile_case,), False),
    "fused": ((hbond_case, cluster_case, profile_case), True),
}
KEYS = {
    hbond_case: {"counts": "equal", "occupancies": "equal",
                 "pair_counts": "equal", "_existence": "equal",
                 "lifetime": "equal", "survival": "equal"},
    profile_case: {"counts": "equal", "p1": "f64", "p2": "f64"},
    cluster_case: {"size_counts": "equal", "n_clusters": "equal",
                   "largest": "equal"},
}
#: case: (run, save after which the run is killed, frames a chunk of the
#: resumed run, shared path)
KILLS = {
    "store_shared": ("store", 2, 6, True),
    "store_own": ("store", 2, 6, False),
    "carry_shared": ("carry", 2, 6, True),
    "store_straddle": ("store", 1, 9, True),
    "fused_shared": ("fused", 2, 6, True),
    "fused_straddle": ("fused", 1, 9, False),
}


class Killed(Exception):
    """The kill: raised by a save on every rank alike."""


@contextlib.contextmanager
def killed_after(saves):
    """Every checkpoint save from here raises Killed once the run has made
    `saves` of them."""

    save = runtime._Checkpoint.save

    def killing(self, *args, **kwargs):
        save(self, *args, **kwargs)
        if self.saved == saves:
            raise Killed

    runtime._Checkpoint.save = killing
    try:
        yield
    finally:
        runtime._Checkpoint.save = save


def analyses(run, u, chunk, **kw):
    factories, _ = RUNS[run]
    out = [f(u, **kw) for f in factories]
    for a in out:
        a._chunk_bytes = chunk * u.atoms.n_atoms * 3 * 4
    return out


def go(run, u, chunk, checkpoint=None, parallel=True):
    """`run`'s analyses run (fused or alone) in chunks of `chunk` frames
    of the whole universe."""

    group = analyses(run, u, chunk, parallel=parallel)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if RUNS[run][1]:
            return run_together(group, parallel=parallel,
                                checkpoint=checkpoint)
        return [group[0].run(checkpoint=checkpoint)]


def kill(run, u, chunk, checkpoint, saves, parallel=True):
    with killed_after(saves):
        try:
            go(run, u, chunk, checkpoint, parallel)
        except Killed:
            return
    raise AssertionError("the run was not killed")


def arrays_of(run, done):
    out = {}
    for i, (factory, a) in enumerate(zip(RUNS[run][0], done)):
        for key in KEYS[factory]:
            value = (getattr(a, key) if key.startswith("_")
                     else a.results[key])
            out[f"{i}:{key}"] = np.asarray(value)
    return out


def kinds(run):
    return {f"{i}:{key}": kind
            for i, factory in enumerate(RUNS[run][0])
            for key, kind in KEYS[factory].items()}
'''

RANK_CODE = '''
import json
import shutil

u = water()
saved, notes = {}, {}
for run in RUNS:
    for key, value in arrays_of(run, go(run, u, 6)).items():
        saved[f"whole/{run}/{key}"] = value
for name, (run, after, chunk, shared) in KILLS.items():
    path = os.path.join(WORKDIR, f"{name}.npz" if shared
                        else f"{name}_{RANK}.npz")
    kill(run, u, 6, path, after)
    done = go(run, u, chunk, path)
    for key, value in arrays_of(run, done).items():
        saved[f"{name}/{key}"] = value
    notes[name] = sorted(f for f in os.listdir(WORKDIR)
                         if f.startswith(name))

# The serial file of this process, resumed over the ranks (each a copy).
mine = os.path.join(WORKDIR, f"from_serial_{RANK}.npz")
shutil.copy(os.path.join(WORKDIR, "serial.npz"), mine)
for key, value in arrays_of("store", go("store", u, 6, mine)).items():
    saved[f"from_serial/{key}"] = value

# A file of the ranks, killed at frame 12, for this process to resume.
kill("store", u, 6, os.path.join(WORKDIR, "to_serial.npz"), 2)
kill("fused", u, 6, os.path.join(WORKDIR, "to_serial_fused.npz"), 2)
if RANK == 0:
    # kept as written: the test that resumes the other goes on writing it
    shutil.copy(os.path.join(WORKDIR, "to_serial_fused.npz"),
                os.path.join(WORKDIR, "at_12_fused.npz"))

# Files that disagree: rank 0 alone has one.
if RANK == 0:
    shutil.copy(os.path.join(WORKDIR, "serial.npz"),
                os.path.join(WORKDIR, "lonely_0.npz"))
try:
    go("store", u, 6, os.path.join(WORKDIR, f"lonely_{RANK}.npz"))
    notes["lonely"] = None
except ValueError as err:
    notes["lonely"] = str(err)

np.savez(os.path.join(WORKDIR, f"rank{RANK}.npz"), **saved)
with open(os.path.join(WORKDIR, f"rank{RANK}.json"), "w") as f:
    json.dump(notes, f)
'''

_cases = {}
exec(CASES, _cases)
RUNS, KILLS = _cases["RUNS"], _cases["KILLS"]


def _held(got, want, kind, what):
    if kind == "equal":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=what)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The work directory and each rank's saved arrays and notes; before
    the job, this process writes ``serial.npz`` (the store run killed
    serially at frame 12)."""

    workdir = tmp_path_factory.mktemp("checkpoints")
    u = _cases["water"]()
    _cases["kill"]("store", u, 6, str(workdir / "serial.npz"), 2,
                   parallel=False)
    spawn_ranks(CASES + RANK_CODE, WORLD, str(workdir), timeout=240)
    return workdir, [
        (dict(np.load(workdir / f"rank{r}.npz")),
         json.loads((workdir / f"rank{r}.json").read_text()))
        for r in range(WORLD)
    ]


@pytest.fixture(scope="module")
def serial():
    """Each run serial and uninterrupted, as arrays."""

    u = _cases["water"]()
    return {run: _cases["arrays_of"](run, _cases["go"](run, u, 6,
                                                      parallel=False))
            for run in RUNS}


@pytest.mark.parametrize("name", list(KILLS))
def test_resumed_run_equals_the_uninterrupted_one(job, name):
    """Killed after its save, resumed from the file: every rank's results
    equal the uninterrupted run's over the ranks (integers and stores
    bit for bit, float64 sums within rtol 1e-12)."""

    run = KILLS[name][0]
    kinds = _cases["kinds"](run)
    for arrays, _ in job[1]:
        for key, kind in kinds.items():
            _held(arrays[f"{name}/{key}"], arrays[f"whole/{run}/{key}"],
                  kind, f"{name}/{key}")


@pytest.mark.parametrize("run", list(RUNS))
def test_uninterrupted_ranks_equal_serial(job, serial, run):
    kinds = _cases["kinds"](run)
    for arrays, _ in job[1]:
        for key, kind in kinds.items():
            _held(arrays[f"whole/{run}/{key}"], serial[run][key], kind, key)


@pytest.mark.parametrize("name", list(KILLS))
def test_shared_path_has_one_writer(job, name):
    """Ranks given one path share one file; ranks given their own each
    write theirs."""

    shared = KILLS[name][3]
    for _, notes in job[1]:
        assert notes[name] == ([f"{name}.npz"] if shared else
                               [f"{name}_{r}.npz" for r in range(WORLD)])


def test_serial_file_resumes_over_ranks(job, serial):
    kinds = _cases["kinds"]("store")
    for arrays, _ in job[1]:
        for key, kind in kinds.items():
            _held(arrays[f"from_serial/{key}"], serial["store"][key], kind,
                  key)


@pytest.mark.parametrize("run,file", [("store", "to_serial.npz"),
                                      ("fused", "to_serial_fused.npz")])
def test_ranks_file_resumes_serially(job, serial, run, file):
    workdir, _ = job
    u = _cases["water"]()
    done = _cases["go"](run, u, 6, str(workdir / file), parallel=False)
    got = _cases["arrays_of"](run, done)
    for key, kind in _cases["kinds"](run).items():
        _held(got[key], serial[run][key], kind, key)


def test_ranks_file_holds_the_serial_state(job, tmp_path):
    """The file the ranks wrote at frame 12 holds what a serial run writes
    there: the frames done, the carry (summed over the ranks) and the
    store prefix gathered in frame order."""

    workdir, _ = job
    u = _cases["water"]()
    path = str(tmp_path / "serial_fused.npz")
    _cases["kill"]("fused", u, 6, path, 2, parallel=False)
    with np.load(workdir / "at_12_fused.npz") as ranks, \
            np.load(path) as alone:
        assert set(ranks.files) == set(alone.files)
        assert int(ranks["__frames_done__"]) == int(alone["__frames_done__"])
        assert int(alone["__frames_done__"]) == 12
        for key in alone.files:
            got, want = ranks[key], alone[key]
            if "store||" in key and got.ndim and "__store_offset__" not in key:
                # the filled prefix (a results array is saved whole)
                got, want = got[:12], want[:12]
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)


def test_disagreeing_files_raise_on_every_rank(job):
    for _, notes in job[1]:
        assert "disagree" in notes["lonely"]
        assert "[12, None, None]" in notes["lonely"]


def test_checkpoint_needs_registered_stores_over_ranks_too():
    """A store-type analysis that has not registered its buffers raises
    the serial `ValueError` before streaming, with ``parallel=True`` as
    serially (over three ranks: ``tests/test_torch_parallel.py``'s
    ``checkpoint`` refusal)."""

    u = _cases["water"]()
    a = _cases["hbond_case"](u, parallel=True)
    a._checkpointable_stores = False
    with pytest.raises(ValueError, match="not registered for checkpointing"):
        a.run(checkpoint="unused.npz")
    assert not os.path.exists("unused.npz")
