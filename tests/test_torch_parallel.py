"""The port's rank runtime (``parallel=True``, ``shard=``) against its
serial runs and the JAX package's sharded runs.

One job of three gloo ranks on the CPU (``testing.spawn_ranks``: spawned
processes, one thread each, a ``file://`` rendezvous under ``tmp_path``,
a 60 s collective timeout) runs every case of ``CASES`` and saves each
rank's results; the tests hold them against the port's serial runs of the
same cases in this process (integer counts equal, S(q) and the ISF within
the JAX test's bounds, stores bit for bit), against the JAX package's
sharded runs on its 8 virtual CPU devices (streaming float32), and rank
against rank.  The inputs are the awkward sizes of
``tests/test_sharding_modes.py`` (83 atoms, 5 frames) and
``tests/test_multihost.py`` (37 atoms, 11 frames in 4-frame chunks, which
leave a padded tail on some ranks).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import mdhelper_tpu.analysis.base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import structure as jax_structure  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu_torch.analysis.base import (  # noqa: E402
    DynamicAnalysisBase,
    ParallelAnalysisBase,
)
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.testing import spawn_ranks  # noqa: E402

WORLD = 3
ROOT = Path(__file__).resolve().parent.parent

#: The cases, run by the ranks and by this process alike (the ranks
#: import no test module, and so no JAX).
CASES = '''
import numpy as np
import torch

from mdhelper_tpu_torch.analysis import structure as st
from mdhelper_tpu_torch.analysis.base import DynamicAnalysisBase
from mdhelper_tpu_torch.core.universe import Universe

BOX_A, BOX_B = 12.0, 10.0
#: frames a chunk of the runs on trajectory "b" (11 frames)
CHUNK_B = 4


def universes(data):
    return {
        "a": Universe.from_arrays(data["a"], [BOX_A] * 3 + [90.0] * 3),
        "b": Universe.from_arrays(data["b"], [BOX_B] * 3 + [90.0] * 3,
                                  dt=1.0),
    }


def chunked(analysis, n_atoms):
    analysis._chunk_bytes = CHUNK_B * n_atoms * 3 * 4
    return analysis


def rdf_a(u, **kw):
    return st.RadialDistributionFunction(
        u.atoms, n_bins=64, range=(0.0, 5.5), exclusion=(1, 1),
        verbose=False, device="cpu", **kw)


def rdf_a_drop(u, **kw):
    return st.RadialDistributionFunction(
        u.atoms, n_bins=32, range=(0.0, 4.0), exclusion=(1, 1),
        drop_axis="z", verbose=False, device="cpu", **kw)


def rdf_a_cross(u, **kw):
    return st.RadialDistributionFunction(
        u.atoms[:30], u.atoms[30:], n_bins=48, range=(0.0, 5.0),
        verbose=False, device="cpu", **kw)


def rdf_a_cross_23(u, **kw):
    return rdf_a_cross(u, exclusion=(2, 3), **kw)


def rdf_b(u, **kw):
    return chunked(st.RadialDistributionFunction(
        u.atoms, n_bins=32, range=(0.0, 4.5), exclusion=(1, 1),
        verbose=False, device="cpu", **kw), u.atoms.n_atoms)


def rdf_b_offset(u, **kw):
    return chunked(st.RadialDistributionFunction(
        u.atoms, n_bins=30, range=(1.0, 4.0), verbose=False,
        device="cpu", **kw), u.atoms.n_atoms)


def sf_a(u, **kw):
    return st.StructureFactor(u.atoms, n_points=5, verbose=False,
                              device="cpu", **kw)


def sf_a_partial(u, **kw):
    third = u.atoms.n_atoms // 3
    return st.StructureFactor([u.atoms[:third], u.atoms[third:]],
                              mode="partial", n_points=4, verbose=False,
                              device="cpu", **kw)


def sf_b(u, **kw):
    return chunked(st.StructureFactor(
        u.atoms, n_points=4, sort=False, unique=False, verbose=False,
        device="cpu", **{"method": "direct", **kw}), u.atoms.n_atoms)


def isf_b(u, **kw):
    return chunked(st.IntermediateScatteringFunction(
        u.atoms, n_points=4, sort=False, unique=False, verbose=False,
        device="cpu", **kw), u.atoms.n_atoms)


class FrameMeans(DynamicAnalysisBase):
    """A user subclass: the mean position of each frame (a store) and
    their sum and frame count (the carry)."""

    _rank_sharded = True

    def __init__(self, u, parallel=False, sequential=False):
        super().__init__(u.trajectory, parallel, device="cpu")
        self._sequential = sequential

    def _checkpoint_attrs(self):
        return ("_means",)

    def _prepare(self):
        self._means = np.zeros((self.n_frames, 3))
        self._store_offset = 0
        self._carry = {"sum": torch.zeros(3, dtype=torch.float64),
                       "frames": torch.zeros((), dtype=torch.float64)}

        def update(carry, positions, dimensions, mask):
            means = positions.double().mean(dim=1)
            return {"sum": carry["sum"] + (means * mask[:, None]).sum(0),
                    "frames": carry["frames"] + mask.sum()}, means

        self._update = update
        self._store_chunk = self._store

    def _store(self, means, batch):
        n = batch.n_real
        self._means[self._store_offset:self._store_offset + n] = means[:n]
        self._store_offset += n

    def _conclude(self):
        self.results.means = self._means.copy()
        self.results.sum = self._carry["sum"].numpy()
        self.results.frames = float(self._carry["frames"])


def frame_means_b(u, **kw):
    return chunked(FrameMeans(u, **kw), u.atoms.n_atoms)


def unflagged(analysis):
    """`analysis` without the declaration that it reduces over ranks."""
    analysis._rank_sharded = False
    return analysis


def rouse_b(u):
    """Rouse modes of one 37-bead chain (unwrapped: an order-dependent
    carry)."""
    from mdhelper_tpu_torch.analysis.polymer import RouseModes

    return RouseModes(u.atoms, n_chains=1, n_monomers=37, verbose=False,
                      device="cpu")


def profile_b(u, **kw):
    from mdhelper_tpu_torch.analysis.profile import DensityProfile

    return DensityProfile(u.atoms, axes="z", n_bins=8, verbose=False,
                          device="cpu", **kw)



#: name: (factory, trajectory, keywords of the sharded run, result keys)
SHARDED = {
    "rdf_frames": (rdf_a, "a", {"shard": "frames"}, ("counts", "rdf")),
    "rdf_atoms": (rdf_a, "a", {"shard": "atoms"}, ("counts", "rdf")),
    "rdf_atoms_drop": (rdf_a_drop, "a", {"shard": "atoms"}, ("counts",)),
    "rdf_cross_ring": (rdf_a_cross, "a", {"shard": "atoms"},
                       ("counts", "rdf")),
    "rdf_cross_ring_23": (rdf_a_cross_23, "a", {"shard": "atoms"},
                          ("counts",)),
    "rdf_b_frames": (rdf_b, "b", {"parallel": True}, ("counts", "rdf")),
    "rdf_b_atoms": (rdf_b, "b", {"shard": "atoms"}, ("counts",)),
    "rdf_b_offset_atoms": (rdf_b_offset, "b", {"shard": "atoms"},
                           ("counts",)),
    "sf_a_frames": (sf_a, "a", {"shard": "frames"},
                    ("ssf", "wavenumbers")),
    "sf_a_q": (sf_a, "a", {"shard": "q"}, ("ssf", "wavenumbers")),
    "sf_a_partial_q": (sf_a_partial, "a", {"shard": "q"}, ("ssf",)),
    "sf_b_q": (sf_b, "b", {"shard": "q"}, ("ssf",)),
    "sf_b_frames": (sf_b, "b", {"parallel": True}, ("ssf",)),
    "isf_b": (isf_b, "b", {"parallel": True}, ("cisf",)),
    "frame_means": (frame_means_b, "b", {"parallel": True},
                    ("means", "sum", "frames")),
}
'''

#: What every rank runs (after ``spawn_ranks``'s prelude and CASES).
RANK_CODE = '''
import json
import warnings

from mdhelper_tpu_torch.analysis import structure as st
from mdhelper_tpu_torch.analysis.multi import run_together
from mdhelper_tpu_torch.analysis.transport import Onsager

us = universes(np.load(os.path.join(WORKDIR, "inputs.npz")))
saved, notes = {}, {}
for name, (factory, traj, kw, keys) in SHARDED.items():
    a = factory(us[traj], **kw).run()
    for key in keys:
        saved[f"{name}:{key}"] = np.asarray(a.results[key])
    if name == "isf_b":
        saved["isf_b:rho"] = a._rho
    notes[name] = {"shards": a._mesh.size, "index": a._mesh.index}

# n_jobs=2: rank 2 holds no frames and still joins the collectives.
a = frame_means_b(us["b"], parallel=True).run(n_jobs=2)
for key in ("means", "sum", "frames"):
    saved[f"frame_means_n_jobs:{key}"] = np.asarray(a.results[key])
notes["frame_means_n_jobs"] = {"shards": a._mesh.size,
                               "index": a._mesh.index}

rdf, sf = run_together([rdf_b(us["b"]), sf_b(us["b"])], parallel=True)
saved["fused:counts"] = rdf.results.counts
saved["fused:ssf"] = sf.results.ssf

# A capacity overflow on rank 1 alone (its cell kernel reports a crowded
# cell on its first call): every rank must re-plan and re-run together.
if RANK == 1:
    sweep = st.cell_pair_histogram

    def crowded(*args, **kwargs):
        counts, occ = sweep(*args, **kwargs)
        st.cell_pair_histogram = sweep
        return counts, occ + 10_000

    st.cell_pair_histogram = crowded
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    a = rdf_b(us["b"], parallel=True).run()
saved["overflow:counts"] = a.results.counts
notes["overflow"] = {
    "retries": a._capacity_retries,
    "warned": sum("re-planning" in str(w.message) for w in caught),
}

refusals = {
    "isf_ring": lambda: isf_b(us["b"], parallel=True, fft=False).run(),
    "sequential_subclass": lambda: frame_means_b(
        us["b"], parallel=True, sequential=True).run(),
    "checkpoint": lambda: frame_means_b(us["b"], parallel=True).run(
        checkpoint=os.path.join(WORKDIR, f"ckpt{RANK}.npz")),
    "fused_vanhove": lambda: run_together(
        [rdf_b(us["b"]), st.VanHoveFunction(
            us["b"].atoms, n_bins=16, range=(0.0, 4.0), n_lags=3,
            verbose=False, device="cpu")], parallel=True),
    "fused_onsager": lambda: run_together(
        [rdf_b(us["b"]), Onsager(us["b"].atoms, verbose=False,
                                 device="cpu")], parallel=True),
    "fused_initial": lambda: run_together(
        [rdf_b(us["b"])], parallel=True, initial=[None]),
    "fused_rouse": lambda: run_together(
        [rdf_b(us["b"]), rouse_b(us["b"])], parallel=True),
    "fused_recentered_profile": lambda: run_together(
        [rdf_b(us["b"]), profile_b(us["b"], recenter=0)], parallel=True),
    "fused_unsharded": lambda: run_together(
        [rdf_b(us["b"]), unflagged(frame_means_b(us["b"], parallel=True))],
        parallel=True),
    "unflagged_subclass": lambda: unflagged(
        frame_means_b(us["b"], parallel=True)).run(),
}
for name, call in refusals.items():
    try:
        call()
        notes[name] = None
    except Exception as err:  # the type and message are what is tested
        notes[name] = [type(err).__name__, str(err)]

np.savez(os.path.join(WORKDIR, f"rank{RANK}.npz"), **saved)
with open(os.path.join(WORKDIR, f"rank{RANK}.json"), "w") as f:
    json.dump(notes, f)
'''

_cases = {}
exec(CASES, _cases)
SHARDED = _cases["SHARDED"]


def _inputs():
    rng = np.random.default_rng(7)
    a = (rng.random((5, 83, 3)) * _cases["BOX_A"]).astype(np.float32)
    rng = np.random.default_rng(42)
    b = (rng.random((11, 37, 3)) * _cases["BOX_B"]).astype(np.float32)
    return {"a": a, "b": b}


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
    spawn_ranks(CASES + RANK_CODE, WORLD, str(workdir), timeout=150)
    return [
        (dict(np.load(workdir / f"rank{r}.npz")),
         json.loads((workdir / f"rank{r}.json").read_text()))
        for r in range(WORLD)
    ]


def _serial(name, universes):
    factory, traj, _, keys = SHARDED[name]
    if name.startswith("sf_") and "q" in name:
        # The q-sharded run takes the direct sums.
        a = factory(universes[traj], method="direct").run()
    else:
        a = factory(universes[traj]).run()
    return a


@pytest.mark.parametrize("name", list(SHARDED))
def test_every_rank_holds_the_same_results(ranks, name):
    keys = SHARDED[name][3]
    first = ranks[0][0]
    for arrays, _ in ranks[1:]:
        for key in keys:
            np.testing.assert_array_equal(arrays[f"{name}:{key}"],
                                          first[f"{name}:{key}"])


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_run_matches_serial(ranks, universes, name):
    """Counts as integers, S(q) and the ISF within rtol 1e-9 (the JAX
    multi-host test's bound; only the order of the frame sums differs),
    stores and the frame count bit for bit."""

    serial = _serial(name, universes)
    arrays = ranks[0][0]
    for key in SHARDED[name][3]:
        got, want = arrays[f"{name}:{key}"], np.asarray(serial.results[key])
        if key in ("counts", "means", "frames", "wavenumbers"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-13)
    if name == "isf_b":
        np.testing.assert_array_equal(arrays["isf_b:rho"], serial._rho)


def test_shards_and_ranks(ranks):
    """Shard counts: min(world, frames) for frames, min(world, atoms) for
    the ring, min(world, wavevectors) for q; each rank its own shard."""

    for rank, (_, notes) in enumerate(ranks):
        for name in SHARDED:
            assert notes[name] == {"shards": WORLD, "index": rank}, name


def test_n_jobs_caps_the_shards(ranks, universes):
    serial = _cases["frame_means_b"](universes["b"]).run()
    for rank, (arrays, notes) in enumerate(ranks):
        assert notes["frame_means_n_jobs"] == {
            "shards": 2, "index": rank if rank < 2 else None}
        np.testing.assert_array_equal(arrays["frame_means_n_jobs:means"],
                                      serial.results.means)
        assert arrays["frame_means_n_jobs:frames"] == 11


def test_run_together_parallel_equals_separate_runs(ranks, universes):
    rdf = _cases["rdf_b"](universes["b"]).run()
    sf = _cases["sf_b"](universes["b"]).run()
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays["fused:counts"],
                                      rdf.results.counts)
        np.testing.assert_allclose(arrays["fused:ssf"], sf.results.ssf,
                                   rtol=1e-9)


def test_overflow_on_one_rank_replans_every_rank(ranks, universes):
    serial = _cases["rdf_b"](universes["b"]).run()
    for arrays, notes in ranks:
        assert notes["overflow"] == {"retries": 1, "warned": 1}
        np.testing.assert_array_equal(arrays["overflow:counts"],
                                      serial.results.counts)


@pytest.mark.parametrize("name,kind,words", [
    ("isf_ring", "NotImplementedError", "Order-dependent analyses"),
    ("sequential_subclass", "NotImplementedError",
     "Order-dependent analyses"),
    ("checkpoint", "ValueError", "not registered for checkpointing"),
    ("fused_vanhove", "ValueError", "order-dependent physics"),
    ("fused_onsager", "ValueError", "order-dependent physics"),
    ("fused_initial", "NotImplementedError", "Queue 3, item 18"),
    ("fused_rouse", "ValueError", "order-dependent physics"),
    ("fused_recentered_profile", "ValueError", "order-dependent physics"),
    ("fused_unsharded", "NotImplementedError", "_rank_sharded = True"),
    ("unflagged_subclass", "NotImplementedError", "_rank_sharded = True"),
])
def test_refusals_over_ranks(ranks, name, kind, words):
    for _, notes in ranks:
        assert notes[name][0] == kind
        assert words in notes[name][1]


@pytest.mark.parametrize("name", ["fused_rouse", "fused_recentered_profile"])
def test_fused_unwrap_refuses_as_jax(ranks, inputs, name):
    """An unwrap scan in a fused pass over ranks raises the JAX package's
    refusal (its type and wording; the JAX package refuses it for any
    ``parallel=True``)."""

    from mdhelper_tpu.analysis import multi as jax_multi
    from mdhelper_tpu.analysis import polymer as jax_polymer
    from mdhelper_tpu.analysis import profile as jax_profile

    data = inputs["b"]
    u = JaxUniverse.from_arrays(
        data.astype(np.float64), np.array([_cases["BOX_B"]] * 3 + [90.0] * 3),
        masses=np.ones(data.shape[1]))
    other = (jax_polymer.RouseModes(u.atoms, n_chains=1, n_monomers=37,
                                    verbose=False)
             if name == "fused_rouse" else
             jax_profile.DensityProfile(u.atoms, axes="z", n_bins=8,
                                        recenter=0, verbose=False))
    rdf = jax_structure.RadialDistributionFunction(
        u.atoms, n_bins=32, range=(0.0, 4.5), verbose=False)
    with pytest.raises(ValueError) as jax_err:
        jax_multi.run_together([rdf, other], parallel=True)
    words = "streams order-dependent physics"
    assert words in str(jax_err.value)
    for _, notes in ranks:
        assert notes[name][0] == type(jax_err.value).__name__
        assert notes[name][1].startswith(f"{type(other).__name__} {words}")


def test_sequential_runs_under_one_rank(universes):
    """With no process group (a world of one) the order-dependent paths
    run, and equal their serial runs."""

    u = universes["b"]
    ring = _cases["isf_b"](u, parallel=True, fft=False).run()
    serial = _cases["isf_b"](u, fft=False).run()
    np.testing.assert_array_equal(ring.results.cisf, serial.results.cisf)
    from mdhelper_tpu_torch.analysis.transport import Onsager

    fused = run_together(
        [_cases["rdf_b"](u), Onsager(u.atoms, verbose=False, device="cpu")],
        parallel=True)
    alone = Onsager(u.atoms, verbose=False, device="cpu").run()
    np.testing.assert_array_equal(fused[1].results.msd_self,
                                  alone.results.msd_self)
    fused = run_together([_cases["rdf_b"](u), _cases["rouse_b"](u)],
                         parallel=True)
    alone = _cases["rouse_b"](u).run()
    for key in ("acf", "mean_square_amplitudes"):
        np.testing.assert_array_equal(fused[1].results[key],
                                      alone.results[key])
    means = _cases["frame_means_b"](u, parallel=True, sequential=True).run()
    assert means.results.frames == 11


@pytest.mark.parametrize("name", list(SHARDED))
def test_parallel_without_process_group_equals_serial(universes, name):
    """``parallel=True`` and ``shard=`` with no process group: a world of
    one on the analysis's device, bit for bit the serial run (S(q) by
    the same direct sums)."""

    factory, traj, kw, keys = SHARDED[name]
    sharded = factory(universes[traj], **kw).run()
    serial = _serial(name, universes)
    assert sharded._mesh.world == 1 and sharded._mesh.grouped is False
    for key in keys:
        np.testing.assert_array_equal(np.asarray(sharded.results[key]),
                                      np.asarray(serial.results[key]))


def _jax_rdf(inputs, name, **kwargs):
    """The JAX package's RDF of a case, streaming float32."""

    data = inputs[name[0]]
    box = _cases["BOX_A" if name[0] == "a" else "BOX_B"]
    u = JaxUniverse.from_arrays(
        data.astype(np.float64), np.array([box] * 3 + [90.0] * 3),
        types=np.array(["A"] * data.shape[1], dtype=object),
        masses=np.ones(data.shape[1]),
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base.SerialAnalysisBase, "_coord_dtype", np.float32)
        if name == "a_cross":
            a = jax_structure.RadialDistributionFunction(
                u.atoms[:30], u.atoms[30:], n_bins=48, range=(0.0, 5.0),
                verbose=False, **kwargs)
        elif name == "a_drop":
            a = jax_structure.RadialDistributionFunction(
                u.atoms, n_bins=32, range=(0.0, 4.0), exclusion=(1, 1),
                drop_axis="z", verbose=False, **kwargs)
        elif name == "a":
            a = jax_structure.RadialDistributionFunction(
                u.atoms, n_bins=64, range=(0.0, 5.5), exclusion=(1, 1),
                verbose=False, **kwargs)
        else:
            a = jax_structure.RadialDistributionFunction(
                u.atoms, n_bins=32, range=(0.0, 4.5), exclusion=(1, 1),
                verbose=False, **kwargs)
            a._chunk_bytes = _cases["CHUNK_B"] * data.shape[1] * 3 * 4
        return a.run()


@pytest.mark.parametrize("name,jax_case,jax_kwargs", [
    ("rdf_frames", "a", {"shard": "frames"}),
    ("rdf_atoms", "a", {"shard": "atoms"}),
    ("rdf_atoms_drop", "a_drop", {"shard": "atoms"}),
    ("rdf_cross_ring", "a_cross", {"shard": "atoms"}),
    ("rdf_cross_ring_23", "a_cross", {"shard": "atoms",
                                      "exclusion": (2, 3)}),
    ("rdf_b_frames", "b", {"parallel": True}),
    ("rdf_b_atoms", "b", {"shard": "atoms"}),
])
def test_rdf_ranks_equal_jax_sharded_runs(ranks, inputs, name, jax_case,
                                          jax_kwargs):
    jax_rdf = _jax_rdf(inputs, jax_case, **jax_kwargs)
    np.testing.assert_array_equal(ranks[0][0][f"{name}:counts"],
                                  jax_rdf.results.counts)


def test_invalid_shard_and_module_raise_as_jax(universes, inputs):
    u = universes["a"]
    ju = JaxUniverse.from_arrays(inputs["a"].astype(np.float64),
                                 np.array([12.0] * 3 + [90.0] * 3))
    for port, jax in (
            (lambda: _cases["rdf_a"](u, shard="bogus"),
             lambda: jax_structure.RadialDistributionFunction(
                 ju.atoms, shard="bogus")),
            (lambda: _cases["sf_a"](u, shard="atoms"),
             lambda: jax_structure.StructureFactor(ju.atoms, shard="atoms")),
            (lambda: _cases["sf_a"](u, shard="q", method="factor"),
             lambda: jax_structure.StructureFactor(
                 ju.atoms, shard="q", method="factor")),
            (lambda: _cases["isf_b"](universes["b"], shard="frames"),
             lambda: jax_structure.IntermediateScatteringFunction(
                 ju.atoms, shard="frames")),
            (lambda: _cases["frame_means_b"](u, parallel=True).run(
                module="bogus"),
             lambda: jax_base.ParallelAnalysisBase(ju.trajectory).run(
                 module="bogus"))):
        with pytest.raises(ValueError) as jax_err:
            jax()
        with pytest.raises(ValueError) as port_err:
            port()
        assert str(port_err.value) == str(jax_err.value)


def test_ring_needs_atoms_and_an_orthorhombic_box(universes):
    u = universes["a"]
    with pytest.raises(ValueError, match="groupings='atoms'"):
        _cases["rdf_a"](u, shard="atoms", groupings="residues")
    from mdhelper_tpu_torch.core.universe import Universe

    tri = Universe.from_arrays(np.zeros((1, 4, 3), np.float32),
                               [12.0] * 3 + [80.0, 90.0, 90.0])
    with pytest.raises(ValueError, match="orthorhombic"):
        _cases["rdf_a"](tri, shard="atoms")


def test_roster_classes_still_refuse_parallel(universes):
    """A user subclass of DynamicAnalysisBase that declares neither
    ``_rank_sharded`` nor ``_sequential`` raises for ``parallel=True``,
    naming what it must declare; a subclass that sets ``_rank_sharded``
    runs, and so does every class of the package (its roster:
    ``tests/test_torch_parallel_roster.py``)."""

    class Undeclared(DynamicAnalysisBase):
        def __init__(self, u, parallel=False):
            super().__init__(u.trajectory, parallel, device="cpu")

    u = universes["a"]
    with pytest.raises(NotImplementedError, match="_rank_sharded = True"):
        Undeclared(u, parallel=True)
    assert Undeclared(u)._parallel is False
    assert issubclass(DynamicAnalysisBase, ParallelAnalysisBase)
    means = _cases["frame_means_b"](u, parallel=True).run(n_jobs=2,
                                                          module="dask")
    assert means._mesh.world == 1


def test_build_lock_builds_once(tmp_path):
    """Two processes entering the build together: one builds, the other
    waits for the lock and finds the library."""

    worker = textwrap.dedent(f"""
        import sys, time
        from pathlib import Path
        sys.path.insert(0, {str(ROOT)!r})
        from mdhelper_tpu_torch.ops import _build

        lib = Path({str(tmp_path)!r}) / "lib.so"

        def build():
            with open(lib.parent / "builds.txt", "a") as f:
                f.write(sys.argv[1] + "\\n")
            time.sleep(1.0)
            lib.write_text("built")

        _build._build_once(lib, build)
        assert lib.read_text() == "built"
    """)
    script = tmp_path / "worker.py"
    script.write_text(worker)
    procs = [subprocess.Popen([sys.executable, str(script), str(i)])
             for i in range(2)]
    assert [p.wait(timeout=60) for p in procs] == [0, 0]
    assert len((tmp_path / "builds.txt").read_text().split()) == 1


def test_current_device_is_the_default(monkeypatch):
    """``require_cuda`` and ``resolve_device(None)`` take the current CUDA
    device (a rank's, once it is set), not always the first."""

    from mdhelper_tpu_torch import _device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert _device.require_cuda() == torch.device("cuda", 2)
    assert _device.resolve_device(None) == torch.device("cuda", 2)
    assert _device.resolve_device("cpu") == torch.device("cpu")
