"""The atom-sharded ring (``parallel/ring.py``) against the JAX package's
``ring_radial_histogram`` and float64 oracles.

Three gloo ranks on the CPU (``testing.spawn_ranks``) run the ring on the
awkward sizes of ``tests/test_sharding_modes.py`` (83 atoms in a 12 A
box) and ``tests/test_multihost.py`` (37 atoms in 10 A), self and cross
(30 x 53, 12 x 25), with exclusions None, (1, 1) and (2, 3), exact and
fast; the exact counts must equal the JAX function's on its 8 virtual
CPU devices (float32 positions) as integers, the fast ones the port's
world-of-one run.  In this process: the ring step's pieces (global
exclusion ids in the cross sweep's slot tables, the plain dense block)
against float64 oracles, on the bin-edge straddle fixture too.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from mdhelper_tpu.parallel.ring import (  # noqa: E402
    ring_radial_histogram as jax_ring,
)
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from mdhelper_tpu_torch.parallel.ring import (  # noqa: E402
    _plain_block_counts,
    ring_radial_histogram,
)
from mdhelper_tpu_torch.testing import (  # noqa: E402
    edge_straddle_positions,
    spawn_ranks,
)

WORLD = 3
EXCLUSIONS = (None, (1, 1), (2, 3))

#: (name, seed, atoms, box, edges' (r_min, r_max, bins), cross split)
SYSTEMS = (
    ("a", 7, 83, 12.0, (0.0, 5.5, 64), 30),
    ("b", 42, 37, 10.0, (0.0, 4.5, 32), 12),
    ("b_offset", 42, 37, 10.0, (1.0, 4.5, 28), 12),
)

CASES = [
    (system, cross, exclusion, precision)
    for system in SYSTEMS
    for cross in (False, True)
    for exclusion in EXCLUSIONS
    for precision in ("exact", "fast")
]


def _key(system, cross, exclusion, precision):
    return (f"{system[0]}-{'cross' if cross else 'self'}-"
            f"{'none' if exclusion is None else '%d%d' % exclusion}-"
            f"{precision}")


def _positions(system):
    _, seed, n, box, _, _ = system
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * box).astype(np.float32)


def _edges(system):
    lo, hi, bins = system[4]
    return np.linspace(lo, hi, bins + 1)


def _arguments(system, cross):
    pos = _positions(system)
    split = system[5]
    if cross:
        return pos[:split], {"positions2": pos[split:]}
    return pos, {}


RANK_CODE = '''
import json

import numpy as np

from mdhelper_tpu_torch.parallel.mesh import get_mesh
from mdhelper_tpu_torch.parallel.ring import ring_radial_histogram

cases = json.load(open(os.path.join(WORKDIR, "cases.json")))
data = np.load(os.path.join(WORKDIR, "inputs.npz"))
out = {}
for key, (box, edges, exclusion, precision) in cases.items():
    kw = {"positions2": data[key + ":2"]} if key + ":2" in data else {}
    out[key] = ring_radial_histogram(
        data[key], [box] * 3, np.asarray(edges), exclusion=(
            None if exclusion is None else tuple(exclusion)),
        precision=precision, device="cpu", **kw)
    # Two of the three ranks on the ring; the third joins the sum.
    out[key + ":two"] = ring_radial_histogram(
        data[key], [box] * 3, np.asarray(edges),
        get_mesh(2, axis_name="atoms"),
        exclusion=None if exclusion is None else tuple(exclusion),
        precision=precision, device="cpu", **kw)
np.savez(os.path.join(WORKDIR, f"rank{RANK}.npz"), **out)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ring")
    cases, arrays = {}, {}
    for system, cross, exclusion, precision in CASES:
        key = _key(system, cross, exclusion, precision)
        pos, kw = _arguments(system, cross)
        arrays[key] = pos
        if kw:
            arrays[key + ":2"] = kw["positions2"]
        cases[key] = (system[3], _edges(system).tolist(), exclusion,
                      precision)
    np.savez(workdir / "inputs.npz", **arrays)
    (workdir / "cases.json").write_text(json.dumps(cases))
    spawn_ranks(RANK_CODE, WORLD, str(workdir), timeout=150)
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("case", CASES, ids=[_key(*c) for c in CASES])
def test_ring_over_ranks(ranks, case):
    """Every rank holds the same counts, with three shards and with two;
    exact counts equal the JAX ring's as integers, fast ones the port's
    world-of-one run (the cell kernels' fast binning, not the JAX
    function's float32 ``searchsorted``)."""

    system, cross, exclusion, precision = case
    key = _key(*case)
    for arrays in ranks:
        np.testing.assert_array_equal(arrays[key], ranks[0][key])
        np.testing.assert_array_equal(arrays[key + ":two"], ranks[0][key])
    pos, kw = _arguments(system, cross)
    box = np.array([system[3]] * 3)
    if precision == "exact":
        want = jax_ring(pos, box, _edges(system), exclusion=exclusion,
                        precision="exact", **kw)
    else:
        want = ring_radial_histogram(pos, box, _edges(system),
                                     exclusion=exclusion, precision="fast",
                                     device="cpu", **kw)
    np.testing.assert_array_equal(ranks[0][key], want)


def _f64_counts(pos1, pos2, box, edges, exclusion, offsets):
    delta = pos1[:, None].astype(np.float64) - pos2[None].astype(np.float64)
    delta -= box * np.round(delta / box)
    dist = np.sqrt((delta**2).sum(-1))
    if exclusion is not None:
        i = offsets[0] + np.arange(len(pos1))
        j = offsets[1] + np.arange(len(pos2))
        dist = dist[(i[:, None] // exclusion[0]) != (j[None] // exclusion[1])]
    return np.histogram(dist.ravel(), bins=edges)[0]


@pytest.mark.parametrize("exclusion", EXCLUSIONS)
@pytest.mark.parametrize("offsets", [(0, 0), (0, 195), (195, 0), (6, 391)])
def test_step_blocks_with_global_ids(exclusion, offsets):
    """A ring step's block on the straddle fixture (bin edge 1.25, 30
    pairs at it and 30 one float32 ulp either side): the cross sweep's
    plain version with ``id_offsets`` and the plain dense block agree as
    integers, and with a float64 oracle on the global ids."""

    rng = np.random.default_rng(11)
    box, r_max, n_bins = 12.0, 5.0, 16
    pos = edge_straddle_positions(rng, box)
    pos1, pos2 = pos[:195], pos[195:]
    plan = cch.cell_plan_search(len(pos1), [box] * 3, r_max,
                                n_atoms2=len(pos2))
    frames1, frames2 = (torch.from_numpy(p)[None] for p in (pos1, pos2))
    cell, _, _ = cch.cross_pair_histogram(
        frames1, frames2, box=(box,) * 3, r_max=r_max,
        n_cells_dim=plan["n_cells_dim"], reach=plan["reach"],
        capacity1=plan["capacity"], capacity2=plan["capacity2"],
        n_bins=n_bins, exclusion=exclusion, id_offsets=offsets)
    dense = _plain_block_counts(
        frames1, frames2, torch.tensor([[box] * 3], dtype=torch.float32),
        r_min=0.0, r_max=r_max, n_bins=n_bins, exclusion=exclusion,
        offsets=offsets, precision="exact")
    np.testing.assert_array_equal(cell[0].numpy(), dense[0].numpy())
    want = _f64_counts(pos1, pos2, box, np.linspace(0.0, r_max, n_bins + 1),
                       exclusion, offsets)
    np.testing.assert_array_equal(dense[0].numpy(), want)


def test_ids_past_float32_range_raise():
    frames = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError, match="float32"):
        cch.cross_pair_histogram(
            frames, frames, box=(12.0,) * 3, r_max=3.0,
            n_cells_dim=(4, 4, 4), capacity1=32, capacity2=32, n_bins=8,
            exclusion=(1, 1), id_offsets=(0, cch._MAX_EXACT_ID - 2))


def test_ring_takes_uniform_edges_only():
    pos = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="uniform"):
        ring_radial_histogram(pos, [10.0] * 3, [0.0, 1.0, 3.0],
                              device="cpu")


def test_world_of_one_mesh():
    """Without a process group the mesh is one rank, shard 0, and the
    collectives are the identity."""

    mesh = port_mesh.get_mesh()
    assert (mesh.world, mesh.size, mesh.index, mesh.grouped) == (
        1, 1, 0, False)
    t = torch.arange(5.0)
    assert port_mesh.all_reduce(t) is t
    assert port_mesh.all_gather_tiles(t) is t
    assert port_mesh.process_frame_block(6, mesh) == (0, 6)


GROUP_OF_ONE = '''
import numpy as np

from mdhelper_tpu_torch.analysis.structure import (
    IntermediateScatteringFunction,
)
from mdhelper_tpu_torch.core.universe import Universe
from mdhelper_tpu_torch.parallel.mesh import get_mesh

mesh = get_mesh()
assert (mesh.world, mesh.grouped) == (1, True)
rng = np.random.default_rng(3)
u = Universe.from_arrays((rng.random((6, 20, 3)) * 8).astype(np.float32),
                         [8.0] * 3 + [90.0] * 3, dt=1.0)
kw = dict(n_points=3, fft=False, verbose=False, device="cpu")
ring = IntermediateScatteringFunction(u.atoms, parallel=True, **kw).run()
serial = IntermediateScatteringFunction(u.atoms, **kw).run()
assert ring._mesh.grouped
np.testing.assert_array_equal(ring.results.cisf, serial.results.cisf)
print("group of one OK")
'''


def test_sequential_runs_in_a_group_of_one(tmp_path):
    """One gloo rank with a process group: the ISF's lag ring runs under
    ``parallel=True`` and its carry passes the (identity) reduction."""

    out = spawn_ranks(GROUP_OF_ONE, 1, str(tmp_path), timeout=90)
    assert "group of one OK" in out[0]
