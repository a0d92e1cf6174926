"""The port's cell-list pair histogram
(:mod:`mdhelper_tpu_torch.ops.cuda_cell_histogram`) against the JAX
package's Pallas kernel (interpret mode), the exact XLA sweep and a
float64 NumPy oracle.  Counts are compared as integers."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.ops.histogram import (  # noqa: E402
    radial_histogram_frame as jax_radial_histogram_frame,
)
from mdhelper_tpu.ops.pallas_cell_histogram import (  # noqa: E402
    cell_pair_histogram_pallas,
    pallas_cell_plan,
)

from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.ops.histogram import (  # noqa: E402
    radial_histogram_frame,
)
from mdhelper_tpu_torch.testing import (  # noqa: E402
    edge_straddle_positions,
    f64_pair_histogram,
)

# The size of tests/test_pallas.py's cell-kernel case.
N, BOX, R_MAX, N_BINS = 1200, 16.0, 3.5, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(pos, plan, box=BOX, r_max=R_MAX, n_bins=N_BINS):
    counts, occ = cch.cell_pair_histogram(
        torch.from_numpy(pos), box=(box,) * 3, r_max=r_max,
        n_cells_dim=plan["n_cells_dim"], capacity=plan["capacity"],
        n_bins=n_bins,
    )
    assert int(occ.max()) <= plan["capacity"]
    return counts[0].numpy().astype(np.int64)


@pytest.fixture(scope="module")
def uniform():
    rng = np.random.default_rng(31)
    return (rng.random((N, 3)) * BOX).astype(np.float32)


@pytest.fixture(scope="module")
def straddle():
    """Pairs at the bin edge 1.25 (5 bins of 0.25), one float32 ulp
    below it and one above."""

    return edge_straddle_positions(np.random.default_rng(99), BOX)


def test_reference_equals_pallas_interpret(uniform):
    plan = pallas_cell_plan(N, [BOX] * 3, R_MAX)
    counts, _ = cell_pair_histogram_pallas(
        jnp.asarray(uniform), box=(BOX,) * 3, r_max=R_MAX,
        n_cells_dim=plan["n_cells_dim"], capacity=plan["capacity"],
        n_bins=N_BINS, precision="exact",
    )
    port_plan = cch.cell_plan_search(N, [BOX] * 3, R_MAX)
    np.testing.assert_array_equal(
        _port(uniform, port_plan), np.asarray(counts).astype(np.int64)
    )


def test_reference_equals_f64_oracle(uniform):
    plan = cch.cell_plan_search(N, [BOX] * 3, R_MAX)
    np.testing.assert_array_equal(
        _port(uniform, plan), f64_pair_histogram(uniform, BOX, R_MAX, N_BINS)
    )


def test_two_legal_plans_agree(uniform):
    searched = cch.cell_plan_search(N, [BOX] * 3, R_MAX)
    other = {"n_cells_dim": (3, 4, 3), "capacity": 128}
    assert tuple(searched["n_cells_dim"]) != other["n_cells_dim"]
    np.testing.assert_array_equal(
        _port(uniform, searched), _port(uniform, other)
    )


def test_plan_search_main_path_shape():
    """At the benchmark's 100k atoms in a 50 A box with r_max 6 the
    search lands on the (8, 8, 8) reach-1 grid at capacity 256; a box
    under 3 cutoffs gets a generalized grid, whose reach covers r_max
    (tests/test_torch_generalized.py)."""

    plan = cch.cell_plan_search(100_000, [50.0] * 3, 6.0)
    assert plan["n_cells_dim"] == (8, 8, 8)
    assert plan["capacity"] == 256
    assert plan["reach"] == (1, 1, 1)
    small = cch.cell_plan_search(1000, [10.0] * 3, 4.0)
    assert cch._generalized(small["n_cells_dim"], small["reach"])
    assert all(m * 10.0 / n >= 4.0 or n <= 2 * m + 1
               for n, m in zip(small["n_cells_dim"], small["reach"]))


def test_edge_straddle_fixture(straddle):
    r_max, n_bins = 4.0, 16
    oracle = f64_pair_histogram(straddle, BOX, r_max, n_bins)
    plan = cch.cell_plan_search(len(straddle), [BOX] * 3, r_max)
    np.testing.assert_array_equal(
        _port(straddle, plan, r_max=r_max, n_bins=n_bins), oracle
    )
    edges = np.linspace(0.0, r_max, n_bins + 1)
    box = np.full(3, BOX, np.float32)
    brute = radial_histogram_frame(
        torch.from_numpy(straddle), torch.from_numpy(straddle),
        torch.from_numpy(box), edges, exclusion=(1, 1),
    )
    np.testing.assert_array_equal(brute.numpy(), oracle)
    jax_counts = jax_radial_histogram_frame(
        jnp.asarray(straddle), jnp.asarray(straddle), jnp.asarray(box),
        jnp.asarray(edges), exclusion=(1, 1), precision="exact",
    )
    np.testing.assert_array_equal(
        np.asarray(jax_counts).astype(np.int64), oracle
    )


def test_capacity_overflow_on_clustered_frame():
    rng = np.random.default_rng(5)
    box, n = 20.0, 1000
    pos = rng.random((1, n, 3)) * box
    pos[0, :500] = 1.0 + rng.random((500, 3)) * 2.0  # one dense cell
    u = Universe.from_arrays(pos.astype(np.float32), [box] * 3)
    rdf = RadialDistributionFunction(
        u.atoms, n_bins=20, range=(0.0, 4.0), verbose=False,
        device="cpu",
    )
    with pytest.warns(UserWarning, match="capacity"):
        with pytest.raises(cch.CellCapacityOverflow):
            rdf.run()
    assert rdf._capacity_retries == 2


def test_shrunken_box_poisons_frame(uniform):
    plan = cch.cell_plan_search(N, [BOX] * 3, R_MAX)
    boxes = torch.tensor([[BOX] * 3, [BOX * 0.7] * 3], dtype=torch.float32)
    pos = torch.from_numpy(np.stack([uniform, uniform * np.float32(0.7)]))
    counts, _ = cch.cell_pair_histogram(
        pos, box=boxes, r_max=R_MAX, n_cells_dim=plan["n_cells_dim"],
        capacity=plan["capacity"], n_bins=N_BINS,
    )
    assert torch.isfinite(counts[0]).all()
    assert torch.isnan(counts[1]).all()


def test_cpu_tensor_takes_reference_without_launch(uniform):
    plan = cch.cell_plan_search(N, [BOX] * 3, R_MAX)
    before = cch.cell_pair_histogram.launches
    _port(uniform, plan)
    assert cch.cell_pair_histogram.launches == before
