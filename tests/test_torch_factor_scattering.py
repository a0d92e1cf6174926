"""The port's factorized trig sums against
``mdhelper_tpu.ops.factor_scattering`` on the same float32 inputs."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.ops import factor_scattering as jfs  # noqa: E402

from mdhelper_tpu_torch.ops import factor_scattering as tfs  # noqa: E402

BOX = (20.0, 17.5, 23.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _grid(k, box):
    grids = [2 * np.pi * np.arange(k) / L for L in box]
    return np.stack(np.meshgrid(*grids, indexing="ij"), -1).reshape(-1, 3)


def test_factor_plan_matches():
    qs = _grid(5, BOX)[::-1]
    j, t = jfs.factor_plan(qs, BOX), tfs.factor_plan(qs, BOX)
    assert j["k"] == t["k"] and j["box"] == t["box"]
    np.testing.assert_array_equal(j["flat_idx"], t["flat_idx"])
    with pytest.raises(ValueError):
        tfs.factor_plan(qs + 1e-3, BOX)


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("weighted", [False, True])
def test_factor_trig_sums_match_jax(precision, weighted):
    rng = np.random.default_rng(7)
    # the size of tests/test_factor_scattering.py's atol=5e-4 case
    n, k = 1000, 7
    pos = (rng.random((n, 3)) * BOX).astype(np.float32)
    # unwrapped coordinates several boxes away: the reduction is periodic
    pos[::3] += np.float32([3 * BOX[0], -2 * BOX[1], 5 * BOX[2]])
    w = rng.random(n).astype(np.float32) if weighted else None
    jc, js = jfs.factor_trig_sums(
        jnp.asarray(pos), None if w is None else jnp.asarray(w),
        k=(k, k, k), box=BOX, precision=precision,
    )
    tc, ts = tfs.factor_trig_sums(
        torch.from_numpy(pos), None if w is None else torch.from_numpy(w),
        k=(k, k, k), box=BOX, precision=precision,
    )
    assert tc.dtype == torch.float32 and tc.shape == (k**3,)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=5e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=5e-4)


def test_exact_tables_match_f64_oracle():
    rng = np.random.default_rng(8)
    n, k = 2000, 6
    pos = (rng.random((n, 3)) * BOX).astype(np.float32)
    qs = _grid(k, BOX)
    plan = tfs.factor_plan(qs, BOX)
    c, s = tfs.factor_trig_sums(
        torch.from_numpy(pos), k=plan["k"], box=plan["box"],
        precision="exact",
    )
    phases = qs @ pos.astype(np.float64).T
    np.testing.assert_allclose(c.numpy()[plan["flat_idx"]],
                               np.cos(phases).sum(1), atol=5e-4)
    np.testing.assert_allclose(s.numpy()[plan["flat_idx"]],
                               np.sin(phases).sum(1), atol=5e-4)


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("weighted", [False, True])
def test_batch_equals_per_frame_loop(precision, weighted):
    """The plain path on a (B, N, 3) batch is the per-frame loop bit for
    bit, gathered or not through flat_idx."""

    rng = np.random.default_rng(9)
    n, k = 700, (5, 6, 4)
    pos = torch.from_numpy((rng.random((3, n, 3)) * BOX).astype(np.float32))
    w = torch.from_numpy(rng.random(n).astype(np.float32)) if weighted \
        else None
    flat = torch.from_numpy(rng.permutation(k[0] * k[1] * k[2])[:50])
    batch = tfs.factor_trig_sums(pos, w, k=k, box=BOX, precision=precision)
    picked = tfs.factor_trig_sums(pos, w, k=k, box=BOX, precision=precision,
                                  flat_idx=flat)
    for b in range(3):
        one = tfs.factor_trig_sums(pos[b], w, k=k, box=BOX,
                                   precision=precision)
        for i in (0, 1):
            assert torch.equal(batch[i][b], one[i])
            assert torch.equal(picked[i][b], one[i][flat])


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [(5, 7, 3), (40, 1, 1)])
def test_ragged_grids_match_jax(k, weighted, precision):
    """Grids whose extents are not the kernel's tile multiples, with and
    without weights, on unwrapped coordinates: the port's sums equal the
    JAX package's within the atol of tests/test_factor_scattering.py
    (5e-4, at n up to 6).  Fast tables take x / L in float32, which the
    two packages may round an ulp apart (XLA may multiply by 1 / L), and
    the phase n x / L carries that ulp n times: the fast tolerance grows
    with the largest n."""

    rng = np.random.default_rng(10)
    n = 1000
    pos = (rng.random((n, 3)) * BOX).astype(np.float32)
    pos[::3] += np.float32([3 * BOX[0], -2 * BOX[1], 5 * BOX[2]])
    w = rng.random(n).astype(np.float32) if weighted else None
    jc, js = jfs.factor_trig_sums(
        jnp.asarray(pos), None if w is None else jnp.asarray(w),
        k=k, box=BOX, precision=precision,
    )
    tc, ts = tfs.factor_trig_sums(
        torch.from_numpy(pos), None if w is None else torch.from_numpy(w),
        k=k, box=BOX, precision=precision,
    )
    assert tc.shape == (k[0] * k[1] * k[2],)
    atol = 5e-4 * (1 if precision == "exact" else max(1, (max(k) - 1) / 6))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=atol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=atol)


def _bad_inputs():
    pos = torch.zeros((2, 10, 3))
    return {
        "float64 positions": (pos.double(), None, None),
        "positions (10, 2)": (torch.zeros((10, 2)), None, None),
        "positions (1, 2, 10, 3)": (pos[None], None, None),
        "non-contiguous positions": (pos.transpose(0, 1), None, None),
        "numpy positions": (pos.numpy(), None, None),
        "float64 weights": (pos, torch.ones(10, dtype=torch.float64), None),
        "weights (9,)": (pos, torch.ones(9), None),
        "non-contiguous weights": (pos, torch.ones((10, 2))[:, 0], None),
        "float32 flat_idx": (pos, None, torch.zeros(3)),
        "precision": (pos, None, None),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_rejects_wrong_inputs(case):
    pos, w, flat = _bad_inputs()[case]
    precision = "double" if case == "precision" else "exact"
    with pytest.raises(ValueError):
        tfs.factor_trig_sums(pos, w, k=(3, 3, 3), box=BOX,
                             precision=precision, flat_idx=flat)


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        tfs.factor_trig_sums(torch.zeros((2, 8, 3), device="meta"),
                             k=(3, 3, 3), box=BOX)


#: (grid, atoms, frames) of the launch plans held to the workspace budget:
#: the fused path's shape, an ISF ring of 64 frames on the default 32^3
#: grid, a million atoms on 32^3 and 64^3, a ragged grid, and 128^3, where
#: one slice of one frame alone is 16 MB.
PLAN_CASES = [
    ((24, 24, 24), 100_000, 8),
    ((32, 32, 32), 100_000, 64),
    ((32, 32, 32), 1_000_000, 8),
    ((64, 64, 64), 1_000_000, 8),
    ((64, 64, 64), 1_000_000, 64),
    ((5, 7, 3), 5003, 2),
    ((128, 128, 128), 1_000_000, 8),
]


@pytest.mark.parametrize("k, n_atoms, n_frames", PLAN_CASES)
def test_launch_plan_stays_within_workspace_budget(k, n_atoms, n_frames):
    """A launch's float32 partial sums stay within the budget (a launch
    then takes fewer frames, or slices of more atoms), the workspace of
    factor_workspace holds those of every call of up to as many frames and
    atoms, the slices and frames cover the call, and the slices do not
    depend on the frames (so that a frame's sums do not either)."""

    budget = tfs._FACTOR_WORKSPACE
    n_grid = k[0] * k[1] * k[2]
    plan = tfs._factor_launch_plan(k, n_atoms, n_frames)
    assert 4 * plan["size"] <= max(budget, 4 * 2 * n_grid)
    assert plan["size"] == plan["slices"] * plan["frames"] * 2 * n_grid
    assert plan["slices"] * plan["split"] >= n_atoms
    assert (plan["slices"] - 1) * plan["split"] < n_atoms
    assert 1 <= plan["frames"] <= n_frames
    assert plan["split"] % plan["stage"] == 0
    assert 4 * plan["bound"] <= max(budget, 4 * 2 * n_grid)
    rng = np.random.default_rng(11)
    atoms = {1, 63, 64, 65, n_atoms - 1, n_atoms,
             *rng.integers(1, n_atoms + 1, 40).tolist()}
    frames = {1, 2, n_frames - 1, n_frames,
              *rng.integers(1, n_frames + 1, 10).tolist()}
    for n in atoms:
        one = tfs._factor_launch_plan(k, n, 1)
        for b in frames:
            got = tfs._factor_launch_plan(k, n, b)
            assert got["size"] <= plan["bound"], (n, b)
            assert (got["split"], got["stage"]) == (one["split"],
                                                     one["stage"]), (n, b)
    workspace = tfs.factor_workspace(k, n_atoms, n_frames, "meta")
    assert workspace.dtype == torch.float32
    assert workspace.numel() == plan["bound"]


def test_fused_shape_is_one_launch():
    """The fused path's chunk, 8 frames of 100k atoms on 24^3, is one
    launch of 49 slices of 2,048 atoms (43 MB of partial sums)."""

    plan = tfs._factor_launch_plan((24, 24, 24), 100_000, 8)
    assert (plan["frames"], plan["slices"], plan["split"]) == (8, 49, 2048)
