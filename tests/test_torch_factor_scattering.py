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
