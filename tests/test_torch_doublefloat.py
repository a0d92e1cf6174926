"""The port's double-float primitives are bit-equal to the JAX
package's on random and near-tie float32 inputs."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.ops import doublefloat as jdf  # noqa: E402

from mdhelper_tpu_torch.ops import doublefloat as tdf  # noqa: E402

N = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _inputs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        # magnitudes over ten decades, both signs
        a = rng.normal(size=N) * 10.0 ** rng.uniform(-5, 5, N)
        b = rng.normal(size=N) * 10.0 ** rng.uniform(-5, 5, N)
        return a.astype(np.float32), b.astype(np.float32)
    # near ties: b within a few float32 ulps of a (or of -a)
    a = (rng.random(N) * 50.0).astype(np.float32)
    steps = rng.integers(-3, 4, N)
    b = a.copy()
    for _ in range(3):
        b = np.where(steps > 0, np.nextafter(b, np.float32(np.inf)), b)
        b = np.where(steps < 0, np.nextafter(b, np.float32(-np.inf)), b)
        steps = steps - np.sign(steps)
    sign = np.where(rng.random(N) < 0.5, 1, -1).astype(np.float32)
    return a, (b * sign).astype(np.float32)


def _both(fn_name, *arrays):
    j = getattr(jdf, fn_name)(*[jnp.asarray(a) for a in arrays])
    t = getattr(tdf, fn_name)(*[torch.from_numpy(a) for a in arrays])
    return j, t


def _pairs(x, y, lo_scale=1e-8):
    return (x, (y * np.float32(lo_scale)).astype(np.float32))


def _assert_bits(j, t):
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype
        if a.dtype == np.float32:
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["random", "near_tie"])
@pytest.mark.parametrize("fn", ["two_sum", "two_diff", "two_prod"])
def test_error_free_transforms_bit_equal(fn, kind):
    a, b = _inputs(kind, 1)
    _assert_bits(*_both(fn, a, b))


@pytest.mark.parametrize("kind", ["random", "near_tie"])
@pytest.mark.parametrize(
    "fn", ["df_add", "df_sub", "df_square", "df_sum3", "df_ge", "df_lt",
           "df_min"],
)
def test_double_float_ops_bit_equal(fn, kind):
    a, b = _inputs(kind, 2)
    c, d = _inputs(kind, 3)
    # normalized pairs: (hi, lo) = two_sum(hi, tiny)
    x = tuple(np.asarray(v) for v in jdf.two_sum(jnp.asarray(a),
                                                 jnp.asarray(c * 1e-8)))
    y = tuple(np.asarray(v) for v in jdf.two_sum(jnp.asarray(b),
                                                 jnp.asarray(d * 1e-8)))
    if kind == "near_tie":
        # equal hi parts with differing lo parts exercise the tie branch
        y = (np.where(np.arange(N) % 2 == 0, x[0], y[0]), y[1])
    j_args = [tuple(jnp.asarray(v) for v in p) for p in (x, y, x)]
    t_args = [tuple(torch.from_numpy(np.array(v)) for v in p)
              for p in (x, y, x)]
    n_args = {"df_square": 1, "df_sum3": 3}.get(fn, 2)
    j = getattr(jdf, fn)(*j_args[:n_args])
    t = getattr(tdf, fn)(*t_args[:n_args])
    _assert_bits(j, t)


FMA_KINDS = {
    "tensors": lambda a, b, c: (a, b, c),
    "broadcast": lambda a, b, c: (a[:, None], b[None, :8], c[:, None]),
    "number_factor": lambda a, b, c: (a, 3.0, c),
    "number_first": lambda a, b, c: (-0.5, b, c),
    "number_addend": lambda a, b, c: (a, b, -0.5),
    "zero_dim_factor": lambda a, b, c: (np.float32(1.7), b, c),
    "zero_dim_factors": lambda a, b, c: (np.float32(1.7), np.float32(3.0),
                                         c),
}


@pytest.mark.parametrize("kind", list(FMA_KINDS))
def test_fma32_rounds_once_for_every_operand_kind(kind):
    """``fma32`` equals the float64 product and sum rounded once to
    float32 (the numpy oracle) whichever operands are tensors, 0-d
    tensors or Python numbers, and returns float32."""

    from mdhelper_tpu_torch.testing import fma32 as np_fma32

    a, b = _inputs("random", 4)
    c = _inputs("random", 5)[0]
    args = FMA_KINDS[kind](a, b, c)
    want = np_fma32(*args)
    got = tdf.fma32(*(torch.from_numpy(np.asarray(x))
                      if isinstance(x, np.ndarray) else
                      torch.tensor(x) if isinstance(x, np.float32) else x
                      for x in args))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))
