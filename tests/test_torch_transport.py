"""The port's unwrap scan and FFT MSD against the JAX package."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.algorithm import correlation as jcorr  # noqa: E402
from mdhelper_tpu.ops import pbc as jpbc  # noqa: E402

from mdhelper_tpu_torch.algorithm import correlation as tcorr  # noqa: E402
from mdhelper_tpu_torch.ops import pbc as tpbc  # noqa: E402

BOX = np.float32([10.0, 12.0, 9.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _walk(t, n, seed, scale=1.5):
    rng = np.random.default_rng(seed)
    walk = rng.random((n, 3)) * BOX + np.cumsum(
        rng.normal(0.0, scale, (t, n, 3)), axis=0
    )
    return np.mod(walk, BOX).astype(np.float32)


@pytest.mark.parametrize("per_frame_box", [False, True])
def test_unwrap_scan_equals_jax(per_frame_box):
    pos = _walk(9, 300, 1)
    box = np.tile(BOX, (9, 1)) if per_frame_box else BOX
    head = 4
    j_out, (j_last, j_img) = jpbc.unwrap_scan(
        jnp.asarray(pos[:head]), jnp.asarray(box[:head] if per_frame_box
                                             else box)
    )
    j_out2, (j_last, j_img) = jpbc.unwrap_scan(
        jnp.asarray(pos[head:]),
        jnp.asarray(box[head:] if per_frame_box else box),
        initial=j_last, images=j_img,
    )
    t_out, (t_last, t_img) = tpbc.unwrap_scan(
        torch.from_numpy(pos[:head]),
        torch.from_numpy(box[:head] if per_frame_box else box),
    )
    t_out2, (t_last, t_img) = tpbc.unwrap_scan(
        torch.from_numpy(pos[head:]),
        torch.from_numpy(box[head:] if per_frame_box else box),
        initial=t_last, images=t_img,
    )
    for j, t in ((j_out, t_out), (j_out2, t_out2), (j_img, t_img),
                 (j_last, t_last)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert np.abs(np.asarray(j_img)).max() > 0  # crossings happened


def test_wrap_positions_equals_jax():
    pos = (np.random.default_rng(2).normal(0, 20, (50, 3))).astype(
        np.float32
    )
    np.testing.assert_array_equal(
        tpbc.wrap_positions(torch.from_numpy(pos),
                            torch.from_numpy(BOX)).numpy(),
        np.asarray(jpbc.wrap_positions(jnp.asarray(pos), jnp.asarray(BOX))),
    )


@pytest.mark.parametrize(
    "shape,axis,average,cross",
    [
        ((20, 3), 0, True, False),
        ((20, 7, 3), 0, True, False),
        ((20, 7, 3), 0, False, False),
        ((2, 15, 7, 3), 1, True, False),
        ((2, 15, 3), 1, True, False),
        ((20, 3), 0, True, True),
        ((2, 15, 3), 1, True, True),
    ],
)
def test_msd_fft_matches_jax(shape, axis, average, cross):
    rng = np.random.default_rng(3)
    pos1 = np.cumsum(rng.normal(size=shape), axis=axis)
    pos2 = np.cumsum(rng.normal(size=shape), axis=axis) if cross else None
    j = np.asarray(jcorr.msd_fft(pos1, pos2, axis, average=average))
    t = tcorr.msd_fft(
        torch.from_numpy(pos1),
        None if pos2 is None else torch.from_numpy(pos2),
        axis, average=average,
    )
    assert t.dtype == torch.float64
    np.testing.assert_allclose(
        t.numpy(), j, rtol=1e-10, atol=1e-10 * np.abs(j).max()
    )
