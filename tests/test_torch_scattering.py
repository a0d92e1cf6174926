"""The port's trig sums and brute-force pair histogram against the JAX
package's ops on the same float32 inputs.

* ``ops/scattering.py``: ``_exact_phases`` bit for bit (the JAX function
  run eagerly), ``trig_sums_frame`` in both precisions;
* ``ops/cuda_kernels.py`` on CPU tensors (the kernels' plain versions):
  ``trig_sums`` against the JAX package's Pallas ``trig_sums`` in
  interpret mode at ``tests/test_pallas.py``'s shapes and a float64
  oracle, within that file's tolerances (1e-4 of the mean amplitude
  fast, 1e-6 exact); ``pair_histogram`` against its Pallas
  ``pair_histogram`` as integers, and against the port's fast cell-list
  histogram.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from mdhelper_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mdhelper_tpu.ops import scattering as jsc  # noqa: E402

from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mdhelper_tpu_torch.ops import scattering as tsc  # noqa: E402
from mdhelper_tpu_torch.testing import edge_straddle_positions  # noqa: E402

BOX = 24.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one OpenMP thread per core oversubscribes them."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _oracle(qs, pos, w=None):
    """float64 sums and the tolerance scale (mean amplitude)."""

    phases = np.asarray(qs, np.float64) @ pos.astype(np.float64).T
    w = 1.0 if w is None else w.astype(np.float64)
    oc = (np.cos(phases) * w).sum(-1)
    osn = (np.sin(phases) * w).sum(-1)
    return oc, osn, np.hypot(oc, osn).mean()


def _tol(precision, amp):
    return (1e-4 if precision == "fast" else 1e-6) * amp


@pytest.mark.parametrize("with_lo", [False, True])
def test_exact_phases_bit_equal_to_jax(with_lo):
    rng = np.random.default_rng(11)
    # A 60 A box and q up to 6: phases of hundreds of radians, many turns.
    pos = (rng.random((257, 3)) * 60.0).astype(np.float32)
    q64 = rng.random((65, 3)) * 6.0
    qs = q64.astype(np.float32)
    lo = (q64 - qs).astype(np.float32) if with_lo else None
    jhi, jlo = jsc._exact_phases(
        jnp.asarray(qs), jnp.asarray(pos),
        None if lo is None else jnp.asarray(lo),
    )
    thi, tlo = tsc._exact_phases(
        torch.from_numpy(qs), torch.from_numpy(pos),
        None if lo is None else torch.from_numpy(lo),
    )
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    assert np.abs(thi.numpy()).max() <= np.float32(np.pi) + 1e-5


@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("case", ["plain", "weights", "float64_q"])
def test_trig_sums_frame_matches_jax(precision, case):
    rng = np.random.default_rng(12)
    n, n_q = 800, 150
    pos = (rng.random((n, 3)) * BOX).astype(np.float32)
    qs = rng.random((n_q, 3)) * 4.0
    if case != "float64_q":
        qs = qs.astype(np.float32)
    w = rng.random(n).astype(np.float32) if case == "weights" else None
    jc, js = jsc.trig_sums_frame(
        jnp.asarray(qs), jnp.asarray(pos),
        None if w is None else jnp.asarray(w), precision=precision,
    )
    tc, ts = tsc.trig_sums_frame(
        torch.from_numpy(qs), torch.from_numpy(pos),
        None if w is None else torch.from_numpy(w), precision=precision,
    )
    assert tc.dtype == torch.float32 and tc.shape == (n_q,)
    oc, osn, amp = _oracle(qs, pos, w)
    tol = _tol(precision, amp)
    for port, jax_sum, ref in ((tc, jc, oc), (ts, js, osn)):
        np.testing.assert_allclose(port.numpy(), np.asarray(jax_sum),
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=tol)


def test_trig_sums_batch_and_ssf():
    rng = np.random.default_rng(13)
    pos = (rng.random((3, 200, 3)) * BOX).astype(np.float32)
    qs = (rng.random((40, 3)) * 3).astype(np.float32)
    c, s = tsc.trig_sums_batch(torch.from_numpy(qs), torch.from_numpy(pos))
    assert c.shape == (3, 40)
    for b in range(3):
        fc, fs = tsc.trig_sums_frame(torch.from_numpy(qs),
                                     torch.from_numpy(pos[b]))
        torch.testing.assert_close(c[b], fc, rtol=0, atol=0)
        torch.testing.assert_close(s[b], fs, rtol=0, atol=0)
    mask = torch.tensor([1.0, 0.0, 1.0], dtype=torch.float64)
    ssf = tsc.ssf_from_trig_sums(c.double(), s.double(), mask)
    jssf = jsc.ssf_from_trig_sums(jnp.asarray(c.double().numpy()),
                                  jnp.asarray(s.double().numpy()),
                                  jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(ssf.numpy(), np.asarray(jssf), rtol=1e-12)


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_trig_sums_op_matches_pallas(precision):
    """The shapes of test_pallas.py::test_trig_sums_matches_oracle."""

    rng = np.random.default_rng(31)
    pos = (rng.random((700, 3)) * BOX).astype(np.float32)
    qs = (rng.random((300, 3)) * 4).astype(np.float32)
    jc, js = jpk.trig_sums(jnp.asarray(qs), jnp.asarray(pos),
                           precision=precision, q_tile=128, atom_tile=256)
    tc, ts = ck.trig_sums(torch.from_numpy(qs), torch.from_numpy(pos),
                          precision=precision)
    oc, osn, amp = _oracle(qs, pos)
    tol = _tol(precision, amp)
    for port, pallas, ref in ((tc, jc, oc), (ts, js, osn)):
        np.testing.assert_allclose(port.numpy(), np.asarray(pallas),
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=tol)


def test_trig_sums_op_weights_and_frames():
    """The shapes of test_pallas.py::test_trig_sums_weights_and_padding,
    as one frame and as the first of a batch."""

    rng = np.random.default_rng(32)
    pos = (rng.random((333, 3)) * BOX).astype(np.float32)
    qs = (rng.random((77, 3)) * 4).astype(np.float32)
    w = (rng.random(333) < 0.5).astype(np.float32)
    jc, js = jpk.trig_sums(jnp.asarray(qs), jnp.asarray(pos),
                           jnp.asarray(w), q_tile=128, atom_tile=256)
    tc, ts = ck.trig_sums(torch.from_numpy(qs), torch.from_numpy(pos),
                          torch.from_numpy(w))
    oc, osn, amp = _oracle(qs, pos, w)
    for port, pallas, ref in ((tc, jc, oc), (ts, js, osn)):
        np.testing.assert_allclose(port.numpy(), np.asarray(pallas),
                                   rtol=0, atol=1e-4 * amp)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                   atol=1e-4 * amp)
    frames = torch.from_numpy(np.stack([pos, pos[::-1].copy()]))
    bc, bs = ck.trig_sums(torch.from_numpy(qs), frames, torch.from_numpy(w))
    assert bc.shape == (2, 77)
    torch.testing.assert_close(bc[0], tc, rtol=0, atol=0)
    torch.testing.assert_close(bs[0], ts, rtol=0, atol=0)


def test_trig_sums_op_low_words():
    """float64 wavevectors in a 500 A box (phases of thousands of
    radians): the exact path keeps their low words, given as a float64
    qs or as an explicit qs_lo, and meets 1e-6 of the mean amplitude."""

    rng = np.random.default_rng(33)
    pos = (rng.random((400, 3)) * 500.0).astype(np.float32)
    q64 = rng.random((50, 3)) * 4.0
    hi = q64.astype(np.float32)
    lo = (q64 - hi).astype(np.float32)
    oc, osn, amp = _oracle(q64, pos)
    c, s = ck.trig_sums(torch.from_numpy(q64), torch.from_numpy(pos),
                        precision="exact")
    c2, s2 = ck.trig_sums(torch.from_numpy(hi), torch.from_numpy(pos),
                          precision="exact", qs_lo=torch.from_numpy(lo))
    torch.testing.assert_close(c, c2, rtol=0, atol=0)
    torch.testing.assert_close(s, s2, rtol=0, atol=0)
    np.testing.assert_allclose(c.numpy(), oc, rtol=0, atol=1e-6 * amp)
    np.testing.assert_allclose(s.numpy(), osn, rtol=0, atol=1e-6 * amp)
    # Without the low words the same sums miss that tolerance.
    c_hi, _ = ck.trig_sums(torch.from_numpy(hi), torch.from_numpy(pos),
                           precision="exact")
    assert np.abs(c_hi.numpy() - oc).max() > 1e-6 * amp


def test_ops_reject_other_devices_and_shapes():
    pos = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        ck.trig_sums(torch.zeros((2, 3)), pos)
    with pytest.raises(ValueError):
        ck.pair_histogram(pos, (10.0,) * 3, 3.0, 10)
    with pytest.raises(ValueError):
        ck.trig_sums(torch.zeros((2, 3)), torch.zeros(4, 3),
                     precision="double")
    with pytest.raises(ValueError):
        ck.pair_histogram(torch.zeros((2, 4, 3)), (10.0,) * 3, 3.0, 10)


@pytest.mark.parametrize("exclusion", [None, (1, 1), (4, 4), (2, 3)])
def test_pair_histogram_equals_pallas(exclusion):
    """900 atoms as in test_pallas.py: equal integer counts (also under
    the asymmetric (2, 3), whose two orders of a pair count apart)."""

    rng = np.random.default_rng(31)
    n, r_max, n_bins = 900, 7.0, 150
    pos = (rng.random((n, 3)) * BOX).astype(np.float32)
    jax_counts = np.asarray(jpk.pair_histogram(
        jnp.asarray(pos), (BOX,) * 3, r_max, n_bins, exclusion=exclusion,
        i_tile=128, j_tile=256,
    ))
    counts = ck.pair_histogram(torch.from_numpy(pos), (BOX,) * 3, r_max,
                               n_bins, exclusion=exclusion)
    assert counts.dtype == torch.int64 and counts.shape == (n_bins,)
    np.testing.assert_array_equal(counts.numpy(),
                                  jax_counts.astype(np.int64))
    if exclusion is None:
        dropped = ck.pair_histogram(torch.from_numpy(pos), (BOX,) * 3,
                                    r_max, n_bins, exclusion=(1, 1))
        assert int(counts[0] - dropped[0]) == n
        np.testing.assert_array_equal(counts[1:].numpy(),
                                      dropped[1:].numpy())


@pytest.mark.parametrize("fixture", ["uniform", "straddle"])
def test_pair_histogram_equals_fast_cell_histogram(fixture):
    """Exclusion (1, 1) bins the ordered pairs the self cell kernel bins,
    with the same fast policy: equal integer counts, also on the bin-edge
    straddle fixture."""

    rng = np.random.default_rng(34)
    if fixture == "uniform":
        box, r_max, n_bins = 16.0, 3.5, 96
        pos = (rng.random((1200, 3)) * box).astype(np.float32)
    else:
        box, r_max, n_bins = 16.0, 4.0, 16
        pos = edge_straddle_positions(rng, box)
    counts = ck.pair_histogram(torch.from_numpy(pos), (box,) * 3, r_max,
                               n_bins, exclusion=(1, 1))
    plan = cch.cell_plan_search(len(pos), [box] * 3, r_max)
    cell, _ = cch.cell_pair_histogram(
        torch.from_numpy(pos), box=(box,) * 3, r_max=r_max,
        n_cells_dim=plan["n_cells_dim"], capacity=plan["capacity"],
        n_bins=n_bins, precision="fast",
    )
    np.testing.assert_array_equal(counts.numpy(),
                                  cell[0].numpy().astype(np.int64))
    assert counts.sum() > 0
