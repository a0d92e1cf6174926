"""The port's particle-mesh deposit and periodic Gaussian smoothing against
the JAX package's functions, a float64 numpy mirror and a direct float64
kernel density estimate.

* ``grid_deposit_frames``: the nearest-grid-point counts are integers and
  equal the JAX package's (also for coordinates one float32 ulp either
  side of cell edges and of the box length).  The cloud-in-cell and
  triangular-shaped-cloud weights are formed in float32 operation for
  operation as the JAX package writes them (XLA's CPU backend contracts
  some products and sums into fused multiply-adds, which the port does
  not); the port sums each cell's weights in float64 and rounds once, the
  JAX package reads them off a double-float cumsum and rounds once, so
  cells agree within one float32 ulp of their total, or, in
  cells of a tiny total, within the double-float cumsum's absolute error
  (a few 2^-48 of the running total); each particle deposits weight 1.
* ``gaussian_smooth_periodic``: the port transforms the float32 deposits
  and kernel in float64 and rounds once; the JAX package's float32 FFTs
  (XLA's) round at about 1e-7 of the field.  Within ``SMOOTH_RTOL`` of the
  field's maximum of the JAX package's field and of a float64 numpy
  mirror of the same pipeline (whose kernel is not rounded to float32);
  the deconvolved CIC and TSC fields converge to the direct periodic KDE
  as the JAX test requires.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mdhelper_tpu.ops import profiles as jax_profiles  # noqa: E402

from mdhelper_tpu_torch.ops import profiles  # noqa: E402

BOX = np.array([8.0, 9.5, 12.0], np.float32)
CELLS = (16, 12, 32)
SMOOTH_RTOL = 2e-6


def _coords(seed=3, frames=3, n=400, box=BOX):
    rng = np.random.default_rng(seed)
    return (rng.random((frames, n, 3)) * box).astype(np.float32)


def _jax_deposit(x, box, order, cells=CELLS):
    return np.asarray(jax_profiles.grid_deposit_frames(
        jnp.asarray(x), cells, jnp.asarray(box), order))


def _deposit(x, box, order, cells=CELLS):
    return profiles.grid_deposit_frames(torch.as_tensor(x), cells,
                                        torch.as_tensor(box), order).numpy()


@pytest.mark.parametrize("boxes", ["one", "per_frame"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_deposit_matches_jax(order, boxes):
    x = _coords()
    box = BOX if boxes == "one" else np.stack(
        [BOX * s for s in (1.0, 1.01, 0.995)]).astype(np.float32)
    if boxes == "per_frame":
        x = np.minimum(x, box[:, None, :] * np.float32(0.99999))
    want = _jax_deposit(x, box, order)
    got = _deposit(x, box, order)
    assert got.dtype == np.float32 and got.shape == want.shape
    if order == 1:
        np.testing.assert_array_equal(got, want)
    else:
        # one ulp of the cell's total, or the double-float cumsum's own
        # absolute error (a few 2^-48 of the running total) in tiny cells
        ulp = np.spacing(np.abs(want)) + x.shape[1] * 2.0**-44
        assert np.all(np.abs(got - want) <= ulp)
        # where that error is far below an ulp, nearly all cells equal
        big = np.abs(want) > 1e-3
        assert np.mean(got[big] == want[big]) > 0.99
    np.testing.assert_allclose(got.sum(axis=(1, 2, 3)), x.shape[1],
                               rtol=1e-5)


def test_ngp_straddles_match_jax():
    """Coordinates one ulp either side of cell edges (in the scaled float32
    coordinate) and of the box length."""

    h = BOX / np.asarray(CELLS, np.float32)
    pts = []
    for k in (1, 5, 11):
        edge = np.float32(k) * h
        for e in (np.nextafter(edge, np.float32(0)), edge,
                  np.nextafter(edge, np.float32(99))):
            pts.append(e)
    pts.append(np.nextafter(BOX, np.float32(0)))
    pts.append(np.zeros(3, np.float32))
    x = np.asarray(pts, np.float32)[None]
    np.testing.assert_array_equal(_deposit(x, BOX, 1),
                                  _jax_deposit(x, BOX, 1))


def oracle_smooth(counts, box, n_cells, xi, order):
    """float64 numpy mirror of gaussian_smooth_periodic (one frame)."""

    kernel = 1.0
    for ax, (n, L) in enumerate(zip(n_cells, box)):
        m = np.fft.rfftfreq(n) * n if ax == 2 else np.fft.fftfreq(n) * n
        k = 2 * np.pi * m / L
        kern = np.exp(-0.5 * (xi * k) ** 2) / np.sinc(m / n) ** order
        shape = [1, 1, 1]
        shape[ax] = -1
        kernel = kernel * kern.reshape(shape)
    cell_volume = np.prod(box) / np.prod(n_cells)
    return np.fft.irfftn(np.fft.rfftn(counts, axes=(0, 1, 2)) * kernel,
                         s=n_cells, axes=(0, 1, 2)) / cell_volume


@pytest.mark.parametrize("boxes", ["one", "per_frame"])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_smoothing_matches_jax_and_f64_mirror(order, boxes):
    x = _coords(seed=9)
    box = BOX if boxes == "one" else np.stack(
        [BOX * s for s in (1.0, 1.02, 0.99)]).astype(np.float32)
    counts = _jax_deposit(x, box, max(order, 1))
    want = np.asarray(jax_profiles.gaussian_smooth_periodic(
        jnp.asarray(counts), jnp.asarray(box), 1.1, order))
    got = profiles.gaussian_smooth_periodic(
        torch.as_tensor(counts), torch.as_tensor(box), 1.1, order).numpy()
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=SMOOTH_RTOL * scale)
    boxes64 = np.broadcast_to(box.astype(np.float64), (len(x), 3))
    for f in range(len(x)):
        mirror = oracle_smooth(counts[f].astype(np.float64), boxes64[f],
                               CELLS, 1.1, order)
        np.testing.assert_allclose(got[f], mirror, rtol=0,
                                   atol=SMOOTH_RTOL * scale)


def test_deconvolved_deposits_converge_to_direct_kde():
    box = np.array([8.0, 8.0, 8.0], np.float32)
    cells = (32, 32, 32)
    xi = 1.2
    pts = _coords(seed=53, frames=1, n=12, box=box)
    centers = [(np.arange(n) + 0.5) * L / n for n, L in zip(cells, box)]
    grid = np.stack(np.meshgrid(*centers, indexing="ij"), axis=-1)
    images = np.array(np.meshgrid(*([[-1, 0, 1]] * 3),
                                  indexing="ij")).reshape(3, -1).T
    norm = (2 * np.pi * xi**2) ** -1.5
    kde = np.zeros(cells)
    for p in pts[0].astype(np.float64):
        for img in images:
            d2 = ((grid - p - img * box) ** 2).sum(axis=-1)
            kde += norm * np.exp(-0.5 * d2 / xi**2)
    errs = {}
    for order in (1, 2, 3):
        counts = profiles.grid_deposit_frames(
            torch.as_tensor(pts), cells, torch.as_tensor(box), order)
        np.testing.assert_allclose(counts.sum().item(), 12, rtol=1e-6)
        dens = profiles.gaussian_smooth_periodic(
            counts, torch.as_tensor(box), xi, order)[0].numpy()
        errs[order] = np.abs(dens - kde).max() / kde.max()
    assert errs[2] < 0.25 * errs[1]
    assert errs[3] < 0.5 * errs[2]
    assert errs[3] < 2e-3


def test_deposit_rejects_other_orders():
    with pytest.raises(ValueError, match="order"):
        profiles.grid_deposit_frames(torch.zeros(1, 2, 3), (4, 4, 4),
                                     torch.ones(3), 4)
