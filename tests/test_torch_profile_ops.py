"""The port's density-profile binning ops against the JAX package's.

The same float32 coordinates go through ``mdhelper_tpu.ops.profiles`` and
``mdhelper_tpu_torch.ops.profiles``.  Counts must be equal as integers;
weighted sums (charges) within ``1e-6 * sum(|w|)`` a bin, since the JAX
package accumulates them in float32 and the port in float64.  The
coordinates sit on the JAX package's float32 edges, one float32 step to
either side of them, at 0, at the box length and beyond, below 0, and at
NaN; the boxes include lengths whose float32 edges neither
``torch.linspace`` nor a cast float64 ``numpy.linspace`` reproduces.

XLA on the CPU flushes float32 subnormals to zero, so the JAX package
counts a coordinate of -1.4e-45 in the first bin; numpy and the port do
not.  Subnormal coordinates are therefore held against
``numpy.histogram`` instead (ROADMAP Queue 3).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mdhelper_tpu.ops import profiles as jax_profiles  # noqa: E402
from mdhelper_tpu_torch.ops import profiles  # noqa: E402

#: (box length, bins): the JAX tests' box (10, 12, 14), and lengths of
#: the benchmark's boxes (36.84, 49.99, 50).
EDGE_CASES = [(10.0, 20), (12.0, 20), (14.0, 20), (36.84, 192),
              (49.99, 201), (50.0, 200)]


def _jax_edges(length, n_bins):
    return np.asarray(jnp.linspace(0.0, length, n_bins + 1,
                                   dtype=jnp.float32))


def _fixture_coords(rng, length, n_bins, n_frames=3, n_random=400):
    """float32 coordinates ``(n_frames, N)``: every JAX float32 edge and
    its float32 neighbours (the normal ones: not those of 0), 0, the
    length and one step past it, 1.5 times it, -1, NaN, and uniform values
    on [-0.1 L, 1.1 L), shuffled differently in each frame."""

    edges = _jax_edges(length, n_bins)
    f32 = np.float32
    special = np.concatenate([
        edges,
        np.nextafter(edges, f32(np.inf))[1:],
        np.nextafter(edges, f32(-np.inf))[1:],
        np.array([0.0, length, 1.5 * length, -1.0, np.nan, np.nan], f32),
    ]).astype(f32)
    frames = []
    for _ in range(n_frames):
        uniform = (rng.random(n_random) * 1.2 - 0.1) * length
        frames.append(rng.permutation(
            np.concatenate([special, uniform.astype(f32)])))
    return np.stack(frames).astype(f32)


def _weights_bound(weights, shape):
    return 1e-6 * np.abs(np.broadcast_to(weights, shape)).sum()


@pytest.mark.parametrize("length,n_bins", EDGE_CASES)
def test_edges_equal_jax_linspace_bits(length, n_bins):
    edges = profiles.linspace_edges_f32(length, n_bins)
    ref = _jax_edges(length, n_bins)
    assert edges.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(edges.view(np.int32), ref.view(np.int32))


def test_edges_differ_from_naive_constructions():
    """The cases above need the JAX formula: in three of them or more,
    both torch.linspace and a cast numpy.linspace miss an edge."""

    missed = 0
    for length, n_bins in EDGE_CASES:
        ref = _jax_edges(length, n_bins)
        naive = torch.linspace(0.0, length, n_bins + 1,
                               dtype=torch.float32).numpy()
        cast = np.linspace(0.0, length, n_bins + 1).astype(np.float32)
        missed += int((naive != ref).any() and (cast != ref).any())
    assert missed >= 3


@pytest.mark.parametrize("length,n_bins", EDGE_CASES)
@pytest.mark.parametrize("weighted", ["none", "atoms", "frames"])
def test_axis_histogram_equals_jax(length, n_bins, weighted):
    rng = np.random.default_rng(int(length * 100) + n_bins)
    coords = _fixture_coords(rng, length, n_bins)
    mask = np.array([1.0, 1.0, 0.0])
    edges = profiles.linspace_edges_f32(length, n_bins)
    weights = {
        "none": None,
        "atoms": rng.normal(size=coords.shape[1]),
        "frames": rng.normal(size=coords.shape),
    }[weighted]
    ref = np.asarray(jax_profiles.axis_histogram_batch(
        jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(edges),
        None if weights is None else jnp.asarray(weights)))
    out = profiles.axis_histogram_batch(
        torch.from_numpy(coords), torch.from_numpy(mask),
        torch.from_numpy(edges),
        None if weights is None else torch.from_numpy(weights)).numpy()
    assert out.shape == (n_bins,)
    if weights is None:
        assert out.dtype == np.int64
        np.testing.assert_array_equal(out, ref.astype(np.int64))
        np.testing.assert_array_equal(ref, np.round(ref))
        # The masked frame and the NaN, negative and beyond-L entries
        # count nothing; the edges at 0 and L count.
        valid = (coords[:2] >= 0) & (coords[:2] <= edges[-1])
        assert out.sum() == valid.sum()
    else:
        assert out.dtype == np.float64
        np.testing.assert_allclose(
            out, ref, rtol=0,
            atol=_weights_bound(weights, coords.shape))


def test_subnormal_coordinates_bin_as_numpy_histogram():
    """float32 subnormals around 0 (which XLA's CPU backend flushes to
    zero) bin as ``numpy.histogram`` bins them: those below 0 count
    nothing, those above count in the first bin."""

    f32 = np.float32
    tiny = np.nextafter(f32(0), f32(1))
    coords = np.array([[tiny, -tiny, f32(1e-40), f32(-1e-40), f32(0.0),
                        f32(5.0)]], f32)
    edges = profiles.linspace_edges_f32(10.0, 20)
    out = profiles.axis_histogram_batch(
        torch.from_numpy(coords), torch.ones(1), torch.from_numpy(edges))
    ref = np.histogram(coords[0], bins=edges)[0]
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out[0] == 3


def test_axis_histogram_counts_the_last_edge_in_the_last_bin():
    edges = torch.from_numpy(profiles.linspace_edges_f32(14.0, 20))
    coords = torch.stack([edges, edges])[None].reshape(1, -1)
    out = profiles.axis_histogram_batch(coords, torch.ones(1), edges)
    expected = np.full(20, 2)
    expected[-1] = 4  # e_19 and e_20 both fall in the last bin
    np.testing.assert_array_equal(out.numpy(), expected)


def _plane_fixture(rng, lengths, bins):
    xs = [_fixture_coords(rng, length, n, n_frames=2)
          for length, n in zip(lengths, bins)]
    n = min(x.shape[1] for x in xs)
    return np.stack([x[:, :n] for x in xs], axis=-1)


@pytest.mark.parametrize("weighted", [False, True])
def test_plane_histogram_equals_jax(weighted):
    rng = np.random.default_rng(7)
    lengths, bins = (12.0, 36.84), (20, 192)
    coords = _plane_fixture(rng, lengths, bins)
    mask = np.array([1.0, 1.0])
    edges = [profiles.linspace_edges_f32(length, n)
             for length, n in zip(lengths, bins)]
    weights = rng.normal(size=coords.shape[1]) if weighted else None
    ref = np.asarray(jax_profiles.plane_histogram_batch(
        jnp.asarray(coords), jnp.asarray(mask), *map(jnp.asarray, edges),
        weights=None if weights is None else jnp.asarray(weights)))
    out = profiles.plane_histogram_batch(
        torch.from_numpy(coords), torch.from_numpy(mask),
        *map(torch.from_numpy, edges),
        weights=None if weights is None else torch.from_numpy(weights),
    ).numpy()
    assert out.shape == bins
    if weights is None:
        np.testing.assert_array_equal(out, ref.astype(np.int64))
        assert out.sum() > 0
    else:
        np.testing.assert_allclose(
            out, ref, rtol=0,
            atol=_weights_bound(weights, coords.shape[:2]))


@pytest.mark.parametrize("weighted", [False, True])
def test_volume_histogram_equals_jax(weighted):
    rng = np.random.default_rng(8)
    lengths, bins = (10.0, 14.0, 49.99), (6, 7, 9)
    coords = _plane_fixture(rng, lengths, bins)
    mask = np.array([1.0, 0.0])
    edges = [profiles.linspace_edges_f32(length, n)
             for length, n in zip(lengths, bins)]
    weights = rng.normal(size=coords.shape[1]) if weighted else None
    ref = np.asarray(jax_profiles.volume_histogram_batch(
        jnp.asarray(coords), jnp.asarray(mask), *map(jnp.asarray, edges),
        weights=None if weights is None else jnp.asarray(weights)))
    out = profiles.volume_histogram_batch(
        torch.from_numpy(coords), torch.from_numpy(mask),
        *map(torch.from_numpy, edges),
        weights=None if weights is None else torch.from_numpy(weights),
    ).numpy()
    assert out.shape == bins
    if weights is None:
        np.testing.assert_array_equal(out, ref.astype(np.int64))
        assert out.sum() > 0
    else:
        np.testing.assert_allclose(
            out, ref, rtol=0,
            atol=_weights_bound(weights, coords.shape[:2]))


def test_volume_histogram_equals_numpy_histogramdd():
    """The voxel ids against ``numpy.histogramdd`` on the same float32
    edges (in range, finite coordinates)."""

    rng = np.random.default_rng(9)
    lengths = np.array([10.0, 12.0, 14.0])
    coords = (rng.random((2, 3000, 3)) * lengths).astype(np.float32)
    edges = [profiles.linspace_edges_f32(length, 8) for length in lengths]
    out = profiles.volume_histogram_batch(
        torch.from_numpy(coords), torch.ones(2), *map(torch.from_numpy,
                                                      edges)).numpy()
    ref = np.histogramdd(coords.reshape(-1, 3), bins=edges)[0]
    np.testing.assert_array_equal(out, ref.astype(np.int64))
