"""The port's unwrap scan and FFT MSD against the JAX package, and its
``Onsager`` of a subset group with ``unwrap=True`` against a numpy float64
oracle (where the JAX class is at fault)."""

import warnings

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


SUBSET_BOX = 7.21


def _subset_universe(groupings):
    """300 random walkers (N(0, 0.4) A steps, 13 frames) wrapped into a
    7.21 A cube as float32; in 3-atom residues with mixed masses."""

    from mdhelper_tpu_torch.core.universe import Universe

    rng = np.random.default_rng(1)
    walk = rng.random((300, 3)) * SUBSET_BOX + np.cumsum(
        rng.normal(0.0, 0.4, (13, 300, 3)), axis=0
    )
    frames = np.mod(walk, SUBSET_BOX).astype(np.float32)
    masses = np.tile([15.999, 1.008, 12.011], 100)
    u = Universe.from_arrays(frames, np.array([SUBSET_BOX] * 3 + [90.0] * 3),
                             masses=masses,
                             resindices=np.repeat(np.arange(100), 3))
    return frames, u


def _oracle_unwrap(frames):
    """Image-flag unwrap of float32 frames, written out in numpy with the
    stream's float32 arithmetic (a step of half a box or more is a
    crossing)."""

    box = np.float32(SUBSET_BOX)
    images = np.zeros(frames.shape[1:], dtype=np.int32)
    out = np.empty_like(frames)
    prev = frames[0]
    for t, pos in enumerate(frames):
        delta = pos - prev
        images -= np.where(np.abs(delta) >= box / np.float32(2),
                           np.sign(delta), 0).astype(np.int32)
        out[t] = pos + images.astype(np.float32) * box
        prev = pos
    return out


def _oracle_coms(pos, masses, labels):
    """float32 centers of mass of each label's atoms (labels ascending),
    summed in atom order from 0."""

    coms = []
    for label in np.unique(labels):
        members = np.flatnonzero(labels == label)
        m = masses[members].astype(np.float32)
        total = np.zeros(pos.shape[:1] + (3,), dtype=np.float32)
        mass = np.float32(0.0)
        for atom, w in zip(members, m):
            total = total + pos[:, atom] * w
            mass = mass + w
        coms.append(total / mass)
    return np.stack(coms, axis=1)


def _oracle_disp(a, b):
    """float64 direct-lag mean of (a(t + m) - a(t)) . (b(t + m) - b(t))
    over origins t (and the particle axis, if any), by lag m."""

    a, b = a.astype(np.float64), b.astype(np.float64)
    n_t = len(a)
    return np.array([
        ((a[m:] - a[:n_t - m]) * (b[m:] - b[:n_t - m])).sum(-1).mean()
        for m in range(n_t)
    ])


@pytest.mark.parametrize("groups, n_blocks, groupings", [
    ([(50, 250)], 1, "atoms"),
    ([(50, 150), (150, 250)], 2, "atoms"),
    ([(50, 250)], 1, "residues"),
], ids=["one_group", "two_groups", "residues"])
def test_onsager_subset_unwrap_matches_oracle(groups, n_blocks, groupings):
    """The port's ``Onsager(subset, unwrap=True)`` against a numpy float64
    oracle of the unwrapped walk: the same float32 image-flag unwrap of
    the same frames, the group's own atoms (their residues' centers of
    mass under ``groupings="residues"``, from partial residues at both
    ends), and direct-lag displacements in float64.

    The JAX class is not the reference here.  With ``unwrap=True`` it
    streams every universe atom but gathers a group's entities at offsets
    into the concatenated group columns, so it takes the first atoms of
    the universe instead of ``atoms[50:250]`` (ROADMAP Queue 3, item 7).
    On this fixture its lag-4 MSD / 6 is 0.331960, where the port and the
    oracle give 0.328177.
    """

    from mdhelper_tpu_torch.analysis.transport import Onsager

    frames, u = _subset_universe(groupings)
    ags = [u.atoms[lo:hi] for lo, hi in groups]
    with warnings.catch_warnings():
        # 13 frames in 2 blocks: the last frame is discarded.
        warnings.simplefilter("ignore")
        ons = Onsager(ags if len(ags) > 1 else ags[0], groupings,
                      n_blocks=n_blocks, unwrap=True, verbose=False,
                      device="cpu").run()
    unwrapped = _oracle_unwrap(frames)
    n_t = len(frames) // n_blocks
    entities = []
    for lo, hi in groups:
        pos = unwrapped[:, lo:hi]
        if groupings == "residues":
            pos = _oracle_coms(pos, u.atoms.masses[lo:hi],
                               u.atoms.resindices[lo:hi])
        entities.append(pos[:n_blocks * n_t].astype(np.float64).reshape(
            n_blocks, n_t, *pos.shape[1:]))
    for (i, j), cross in zip(ons.results.pairs, ons.results.msd_cross):
        for block in range(n_blocks):
            ref = _oracle_disp(entities[i][block].sum(1),
                               entities[j][block].sum(1)) / 6
            np.testing.assert_allclose(cross[block], ref, rtol=1e-8,
                                       atol=1e-9 * np.abs(ref).max())
    for i, self_msd in enumerate(ons.results.msd_self):
        for block in range(n_blocks):
            ref = _oracle_disp(entities[i][block], entities[i][block]) / 6
            np.testing.assert_allclose(self_msd[block], ref, rtol=1e-8,
                                       atol=1e-9 * np.abs(ref).max())
    if groups == [(50, 250)] and groupings == "atoms":
        assert abs(ons.results.msd_self[0, 0, 4] - 0.328177) < 1e-6


@pytest.mark.parametrize("center_wrap", [False, True])
def test_onsager_center_atom_matches_oracle(center_wrap):
    """The port's ``Onsager(atoms[50:250], unwrap=True, center=True,
    center_atom=True)`` against a numpy float64 oracle: the float32
    image-flag unwrap of every atom, the system's center of mass of all
    300 atoms in each frame (their float32 unwrapped positions, wrapped
    into the box in float32 first with `center_wrap`, averaged in
    float64 with the float64 masses), subtracted in float64 from the
    group's atoms, and direct-lag displacements in float64.

    The JAX class is not the reference here.  With ``center_atom=True``
    (as with ``unwrap=True``) it streams every universe atom but gathers
    the group at offsets into the concatenated group columns, so it
    centers and measures the first 200 atoms of the universe instead of
    ``atoms[50:250]`` (ROADMAP Queue 3, item 7).
    """

    from mdhelper_tpu_torch.analysis.transport import Onsager

    frames, u = _subset_universe("atoms")
    ons = Onsager(u.atoms[50:250], unwrap=True, center=True,
                  center_atom=True, center_wrap=center_wrap, verbose=False,
                  device="cpu").run()
    unwrapped = _oracle_unwrap(frames)
    ref = unwrapped
    if center_wrap:
        box = np.float32(SUBSET_BOX)
        ref = unwrapped - np.floor(unwrapped / box) * box
    masses = u.atoms.masses
    com = (masses[:, None] * ref.astype(np.float64)).sum(
        axis=1, keepdims=True) / masses.sum()
    group = unwrapped[:, 50:250].astype(np.float64) - com
    self_ref = _oracle_disp(group, group) / 6
    cross_ref = _oracle_disp(group.sum(1), group.sum(1)) / 6
    for got, want in ((ons.results.msd_self[0, 0], self_ref),
                      (ons.results.msd_cross[0, 0], cross_ref)):
        np.testing.assert_allclose(got, want, rtol=1e-8,
                                   atol=1e-9 * np.abs(want).max())
    # Centering moves the group: the uncentered MSD differs.
    plain = _oracle_disp(unwrapped[:, 50:250].astype(np.float64),
                         unwrapped[:, 50:250].astype(np.float64)) / 6
    assert np.abs(self_ref[1:] / plain[1:] - 1).max() > 1e-4
