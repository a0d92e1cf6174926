"""The plain references against brute-force float64 numpy at tiny
sizes."""

import numpy as np
import pytest
import torch

from mdbench.harness import spec as specs

RNG = np.random.default_rng(7)
BOX = 19.0
DIMS = np.array([BOX] * 3 + [90.0] * 3)


def wrapped(x):
    f = np.mod(x, BOX).astype(np.float32)
    return np.where(f >= BOX, f - BOX, f).astype(np.float32)


def min_image(d):
    return d - BOX * np.round(d / BOX)


def test_rdf_counts_equal_a_brute_histogram():
    frames = wrapped(RNG.random((2, 400, 3)) * BOX)
    spec = {"kwargs": {"n_bins": 50, "range": (0.0, 6.0),
                       "exclusion": (1, 1)}}
    got = specs.reference("rdf_counts").expected(frames, DIMS, spec, "cpu")
    edges = np.linspace(0.0, 6.0, 51)
    want = np.zeros(50, np.int64)
    for f in frames.astype(np.float64):
        d = min_image(f[:, None] - f[None])
        r = np.sqrt((d**2).sum(-1))[~np.eye(len(f), dtype=bool)]
        want += np.histogram(r, bins=edges)[0]
    np.testing.assert_array_equal(got["counts"], want)


def brute_power(pos, n_points, q_axis):
    n = np.arange(n_points)
    grid = np.stack(np.meshgrid(n, n, n, indexing="ij"), -1).reshape(-1, 3)
    qs = q_axis[grid]
    phases = pos @ qs.T
    return (np.cos(phases).sum(0) ** 2 + np.sin(phases).sum(0) ** 2), grid


def grouped(values, grid):
    n2 = (grid**2).sum(1)
    keys = np.unique(n2)
    return np.array([values[n2 == k].mean() for k in keys])


def test_ssf_equals_brute_sums():
    frames = wrapped(RNG.random((3, 200, 3)) * BOX)
    spec = {"kwargs": {"n_points": 5}}
    got = specs.reference("ssf").expected(frames, DIMS, spec, "cpu")
    q_axis = 2 * np.pi * np.arange(5) / BOX
    total = 0
    for f in frames.astype(np.float64):
        power, grid = brute_power(f, 5, q_axis)
        total = total + power
    want = grouped(total / (3 * 200), grid)
    np.testing.assert_allclose(got["ssf"], want, rtol=1e-12, atol=1e-12)


def brute_unwrap(frames, seed):
    out = [seed]
    for t in range(1, len(frames)):
        out.append(out[-1] + min_image(frames[t] - frames[t - 1]))
    return np.array(out)


def test_msd_equals_brute_displacements():
    walk = np.cumsum(RNG.normal(0, 2.0, (12, 50, 3)), axis=0)
    frames = wrapped(walk + BOX / 2)
    got = specs.reference("msd").expected(frames, DIMS, {"kwargs": {}},
                                          "cpu")
    f64 = frames.astype(np.float64)
    u = brute_unwrap(f64, f64[0])
    total = u.sum(1)
    for m in range(1, 12):
        d = u[m:] - u[:-m]
        assert got["msd_self"][m] == pytest.approx(
            (d**2).sum(-1).mean() / 6, rel=1e-12)
        dc = total[m:] - total[:-m]
        assert got["msd_cross"][m] == pytest.approx(
            (dc**2).sum(-1).mean() / 6, rel=1e-12)


M, NP = 6, 5


@pytest.fixture(scope="module")
def chains():
    heads = RNG.random((M, 3)) * BOX
    bonds = RNG.normal(0, 0.6, (7, M, NP - 1, 3))
    drift = np.cumsum(RNG.normal(0, 0.5, (7, M, 3)), axis=0)
    conf = np.concatenate((np.zeros((7, M, 1, 3)), np.cumsum(bonds, 2)), 2)
    unwrapped = heads[None, :, None] + drift[:, :, None] + conf
    return wrapped(unwrapped.reshape(7, -1, 3))


def brute_chains(frames):
    f64 = frames.astype(np.float64).reshape(len(frames), M, NP, 3)
    first = f64[0]
    whole = [first[:, 0]]
    for n in range(1, NP):
        whole.append(whole[-1] + min_image(first[:, n] - first[:, n - 1]))
    seed = np.stack(whole, 1)
    return brute_unwrap(f64.reshape(len(frames), -1, 3),
                        seed.reshape(-1, 3)).reshape(-1, M, NP, 3)


def brute_acf(x):
    t = len(x)
    return np.array([(x[m:] * x[:t - m]).sum(-1).mean() for m in range(t)])


SPEC = {"kwargs": {"n_chains": M, "n_monomers": NP, "n_modes": 3,
                   "n_points": 4}}


def test_gyradius_e2e_rouse_and_scsf_equal_brute_numpy(chains):
    u = brute_chains(chains)
    ref = {k: specs.reference(k).expected(chains, DIMS, SPEC, "cpu")
           for k in ("gyradius", "e2e_acf", "rouse", "scsf")}
    dr = u - u.mean(2, keepdims=True)
    np.testing.assert_allclose(
        ref["gyradius"]["gyradii"],
        np.sqrt((dr**2).sum(-1).mean(-1)).mean(-1), rtol=1e-12)
    e = u[:, :, -1] - u[:, :, 0]
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    np.testing.assert_allclose(ref["e2e_acf"]["acf"], brute_acf(e),
                               rtol=1e-12, atol=1e-15)
    p = np.arange(1, 4)[:, None]
    mat = np.cos(p * np.pi * (np.arange(NP) + 0.5) / NP) / NP
    amps = np.einsum("pn,tmnd->tmpd", mat, u)
    acf = np.stack([brute_acf(amps[:, :, k]) for k in range(3)])
    np.testing.assert_allclose(ref["rouse"]["acf"], acf / acf[:, :1],
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ref["rouse"]["mean_square_amplitudes"],
                               (amps**2).sum(-1).mean((0, 1)), rtol=1e-12)
    q_axis = (2 * np.pi * np.arange(4) / BOX).astype(np.float32).astype(
        np.float64)
    total = 0
    for frame in u:
        for chain in frame:
            power, grid = brute_power(chain, 4, q_axis)
            total = total + power
    np.testing.assert_allclose(ref["scsf"]["scsf"],
                               grouped(total / (7 * M * NP), grid),
                               rtol=1e-11)


def test_lower_precision_reference_reads_differently():
    """The control's reference in float32 is not the float64 one."""

    frames = wrapped(RNG.random((2, 3000, 3)) * BOX)
    spec = {"kwargs": {"n_bins": 200, "range": (0.0, 6.0),
                       "exclusion": (1, 1)}}
    ref = specs.reference("rdf_counts")
    f64 = ref.expected(frames, DIMS, spec, "cpu")
    f32 = ref.expected(frames, DIMS, spec, "cpu", torch.float32)
    assert ref.judge(f32, f64)["rdf_count_diff"] > 0
    assert ref.judge(f64, f64)["rdf_count_diff"] == 0
