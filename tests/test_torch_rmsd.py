"""The port's RMSD, RMSF, PCA and TICA against float64 oracles and the
JAX package's classes.

The fixture is a protein-like group inside a larger universe: 10 of 30
atoms (the rest a solvent the classes must not read) move as a reference
structure under a random rigid rotation and translation a frame, with two
collective modes of distinct variance and correlation time (AR(1)
amplitudes, 2 and 8 frames) and isotropic noise on top; float32
coordinates, 120 frames, in chunks of 3 frames (a short last chunk).

* The port fits in float64 (the float32 stream cast): RMSD and rotations
  within ``rtol=1e-10`` of a float64 oracle
  (``scipy.spatial.transform.Rotation.align_vectors`` on the same float32
  coordinates, as ``tests/test_analysis_rmsd.py`` does), frame 0 against
  itself below 1e-6 A; RMSF, PCA and TICA within ``rtol=1e-10`` of
  oracles that align with it.
* Against the JAX classes at their CPU default (float64 stream): within
  1e-9.  Against them streaming float32 (``_coord_dtype``): RMSD squares
  within ``F32_FACTOR * eps32 * (G_p + G_q) / W``, the cancellation of
  ``G_p + G_q - 2 lambda`` in float32 (ROADMAP Queue 3, item 16).
* Rotations are compared as matrices (q and -q are one rotation); a
  collinear group, whose top eigenvalue is degenerate, is held by its
  RMSD only.
* PCA and TICA components are compared where their eigenvalues are well
  separated (the two imposed modes), with the largest-|entry|-positive
  sign rule; the rest through projectors.
* TICA's lag ring crosses chunks (chunks of 3 frames, lag 4) and a frame
  selection ``step``: its float64 sums equal a frame-by-frame oracle.
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import rmsd as jax_rmsd  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.analysis import rmsd  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N_UNIVERSE, N_GROUP, T, CHUNK = 30, 10, 120, 3
GROUP = slice(10, 10 + N_GROUP)
RTOL = 1e-10
EPS32 = float(np.finfo(np.float32).eps)
#: the float32 JAX fit's RMSD^2 against the port's, in units of
#: eps32 (G_p + G_q) / W: the float32 sums and the float32 4 x 4 eigh
#: each leave a few ulps of G.
F32_FACTOR = 16.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ar1(rng, n, tau):
    rho = np.exp(-1.0 / tau)
    x = np.empty(n)
    x[0] = rng.standard_normal()
    for t in range(1, n):
        x[t] = rho * x[t - 1] + np.sqrt(1 - rho**2) * rng.standard_normal()
    return x


def _protein(seed=4242, n_frames=T, noise=0.05):
    """``(frames float32 (T, 30, 3), base (10, 3), modes (2, 10, 3),
    amplitudes (T, 2), masses (30,))``."""

    rng = np.random.default_rng(seed)
    base = rng.normal(size=(N_GROUP, 3)) * 4.0
    # orthonormal modes free of rigid motion: orthogonal to the three
    # translations and the three rotations of the base structure
    rigid = [np.tile(np.eye(3)[k], (N_GROUP, 1)) for k in range(3)]
    rigid += [np.cross(np.eye(3)[k], base) for k in range(3)]
    basis = np.linalg.qr(np.stack([r.ravel() for r in rigid], 1))[0]
    modes = rng.normal(size=(2, 3 * N_GROUP))
    modes -= (modes @ basis) @ basis.T
    modes = np.linalg.qr(modes.T)[0].T.reshape(2, N_GROUP, 3)
    amps = np.stack([1.5 * _ar1(rng, n_frames, 8.0),
                     0.8 * _ar1(rng, n_frames, 2.0)], axis=1)
    frames = rng.random((n_frames, N_UNIVERSE, 3)) * 30.0
    rotations = Rotation.random(n_frames, rng=rng).as_matrix()
    for t in range(n_frames):
        local = (base + np.einsum("m,mnd->nd", amps[t], modes)
                 + rng.normal(size=(N_GROUP, 3)) * noise)
        frames[t, GROUP] = local @ rotations[t].T + rng.normal(size=3) * 5.0
    masses = rng.choice([12.011, 14.007, 15.999, 32.06], N_UNIVERSE)
    return frames.astype(np.float32), base, modes, amps, masses


@pytest.fixture(scope="module")
def protein():
    frames, base, modes, amps, masses = _protein()
    dims = np.array([30.0] * 3 + [90.0] * 3)
    return {
        "frames": frames, "base": base, "modes": modes, "amps": amps,
        "masses": masses,
        "jax": JaxUniverse.from_arrays(frames.astype(np.float64), dims,
                                       masses=masses, dt=2.0),
        "port": Universe.from_arrays(frames, dims, masses=masses, dt=2.0),
    }


def _aligned_oracle(frames, ref, w, align=True):
    """float64 Kabsch of the float32 `frames` ``(T, N, 3)`` onto `ref`:
    ``(rmsd (T,), rotations (T, 3, 3), aligned (T, N, 3))``."""

    w_total = w.sum()
    ref_c = ref - (w[:, None] * ref).sum(0) / w_total
    out = ([], [], [])
    for p in frames.astype(np.float64):
        pc = p - (w[:, None] * p).sum(0) / w_total
        rot = (Rotation.align_vectors(ref_c, pc, weights=w)[0].as_matrix()
               if align else np.eye(3))
        a = pc @ rot.T
        out[0].append(np.sqrt((w * ((a - ref_c) ** 2).sum(1)).sum()
                              / w_total))
        out[1].append(rot)
        out[2].append(a)
    return tuple(np.array(x) for x in out)


def _port(cls, u, **kwargs):
    a = getattr(rmsd, cls)(u.atoms[GROUP], verbose=False, device="cpu",
                           **kwargs)
    a._chunk_bytes = CHUNK * N_GROUP * 3 * 4
    return a


def _jax(cls, u, **kwargs):
    a = getattr(jax_rmsd, cls)(u.atoms[GROUP], verbose=False, **kwargs)
    a._chunk_bytes = CHUNK * N_GROUP * 3 * 8
    return a


WEIGHTS = {
    "unit": None,
    "mass": "mass",
    "explicit": np.linspace(0.5, 2.0, N_GROUP),
}


def _w(protein, weights):
    if weights is None:
        return np.ones(N_GROUP)
    if isinstance(weights, str):
        return protein["masses"][GROUP]
    return weights


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("reference", ["frame", "explicit"])
def test_rmsd_matches_f64_oracle_and_jax(protein, weights, reference):
    w_spec = WEIGHTS[weights]
    w = _w(protein, w_spec)
    frames = protein["frames"][:, GROUP]
    ref = (protein["base"] if reference == "explicit"
           else frames[0].astype(np.float64))
    spec = ref if reference == "explicit" else 0
    port = _port("RMSD", protein["port"], weights=w_spec,
                 reference=spec).run()
    r_o, rot_o, _ = _aligned_oracle(frames, ref, w)
    moving = slice(1, None) if reference == "frame" else slice(None)
    np.testing.assert_allclose(port.results.rmsd[moving], r_o[moving],
                               rtol=RTOL)
    np.testing.assert_allclose(port.results.rotations, rot_o, rtol=0,
                               atol=RTOL)
    if reference == "frame":
        assert port.results.rmsd[0] < 1e-6
    ref_jax = _jax("RMSD", protein["jax"], weights=w_spec,
                   reference=spec).run()
    np.testing.assert_allclose(port.results.rmsd, ref_jax.results.rmsd,
                               rtol=0, atol=1e-9 if reference == "explicit"
                               else 1e-6)
    np.testing.assert_allclose(port.results.rmsd[moving],
                               ref_jax.results.rmsd[moving], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(port.results.rotations,
                               ref_jax.results.rotations, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(port.results.times,
                                  ref_jax.results.times)


def test_rmsd_against_the_float32_jax_fit(protein, monkeypatch):
    """The JAX class streaming float32 fits in float32: its RMSD^2 moves
    by up to F32_FACTOR eps32 (G_p + G_q) / W from the port's (3.4 of
    that unit at most on this fixture, 6.5e-5 A in the RMSD)."""

    monkeypatch.setattr(jax_base.SerialAnalysisBase, "_coord_dtype",
                        np.float32)
    w = protein["masses"][GROUP]
    port = _port("RMSD", protein["port"], weights="mass").run()
    ref = _jax("RMSD", protein["jax"], weights="mass").run()
    frames = protein["frames"][:, GROUP].astype(np.float64)
    w_total = w.sum()
    centered = frames - np.einsum("n,tnd->td", w, frames)[:, None] / w_total
    g = np.einsum("n,tnd->t", w, centered**2)
    bound = F32_FACTOR * EPS32 * (g + g[0]) / w_total
    diff = np.abs(port.results.rmsd**2 - ref.results.rmsd**2)
    assert (diff <= bound).all(), (diff / bound).max()
    assert port.results.rmsd[0] < 1e-6


def test_rmsd_without_alignment_and_reduced(protein):
    port = _port("RMSD", protein["port"], align=False, reduced=True).run()
    r_o, _, _ = _aligned_oracle(protein["frames"][:, GROUP],
                                protein["frames"][0, GROUP].astype(float),
                                np.ones(N_GROUP), align=False)
    np.testing.assert_allclose(port.results.rmsd, r_o, rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_array_equal(
        port.results.rotations,
        np.broadcast_to(np.eye(3), port.results.rotations.shape))
    assert "units" not in port.results


@pytest.mark.filterwarnings("ignore:Optimal rotation is not uniquely")
def test_collinear_group_rmsd(protein):
    """Atoms on a line: rotations about the line are free, so the top
    eigenvalue of the 4 x 4 problem is degenerate; the RMSD is still the
    oracle's (the rotation is not compared)."""

    rng = np.random.default_rng(9)
    line = np.linspace(-6.0, 6.0, 8)[:, None] * np.array([[0.6, 0.0, 0.8]])
    frames = np.empty((6, 8, 3))
    for t in range(6):
        rot = Rotation.random(rng=rng).as_matrix()
        stretch = 1.0 + 0.05 * rng.standard_normal((8, 1))
        frames[t] = (line * stretch) @ rot.T + rng.normal(size=3)
    frames = frames.astype(np.float32)
    u = Universe.from_arrays(frames, np.array([50.0] * 3 + [90.0] * 3))
    port = rmsd.RMSD(u.atoms, reference=line, verbose=False,
                     device="cpu").run()
    r_o, _, _ = _aligned_oracle(frames, line, np.ones(8))
    np.testing.assert_allclose(port.results.rmsd, r_o, rtol=1e-9)
    dets = np.linalg.det(port.results.rotations)
    np.testing.assert_allclose(dets, 1.0, atol=1e-12)


@pytest.mark.parametrize("weights", ["unit", "mass"])
def test_rmsf_matches_f64_oracle_and_jax(protein, weights):
    w_spec = WEIGHTS[weights]
    w = _w(protein, w_spec)
    frames = protein["frames"][:, GROUP]
    port = _port("RMSF", protein["port"], weights=w_spec).run()
    _, _, aligned = _aligned_oracle(frames, frames[0].astype(float), w)
    mean = aligned.mean(0)
    rmsf = np.sqrt(((aligned - mean) ** 2).sum(-1).mean(0))
    np.testing.assert_allclose(port.results.rmsf, rmsf, rtol=RTOL)
    np.testing.assert_allclose(port.results.mean_positions, mean, rtol=0,
                               atol=RTOL * np.abs(mean).max())
    ref = _jax("RMSF", protein["jax"], weights=w_spec).run()
    np.testing.assert_allclose(port.results.rmsf, ref.results.rmsf, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(port.results.mean_positions,
                               ref.results.mean_positions, rtol=0, atol=1e-9)
    assert set(port.results.units) == set(ref.results.units)


def _sign(vecs):
    peaks = np.argmax(np.abs(vecs), axis=0)
    signs = np.sign(vecs[peaks, np.arange(vecs.shape[1])])
    return vecs * np.where(signs == 0, 1.0, signs)


def test_pca_matches_f64_oracle_and_jax(protein):
    frames = protein["frames"][:, GROUP]
    port = _port("PrincipalComponentAnalysis", protein["port"],
                 reference=protein["base"]).run()
    _, _, aligned = _aligned_oracle(frames, protein["base"],
                                    np.ones(N_GROUP))
    x = aligned.reshape(T, -1)
    mean = x.mean(0)
    cov = (x - mean).T @ (x - mean) / T
    vals, vecs = np.linalg.eigh(cov)
    vals, vecs = vals[::-1], _sign(vecs[:, ::-1])
    scale = vals[0]
    np.testing.assert_allclose(port.results.variance, np.maximum(vals, 0),
                               rtol=0, atol=RTOL * scale)
    assert vals[0] > 1.5 * vals[1] > 3 * vals[2]  # the imposed modes
    np.testing.assert_allclose(port.results.p_components[:, :2],
                               vecs[:, :2], rtol=0, atol=1e-8)
    # the imposed modes, rotated into the reference frame, are recovered
    modes = protein["modes"].reshape(2, -1)
    cos = np.abs(modes @ port.results.p_components[:, :2])
    assert cos[0, 0] > 0.98 and cos[1, 1] > 0.98
    # projector onto the next eight components (their eigenvalues close)
    k = slice(2, 10)
    np.testing.assert_allclose(
        port.results.p_components[:, k] @ port.results.p_components[:, k].T,
        vecs[:, k] @ vecs[:, k].T, rtol=0, atol=1e-6)
    proj = port.transform(n_components=3)
    np.testing.assert_allclose(proj, (x - mean) @ port.results.p_components[
        :, :3], rtol=0, atol=RTOL * np.abs(proj).max())
    ref = _jax("PrincipalComponentAnalysis", protein["jax"],
               reference=protein["base"]).run()
    np.testing.assert_allclose(port.results.variance, ref.results.variance,
                               rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(port.results.p_components[:, :2],
                               ref.results.p_components[:, :2], rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(proj, ref.transform(n_components=3), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(port.results.cumulated_variance[-1], 1.0,
                               rtol=1e-12)


def _tica_sums(x, lag):
    """Frame-by-frame float64 sums of the lag ring."""

    sums = {key: 0.0 for key in ("sum", "m2", "sum_a", "sum_b", "mab")}
    for t, xt in enumerate(x):
        sums["sum"] = sums["sum"] + xt
        sums["m2"] = sums["m2"] + np.outer(xt, xt)
        if t >= lag:
            sums["sum_a"] = sums["sum_a"] + x[t - lag]
            sums["sum_b"] = sums["sum_b"] + xt
            sums["mab"] = sums["mab"] + np.outer(x[t - lag], xt)
    return sums


@pytest.mark.parametrize("step", [1, 2])
def test_tica_ring_crosses_chunks(protein, step):
    """Chunks of 3 frames under a lag of 4 (and every second frame): the
    ring's float64 sums equal the frame-by-frame oracle's."""

    lag = 4
    t = _port("TICA", protein["port"], lag=lag, weights="mass")
    t.run(step=step)
    frames = protein["frames"][::step, GROUP]
    _, _, aligned = _aligned_oracle(frames, frames[0].astype(float),
                                    protein["masses"][GROUP])
    x = aligned.reshape(len(frames), -1)
    for key, value in _tica_sums(x, lag).items():
        got = t._carry[key].numpy()
        np.testing.assert_allclose(got, value, rtol=0,
                                   atol=RTOL * np.abs(value).max())
    assert t._carry["frame"] == len(frames)


def _tica_oracle(x, lag, rcond=1e-8):
    mean = x.mean(0)
    c0 = (x - mean).T @ (x - mean) / len(x)
    a, b = x[:-lag] - mean, x[lag:] - mean
    ctau = a.T @ b / len(a)
    ctau = (ctau + ctau.T) / 2
    vals0, vecs0 = np.linalg.eigh(c0)
    keep = vals0 > rcond * vals0[-1]
    whiten = vecs0[:, keep] / np.sqrt(vals0[keep])
    m = whiten.T @ ctau @ whiten
    lam, y = np.linalg.eigh((m + m.T) / 2)
    return lam[::-1], _sign(whiten @ y[:, ::-1]), c0, ctau


def test_tica_matches_f64_oracle_and_jax(protein):
    lag = 3
    t = _port("TICA", protein["port"], lag=lag).run()
    frames = protein["frames"][:, GROUP]
    _, _, aligned = _aligned_oracle(frames, frames[0].astype(float),
                                    np.ones(N_GROUP))
    x = aligned.reshape(T, -1)
    lam, comps, c0, ctau = _tica_oracle(x, lag)
    assert t.results.rank == comps.shape[1]
    np.testing.assert_allclose(t.results.eigenvalues, lam, rtol=0, atol=1e-9)
    assert lam[0] - lam[1] > 0.05 and lam[1] - lam[2] > 0.05
    np.testing.assert_allclose(t.results.tica_components[:, :2],
                               comps[:, :2], rtol=0,
                               atol=1e-7 * np.abs(comps[:, :2]).max())
    u_c = t.results.tica_components
    np.testing.assert_allclose(np.einsum("ik,ij,jk->k", u_c, c0, u_c), 1.0,
                               atol=1e-8)
    np.testing.assert_allclose(np.einsum("ik,ij,jk->k", u_c, ctau, u_c),
                               t.results.eigenvalues, atol=1e-8)
    # the slowest component follows the 8-frame mode's amplitude
    slow = (x - x.mean(0)) @ u_c[:, 0]
    corr = [abs(np.corrcoef(slow, a)[0, 1]) for a in protein["amps"].T]
    assert corr[0] > 0.9 > 0.5 > corr[1], corr
    ok = (lam > 1e-3) & (lam < 1)
    np.testing.assert_allclose(t.results.timescales[ok],
                               -lag * 2.0 / np.log(lam[ok]), rtol=1e-8)
    proj = t.transform(2)
    np.testing.assert_allclose(proj, (x - x.mean(0)) @ u_c[:, :2], rtol=0,
                               atol=1e-8 * np.abs(proj).max())
    ref = _jax("TICA", protein["jax"], lag=lag).run()
    np.testing.assert_allclose(t.results.eigenvalues, ref.results.eigenvalues,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(t.results.tica_components[:, :2],
                               ref.results.tica_components[:, :2], rtol=0,
                               atol=1e-6 * np.abs(comps[:, :2]).max())
    np.testing.assert_allclose(proj, ref.transform(2), rtol=0,
                               atol=1e-6 * np.abs(proj).max())
    assert set(t.results.units) == set(ref.results.units)


def test_validation(protein):
    u = protein["port"]
    ju = protein["jax"]
    for module, universe, device in ((jax_rmsd, ju, {}),
                                     (rmsd, u, {"device": "cpu"})):
        with pytest.raises(ValueError, match="weights"):
            module.RMSD(universe.atoms, weights="charge", verbose=False,
                        **device)
        with pytest.raises(ValueError, match="one value per"):
            module.RMSD(universe.atoms, weights=np.ones(3), verbose=False,
                        **device)
        with pytest.raises(ValueError, match="non-negative"):
            module.RMSD(universe.atoms[:3], weights=-np.ones(3),
                        verbose=False, **device)
        with pytest.raises(ValueError, match="reference"):
            module.RMSD(universe.atoms, reference=np.zeros((4, 3)),
                        verbose=False, **device).run()
        with pytest.raises(ValueError, match="at least 3"):
            module.RMSD(universe.atoms[:2], verbose=False, **device)
        with pytest.raises(ValueError, match="positive"):
            module.TICA(universe.atoms, lag=0, verbose=False, **device)
        with pytest.raises(ValueError, match="below the analyzed"):
            module.TICA(universe.atoms, lag=5, verbose=False,
                        **device).run(stop=5)
        with pytest.raises(ValueError, match="evenly spaced"):
            module.TICA(universe.atoms, lag=1, verbose=False,
                        **device).run(frames=[0, 1, 3, 4])
        for cls in ("PrincipalComponentAnalysis", "TICA"):
            with pytest.raises(RuntimeError, match="run"):
                getattr(module, cls)(universe.atoms, verbose=False,
                                     **device).transform()
    # parallel=True is taken (ROADMAP Queue 1, item 10b-2; TICA on one
    # rank)
    for cls in ("RMSD", "RMSF", "PrincipalComponentAnalysis", "TICA"):
        assert getattr(rmsd, cls)(u.atoms, parallel=True,
                                  device="cpu")._parallel
