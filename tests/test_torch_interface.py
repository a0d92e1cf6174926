"""The port's Willard-Chandler interfaces against the JAX package's and
numpy oracles.

A corrugated liquid slab (float32, 3,000 surface sites, a few ions) goes
through ``mdhelper_tpu.analysis.interface`` (streaming float32:
``_coord_dtype`` on its base class, on the CPU) and its port
(``device="cpu"``), in chunks of 2 frames of 5.

* ``slab_interface_heights`` and ``interpolate_height_maps`` take the same
  float32 inputs in both packages and give the same bits as the jitted
  JAX functions (NaN columns included): the port forms ``n u - 1/2`` and
  the bilinear sum with the fused multiply-adds XLA compiles them to.
* The port's fields come from float64 FFTs rounded once to float32, the
  JAX package's from XLA's float32 FFTs, which round at about 1e-7 of the
  field.  Fields agree within ``FIELD_RTOL`` of their maximum; levels
  within ``LEVEL_RTOL`` (a grid point at half the maximum may leave or
  join the bulk mask, which moves the level by about one over the mask's
  size); heights, continuous in the field, within ``HEIGHT_ATOL``; the
  fixtures' columns stay clear of the level, so NaN columns are the same.
  The JAX test's float64 numpy mirror of the pipeline holds the port
  within the same bounds.
* ``IntrinsicDensityProfile``'s counts are the port's own interpolation
  of its own heights, binned in float32 against the float64 linspace
  edges rounded to float32: they equal a numpy float32 evaluation on the
  port's heights exactly, and the JAX package's within ``COUNT_ATOL`` a
  bin (an atom within a height error of a bin edge moves a bin) with the
  same totals.
* The post-hoc methods (spectrum, surface tension, PMF) are host float64
  numpy in both packages: on the same heights or densities they agree
  within ``POSTHOC_RTOL``.  End to end, the spectrum is held within the
  bound that the measured height difference implies (``spectrum_bound``)
  and, with the surface tension, within 5 %.
* A chunk's frames go through the grid in passes of ``_grid_bytes``; one
  frame a pass gives the bits of one pass a chunk.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.analysis import interface as jax_interface  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch import Q_  # noqa: E402
from mdhelper_tpu_torch.analysis import interface  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.testing import fma32  # noqa: E402

BOX = np.array([12.0, 12.0, 18.0])
T, N_SURF, N_ION, CHUNK = 5, 3000, 60, 2
CELLS = (16, 16, 32)
XI = 1.2
FIELD_RTOL, LEVEL_RTOL, HEIGHT_ATOL = 2e-6, 1e-4, 2e-3
COUNT_ATOL = 3
POSTHOC_RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_streams_float32(monkeypatch):
    monkeypatch.setattr(jax_base.SerialAnalysisBase, "_coord_dtype",
                        np.float32)


def slab_frames(rng, n_frames, n_surf, n_ion, box, z_lo, z_up, amp):
    """float32 frames: `n_surf` sites uniform in a slab between z_lo and
    z_up, both surfaces corrugated by amp sin(2 pi x / L_x + t), then
    `n_ion` ions uniform in z over the box; a few sites wrapped below 0."""

    out = np.empty((n_frames, n_surf + n_ion, 3))
    for t in range(n_frames):
        x = rng.uniform(0, box[0], n_surf)
        y = rng.uniform(0, box[1], n_surf)
        zeta = amp * np.sin(2 * np.pi * x / box[0] + t)
        z = zeta + rng.uniform(z_lo, z_up, n_surf)
        out[t, :n_surf] = np.stack((x, y, z), axis=-1)
        out[t, n_surf:] = rng.random((n_ion, 3)) * box
    out[:, :5, 1] -= box[1]
    return out.astype(np.float32)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(17)
    pos = slab_frames(rng, T, N_SURF, N_ION, BOX, 5.0, 13.0, 1.0)
    n = N_SURF + N_ION
    topology = dict(
        masses=np.concatenate([np.full(N_SURF, 16.0), np.full(N_ION, 23.0)]),
        charges=np.concatenate([np.zeros(N_SURF),
                                np.tile([1.0, -1.0], N_ION // 2)]),
        resindices=np.concatenate([np.repeat(np.arange(N_SURF // 3), 3),
                                   N_SURF // 3 + np.arange(N_ION)]),
    )
    assert len(topology["masses"]) == n
    return pos, np.concatenate([BOX, [90.0] * 3]), topology


def _pair(pos, dims, topology):
    return (JaxUniverse.from_arrays(pos.astype(np.float64), dims, dt=1.0,
                                    **topology),
            Universe.from_arrays(pos, dims, dt=1.0, **topology))


@pytest.fixture(scope="module")
def universes(system):
    return _pair(*system)


def _run(a, runner="run"):
    a._chunk_bytes = CHUNK * len(a._atom_indices) * 3 * 4
    if runner == "together":
        return run_together([a])[0]
    return a.run()


def _slab_field(rng, shape=(3, 8, 8, 24)):
    """float32 density columns: a bump along the last axis with noise, a
    few columns far below the level (NaN heights)."""

    z = np.arange(shape[-1])
    bump = np.exp(-0.5 * ((z - 12) / 4.0) ** 2)
    field = bump * (1 + 0.05 * rng.standard_normal(shape))
    field[:, 0, :3] *= 0.1
    return field.astype(np.float32)


def test_slab_heights_equal_jax():
    field = _slab_field(np.random.default_rng(1))
    level = np.full((3, 1, 1, 1), 0.5, np.float32)
    length = np.full((3, 1, 1), 18.0, np.float32)
    heights = jax.jit(jax_interface.slab_interface_heights,
                      static_argnums=2)
    want = np.asarray(heights(jnp.asarray(field), jnp.asarray(level), 24,
                              jnp.asarray(length)))
    got = interface.slab_interface_heights(
        torch.as_tensor(field), torch.as_tensor(level), 24,
        torch.as_tensor(length)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any() and np.isfinite(got).mean() > 0.9


def test_height_interpolation_equals_jax():
    rng = np.random.default_rng(2)
    maps = (rng.random((3, 8, 12)) * 5 + 4).astype(np.float32)
    maps[1, 2, 3] = np.nan
    frac = rng.random((3, 500, 2)).astype(np.float32)
    frac[:, 0] = [0.0, np.nextafter(np.float32(1), np.float32(0))]
    # jitted, as the JAX classes run it (XLA fuses its products and sums)
    want = np.asarray(jax.jit(jax_interface.interpolate_height_maps)(
        jnp.asarray(maps), jnp.asarray(frac)))
    got = interface.interpolate_height_maps(
        torch.as_tensor(maps), torch.as_tensor(frac)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[1]).any() and not np.isnan(got[0]).any()


def _assert_wc_close(out, ref):
    field = ref.results.density_field
    np.testing.assert_allclose(out.results.density_field, field, rtol=0,
                               atol=FIELD_RTOL * np.abs(field).max())
    np.testing.assert_allclose(out.results.levels, ref.results.levels,
                               rtol=LEVEL_RTOL)
    h, rh = out.results.heights, ref.results.heights
    np.testing.assert_array_equal(np.isnan(h), np.isnan(rh))
    np.testing.assert_allclose(h, rh, rtol=0, atol=HEIGHT_ATOL)
    np.testing.assert_allclose(out.results.mean_heights,
                               ref.results.mean_heights, atol=HEIGHT_ATOL)
    np.testing.assert_allclose(out.results.interface_width,
                               ref.results.interface_width, rtol=1e-3)
    for b, rb in zip(out.results.bins, ref.results.bins):
        np.testing.assert_array_equal(b, rb)


WC_CASES = {
    "default": (slice(0, N_SURF), dict()),
    "residues_tsc": (slice(0, N_SURF), dict(grouping="residues", axis="z",
                                          order=3)),
    "subset_ngp": (slice(0, N_SURF, 2), dict(order=1)),
    "fixed_level": (slice(0, N_SURF), dict(level=0.12, order=2)),
}


@pytest.mark.parametrize("case,runner", [(case, "run") for case in WC_CASES]
                         + [("default", "together")])
def test_willard_chandler_matches_jax(universes, case, runner):
    ju, tu = universes
    sel, kwargs = WC_CASES[case]
    kwargs = {"xi": XI, "n_cells": CELLS, **kwargs}
    ref = _run(jax_interface.WillardChandlerInterface(
        ju.atoms[sel], verbose=False, **kwargs))
    out = _run(interface.WillardChandlerInterface(
        tu.atoms[sel], verbose=False, device="cpu", **kwargs), runner)
    _assert_wc_close(out, ref)
    if case == "default":
        assert np.isfinite(out.results.heights).all()
    for what in (out, ref):
        what.calculate_spectrum()
        what.calculate_surface_tension(300.0)
    np.testing.assert_array_equal(out.results.spectrum_wavenumbers,
                                  ref.results.spectrum_wavenumbers)
    delta = np.nanmax(np.abs(out.results.heights - ref.results.heights))
    bound = spectrum_bound(ref.results.heights, BOX, delta)
    finite = np.isfinite(ref.results.spectrum)
    np.testing.assert_array_equal(np.isfinite(out.results.spectrum), finite)
    assert np.all(np.abs(out.results.spectrum - ref.results.spectrum)[finite]
                  <= bound[finite])
    np.testing.assert_allclose(out.results.spectrum, ref.results.spectrum,
                               rtol=0.05, atol=1e-6)
    np.testing.assert_allclose(out.results.surface_tension,
                               ref.results.surface_tension, rtol=0.05)
    assert set(out.results.units) == set(ref.results.units)

    # The same heights through both packages' post-hoc methods.
    out.results.heights = ref.results.heights.copy()
    del out.results["spectrum"]
    out.calculate_surface_tension(300.0)
    np.testing.assert_allclose(out.results.spectrum, ref.results.spectrum,
                               rtol=POSTHOC_RTOL)
    np.testing.assert_allclose(out.results.surface_tension,
                               ref.results.surface_tension,
                               rtol=POSTHOC_RTOL)


def spectrum_bound(heights, box, delta):
    """Largest change of each capillary-spectrum shell (as
    ``calculate_spectrum`` forms it, for a z normal) when every height of
    `heights` ``(2, T, n1, n2)`` moves by at most `delta`: a mode of the
    mean-removed map moves by at most 2 delta, so its power |z|^2 by at
    most 2 delta (2 |z| + 2 delta); shell means of the frame means of
    that, times the area.  Shape ``(2, n_q)`` of the kept shells."""

    _, _, n1, n2 = heights.shape
    q_mag = np.hypot(*np.meshgrid(
        2 * np.pi * np.fft.fftfreq(n1, d=box[0] / n1),
        2 * np.pi * np.fft.fftfreq(n2, d=box[1] / n2), indexing="ij"))
    shells = np.round(q_mag / (2 * np.pi / max(box[:2]))).astype(int)
    n_q = shells.max() + 1
    shell_counts = np.bincount(shells.ravel(), minlength=n_q)
    out = np.full((2, n_q), np.inf)
    for side in range(2):
        maps = heights[side][~np.isnan(heights[side]).any(axis=(1, 2))]
        if not len(maps):
            continue
        fluct = maps - maps.mean(axis=(1, 2), keepdims=True)
        zhat = np.abs(np.fft.fft2(fluct) / (n1 * n2))
        change = (2 * delta * (2 * zhat + 2 * delta)).mean(axis=0)
        out[side] = (box[0] * box[1] * np.bincount(
            shells.ravel(), weights=change.ravel(), minlength=n_q)
            / np.maximum(shell_counts, 1))
    keep = shell_counts > 0
    keep[0] = False
    return out[:, keep]


def test_willard_chandler_matches_numpy_mirror(universes, system):
    """The JAX test's float64 numpy mirror of the pipeline (deposit, FFT
    smoothing, bulk level, first crossings) on the float32 positions."""

    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_analysis_interface import oracle_pipeline

    _, tu = universes
    out = _run(interface.WillardChandlerInterface(
        tu.atoms[:N_SURF], xi=XI, n_cells=CELLS, verbose=False,
        device="cpu"))
    pos = system[0][:, :N_SURF].astype(np.float64)
    field, levels, heights = oracle_pipeline(pos, BOX, CELLS, XI)
    np.testing.assert_allclose(out.results.density_field, field, rtol=0,
                               atol=FIELD_RTOL * field.max())
    np.testing.assert_allclose(out.results.levels, levels, rtol=LEVEL_RTOL)
    np.testing.assert_allclose(out.results.heights, heights, rtol=0,
                               atol=HEIGHT_ATOL)


def test_per_frame_boxes(system):
    pos, dims, topology = system
    boxes = np.tile(dims, (T, 1))
    boxes[:, :3] *= (1 + 0.01 * np.sin(np.arange(T)))[:, None]
    ju, tu = _pair(pos, boxes, topology)
    kwargs = dict(xi=XI, n_cells=CELLS, verbose=False)
    ref = _run(jax_interface.WillardChandlerInterface(ju.atoms[:N_SURF],
                                                      **kwargs))
    out = _run(interface.WillardChandlerInterface(tu.atoms[:N_SURF],
                                                  device="cpu", **kwargs))
    _assert_wc_close(out, ref)


def _intrinsic_oracle(pos, heights, box, edges, axis=2):
    """int64 counts ``(2, n_bins)`` of the float32 signed distances of
    `pos` ``(T, N, 3)`` from the heights ``(2, T, n1, n2)`` (the port's,
    float32), wrapped, interpolated and minimum-imaged as XLA evaluates
    the JAX package's expressions (fused multiply-adds), binned against
    the float64 edges rounded to float32."""

    f32 = np.float32
    box32 = box.astype(f32)
    edges32 = edges.astype(f32)
    n_bins = len(edges) - 1
    t1, t2 = (a for a in range(3) if a != axis)
    out = np.zeros((2, n_bins), np.int64)
    fma = fma32
    for t in range(len(pos)):
        p = fma(-np.floor(pos[t] / box32), box32, pos[t])
        for s, sign in ((0, f32(1.0)), (1, f32(-1.0))):
            maps = heights[s, t].astype(f32)
            n1, n2 = maps.shape
            u = fma(p[:, t1] / box32[t1], n1, -0.5)
            v = fma(p[:, t2] / box32[t2], n2, -0.5)
            i0, j0 = np.floor(u), np.floor(v)
            fu, fv = u - i0, v - j0
            i0, j0 = i0.astype(np.int64), j0.astype(np.int64)
            wu = (f32(1) - fu, fu)
            wv = (f32(1) - fv, fv)
            total = None
            for i in (0, 1):
                for j in (0, 1):
                    c = maps[(i0 + i) % n1, (j0 + j) % n2]
                    term = c * wu[i]
                    total = term * wv[j] if total is None else fma(
                        term, wv[j], total)
            d = sign * (p[:, axis] - total)
            d = fma(-box32[axis], np.round(d / box32[axis]), d)
            idx = np.searchsorted(edges32, d, side="right") - 1
            idx[d == edges32[-1]] = n_bins - 1
            ok = (d >= edges32[0]) & (d <= edges32[-1])
            out[s] += np.bincount(np.clip(idx, 0, n_bins - 1)[ok],
                                  minlength=n_bins)
    return out


def test_intrinsic_counts_equal_oracle_on_own_heights(universes, system):
    _, tu = universes
    kwargs = dict(xi=XI, n_cells=CELLS, verbose=False, device="cpu")
    surf = tu.atoms[:N_SURF]
    ions = tu.atoms[N_SURF:]
    idp = _run(interface.IntrinsicDensityProfile(
        surf, [surf, ions], n_bins=40, range=(-6.0, 6.0), **kwargs))
    wc = _run(interface.WillardChandlerInterface(surf, **kwargs))
    pos = system[0]
    for g, cols in enumerate((slice(0, N_SURF), slice(N_SURF, None))):
        want = _intrinsic_oracle(pos[:, cols], wc.results.heights, BOX,
                                 idp.results.edges)
        np.testing.assert_array_equal(idp.results.counts[g], want)
    assert idp.results.counts[0].sum() > 0.6 * 2 * T * N_SURF


INTRINSIC_CASES = {
    "both": dict(),
    "lower_groups": dict(groups="split", side="lower", n_bins=50,
                         range=(-7.0, 5.0)),
    "upper_residues": dict(groupings="residues", surface_grouping="residues",
                           side="upper", order=3),
    "charges": dict(groups="split", charges=[0.5, -1.0], level=0.1),
}


@pytest.mark.parametrize("case", list(INTRINSIC_CASES))
def test_intrinsic_matches_jax(universes, case):
    ju, tu = universes
    kwargs = dict(INTRINSIC_CASES[case])
    split = kwargs.pop("groups", None) == "split"

    def groups(u):
        surf = u.atoms[:N_SURF]
        return surf, ([surf[::2], u.atoms[N_SURF:]] if split else None)

    common = dict(xi=XI, n_cells=CELLS, verbose=False)
    ref = _run(jax_interface.IntrinsicDensityProfile(*groups(ju), **common,
                                                     **kwargs))
    out = _run(interface.IntrinsicDensityProfile(*groups(tu), **common,
                                                 device="cpu", **kwargs))
    np.testing.assert_array_equal(out.results.edges, ref.results.edges)
    c, rc = out.results.counts, ref.results.counts
    assert c.shape == rc.shape
    assert np.abs(c - rc).max() <= COUNT_ATOL
    np.testing.assert_array_equal(c.sum(-1), rc.sum(-1))
    scale = np.abs(ref.results.number_densities).max()
    np.testing.assert_allclose(out.results.number_densities,
                               ref.results.number_densities, rtol=0,
                               atol=COUNT_ATOL * scale / 50)
    if ref.results.charge_densities is None:
        assert out.results.charge_densities is None
    else:
        np.testing.assert_allclose(out.results.charge_densities,
                                   ref.results.charge_densities, rtol=0,
                                   atol=COUNT_ATOL * scale / 50)
    with np.errstate(all="ignore"):
        for what in (out, ref):
            what.calculate_pmf(300.0)
    finite = np.isfinite(ref.results.pmf) & (rc.sum(1) > 200)
    np.testing.assert_allclose(out.results.pmf[finite],
                               ref.results.pmf[finite], atol=0.05)
    # the same densities through both packages' calculate_pmf
    out.results.number_densities = ref.results.number_densities.copy()
    with np.errstate(all="ignore"):
        out.calculate_pmf(300.0)
    np.testing.assert_allclose(out.results.pmf, ref.results.pmf,
                               rtol=POSTHOC_RTOL)
    assert {k: str(v) for k, v in out.results.units.items()} == {
        k: str(v) for k, v in ref.results.units.items()}


@pytest.mark.parametrize("cls", ["WillardChandlerInterface",
                                 "IntrinsicDensityProfile"])
def test_grid_passes_equal_one_pass(universes, cls):
    """One frame a grid pass (``_grid_bytes`` 1) against the whole chunk
    in one pass: the same bits."""

    _, tu = universes
    surf = tu.atoms[:N_SURF]
    make = getattr(interface, cls)
    runs = []
    for grid_bytes in (1, 1 << 40):
        a = make(surf, xi=XI, n_cells=CELLS, verbose=False, device="cpu")
        a._grid_bytes = grid_bytes
        a._chunk_bytes = 4 * len(a._atom_indices) * 3 * 4
        runs.append(a.run())
    assert interface._grid_pass_frames(1, CELLS, N_SURF, 2) == 1
    assert interface._grid_pass_frames(1 << 40, CELLS, N_SURF, 2) >= T
    one, whole = runs
    keys = (("density_field", "levels", "heights") if cls.startswith("Will")
            else ("counts",))
    for key in keys:
        np.testing.assert_array_equal(one.results[key], whole.results[key])


def test_grid_pass_frames_fit_the_budget():
    # the (128, 128, 256) grid of a 100 x 100 x 180 A box at xi 2.4 A
    cells = (128, 128, 256)
    per_frame = 64 * 128 * 128 * 256 + 32 * 20_000 * 8
    assert interface._grid_pass_frames(1 << 30, cells, 20_000, 2) == (
        (1 << 30) // per_frame) == 3
    assert interface._grid_pass_frames(1 << 20, cells, 20_000, 2) == 1


def test_intrinsic_pmf_references_and_reduced(universes):
    _, tu = universes
    surf = tu.atoms[:N_SURF]
    idp = _run(interface.IntrinsicDensityProfile(
        surf, [surf, tu.atoms[N_SURF:]], xi=XI, n_cells=CELLS,
        reduced=True, verbose=False, device="cpu"))
    assert idp.results.units == {}
    idp.calculate_pmf(1.0, reference_densities=[0.03, 0.001])
    assert idp.results.pmf.shape == (2, 200)
    idp2 = _run(interface.IntrinsicDensityProfile(
        surf, xi=XI, n_cells=CELLS, range=(-9.0, -8.0), n_bins=4,
        verbose=False, device="cpu"))
    with pytest.warns(UserWarning, match="zero density"):
        idp2.calculate_pmf(Q_(300.0, "K"))


def test_default_grid_and_validation(universes, system):
    ju, tu = universes
    wc = interface.WillardChandlerInterface(tu.atoms, device="cpu")
    jwc = jax_interface.WillardChandlerInterface(ju.atoms)
    assert wc._n_cells == jwc._n_cells == (16, 16, 16)
    assert interface.WillardChandlerInterface(
        tu.atoms, n_cells=8, device="cpu")._n_cells == (8, 8, 8)
    pos, _, topology = system
    tri = Universe.from_arrays(pos, [12.0, 12.0, 18.0, 80.0, 90.0, 90.0],
                               **topology)
    for cls in (interface.WillardChandlerInterface,
                interface.IntrinsicDensityProfile):
        with pytest.raises(ValueError, match="orthorhombic"):
            cls(tri.atoms, device="cpu")
        # parallel=True is taken (ROADMAP Queue 1, item 10b-2)
        assert cls(tu.atoms, parallel=True, device="cpu")._parallel
        for kwargs, match in ((dict(axis="w"), "axis"), (dict(axis=3), "axis"),
                              (dict(xi=0.0), "xi"),
                              (dict(n_cells=2), "n_cells"),
                              (dict(n_cells=(8, 8)), "n_cells"),
                              (dict(order=4), "order")):
            with pytest.raises(ValueError, match=match):
                cls(tu.atoms, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="grouping"):
        interface.WillardChandlerInterface(tu.atoms, "molecules",
                                           device="cpu")
    for kwargs, match in ((dict(surface_grouping="x"), "surface_grouping"),
                          (dict(side="middle"), "side"),
                          (dict(n_bins=0), "n_bins"),
                          (dict(range=(1.0, -1.0)), "increasing")):
        with pytest.raises(ValueError, match=match):
            interface.IntrinsicDensityProfile(tu.atoms, device="cpu",
                                              **kwargs)
    no_box = Universe.from_arrays(pos, None, **topology)
    with pytest.raises(ValueError, match="periodic box"):
        interface.WillardChandlerInterface(no_box.atoms, device="cpu")
    wc = _run(interface.WillardChandlerInterface(
        tu.atoms[:N_SURF], xi=XI, n_cells=CELLS, reduced=True,
        verbose=False, device="cpu"))
    assert "units" not in wc.results
    with pytest.raises(ValueError, match="q_max"):
        wc.calculate_surface_tension(1.0, q_max=1e-3)
    with pytest.raises(ValueError, match="units"):
        wc.calculate_surface_tension(Q_(1.0, "K"))
