"""The port's CUDA kernels against their plain-torch versions, on the
card.  Imports only the port (the machine with the card has no JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda

Without a CUDA device every test here skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mdhelper_tpu_torch.ops import cuda_cell_histogram as cch  # noqa: E402
from mdhelper_tpu_torch.testing import (  # noqa: E402
    edge_straddle_cross_positions,
    edge_straddle_positions,
    f64_cross_histogram,
    f64_pair_histogram,
)

BOX = 16.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "straddle"])
def test_cell_kernel_equals_reference(cuda_device, case):
    rng = np.random.default_rng(31)
    if case == "uniform":
        pos, r_max, n_bins = (
            (rng.random((1200, 3)) * BOX).astype(np.float32), 3.5, 96
        )
    else:
        pos, r_max, n_bins = edge_straddle_positions(rng, BOX), 4.0, 16
    plan = cch.cell_plan_search(len(pos), [BOX] * 3, r_max)
    args = dict(box=(BOX,) * 3, r_max=r_max,
                n_cells_dim=plan["n_cells_dim"],
                capacity=plan["capacity"], n_bins=n_bins)
    frames = torch.from_numpy(np.stack([pos, pos[::-1].copy()]))
    frames = frames.to(cuda_device)
    before = cch.cell_pair_histogram.launches
    kernel, occ = cch.cell_pair_histogram(frames, **args)
    torch.cuda.synchronize()
    assert cch.cell_pair_histogram.launches == before + 1
    plain, plain_occ = cch.cell_pair_histogram_reference(frames, **args)
    torch.testing.assert_close(kernel, plain, rtol=0, atol=0)
    torch.testing.assert_close(occ, plain_occ, rtol=0, atol=0)
    np.testing.assert_array_equal(
        kernel[0].cpu().numpy(), f64_pair_histogram(pos, BOX, r_max, n_bins)
    )


@pytest.mark.cuda
def test_cell_kernel_large_capacity_and_shrunken_box(cuda_device):
    """A capacity above 48 KB of shared memory takes the opt-in launch
    path; a frame whose box is too small comes back NaN."""

    rng = np.random.default_rng(4)
    pos = (rng.random((2, 3000, 3)) * BOX).astype(np.float32)
    pos[1] *= np.float32(0.7)
    args = dict(box=torch.tensor([[BOX] * 3, [0.7 * BOX] * 3]),
                r_max=4.0, n_cells_dim=(3, 3, 4), capacity=1600,
                n_bins=64)
    frames = torch.from_numpy(pos).to(cuda_device)
    kernel, _ = cch.cell_pair_histogram(frames, **args)
    plain, _ = cch.cell_pair_histogram_reference(frames, **args)
    torch.cuda.synchronize()
    assert torch.isnan(kernel[1]).all()
    torch.testing.assert_close(kernel[0], plain[0], rtol=0, atol=0)


def test_cuda_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        cch.cell_pair_histogram(
            torch.zeros((1, 8, 3), device="meta"), box=(BOX,) * 3,
            r_max=4.0, n_cells_dim=(4, 4, 4), capacity=32, n_bins=8,
        )


def _cross_inputs(rng, n_frames=2):
    p1 = (rng.random((n_frames, 600, 3)) * BOX).astype(np.float32)
    p2 = (rng.random((n_frames, 900, 3)) * BOX).astype(np.float32)
    return p1, p2


@pytest.mark.cuda
@pytest.mark.parametrize("exclusion", [None, (1, 1), (2, 3)])
def test_cross_kernel_equals_reference(cuda_device, exclusion):
    p1, p2 = _cross_inputs(np.random.default_rng(41))
    r_max, n_bins = 3.5, 96
    plan = cch.cell_plan_search(600, [BOX] * 3, r_max, n_atoms2=900)
    args = dict(box=(BOX,) * 3, r_max=r_max,
                n_cells_dim=plan["n_cells_dim"],
                capacity1=plan["capacity"], capacity2=plan["capacity2"],
                n_bins=n_bins, exclusion=exclusion)
    f1 = torch.from_numpy(p1).to(cuda_device)
    f2 = torch.from_numpy(p2).to(cuda_device)
    before = cch.cross_pair_histogram.launches
    kernel = cch.cross_pair_histogram(f1, f2, **args)
    torch.cuda.synchronize()
    assert cch.cross_pair_histogram.launches == before + 1
    plain = cch.cross_pair_histogram_reference(f1, f2, **args)
    for k, p in zip(kernel, plain):
        torch.testing.assert_close(k, p, rtol=0, atol=0)
    np.testing.assert_array_equal(
        kernel[0][0].cpu().numpy(),
        f64_cross_histogram(p1[0], p2[0], BOX, r_max, n_bins, exclusion),
    )


@pytest.mark.cuda
def test_cross_kernel_straddle(cuda_device):
    a, b = edge_straddle_cross_positions(np.random.default_rng(99), BOX)
    plan = cch.cell_plan_search(len(a), [BOX] * 3, 4.0, n_atoms2=len(b))
    kernel, _, _ = cch.cross_pair_histogram(
        torch.from_numpy(a).to(cuda_device),
        torch.from_numpy(b).to(cuda_device), box=(BOX,) * 3, r_max=4.0,
        n_cells_dim=plan["n_cells_dim"], capacity1=plan["capacity"],
        capacity2=plan["capacity2"], n_bins=16,
    )
    np.testing.assert_array_equal(
        kernel[0].cpu().numpy(), f64_cross_histogram(a, b, BOX, 4.0, 16)
    )


@pytest.mark.cuda
def test_cross_kernel_large_capacity_and_shrunken_box(cuda_device):
    """Capacities above 48 KB of shared memory take the opt-in launch
    path; a frame whose box is too small comes back NaN."""

    p1, p2 = _cross_inputs(np.random.default_rng(7))
    p1[1] *= np.float32(0.7)
    p2[1] *= np.float32(0.7)
    args = dict(box=torch.tensor([[BOX] * 3, [0.7 * BOX] * 3]),
                r_max=4.0, n_cells_dim=(3, 3, 4), capacity1=1600,
                capacity2=1600, n_bins=64, exclusion=(2, 3))
    f1 = torch.from_numpy(p1).to(cuda_device)
    f2 = torch.from_numpy(p2).to(cuda_device)
    kernel, _, _ = cch.cross_pair_histogram(f1, f2, **args)
    plain, _, _ = cch.cross_pair_histogram_reference(f1, f2, **args)
    torch.cuda.synchronize()
    assert torch.isnan(kernel[1]).all()
    torch.testing.assert_close(kernel[0], plain[0], rtol=0, atol=0)


@pytest.mark.cuda
def test_vanhove_and_cross_rdf_on_the_card_equal_cpu(cuda_device):
    """The two new paths give the same counts on the card as on the
    CPU (plain versions)."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        VanHoveFunction,
    )
    from mdhelper_tpu_torch.core.universe import Universe

    rng = np.random.default_rng(12)
    traj = (rng.random((6, 1200, 3)) * BOX).astype(np.float32)
    u = Universe.from_arrays(traj, np.array([BOX] * 3))
    results = []
    for device in ("cpu", cuda_device):
        vh = VanHoveFunction(u.atoms, n_bins=32, range=(0.0, 4.0),
                             lags="log", verbose=False,
                             device=device).run()
        rdf = RadialDistributionFunction(
            u.atoms[0::2], u.atoms[1::2], n_bins=32, range=(0.0, 4.0),
            exclusion=(2, 3), verbose=False, device=device,
        ).run()
        results.append((vh.results.counts_self, vh.results.counts_distinct,
                        rdf.results.counts))
    for cpu, card in zip(*results):
        np.testing.assert_array_equal(cpu, card)


def test_cross_wrapper_rejects_other_devices():
    pos = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError):
        cch.cross_pair_histogram(
            pos, pos, box=(BOX,) * 3, r_max=4.0, n_cells_dim=(4, 4, 4),
            capacity1=32, capacity2=32, n_bins=8,
        )


# -- the triclinic kernels ----------------------------------------------------

#: the tilted cell of tests/test_pallas.py, and a small xy-square rhombic
#: dodecahedron (3 cells of r_max 4 on every axis).
TRICLINIC = {
    "dims6": np.array([16.0, 15.0, 14.0, 80.0, 95.0, 100.0]),
    "dodeca": np.array([18.0, 18.0, 18.0, 60.0, 60.0, 90.0]),
}


def _triclinic_frames(rng, name, n_frames, n_atoms, outside=False):
    """float32 frames at uniform fractional coordinates and the float32
    box matrix; with `outside`, every atom moved by a random lattice
    vector (the wrappers fold them back)."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices

    h64 = triclinic_matrices(TRICLINIC[name])
    frac = rng.random((n_frames, n_atoms, 3))
    if outside:
        frac += rng.integers(-1, 2, frac.shape)
    return (frac @ h64).astype(np.float32), h64.astype(np.float32)


def _triclinic_plan(box, r_max, n1, n2=None):
    widths = cch.triclinic_perpendicular_widths(box).astype(np.float64)
    return cch.cell_plan_search(n1, widths, r_max, n_atoms2=n2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dims6", "dodeca"])
@pytest.mark.parametrize("outside", [False, True], ids=["inside", "outside"])
def test_triclinic_self_kernel_equals_reference(cuda_device, name, outside):
    rng = np.random.default_rng(51)
    frames, box = _triclinic_frames(rng, name, 2, 900, outside)
    plan = _triclinic_plan(box, 3.5 if name == "dims6" else 4.0, 900)
    args = dict(box=box, r_max=3.5 if name == "dims6" else 4.0,
                n_cells_dim=plan["n_cells_dim"], capacity=plan["capacity"],
                n_bins=64)
    f = torch.from_numpy(frames).to(cuda_device)
    before = cch.triclinic_cell_pair_histogram.launches
    kernel = cch.triclinic_cell_pair_histogram(f, **args)
    torch.cuda.synchronize()
    assert cch.triclinic_cell_pair_histogram.launches == before + 1
    plain = cch.triclinic_cell_pair_histogram_reference(f, **args)
    for k, p in zip(kernel, plain):
        torch.testing.assert_close(k, p, rtol=0, atol=0)
    assert kernel[0].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("exclusion", [None, (1, 1), (2, 1)])
def test_triclinic_cross_kernel_equals_reference(cuda_device, exclusion):
    rng = np.random.default_rng(52)
    p1, box = _triclinic_frames(rng, "dims6", 2, 600, outside=True)
    p2, _ = _triclinic_frames(rng, "dims6", 2, 400)
    plan = _triclinic_plan(box, 3.0, 600, 400)
    args = dict(box=box, r_max=3.0, n_cells_dim=plan["n_cells_dim"],
                capacity1=plan["capacity"], capacity2=plan["capacity2"],
                n_bins=64, exclusion=exclusion)
    f1 = torch.from_numpy(p1).to(cuda_device)
    f2 = torch.from_numpy(p2).to(cuda_device)
    before = cch.triclinic_cross_pair_histogram.launches
    kernel = cch.triclinic_cross_pair_histogram(f1, f2, **args)
    torch.cuda.synchronize()
    assert cch.triclinic_cross_pair_histogram.launches == before + 1
    plain = cch.triclinic_cross_pair_histogram_reference(f1, f2, **args)
    for k, p in zip(kernel, plain):
        torch.testing.assert_close(k, p, rtol=0, atol=0)


@pytest.mark.cuda
def test_triclinic_kernels_straddle(cuda_device):
    from mdhelper_tpu_torch.testing import (
        edge_straddle_triclinic_positions,
        f64_triclinic_pair_histogram,
    )

    _, box = _triclinic_frames(np.random.default_rng(0), "dodeca", 1, 1)
    pos = edge_straddle_triclinic_positions(np.random.default_rng(99), box)
    plan = _triclinic_plan(box, 4.0, len(pos))
    self_counts, _ = cch.triclinic_cell_pair_histogram(
        torch.from_numpy(pos).to(cuda_device), box=box, r_max=4.0,
        n_cells_dim=plan["n_cells_dim"], capacity=plan["capacity"],
        n_bins=16,
    )
    np.testing.assert_array_equal(
        self_counts[0].cpu().numpy(),
        f64_triclinic_pair_histogram(pos, pos, box, 4.0, 16, (1, 1)),
    )
    a, b = pos[:300], pos[300:]
    plan = _triclinic_plan(box, 4.0, 300, 90)
    cross_counts, _, _ = cch.triclinic_cross_pair_histogram(
        torch.from_numpy(a).to(cuda_device),
        torch.from_numpy(b).to(cuda_device), box=box, r_max=4.0,
        n_cells_dim=plan["n_cells_dim"], capacity1=plan["capacity"],
        capacity2=plan["capacity2"], n_bins=16,
    )
    np.testing.assert_array_equal(
        cross_counts[0].cpu().numpy(),
        f64_triclinic_pair_histogram(a, b, box, 4.0, 16),
    )


@pytest.mark.cuda
def test_triclinic_kernels_large_capacity_and_shrunken_box(cuda_device):
    """Capacities above 48 KB of shared memory take the opt-in launch
    path; a frame whose c-vector shrank comes back NaN."""

    rng = np.random.default_rng(53)
    frames, box = _triclinic_frames(rng, "dodeca", 2, 3000)
    bad = box.copy()
    bad[2] *= np.float32(0.5)
    boxes = torch.from_numpy(np.stack([box, bad]))
    f = torch.from_numpy(frames).to(cuda_device)
    grid = dict(box=boxes, r_max=4.0, n_cells_dim=(3, 3, 3), n_bins=64)
    kernel, _ = cch.triclinic_cell_pair_histogram(f, capacity=1600, **grid)
    plain, _ = cch.triclinic_cell_pair_histogram_reference(
        f, capacity=1600, **grid)
    cross, _, _ = cch.triclinic_cross_pair_histogram(
        f, f.flip(1), capacity1=1600, capacity2=1600, exclusion=(1, 1),
        **grid)
    cross_plain, _, _ = cch.triclinic_cross_pair_histogram_reference(
        f, f.flip(1), capacity1=1600, capacity2=1600, exclusion=(1, 1),
        **grid)
    torch.cuda.synchronize()
    for k, p in ((kernel, plain), (cross, cross_plain)):
        assert torch.isnan(k[1]).all()
        torch.testing.assert_close(k[0], p[0], rtol=0, atol=0)


@pytest.mark.cuda
def test_triclinic_paths_on_the_card_equal_cpu(cuda_device):
    """The triclinic RDF (self and cross) and Van Hove give the same
    counts on the card as on the CPU (plain versions)."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        VanHoveFunction,
    )
    from mdhelper_tpu_torch.core.universe import Universe

    traj, _ = _triclinic_frames(np.random.default_rng(54), "dodeca", 5, 900)
    u = Universe.from_arrays(traj, TRICLINIC["dodeca"])
    results = []
    for device in ("cpu", cuda_device):
        kw = dict(n_bins=32, range=(0.0, 4.0), verbose=False, device=device)
        vh = VanHoveFunction(u.atoms, lags="log", **kw).run()
        rdf = RadialDistributionFunction(u.atoms, exclusion=(1, 1),
                                         **kw).run()
        cross = RadialDistributionFunction(u.atoms[0::2], u.atoms[1::2],
                                           exclusion=(2, 3), **kw).run()
        results.append((vh.results.counts_self, vh.results.counts_distinct,
                        rdf.results.counts, cross.results.counts))
    for cpu, card in zip(*results):
        np.testing.assert_array_equal(cpu, card)


# -- generalized grids (boxes under 3 cutoffs) and tri_pp -------------------

#: a cube of 16 under r_max 6 (2.67 cutoffs) and the small dodecahedron
#: above under r_max 6 (perpendicular widths 14.70, 14.70, 12.73).
SMALL_R, SMALL_BINS = 6.0, 24


def _ortho_small_plan(grid, n1, n2=None, box=(BOX,) * 3, r_max=SMALL_R):
    return cch.grid_plan(n1, box, r_max, grid, n_atoms2=n2)


def _self_args(plan, box, r_max=SMALL_R, n_bins=SMALL_BINS, capacity=None):
    return dict(box=box, r_max=r_max, n_cells_dim=plan["n_cells_dim"],
                reach=plan["reach"], capacity=capacity or plan["capacity"],
                n_bins=n_bins)


def _cross_args(plan, box, r_max=SMALL_R, n_bins=SMALL_BINS, capacity=None,
                exclusion=None):
    """Cross-kernel arguments of `plan`; `capacity` overrides both
    capacities (a self plan then serves a cross sweep)."""

    return dict(box=box, r_max=r_max, n_cells_dim=plan["n_cells_dim"],
                reach=plan["reach"],
                capacity1=capacity or plan["capacity"],
                capacity2=capacity or plan["capacity2"], n_bins=n_bins,
                exclusion=exclusion)


def _assert_kernel_equals_plain(kernel, plain):
    for k, p in zip(kernel, plain):
        torch.testing.assert_close(k, p, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("grid, mode", [
    ((5, 5, 5), "general"), ((1, 2, 6), "ordered"),
])
def test_generalized_self_kernel_straddle(cuda_device, grid, mode):
    """Generalized half-shell and ordered self kernels on the straddle
    fixture in a box 2.67 cutoffs wide: equal to the plain version and
    to the float64 oracle as integers."""

    pos = edge_straddle_positions(np.random.default_rng(99), BOX)
    plan = _ortho_small_plan(grid, len(pos))
    assert cch._sweep_mode(grid, plan["reach"], False, False) == mode
    args = _self_args(plan, (BOX,) * 3)
    f = torch.from_numpy(pos).to(cuda_device)
    before = cch.cell_pair_histogram.mode_launches[mode]
    kernel = cch.cell_pair_histogram(f, **args)
    torch.cuda.synchronize()
    assert cch.cell_pair_histogram.mode_launches[mode] == before + 1
    _assert_kernel_equals_plain(kernel,
                                cch.cell_pair_histogram_reference(f, **args))
    np.testing.assert_array_equal(
        kernel[0][0].cpu().numpy(),
        f64_pair_histogram(pos, BOX, SMALL_R, SMALL_BINS),
    )


@pytest.mark.cuda
def test_generalized_cross_kernel_straddle(cuda_device):
    a, b = edge_straddle_cross_positions(np.random.default_rng(99), BOX)
    plan = _ortho_small_plan((2, 5, 6), len(a), len(b))
    args = _cross_args(plan, (BOX,) * 3)
    fa = torch.from_numpy(a).to(cuda_device)
    fb = torch.from_numpy(b).to(cuda_device)
    before = cch.cross_pair_histogram.mode_launches["general"]
    kernel = cch.cross_pair_histogram(fa, fb, **args)
    torch.cuda.synchronize()
    assert cch.cross_pair_histogram.mode_launches["general"] == before + 1
    _assert_kernel_equals_plain(
        kernel, cch.cross_pair_histogram_reference(fa, fb, **args))
    np.testing.assert_array_equal(
        kernel[0][0].cpu().numpy(),
        f64_cross_histogram(a, b, BOX, SMALL_R, SMALL_BINS),
    )


#: (box lengths, r_max, grid) of generalized grids with an axis that the
#: sweep does not span whole, so a shrunk frame must poison: a half-shell
#: grid of reach 2 along z and an ordered grid (its first axis is 1
#: cell).  Few cells, so that the plain versions stay quick at a
#: capacity of 1,600 slots.
POISON_GRIDS = {
    "general": ((40.0,) * 3, SMALL_R, (3, 3, 10)),
    "ordered": ((BOX, BOX, 40.0), SMALL_R, (1, 2, 10)),
}


def _shrunk_frames(rng, lengths, n_atoms):
    """Two frames of uniform atoms: one in `lengths`, one in the box
    shrunk to 0.7 of it; the (2, 3) boxes."""

    lengths = np.float32(lengths)
    pos = (rng.random((2, n_atoms, 3)) * lengths).astype(np.float32)
    pos[1] *= np.float32(0.7)
    return pos, torch.from_numpy(np.stack([lengths, lengths * 0.7]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["general", "ordered"])
def test_generalized_kernels_large_capacity_and_shrunken_box(cuda_device,
                                                              mode):
    """Generalized self and cross kernels at a capacity above 48 KB of
    shared memory, on a frame whose box shrank below the grid (NaN)."""

    lengths, r_max, grid = POISON_GRIDS[mode]
    pos, boxes = _shrunk_frames(np.random.default_rng(61), lengths, 3000)
    plan = cch.grid_plan(3000, lengths, r_max, grid)
    assert cch._sweep_mode(grid, plan["reach"], False, False) == mode
    f = torch.from_numpy(pos).to(cuda_device)
    args = _self_args(plan, boxes, r_max, 64, capacity=1600)
    kernel = cch.cell_pair_histogram(f, **args)
    plain = cch.cell_pair_histogram_reference(f, **args)
    cross_args = _cross_args(plan, boxes, r_max, 64,
                             capacity=1600, exclusion=(1, 1))
    cross = cch.cross_pair_histogram(f, f.flip(1), **cross_args)
    cross_plain = cch.cross_pair_histogram_reference(f, f.flip(1),
                                                     **cross_args)
    torch.cuda.synchronize()
    for k, p in ((kernel, plain), (cross, cross_plain)):
        assert torch.isnan(k[0][1]).all() and k[0][0].sum() > 0
        _assert_kernel_equals_plain(k, p)


@pytest.mark.cuda
def test_tri_pp_kernels_straddle(cuda_device):
    """tri_pp self and cross kernels on the triclinic straddle fixture,
    widths under 3 cutoffs: equal to the plain versions and to the
    float64 27-image oracle."""

    from mdhelper_tpu_torch.testing import (
        edge_straddle_triclinic_positions,
        f64_triclinic_pair_histogram,
    )

    _, box = _triclinic_frames(np.random.default_rng(0), "dodeca", 1, 1)
    widths = cch.triclinic_perpendicular_widths(box).astype(np.float64)
    pos = edge_straddle_triclinic_positions(np.random.default_rng(99), box)
    f = torch.from_numpy(pos).to(cuda_device)
    plan = cch.grid_plan(len(pos), widths, SMALL_R, (2, 5, 6))
    assert cch.plan_is_tri_pp(plan, True)
    args = _self_args(plan, box)
    before = cch.triclinic_cell_pair_histogram.mode_launches["tri_pp"]
    kernel = cch.triclinic_cell_pair_histogram(f, **args)
    torch.cuda.synchronize()
    assert (cch.triclinic_cell_pair_histogram.mode_launches["tri_pp"]
            == before + 1)
    _assert_kernel_equals_plain(
        kernel, cch.triclinic_cell_pair_histogram_reference(f, **args))
    np.testing.assert_array_equal(
        kernel[0][0].cpu().numpy(),
        f64_triclinic_pair_histogram(pos, pos, box, SMALL_R, SMALL_BINS,
                                     (1, 1)),
    )
    plan = cch.grid_plan(300, widths, SMALL_R, (2, 5, 6), n_atoms2=90)
    args = _cross_args(plan, box)
    a, b = f[:300], f[300:]
    kernel = cch.triclinic_cross_pair_histogram(a, b, **args)
    _assert_kernel_equals_plain(
        kernel, cch.triclinic_cross_pair_histogram_reference(a, b, **args))
    np.testing.assert_array_equal(
        kernel[0][0].cpu().numpy(),
        f64_triclinic_pair_histogram(pos[:300], pos[300:], box, SMALL_R,
                                     SMALL_BINS),
    )


@pytest.mark.cuda
def test_tri_pp_kernels_large_capacity_and_shrunken_box(cuda_device):
    """tri_pp self and cross kernels at a capacity above 48 KB, on a
    frame whose c-vector shrank below the grid (NaN): a reach-1 grid of
    one cell on a and b and 4 on c, swept ring by ring along c."""

    frames, box = _triclinic_frames(np.random.default_rng(62), "dodeca", 2,
                                    3000)
    bad = box.copy()
    bad[2] *= np.float32(0.5)
    boxes = torch.from_numpy(np.stack([box, bad]))
    widths = cch.triclinic_perpendicular_widths(box).astype(np.float64)
    plan = cch.grid_plan(3000, widths, 3.0, (1, 1, 4))
    assert plan["reach"] == (1, 1, 1) and cch.plan_is_tri_pp(plan, True)
    f = torch.from_numpy(frames).to(cuda_device)
    args = _self_args(plan, boxes, 3.0, 64, capacity=1600)
    kernel = cch.triclinic_cell_pair_histogram(f, **args)
    plain = cch.triclinic_cell_pair_histogram_reference(f, **args)
    cross_args = _cross_args(plan, boxes, 3.0, 64,
                             capacity=1600, exclusion=(1, 1))
    cross = cch.triclinic_cross_pair_histogram(f, f.flip(1), **cross_args)
    cross_plain = cch.triclinic_cross_pair_histogram_reference(
        f, f.flip(1), **cross_args)
    torch.cuda.synchronize()
    for k, p in ((kernel, plain), (cross, cross_plain)):
        assert torch.isnan(k[0][1]).all() and k[0][0].sum() > 0
        _assert_kernel_equals_plain(k, p)


@pytest.mark.cuda
def test_small_box_paths_on_the_card_equal_cpu(cuda_device):
    """The RDF (self and cross) and Van Hove in a cube and a
    dodecahedron under 3 cutoffs give the same counts on the card as on
    the CPU (plain versions)."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        VanHoveFunction,
    )
    from mdhelper_tpu_torch.core.universe import Universe

    rng = np.random.default_rng(63)
    cube = (rng.random((4, 400, 3)) * 12.0).astype(np.float32)
    dodeca, _ = _triclinic_frames(rng, "dodeca", 4, 400)
    for traj, dims in ((cube, np.array([12.0] * 3)),
                       (dodeca, TRICLINIC["dodeca"])):
        u = Universe.from_arrays(traj, dims)
        results = []
        for device in ("cpu", cuda_device):
            kw = dict(n_bins=32, range=(0.0, 5.0), verbose=False,
                      device=device)
            vh = VanHoveFunction(u.atoms, lags="log", **kw).run()
            rdf = RadialDistributionFunction(u.atoms, **kw).run()
            cross = RadialDistributionFunction(
                u.atoms[0::2], u.atoms[1::2], exclusion=(2, 3), **kw
            ).run()
            plan = cross._searched_cell_plan()
            assert cch._generalized(plan["n_cells_dim"], plan["reach"])
            results.append((vh.results.counts_self,
                            vh.results.counts_distinct, rdf.results.counts,
                            cross.results.counts))
        for cpu, card in zip(*results):
            np.testing.assert_array_equal(cpu, card)


# -- slice 5: offset bins, 2-D grids, self tiles, fast binning -----------------

#: (geometry, grid, (r_min, r_max, n_bins), exclusion, precision, cross,
#: the option counter the launch adds to): every new mode on the card.
MODE_CASES = {
    "tiles_33_half": ("cube", (3, 3, 3), (0.0, 4.0, 32), (3, 3), "exact",
                      False, "tiles"),
    "asym_23_half": ("cube", (3, 3, 3), (0.0, 4.0, 32), (2, 3), "exact",
                     False, "asym"),
    "asym_32_ordered": ("cube", (1, 2, 6), (0.0, 6.0, 24), (3, 2), "exact",
                        False, "asym"),
    "offset_self": ("cube", (3, 3, 3), (1.25, 4.0, 22), None, "exact",
                    False, "offset"),
    "offset_cross": ("cube", (2, 5, 6), (0.5, 1.25, 12), (2, 3), "exact",
                     True, "offset"),
    "axes2_self": ("slab", (4, 4), (0.0, 4.0, 16), (3, 3), "exact", False,
                   "2d"),
    "axes2_cross": ("slab", (5, 5), (0.5, 1.25, 12), None, "exact", True,
                    "2d"),
    "fast_self": ("cube", (5, 5, 5), (1.25, 6.0, 19), None, "fast", False,
                  "fast"),
    "tri_block_asym": ("tri", (3, 3, 3), (1.25, 4.0, 11), (2, 3), "exact",
                       False, "asym"),
    "tri_block_fast": ("tri", (3, 3, 3), (0.0, 4.0, 16), None, "fast", True,
                       "fast"),
    "tri_pp_tiles_fast": ("tri", (1, 2, 4), (0.5, 1.25, 12), (3, 3), "fast",
                          False, "fast"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MODE_CASES))
def test_new_modes_kernel_equals_reference(cuda_device, case):
    """Each new mode's kernel equals its plain version as integers on the
    straddle fixtures (a 2-D grid's with redrawn dropped coordinates),
    and its launch adds one to the option's counter."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.testing import edge_straddle_triclinic_positions

    geometry, grid, (r_min, r_max, n_bins), ex, precision, cross, option = (
        MODE_CASES[case])
    rng = np.random.default_rng(99)
    tri = geometry == "tri"
    if tri:
        box = triclinic_matrices(TRICLINIC["dodeca"]).astype(np.float32)
        pos = edge_straddle_triclinic_positions(rng, box)
        extents = cch.triclinic_perpendicular_widths(box).astype(float)
    else:
        pos = edge_straddle_positions(rng, BOX)
        box = np.float32([BOX, BOX, 4.0 if geometry == "slab" else BOX])
        pos[:, 2] = (rng.random(len(pos)) * box[2]).astype(np.float32)
        extents = box.astype(float)[:len(grid)]
    groups = (pos[:300], pos[300:]) if cross else (pos,)
    plan = cch.grid_plan(len(groups[0]), extents, r_max, grid,
                         n_atoms2=len(groups[-1]) if cross else None)
    args = dict(box=box, r_max=r_max, r_min=r_min, n_cells_dim=grid,
                reach=plan["reach"], n_bins=n_bins, exclusion=ex,
                precision=precision)
    if len(grid) == 2:
        args["axes"] = (0, 1)
    frames = [torch.from_numpy(g).to(cuda_device)[None] for g in groups]
    if cross:
        kernel_fn = (cch.triclinic_cross_pair_histogram if tri
                     else cch.cross_pair_histogram)
        plain_fn = (cch.triclinic_cross_pair_histogram_reference if tri
                    else cch.cross_pair_histogram_reference)
        args.update(capacity1=plan["capacity"], capacity2=plan["capacity2"])
    else:
        kernel_fn = (cch.triclinic_cell_pair_histogram if tri
                     else cch.cell_pair_histogram)
        plain_fn = (cch.triclinic_cell_pair_histogram_reference if tri
                    else cch.cell_pair_histogram_reference)
        args["capacity"] = plan["capacity"]
    before = kernel_fn.option_launches[option]
    kernel = kernel_fn(*frames, **args)
    torch.cuda.synchronize()
    assert kernel_fn.option_launches[option] == before + 1
    plain = plain_fn(*frames, **args)
    for k, p in zip(kernel, plain):
        torch.testing.assert_close(k, p, rtol=0, atol=0)
    assert kernel[0].sum() > 0


@pytest.mark.cuda
def test_new_options_on_the_card_equal_cpu(cuda_device):
    """The RDF with an asymmetric tile, an offset range and a 2-D grid,
    and the Van Hove function on an offset range, give the same counts
    on the card as on the CPU (plain versions)."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        VanHoveFunction,
    )
    from mdhelper_tpu_torch.core.universe import Universe

    rng = np.random.default_rng(13)
    traj = (rng.random((4, 1200, 3))
            * np.float32([BOX, BOX, 6.0])).astype(np.float32)
    u = Universe.from_arrays(traj, np.array([BOX, BOX, 6.0]))
    results = []
    for device in ("cpu", cuda_device):
        kw = dict(n_bins=32, verbose=False, device=device)
        runs = [
            RadialDistributionFunction(u.atoms, range=(0.0, 4.0),
                                       exclusion=(2, 3), **kw),
            RadialDistributionFunction(u.atoms[0::2], u.atoms[1::2],
                                       range=(1.0, 4.0), drop_axis="z",
                                       **kw),
            RadialDistributionFunction(u.atoms, range=(0.5, 3.0),
                                       exclusion=(3, 3), **kw),
        ]
        counts = [r.run().results.counts for r in runs]
        vh = VanHoveFunction(u.atoms, range=(1.0, 4.0), lags="log",
                             **kw).run()
        results.append(counts + [vh.results.counts_self,
                                 vh.results.counts_distinct])
    for cpu, card in zip(*results):
        np.testing.assert_array_equal(cpu, card)


def _trig_oracle(qs, pos, w=None):
    """float64 (B, N_q) sums of frames `pos` and the mean amplitude."""

    phases = np.asarray(qs, np.float64) @ pos.astype(np.float64).transpose(
        0, 2, 1)
    w = 1.0 if w is None else w.astype(np.float64)
    oc = (np.cos(phases) * w).sum(-1)
    osn = (np.sin(phases) * w).sum(-1)
    return oc, osn, np.hypot(oc, osn).mean()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("case", ["float32_q", "weights", "float64_q"])
def test_trig_sums_kernel_equals_reference(cuda_device, precision, case):
    """The trig-sums kernel and its plain version each within the
    tolerances of tests/test_pallas.py of a float64 oracle (1e-4 of the
    mean amplitude fast, 1e-6 exact), on two frames with tails of both
    tiles; two launches give the same bits, and the exact sums are the
    plain version's bit for bit."""

    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(61)
    n, n_q = 5003, 301
    pos = (rng.random((2, n, 3)) * 30.0).astype(np.float32)
    qs = rng.random((n_q, 3)) * 4.0
    if case != "float64_q":
        qs = qs.astype(np.float32)
    w = ((rng.random(n) < 0.7).astype(np.float32) if case == "weights"
         else None)
    args = (torch.from_numpy(qs).to(cuda_device),
            torch.from_numpy(pos).to(cuda_device),
            None if w is None else torch.from_numpy(w).to(cuda_device))
    before = ck.trig_sums.launches
    kernel = ck.trig_sums(*args, precision=precision)
    again = ck.trig_sums(*args, precision=precision)
    torch.cuda.synchronize()
    assert ck.trig_sums.launches == before + 2
    plain = ck.trig_sums_reference(*args, precision=precision)
    oc, osn, amp = _trig_oracle(qs, pos, w)
    tol = (1e-4 if precision == "fast" else 1e-6) * amp
    for i, ref in ((0, oc), (1, osn)):
        assert kernel[i].shape == (2, n_q)
        torch.testing.assert_close(kernel[i], again[i], rtol=0, atol=0)
        assert np.abs(kernel[i].cpu().numpy() - ref).max() <= tol
        assert np.abs(plain[i].cpu().numpy() - ref).max() <= tol
        if precision == "exact":
            torch.testing.assert_close(kernel[i], plain[i], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("exclusion", [None, (1, 1), (4, 4), (2, 3), (3, 2)])
def test_pair_histogram_kernel_equals_reference(cuda_device, exclusion):
    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(62)
    for pos, box, r_max, n_bins in (
            ((rng.random((3001, 3)) * BOX).astype(np.float32), BOX, 5.0, 77),
            (edge_straddle_positions(rng, BOX), BOX, 4.0, 16)):
        p = torch.from_numpy(pos).to(cuda_device)
        before = ck.pair_histogram.launches
        kernel = ck.pair_histogram(p, (box,) * 3, r_max, n_bins,
                                   exclusion=exclusion)
        torch.cuda.synchronize()
        assert ck.pair_histogram.launches == before + 1
        plain = ck.pair_histogram_reference(p, (box,) * 3, r_max, n_bins,
                                            exclusion=exclusion)
        torch.testing.assert_close(kernel, plain, rtol=0, atol=0)
        if exclusion == (1, 1):
            plan = cch.cell_plan_search(len(pos), [box] * 3, r_max)
            cell, _ = cch.cell_pair_histogram(
                p, box=(box,) * 3, r_max=r_max,
                n_cells_dim=plan["n_cells_dim"], capacity=plan["capacity"],
                n_bins=n_bins, precision="fast")
            np.testing.assert_array_equal(
                kernel.cpu().numpy(), cell[0].cpu().numpy().astype(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("n_atoms", [1, 511, 512, 513, 1000, 1025])
@pytest.mark.parametrize("exclusion", [None, (2, 3), (3, 2)])
def test_pair_histogram_tile_edges_equal_reference(cuda_device, n_atoms,
                                                   exclusion):
    """Atom counts at the edges of the kernel's 512-atom tiles (one
    atom, a tile less one, one tile, one more, a count that is a multiple
    of neither, two tiles and one): integers equal to the plain
    version's, and under None each atom once in bin 0."""

    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(65)
    p = torch.from_numpy((rng.random((n_atoms, 3)) * 8.0).astype(
        np.float32)).to(cuda_device)
    kernel = ck.pair_histogram(p, (8.0,) * 3, 3.5, 40, exclusion=exclusion)
    plain = ck.pair_histogram_reference(p, (8.0,) * 3, 3.5, 40,
                                        exclusion=exclusion)
    torch.testing.assert_close(kernel, plain, rtol=0, atol=0)
    if exclusion is None:
        dropped = ck.pair_histogram(p, (8.0,) * 3, 3.5, 40, exclusion=(1, 1))
        assert int(kernel[0] - dropped[0]) == n_atoms
        torch.testing.assert_close(kernel[1:], dropped[1:], rtol=0, atol=0)


@pytest.mark.cuda
def test_pair_histogram_bins_near_shared_memory_limit(cuda_device):
    """The widest histogram the kernel's shared memory holds beside its
    staged tile: equal to the plain version; one bin more raises."""

    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    n_bins = (cch._SMEM_BYTES - ck._HIST_TILE * ck._HIST_SLOT_BYTES - 4) // 4
    rng = np.random.default_rng(66)
    p = torch.from_numpy((rng.random((1500, 3)) * BOX).astype(
        np.float32)).to(cuda_device)
    for exclusion in (None, (2, 3)):
        kernel = ck.pair_histogram(p, (BOX,) * 3, 6.0, n_bins,
                                   exclusion=exclusion)
        plain = ck.pair_histogram_reference(p, (BOX,) * 3, 6.0, n_bins,
                                            exclusion=exclusion)
        torch.testing.assert_close(kernel, plain, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ck.pair_histogram(p, (BOX,) * 3, 6.0, n_bins + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("exclusion", [None, (1, 1)])
def test_pair_histogram_unwrapped_positions_equal_reference(cuda_device,
                                                            exclusion):
    """Positions up to two boxes outside [0, L) on each axis (the wrapper
    does not wrap them): the kernel takes each pair's minimum image as
    its plain version does, to the same integers."""

    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(64)
    pos = (rng.random((2500, 3)) * BOX).astype(np.float32)
    shifts = rng.integers(-2, 3, size=pos.shape).astype(np.float32)
    loose = pos + shifts * np.float32(BOX)
    assert (loose < 0).any() and (loose >= 2 * BOX).any()
    p = torch.from_numpy(loose).to(cuda_device)
    kernel = ck.pair_histogram(p, (BOX,) * 3, 5.0, 77, exclusion=exclusion)
    plain = ck.pair_histogram_reference(p, (BOX,) * 3, 5.0, 77,
                                        exclusion=exclusion)
    torch.testing.assert_close(kernel, plain, rtol=0, atol=0)
    assert int(kernel.sum()) > 0

@pytest.mark.cuda
def test_direct_structure_factor_on_the_card_equals_cpu(cuda_device):
    """The direct, split and partial S(q) give the same results on the
    card (the trig-sums kernel) as on the CPU (its plain version), within
    the S(q) gate."""

    from mdhelper_tpu_torch.analysis.structure import StructureFactor
    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(63)
    n = 2000
    box = float(n / 0.8) ** (1 / 3)
    traj = (rng.random((4, n, 3)) * box).astype(np.float32)
    u = Universe.from_arrays(traj, np.array([box] * 3 + [90.0] * 3))
    results = []
    before = ck.trig_sums.launches
    for device in ("cpu", cuda_device):
        kw = dict(n_points=6, sort=False, unique=False, verbose=False,
                  device=device)
        runs = [
            StructureFactor(u.atoms, method="direct", **kw),
            StructureFactor(u.atoms, n_surfaces=2, **kw),
            StructureFactor([u.atoms[0::2], u.atoms[1::2]], mode="partial",
                            method="direct", **kw),
        ]
        results.append([r.run().results.ssf for r in runs])
    assert ck.trig_sums.launches >= before + 3
    for cpu, card in zip(*results):
        np.testing.assert_allclose(card, cpu, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_trig_sums_workspace_and_displacements_equal_reference(cuda_device):
    """Displacement frames anywhere in +-L (the incoherent ISF's lag
    launch): the kernel, with and without a shared workspace, equals
    itself bit for bit and its plain version within the fast tolerance of
    a float64 oracle."""

    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(64)
    n, n_q, box = 4100, 257, 30.0
    pos = ((rng.random((5, n, 3)) - rng.random((5, n, 3))) * box).astype(
        np.float32)
    qs = rng.random((n_q, 3)) * 4.0
    args = (torch.from_numpy(qs).to(cuda_device),
            torch.from_numpy(pos).to(cuda_device))
    workspace = ck.trig_workspace(8, n, n_q, cuda_device)
    own = ck.trig_sums(*args, precision="fast")
    shared = ck.trig_sums(*args, precision="fast", workspace=workspace)
    plain = ck.trig_sums_reference(*args, precision="fast")
    oc, osn, amp = _trig_oracle(qs, pos)
    for i, ref in ((0, oc), (1, osn)):
        torch.testing.assert_close(own[i], shared[i], rtol=0, atol=0)
        assert np.abs(own[i].cpu().numpy() - ref).max() <= 1e-4 * amp
        assert np.abs(plain[i].cpu().numpy() - ref).max() <= 1e-4 * amp
    with pytest.raises(ValueError, match="workspace"):
        ck.trig_sums(*args, workspace=workspace[:10])


@pytest.mark.cuda
@pytest.mark.parametrize("lags", [None, "log"])
def test_isf_on_the_card_equals_cpu(cuda_device, lags):
    """The direct-route ISF (coherent and incoherent lag ring, and the
    coherent time FFT) gives the same F(q, t) on the card (the trig-sums
    kernel) as on the CPU (its plain version), within the S(q) gate, with
    one coherent launch a chunk and one lag launch a frame."""

    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.analysis.structure import (
        IntermediateScatteringFunction,
    )
    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(65)
    n, n_frames, chunk = 2000, 12, 4
    box = float(n / 0.8) ** (1 / 3)
    walk = rng.random((n, 3)) * box + np.cumsum(
        rng.normal(0.0, 0.3, (n_frames, n, 3)), axis=0)
    traj = np.mod(walk, box).astype(np.float32)
    u = Universe.from_arrays(traj, np.array([box] * 3 + [90.0] * 3))
    results = []
    for device in ("cpu", cuda_device):
        kw = dict(n_points=6, n_lags=10, lags=lags, sort=False,
                  unique=False, method="direct", verbose=False,
                  device=device)
        ring = IntermediateScatteringFunction(u.atoms, incoherent=True, **kw)
        fft = IntermediateScatteringFunction(u.atoms, **kw)
        for a in (ring, fft):
            a._chunk_bytes = chunk * n * 3 * 4
        before = ck.trig_sums.launches
        split = dict(ck.trig_sums.launches_by_precision)
        run_together([ring])
        if device != "cpu":
            # 3 coherent launches (one a chunk), 12 lag launches.
            assert ck.trig_sums.launches == before + 3 + n_frames
            assert ck.trig_sums.launches_by_precision == {
                "exact": split["exact"] + 3, "fast": split["fast"] + n_frames}
        run_together([fft])
        results.append([ring.results.cisf, ring.results.iisf,
                        fft.results.cisf])
    for cpu, card in zip(*results):
        np.testing.assert_allclose(card, cpu, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(results[1][1][0], 1.0)


# -- the second design's edges: work-item and ring-tile boundaries ---------

#: atoms a cell holds, cycled over a grid's cells: empty, one, half a
#: home tile and one past it, a home tile of 64 slots and one past it, a
#: ring tile of 256 slots and one past it.
EDGE_COUNTS = (0, 1, 32, 33, 64, 65, 256, 257, 3)


def _edge_frames(grid, h, counts=EDGE_COUNTS, seed=5):
    """One float32 frame whose cells hold `counts` atoms in turn, at
    uniform positions inside each cell of the fractional grid `grid` of
    the box matrix `h` (a diagonal one for an orthorhombic box), and the
    capacity that holds the fullest cell."""

    rng = np.random.default_rng(seed)
    dims = np.array(grid, float)
    frac = []
    for c, cell in enumerate(np.ndindex(*grid)):
        k = counts[c % len(counts)]
        frac.append((np.array(cell) + 0.02 + 0.96 * rng.random((k, len(grid))))
                    / dims)
    frac = np.concatenate(frac)
    if len(grid) == 2:
        frac = np.concatenate([frac, rng.random((len(frac), 1))], axis=1)
    pos = (frac @ h).astype(np.float32)
    return pos[None], 32 * -(-max(counts) // 32)


#: (geometry, grid, r_max, exclusion, cross) of each edge case; every
#: sweep mode and geometry, with the asymmetric tiles' side-id ring.
EDGE_CASES = {
    "half": ("cube", (3, 3, 3), 4.0, None, False),
    "half_asym": ("cube", (3, 3, 3), 4.0, (2, 3), False),
    "ordered": ("cube", (1, 2, 4), 6.0, None, False),
    "ordered_asym": ("cube", (1, 2, 4), 6.0, (3, 2), False),
    "2d": ("slab", (3, 3), 4.0, None, False),
    "block": ("tri", (3, 3, 3), 4.0, (3, 3), False),
    "tri_pp": ("tri", (1, 2, 4), 5.0, None, False),
    "cross": ("cube", (3, 3, 3), 4.0, (2, 3), True),
    "cross_general": ("cube", (2, 3, 5), 5.0, None, True),
    "cross_2d": ("slab", (3, 3), 4.0, None, True),
    "cross_block": ("tri", (3, 3, 3), 4.0, None, True),
    "cross_tri_pp": ("tri", (1, 2, 4), 5.0, (1, 1), True),
}


def _edge_call(case, cuda_device, n_bins=24, counts=EDGE_COUNTS):
    """The kernel's and the plain version's outputs of an edge case."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices

    geometry, grid, r_max, ex, cross = EDGE_CASES[case]
    if geometry == "tri":
        h = triclinic_matrices(TRICLINIC["dodeca"]).astype(np.float32)
        box, extents = h, cch.triclinic_perpendicular_widths(h)
    else:
        box = np.float32([BOX, BOX, 4.0 if geometry == "slab" else BOX])
        h, extents = np.diag(box), box[:len(grid)]
    pos, capacity = _edge_frames(grid, h.astype(np.float64), counts)
    plan = cch.grid_plan(pos.shape[1], np.asarray(extents, float), r_max,
                         grid)
    args = dict(box=box, r_max=r_max, n_cells_dim=grid, reach=plan["reach"],
                n_bins=n_bins, exclusion=ex)
    if len(grid) == 2:
        args["axes"] = (0, 1)
    tri = geometry == "tri"
    frames = torch.from_numpy(pos).to(cuda_device)
    if cross:
        groups = (frames[:, 0::2].contiguous(), frames[:, 1::2].contiguous())
        args.update(capacity1=capacity, capacity2=capacity)
        kernel_fn = (cch.triclinic_cross_pair_histogram if tri
                     else cch.cross_pair_histogram)
        plain_fn = (cch.triclinic_cross_pair_histogram_reference if tri
                    else cch.cross_pair_histogram_reference)
    else:
        groups = (frames,)
        args["capacity"] = capacity
        kernel_fn = (cch.triclinic_cell_pair_histogram if tri
                     else cch.cell_pair_histogram)
        plain_fn = (cch.triclinic_cell_pair_histogram_reference if tri
                    else cch.cell_pair_histogram_reference)
    before = kernel_fn.launches
    kernel = kernel_fn(*groups, **args)
    torch.cuda.synchronize()
    assert kernel_fn.launches == before + 1
    return kernel, plain_fn(*groups, **args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_sweep_edges_kernel_equals_reference(cuda_device, case):
    """Cells of 0, 1, 32, 33, 64, 65, 256 and 257 atoms (around the home
    tile and the ring tile, and one past each) in every geometry and
    sweep: the kernel equals its plain version as integers."""

    kernel, plain = _edge_call(case, cuda_device)
    _assert_kernel_equals_plain(kernel, plain)
    assert kernel[0].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins", [1, 57_856])
@pytest.mark.parametrize("case", ["half", "cross", "tri_pp"])
def test_sweep_bins_extremes_equal_reference(cuda_device, case, n_bins):
    """One bin, and 57,856 bins at capacity 32 (the widest histogram the
    first design could launch there: too wide for a shared copy beside
    the ring, so it counts in global memory)."""

    kernel, plain = _edge_call(case, cuda_device, n_bins=n_bins,
                               counts=(0, 1, 7, 32, 19))
    _assert_kernel_equals_plain(kernel, plain)
    assert kernel[0].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cross", [False, True])
def test_sweep_capacity_ceiling_equals_reference(cuda_device, cross):
    """A cell at the planner's 4,096-slot ceiling (one cell, 4,000
    atoms): 63 home tiles of 64 slots, 16 ring tiles a neighbour."""

    rng = np.random.default_rng(8)
    pos = torch.from_numpy(
        (rng.random((1, 4000, 3)) * BOX).astype(np.float32)).to(cuda_device)
    plan = cch.grid_plan(4000, np.array([BOX] * 3), 3.0, (1, 1, 1))
    args = dict(box=(BOX,) * 3, r_max=3.0, n_cells_dim=(1, 1, 1),
                reach=plan["reach"], n_bins=12)
    if cross:
        groups = (pos[:, :2000].contiguous(), pos[:, 2000:].contiguous())
        args.update(capacity1=4096, capacity2=4096, exclusion=(5, 5))
        kernel = cch.cross_pair_histogram(*groups, **args)
        plain = cch.cross_pair_histogram_reference(*groups, **args)
    else:
        args.update(capacity=4096)
        kernel = cch.cell_pair_histogram(pos, **args)
        plain = cch.cell_pair_histogram_reference(pos, **args)
    torch.cuda.synchronize()
    _assert_kernel_equals_plain(kernel, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["orthorhombic", "triclinic"])
def test_overlapping_cross_rdf_on_the_card_equals_cpu(cuda_device, shape):
    """The cross RDF of groups [0, 800) and [400, 1200) of 1,200 atoms
    gives the same counts and g(r) on the card as on the CPU (whose
    counts tests/test_torch_overlap.py holds against the JAX class)."""

    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
    )
    from mdhelper_tpu_torch.core.universe import Universe

    dims6 = (np.array([14.0] * 3 + [90.0] * 3) if shape == "orthorhombic"
             else np.array([18.0] * 3 + [60.0, 60.0, 90.0]))
    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices

    rng = np.random.default_rng(1200)
    traj = (rng.random((2, 1200, 3)) @ triclinic_matrices(dims6)).astype(
        np.float32)
    u = Universe.from_arrays(traj, dims6, dt=1.0)
    results = []
    for device in ("cpu", cuda_device):
        for exclusion, range_ in ((None, (0.0, 3.0)), ((2, 2), (0.5, 3.0))):
            rdf = RadialDistributionFunction(
                u.atoms[0:800], u.atoms[400:1200], n_bins=30, range=range_,
                exclusion=exclusion, verbose=False, device=device)
            results.append(rdf.run().results)
    for cpu, card in zip(results[:2], results[2:]):
        np.testing.assert_array_equal(card.counts, cpu.counts)
        np.testing.assert_array_equal(card.rdf, cpu.rdf)
    assert results[2].counts[0] >= 800


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["orthorhombic", "triclinic"])
def test_npt_paths_on_the_card_equal_cpu(cuda_device, shape):
    """Per-frame boxes growing by 5 %: the self RDF (exclusion None and
    (1, 1)) and the Van Hove counts on the card equal the CPU's (which
    tests/test_torch_npt.py holds against the JAX classes); a shrinking
    box raises on the card too."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        VanHoveFunction,
    )
    from mdhelper_tpu_torch.core.universe import Universe

    dims6 = (np.array([14.0] * 3 + [90.0] * 3) if shape == "orthorhombic"
             else np.array([18.0] * 3 + [60.0, 60.0, 90.0]))
    rng = np.random.default_rng(77)

    def trajectory(growth):
        frac = np.mod(rng.random((400, 3)) + np.cumsum(
            rng.normal(0.0, 0.02, (4, 400, 3)), axis=0), 1.0)
        dims = np.repeat(dims6[None], 4, axis=0)
        dims[:, :3] *= (1.0 + growth * np.arange(4) / 3)[:, None]
        traj = np.einsum("fnk,fkj->fnj", frac, triclinic_matrices(dims))
        return Universe.from_arrays(traj.astype(np.float32), dims, dt=1.0)

    u = trajectory(0.05)
    results = []
    for device in ("cpu", cuda_device):
        kw = dict(n_bins=24, range=(0.0, 3.0), verbose=False, device=device)
        runs = [RadialDistributionFunction(u.atoms, exclusion=ex, **kw)
                for ex in (None, (1, 1))]
        runs.append(VanHoveFunction(u.atoms, **kw))
        results.append([r.run().results for r in runs])
    for cpu, card in zip(*results):
        for key in ("counts", "counts_self", "counts_distinct"):
            if hasattr(cpu, key):
                np.testing.assert_array_equal(getattr(card, key),
                                              getattr(cpu, key))
    shrunk = trajectory(-0.25)
    with pytest.raises(RuntimeError, match="shrank"):
        RadialDistributionFunction(shrunk.atoms, n_bins=24, range=(0.0, 3.0),
                                   verbose=False, device=cuda_device).run()


def _water_universe(n_mol=1500, box=24.0, n_frames=6, **topology):
    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.testing import water_system

    frames, top = water_system(np.random.default_rng(91), n_mol, box,
                               n_frames)
    top.update(topology)
    return Universe.from_arrays(frames, np.array([box] * 3 + [90.0] * 3),
                                dt=1.0, **top)


@pytest.mark.cuda
@pytest.mark.parametrize("grouping", ["residues", "segments"])
def test_com_reduction_on_the_card_equals_cpu_bits(cuda_device, grouping):
    """The fixed-order center-of-mass reduction gives the CPU's bits on
    the card, whole and on a shuffled partial group (tests of the CPU
    against the JAX package: tests/test_torch_groupings.py)."""

    from mdhelper_tpu_torch.analysis.structure import _com_reducer

    u = _water_universe(segindices=np.arange(4500) % 3)
    rng = np.random.default_rng(4)
    for group in (u.atoms, u.atoms[rng.permutation(4500)[:3000]]):
        frames = torch.from_numpy(
            u.trajectory.read_frames(np.arange(6))[0][:, group.ix])
        cpu, _ = _com_reducer(group, grouping, "cpu")
        card, _ = _com_reducer(group, grouping, cuda_device)
        expected = cpu(frames).numpy()
        got = card(frames.to(cuda_device)).cpu().numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      expected.view(np.int32))


@pytest.mark.cuda
def test_grouped_analyses_on_the_card_equal_cpu(cuda_device):
    """The RDF (self and mixed), Van Hove, S(q) and ISF of residue centers
    and the bonded Onsager MSD on the card against the CPU runs: integer
    counts equal, S(q) and the ISF within the S(q) gate, the MSD (of the
    same float32 centers) within rtol 1e-8 of the CPU's float64 FFTs."""

    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.analysis.structure import (
        IntermediateScatteringFunction,
        RadialDistributionFunction,
        StructureFactor,
        VanHoveFunction,
    )
    from mdhelper_tpu_torch.analysis.transport import Onsager

    u = _water_universe()
    results = []
    for device in ("cpu", cuda_device):
        kw = dict(verbose=False, device=device)
        runs = [
            RadialDistributionFunction(u.atoms, n_bins=60, range=(0.0, 6.0),
                                       exclusion=(1, 1),
                                       groupings="residues", **kw),
            RadialDistributionFunction(u.atoms, n_bins=60, range=(0.0, 6.0),
                                       groupings=("residues", "atoms"), **kw),
            VanHoveFunction(u.atoms, n_bins=60, range=(0.0, 6.0),
                            grouping="residues", n_lags=4, **kw),
            StructureFactor(u.atoms, "residues", n_points=6,
                            method="direct", **kw),
            IntermediateScatteringFunction(u.atoms, "residues", n_points=6,
                                           n_lags=4, incoherent=True,
                                           method="direct", **kw),
            Onsager(u.atoms, "residues", unwrap=True, **kw),
        ]
        results.append([a.results for a in run_together(runs)])
    cpu, card = results
    for i in range(3):
        for key in ("counts", "counts_self", "counts_distinct"):
            if key in cpu[i]:
                np.testing.assert_array_equal(card[i][key], cpu[i][key])
    np.testing.assert_allclose(card[3].ssf, cpu[3].ssf, rtol=1e-4, atol=1e-5)
    for key in ("cisf", "iisf"):
        np.testing.assert_allclose(card[4][key], cpu[4][key], rtol=1e-4,
                                   atol=1e-5)
    for key in ("msd_self", "msd_cross"):
        np.testing.assert_allclose(card[5][key], cpu[5][key], rtol=1e-8,
                                   atol=1e-9 * np.abs(cpu[5][key]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("exclusion", [None, (1, 1), (2, 3)])
def test_radial_histogram_on_the_card_equals_f64_oracle(cuda_device,
                                                        exclusion):
    """The module function ``radial_histogram`` on the card: one frame of
    2,000 ions against a numpy float64 histogram, as integers."""

    from mdhelper_tpu_torch.analysis.structure import radial_histogram
    from mdhelper_tpu_torch.testing import f64_cross_histogram

    rng = np.random.default_rng(41)
    pos = (rng.random((2000, 3)) * BOX).astype(np.float32)
    counts = radial_histogram(pos, pos, 120, (0.0, 6.0), [BOX] * 3,
                              exclusion=exclusion, device=cuda_device)
    np.testing.assert_array_equal(
        counts, f64_cross_histogram(pos, pos, BOX, 6.0, 120, exclusion))


@pytest.mark.cuda
def test_electrolyte_posthoc_on_the_card_equals_cpu(cuda_device):
    """The electrolyte path (cation-anion RDF, partial S(q), Onsager with
    unwrap and centering, by FFT and by the direct windows) on the card
    against the CPU: counts equal, S(q) and its recombinations within the
    S(q) gate, the MSDs and every linear-fit post-hoc result within rtol
    1e-8 (the same float32 streams; float64 centers and FFTs)."""

    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        StructureFactor,
    )
    from mdhelper_tpu_torch.analysis.transport import Onsager
    from mdhelper_tpu_torch.core.universe import Universe

    rng = np.random.default_rng(42)
    n, n_frames = 2000, 17
    walk = rng.random((n, 3)) * BOX + np.cumsum(
        rng.normal(0.0, 0.3, (n_frames, n, 3)), axis=0)
    frames = np.mod(walk, BOX).astype(np.float32)
    u = Universe.from_arrays(frames, np.array([BOX] * 3 + [90.0] * 3),
                             charges=np.tile([1.0, -1.0], n // 2))
    ions = [u.atoms[0::2], u.atoms[1::2]]
    results = []
    for device in ("cpu", cuda_device):
        kw = dict(verbose=False, device=device)
        rdf, sq, ons, shift = run_together([
            RadialDistributionFunction(*ions, n_bins=80, range=(0.0, 5.0),
                                       **kw),
            StructureFactor(ions, mode="partial", n_points=6, **kw),
            Onsager(ions, temperature=300, unwrap=True, center=True, **kw),
            Onsager(ions, unwrap=True, center=True, center_atom=True,
                    center_wrap=True, fft=False, **kw),
        ])
        rdf.calculate_coordination_numbers(n / 2 / BOX**3)
        rdf.calculate_pmf(300)
        out = dict(counts=rdf.results.counts, pmf=rdf.results.pmf,
                   ssf=sq.results.ssf,
                   charge_ssf=sq.calculate_charge_structure_factor())
        for name, o in (("fft", ons), ("shift", shift)):
            o.calculate_transport_coefficients(scale="linear")
            o.calculate_ionicity()
            o.calculate_electrophoretic_mobility()
            o.calculate_transference_number()
            for key in ("msd_self", "msd_cross", "D_i", "L_ij",
                        "conductivities", "ne_conductivities",
                        "electrophoretic_mobilities",
                        "transference_numbers"):
                out[f"{name}_{key}"] = np.asarray(o.results[key])
        results.append(out)
    cpu, card = results
    np.testing.assert_array_equal(card["counts"], cpu["counts"])
    np.testing.assert_array_equal(card["pmf"], cpu["pmf"])
    for key in ("ssf", "charge_ssf"):
        np.testing.assert_allclose(card[key], cpu[key], rtol=1e-4, atol=1e-5)
    for key, value in cpu.items():
        if key.startswith(("fft_", "shift_")):
            np.testing.assert_allclose(
                card[key], value, rtol=1e-8,
                atol=1e-9 * np.nanmax(np.abs(value), initial=0.0),
                err_msg=key)


def _files_universe(tmp_path, fmt):
    """A 3,000-atom float32 random walk written with the port's writers
    (GRO topology with names A and B, and an XTC or a DCD), opened with
    ``Universe.from_files``."""

    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.io import dcd, structure_writers, xtc

    rng = np.random.default_rng(43)
    n, n_frames = 3000, 13
    box = float(n / 0.8) ** (1 / 3)
    walk = rng.random((n, 3)) * box + np.cumsum(
        rng.normal(0.0, 0.4, (n_frames, n, 3)), axis=0)
    frames = np.mod(walk, box).astype(np.float32)
    dims = np.array([box] * 3 + [90.0] * 3)
    gro, traj = str(tmp_path / "top.gro"), str(tmp_path / f"traj.{fmt}")
    structure_writers.write_gro(
        gro, frames[0], names=np.where(np.arange(n) % 2, "B", "A"),
        dimensions=dims)
    if fmt == "xtc":
        xtc.write_xtc(traj, frames / 10,
                      np.tile(np.eye(3) * box / 10, (n_frames, 1, 1)))
    else:
        dcd.write_dcd(traj, frames, np.tile(dims, (n_frames, 1)))
    return Universe.from_files(gro, traj)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["xtc", "dcd"])
def test_files_slice_on_the_card_equals_cpu(cuda_device, tmp_path, fmt):
    """The fused RDF + S(q) + MSD slice from files on the card, with the
    prefetch on and off, against the CPU run: counts equal, S(q) within
    the S(q) gate, the MSD within rtol 1e-8; the cross RDF of the two
    name selections likewise."""

    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        StructureFactor,
    )
    from mdhelper_tpu_torch.analysis.transport import Onsager
    from mdhelper_tpu_torch.io import _xtc_native

    if fmt == "xtc":
        assert _xtc_native.load() is not None
    u = _files_universe(tmp_path, fmt)
    group = u.select_atoms("all")
    a, b = u.select_atoms("name A"), u.select_atoms("name B")
    results = []
    for device, prefetch in (("cpu", True), (cuda_device, True),
                             (cuda_device, False)):
        kw = dict(verbose=False, device=device)
        runs = [RadialDistributionFunction(group, n_bins=60,
                                           range=(0.0, 5.0),
                                           exclusion=(1, 1), **kw),
                StructureFactor(group, n_points=6, sort=False,
                                unique=False, method="factor", **kw),
                Onsager(group, unwrap=True, **kw),
                RadialDistributionFunction(a, b, n_bins=60,
                                           range=(0.0, 5.0), **kw)]
        for run in runs:
            run._chunk_bytes = 4 * 3000 * 3 * 4
            run._prefetch_batches = prefetch
        results.append([r.results for r in run_together(runs)])
    cpu = results[0]
    for card in results[1:]:
        for i in (0, 3):
            assert cpu[i].counts.sum() > 0
            np.testing.assert_array_equal(card[i].counts, cpu[i].counts)
        np.testing.assert_allclose(card[1].ssf, cpu[1].ssf, rtol=1e-4,
                                   atol=1e-5)
        for key in ("msd_self", "msd_cross"):
            np.testing.assert_allclose(card[2][key], cpu[2][key], rtol=1e-8,
                                       atol=1e-9 * np.abs(cpu[2][key]).max())
    for key in ("msd_self", "msd_cross"):
        np.testing.assert_array_equal(results[1][2][key], results[2][2][key])


@pytest.mark.cuda
def test_fast_bin_index_root_on_the_card_equals_ieee(cuda_device):
    """The plain fast binning's root on the card (float64, rounded) and
    torch's float32 sqrt there (IEEE) give the same indices as numpy's
    correctly rounded root, at every bin edge of a 57,856-bin range."""

    consts = cch._bin_boundary_constants(6.0, 57_856)
    edges = np.arange(1, 57_857) / np.float64(consts[1])
    centre = (edges * edges).astype(np.float32).view(np.int32)
    d2 = (centre[:, None] + np.arange(-4, 5, dtype=np.int32)).ravel().view(
        np.float32)
    idx = cch._fast_bin_index(
        torch.from_numpy(d2).to(cuda_device),
        cch._device_constants(consts, cuda_device), 57_856).cpu().numpy()
    root = np.sqrt(d2)
    np.testing.assert_array_equal(
        torch.sqrt(torch.from_numpy(d2).to(cuda_device)).cpu().numpy(), root)
    np.testing.assert_array_equal(
        idx, np.minimum(root * consts[1], np.float32(57_856)).astype(
            np.int32))


def _profile_system(n_mol=400, n_frames=9):
    """SPC/E waters of a 10 A cube stretched to a 10 x 12 x 14 A box."""

    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.testing import water_system

    box = np.array([10.0, 12.0, 14.0])
    frames, topology = water_system(np.random.default_rng(43), n_mol, 10.0,
                                    n_frames, step=0.7, charges=True)
    frames = np.mod(frames * (box / 10.0), box).astype(np.float32)
    return Universe.from_arrays(frames, np.concatenate([box, [90.0] * 3]),
                                **topology)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_profile_ops_on_the_card_equal_cpu(cuda_device, weighted):
    """The 1-, 2- and 3-D histograms on the card: counts equal the CPU's
    as integers, charge sums within rtol 1e-12 (float64 atomics add in
    another order)."""

    from mdhelper_tpu_torch.ops import profiles

    rng = np.random.default_rng(44)
    lengths = (12.0, 36.84, 49.99)
    coords = (rng.random((4, 5000, 3)) * 1.1 - 0.05) * np.array(lengths)
    coords = coords.astype(np.float32)
    coords[0, :5, 0] = np.nan
    edges = [profiles.linspace_edges_f32(length, n)
             for length, n in zip(lengths, (20, 192, 201))]
    mask = np.array([1.0, 1.0, 0.0, 1.0])
    weights = rng.normal(size=5000) if weighted else None

    def run(device):
        t = torch.from_numpy(coords).to(device)
        e = [torch.from_numpy(x).to(device) for x in edges]
        m = torch.from_numpy(mask).to(device)
        w = None if weights is None else torch.from_numpy(weights).to(device)
        return [
            profiles.axis_histogram_batch(t[..., 0], m, e[0], w),
            profiles.plane_histogram_batch(t[..., :2], m, e[0], e[1], w),
            profiles.volume_histogram_batch(t, m, *e, weights=w),
        ]

    for card, cpu in zip(run(cuda_device), run("cpu")):
        assert card.is_cuda
        if weighted:
            np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(),
                                       rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(card.cpu().numpy(), cpu.numpy())


@pytest.mark.cuda
def test_profiles_on_the_card_equal_cpu(cuda_device):
    """DensityProfile (atoms, residues, time-resolved, recentered),
    RadialDensityProfile (a fixed point, a COM center), DensityMap2D and
    DensityMap3D on the card: counts equal the CPU's; charge densities
    within rtol 1e-12."""

    from mdhelper_tpu_torch.analysis import profile

    u = _profile_system()
    cases = [
        (profile.DensityProfile, ([u.atoms[0::3], u.atoms[1::3]],),
         dict(n_bins=(20, 21, 22))),
        (profile.DensityProfile, (u.atoms,),
         dict(groupings="residues", axes="z", n_bins=40)),
        (profile.DensityProfile, ([u.atoms[0::3], u.atoms[1::3]],),
         dict(axes="y", n_bins=24, average=False)),
        (profile.DensityProfile, ([u.atoms[0::3], u.atoms[1::3]],),
         dict(axes="xz", n_bins=30, recenter=0)),
        (profile.RadialDensityProfile, ([u.atoms[0::3]], np.array(
            [5.0, 6.0, 7.0])), dict(n_bins=50, range=(0.0, 6.0))),
        (profile.RadialDensityProfile, ([u.atoms[1::3]], u.atoms[:9]),
         dict(n_bins=50, range=(0.0, 6.0), geometry="cylindrical",
              groupings="atoms")),
        (profile.DensityMap2D, (u.atoms,), dict(axes="xy", n_bins=32)),
        (profile.DensityMap3D, (u.atoms,),
         dict(n_bins=(8, 9, 10), groupings="residues")),
    ]
    for cls, args, kwargs in cases:
        results = []
        for device in (cuda_device, "cpu"):
            a = cls(*args, verbose=False, device=device, **kwargs)
            a._chunk_bytes = 2 * u.atoms.n_atoms * 3 * 4
            results.append(a.run().results)
        card, cpu = results
        for key in ("counts", "number_densities"):
            if cpu.get(key) is None:
                continue
            # A list per axis (DensityProfile) or one array.
            pairs = (zip(card[key], cpu[key]) if isinstance(cpu[key], list)
                     else [(card[key], cpu[key])])
            for x, y in pairs:
                np.testing.assert_array_equal(x, y)
        if cpu.charge_densities is not None:
            for x, y in zip(card.charge_densities, cpu.charge_densities):
                np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-15)


@pytest.mark.cuda
@pytest.mark.parametrize("options", [dict(unwrap=True),
                                     dict(neutralize=True),
                                     dict(average=True)])
def test_dipoles_on_the_card_equal_cpu(cuda_device, options):
    """DipoleMoment on the card: the float64 dipoles within rtol 1e-12 of
    the CPU's (the same float32 unwrapped positions, float64 sums in
    another order), the volumes equal."""

    from mdhelper_tpu_torch.analysis.electrostatics import DipoleMoment

    u = _profile_system()
    results = []
    for device in (cuda_device, "cpu"):
        a = DipoleMoment([u.atoms[:600], u.atoms[600:]], verbose=False,
                         device=device, **options)
        a._chunk_bytes = 2 * u.atoms.n_atoms * 3 * 4
        results.append(a.run().results)
    card, cpu = results
    np.testing.assert_allclose(card.dipoles, cpu.dipoles, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(card.volumes, cpu.volumes)


def _polymer_system(n_chains=40, n_monomers=20, n_frames=12, box=24.0):
    """Chains of testing.polymer_chains in a cube, with one segment a
    chain and backbone bonds, and the box and the largest |r| unwrapped."""

    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.testing import polymer_chains

    frames, unwrapped = polymer_chains(np.random.default_rng(45), n_chains,
                                       n_monomers, n_frames, box,
                                       stiffness=0.5, memory=0.8)
    first = np.arange(n_chains * n_monomers).reshape(n_chains, n_monomers)
    topology = dict(
        masses=np.tile(np.linspace(1.0, 2.0, n_monomers), n_chains),
        segindices=np.repeat(np.arange(n_chains), n_monomers),
        bonds=np.stack((first[:, :-1].ravel(), first[:, 1:].ravel()), 1))
    u = Universe.from_arrays(frames, [box] * 3 + [90.0] * 3, **topology)
    return u, max(box, float(np.abs(unwrapped).max()))


def _polymer_runs(make, u):
    """``make(device)`` run on the card and on the CPU, 4 frames a chunk."""

    out = []
    for device in ("cuda", "cpu"):
        a = make(device)
        a._chunk_bytes = 4 * u.atoms.n_atoms * 3 * 4
        out.append(a.run())
    return out


@pytest.mark.cuda
def test_polymer_trio_on_the_card_equals_cpu(cuda_device):
    """Gyradius (with shape), EndToEndVector and RouseModes on the card,
    unwrapped: the end-to-end vectors equal the CPU's (the same float32
    subtractions and unwrap), radii and Rouse amplitudes within 4 eps32
    max|r| (float32 sums in another order), b and c within 1e-3 A^2."""

    from mdhelper_tpu_torch.analysis import polymer

    u, r_max = _polymer_system()
    atol = 4 * float(np.finfo(np.float32).eps) * r_max
    card, cpu = _polymer_runs(lambda d: polymer.Gyradius(
        u.atoms, shape=True, unwrap=True, verbose=False, device=d), u)
    np.testing.assert_allclose(card.results.gyradii, cpu.results.gyradii,
                               rtol=0, atol=atol)
    for key in ("asphericity", "acylindricity"):
        np.testing.assert_allclose(card.results[key], cpu.results[key],
                                   rtol=0, atol=1e-3)
    card, cpu = _polymer_runs(lambda d: polymer.EndToEndVector(
        u.atoms, unwrap=True, n_blocks=2, verbose=False, device=d), u)
    np.testing.assert_array_equal(card._e2e, cpu._e2e)
    np.testing.assert_allclose(card.results.acf, cpu.results.acf, rtol=0,
                               atol=1e-12)
    card, cpu = _polymer_runs(lambda d: polymer.RouseModes(
        u.atoms, n_modes=8, verbose=False, device=d), u)
    for x, y in zip(card._amps, cpu._amps):
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("workspace_frames", [None, 7])
def test_single_chain_structure_factor_on_the_card(cuda_device,
                                                   workspace_frames,
                                                   monkeypatch):
    """The single-chain S(q) on the card goes through the trig-sums
    kernel, exact, one launch a block of chain-frames (7 a launch, or the
    default workspace's), and equals the CPU's plain sums within 1e-6 of
    its largest value (the card's and the CPU's float32 cosines)."""

    from mdhelper_tpu_torch.analysis import polymer
    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    u, _ = _polymer_system()
    n_q = 4**3
    if workspace_frames:
        monkeypatch.setattr(polymer.SingleChainStructureFactor,
                            "_workspace_bytes", workspace_frames * 2 * n_q * 8)
    ck.trig_sums.launches = 0
    ck.trig_sums.launches_by_precision.update(exact=0, fast=0)
    card, cpu = _polymer_runs(lambda d: polymer.SingleChainStructureFactor(
        u.atoms, n_points=4, unwrap=True, verbose=False, device=d), u)
    chain_frames = [40 * 4] * 3
    per_launch = workspace_frames or 40 * 4
    expected = sum(-(-n // per_launch) for n in chain_frames)
    assert ck.trig_sums.launches_by_precision == {"exact": expected,
                                                  "fast": 0}
    scale = np.abs(cpu.results.scsf).max()
    np.testing.assert_allclose(card.results.scsf, cpu.results.scsf, rtol=0,
                               atol=1e-6 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("angles", [(90.0, 90.0, 90.0), (80.0, 75.0, 70.0)])
def test_minimum_image_polymer_classes_on_the_card_equal_cpu(cuda_device,
                                                              angles):
    """PersistenceLength and MeanSquareInternalDistance of wrapped chains
    on the card (orthorhombic and triclinic boxes): within 1e-6 of the
    CPU's (float64 Gram sums in another order)."""

    from mdhelper_tpu_torch.analysis import polymer
    from mdhelper_tpu_torch.core.universe import Universe

    u, _ = _polymer_system()
    frames = u.trajectory.read_frames(np.arange(12))[0]
    dims = [24.0] * 3 + list(angles)
    u = Universe.from_arrays(frames, dims,
                             segindices=np.repeat(np.arange(40), 20))
    card, cpu = _polymer_runs(lambda d: polymer.PersistenceLength(
        u.atoms, verbose=False, device=d), u)
    np.testing.assert_allclose(card.results.bond_acf[0],
                               cpu.results.bond_acf[0], rtol=0, atol=1e-6)
    card, cpu = _polymer_runs(lambda d: polymer.MeanSquareInternalDistance(
        u.atoms, verbose=False, device=d), u)
    np.testing.assert_allclose(card.results.msid, cpu.results.msid, rtol=0,
                               atol=1e-6 * cpu.results.msid.max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["calculate_shear_viscosity",
                                  "calculate_thermal_conductivity",
                                  "calculate_ionic_conductivity",
                                  "calculate_dielectric_spectrum"])
def test_transport_functions_on_the_card_equal_cpu(cuda_device, name):
    """The transport functions' float64 FFTs on the card: the ACF within
    1e-12 of the CPU's largest value (cuFFT and pocketfft round in
    another order)."""

    from mdhelper_tpu_torch.analysis import electrostatics, thermodynamics

    fn = getattr(thermodynamics, name, None) or getattr(electrostatics, name)
    series = np.random.default_rng(5).normal(size=(4096, 3))
    card = fn(series, 1.0, 1.0, 0.01, reduced=True, device="cuda")
    cpu = fn(series, 1.0, 1.0, 0.01, reduced=True, device="cpu")
    np.testing.assert_allclose(card.acf, cpu.acf, rtol=0,
                               atol=1e-12 * np.abs(cpu.acf).max())


@pytest.mark.cuda
def test_existence_lifetimes_on_the_card_equal_cpu(cuda_device):
    """The lifetime correlation's float64 FFT on the card within 1e-12 of
    the CPU's; the run-length survival is host numpy and equal."""

    from mdhelper_tpu_torch.analysis.base import existence_lifetimes

    h = np.random.default_rng(6).random((400, 64)) < 0.7
    card = existence_lifetimes(h)
    cpu = existence_lifetimes(h, device="cpu")
    np.testing.assert_allclose(card[0], cpu[0], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(card[1], cpu[1])


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_mesh_sums_on_the_card(cuda_device, weighted):
    """The mesh route's scatter-adds on the card against the in-order dense
    chain on the card and the CPU's sums, within 1e-5 sqrt(N) (float32
    atomics add in no fixed order); rho(0) the sum of the weights."""

    from mdhelper_tpu_torch.ops import mesh_scattering as ms

    rng = np.random.default_rng(46)
    n, box = 20_000, 30.0
    pos = torch.from_numpy((rng.random((3, n, 3)) * box).astype(np.float32))
    w = (torch.from_numpy(rng.random((3, n)).astype(np.float32))
         if weighted else None)
    plan = ms.mesh_plan(12, [box] * 3)
    kwargs = dict(n_points=12, mesh=plan["mesh"], width=plan["width"],
                  beta=plan["beta"], box=plan["box"], deconv=plan["deconv"])
    on_card = [x.cpu() for x in ms.mesh_trig_sums(
        pos.to(cuda_device), weights=None if w is None else w.to(
            cuda_device), **kwargs)]
    plain = [x.cpu() for x in ms.mesh_trig_sums_plain(
        pos.to(cuda_device), weights=None if w is None else w.to(
            cuda_device), **kwargs)]
    cpu = ms.mesh_trig_sums(pos, weights=w, **kwargs)
    tol = 1e-5 * np.sqrt(n)
    for a, b, c in zip(on_card, plain, cpu):
        assert (a - b).abs().max().item() < tol
        assert (a - c).abs().max().item() < tol
    total = n if w is None else w.sum(dim=1)
    torch.testing.assert_close(on_card[0][:, 0, 0, 0],
                               torch.as_tensor(total, dtype=torch.float32)
                               .expand(3), rtol=1e-7, atol=0)


def _agg_system(n_mol=300, box=21.0, n_frames=6):
    """testing.water_system waters at liquid density."""

    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.testing import water_system

    frames, topology = water_system(np.random.default_rng(47), n_mol, box,
                                    n_frames, step=0.3)
    return Universe.from_arrays(frames, [box] * 3 + [90.0] * 3, **topology)


@pytest.mark.cuda
def test_aggregates_on_the_card_equal_cpu(cuda_device):
    """ClusterSizeDistribution, HydrogenBondAnalysis and
    NematicOrderParameter on the card: cluster counts, sizes, H-bond counts,
    pair counts and lifetimes equal the CPU's (the same float32 distances
    and a correctly rounded root); the order tensors within 8 eps32."""

    from mdhelper_tpu_torch.analysis import cluster, hbonds, orientation

    u = _agg_system()
    card, cpu = _polymer_runs(lambda d: cluster.ClusterSizeDistribution(
        u.atoms, 2.5, "residues", verbose=False, device=d), u)
    for key in ("n_clusters", "largest", "size_counts"):
        np.testing.assert_array_equal(card.results[key], cpu.results[key])
    card, cpu = _polymer_runs(lambda d: hbonds.HydrogenBondAnalysis(
        u, pair_counts=True, lifetimes=True, verbose=False, device=d), u)
    for key in ("counts", "occupancies", "pair_counts"):
        np.testing.assert_array_equal(card.results[key], cpu.results[key])
    np.testing.assert_allclose(card.results.lifetime, cpu.results.lifetime,
                               rtol=0, atol=1e-12)
    card, cpu = _polymer_runs(lambda d: orientation.NematicOrderParameter(
        u.select_atoms("name H1"), u.select_atoms("name H2"), acf=True,
        verbose=False, device=d), u)
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(card.results.Q, cpu.results.Q, rtol=0,
                               atol=8 * eps)
    card, cpu = _polymer_runs(lambda d: orientation.OrientationProfile(
        u.select_atoms("name O"), u.select_atoms("name H1"), n_bins=20,
        verbose=False, device=d), u)
    np.testing.assert_array_equal(card.results.counts, cpu.results.counts)
    np.testing.assert_allclose(card.results.p2, cpu.results.p2, rtol=0,
                               atol=1e-9)


@pytest.mark.cuda
def test_order_on_the_card_equals_cpu(cuda_device):
    """SteinhardtOrderParameter and TetrahedralOrderParameter on the card:
    neighbor counts equal the CPU's, q_l within 2e-6, w_l within 1e-5,
    q_tet within 2e-6 (float32 sums in another order, CUDA's rsqrtf)."""

    from mdhelper_tpu_torch.analysis import steinhardt

    u = _agg_system()
    card, cpu = _polymer_runs(lambda d: steinhardt.SteinhardtOrderParameter(
        u.atoms, 3.5, (4, 6), averaged=True, wl=True, verbose=False,
        device=d), u)
    np.testing.assert_array_equal(card.results.n_neighbors,
                                  cpu.results.n_neighbors)
    for key in ("ql", "ql_avg", "Ql"):
        np.testing.assert_allclose(card.results[key], cpu.results[key],
                                   rtol=0, atol=2e-6)
    for key in ("wl", "wl_avg"):
        np.testing.assert_allclose(card.results[key], cpu.results[key],
                                   rtol=0, atol=1e-5)
    card, cpu = _polymer_runs(lambda d: steinhardt.TetrahedralOrderParameter(
        u.atoms, verbose=False, device=d), u)
    np.testing.assert_allclose(card.results.q_tet, cpu.results.q_tet,
                               rtol=0, atol=2e-6)


def _velocity_system(n=600, frames=12, box=14.0, seed=47):
    """float32 positions on a wrapped random walk and AR(1) velocities,
    charges +-1, masses 1-20, two-atom residues."""

    from mdhelper_tpu_torch.core.universe import Universe

    rng = np.random.default_rng(seed)
    steps = rng.normal(0.0, 0.3, (frames, n, 3))
    steps[0] = rng.random((n, 3)) * box
    pos = np.mod(np.cumsum(steps, axis=0), box).astype(np.float32)
    vel = np.empty((frames, n, 3))
    vel[0] = rng.standard_normal((n, 3))
    for t in range(1, frames):
        vel[t] = 0.7 * vel[t - 1] + 0.71 * rng.standard_normal((n, 3))
    return Universe.from_arrays(
        pos, [box] * 3 + [90.0] * 3, dt=0.5,
        velocities=vel.astype(np.float32),
        masses=rng.uniform(1.0, 20.0, n), charges=np.tile([1.0, -1.0], n // 2),
        resindices=np.repeat(np.arange(n // 2), 2))


@pytest.mark.cuda
def test_velocity_dynamics_on_the_card_equal_cpu(cuda_device):
    """VelocityAutocorrelation and ElectricCurrentAutocorrelation (float64
    on the card, another summation order) within 1e-12 of the CPU's; the
    survival memberships (slab, sphere, shell) and the overlap function
    (a ring of 5 lags over more frames) equal the CPU's."""

    from mdhelper_tpu_torch.analysis import dynamics

    u = _velocity_system()
    card, cpu = _polymer_runs(lambda d: dynamics.VelocityAutocorrelation(
        u.atoms, n_blocks=2, verbose=False, device=d), u)
    for key in ("vacf", "vdos"):
        np.testing.assert_allclose(card.results[key], cpu.results[key],
                                   rtol=1e-12, atol=1e-12)
    card, cpu = _polymer_runs(
        lambda d: dynamics.ElectricCurrentAutocorrelation(
            u.atoms, 300.0, verbose=False, device=d), u)
    np.testing.assert_allclose(card.results.current, cpu.results.current,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(card.results.conductivity,
                               cpu.results.conductivity, rtol=1e-10)
    for zone in (("slab", "z", 3.0, 9.0), ("sphere", [7.0, 7.0, 7.0], 4.0),
                 ("shell", u.atoms[:40], 2.0)):
        card, cpu = _polymer_runs(lambda d: dynamics.SurvivalProbability(
            u.atoms[1::2], zone, verbose=False, device=d), u)
        np.testing.assert_array_equal(card._membership, cpu._membership)
        np.testing.assert_allclose(card.results.intermittent,
                                   cpu.results.intermittent, atol=1e-12)
    # a ring of fewer lags than frames, so that it wraps around
    for grouping in ("atoms", "residues"):
        card, cpu = _polymer_runs(lambda d: dynamics.OverlapFunction(
            u.atoms, 0.4, grouping=grouping, n_lags=5, verbose=False,
            device=d), u)
        np.testing.assert_array_equal(card.results.Q, cpu.results.Q)
        np.testing.assert_array_equal(card.results.chi4, cpu.results.chi4)


@pytest.mark.cuda
def test_flow_on_the_card_equals_cpu(cuda_device):
    """FlowProfile on the card: counts equal the CPU's; the float64 weighted
    sums (bincount's atomics, in no fixed order) within 1e-12."""

    from mdhelper_tpu_torch.analysis import flow

    u = _velocity_system()
    card, cpu = _polymer_runs(lambda d: flow.FlowProfile(
        u.atoms, n_bins=30, verbose=False, device=d), u)
    np.testing.assert_array_equal(card.results.counts, cpu.results.counts)
    for key in ("velocity", "temperature", "mass_density"):
        np.testing.assert_allclose(card.results[key], cpu.results[key],
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2, 3])
def test_grid_ops_on_the_card_equal_cpu(cuda_device, order):
    """The deposit on the card: NGP counts equal, CIC/TSC cells (float64
    atomics rounded once) equal but for near-ties; the float64-transform
    smoothing within an ulp of its maximum, and equal but for near-ties
    where the field is not tiny."""

    from mdhelper_tpu_torch.ops import profiles

    rng = np.random.default_rng(48)
    box = torch.tensor([30.0, 30.0, 50.0])
    x = torch.from_numpy((rng.random((4, 20_000, 3))
                          * box.numpy()).astype(np.float32))
    cells = (64, 64, 128)
    cpu = profiles.grid_deposit_frames(x, cells, box, order)
    card = profiles.grid_deposit_frames(x.to(cuda_device), cells,
                                        box.to(cuda_device), order).cpu()
    if order == 1:
        torch.testing.assert_close(card, cpu, rtol=0, atol=0)
    else:
        assert (card != cpu).float().mean().item() < 1e-6
        torch.testing.assert_close(card, cpu, rtol=2e-7, atol=1e-12)
    smooth_cpu = profiles.gaussian_smooth_periodic(cpu, box, 2.4, order)
    smooth = profiles.gaussian_smooth_periodic(
        cpu.to(cuda_device), box.to(cuda_device), 2.4, order).cpu()
    # float64 transforms differ far below an ulp of the maximum; where the
    # field is not tiny, the float32 roundings agree but for near-ties
    top = smooth_cpu.abs().max().item()
    assert (smooth - smooth_cpu).abs().max().item() <= top * 2.0**-24
    big = smooth_cpu.abs() > 1e-3 * top
    assert (smooth[big] != smooth_cpu[big]).float().mean().item() < 1e-6


@pytest.mark.cuda
def test_interfaces_on_the_card_equal_cpu(cuda_device):
    """WillardChandlerInterface and IntrinsicDensityProfile on the card: the
    fields within 2e-7 of their maximum of the CPU's, levels within 1e-6,
    heights within 1e-5 A (a few ulps: float64 sums and transforms
    rounded once agree but for near-ties), also at the default chunk in
    grid passes of two frames; the intrinsic counts equal."""

    from mdhelper_tpu_torch.analysis import interface
    from mdhelper_tpu_torch.core.universe import Universe

    rng = np.random.default_rng(49)
    box = np.array([20.0, 20.0, 30.0])
    frames, n = 6, 8000
    pos = np.empty((frames, n + 100, 3))
    for t in range(frames):
        x = rng.uniform(0, box[0], n)
        y = rng.uniform(0, box[1], n)
        z = 1.5 * np.sin(2 * np.pi * x / box[0] + t) + rng.uniform(8, 22, n)
        pos[t, :n] = np.stack((x, y, z), -1)
        pos[t, n:] = rng.random((100, 3)) * box
    u = Universe.from_arrays(pos.astype(np.float32), list(box) + [90.0] * 3)
    card, cpu = _polymer_runs(lambda d: interface.WillardChandlerInterface(
        u.atoms[:n], xi=1.5, verbose=False, device=d), u)
    field = cpu.results.density_field
    np.testing.assert_allclose(card.results.density_field, field, rtol=0,
                               atol=2e-7 * field.max())
    np.testing.assert_allclose(card.results.levels, cpu.results.levels,
                               rtol=1e-6)
    np.testing.assert_allclose(card.results.heights, cpu.results.heights,
                               rtol=0, atol=1e-5)
    # the default chunk (every frame at once) in grid passes of 2 frames
    whole = interface.WillardChandlerInterface(u.atoms[:n], xi=1.5,
                                               verbose=False, device="cuda")
    per_frame = (interface._BYTES_PER_POINT * int(np.prod(whole._n_cells))
                 + interface._BYTES_PER_CORNER * n * 2**3)
    whole._grid_bytes = 2 * per_frame
    assert interface._grid_pass_frames(whole._grid_bytes, whole._n_cells, n,
                                       2) == 2
    whole.run()
    np.testing.assert_allclose(whole.results.levels, cpu.results.levels,
                               rtol=1e-6)
    np.testing.assert_allclose(whole.results.heights, cpu.results.heights,
                               rtol=0, atol=1e-5)
    card, cpu = _polymer_runs(lambda d: interface.IntrinsicDensityProfile(
        u.atoms[:n], [u.atoms[:n], u.atoms[n:]], xi=1.5, verbose=False,
        device=d), u)
    np.testing.assert_array_equal(card.results.counts, cpu.results.counts)


def _molecule_system():
    """Six chains of 10 monomers (testing.polymer_chains) wrapped into a
    triclinic cell, 8 float32 frames, with bonds and masses."""

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.testing import polymer_chains

    dims = np.array([12.0, 12.0, 12.0, 80.0, 75.0, 70.0])
    _, unwrapped = polymer_chains(np.random.default_rng(52), 6, 10, 8, 12.0,
                                  stiffness=0.5)
    h = triclinic_matrices(dims[None])[0]
    frac = unwrapped @ np.linalg.inv(h)
    frames = ((frac - np.floor(frac)) @ h).astype(np.float32)
    bonds = np.array([(c * 10 + i, c * 10 + i + 1)
                      for c in range(6) for i in range(9)])
    masses = np.tile([12.011, 14.007], 30)
    return (Universe.from_arrays(frames, dims, bonds=bonds, masses=masses),
            Universe.from_arrays(unwrapped.astype(np.float32),
                                 [50.0] * 3 + [90.0] * 3, masses=masses))


@pytest.mark.cuda
def test_superposition_on_the_card_equals_cpu(cuda_device):
    """RMSD, RMSF, PCA and TICA on the card: the float64 fit (cuSOLVER's
    batched 4 x 4 eigh) within 1e-10 of the CPU's; PCA variances and the
    two leading components, and TICA's eigenvalues, within 1e-8."""

    from mdhelper_tpu_torch.analysis import rmsd

    _, u = _molecule_system()
    group = u.atoms[10:40]
    card, cpu = _polymer_runs(lambda d: rmsd.RMSD(
        group, weights="mass", verbose=False, device=d), u)
    np.testing.assert_allclose(card.results.rmsd, cpu.results.rmsd, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(card.results.rotations, cpu.results.rotations,
                               rtol=0, atol=1e-10)
    assert card.results.rmsd[0] < 1e-6
    card, cpu = _polymer_runs(lambda d: rmsd.RMSF(
        group, verbose=False, device=d), u)
    np.testing.assert_allclose(card.results.rmsf, cpu.results.rmsf, rtol=0,
                               atol=1e-10)
    card, cpu = _polymer_runs(lambda d: rmsd.PrincipalComponentAnalysis(
        group, verbose=False, device=d), u)
    scale = cpu.results.variance[0]
    np.testing.assert_allclose(card.results.variance, cpu.results.variance,
                               rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(card.transform(2), cpu.transform(2), rtol=0,
                               atol=1e-8 * np.sqrt(scale))
    card, cpu = _polymer_runs(lambda d: rmsd.TICA(
        group, lag=2, verbose=False, device=d), u)
    np.testing.assert_allclose(card.results.eigenvalues,
                               cpu.results.eigenvalues, rtol=0, atol=1e-8)
    for key in ("sum", "m2", "sum_a", "sum_b", "mab"):
        np.testing.assert_allclose(card._carry[key].cpu().numpy(),
                                   cpu._carry[key].numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.cuda
def test_bonded_on_the_card_equals_cpu(cuda_device):
    """Bond lengths bin exactly on the card (counts equal the CPU's);
    angles and dihedrals (float32 arccos and arctan2 of CUDA's libdevice)
    within two counts of each value near an edge; moments within 1e-6."""

    from mdhelper_tpu_torch.analysis import bonded

    u, _ = _molecule_system()
    for cls in ("BondLengthDistribution", "BondAngleDistribution",
                "DihedralDistribution"):
        card, cpu = _polymer_runs(lambda d: getattr(bonded, cls)(
            u.atoms, verbose=False, device=d), u)
        diff = np.abs(card.results.counts - cpu.results.counts).sum()
        assert diff == 0 if cls == "BondLengthDistribution" else diff <= 4
        if "mean" in cpu.results:
            np.testing.assert_allclose(card.results.mean, cpu.results.mean,
                                       rtol=1e-6)
            np.testing.assert_allclose(card.results.std, cpu.results.std,
                                       rtol=1e-6)


@pytest.mark.cuda
def test_native_contacts_on_the_card_equal_cpu(cuda_device):
    """hard and radius q equal the CPU's bit for bit, soft within 1e-6, in
    the triclinic cell."""

    from mdhelper_tpu_torch.analysis import contacts

    u, _ = _molecule_system()
    for method in ("hard", "radius", "soft"):
        card, cpu = _polymer_runs(lambda d: contacts.NativeContacts(
            u.atoms[:30], u.atoms[20:], 3.0, method=method, verbose=False,
            device=d), u)
        np.testing.assert_array_equal(card.results.pairs, cpu.results.pairs)
        if method == "soft":
            np.testing.assert_allclose(card.results.q, cpu.results.q,
                                       rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(card.results.q, cpu.results.q)


@pytest.mark.cuda
def test_accelerated_numpy_inputs_run_on_the_card(cuda_device):
    """NumPy inputs to ``algorithm.accelerated`` go to the first CUDA device
    and come back as NumPy, equal to the CPU tensors' results within 1e-12
    of the largest value (float64)."""

    from mdhelper_tpu_torch.algorithm import accelerated

    rng = np.random.default_rng(11)
    qs, rs = rng.normal(size=(7, 3)), rng.normal(size=(50, 3)) * 4
    xs = rng.normal(size=(6, 30)) * 3
    for name, args in (("delta_fourier_transform_sum_2d_2d", (qs, rs)),
                       ("inner_2d_2d", (qs, rs)), ("cosine_sum_2d", (xs,)),
                       ("sine_sum_2d", (xs,))):
        fn = getattr(accelerated, name)
        card = fn(*args)
        assert isinstance(card, np.ndarray)
        cpu = fn(*[torch.as_tensor(a) for a in args]).numpy()
        np.testing.assert_allclose(card, cpu, rtol=0,
                                   atol=1e-12 * np.abs(cpu).max())
    out = np.zeros(len(xs))
    accelerated.cosine_sum_inplace_2d(xs, out)
    np.testing.assert_allclose(out, np.cos(xs).sum(axis=1), rtol=1e-12)
