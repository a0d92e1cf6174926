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
    edge_straddle_positions,
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
