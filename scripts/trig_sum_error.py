"""Where the error of the exact trig sums comes from, on the card.

Usage::

    python scripts/trig_sum_error.py [--atoms 100000] [--seed 2031]

Draws uniform float32 frames in a cube of density 0.8 and takes 512
wavevectors of the 24^3 grid (float64, split hi + lo), as
``chip_smoke.py``'s trig-sums phase does, forms the double-float reduced
phases of ``ops/scattering._exact_phases`` and sums four versions of the
terms in float64 against a float64 direct sum:

* A: float32 ``cos(hi) - lo sin(hi)`` (the kernel's and the plain
  version's terms);
* B: float64 ``cos(hi + lo)`` (the phase alone);
* C: float32 ``cos(hi)``, ``sin(hi)`` with the correction in float64;
* D: float64 ``cos(hi)``, ``sin(hi)`` with the correction in float64.

For each it prints the largest error of the sums, beside the tolerance
of ``tests/test_pallas.py`` (1e-6 of the mean amplitude), and the
largest mean error of one term over the atoms.  Then the kernel's own
exact sums (``ops/cuda_kernels.trig_sums``, cos and sin) against the
float64 direct sums, and their share of the tolerance.  Needs a CUDA
device.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mdhelper_tpu_torch._device import require_cuda  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import _wavevector_grid  # noqa: E402
from mdhelper_tpu_torch.ops import cuda_kernels, scattering  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--atoms", type=int, default=100_000)
    parser.add_argument("--frames", type=int, default=2)
    parser.add_argument("--seed", type=int, default=2031)
    args = parser.parse_args()
    device = require_cuda()
    rng = np.random.default_rng(args.seed)
    box = float(args.atoms / 0.8) ** (1 / 3)
    qs = _wavevector_grid([box] * 3, 24)
    qs = torch.from_numpy(qs[np.sort(rng.choice(len(qs), 512,
                                                replace=False))]).to(device)
    q_hi, q_lo = scattering._split_wavevectors(qs, torch.float32)
    for f in range(args.frames):
        pos = torch.from_numpy(
            (rng.random((args.atoms, 3)) * box).astype(np.float32)
        ).to(device)
        phases = qs @ pos.double().T
        exact = torch.cos(phases)
        oracle = exact.sum(-1)
        oracle_sin = torch.sin(phases).sum(-1)
        amp = float(torch.hypot(oracle, oracle_sin).mean())
        hi, lo = scattering._exact_phases(q_hi, pos, q_lo)
        hi64, lo64 = hi.double(), lo.double()
        terms = {
            "A float32 terms": (torch.cos(hi) - lo * torch.sin(hi)).double(),
            "B float64 cos(hi + lo)": torch.cos(hi64 + lo64),
            "C float32 cos, sin; float64 correction":
                torch.cos(hi).double() - lo64 * torch.sin(hi).double(),
            "D float64 cos, sin; float64 correction":
                torch.cos(hi64) - lo64 * torch.sin(hi64),
        }
        for name, values in terms.items():
            err = (values.sum(-1) - oracle).abs()
            bias = (values - exact).mean(-1).abs().max()
            print(f"frame {f}, {args.atoms} atoms, {name}: largest sum "
                  f"error {float(err.max()):.3e} (tolerance "
                  f"{1e-6 * amp:.3e}), largest mean term error "
                  f"{float(bias):.3e}")
        k_cos, k_sin = cuda_kernels.trig_sums(qs, pos, precision="exact")
        err = max(float((k_cos.double() - oracle).abs().max()),
                  float((k_sin.double() - oracle_sin).abs().max()))
        print(f"frame {f}, {args.atoms} atoms, the kernel's exact sums: "
              f"largest error {err:.3e} ({100 * err / (1e-6 * amp):.0f} % "
              f"of the tolerance {1e-6 * amp:.3e})")


if __name__ == "__main__":
    main()
