"""Where the PyTorch port's fused slice spends its time on one CUDA card.

Run from the repository root::

    python3 scripts/profile_torch_slice.py [--out PATH]

In one process, on ``chip_smoke.py``'s main path (100k atoms, 40
frames in 8-frame chunks), it times the fused RDF + S(q) + MSD pass,
each analysis alone, and the fused pass again, and prints frames/s for
each with the card's name and power limit.  Then it runs one fused pass
under ``torch.profiler`` and prints the device's busy share of that
pass's wall time (the union of all device-side activity intervals) and
the kernels that took the most device time.  With ``--out PATH`` the
full profiler table is also written to PATH.

Imports neither JAX nor the JAX package.
"""

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

PASSES = (
    ("fused RDF + S(q) + MSD", ("rdf", "sq", "msd")),
    ("RDF alone", ("rdf",)),
    ("S(q) alone", ("sq",)),
    ("Onsager alone", ("msd",)),
    ("fused again", ("rdf", "sq", "msd")),
)


def busy_us(events):
    """Length of the union of ``[start, end)`` intervals, in us."""

    total, reach = 0.0, -np.inf
    for start, end in sorted(events):
        if end <= reach:
            continue
        total += end - max(start, reach)
        reach = end
    return total


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="file for the full profiler table")
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mdhelper_tpu_torch._device import require_cuda

    device = require_cuda()
    card = chip_smoke.card_line()
    _, u = chip_smoke.slice_universe(np.random.default_rng(chip_smoke.SEED))

    # Warm-up: builds the kernel and the first-call caches.
    chip_smoke.run_timed(chip_smoke.slice_analyses(u, device))
    print(f"{card}; {chip_smoke.N_ATOMS} atoms, {chip_smoke.N_FRAMES} "
          f"frames in chunks of {chip_smoke.CHUNK}")
    print("| Pass | frames/s | ms a frame |")
    print("| --- | --- | --- |")
    for name, parts in PASSES:
        fps = chip_smoke.run_timed(chip_smoke.slice_analyses(u, device, parts))
        print(f"| {name} | {fps:.3f} | {1e3 / fps:.3f} |")

    analyses = chip_smoke.slice_analyses(u, device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke.run_timed(analyses)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA
    ]
    print(f"profiled fused pass: wall {wall_us / 1e6:.3f} s with the "
          f"profiler on; {len(on_device)} device activities; device busy "
          f"{100 * busy_us(on_device) / wall_us:.1f} % of the wall time")
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=15))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(card + "\n" + averages.table(
                sort_by="self_device_time_total", row_limit=60) + "\n")
        print(f"full table: {args.out}")


if __name__ == "__main__":
    main()
