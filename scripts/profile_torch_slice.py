"""Where the PyTorch port's paths spend their time on one CUDA card.

Run from the repository root::

    python3 scripts/profile_torch_slice.py [--path P] [--seed N] [--out FILE]

``--path fused`` (the default) takes ``chip_smoke.py``'s main path
(100k atoms, 40 frames in 8-frame chunks): in one process it times the
fused RDF + S(q) + MSD pass, each analysis alone, and the fused pass
again.  ``--path cross_rdf`` and ``--path vanhove`` take its cross-RDF
(56 frames) and Van Hove (104 frames, 21 lags) paths at 100k atoms and
time two passes.  Each prints frames/s with the card's name and power
limit after one warm-up pass, then runs one more pass under
``torch.profiler`` and prints the device's busy share of that pass's
wall time (the union of all device-side activity intervals) and the
kernels that took the most device time.  With ``--out FILE`` the full
profiler table is also written to FILE.  ``--seed`` picks the uniform
trajectory (default ``chip_smoke.SEED``): a pass whose densest cell
exceeds the planned capacity raises ``CellCapacityOverflow``, as
``run_together`` does, and another seed gives another draw.

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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", default="fused",
                        choices=("fused", "cross_rdf", "vanhove"))
    parser.add_argument("--seed", type=int, default=chip_smoke.SEED,
                        help="seed of the uniform trajectory")
    parser.add_argument("--out", help="file for the full profiler table")
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mdhelper_tpu_torch._device import require_cuda

    device = require_cuda()
    card = chip_smoke.card_line()
    if args.path == "fused":
        n_frames, passes = chip_smoke.N_FRAMES, PASSES

        def make(parts):
            return chip_smoke.slice_analyses(u, device, parts)
    else:
        n_frames = (chip_smoke.RDF_FRAMES if args.path == "cross_rdf"
                    else chip_smoke.VH_FRAMES)
        passes = ((args.path, None), (f"{args.path} again", None))

        def make(parts):
            return [chip_smoke.path_analysis(u, device, args.path)]
    _, u = chip_smoke.slice_universe(
        np.random.default_rng(args.seed), n_frames
    )

    def run(parts):
        return chip_smoke.run_timed(make(parts), n_frames)

    # Warm-up: builds the kernels and the first-call caches.
    run(passes[0][1])
    print(f"{card}; {args.path}: {chip_smoke.N_ATOMS} atoms, {n_frames} "
          f"frames in chunks of {chip_smoke.CHUNK}")
    print("| Pass | frames/s | ms a frame |")
    print("| --- | --- | --- |")
    for name, parts in passes:
        fps = run(parts)
        print(f"| {name} | {fps:.3f} | {1e3 / fps:.3f} |")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(passes[0][1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA
    ]
    print(f"profiled {args.path} pass: wall {wall_us / 1e6:.3f} s with the "
          f"profiler on; {len(on_device)} device activities; device busy "
          f"{100 * chip_smoke.busy_us(on_device) / wall_us:.1f} % of the "
          "wall time")
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
