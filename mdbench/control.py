"""Readings that set the limits of a cell's compared numbers.

    python3 mdbench/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds a,b,c] [--reference-dtype float32] [--rehearse]

For each seed of ``--seeds`` it makes the cell's trajectory, runs one
pass of the program as the benchmark's window runs it and judges it
against the float64 references: the lower readings.  For each seed of
``--control-seeds`` it also judges the control: the program with each
analysis's own lower-precision path switched on (the traffic entry's
``control.kwargs``), and, for an analysis without one, its reference
computed in the precision below the one the configuration states
(``control.dtype``) put in the program's place: the upper readings.
``--reference-dtype`` also reads every reference computed in that dtype
in the program's place (where the program's own path does not separate
from it).  One JSON line a reading, then one line with each number's
largest lower and smallest upper reading.  The benchmark's own runs do
not run this; ``tests/test_mdbench_faults.py`` plants the faults.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

def seeds(text):
    return [int(s) for s in text.split(",") if s]


def control_taken(universe, frames, dims, traffic, config, device):
    """The control's results of one pass: the program with each entry's
    ``control.kwargs`` on, and each entry with ``control.dtype`` replaced
    by its reference computed in that dtype."""

    import torch

    from mdbench.harness import passes
    from mdbench.harness import spec as specs

    taken = passes.run_pass(universe, traffic, config, device, control=True)
    for i, entry in enumerate(traffic["analyses"]):
        dtype = entry.get("control", {}).get("dtype")
        if dtype:
            ref = specs.reference(entry["reference"])
            sub = dict(entry, kwargs=passes.resolved(entry, config))
            taken[i] = ref.expected(frames, dims, sub, device,
                                    getattr(torch, dtype))
    return taken


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--reference-dtype", default=None,
                   help="also read every entry's reference computed in "
                   "this dtype put in the program's place")
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)

    import torch

    from mdbench.harness import judge, passes
    from mdbench.harness import spec as specs
    from mdbench.run import sized
    from mdhelper_tpu_torch.core.universe import Universe

    cell = specs.cell(args.workload, ROOT)
    config, traffic = sized(cell, args.rehearse)
    device = torch.device("cpu" if args.rehearse else "cuda")
    gen = specs.generator(config["generator"])
    lower, upper = {}, {}

    def report(seed, kind, got, seconds):
        print(json.dumps({"seed": seed, "kind": kind, "numbers": got,
                          "seconds": seconds}), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        frames, dims = gen.make(config, int(traffic["pass_frames"]), seed,
                                device)
        universe = Universe.from_arrays(frames, dims, dt=1.0)
        began = time.perf_counter()
        taken = passes.run_pass(universe, traffic, config, device)
        pass_s = time.perf_counter() - began
        began = time.perf_counter()
        answers = judge.wants(frames, dims, traffic, config, device)
        ref_s = time.perf_counter() - began
        if seed in args.seeds:
            got = judge.numbers(taken, answers, traffic)
            report(seed, "program", got, {"pass": pass_s, "reference": ref_s})
            for k, v in got.items():
                lower[k] = max(lower.get(k, v), v)
        if seed not in args.control_seeds:
            continue
        taken = control_taken(universe, frames, dims, traffic, config,
                              device)
        got = judge.numbers(taken, answers, traffic)
        report(seed, "control", got, None)
        for k, v in got.items():
            upper[k] = min(upper.get(k, v), v)
        if args.reference_dtype:
            taken = [specs.reference(entry["reference"]).expected(
                frames, dims, dict(entry, kwargs=passes.resolved(entry, config)),
                device, getattr(torch, args.reference_dtype))
                for entry in traffic["analyses"]]
            report(seed, f"reference:{args.reference_dtype}",
                   judge.numbers(taken, answers, traffic), None)
        del universe, frames
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}))


if __name__ == "__main__":
    main()
