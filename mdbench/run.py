"""Run one cell of ``BENCHMARK.json`` once, on this machine's CUDA cards.

    python3 mdbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    python3 mdbench/run.py --workload <cell> --rehearse

Run from the root of a checkout.  Set-up (the process's start to the
window's start) imports the program, loads or builds its CUDA library
(inside the checkout, ``mdhelper_tpu_torch/_build/``), makes the cell's
trajectory from the seed on the card and runs one warm pass of the
cell's own shapes.  With ``--trace 0`` the window then runs back-to-back
passes until the end of the first one that finishes ``--seconds`` after
its start, and the end-to-end metrics are printed; with ``--trace 1``
one pass runs under ``torch.profiler`` and the per-layer metrics are
printed.  After the window, once the device's peak memory is read and the
program's state is freed, every judged pass is held against the plain
references (``mdbench/reference/``), each compared number printed beside
its limit on standard error and under ``checks`` in the result.  The last
line of standard output is one JSON object: ``correct``, ``attempted``
and ``failed`` (passes), ``metrics``, ``device`` and, traced,
``breakdown``, then ``checks``.

``--rehearse`` runs the cell at the configuration's and the traffic's
``rehearse`` sizes on the CPU, through the program's plain versions: it
checks the harness's paths and prints no metric.  A measured run fails
without as many CUDA cards as the cell asks for.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: top-level module names the process may not hold once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "mdhelper_tpu")


def fail(message, code=2):
    print(f"mdbench: {message}", file=sys.stderr)
    sys.exit(code)


def forbidden_modules():
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info():
    """The card's name, power limit and clocks, from nvidia-smi."""

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return [f"nvidia-smi unavailable: {exc}"]


def quiet_collector():
    """Move every object alive at the end of set-up (the imports', the
    harness's, the trajectory's) out of the cyclic garbage collector's
    reach, so that a collection in the window scans only what the passes
    made: a full collection over set-up's objects cost about 0.35 s of a
    5-s pass of ``lj100k.fused``, at a random pass, on an H100 host."""

    import gc

    gc.collect()
    gc.freeze()


def caches():
    """Every build and kernel cache inside the checkout, at fixed paths."""

    base = ROOT / ".mdbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true")
    return p.parse_args(argv)


def sized(cell, rehearse):
    """The cell's configuration and traffic, at their ``rehearse`` sizes
    for a rehearsal."""

    config, traffic = dict(cell["config"]), dict(cell["traffic"])
    if rehearse:
        config.update(config.get("rehearse", {}))
        traffic.update(traffic.get("rehearse", {}))
    return config, traffic


def main(argv=None):
    args = parse(argv)
    if not (ROOT / "mdhelper_tpu_torch").is_dir():
        fail("the program (mdhelper_tpu_torch/) is not in this checkout")
    caches()
    from mdbench.harness import spec as specs

    cell = specs.cell(args.workload, ROOT)
    if cell["traffic"].get("ranks", 1) > 1:
        from mdbench.harness import ranks

        return ranks.main(args, cell, STARTED)

    import torch

    if args.rehearse:
        device = torch.device("cpu")
        sync = (lambda: None)
    else:
        if not torch.cuda.is_available():
            fail("no CUDA device: a measured run needs the card")
        if torch.cuda.device_count() < cell["chips"]:
            fail(f"{torch.cuda.device_count()} CUDA device(s), the cell "
                 f"asks for {cell['chips']}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        sync = torch.cuda.synchronize
    return run_cell(args, cell, device, sync)


def run_cell(args, cell, device, sync, wrap=None):
    """One run of `cell` on `device`; `wrap` (the fault tests' hook)
    breaks the timed path underneath (:func:`passes.run_pass`)."""

    import torch

    from mdbench.harness import judge, passes, trace
    from mdbench.harness import spec as specs
    from mdhelper_tpu_torch.core.universe import Universe

    config, traffic = sized(cell, args.rehearse)
    measured = not args.rehearse
    build_s = None
    if measured:
        from mdhelper_tpu_torch.ops import _build

        began = time.perf_counter()
        _build.load_library()
        build_s = time.perf_counter() - began
    gen = specs.generator(config["generator"])
    phases = {"library": time.perf_counter() - STARTED}
    frames, dims = gen.make(config, int(traffic["pass_frames"]), args.seed,
                            device)
    universe = Universe.from_arrays(frames, dims, dt=1.0)
    phases["trajectory"] = time.perf_counter() - STARTED

    def one_pass(on_chunk=None):
        return passes.run_pass(universe, traffic, config, device,
                               on_chunk=on_chunk, wrap=wrap)

    n_chunks = -(-int(traffic["pass_frames"]) // int(traffic["chunk_frames"]))
    kept, records, breakdown, ends = [], None, None, []
    if args.trace and measured:
        # The warm pass of set-up is the trace's first warming pass.
        quiet_collector()
        setup_s = time.perf_counter() - STARTED
        torch.cuda.reset_peak_memory_stats(device)
        taken, records, window_s, tries = trace.traced_pass(
            one_pass, n_chunks, sync)
        kept = [taken]
        n_passes = 1
    else:
        kept.append(one_pass())
        sync()
        quiet_collector()
        setup_s = time.perf_counter() - STARTED
        if measured:
            torch.cuda.reset_peak_memory_stats(device)
            kept, n_passes, window_s, ends = passes.window(
                one_pass, args.seconds, sync)
        else:
            n_passes, window_s = 1, None
    peak = torch.cuda.max_memory_allocated(device) if measured else 0
    del one_pass
    if measured:
        torch.cuda.empty_cache()
    leaked = forbidden_modules()
    if leaked and measured:
        fail(f"the process holds {leaked} after the window", code=3)

    began = time.perf_counter()
    answers = judge.wants(frames, dims, traffic, config, device)
    correct, failed, widest, limits = judge.verdict(kept, answers, traffic)
    reference_s = time.perf_counter() - began
    if not measured:
        return emit(cell, args, correct, len(kept), failed, widest, limits)

    cards = card_info()
    n_frames = int(traffic["pass_frames"])
    metrics, device_out = {}, {
        "platform": "gpu", "kind": torch.cuda.get_device_name(device),
        "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if args.trace:
        busy_us = trace.busy_us([(s, e) for _, s, e in records])
        device_out.update(busy_s=busy_us / 1e6, window_s=window_s)
        ctx = {"records": records, "window_s": window_s,
               "frames": n_frames * n_passes, "passes": n_passes,
               "answers": answers, "taken": kept, "config": config,
               "traffic": traffic}
        for m in cell["per_layer"]:
            value = specs.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = trace.breakdown(records)
    else:
        for m in cell["end_to_end"]:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == "frames_per_s":
                value = n_frames * n_passes / window_s
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    record = {"card": cards, "build_s": build_s, "setup_s": setup_s,
              "passes": n_passes, "window_s": window_s,
              "memory_peak_bytes": int(peak), "reference_s": reference_s,
              "phases_s": phases, "pass_ends_s": ends}
    if args.trace:
        record["profiler_tries"] = tries
    print(f"card {cards}; library build/load {build_s!r} s; set-up "
          f"{setup_s!r} s; {n_passes} passes in {window_s!r} s; peak "
          f"{peak} bytes; reference and judgement {reference_s!r} s; set-up "
          f"phases (seconds from the start) {phases}; passes' ends {ends}",
          file=sys.stderr)
    return emit(cell, args, correct, len(kept), failed, widest, limits,
                metrics, device_out, breakdown, record)


def emit(cell, args, correct, attempted, failed, widest, limits,
         metrics=None, device=None, breakdown=None, record=None):
    """Print each compared number beside its limit as the last lines of
    standard error and the result as the last line of standard output;
    a measured run also writes its record to ``.mdbench_runs/``.  A
    rehearsal's result has no metric and says it was not measured."""

    from mdbench.harness import judge

    checks = {name: {"value": widest.get(name), "limit": limits.get(name)}
              for name in sorted(set(widest) | set(limits))}
    if args.rehearse:
        result = {"rehearsal": True, "measured": False}
    else:
        result = {}
        runs = ROOT / ".mdbench_runs"
        runs.mkdir(exist_ok=True)
        with open(runs / f"{cell['name']}.{args.seed}.{args.trace}.json",
                  "w") as f:
            json.dump(dict(record, cell=cell["name"], seed=args.seed,
                           trace=args.trace, metrics=metrics,
                           checks=checks), f)
    result.update(correct=correct, attempted=attempted, failed=failed)
    if not args.rehearse:
        result.update(metrics=metrics, device=device)
        if breakdown is not None:
            result["breakdown"] = breakdown
    result["checks"] = checks
    for line in judge.lines(widest, limits):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
