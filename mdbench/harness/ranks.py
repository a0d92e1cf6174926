"""A cell whose traffic runs over ranks: one process a card, joined by
``torch.distributed`` (NCCL on the cards; gloo on the CPU for a
rehearsal), each running the passes with ``run_together(...,
parallel=True)``, which shards every chunk's frames over the ranks and
reduces the carries and stores before the conclusions.

The parent (``run.py``) starts the ranks, waits for each, and prints the
result.  Each rank makes the same trajectory from the seed on its own
card and runs a warm pass.  A pass of the window starts on every rank
after a barrier; the job's pass runs from the first rank's start to the
last rank's end (wall clocks of one host), and the window's rate is all
passes' frames over the first start to the last end.  Rank 0 decides,
after each pass, whether the window goes on.  Set-up is the parent's
start to the window's start.  Once the window has closed every rank
judges its own results against the references on its card; the run is
correct when every rank's are.

    python3 mdbench/harness/ranks.py <job.json>

runs one rank (the parent writes the job file).
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: seconds a rank may take, set-up and reference included.
RANK_TIMEOUT = 330


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(args, cell, started, fault=None):
    """Run the cell's ranks; print the result line; return the exit
    code.  `fault` (the fault tests') breaks every rank's timed path.
    Each rank gets `cell` (its configuration and traffic) in its job
    file."""

    import torch

    from mdbench.run import card_info, fail, forbidden_modules

    world = int(cell["traffic"]["ranks"])
    if not args.rehearse:
        if not torch.cuda.is_available():
            fail("no CUDA device: a measured run needs the cards")
        if torch.cuda.device_count() < max(world, cell["chips"]):
            fail(f"{torch.cuda.device_count()} CUDA device(s), the cell "
                 f"asks for {max(world, cell['chips'])}")
    wall_started = time.time() - (time.perf_counter() - started)
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="mdbench_ranks_") as tmp:
        procs = []
        for rank in range(world):
            job = {"rank": rank, "world": world, "port": port,
                   "workload": args.workload, "seed": args.seed,
                   "seconds": args.seconds, "trace": args.trace,
                   "rehearse": args.rehearse, "wall_started": wall_started,
                   "fault": fault, "out": os.path.join(tmp, f"{rank}.json"),
                   "cell": cell}
            path = os.path.join(tmp, f"job{rank}.json")
            with open(path, "w") as f:
                json.dump(job, f)
            env = dict(os.environ, OMP_NUM_THREADS="1", USE_FLAX="0")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), path],
                cwd=str(ROOT), env=env))
        deadline = time.monotonic() + RANK_TIMEOUT
        codes = []
        try:
            for p in procs:
                codes.append(p.wait(timeout=max(
                    deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            codes.append(None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if codes != [0] * world:
            fail(f"a rank failed: exit codes {codes}", code=4)
        reports = []
        for rank in range(world):
            with open(os.path.join(tmp, f"{rank}.json")) as f:
                reports.append(json.load(f))
    leaked = forbidden_modules()
    if leaked:
        fail(f"the process holds {leaked} after the window", code=3)
    return report(args, cell, reports, card_info() if not args.rehearse
                  else None)


def merged_breakdown(parts):
    """The ranks' breakdowns as one: each device operation's seconds
    summed over the ranks, and the longest idle gaps of any rank (named
    with their rank), ten of each."""

    ops = {}
    for part in parts:
        for name, seconds in part["device_ops"]:
            ops[name] = ops.get(name, 0.0) + seconds
    gaps = [[f"rank {rank} {name}", seconds]
            for rank, part in enumerate(parts)
            for name, seconds in part["idle_gaps"]]
    return {"device_ops": [list(o) for o in sorted(
                ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10]}


def report(args, cell, reports, cards):
    """The result line of the ranks' reports (rank order)."""

    from mdbench.harness import spec as specs
    from mdbench.run import emit

    first = reports[0]
    widest, limits = {}, first["limits"]
    for r in reports:
        for name, value in r["widest"].items():
            widest[name] = max(widest.get(name, value), value)
    correct = all(r["correct"] for r in reports)
    failed = max(r["failed"] for r in reports)
    if args.rehearse:
        return emit(cell, args, correct, first["passes"], failed, widest,
                    limits)
    metrics = {}
    device = {"platform": "gpu", "kind": first["kind"],
              "count": cell["chips"],
              "memory_peak_bytes": max(r["peak"] for r in reports)}
    breakdown = None
    if args.trace:
        traced = [r["traced"] for r in reports]
        device.update(busy_s=sum(t["busy_s"] for t in traced) / len(traced),
                      window_s=first["job_window_s"])
        ctx = {"ranks": traced, "frames": first["job_frames"],
               "window_s": first["job_window_s"]}
        for m in cell["per_layer"]:
            value = specs.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = merged_breakdown([t["breakdown"] for t in traced])
    else:
        for m in cell["end_to_end"]:
            if m["name"] == "setup_s":
                value = first["setup_s"]
            elif m["name"] == "job_frames_per_s":
                value = first["job_frames"] / first["job_window_s"]
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(f"card {cards}; ranks' set-up {[r['rank_setup_s'] for r in reports]}"
          f" s; job set-up {first['setup_s']!r} s; {first['passes']} passes "
          f"in {first['job_window_s']!r} s; peak {device['memory_peak_bytes']}"
          f" bytes; references {[r['reference_s'] for r in reports]} s",
          file=sys.stderr)
    return emit(cell, args, correct, first["passes"], failed, widest, limits,
                metrics, device, breakdown, {"card": cards, "ranks": reports})


def rank_main(job_path):
    """One rank of a job (the child process)."""

    with open(job_path) as f:
        job = json.load(f)
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from mdbench.harness import faults, judge, passes, trace
    from mdbench.harness import spec as specs
    from mdbench.run import forbidden_modules, quiet_collector, sized
    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.parallel.mesh import initialize_distributed

    rank, world = job["rank"], job["world"]
    config, traffic = sized(job["cell"], job["rehearse"])
    if job["rehearse"]:
        device, backend = torch.device("cpu"), "gloo"

        def sync():
            pass
    else:
        device, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(device)
        sync = torch.cuda.synchronize
        from mdhelper_tpu_torch.ops import _build

        _build.load_library()
    initialize_distributed(f"localhost:{job['port']}", world, rank,
                           backend=backend, timeout=120)
    wrap = faults.wrap(job["fault"]) if job["fault"] else None
    frames, dims = specs.generator(config["generator"]).make(
        config, int(traffic["pass_frames"]), job["seed"], device)
    universe = Universe.from_arrays(frames, dims, dt=1.0)

    def one_pass(on_chunk=None):
        return passes.run_pass(universe, traffic, config, device,
                               on_chunk=on_chunk, wrap=wrap, parallel=True)

    def stamps(start, end):
        """Every rank's (start, end) wall clocks of a pass."""

        out = [None] * world
        dist.all_gather_object(out, (start, end))
        return out

    n_frames = int(traffic["pass_frames"])
    n_chunks = -(-n_frames // int(traffic["chunk_frames"]))
    kept = []
    traced = None
    if job["trace"] and not job["rehearse"]:
        quiet_collector()
        rank_setup = time.time() - job["wall_started"]
        torch.cuda.reset_peak_memory_stats(device)
        started = []

        def barriered(on_chunk):
            if on_chunk is None:  # the traced pass starts on every rank
                dist.barrier()
                started.append(time.time())
            return one_pass(on_chunk)

        taken, records, seconds, _ = trace.traced_pass(barriered, n_chunks,
                                                       sync)
        kept.append(taken)
        all_stamps = stamps(started[-1], started[-1] + seconds)
        job_window = max(e for _, e in all_stamps) - min(
            s for s, _ in all_stamps)
        traced = {"busy_s": trace.busy_us([(a, b) for _, a, b in records])
                  / 1e6, "window_s": seconds,
                  "kernels": sum(trace.is_kernel(n) for n, _, _ in records),
                  "breakdown": trace.breakdown(records)}
        n_passes, setup = 1, None
    else:
        kept.append(one_pass())
        sync()
        quiet_collector()
        rank_setup = time.time() - job["wall_started"]
        if not job["rehearse"]:
            torch.cuda.reset_peak_memory_stats(device)
        first_start, n_passes = None, 0
        while True:
            dist.barrier()
            start = time.time()
            kept.append(one_pass())
            sync()
            all_stamps = stamps(start, time.time())
            n_passes += 1
            if first_start is None:
                first_start = min(s for s, _ in all_stamps)
            last_end = max(e for _, e in all_stamps)
            go_on = [last_end - first_start < job["seconds"]]
            dist.broadcast_object_list(go_on, src=0)
            if not go_on[0] or job["rehearse"]:
                break
        job_window = last_end - first_start
        setup = first_start - job["wall_started"]
        kept = kept[1:] if not job["rehearse"] else kept
    peak = (torch.cuda.max_memory_allocated(device)
            if not job["rehearse"] else 0)
    del one_pass
    if not job["rehearse"]:
        torch.cuda.empty_cache()
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"rank {rank} holds {leaked} after the window")
    began = time.perf_counter()
    answers = judge.wants(frames, dims, traffic, config, device)
    correct, failed, widest, limits = judge.verdict(kept, answers, traffic)
    reference_s = time.perf_counter() - began
    dist.barrier()
    dist.destroy_process_group()
    with open(job["out"], "w") as f:
        json.dump({"rank": rank, "correct": correct, "failed": failed,
                   "widest": widest, "limits": limits, "passes": n_passes,
                   "job_frames": n_frames * n_passes,
                   "job_window_s": job_window, "setup_s": setup,
                   "rank_setup_s": rank_setup, "peak": int(peak),
                   "reference_s": reference_s, "traced": traced,
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")}, f)


if __name__ == "__main__":
    rank_main(sys.argv[1])
