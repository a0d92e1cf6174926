"""The device trace of one pass, from ``torch.profiler``.

Copied from ``chip_smoke.py::run_profiled`` and ``busy_us`` at commit
f7f3e8cd0aa08483990a67085713f35a76e682d8: the profiler is warmed a chunk
ahead (``prepare_trace`` at the last chunk of the pass before, which
turns CUPTI's activity records on) and started at the traced pass, since
a profiler started cold drops the device records of the window's first
kernels.  Now and then it still drops a whole window's device records
while it keeps the host's launch calls: such a window goes again, three
tries at most, and then the run fails.
"""

import time

import numpy as np

TRIES = 3


def busy_us(intervals):
    """Length of the union of ``[start, end)`` intervals."""

    total, reach = 0.0, -np.inf
    for start, end in sorted(intervals):
        if end <= reach:
            continue
        total += end - max(start, reach)
        reach = end
    return total


def _us(event, what):
    """A kineto event's start or duration in us (``*_ns`` in newer torch,
    ``*_us`` in older)."""

    ns = getattr(event, f"{what}_ns", None)
    return ns() / 1e3 if ns is not None else getattr(event, f"{what}_us")()


def device_records(prof):
    """``[(name, start_us, end_us)]`` of every device activity (kernels,
    copies, sets) the profiler kept."""

    from torch.autograd import DeviceType

    out = []
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                start = _us(e, "start")
                out.append((e.name(), start, start + _us(e, "duration")))
        return out
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def traced_pass(run, n_chunks, sync):
    """``(results, records, window seconds)`` of one pass run under the
    profiler; `run(on_chunk)` runs one pass.  Each try runs a warming pass
    first, whose last chunk prepares the trace."""

    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRIES + 1):
        prof = profile(activities=[ProfilerActivity.CUDA])
        seen = [0]

        def on_chunk(batch):
            seen[0] += 1
            if seen[0] == n_chunks:
                prof.prepare_trace()

        run(on_chunk)
        sync()
        prof.start_trace()
        start = time.perf_counter()
        results = run(None)
        sync()
        seconds = time.perf_counter() - start
        prof.stop()
        records = device_records(prof)
        if records:
            return results, records, seconds, attempt
    raise RuntimeError(f"the profiler kept no device record in {TRIES} "
                       "traced passes")


def is_kernel(name):
    return not name.startswith(("Memcpy", "Memset"))


def breakdown(records):
    """The device operations that took most time and the longest idle
    gaps, each named by the operation that ended it: ``{"device_ops":
    [[name, seconds], ...], "idle_gaps": [[name, seconds], ...]}``, ten
    of each at most."""

    totals = {}
    for name, start, end in records:
        short = name if len(name) <= 160 else name[:157] + "..."
        totals[short] = totals.get(short, 0.0) + (end - start) / 1e6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    gaps, reach = [], None
    for name, start, end in sorted(records, key=lambda r: r[1]):
        if reach is not None and start > reach:
            short = name if len(name) <= 140 else name[:137] + "..."
            gaps.append((f"before {short}", (start - reach) / 1e6))
        reach = end if reach is None else max(reach, end)
    gaps = sorted(gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [list(o) for o in ops],
            "idle_gaps": [list(g) for g in gaps]}
