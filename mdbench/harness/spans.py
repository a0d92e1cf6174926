"""The program's host spans of the traced pass, and the arithmetic the
span readers (``mdbench/metrics/*``, source ``program_span``) share.

While the profiler is on, the program records a span at each of its
layer boundaries (``mdhelper_tpu_torch.core.profiling.span``): the root
``pass`` of a ``run_together`` or ``run()``, and under it ``prepare``,
``unwrap.edge``, ``plan.cells``, ``plan.slots``, ``stream.wait``,
``fold``, ``store.queue``, ``store.drain`` and ``conclude``.  A record
is a dict with ``index``, ``name``, ``start_ns`` and ``end_ns`` (on
``time.time_ns()``, the Unix-epoch clock of the profiler's events),
``parent`` (an index; ``None`` at the root), ``pass`` and ``attrs``.
The device records of the traced pass (``trace.device_records``) are
``(name, start_us, end_us)`` on the same clock, in microseconds.

A program without the recorder gives no spans: then every reader returns
``None``, and the run's result line leaves its metric out.
"""

from mdbench.harness.trace import busy_us


def pass_spans():
    """The newest pass's span records, the root first; ``[]`` when the
    program records none (or has no recorder)."""

    try:
        from mdhelper_tpu_torch.core import profiling
    except ImportError:
        return []
    newest = getattr(profiling, "pass_spans", None)
    return newest() if newest is not None else []


def root(spans):
    """The pass's root span (the one without a parent), or ``None``."""

    return next((s for s in spans if s["parent"] is None), None)


def named(spans, *names):
    """The spans called one of `names`, in the order they opened."""

    return [s for s in spans if s["name"] in names]


def seconds(span):
    return (span["end_ns"] - span["start_ns"]) / 1e9


def interval_us(span):
    """The span's ``(start, end)`` in us since the epoch, as the device
    records are: integer nanoseconds over 1000 round once, where a float
    of them would already be 256 ns off."""

    return span["start_ns"] / 1000, span["end_ns"] / 1000


def union(intervals):
    """The union of ``[start, end)`` intervals as sorted, disjoint
    ``[start, end]`` lists."""

    out = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def overlap(a, b):
    """Length of the intersection of two sorted, disjoint interval
    lists (as :func:`union` returns)."""

    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_seconds(spans):
    """``{index: seconds}``: each span's duration less the part of it
    its child spans cover."""

    children = {}
    for s in spans:
        if s["parent"] is not None:
            children.setdefault(s["parent"], []).append(
                (s["start_ns"], s["end_ns"]))
    out = {}
    for s in spans:
        lo, hi = s["start_ns"], s["end_ns"]
        covered = busy_us([(max(a, lo), min(b, hi))
                           for a, b in children.get(s["index"], ())
                           if min(b, hi) > max(a, lo)])
        out[s["index"]] = (hi - lo - covered) / 1e9
    return out


def total_self(spans, *names, where=None):
    """Self seconds summed over the spans called one of `names` (and,
    with `where`, those for which ``where(span)`` holds)."""

    own = self_seconds(spans)
    return sum(own[s["index"]] for s in named(spans, *names)
               if where is None or where(s))


def idle_intervals(spans, records):
    """The device's idle intervals inside the root span, in us: the root's
    interval less the union of the device records."""

    lo, hi = interval_us(root(spans))
    busy = union((max(s, lo), min(e, hi)) for _, s, e in records)
    idle, reach = [], lo
    for start, end in busy:
        if start > reach:
            idle.append([reach, start])
        reach = max(reach, end)
    if hi > reach:
        idle.append([reach, hi])
    return idle


def attributed_pct(spans, records):
    """The share of the device's idle time inside the root span that
    lies under some other span, in %; ``None`` without spans, records or
    idle time."""

    if not spans or not records or root(spans) is None:
        return None
    idle = idle_intervals(spans, records)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    under = union(interval_us(s) for s in spans if s["parent"] is not None)
    return 100.0 * overlap(idle, under) / total


def innermost(spans, t_us):
    """The deepest span open at `t_us` (the root if no other is)."""

    depth, best = {}, None
    for s in spans:
        d = 0 if s["parent"] is None else depth.get(s["parent"], 0) + 1
        depth[s["index"]] = d
        start, end = interval_us(s)
        if start <= t_us < end and (best is None
                                    or d >= depth[best["index"]]):
            best = s
    return best


def longest_idle_gaps(spans, records, n=10):
    """The `n` longest idle intervals inside the root span, longest
    first: ``[(seconds, start in s from the root's start, name of the
    innermost span at the gap's middle, its attrs)]``."""

    if not spans or root(spans) is None:
        return []
    lo = interval_us(root(spans))[0]
    gaps = sorted(idle_intervals(spans, records), key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        s = innermost(spans, (a + b) / 2)
        out.append(((b - a) / 1e6, (a - lo) / 1e6, s["name"], s["attrs"]))
    return out
