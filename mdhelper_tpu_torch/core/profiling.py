r"""
Tracing and profiling
=====================

The port of :mod:`mdhelper_tpu.core.profiling`: a stage timer for the
streaming pipeline, a trace capture over :mod:`torch.profiler` (in place
of ``jax.profiler``) and the benchmark-grid pattern of the PME auto-tuner
(:func:`mdhelper_tpu_torch.openmm.utility.optimize_pme`) applied to
device launches.

Host spans
----------
:func:`span` marks a stretch of host work inside the pipeline (a chunk's
fold, a store's copy, a conclusion).  While a :mod:`torch.profiler`
window is open (between its ``start_trace()`` and ``stop()``, in any
thread of the process), each span appends one record to a process-wide
collector: its ``name``, ``start_ns`` and ``end_ns`` on
:func:`time.time_ns` (the Unix-epoch clock on which the profiler's own
events lie), the ``index`` of its ``parent`` (the span open around it on
the same thread), the ``pass`` it belongs to (the index of the outermost
span open on that thread) and its keyword ``attrs``.  Outside such a
window a span is one shared no-op: one flag read, no clock read, no
record.  The records never reach the profiler, so its device records are
the same with spans as without.  :func:`pass_spans` returns the newest
pass's records; the collector keeps the newest ``_KEPT_PASSES`` passes.
:class:`Timer` stages are spans too.

The device runs asynchronously, so :func:`benchmark_grid` waits for the
devices of the tensors a call returns before it stops the clock, and
:func:`trace` waits for the device before it closes its window.
"""

import contextlib
import itertools
import json
import logging
import os
import platform
import threading
import time
from typing import Callable, Iterable

import torch.autograd.profiler as _autograd_profiler

__all__ = ["Timer", "trace", "benchmark_grid", "span", "pass_spans"]

#: passes whose spans the collector keeps (a traced run of the benchmark
#: takes three at most).
_KEPT_PASSES = 4


class _Collector:
    """The process's span records, in the order the spans opened, and
    each thread's stack of open spans."""

    def __init__(self):
        self.records: list[dict] = []
        self._indices = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            self._local.thread = threading.get_native_id()
        return stack

    def open(self, name: str, attrs: dict) -> dict:
        stack = self._stack()
        index = next(self._indices)
        parent = stack[-1] if stack else None
        record = {
            "index": index, "name": name, "start_ns": None, "end_ns": None,
            "parent": None if parent is None else parent["index"],
            "pass": index if parent is None else parent["pass"],
            "thread": self._local.thread, "attrs": attrs,
        }
        with self._lock:
            if parent is None and name == "pass":
                self._drop_old_passes()
            self.records.append(record)
        stack.append(record)
        record["start_ns"] = time.time_ns()
        return record

    def close(self, record: dict) -> None:
        record["end_ns"] = time.time_ns()
        stack = self._stack()
        while stack and stack.pop() is not record:
            pass

    def _drop_old_passes(self) -> None:
        """Drop the records older than the newest ``_KEPT_PASSES - 1``
        passes, as a new one opens."""

        roots = [i for i, r in enumerate(self.records)
                 if r["parent"] is None and r["name"] == "pass"]
        keep = _KEPT_PASSES - 1
        if len(roots) > keep:
            del self.records[:roots[-keep]]

    def newest_pass(self) -> list[dict]:
        with self._lock:
            records = list(self.records)
        for root in reversed(records):
            if root["parent"] is None and root["name"] == "pass":
                return [dict(r) for r in records
                        if r["pass"] == root["index"]]
        return []

    def between(self, start_ns: int, end_ns: int) -> list[dict]:
        with self._lock:
            records = list(self.records)
        return [dict(r) for r in records if r["end_ns"] is not None
                and start_ns <= r["start_ns"] and r["end_ns"] <= end_ns]


_COLLECTOR = _Collector()


class _Span:
    """A span being recorded: opened on entry, closed on exit."""

    __slots__ = ("_name", "_attrs", "_record")

    def __init__(self, name: str, attrs: dict):
        self._name, self._attrs = name, attrs

    def __enter__(self):
        self._record = _COLLECTOR.open(self._name, self._attrs)
        return self

    def __exit__(self, *exc):
        _COLLECTOR.close(self._record)
        return False


class _NoSpan:
    """The span of an unprofiled stretch: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context manager that records the host's stretch of work inside
    it as the span `name` with attributes `attrs` (such as
    ``analysis="StructureFactor"``, ``frames=8``, ``bytes=...``), while a
    :mod:`torch.profiler` window is open; otherwise it does nothing.

    Usage::

        with profiling.span("fold", analysis="RDF", frames=8):
            carry = update(carry, positions)
    """

    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def pass_spans() -> list[dict]:
    """The records of the newest pass recorded under the profiler (the
    spans whose outermost span is a ``pass``), its root first, in the
    order they opened; ``[]`` when none was.  Each record is a dict of
    ``index``, ``name``, ``start_ns``, ``end_ns`` (``None`` while open),
    ``parent`` (an index, ``None`` at the root), ``pass`` (the root's
    index), ``thread`` (the native thread id) and ``attrs``."""

    return _COLLECTOR.newest_pass()


class Timer:
    """Accumulating wall-clock timer for named pipeline stages; each
    stage is also a :func:`span` of its name.

    Usage::

        timer = Timer()
        with timer("read"):
            ...
        with timer("update"):
            ...
        print(timer.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        start = time.perf_counter()
        try:
            with span(stage):
                yield
        finally:
            elapsed = time.perf_counter() - start
            self.totals[stage] = self.totals.get(stage, 0.0) + elapsed
            self.counts[stage] = self.counts.get(stage, 0) + 1

    def report(self) -> str:
        lines = [
            f"  {stage:<24} {self.totals[stage]:10.4f} s "
            f"({self.counts[stage]:>6} calls)"
            for stage in sorted(
                self.totals, key=self.totals.get, reverse=True
            )
        ]
        return "pipeline stage timings:\n" + "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str, *, host_profile: bool = False):
    """Capture a :mod:`torch.profiler` trace around a block of analysis
    work and write it into `log_dir` as a Chrome trace
    (``{host}.{pid}.{ns}.pt.trace.json``, viewable in Perfetto or
    TensorBoard).

    The host's activities are always recorded, and the device's when a
    CUDA device is present.  The host :func:`span` records of the window
    (the pipeline's passes, chunk waits, folds, stores, conclusions) are
    written into the same file as complete events of category ``span``,
    on their thread's row and on the time base of the profiler's own
    events, so they show beside the kernels they launched.  A profiler
    started cold drops the device records of its window's first kernels
    now and then, so CUPTI's activity records are turned on
    (``prepare_trace``) and warmed by one small launch before the window
    opens.  `host_profile` is accepted as in the JAX package, where it
    is unused too."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.prepare_trace()
    if cuda:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    opened = time.time_ns()
    prof.start_trace()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop_trace()
        path = os.path.join(
            log_dir,
            f"{platform.node()}.{os.getpid()}.{time.time_ns()}"
            ".pt.trace.json",
        )
        prof.export_chrome_trace(path)
        _add_spans(path, _COLLECTOR.between(opened, time.time_ns()))
        logging.info(f"Wrote device trace to {path}.")


def _add_spans(path: str, records: list[dict]) -> None:
    """Append `records` to the Chrome trace at `path` as complete events
    (``ph`` "X") in microseconds since its ``baseTimeNanoseconds``, the
    base of its own events' ``ts``."""

    if not records:
        return
    with open(path) as f:
        chrome = json.load(f)
    base = int(chrome.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    chrome["traceEvents"].extend(
        {"ph": "X", "cat": "span", "name": r["name"], "pid": pid,
         "tid": r["thread"], "ts": (r["start_ns"] - base) / 1e3,
         "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
         "args": {k: v if isinstance(v, (int, float, str)) else str(v)
                  for k, v in r["attrs"].items()}}
        for r in records)
    with open(path, "w") as f:
        json.dump(chrome, f)


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in `out`, at any depth of its
    tuples, lists and dicts."""

    import torch

    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in out))
    return set()


def _wait(out) -> None:
    """Wait until the devices of the CUDA tensors in `out` are done."""

    import torch

    for device in _cuda_devices(out):
        torch.cuda.synchronize(device)


def _context_alive() -> bool:
    """False when the CUDA context holds a sticky error (an illegal
    address, a launch failure), which every later call raises again."""

    import torch

    if not torch.cuda.is_initialized():
        return True
    try:
        torch.cuda.synchronize()
    except Exception:
        return False
    return True


def benchmark_grid(
    build: Callable[..., Callable],
    configs: Iterable[dict],
    *args,
    warmup: int = 1,
    repeats: int = 3,
) -> tuple[dict, list[tuple[float, dict]]]:
    """Benchmark a grid of kernel configurations and pick the fastest --
    the PME-tuner pattern applied to (e.g.) a kernel's frame batch.

    Each timed call ends when the devices of the tensors it returns are
    done, so the times are of the work, not of its launch.  A
    configuration that raises is logged and skipped when the device is
    still usable (a launch refused for its resources, an allocation that
    does not fit); an error that leaves the CUDA context unusable is
    raised, since every later time would be of a dead device.

    Parameters
    ----------
    build : callable
        ``build(**config)`` returns the callable to time.
    configs : iterable of `dict`
        Configurations to sweep.
    *args
        Arguments passed to each built callable.
    warmup, repeats : `int`
        Warmup runs (builds, caches) and timed repeats (median taken).

    Returns
    -------
    best : `dict`
        The fastest configuration.
    ranking : `list`
        ``(median_seconds, config)`` pairs, fastest first.
    """

    ranking = []
    for config in configs:
        fn = build(**config)
        try:
            for _ in range(warmup):
                _wait(fn(*args))
            times = []
            for _ in range(repeats):
                start = time.perf_counter()
                _wait(fn(*args))
                times.append(time.perf_counter() - start)
            times.sort()
            ranking.append((times[len(times) // 2], dict(config)))
        except Exception as exc:
            if not _context_alive():
                raise
            logging.debug(f"config {config} failed: {exc}")
    if not ranking:
        raise RuntimeError("No benchmark configuration succeeded.")
    ranking.sort(key=lambda pair: pair[0])
    return ranking[0][1], ranking
