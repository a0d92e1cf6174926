r"""
Tracing and profiling
=====================

The port of :mod:`mdhelper_tpu.core.profiling`: a stage timer for the
streaming pipeline, a trace capture over :mod:`torch.profiler` (in place
of ``jax.profiler``) and the benchmark-grid pattern of the PME auto-tuner
(:func:`mdhelper_tpu_torch.openmm.utility.optimize_pme`) applied to
device launches.

The device runs asynchronously, so :func:`benchmark_grid` waits for the
devices of the tensors a call returns before it stops the clock, and
:func:`trace` waits for the device before it closes its window.
"""

import contextlib
import logging
import os
import platform
import time
from typing import Callable, Iterable

__all__ = ["Timer", "trace", "benchmark_grid"]


class Timer:
    """Accumulating wall-clock timer for named pipeline stages.

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
    CUDA device is present.  A profiler started cold drops the device
    records of its window's first kernels now and then, so CUPTI's
    activity records are turned on (``prepare_trace``) and warmed by one
    small launch before the window opens.  `host_profile` is accepted as
    in the JAX package, where it is unused too."""

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
        logging.info(f"Wrote device trace to {path}.")


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
