"""Whether a run's passes are correct: the program's results against the
plain references, each number compared against its limit.

Each analysis entry of the traffic names its reference kind
(``mdbench/reference/<kind>.py``).  Every pass of the window is judged;
a number is the widest a pass gave, and the run is correct when every
number of every pass is within its limit (the traffic's ``limits``).
"""

import torch

from mdbench.harness import spec as specs
from mdbench.harness.passes import resolved


def wants(frames, dimensions, traffic, config, device,
          dtype=torch.float64):
    """The references' answers, one an analysis entry."""

    out = []
    for entry in traffic["analyses"]:
        ref = specs.reference(entry["reference"])
        spec = dict(entry, kwargs=resolved(entry, config))
        out.append(ref.expected(frames, dimensions, spec, device, dtype))
    return out


def numbers(taken, answers, traffic):
    """The compared numbers of one pass's results `taken`."""

    out = {}
    for got, want, entry in zip(taken, answers, traffic["analyses"]):
        out.update(specs.reference(entry["reference"]).judge(got, want))
    return out


def verdict(passes, answers, traffic):
    """``(correct, failed passes, {name: widest number}, limits)`` over
    the results of every judged pass."""

    limits = traffic["limits"]
    widest, failed = {}, 0
    for taken in passes:
        got = numbers(taken, answers, traffic)
        bad = False
        for name, value in got.items():
            widest[name] = max(widest.get(name, value), value)
            limit = limits.get(name)
            bad = bad or limit is None or not value <= limit
        failed += int(bad)
    correct = failed == 0 and bool(passes) and all(
        name in widest for name in limits)
    return correct, failed, widest, limits


def lines(widest, limits):
    """One plain line a compared number: its name, value and limit."""

    return [f"{name} {widest.get(name)!r} limit {limits.get(name)!r}"
            for name in sorted(set(widest) | set(limits))]
