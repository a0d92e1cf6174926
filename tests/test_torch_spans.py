"""The port's host spans (``core.profiling.span``) in the streaming
pipeline, on the CPU; the last test needs a card and skips without one.

A span is recorded only while a ``torch.profiler`` window is open, on the
profiler's own clock, and never reaches the profiler's records.  These
tests hold the records of a small fused pass (RDF + factor S(q) +
unwrapped Onsager) to the pipeline's structure, the results to those of
an unrecorded pass, and the clock to the profiler's events.  The card's
test is run with ``python -m pytest tests/test_torch_spans.py -m cuda``.
"""

import json
import os
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import (  # noqa: E402
    ProfilerActivity,
    profile,
    record_function,
)

from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
    StructureFactor,
)
from mdhelper_tpu_torch.analysis.transport import Onsager  # noqa: E402
from mdhelper_tpu_torch.core import profiling  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N_ATOMS, N_FRAMES, BOX, CHUNK = 300, 12, 10.0, 4


def universe():
    rng = np.random.default_rng(7)
    start = rng.random((N_ATOMS, 3)) * BOX
    walk = np.cumsum(rng.normal(0.0, 0.1, (N_FRAMES, N_ATOMS, 3)), axis=0)
    dims = np.tile([BOX, BOX, BOX, 90.0, 90.0, 90.0], (N_FRAMES, 1))
    return Universe.from_arrays(((start + walk) % BOX).astype(np.float32),
                                dims.astype(np.float32))


def fused_set(u, device="cpu", prefetch=True):
    analyses = [
        RadialDistributionFunction(u.atoms, n_bins=20, range=(0.0, 3.0),
                                   exclusion=(1, 1), verbose=False,
                                   device=device),
        StructureFactor(u.atoms, n_points=4, method="factor",
                        precision="exact", verbose=False, device=device),
        Onsager(u.atoms, unwrap=True, verbose=False, device=device),
    ]
    for a in analyses:
        a._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
        a._prefetch_batches = prefetch
    return analyses


def profiler(activities=(ProfilerActivity.CPU,)):
    """A started profiler window, as the benchmark's traced pass opens
    one."""

    prof = profile(activities=list(activities))
    prof.prepare_trace()
    prof.start_trace()
    return prof


def traced(run):
    prof = profiler()
    try:
        out = run()
    finally:
        prof.stop()
    return out, profiling.pass_spans()


def results(analyses):
    return [{key: np.array(value) for key, value in a.results.items()
             if isinstance(value, (np.ndarray, torch.Tensor))}
            for a in analyses]


@pytest.fixture(scope="module")
def fused_spans():
    analyses, spans = traced(lambda: run_together(fused_set(universe())))
    return analyses, spans


def check_tree(spans):
    """One root ``pass``; every other span's parent is an earlier span of
    the pass and encloses it; every span shares the root's pass id."""

    by_index = {s["index"]: s for s in spans}
    root = spans[0]
    assert root["name"] == "pass" and root["parent"] is None
    for s in spans:
        assert s["pass"] == root["index"]
        assert s["start_ns"] <= s["end_ns"]
        if s is root:
            continue
        parent = by_index[s["parent"]]
        assert parent["index"] < s["index"]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]


def test_fused_pass_records_its_spans(fused_spans):
    _, spans = fused_spans
    check_tree(spans)
    names = Counter(s["name"] for s in spans)
    chunks = -(-N_FRAMES // CHUNK)
    assert names["pass"] == 1
    assert names["prepare"] == names["conclude"] == 3
    assert names["stream.wait"] == chunks
    assert names["fold"] == 3 * chunks
    # Onsager stores a chunk's displacements; every analysis drains its
    # queue at the end, and each queue drains the chunk before it.
    assert names["store.queue"] == chunks
    assert names["store.drain"] == chunks + 3
    assert names["unwrap.edge"] == 1 and names["plan.cells"] == 1
    assert names["plan.slots"] == chunks
    root = spans[0]
    assert root["attrs"] == {
        "analyses": "RadialDistributionFunction,StructureFactor,Onsager",
        "frames": N_FRAMES}


def test_fused_spans_carry_their_attributes(fused_spans):
    _, spans = fused_spans
    by_index = {s["index"]: s for s in spans}
    waits = [s for s in spans if s["name"] == "stream.wait"]
    assert [s["attrs"]["chunk"] for s in waits] == [0, 1, 2]
    assert sum(s["attrs"]["frames"] for s in waits) == N_FRAMES
    folds = [s for s in spans if s["name"] == "fold"]
    assert [s["attrs"]["analysis"] for s in folds[:3]] == [
        "RadialDistributionFunction", "StructureFactor", "Onsager"]
    assert sum(s["attrs"]["frames"] for s in folds) == 3 * N_FRAMES
    # Onsager's store: a chunk of float32 unwrapped positions, queued
    # outside its fold.
    for s in spans:
        if s["name"] == "store.queue":
            assert s["attrs"]["bytes"] == CHUNK * N_ATOMS * 3 * 4
            assert by_index[s["parent"]]["name"] == "pass"
    parents = {s["name"]: by_index[s["parent"]] for s in spans
               if s["name"] in ("unwrap.edge", "plan.cells", "plan.slots")}
    assert parents["unwrap.edge"]["name"] == "prepare"
    assert parents["unwrap.edge"]["attrs"]["analysis"] == "Onsager"
    assert spans[[s["name"] for s in spans].index("unwrap.edge")][
        "attrs"] == {"atoms": N_ATOMS}
    assert parents["plan.cells"]["attrs"]["analysis"] == (
        "RadialDistributionFunction")
    assert parents["plan.slots"]["name"] == "fold"


def test_spans_leave_results_unchanged(fused_spans):
    on, _ = fused_spans
    off = run_together(fused_set(universe()))
    for a, b in zip(results(on), results(off)):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_nothing_is_recorded_without_the_profiler(fused_spans):
    before = profiling.pass_spans()
    count = len(profiling._COLLECTOR.records)
    run_together(fused_set(universe()))
    StructureFactor(universe().atoms, n_points=4, method="factor",
                    verbose=False, device="cpu").run()
    assert profiling.span("fold") is profiling.span("pass", frames=1)
    assert len(profiling._COLLECTOR.records) == count
    assert profiling.pass_spans() == before


def test_inline_staging_is_the_streams_wait():
    """With prefetch off, each chunk's staging on the calling thread is
    its ``stream.wait``."""

    _, spans = traced(lambda: run_together(
        fused_set(universe(), prefetch=False)))
    check_tree(spans)
    waits = [s for s in spans if s["name"] == "stream.wait"]
    assert [s["attrs"]["chunk"] for s in waits] == [0, 1, 2]
    assert all(s["parent"] == spans[0]["index"] for s in waits)


def test_run_is_a_pass_of_one_analysis():
    u = universe()
    sf = StructureFactor(u.atoms, n_points=4, method="factor",
                         verbose=False, device="cpu")
    sf._chunk_bytes = CHUNK * N_ATOMS * 3 * 4
    _, spans = traced(sf.run)
    check_tree(spans)
    names = Counter(s["name"] for s in spans)
    assert spans[0]["attrs"] == {"analyses": "StructureFactor",
                                 "frames": N_FRAMES}
    assert names["prepare"] == names["conclude"] == 1
    assert names["fold"] == names["stream.wait"] == 3


def test_a_cached_plan_is_no_plan_span():
    u = universe()
    rdf = RadialDistributionFunction(u.atoms, n_bins=20, range=(0.0, 3.0),
                                     verbose=False, device="cpu")
    _, first = traced(rdf.run)
    _, second = traced(rdf.run)
    assert [s["name"] for s in first].count("plan.cells") == 1
    assert [s["name"] for s in second].count("plan.cells") == 0
    assert second[0]["index"] > first[0]["index"]


def test_span_brackets_a_profiler_event():
    """A span and the profiler's events are on one clock: a
    ``record_function`` inside a span lies inside it."""

    prof = profiler()
    with profiling.span("pass"):
        with profiling.span("fold"):
            with record_function("inner"):
                torch.ones(256).cumsum(0)
    prof.stop()
    fold = [s for s in profiling.pass_spans() if s["name"] == "fold"][0]
    inner = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner"][0]
    start = inner.start_ns()
    end = start + inner.duration_ns()
    assert fold["start_ns"] <= start <= end <= fold["end_ns"]


def test_timer_stages_are_spans():
    timer = profiling.Timer()
    prof = profiler()
    with profiling.span("pass"):
        with timer("read"):
            with timer("decode"):
                pass
        with timer("read"):
            pass
    prof.stop()
    with timer("read"):
        pass
    assert timer.counts == {"read": 3, "decode": 1}
    assert set(timer.totals) == {"read", "decode"}
    assert "(     3 calls)" in timer.report()
    spans = profiling.pass_spans()
    assert [s["name"] for s in spans] == ["pass", "read", "decode", "read"]
    assert spans[2]["parent"] == spans[1]["index"]


def test_collector_keeps_the_newest_passes():
    prof = profiler()
    for i in range(profiling._KEPT_PASSES + 2):
        with profiling.span("pass", n=i):
            with profiling.span("fold"):
                pass
    prof.stop()
    kept = [r["attrs"]["n"] for r in profiling._COLLECTOR.records
            if r["parent"] is None]
    assert kept == list(range(2, profiling._KEPT_PASSES + 2))
    assert [s["name"] for s in profiling.pass_spans()] == ["pass", "fold"]
    assert profiling.pass_spans()[0]["attrs"] == {
        "n": profiling._KEPT_PASSES + 1}


def test_trace_writes_spans_on_the_events_time_base(tmp_path):
    """``trace()`` adds its window's spans to the Chrome trace, on the
    time base of the profiler's own events."""

    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        with profiling.span("pass", frames=2):
            with profiling.span("fold", analysis="A"):
                torch.ones(64).cumsum(0)
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert set(spans) == {"pass", "fold"}
    assert spans["fold"]["args"] == {"analysis": "A"}
    cumsum = [e for e in events
              if "cumsum" in e.get("name", "") and e.get("ph") == "X"][0]
    fold = spans["fold"]
    assert fold["ts"] <= cumsum["ts"]
    assert cumsum["ts"] + cumsum["dur"] <= fold["ts"] + fold["dur"]
    assert fold["tid"] == cumsum["tid"]


@pytest.mark.cuda
def test_spans_on_the_card(monkeypatch):
    """A span around a launch and its synchronisation brackets the
    kernel's device record, and a traced pass's device records have the
    same names with spans recorded and without."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", 0)
    x = torch.ones(1 << 20, device=device)
    torch.cuda.synchronize()
    prof = profiler((ProfilerActivity.CUDA,))
    with profiling.span("pass"):
        with profiling.span("fold"):
            x.mul_(3.0)
            torch.cuda.synchronize()
    prof.stop()
    fold = [s for s in profiling.pass_spans() if s["name"] == "fold"][0]
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert kernels
    for e in kernels:
        assert fold["start_ns"] <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= fold["end_ns"]

    u = universe()

    def names():
        run_together(fused_set(u, device=device))
        torch.cuda.synchronize()
        prof = profiler((ProfilerActivity.CUDA,))
        run_together(fused_set(u, device=device))
        torch.cuda.synchronize()
        prof.stop()
        return {e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA}

    recorded = names()
    monkeypatch.setattr(profiling, "span",
                        lambda name, **attrs: profiling._NO_SPAN)
    assert names() == recorded
