"""The span readers and ``harness/spans.py`` against numbers worked by
hand on a synthetic pass, and against the program's own recorder on a
small pass on the CPU."""

import numpy as np
import pytest

from mdbench.harness import spans as sp
from mdbench.harness import spec as specs

#: the Unix-epoch origin of the synthetic pass, in ns.
BASE = 1_790_000_000_000_000_000
MS = 1_000_000


def span(index, name, start_ms, end_ms, parent=0, **attrs):
    return {"index": index, "name": name,
            "start_ns": BASE + int(start_ms * MS),
            "end_ns": BASE + int(end_ms * MS), "parent": parent, "pass": 0,
            "thread": 1, "attrs": attrs}


#: a pass of 16 frames in two chunks (times in ms from its start).
SPANS = [
    span(0, "pass", 0, 100, parent=None, analyses="SF,RDF", frames=16),
    span(1, "prepare", 0, 10, analysis="RDF"),
    span(2, "unwrap.edge", 2, 6, parent=1, atoms=10),
    span(3, "plan.cells", 7, 8, parent=1),
    span(4, "stream.wait", 10, 12, chunk=0, frames=8),
    span(5, "fold", 12, 30, analysis="StructureFactor", frames=8),
    span(6, "fold", 30, 40, analysis="RDF", frames=8),
    span(7, "plan.slots", 31, 33, parent=6),
    span(8, "store.queue", 40, 44, bytes=96),
    span(9, "store.drain", 41, 43, parent=8),
    span(10, "stream.wait", 50, 51, chunk=1, frames=8),
    span(11, "fold", 51, 70, analysis="StructureFactor", frames=8),
    span(12, "fold", 70, 75, analysis="RDF", frames=8),
    span(13, "plan.slots", 71, 72, parent=12),
    span(14, "store.queue", 75, 77, bytes=96),
    span(15, "store.drain", 75.5, 76.5, parent=14),
    span(16, "store.drain", 80, 81),
    span(17, "conclude", 85, 95, analysis="RDF"),
]


def us(ms):
    """`ms` from the pass's start as a device record's time, in us since
    the epoch."""

    return BASE / 1e3 + ms * 1e3


#: busy on the device over [15, 45) and [60, 80) ms.
RECORDS = [("kernelA", us(15), us(45)), ("kernelB", us(60), us(70)),
           ("Memcpy DtoH (Device -> Pinned)", us(65), us(80))]


def read(name, spans=SPANS, records=RECORDS, monkeypatch=None):
    monkeypatch.setattr(sp, "pass_spans", lambda: spans)
    return specs.metric_reader(name).read(
        {"records": records, "window_s": 0.1, "frames": 16, "passes": 1})


#: each reader's value on SPANS and RECORDS, worked by hand.
BY_HAND = {
    # waits of 2 and 1 ms over 2 chunks
    "stream_wait_ms_per_chunk": 1.5,
    # the stores' outermost spans, 4 + 2 + 1 ms, over 2 chunks
    "store_ms_per_chunk": 3.5,
    # folds' self time 18 + (10 - 2) + 19 + (5 - 1) = 49 ms over 16 frames
    "fold_ms_per_frame": 49 / 16,
    # StructureFactor's folds, 18 + 19 ms, over 16 frames
    "sq_fold_ms_per_frame": 37 / 16,
    # 10 ms less the unwrap's 4 and the plan's 1
    "prepare_s_per_pass": 0.005,
    "unwrap_edge_s_per_pass": 0.004,
    # plan.cells 1 ms, plan.slots 2 + 1 ms
    "cell_plan_ms_per_pass": 4.0,
    "conclude_s_per_pass": 0.010,
    # idle [0, 15) + [45, 60) + [80, 100) = 50 ms; under a span [0, 15),
    # [50, 60), [80, 81) and [85, 95): 36 ms
    "idle_attributed_pct": 72.0,
}


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_reader_by_hand(name, monkeypatch):
    assert read(name, monkeypatch=monkeypatch) == pytest.approx(
        BY_HAND[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_reader_without_spans_is_none(name, monkeypatch):
    """A program that records no span (an older one, or one without the
    recorder) gives no value, and the reader does not raise."""

    assert read(name, spans=[], monkeypatch=monkeypatch) is None


def test_every_span_reader_has_its_entry():
    bench = specs.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in BY_HAND:
        assert entries[name]["source"] == "program_span"
        assert entries[name]["moves"] == "frames_per_s"


def test_sq_fold_without_structure_factor_is_none(monkeypatch):
    spans = [s for s in SPANS
             if s["attrs"].get("analysis") != "StructureFactor"]
    assert read("sq_fold_ms_per_frame", spans=spans,
                monkeypatch=monkeypatch) is None
    assert read("fold_ms_per_frame", spans=spans,
                monkeypatch=monkeypatch) == pytest.approx(12 / 16)


def test_idle_attribution_without_records_is_none(monkeypatch):
    assert read("idle_attributed_pct", records=[],
                monkeypatch=monkeypatch) is None


def test_self_seconds_by_hand():
    own = sp.self_seconds(SPANS)
    assert own[1] == pytest.approx(0.005)
    assert own[6] == pytest.approx(0.008)
    assert own[8] == pytest.approx(0.002)
    assert own[9] == pytest.approx(0.002)
    # the root less everything under it: [0, 44), [50, 77), [80, 81) and
    # [85, 95) cover 82 ms
    assert own[0] == pytest.approx(0.018)


def test_union_and_overlap():
    assert sp.union([(5, 7), (0, 2), (1, 3), (3, 4), (9, 9)]) == [
        [0, 4], [5, 7]]
    assert sp.overlap([[0, 4], [5, 7]], [[3, 6], [6.5, 10]]) == \
        pytest.approx(1 + 1 + 0.5)
    assert sp.overlap([], [[0, 1]]) == 0.0


def test_idle_intervals_clip_records_to_the_pass():
    records = RECORDS + [("early", us(-5), us(2))]
    idle = sp.idle_intervals(SPANS, records)
    ms = [[(t - us(0)) / 1e3 for t in gap] for gap in idle]
    assert ms == [pytest.approx(g, abs=1e-3)
                  for g in ([2, 15], [45, 60], [80, 100])]


def test_longest_idle_gaps_name_their_innermost_span():
    gaps = sp.longest_idle_gaps(SPANS, RECORDS, n=2)
    # [80, 100) at 90 ms is under conclude; [0, 15) at 7.5 ms under
    # plan.cells, inside prepare
    assert [name for _, _, name, _ in gaps] == ["conclude", "plan.cells"]
    assert [(s, at) for s, at, _, _ in gaps] == [
        pytest.approx((0.020, 0.080), abs=1e-6),
        pytest.approx((0.015, 0.0), abs=1e-6)]
    assert sp.innermost(SPANS, us(47))["name"] == "pass"


def test_readers_on_the_programs_own_spans():
    """A small fused pass on the CPU under the profiler: every reader
    finds its spans in the program's recorder."""

    pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile

    from mdhelper_tpu_torch.analysis.multi import run_together
    from mdhelper_tpu_torch.analysis.structure import (
        RadialDistributionFunction,
        StructureFactor,
    )
    from mdhelper_tpu_torch.analysis.transport import Onsager
    from mdhelper_tpu_torch.core.universe import Universe

    rng = np.random.default_rng(5)
    n, frames, box = 200, 8, 9.0
    pos = (rng.random((n, 3)) * box
           + np.cumsum(rng.normal(0, 0.1, (frames, n, 3)), axis=0)) % box
    dims = np.tile([box] * 3 + [90.0] * 3, (frames, 1))
    u = Universe.from_arrays(pos.astype(np.float32), dims.astype(np.float32))
    analyses = [
        RadialDistributionFunction(u.atoms, n_bins=10, range=(0.0, 3.0),
                                   verbose=False, device="cpu"),
        StructureFactor(u.atoms, n_points=3, method="factor",
                        verbose=False, device="cpu"),
        Onsager(u.atoms, unwrap=True, verbose=False, device="cpu")]
    for a in analyses:
        a._chunk_bytes = 4 * n * 12
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.prepare_trace()
    prof.start_trace()
    run_together(analyses)
    prof.stop()
    spans = sp.pass_spans()
    top = sp.root(spans)
    lo, hi = top["start_ns"] / 1e3, top["end_ns"] / 1e3
    # a device busy over the pass's middle half
    records = [("kernel", lo + (hi - lo) / 4, hi - (hi - lo) / 4)]
    ctx = {"records": records, "window_s": 1.0, "frames": frames,
           "passes": 1}
    for name in BY_HAND:
        value = specs.metric_reader(name).read(ctx)
        assert value is not None and value >= 0, name
    assert specs.metric_reader("idle_attributed_pct").read(ctx) <= 100
