"""The roofline arithmetic and the per-layer readers against numbers
worked by hand."""

import numpy as np
import pytest

from mdbench.harness import roofline
from mdbench.harness import spec as specs


def test_pair_histogram_least_time_by_hand():
    # 1e6 pairs x 205 operations / 67e12 = 3.0597e-6 s; bytes 1000 atoms
    # x 12 + 200 bins x 8 = 13,600 / 3.35e12 = 4.06e-9 s.
    seconds, by = roofline.self_pair_histogram_least(1e6, 1, 1000, 200)
    assert by == "operations"
    assert seconds == pytest.approx(205e6 / 67e12, rel=1e-12)
    seconds, by = roofline.self_pair_histogram_least(0, 1, 1000, 200)
    assert by == "bytes"
    assert seconds == pytest.approx(13600 / 3.35e12, rel=1e-12)


def test_cross_pair_histogram_least_time_matches_the_van_hove_bound():
    # 100k x 100k within 6 A at 0.8 A^-3: 100,000 x 0.8 x 4/3 pi 6^3 =
    # 7.238e7 ordered pairs a sweep x 205 / 67e12 = 0.2215 ms, the
    # kernels table's Van Hove bound (row 5); bytes 2 x 1.2 MB + 1.6 kB.
    pairs = 1e5 * 0.8 * 4 / 3 * np.pi * 6**3
    seconds, by = roofline.pair_histogram_least(pairs, 1, 100000, 200)
    assert by == "operations"
    assert seconds * 1e3 == pytest.approx(0.2215, abs=1e-4)


def test_trig_sums_least_time_matches_the_smoke_bound():
    # 2,000 chains x 50 monomers x 13,824 wavevectors x 97 operations over
    # 67 TFLOP/s: the 2.001 ms a frame of the kernels table, row 9.
    seconds, by = roofline.trig_sums_least(2000, 50, 13824)
    assert by == "operations"
    assert seconds * 1e3 == pytest.approx(2.0014, abs=1e-4)
    assert roofline.trig_term_ops() == 97
    assert roofline.trig_term_ops(lo=True, weights=True) == 105


RECORDS = [("kernelA", 0.0, 1e6), ("Memcpy HtoD (Pinned -> Device)",
                                   5e5, 1.5e6),
           ("void cellsweep::cell_sweep_kernel<cellbin::OrthoBlock<3>, "
            "cellbin::ZeroExact, cellsweep::HalfShellPairs<X> >", 2e6, 2.5e6),
           ("trig_sums_kernel<true, false, false>", 2.5e6, 3e6)]


def ctx(**kw):
    base = {"records": RECORDS, "window_s": 4.0, "frames": 2, "passes": 1,
            "config": {"n_atoms": 1000, "n_chains": 20, "n_monomers": 50},
            "traffic": {"analyses": []}, "answers": []}
    base.update(kw)
    return base


def test_device_idle_pct_by_hand():
    # busy: [0, 1.5e6) and [2e6, 3e6) us = 2.5 s of 4 s.
    assert specs.metric_reader("device_idle_pct").read(ctx()) == \
        pytest.approx(37.5)


def test_kernels_per_frame_leaves_copies_out():
    assert specs.metric_reader("kernels_per_frame").read(ctx()) == 1.5


def test_cell_pair_histogram_roofline_by_hand():
    counts = np.zeros(200, np.int64)
    counts[10] = 4_000_000  # ordered: 2e6 pairs in range over the pass
    c = ctx(traffic={"analyses": [{"reference": "rdf_counts",
                                   "kwargs": {"n_bins": 200}}]},
            answers=[{"counts": counts}])
    least = 2e6 * 205 / 67e12
    assert specs.metric_reader("cell_pair_histogram_roofline").read(c) == \
        pytest.approx(100 * least / 0.5)
    assert specs.metric_reader("cell_pair_histogram_roofline").read(
        ctx()) is None


def test_trig_sums_roofline_by_hand():
    work = {"trig_sums": {"sets": "n_chains", "atoms": "n_monomers",
                          "wavevectors": 100, "lo": False, "weights": False}}
    c = ctx(traffic={"analyses": [{"reference": "scsf", "work": work}]})
    least = roofline.trig_sums_least(40, 50, 100)[0]
    assert specs.metric_reader("trig_sums_roofline").read(c) == \
        pytest.approx(100 * least / 0.5)
    assert specs.metric_reader("trig_sums_roofline").read(
        ctx(records=RECORDS[:2])) is None


def test_readers_over_ranks_by_hand():
    ranks = [{"busy_s": 1.0, "window_s": 4.0, "kernels": 300},
             {"busy_s": 2.0, "window_s": 4.0, "kernels": 500}]
    c = {"ranks": ranks, "frames": 100, "window_s": 4.0}
    assert specs.metric_reader("device_idle_pct.ranks").read(c) == \
        pytest.approx(62.5)
    assert specs.metric_reader("kernels_per_frame.ranks").read(c) == 8.0
    assert specs.metric_reader("kernels_per_frame.ranks").read(
        dict(c, ranks=[])) is None
