"""factor_sums_roofline against numbers worked by hand, and its grid
against the program's factor plan of the fused cell's wavevectors."""

import pytest

from mdbench.harness import roofline
from mdbench.harness import spec as specs

SQ = {"class": "structure.StructureFactor",
      "kwargs": {"n_points": 24, "method": "factor", "precision": "exact"}}
RECORDS = [("void (anonymous namespace)::factor_sums_kernel<true, false>"
            "(float const*, float const*, double*, int)", 1e6, 1.5e6),
           ("(anonymous namespace)::factor_sums_reduce(double const*)",
            1.5e6, 1.6e6),
           ("Memcpy HtoD (Pinned -> Device)", 1.6e6, 2e6),
           ("trig_sums_kernel<true, false, false>", 2e6, 3e6)]


def ctx(**kw):
    base = {"records": RECORDS, "window_s": 4.0, "frames": 2, "passes": 1,
            "config": {"n_atoms": 1000}, "traffic": {"analyses": [SQ]},
            "answers": []}
    base.update(kw)
    return base


def reader():
    return specs.metric_reader("factor_sums_roofline")


def test_factor_sums_roofline_by_hand():
    # 2 frames x 1,000 atoms x (8 x 24^3 + 6 x 24^2 = 114,048) operations
    # = 2.28096e8 / 67e12 = 3.4044e-6 s; bytes 2 x (12,000 + 13,824 x 8)
    # = 245,184 / 3.35e12 = 7.3e-8 s; the two kernels' 0.6 s.
    least = 2 * 1000 * 114_048 / 67e12
    assert roofline.least_seconds(2 * 1000 * 114_048, 245_184) == (
        pytest.approx(least, rel=1e-12), "operations")
    assert reader().read(ctx()) == pytest.approx(100 * least / 0.6)


def test_factor_sums_roofline_reads_nothing_without_its_records():
    assert reader().read(ctx(records=RECORDS[2:])) is None
    assert reader().read(ctx(traffic={"analyses": []})) is None
    direct = {"class": "structure.StructureFactor",
              "kwargs": {"n_points": 24, "method": "direct"}}
    chains = {"class": "polymer.SingleChainStructureFactor",
              "kwargs": {"n_points": 24}}
    assert reader().read(ctx(traffic={"analyses": [direct, chains]})) is None


def test_factor_sums_roofline_reads_100_on_a_record_as_long_as_the_bound():
    # A bytes-bound case too: 1 atom, so the sums' bytes lead.
    for atoms in (100_000, 1):
        config = {"n_atoms": atoms}
        ops = 256 * atoms * (8 * 24**3 + 6 * 24**2)
        least = roofline.least_seconds(ops, 256 * (atoms * 12 + 24**3 * 8))
        records = [("factor_sums_kernel<true, false>", 0.0, least[0] * 1e6)]
        share = reader().read(ctx(records=records, frames=256,
                                  config=config))
        assert share == pytest.approx(100.0, rel=1e-9)
        longer = [("factor_sums_kernel<true, false>", 0.0,
                   least[0] * 2e6)]
        assert reader().read(ctx(records=longer, frames=256,
                                 config=config)) == pytest.approx(50.0)


def test_factor_grid_is_the_program_plan_of_the_fused_cell():
    """The K the reader takes from n_points is the program's factor plan
    of the fused cell's wavevectors in its box, with N_q = K^3."""

    from mdhelper_tpu_torch.analysis.structure import _wavevector_grid
    from mdhelper_tpu_torch.ops.factor_scattering import factor_plan

    cell = specs.cell("lj100k.fused")
    box = [float(cell["config"]["box"])] * 3
    entries = [e for e in cell["traffic"]["analyses"]
               if e["class"] == "structure.StructureFactor"]
    assert len(entries) == 1
    n_points = entries[0]["kwargs"]["n_points"]
    qs = _wavevector_grid(box, n_points)
    assert factor_plan(qs, box)["k"] == (n_points,) * 3
    assert len(qs) == n_points**3
