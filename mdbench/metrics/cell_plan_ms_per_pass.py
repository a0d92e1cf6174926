"""cell_plan_ms_per_pass: the host's time in the traced pass planning
the cell lists (``plan.cells``: the plan search, once a pass) and
launching the slot tables (``plan.slots``: every chunk), in ms."""

from mdbench.harness import spans as sp


def read(ctx):
    spans = sp.pass_spans()
    if not spans:
        return None
    return 1e3 * sum(sp.seconds(s)
                     for s in sp.named(spans, "plan.cells", "plan.slots"))
