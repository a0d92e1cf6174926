"""fold_ms_per_frame: the host's time in the analyses' per-chunk updates
of the traced pass (``fold``, every analysis; self time, so less the
slot tables' ``plan.slots``), in ms, over the pass's frames."""

from mdbench.harness import spans as sp


def read(ctx):
    spans = sp.pass_spans()
    top = sp.root(spans)
    if top is None or not top["attrs"].get("frames"):
        return None
    return 1e3 * sp.total_self(spans, "fold") / top["attrs"]["frames"]
