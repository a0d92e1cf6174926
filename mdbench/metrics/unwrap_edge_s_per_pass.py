"""unwrap_edge_s_per_pass: the host's time in the traced pass making
molecules whole across the box edge at the first frame
(``unwrap.edge``, every analysis that unwraps), in s."""

from mdbench.harness import spans as sp


def read(ctx):
    spans = sp.pass_spans()
    if not spans:
        return None
    return sum(sp.seconds(s) for s in sp.named(spans, "unwrap.edge"))
