"""prepare_s_per_pass: the host's time in the analyses' set-up of the
traced pass (``prepare``: carries, buffers, constants), self time, so
less the edge unwrap and the cell plan inside it, in s."""

from mdbench.harness import spans as sp


def read(ctx):
    spans = sp.pass_spans()
    if not spans:
        return None
    return sp.total_self(spans, "prepare")
