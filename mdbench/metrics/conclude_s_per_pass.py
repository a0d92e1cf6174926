"""conclude_s_per_pass: the host's time in the analyses' conclusions of
the traced pass (``conclude``: the reductions and transforms that turn
carries and stores into results, and their copies to the host), self
time, in s."""

from mdbench.harness import spans as sp


def read(ctx):
    spans = sp.pass_spans()
    if not spans:
        return None
    return sp.total_self(spans, "conclude")
