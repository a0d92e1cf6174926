"""idle_attributed_pct: the share of the device's idle time in the traced
pass (the root ``pass`` span's interval less the union of the device
records) that lies under one of the program's other spans, in %: how much
of the idle time the spans explain."""

from mdbench.harness import spans as sp


def read(ctx):
    return sp.attributed_pct(sp.pass_spans(), ctx["records"])
