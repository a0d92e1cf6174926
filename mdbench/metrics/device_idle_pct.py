"""device_idle_pct: the share of the traced pass's wall time in which no
operation ran on the card, 100 less the union of the device records
(kernels, copies, sets) over the window, in %."""

from mdbench.harness.trace import busy_us


def read(ctx):
    records = ctx["records"]
    if not records or not ctx["window_s"]:
        return None
    busy = busy_us([(s, e) for _, s, e in records]) / 1e6
    return 100.0 * (1.0 - busy / ctx["window_s"])
