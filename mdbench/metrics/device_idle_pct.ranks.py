"""device_idle_pct.ranks: as device_idle_pct, for a job over ranks: each
rank's idle share of its own traced pass (100 less the union of its
device records over its pass's wall time), the mean over the ranks, in
%."""


def read(ctx):
    ranks = [r for r in ctx.get("ranks", ()) if r and r["window_s"]]
    if not ranks or not all(r["busy_s"] for r in ranks):
        return None
    return sum(100.0 * (1.0 - r["busy_s"] / r["window_s"])
               for r in ranks) / len(ranks)
