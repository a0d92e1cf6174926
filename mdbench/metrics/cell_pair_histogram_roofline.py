"""cell_pair_histogram_roofline: the self cell-list sweep's share of its
roofline, in %.

The least time of the traced pass's self sweeps (``harness/roofline.py``:
205 float32 operations a pair in range, against the positions read once
and the counts written once) over the device time of the kernels named
here.  The pairs in range are those of the reference's counts for the
traffic's ``rdf_counts`` analyses (ordered counts, so halved), never the
pairs the plan visits.  Nothing to read without such an analysis or
without a kernel of that name in the trace.
"""

from mdbench.harness import roofline

#: the self sweeps: cell_sweep_kernel over half-shell or ordered pairs.
NAMES = ("cell_sweep_kernel",)
PAIRS = ("HalfShellPairs", "OrderedPairs")


def read(ctx):
    seconds = sum((e - s) / 1e6 for name, s, e in ctx["records"]
                  if any(n in name for n in NAMES)
                  and any(p in name for p in PAIRS))
    least = 0.0
    for entry, want in zip(ctx["traffic"]["analyses"], ctx["answers"]):
        if entry["reference"] != "rdf_counts":
            continue
        pairs = float(want["counts"].sum()) / 2 * ctx["passes"]
        least += roofline.self_pair_histogram_least(
            pairs, ctx["frames"], int(ctx["config"]["n_atoms"]),
            int(entry["kwargs"]["n_bins"]))[0]
    if not seconds or not least:
        return None
    return 100.0 * least / seconds
