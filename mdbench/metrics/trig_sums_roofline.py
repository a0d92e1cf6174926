"""trig_sums_roofline: the exact trig-sums kernel's share of its
roofline, in %.

The least time of the traced pass's trig sums (``harness/roofline.py``:
the operations of each (wavevector, atom) term over the float32 peak,
against the positions and wavevectors read once and the float32 sums
written once) over the device time of the kernels named here.  The terms
come from each traffic entry's ``work.trig_sums``: ``sets`` and ``atoms``
name configuration keys (the sets a frame and the atoms a set; chains and
monomers for the single-chain S(q)), ``wavevectors`` is their count.
"""

from mdbench.harness import roofline

NAMES = ("trig_sums_kernel", "trig_sums_reduce")


def read(ctx):
    seconds = sum((e - s) / 1e6 for name, s, e in ctx["records"]
                  if any(n in name for n in NAMES))
    least, config = 0.0, ctx["config"]
    for entry in ctx["traffic"]["analyses"]:
        work = entry.get("work", {}).get("trig_sums")
        if work is None:
            continue
        least += roofline.trig_sums_least(
            int(config[work["sets"]]) * ctx["frames"],
            int(config[work["atoms"]]), int(work["wavevectors"]),
            lo=work["lo"], weights=work["weights"])[0]
    if not seconds or not least:
        return None
    return 100.0 * least / seconds
