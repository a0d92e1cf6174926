"""factor_sums_roofline: the factor S(q) kernel's share of its roofline,
in %.

The least time of the traced pass's factor sums (``harness/roofline.py``:
the larger of the operations over the float32 peak and the bytes over
the memory rate) over the device time of the kernels named here.  The
operations are the contraction's and the xy products', 8 Kx Ky Kz + 6 Kx
Ky float32 operations an atom and frame (a complex multiply-add is four
FMAs, an FMA counts two); the axis tables are left out, so the least time
is a lower bound.  The bytes are the positions read once and the N_q
float32 cos and sin sums written once a frame.  K is ``(n_points,) * 3``
of each ``StructureFactor`` entry of the traffic on the factor route
(``method`` "factor" or "auto": the cubic box's grid, N_q = K^3), the
atoms the configuration's ``n_atoms``.  Nothing to read without such an
entry or without a kernel of these names in the trace.
"""

from mdbench.harness import roofline

NAMES = ("factor_sums_kernel", "factor_sums_reduce")


def read(ctx):
    seconds = sum((e - s) / 1e6 for name, s, e in ctx["records"]
                  if any(n in name for n in NAMES))
    least = 0.0
    for entry in ctx["traffic"]["analyses"]:
        kwargs = entry.get("kwargs", {})
        if (entry.get("class", "").rsplit(".", 1)[-1] != "StructureFactor"
                or kwargs.get("method", "auto") not in ("factor", "auto")
                or "n_points" not in kwargs):
            continue
        k = int(kwargs["n_points"])
        frames, atoms = ctx["frames"], int(ctx["config"]["n_atoms"])
        ops = frames * atoms * (8 * k**3 + 6 * k**2)
        n_bytes = frames * (atoms * 12 + k**3 * 8)
        least += roofline.least_seconds(ops, n_bytes)[0]
    if not seconds or not least:
        return None
    return 100.0 * least / seconds
