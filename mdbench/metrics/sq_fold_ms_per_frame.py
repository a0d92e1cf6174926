"""sq_fold_ms_per_frame: the host's time in the structure factor's
per-chunk updates of the traced pass (``fold`` of ``StructureFactor``:
the factor route's per-frame launch loop), self time, in ms, over the
pass's frames."""

from mdbench.harness import spans as sp


def is_sq(span):
    return span["attrs"].get("analysis") == "StructureFactor"


def read(ctx):
    spans = sp.pass_spans()
    top = sp.root(spans)
    if (top is None or not top["attrs"].get("frames")
            or not any(is_sq(s) for s in sp.named(spans, "fold"))):
        return None
    return (1e3 * sp.total_self(spans, "fold", where=is_sq)
            / top["attrs"]["frames"])
