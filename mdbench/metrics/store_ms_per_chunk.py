"""store_ms_per_chunk: the host's time in the per-frame stores of the
traced pass (``store.queue``: the device-to-host copies enqueued into
pinned memory; ``store.drain``: the wait for them and the absorb into the
host buffers), self time, in ms, over the pass's chunks."""

from mdbench.harness import spans as sp


def read(ctx):
    spans = sp.pass_spans()
    chunks = len(sp.named(spans, "stream.wait"))
    if not chunks:
        return None
    return 1e3 * sp.total_self(spans, "store.queue", "store.drain") / chunks
