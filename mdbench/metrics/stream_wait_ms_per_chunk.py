"""stream_wait_ms_per_chunk: the host's wait for each staged chunk of the
traced pass (``stream.wait``: the prefetch worker's read, pin and
host-to-device enqueue that the stream did not hide), in ms, over the
chunks."""

from mdbench.harness import spans as sp


def read(ctx):
    waits = sp.named(sp.pass_spans(), "stream.wait")
    if not waits:
        return None
    return 1e3 * sum(sp.seconds(s) for s in waits) / len(waits)
