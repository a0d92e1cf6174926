"""kernels_per_frame: kernel records on the card in the traced pass (no
copies or sets) over the frames the pass folded: the launches the fused
stream spends a frame."""

from mdbench.harness.trace import is_kernel


def read(ctx):
    kernels = sum(1 for name, _, _ in ctx["records"] if is_kernel(name))
    if not kernels or not ctx["frames"]:
        return None
    return kernels / ctx["frames"]
