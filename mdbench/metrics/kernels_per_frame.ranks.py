"""kernels_per_frame.ranks: as kernels_per_frame, for a job over ranks:
every rank's kernel records in its traced pass over the job's frames."""


def read(ctx):
    ranks = [r for r in ctx.get("ranks", ()) if r]
    kernels = sum(r["kernels"] for r in ranks)
    if not kernels or not ctx["frames"]:
        return None
    return kernels / ctx["frames"]
