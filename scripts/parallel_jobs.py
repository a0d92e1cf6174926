"""Run jobs of ``chip_smoke.py``'s ``phase_parallel`` on their own: the
serial references on the first card, then each job of ranks, each rank a
spawned process, its results held against the serial runs as the smoke
holds them.

    python3 scripts/parallel_jobs.py [--out FILE] WORLD:BACKEND...

``WORLD:BACKEND`` names a job, e.g. ``1:nccl 2:gloo`` (the smoke's jobs)
or ``4:nccl`` (one NCCL rank a card, on four cards).  Each job prints its
ranks' lines and its frames/s as the smoke does; the last line is one
JSON object, ``{"card": ..., "jobs": {WORLD: {"launches": {run:
{kernel: n}}, "job_fps": {run: frames/s}, "checkpoints": {run: {rank:
{"save_ms", "bytes", "chunk_ms", "share"}}}, "seconds": s}}}``, which
``--out`` also writes to FILE.  Needs a CUDA card for each NCCL rank.
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        del argv[i:i + 2]
    if not argv:
        sys.exit(__doc__)
    jobs = [(int(world), backend)
            for world, backend in (a.split(":") for a in argv)]

    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from mdhelper_tpu_torch.ops import _build

    _build.load_library()
    card = chip_smoke.card_line()
    results = {}
    with tempfile.TemporaryDirectory(prefix="parallel_jobs_") as refs:
        chip_smoke.parallel_references(refs)
        torch.cuda.empty_cache()
        references = os.path.join(refs, "references.npz")
        for world, backend in jobs:
            job = chip_smoke.parallel_job(world, backend, references, card)
            results[world] = {key: job[key]
                              for key in ("launches", "job_fps",
                                          "checkpoints", "seconds")}
    line = json.dumps({"card": card, "jobs": results})
    if out is not None:
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
