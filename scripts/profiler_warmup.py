"""Does torch.profiler keep every device record of a short window?

Runs the profiled windows of ``chip_smoke.py`` (config 4's z profile of
the 100k-ion electrolyte and config 5's Gyradius + EndToEndVector +
RouseModes trio on 2,000 chains of 50 monomers, the last 8 frames of
each) again and again, with the profiler started two ways:

* ``cold``: ``start()`` at the window;
* ``warm``: ``prepare_trace()`` (which turns CUPTI's activity records
  on) one chunk ahead, ``start_trace()`` at the window, as
  ``chip_smoke.run_profiled`` does.

For each path and way it prints how many windows held fewer CUDA
records than the most common count, how many held none, and the counts
seen; and the names of the events that the traces with no device record
held (the host's runtime calls).

Usage, on a machine with a CUDA device, from the repository root::

    python3 scripts/profiler_warmup.py [REPS]
"""

import collections
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from mdhelper_tpu_torch.analysis import polymer  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402


def window(analyses, n_frames, runner, warm):
    """CUDA records of the last CHUNK frames' trace and its events' names
    (each with its count)."""

    prof = profile(activities=[ProfilerActivity.CUDA])
    seen = [0]
    warm_at, start_at = n_frames - 2 * cs.CHUNK, n_frames - cs.CHUNK

    def on_chunk(batch):
        seen[0] += batch.n_real
        if warm and seen[0] == warm_at:
            torch.cuda.synchronize()
            prof.prepare_trace()
        elif seen[0] == start_at:
            torch.cuda.synchronize()
            prof.start_trace() if warm else prof.start()
            torch.cuda.synchronize()
        elif seen[0] == n_frames:
            torch.cuda.synchronize()
            prof.stop()

    runner(analyses, on_chunk=on_chunk)
    torch.cuda.synchronize()
    events = prof.events()
    names = collections.Counter(e.name for e in events)
    return sum(e.device_type == DeviceType.CUDA for e in events), names


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    device = torch.device("cuda", 0)
    _, u = cs.electrolyte_universe(np.random.default_rng(cs.SEED + 12),
                                   cs.N_FRAMES)
    groups = [u.select_atoms("charge > 0"), u.select_atoms("charge < 0")]
    _, _, chains = cs.polymer_universe(np.random.default_rng(cs.SEED + 14),
                                       cs.POLYMER_FRAMES)

    def trio():
        return [
            cs.polymer_analysis(polymer.Gyradius, chains.atoms, device),
            cs.polymer_analysis(polymer.EndToEndVector, chains.atoms, device),
            cs.polymer_analysis(polymer.RouseModes, chains.atoms, device,
                                n_modes=cs.POLYMER_MODES),
        ]

    paths = {
        "config 4": (lambda: [cs.profile_analysis(groups, device)],
                     cs.N_FRAMES, cs.run_alone, reps),
        "config 5 trio": (trio, cs.POLYMER_FRAMES, run_together,
                          max(1, reps // 4)),
    }
    print(cs.card_line())
    for name, (make, n_frames, runner, n) in paths.items():
        counts = {False: [], True: []}
        empty_events = []
        for _ in range(n):
            for warm in (False, True):
                n_cuda, names = window(make(), n_frames, runner, warm)
                counts[warm].append(n_cuda)
                if not n_cuda:
                    empty_events.append(dict(names))
        for warm, seen in counts.items():
            tally = collections.Counter(seen)
            mode = tally.most_common(1)[0][0]
            print(json.dumps({
                "path": name, "profiler": "warm" if warm else "cold",
                "windows": len(seen),
                "short": sum(c < mode for c in seen),
                "empty": tally.get(0, 0),
                "counts": {str(k): v for k, v in sorted(tally.items())},
            }))
        if empty_events:
            print(f"{name}: the events of the traces with no device "
                  f"record: {json.dumps(empty_events)}")
        sys.stdout.flush()


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"{time.perf_counter() - t0:.1f} s")
