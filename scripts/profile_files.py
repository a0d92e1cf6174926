"""Where the files path's time goes on the card: the fused path (the RDF,
S(q) and Onsager of ``chip_smoke.py``'s main path, 100k atoms, 8 + 32
frames) from an XTC with the read prefetch on, the XTC reader's decode
threads capped at 8, 4, 2 and 1, and with the prefetch off, beside the
same decoded frames from an ArrayReader; after a warm-up run, every
variant runs in turns (forward, then backward, `--reps` times).

    python3 scripts/profile_files.py [--reps 2]

Prints each variant's frames/s (every run and the mean), the host's
decode time of an 8-frame chunk at each thread count, and the card's
name and power limit.  The thread cap patches ``os.cpu_count``, which
the reader reads to size its pool.  Needs a card.
"""

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

THREADS = (8, 4, 2, 1)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()

    from mdhelper_tpu_torch._device import require_cuda
    from mdhelper_tpu_torch.core.universe import Universe
    from mdhelper_tpu_torch.io import _xtc_native, structure_writers, xtc

    device = require_cuda()
    card = cs.card_line()
    cs.check(_xtc_native.load() is not None, "no native XTC codec")
    traj, _ = cs.slice_universe(np.random.default_rng(cs.SEED + 11),
                                cs.N_FRAMES)
    names = np.where(np.arange(cs.N_ATOMS) % 2 == 0, "A", "B")
    with tempfile.TemporaryDirectory() as tmp:
        gro, path = os.path.join(tmp, "top.gro"), os.path.join(tmp, "t.xtc")
        structure_writers.write_gro(gro, traj[0], names=names,
                                    dimensions=[cs.BOX] * 3 + [90.0] * 3)
        xtc.write_xtc(path, traj / np.float32(10.0),
                      np.tile(np.eye(3) * cs.BOX / 10, (cs.N_FRAMES, 1, 1)),
                      precision=cs.XTC_PRECISION)
        u = Universe.from_files(gro, path)
        array = cs.decoded_universe(u)
        decode = {}
        for k in THREADS:
            with mock.patch("os.cpu_count", return_value=k):
                times = []
                for lo in range(0, cs.N_FRAMES, cs.CHUNK):
                    t0 = time.perf_counter()
                    u.trajectory.read_frames(np.arange(lo, lo + cs.CHUNK))
                    times.append(1e3 * (time.perf_counter() - t0))
            decode[k] = times
        variants = [("array", None, True), ("array", None, False)]
        variants += [("xtc", k, True) for k in THREADS]
        variants += [("xtc", THREADS[0], False)]
        sources = {"array": array, "xtc": u}
        replans, sigmas = [], {}
        fps = {v: [] for v in variants}

        def run(variant):
            route, k, prefetch = variant
            with mock.patch("os.cpu_count", return_value=k or os.cpu_count()):
                return cs.replanned(
                    lambda s: cs.files_path(sources[route], device, prefetch,
                                            s),
                    cs.run_timed, str(variant), replans, sigmas, "xtc")[1]

        run(("xtc", THREADS[0], True))
        for rep in range(args.reps):
            for variant in variants + variants[::-1]:
                fps[variant].append(run(variant))
    print(card)
    for k in THREADS:
        print(f"decode a {cs.CHUNK}-frame chunk of {cs.N_ATOMS} atoms, {k} "
              f"thread(s): {np.mean(decode[k]):.2f} ms (runs "
              f"{[round(x, 2) for x in decode[k]]})")
    for (route, k, prefetch), values in fps.items():
        what = (f"{route}, prefetch {'on' if prefetch else 'off'}"
                + (f", {k} decode thread(s)" if k else ""))
        print(f"{what}: {np.mean(values):.3f} frames/s (runs "
              f"{[round(x, 3) for x in values]}) on {card}")
    print("re-plans: " + ("; ".join(replans) if replans else "none"))


if __name__ == "__main__":
    main()
