"""Run phases of ``chip_smoke.py`` from two checkouts on one card, in the
order A, B, B, A (one process a run), and report each run's results.

    python3 scripts/compare_smoke_phases.py [--build] [--out FILE] DIR_A
        DIR_B PHASE...

``PHASE`` names a phase function of ``chip_smoke.py`` (``phase_profiles``,
``phase_aggregates``, ...); each is called as ``main()`` calls it, with
its own generator.  ``--build`` builds the checkout's kernels first (the
phases that launch or count them).  Each run prints the phases' own
lines; the last line is one JSON object, ``{"runs": [{"dir": ...,
"phases": {phase: {key: number, ...}}}, ...]}``, of the numbers that
each phase returned, which ``--out`` also writes to FILE.  Needs a CUDA
card.
"""

import json
import os
import subprocess
import sys

#: the seed offset of each phase's generator in chip_smoke.main().
SEED_OFFSETS = {
    "phase_groupings": 9,
    "phase_electrolyte": 10,
    "phase_files": 11,
    "phase_profiles": 12,
    "phase_polymer": 14,
    "phase_mesh": 15,
    "phase_aggregates": 16,
    "phase_order": 17,
    "phase_velocities": 18,
    "phase_interface": 19,
    "phase_superposition": 20,
    "phase_bonded": 21,
    "phase_checkpoint": 22,
    "phase_pairing": 23,
    "phase_sasa": 24,
}

CHILD = """
import json, sys
import numpy as np, torch
import chip_smoke as cs

def numbers(obj):
    if isinstance(obj, dict):
        out = {str(k): numbers(v) for k, v in obj.items()}
        return {k: v for k, v in out.items() if v is not None}
    if isinstance(obj, (bool, np.bool_)):
        return None
    if isinstance(obj, (int, float, np.integer, np.floating)):
        return float(obj)
    return None

args = json.loads(sys.argv[1])
if args["build"]:
    from mdhelper_tpu_torch.ops import _build
    _build.load_library()
device = torch.device("cuda", 0)
card = cs.card_line()
results = {}
for name in args["phases"]:
    rng = np.random.default_rng(cs.SEED + args["offsets"][name])
    results[name] = numbers(getattr(cs, name)(device, rng, card))
print("RESULT " + json.dumps(results))
"""


def run(directory, phases, build):
    args = json.dumps({"build": build, "phases": phases,
                       "offsets": {p: SEED_OFFSETS[p] for p in phases}})
    env = dict(os.environ, PYTHONPATH=os.path.abspath(directory))
    proc = subprocess.run([sys.executable, "-c", CHILD, args],
                          cwd=directory, env=env, capture_output=True,
                          text=True, check=False)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode:
        raise SystemExit(f"{directory}: exit {proc.returncode}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def main(argv):
    build = "--build" in argv
    argv = [a for a in argv if a != "--build"]
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) < 3 or any(p not in SEED_OFFSETS for p in argv[2:]):
        raise SystemExit(__doc__ + f"\nphases: {sorted(SEED_OFFSETS)}")
    dir_a, dir_b, phases = argv[0], argv[1], argv[2:]
    runs = []
    for directory in (dir_a, dir_b, dir_b, dir_a):
        print(f"== {directory}", flush=True)
        runs.append({"dir": directory,
                     "phases": run(directory, phases, build)})
    summary = json.dumps({"runs": runs})
    if out is not None:
        with open(out, "w") as f:
            f.write(summary + "\n")
    print(summary)


if __name__ == "__main__":
    main(sys.argv[1:])
