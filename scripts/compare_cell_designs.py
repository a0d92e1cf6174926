"""Time the first design of the cell-list kernels beside the current one,
in turns, on the shapes of the paths that run them.

Usage::

    python scripts/compare_cell_designs.py [--parent REV] [--out FILE]
        [--rows ROW,...]

Run it once where git is (any machine): it writes the ``csrc/`` of
commit ``REV`` (default ``fc5e84c``, the last commit of the first
design), taken with ``git show``, under ``chip_archive/first_design/``
(ignored by git).  Run it again on a machine with an NVIDIA GPU: it
compiles that tree with the package's own nvcc flags
(``ops/_build.NVCC_FLAGS``, one process a source) into a library beside
it, builds the current tree as the package does, and for each shape
calls the same wrapper (slot tables included) on the same frames with
the first library, then the current one twice, then the first again
(CUDA-event means a frame, the wrapper's and its launch's alone, the
slot tables built), and checks that the two designs' counts are
equal as integers.  A third build between them, the current per-pair
arithmetic (``cell_bin.cuh``) under the first design's sweep templates
(its ``cell_pair_histogram.cuh`` and ``cross_pair_histogram.cuh``, whose
interface to the arithmetic is unchanged), separates the arithmetic's
share of the gain from the sweep's: the order is first, arithmetic,
current, current, arithmetic, first.  The C entry points of both trees take the same
arguments, so one wrapper drives either.  It also counts, in numpy on
the host, the double-float candidates the tri_pp screen keeps for the
pairs it passes in the 50k-atom rhombic dodecahedron
(``testing.tri27_screen``).  ``--rows`` times only the rows named.  The card's name and power limit, a line a
shape and a JSON summary (also written to ``--out``) are printed.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CSRC = "mdhelper_tpu_torch/csrc"


def extract(rev, dest):
    """Write commit `rev`'s csrc/ into `dest` with git show."""

    names = subprocess.run(
        ["git", "ls-tree", "--full-tree", "--name-only", f"{rev}:{CSRC}"], cwd=ROOT,
        capture_output=True, text=True, check=True).stdout.split()
    dest.mkdir(parents=True, exist_ok=True)
    for name in names:
        blob = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                              cwd=ROOT, capture_output=True, check=True)
        (dest / name).write_bytes(blob.stdout)
    return names


def build(csrc, lib_path):
    """Compile every .cu of `csrc` with the package's flags, in
    parallel, and link them; returns the loaded library."""

    from mdhelper_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    jobs = []
    for src in sorted(csrc.glob("*.cu")):
        obj = lib_path.with_name(f"{src.stem}.o")
        jobs.append((obj, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-c", "-o",
             str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    for obj, proc in jobs:
        log.append(proc.communicate()[0])
        if proc.returncode:
            raise RuntimeError("".join(log))
    subprocess.run([nvcc, *_build._LINK_FLAGS, "-o", str(lib_path),
                    *[str(o) for o, _ in jobs]], check=True)
    lib_path.with_suffix(".log").write_text("".join(log))
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


#: the first design's per-pair call as the current policies serve it: an
#: exact policy's screen, then its exact bin (the lane's own pair, with no
#: queue), or a fast policy's bin.
SCREENED_INDEX = """
template <class B, class I>
__device__ __forceinline__ int screened_index(const B& bins, const I& image,
                                              float4 a, float4 c, int n) {
  if constexpr (B::kScreened) {
    unsigned aux = 0u;
    return bins.screen(image, a, c, aux) ? bins.index(image, a, c, aux, n)
                                         : n;
  } else {
    return bins.index(image, a, c, n);
  }
}
"""


def first_sweep(path):
    """A first-design sweep template calling the current arithmetic."""

    text = path.read_text().replace(
        '#include "cell_bin.cuh"\n',
        '#include "cell_bin.cuh"\n' + SCREENED_INDEX, 1)
    return text.replace("binner.index(image, ", "screened_index(binner, "
                        "image, ")


def shapes(device, rng):
    """(row, text, frames1, frames2, box, plan, r_max, n_bins, options) of
    each compared shape: the paths' planner plans at PERF.md's rows."""

    gen_dodeca = cs.dodecahedron(cs.GEN_DODECA_A)
    out = []

    def add(row, text, n1, n2, dims6, r_max, n_bins, n_frames, **options):
        f1, box = cs.uniform_frames(rng, device, n_frames, n1, dims6)
        f2 = (None if n2 is None else
              cs.uniform_frames(rng, device, n_frames, n2, dims6)[0])
        plan = cs.planned(n1, box, r_max, n_atoms2=n2,
                          exclusion=options.get("exclusion"))
        out.append((row, text, f1, f2, box, plan, r_max, n_bins, options))

    cube100k = cs.cube(cs.N_ATOMS)
    add("1", "self, 100k atoms, cube 50 A, r 6, exclusion (1, 1) (fused)",
        cs.N_ATOMS, None, cube100k, cs.R_MAX, cs.N_BINS, 2)
    add("1b fast", "self, 100k atoms, cube, r 6, fast", cs.N_ATOMS, None,
        cube100k, cs.R_MAX, cs.N_BINS, 2, precision="fast")
    add("1d", "tri_pp self, 50k atoms, dodecahedron a = 44.54 A, r 15",
        cs.GEN_ATOMS, None, gen_dodeca, cs.GEN_R, cs.GEN_BINS, 1)
    add("5 Van Hove", "cross 100k x 100k, exclusion (1, 1), cube, r 6",
        cs.N_ATOMS, cs.N_ATOMS, cube100k, cs.R_MAX, cs.N_BINS, 2,
        exclusion=(1, 1))
    add("5c Van Hove", "cross 50k x 50k, exclusion (1, 1), cube 39.685 A, "
        "r 15", cs.GEN_ATOMS, cs.GEN_ATOMS, cs.cube(cs.GEN_ATOMS), cs.GEN_R,
        cs.GEN_BINS, 2, exclusion=(1, 1))
    add("5d", "tri_pp cross 25k x 25k, dodecahedron a = 44.54 A, r 15",
        cs.GEN_ATOMS // 2, cs.GEN_ATOMS // 2, gen_dodeca, cs.GEN_R,
        cs.GEN_BINS, 1)
    add("6", "cross 200k x 200k, cube 79.37 A, r 6", cs.STREAM_ATOMS // 2,
        cs.STREAM_ATOMS // 2, cs.cube(cs.STREAM_ATOMS), cs.R_MAX, cs.N_BINS,
        1)
    add("7 Van Hove", "per-block cross 100k x 100k, exclusion (1, 1), "
        "dodecahedron a = 56.12 A, r 6", cs.N_ATOMS, cs.N_ATOMS,
        cs.dodecahedron(cs.DODECA_A), cs.R_MAX, cs.N_BINS, 2,
        exclusion=(1, 1))
    add("8", "per-block cross 200k x 200k, dodecahedron a = 89.09 A, r 6",
        cs.STREAM_ATOMS // 2, cs.STREAM_ATOMS // 2,
        cs.dodecahedron(cs.DODECA_STREAM_A), cs.R_MAX, cs.N_BINS, 1)
    return out


def kept_candidates(rng, n_pairs=2_000_000):
    """Mean tri_pp candidates kept a pair passing the screen, over
    uniform pairs in the 50k-atom dodecahedron (r_max 15): the kept count
    depends on the displacement alone, so pairs within reach of the
    sweep's cells kept by the screen are as these."""

    import torch

    from mdhelper_tpu_torch.algorithm.topology import triclinic_matrices
    from mdhelper_tpu_torch.ops.histogram import _inv3
    from mdhelper_tpu_torch.testing import tri27_screen

    h64 = triclinic_matrices(cs.dodecahedron(cs.GEN_DODECA_A))
    h = h64.astype(np.float32)
    inv = _inv3(torch.from_numpy(h)).numpy()
    p1 = (rng.random((n_pairs, 3)) @ h64).astype(np.float32)
    p2 = (rng.random((n_pairs, 3)) @ h64).astype(np.float32)
    cut = np.nextafter(np.float32(cs.GEN_R) ** 2, np.float32(np.inf))
    passed, kept, _ = tri27_screen(p1, p2, h, inv, cut)
    n_kept = kept.sum(axis=-1)[passed]
    return {"pairs": n_pairs, "passed": int(passed.sum()),
            "mean_kept": float(n_kept.mean()),
            "share_kept_2_or_more": float((n_kept >= 2).mean())}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default="fc5e84c")
    parser.add_argument("--out", help="also write the JSON summary here")
    parser.add_argument("--rows", help="comma-separated rows to time "
                        "(default: all)")
    args = parser.parse_args()
    first_dir = ROOT / "chip_archive" / "first_design" / args.parent
    if not (first_dir / "csrc").exists():
        names = extract(args.parent, first_dir / "csrc")
        print(f"wrote {len(names)} files of {args.parent}:{CSRC} to "
              f"{first_dir / 'csrc'}")

    import torch

    from mdhelper_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("no CUDA device: the comparison runs on the card")
        sys.exit(1)
    device = torch.device("cuda", 0)
    card = cs.card_line()
    start = time.perf_counter()
    step = first_dir / "arithmetic"
    step.mkdir(exist_ok=True)
    for src in (ROOT / CSRC).iterdir():
        text = src.read_text()
        if src.name in ("cell_pair_histogram.cuh", "cross_pair_histogram.cuh"):
            text = first_sweep(first_dir / "csrc" / src.name)
        (step / src.name).write_text(text)
    libs = {"first": build(first_dir / "csrc", first_dir / "libfirst.so"),
            "arithmetic": build(step, first_dir / "libarithmetic.so"),
            "new": _build.load_library()}
    print(f"{card}; both designs built in "
          f"{time.perf_counter() - start:.1f} s")

    def use(design):
        _build.load_library = lambda: libs[design]

    rng = np.random.default_rng(cs.SEED + 7)
    rows = []
    wanted = None if args.rows is None else set(args.rows.split(","))
    for row, text, f1, f2, box, plan, r_max, n_bins, options in shapes(
            device, rng):
        if wanted is not None and row not in wanted:
            continue
        kernel, _, work, plan_text = cs.sweep_calls(
            f1, f2, box, plan, r_max, n_bins, **options)
        n_frames = f1.shape[0]
        outs = {}
        for design in libs:
            use(design)
            outs[design], replay = cs.recorded_launch(kernel)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for d in libs if d != "new"
                    for a, b in zip(outs[d], outs["new"]))
        cs.check(equal, f"row {row}: the designs' counts differ")
        work = work["rebound"](cs.counted_pairs(outs["new"][0], work))
        reps = 1 if work["mode"] == "tri_pp" else 3
        ms = {design: [] for design in libs}
        launch_ms = {design: [] for design in libs}
        order = ["first", "arithmetic", "new"]
        for design in order + order[::-1]:
            use(design)
            ms[design].append(cs.time_ms(kernel, reps) / n_frames)
            launch_ms[design].append(cs.time_ms(replay, reps) / n_frames)
        first, new = float(np.mean(ms["first"])), float(np.mean(ms["new"]))
        step1 = float(np.mean(ms["arithmetic"]))
        alone = {d: float(np.mean(v)) for d, v in launch_ms.items()}
        rows.append({"row": row, "shape": text, "plan": plan_text,
                     "first_ms": ms["first"],
                     "arithmetic_ms": ms["arithmetic"], "new_ms": ms["new"],
                     "launch_ms": launch_ms,
                     "speedup": first / new, "counts_equal": equal,
                     "bound_ms": work["bound_ms"],
                     "first_design_bound_ms": work["first_design_bound_ms"],
                     "pairs_per_frame": work["pairs_per_frame"],
                     "counted_per_frame": work["counted_per_frame"]})
        print(f"row {row}: {text}, {plan_text}: first {first:.3f} ms a "
              f"frame (runs {[round(x, 3) for x in ms['first']]}), "
              f"arithmetic only {step1:.3f}, new "
              f"{new:.3f} (runs {[round(x, 3) for x in ms['new']]}), "
              f"{first / new:.2f}x; counts equal; bound {work['bound_ms']:.3f}"
              f" ms ({100 * work['bound_ms'] / new:.1f} %), first design's "
              f"count {work['first_design_bound_ms']:.3f}; the launch "
              f"alone: first {alone['first']:.3f}, arithmetic only "
              f"{alone['arithmetic']:.3f}, new {alone['new']:.3f} "
              f"({alone['first'] / alone['new']:.2f}x; bound "
              f"{100 * work['bound_ms'] / alone['new']:.1f} %)", flush=True)
        del outs
    kept = kept_candidates(np.random.default_rng(cs.SEED + 8))
    print(f"tri_pp screen, 50k dodecahedron, r 15: {kept['passed']} of "
          f"{kept['pairs']} uniform pairs pass, {kept['mean_kept']:.4f} "
          f"candidates kept a passing pair, {kept['share_kept_2_or_more']:.4f}"
          " keep two or more")
    summary = {"card": card, "rows": rows, "tri_pp_kept": kept}
    if args.out:
        out = ROOT / args.out
        os.makedirs(out.parent, exist_ok=True)
        out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
