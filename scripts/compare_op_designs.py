"""Time the first design of the trig-sums and brute pair-histogram kernels
beside the current one, in turns, at the smoke's shapes.

Usage::

    python scripts/compare_op_designs.py [--parent REV] [--out FILE]
        [--sass]

Run it once where git is (any machine): it writes the ``csrc/`` of
commit ``REV`` (default ``ed37833``, the last commit of the first design
of both kernels), taken with ``git show``, under
``chip_archive/first_design/`` (ignored by git).  Run it again on a
machine with an NVIDIA GPU: it compiles that tree with the package's own
nvcc flags into a library beside it and builds the current tree as the
package does.  Then, on the same inputs:

* the trig sums (``csrc/trig_sums.cu``): 2 frames of 100k atoms in the
  50 A cube x the 24^3 grid's 13,824 float64 wavevectors in one launch,
  exact and fast, through ``ops.cuda_kernels.trig_sums`` on each library
  (the C entry point is unchanged); the exact sums of both designs must
  be equal bit for bit, the fast ones within 1e-4 of the mean amplitude;
* the brute pair histogram (``csrc/pair_histogram.cu``): the 100k atoms,
  r_max 6, 200 bins, exclusion (1, 1) and None; the first design through
  its own entry point (no d^2 cut argument), the current one through the
  wrapper; counts must be equal as integers.

Times are CUDA-event means a frame of 3 calls, taken in the order
first, current, current, first.  With
``--sass`` it also prints, for both trees, the innermost loops of the
two kernels' SASS (``scripts/compare_sass.py --loops``) and their
registers and spills (``-Xptxas -v``), and writes the whole listings
beside ``--out``.  The card's name and power limit,
a line a case and a JSON summary (also written to ``--out``) are
printed.
"""

import argparse
import ctypes
import json
import os
import re
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from compare_cell_designs import CSRC, build, extract  # noqa: E402

#: the first design's pair-histogram entry point (no d^2 cut).
_FIRST_HIST_ARGS = (ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 5 \
    + (ctypes.c_float,) * 4 + (ctypes.c_void_p,)

#: the kernels' names in the SASS, for --sass.
SASS_PATTERNS = (("trig_sums_kernel",), ("pair_histogram_kernel",))



def ptxas_lines(log, names=("trig_sums_kernel", "pair_histogram_kernel")):
    """Registers, stack and spills of the kernels in a build log."""

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if any(n in m.group(1) for n in names) else None
        elif name and ("spill" in line or "registers" in line):
            out.append(f"  {name}: {line.strip()}")
    return out


def first_pair_histogram(lib, pos, box, r_max, n_bins, exclusion):
    """The first design's launch, as its wrapper made it."""

    import torch

    from mdhelper_tpu_torch.ops import _build
    from mdhelper_tpu_torch.ops.cuda_cell_histogram import (
        _bin_boundary_constants,
    )

    counts = torch.zeros(n_bins, dtype=torch.int64, device=pos.device)
    e0, e1 = exclusion or (1, 1)
    inv_dr = _bin_boundary_constants(r_max, n_bins)[1]
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    _build.check(lib.pair_histogram_launch(
        pos.data_ptr(), counts.data_ptr(), pos.shape[0], n_bins,
        int(exclusion is not None), e0, e1, *map(float, box), float(inv_dr),
        stream), "first pair_histogram_launch")
    return counts


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default="ed37833")
    parser.add_argument("--out", help="also write the JSON summary here")
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args()
    first_dir = ROOT / "chip_archive" / "first_design" / args.parent
    if not (first_dir / "csrc").exists():
        names = extract(args.parent, first_dir / "csrc")
        print(f"wrote {len(names)} files of {args.parent}:{CSRC} to "
              f"{first_dir / 'csrc'}")

    import torch

    from mdhelper_tpu_torch.analysis.structure import _wavevector_grid
    from mdhelper_tpu_torch.ops import _build
    from mdhelper_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("no CUDA device: the comparison runs on the card")
        sys.exit(1)
    device = torch.device("cuda", 0)
    card = cs.card_line()
    start = time.perf_counter()
    libs = {"first": build(first_dir / "csrc", first_dir / "libfirst.so"),
            "new": _build.load_library()}
    libs["first"].pair_histogram_launch.argtypes = list(_FIRST_HIST_ARGS)
    print(f"{card}; designs built in {time.perf_counter() - start:.1f} s")
    logs = {"first": (first_dir / "libfirst.log").read_text(),
            "new": _build.build_info()["log"]}
    for design, log in logs.items():
        print(f"ptxas, {design} design:")
        print("\n".join(ptxas_lines(log)))

    def use(design):
        _build.load_library = lambda: libs[design]

    rng = np.random.default_rng(cs.SEED + 5)
    frames, box = cs.uniform_frames(rng, device, 2, cs.N_ATOMS,
                                    cs.cube(cs.N_ATOMS))
    qs = torch.from_numpy(_wavevector_grid([cs.BOX] * 3, cs.N_QPTS)).to(
        device)
    n_frames = frames.shape[0]
    rows = []
    for precision in ("exact", "fast"):
        designs = ["first", "new"]
        outs = {}
        for design in designs:
            use(design)
            outs[design] = ck.trig_sums(qs, frames, precision=precision)
        torch.cuda.synchronize()
        amp = float(torch.hypot(*outs["first"]).mean())
        if precision == "exact":
            cs.check(all(torch.equal(a, b) for a, b in
                         zip(outs["new"], outs["first"])),
                     "exact trig sums: new != first")
        else:
            err = max(float((a - b).abs().max()) for a, b in
                      zip(outs["new"], outs["first"]))
            cs.check(err <= 1e-4 * amp,
                     f"fast trig sums: new off first by {err:.3e}")
        ms = {design: [] for design in designs}
        for design in designs + designs[::-1]:
            use(design)
            ms[design].append(cs.time_ms(lambda: ck.trig_sums(
                qs, frames, precision=precision), 3) / n_frames)
        use("new")
        bound = cs.trig_bound(n_frames, cs.N_ATOMS, len(qs), precision,
                              lo=precision == "exact", weights=False)
        mean = {d: float(np.mean(v)) for d, v in ms.items()}
        rows.append({"kernel": "trig_sums", "precision": precision,
                     "ms": ms, "bound_ms": bound["bound_ms"],
                     "first_design_bound_ms": bound["first_design_bound_ms"],
                     "speedup": mean["first"] / mean["new"]})
        print(f"trig sums {precision}, {cs.N_ATOMS} atoms x {len(qs)} "
              f"float64 wavevectors, {n_frames} frames a launch: first "
              f"{mean['first']:.3f} ms a frame (runs "
              f"{[round(x, 3) for x in ms['first']]}), new "
              f"{mean['new']:.3f} (runs {[round(x, 3) for x in ms['new']]}),"
              f" {mean['first'] / mean['new']:.2f}x; bound "
              f"{bound['bound_ms']:.3f} ms "
              f"({100 * bound['bound_ms'] / mean['new']:.1f} %), first "
              f"count {bound['first_design_bound_ms']:.3f}; "
              + ("exact sums equal bit for bit" if precision == "exact"
                 else "within 1e-4 of the mean amplitude"), flush=True)
        del outs

    pos = frames[0].contiguous()
    for exclusion in ((1, 1), None):
        def first_call():
            return first_pair_histogram(libs["first"], pos, box, cs.R_MAX,
                                        cs.N_BINS, exclusion)

        def call(design):
            if design == "first":
                return first_call()
            use(design)
            return ck.pair_histogram(pos, box, cs.R_MAX, cs.N_BINS,
                                     exclusion=exclusion)

        designs = ["first", "new"]
        outs = {design: call(design) for design in designs}
        torch.cuda.synchronize()
        new = outs["new"]
        cs.check(all(torch.equal(outs[d], new) for d in designs),
                 f"pair histogram {exclusion}: the designs' counts differ")
        ms = {design: [] for design in designs}
        for design in designs + designs[::-1]:
            ms[design].append(cs.time_ms(lambda: call(design), 3))
        counted = int(new.sum()) - (cs.N_ATOMS if exclusion is None else 0)
        bound = cs.brute_bound(cs.N_ATOMS, cs.N_BINS, counted)
        mean = {d: float(np.mean(v)) for d, v in ms.items()}
        rows.append({"kernel": "pair_histogram", "exclusion": exclusion,
                     "ms": ms, "bound_ms": bound["bound_ms"],
                     "first_design_bound_ms": bound["first_design_bound_ms"],
                     "speedup": mean["first"] / mean["new"]})
        print(f"pair histogram {cs.N_ATOMS} atoms, exclusion {exclusion}: "
              f"first {mean['first']:.3f} ms (runs "
              f"{[round(x, 3) for x in ms['first']]}), new "
              f"{mean['new']:.3f} (runs {[round(x, 3) for x in ms['new']]}),"
              f" {mean['first'] / mean['new']:.2f}x; counts equal; bound "
              f"{bound['bound_ms']:.3f} ms "
              f"({100 * bound['bound_ms'] / mean['new']:.1f} %), first "
              f"count {bound['first_design_bound_ms']:.3f}", flush=True)

    if args.sass:
        import compare_sass

        for design, tree in (("first", first_dir / "csrc"),
                             ("new", ROOT / CSRC)):
            for patterns in SASS_PATTERNS:
                print(f"SASS loops, {design} design, {patterns[0]}:")
                listing = (None if args.out is None else ROOT / Path(
                    args.out).with_name(f"sass_{design}_{patterns[0]}.txt"))
                compare_sass.loop_report(list(patterns), listing, tree)
    summary = {"card": card, "rows": rows}
    if args.out:
        out = ROOT / args.out
        os.makedirs(out.parent, exist_ok=True)
        out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
