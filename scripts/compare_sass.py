"""Compare the SASS of two trees' cell-list kernels; print their registers.

Usage::

    python scripts/compare_sass.py OLD_CSRC [NEW_CSRC] [--out FILE]
    python scripts/compare_sass.py --loops PATTERN [--loops ...] [--tree DIR]
        [--out FILE]

With ``--loops`` only one tree is compiled (``--tree``, default the
current ``mdhelper_tpu_torch/csrc``), and for every kernel
whose demangled name contains every PATTERN the script prints each loop of its
SASS (the instructions from a backward branch's target to the branch),
innermost first, with its length and its instructions by opcode, and then
the kernel's whole SASS.

Compiles every ``*.cu`` of both source directories (``NEW_CSRC`` defaults
to ``mdhelper_tpu_torch/csrc``) with the port's nvcc flags
(``ops/_build.NVCC_FLAGS``), one nvcc process per source, all started
together, and times each tree's build.  ``cuobjdump -sass`` then gives each
kernel's instructions (addresses and encodings dropped) and ``cuobjdump
-res-usage`` its registers.  Every kernel of the old tree is matched to the
new kernel of the same geometry and sweep that bins from 0, exactly, with
no tile exclusion (the new template arguments ``cellbin::ZeroExact`` and
``NoTiles`` removed from its name), and the two instruction lists are
compared: the script prints, a kernel a line, whether they are identical
(else how many instructions differ), then every new kernel's registers,
and exits non-zero when a matched pair differs or an old kernel has no
match.  Needs the CUDA toolkit (the machine with the card).
"""

import argparse
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mdhelper_tpu_torch.ops import _build  # noqa: E402

#: template arguments the new kernels added for the policies of the old
#: code: bins from 0, exact; no tile exclusion (cu++filt spells the
#: anonymous namespace either way).
_NEW_DEFAULTS = re.compile(
    r", (?:cellbin::ZeroExact|(?:<unnamed>|\(anonymous namespace\))::NoTiles)"
    r"(?=[,>])")


def _tool(name):
    nvcc = Path(_build._nvcc())
    return str(nvcc.with_name(name))


def compile_tree(csrc, out_dir):
    """One object per ``*.cu`` of `csrc`, compiled in parallel; returns
    the objects and the wall seconds."""

    start = time.perf_counter()
    jobs = []
    for src in sorted(Path(csrc).glob("*.cu")):
        obj = Path(out_dir) / f"{src.stem}.o"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-c",
               "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    for obj, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{log}")
    return [obj for obj, _ in jobs], time.perf_counter() - start


def _demangle(names):
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True)
    return dict(zip(names, out.stdout.splitlines()))


def kernels(objects):
    """``{demangled kernel: [instruction, ...]}`` of the objects."""

    code = {}
    for obj in objects:
        text = subprocess.run([_tool("cuobjdump"), "-sass", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
        name = None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                name = m.group(1)
                code[name] = []
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m and name:
                code[name].append(m.group(1))
    names = _demangle(list(code))
    return {names[k]: v for k, v in code.items()}


def registers(objects):
    """``{demangled kernel: registers}`` (``cuobjdump -res-usage``)."""

    regs = {}
    for obj in objects:
        text = subprocess.run([_tool("cuobjdump"), "-res-usage", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
        name = None
        for line in text.splitlines():
            m = re.match(r"\s*Function (\S+):", line)
            if m:
                name = m.group(1)
            m = re.search(r"REG:(\d+)", line)
            if m and name:
                regs[name] = int(m.group(1))
                name = None
    names = _demangle(list(regs))
    return {names[k]: v for k, v in regs.items()}


def sass_with_addresses(objects):
    """``{demangled kernel: [(address, instruction), ...]}``."""

    code = {}
    for obj in objects:
        text = subprocess.run([_tool("cuobjdump"), "-sass", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
        name = None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                name = m.group(1)
                code[name] = []
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m and name:
                code[name].append((int(m.group(1), 16), m.group(2)))
    names = _demangle(list(code))
    return {names[k]: v for k, v in code.items()}


def loops(code):
    """Each loop of a kernel's SASS as (first address, branch address,
    instructions), smallest first."""

    found = []
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            target = int(m.group(1), 16)
            body = [i for a, i in code if target <= a <= addr]
            found.append((target, addr, body))
    return sorted(found, key=lambda x: len(x[2]))


def loop_report(patterns, out, tree=None):
    """The --loops report (see the module docstring) of the sources in
    `tree` (default the package's csrc/); returns its summary lines."""

    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        objs, secs = compile_tree(tree or ROOT / "mdhelper_tpu_torch" / "csrc",
                                  tmp)
        code = sass_with_addresses(objs)
    for name, ins in sorted(code.items()):
        if not all(p in name for p in patterns):
            continue
        lines.append(f"== {signature(name)}: {len(ins)} instructions")
        for first, last, body in loops(ins):
            ops = {}
            for i in body:
                op = re.sub(r"^@!?U?P\w+\s+", "", i).split()[0]
                ops[op] = ops.get(op, 0) + 1
            hist = ", ".join(f"{k} {v}" for k, v in
                             sorted(ops.items(), key=lambda kv: -kv[1]))
            lines.append(f"  loop {first:#x}-{last:#x}: {len(body)} "
                         f"instructions: {hist}")
        lines += [f"    /*{a:04x}*/ {i}" for a, i in ins]
    text = "\n".join(lines)
    summary = [line for line in lines if not line.startswith("    /*")]
    print("\n".join(summary))
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(text + "\n")
    return summary


def signature(name):
    """A demangled kernel's name with its template arguments, without
    its parameter list."""

    if "_kernel<" not in name:
        return name
    start = name.index("_kernel<") + len("_kernel")
    depth = 0
    for i in range(start, len(name)):
        depth += {"<": 1, ">": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i + 1]
    return name


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old", nargs="?")
    parser.add_argument("new", nargs="?",
                        default=str(ROOT / "mdhelper_tpu_torch" / "csrc"))
    parser.add_argument("--out", help="also write the report here")
    parser.add_argument("--loops", metavar="PATTERN", action="append",
                        help="report the loops of the kernels whose names "
                        "hold every such pattern")
    parser.add_argument("--tree", help="with --loops: the source directory "
                        "(default mdhelper_tpu_torch/csrc)")
    args = parser.parse_args()
    if args.loops:
        loop_report(args.loops, args.out, args.tree)
        return
    if args.old is None:
        parser.error("OLD_CSRC is needed unless --loops is given")
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        old_dir, new_dir = Path(tmp, "old"), Path(tmp, "new")
        old_dir.mkdir()
        new_dir.mkdir()
        old_objs, old_s = compile_tree(args.old, old_dir)
        new_objs, new_s = compile_tree(args.new, new_dir)
        lines.append(f"build: old {old_s:.1f} s ({len(old_objs)} sources), "
                     f"new {new_s:.1f} s ({len(new_objs)} sources), nvcc "
                     "processes in parallel")
        old, new = kernels(old_objs), kernels(new_objs)
        new_regs = registers(new_objs)
    by_key = {}
    for name, code in new.items():
        key = signature(name)
        key, n_defaults = _NEW_DEFAULTS.subn("", key)
        if n_defaults == (2 if "cell_pair" in key else 1):
            by_key[key] = (name, code)
    bad = 0
    for name, code in sorted(old.items()):
        key = signature(name)
        if key not in by_key:
            lines.append(f"NO MATCH {key}")
            bad += 1
            continue
        new_name, new_code = by_key[key]
        differ = sum(a != b for a, b in zip(code, new_code)) + abs(
            len(code) - len(new_code))
        bad += differ > 0
        lines.append(
            f"{'identical' if not differ else f'{differ} differ'}: {key} "
            f"({len(code)} instructions) -> {signature(new_name)} "
            f"({len(new_code)})")
    lines.append(f"{len(new_regs)} new kernels; registers:")
    for name, regs in sorted(new_regs.items(),
                             key=lambda kv: signature(kv[0])):
        lines.append(f"  {regs:3d} {signature(name)}")
    text = "\n".join(lines)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
