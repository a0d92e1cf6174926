"""Count the float instructions of ``sincosf`` in the SASS of sm_90a.

Usage (on a machine with the CUDA toolkit)::

    python scripts/sincos_sass.py

Compiles a probe kernel -- one precise ``sincosf`` of a loaded float,
both results stored -- with the port's ``NVCC_FLAGS``, disassembles it
with ``cuobjdump -sass`` and prints its instructions, then the count of
float-pipe instructions on the path of arguments under 105615, which the
trig-sums kernel takes, and in all.  The path is walked from the entry
to ``EXIT``: a conditional branch is taken when the code it jumps over
holds the Payne-Hanek reduction of larger arguments (the only float64 or
local-memory instructions of the function), otherwise it falls through;
an unconditional branch is always taken.  ``csrc/trig_sums.cu`` and
``chip_smoke.py`` count ``sincosf`` as the first number when they bound
the kernel.
"""

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mdhelper_tpu_torch.ops import _build  # noqa: E402

PROBE = r"""
extern "C" __global__ void sincos_probe(const float* x, float* s, float* c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float a, b;
  sincosf(x[i], &a, &b);
  s[i] = a;
  c[i] = b;
}
"""

#: SASS opcodes of the float pipes (arithmetic, compares, selects,
#: conversions and the special-function unit).
FLOAT_OPS = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
             "FRND", "FCHK", "F2I", "I2F", "I2FP", "F2F", "F2FP", "MUFU"}

_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def _parse(sass):
    """(address, predicate or "", opcode with modifiers, operands) a
    line."""

    out = []
    for line in sass.splitlines():
        match = _INSTRUCTION.search(line)
        if match:
            out.append((int(match.group(1), 16),
                        (match.group(2) or "").strip(), match.group(3),
                        match.group(4)))
    return out


def _slow_path(op):
    """Instructions found only in the large-argument reduction."""

    return (op.split(".")[0] in ("DMUL", "DADD", "DFMA", "LDL", "STL")
            or ".F64" in op)


def float_counts(sass):
    """(float instructions on the small-argument path, in all, the
    listing)."""

    instrs = _parse(sass)
    index = {addr: i for i, (addr, _, _, _) in enumerate(instrs)}
    total = sum(op.split(".")[0] in FLOAT_OPS for _, _, op, _ in instrs)
    fast, i, seen = 0, 0, set()
    while i < len(instrs) and i not in seen:
        seen.add(i)
        _, predicated, op, operands = instrs[i]
        base = op.split(".")[0]
        if base == "EXIT" and not predicated:
            break
        if base == "BRA":
            j = index[int(_TARGET.search(operands).group(1), 16)]
            skipped = instrs[i + 1:j] if j > i else []
            if not predicated or any(_slow_path(o) for _, _, o, _ in
                                     skipped):
                i = j
                continue
        fast += base in FLOAT_OPS
        i += 1
    listing = [f"/*{a:04x}*/ {p + ' ' if p else ''}{op}{rest}"
               for a, p, op, rest in instrs]
    return fast, total, listing


def main():
    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(nvcc).with_name("cuobjdump"))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "probe.cu"
        src.write_text(PROBE)
        cubin = Path(tmp) / "probe.cubin"
        subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)],
                       check=True)
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
    fast, total, lines = float_counts(sass)
    print("\n".join(lines))
    print(f"sincosf: {fast} float instructions on the path of arguments "
          f"under 105615, {total} in all")


if __name__ == "__main__":
    main()
