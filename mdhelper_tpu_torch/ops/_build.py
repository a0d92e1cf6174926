"""
Build and load the hand-written CUDA kernels
============================================

At first use, every ``csrc/*.cu`` is compiled with ``nvcc`` into one
shared library with a plain C interface under
``mdhelper_tpu_torch/_build/`` (ignored by git), named by a hash of the
sources and flags so an edited source rebuilds, and loaded with
:mod:`ctypes`.  Pointers and the CUDA stream pass as ``c_void_p``; each C
entry point returns ``cudaGetLastError()`` and :func:`check` raises on a
non-zero value.

Only the machine with the card builds: there is no fallback, and a
missing ``nvcc`` raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "load_library", "check", "build_info"]

_PACKAGE = Path(__file__).resolve().parent.parent
_CSRC = _PACKAGE / "csrc"
_BUILD = _PACKAGE / "_build"

#: ``--fmad=false``: no fused multiply-add contraction anywhere (the
#: double-float error terms depend on separate roundings).  No
#: ``--use_fast_math``: division and sqrt stay IEEE.  ``-Xptxas -v``
#: records registers, shared memory and spills in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry points and their argument types.
_SIGNATURES = {
    "cell_pair_histogram_launch": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P,
    ),
}

_info = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc was not found (PATH or /usr/local/cuda/bin): the CUDA "
        "kernels cannot be built."
    )


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""

    sources = sorted(_CSRC.glob("*.cu"))
    headers = sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    _BUILD.mkdir(exist_ok=True)
    lib_path = _BUILD / f"libmdhelper_kernels-{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    start = time.perf_counter()
    if not lib_path.exists():
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [
            _nvcc(), *NVCC_FLAGS, "-I", str(_CSRC),
            "-o", str(tmp), *map(str, sources),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    _info["seconds"] = time.perf_counter() - start
    _info["path"] = str(lib_path)
    _info["log"] = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def build_info() -> dict:
    """Seconds the last :func:`load_library` build took, the library
    path, and nvcc's log (ptxas resource usage)."""

    return dict(_info)


def check(status: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""

    if status != 0:
        raise RuntimeError(f"{what} failed: CUDA error {status}.")
