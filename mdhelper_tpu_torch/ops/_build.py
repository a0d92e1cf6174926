"""
Build and load the hand-written CUDA kernels
============================================

At first use, every ``csrc/*.cu`` is compiled with ``nvcc`` -- one
process per source, all started together -- and the objects are linked
into one shared library with a plain C interface under
``mdhelper_tpu_torch/_build/`` (ignored by git), named by a hash of the
sources and flags so an edited source rebuilds, and loaded with
:mod:`ctypes`.  The build holds an exclusive ``fcntl.flock`` on the
build directory, so processes that start together (the ranks of one
job) build the library once and all load the same file.  Pointers and
the CUDA stream pass as ``c_void_p``; each C entry point returns
``cudaGetLastError()`` and :func:`check` raises on a non-zero value.

Only the machine with the card builds: there is no fallback, and a
missing ``nvcc`` raises.
"""

import contextlib
import ctypes
import fcntl
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the link of the objects into one shared library (runtime linked
#: statically, nvcc's default).
_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: the binning arguments every entry point ends with, before the stream:
#: the fast flag, the offset flag and the convention's 8 constants.
_BINS = (_I, _I) + (_F,) * 8

#: the self entry points' tile-exclusion arguments: the tile flag, the
#: asymmetric flag and the second-id side table.
_TILES = (_I, _I, _P)

#: C entry points and their argument types.
_SIGNATURES = {
    "cell_pair_histogram_launch": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, *_TILES, *_BINS, _P,
    ),
    "tri_pp_cell_pair_histogram_launch": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, *_TILES, *_BINS, _P,
    ),
    "tri_pp_cross_pair_histogram_launch": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        *_BINS, _P,
    ),
    "cross_pair_histogram_launch": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        *_BINS, _P,
    ),
    "triclinic_cell_pair_histogram_launch": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, *_TILES, *_BINS,
        _P,
    ),
    "triclinic_cross_pair_histogram_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        *_BINS, _P,
    ),
    "trig_sums_launch": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P,
    ),
    "pair_histogram_launch": (
        _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P,
    ),
    "factor_sums_launch": (
        _P, _P, _P, _P, _P, _P, *(_I,) * 16, *(_F,) * 5, _P,
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + _LINK_FLAGS).encode())
    for path in sources + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    _BUILD.mkdir(exist_ok=True)
    lib_path = _BUILD / f"libmdhelper_kernels-{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    start = time.perf_counter()
    _build_once(lib_path, lambda: _compile_and_link(sources, lib_path,
                                                    log_path))
    _info["seconds"] = time.perf_counter() - start
    _info["path"] = str(lib_path)
    _info["log"] = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def _locked(directory):
    """Hold an exclusive ``flock`` on `directory` (waiting for it)."""

    fd = os.open(directory, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # closing the descriptor releases the lock


def _build_once(lib_path, build) -> None:
    """Call ``build()`` unless `lib_path` exists, under the lock of its
    directory: of processes that arrive together, the first builds and
    the others wait, then find the file."""

    if lib_path.exists():
        return
    with _locked(lib_path.parent):
        if not lib_path.exists():
            build()


def _compile_and_link(sources, lib_path, log_path) -> None:
    """One ``nvcc -c`` per source, run in parallel, then one link."""

    stem = f"{lib_path.name}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        obj = lib_path.with_name(f"{stem}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o", str(obj),
               str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )))
    log, failed = [], []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = lib_path.with_name(f"{stem}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, *_LINK_FLAGS, "-o", str(tmp),
             *[str(obj) for _, obj, _ in jobs]],
            capture_output=True, text=True,
        )
        log.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    log_path.write_text("".join(log))
    if failed:
        raise RuntimeError(
            f"nvcc failed ({', '.join(failed)}):\n{''.join(log)}"
        )
    os.replace(tmp, lib_path)


def build_info() -> dict:
    """Seconds the last :func:`load_library` build took, the library
    path, and nvcc's log (ptxas resource usage)."""

    return dict(_info)


def check(status: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""

    if status != 0:
        raise RuntimeError(f"{what} failed: CUDA error {status}.")
