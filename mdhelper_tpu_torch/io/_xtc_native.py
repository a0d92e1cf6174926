"""
Loader for the native XTC codec
===============================

Builds :mod:`mdhelper_tpu_torch/io/_xtc_native.cpp` (the port's copy of
the JAX package's source) at first use with the system C++ compiler
into ``mdhelper_tpu_torch/_build/`` (ignored by git), keyed by a hash of
the source, and exposes the two entry points through :mod:`ctypes`.
The algorithmic reference is :mod:`mdhelper_tpu_torch.io.xtc`, whose
pure-Python codec is the plain version of this one and is used when no
compiler is available or when :data:`ENABLED` is false.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["ENABLED", "load", "native_decompress", "native_compress"]

_SRC = Path(__file__).resolve().parent / "_xtc_native.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_lib = None
_tried = False

#: load the native codec (tests set it false to run the Python codec).
ENABLED = True


def _build(source: Path, target: Path) -> bool:
    """Compile `source` into `target` with the first C++ compiler that
    works; the library is written under a temporary name in the build
    directory and renamed into place, so a concurrent build never loads
    a half-written file."""

    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    for cxx in ("g++", "c++", "clang++"):
        try:
            result = subprocess.run(
                [cxx, "-O3", "-fPIC", "-shared", "-o", str(tmp),
                 str(source)],
                capture_output=True,
                timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            continue
        if result.returncode == 0:
            os.replace(tmp, target)
            return True
    tmp.unlink(missing_ok=True)
    return False


def load():
    """Return the ctypes library, building it if needed; ``None`` when
    unavailable (disabled, no source, no compiler, build failure)."""

    global _lib, _tried
    if not ENABLED:
        return None
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    target = _BUILD / f"_xtc_native-{digest}.so"
    if not target.exists() and not _build(_SRC, target):
        return None
    try:
        lib = ctypes.CDLL(str(target))
    except OSError:
        return None
    lib.xtc_decompress.restype = ctypes.c_long
    lib.xtc_decompress.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.xtc_compress.restype = ctypes.c_long
    lib.xtc_compress.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_long,
    ]
    _lib = lib
    return _lib


def native_decompress(data: bytes, n_atoms: int):
    """Native payload decompression; returns ``(coords, consumed,
    precision)`` or ``None`` when the library is unavailable or
    rejects the stream."""

    lib = load()
    if lib is None:
        return None
    out = np.empty((n_atoms, 3), dtype=np.float32)
    precision = ctypes.c_float(0.0)
    consumed = lib.xtc_decompress(
        data,
        len(data),
        n_atoms,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(precision),
    )
    if consumed < 0:
        return None
    return out, int(consumed), float(precision.value)


def native_compress(coords: np.ndarray, precision: float):
    """Native payload compression; returns ``bytes`` or ``None``."""

    lib = load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    n_atoms = len(coords)
    # Worst case is ~102 bits/atom (3x32-bit coords + flag/run bits
    # on the wide-range path); 16 bytes/atom is a safe ceiling.
    cap = 16 * n_atoms + 1024
    out = np.empty(cap, dtype=np.uint8)
    written = lib.xtc_compress(
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_atoms,
        ctypes.c_float(precision),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        cap,
    )
    if written < 0:
        return None
    return out[:written].tobytes()
