"""
XTC trajectory codec
====================

Dependency-free reader/writer for GROMACS XTC compressed trajectories
— a copy of :mod:`mdhelper_tpu.io.xtc`, beside
:mod:`mdhelper_tpu_torch.io.dcd`.
Implemented at the byte level from the public XDR/xdrfile format
specification: big-endian XDR container + the ``xdr3dfcoord``
algorithm (fixed-point quantization, per-frame bounding box,
multi-radix packed integers, adaptive small-difference run-length
coding).

Frame layout (all XDR big-endian):

- ``int`` magic (1995), ``int`` natoms, ``int`` step, ``float`` time;
- 9 ``float`` box vectors (nm, row-major);
- ``int`` natoms again, then for > 9 atoms: ``float`` precision,
  ``int[3]`` minint, ``int[3]`` maxint, ``int`` smallidx,
  ``int`` byte count + that many opaque bytes (padded to 4);
  for <= 9 atoms the raw floats follow uncompressed.

A C++ accelerator for the inner bit loops is loaded transparently when
available (:mod:`mdhelper_tpu_torch.io._xtc_native`); this module is the
portable reference implementation and the only fallback needed.
"""

import os
import struct
from typing import Sequence

import numpy as np

__all__ = [
    "XTCFile",
    "read_xtc",
    "write_xtc",
    "compress_coords",
    "decompress_coords",
]

MAGIC = 1995

_MAGICINTS = np.array(
    [
        0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50,
        64, 80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812,
        1024, 1290, 1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192,
        10321, 13003, 16384, 20642, 26007, 32768, 41285, 52015, 65536,
        82570, 104031, 131072, 165140, 208063, 262144, 330280, 416127,
        524287, 660561, 832255, 1048576, 1321122, 1664510, 2097152,
        2642245, 3329021, 4194304, 5284491, 6658042, 8388607,
        10568983, 13316085, 16777216,
    ],
    dtype=np.int64,
)
_FIRSTIDX = 9
_LASTIDX = len(_MAGICINTS) - 1
_MAXABS = float(2**31 - 2)


def _sizeofint(size: int) -> int:
    """Bits needed to store an unsigned value in ``[0, size)``...
    (the xdrfile convention: smallest ``n`` with ``2**n > size - 1``,
    i.e. ``2**n >= size`` is not enough when ``size`` is a power of
    two — the C loop runs while ``size >= num``)."""

    num = 1
    nbits = 0
    while size >= num and nbits < 32:
        nbits += 1
        num <<= 1
    return nbits


def _sizeofints(sizes) -> int:
    """Bits needed for the multi-radix packing of one value per
    ``sizes`` entry (product-of-ranges magnitude, computed in byte
    arithmetic exactly as consumers of the format expect)."""

    product = 1
    for s in sizes:
        product *= int(s)
    # product = (num_of_bytes full bytes) * 256^k + leading byte
    nbytes = 0
    while product >= 256:
        product >>= 8
        nbytes += 1
    nbits = 0
    num = 1
    while product >= num:
        nbits += 1
        num *= 2
    return nbits + nbytes * 8


class _BitWriter:
    """MSB-first bit stream over a growable byte buffer."""

    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0  # pending bits, MSB-aligned within _nbits
        self._nbits = 0

    def write(self, nbits: int, value: int) -> None:
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (
            value & ((1 << nbits) - 1)
        )
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_ints(self, nbits: int, sizes, nums) -> None:
        """Multi-radix packing: combine ``nums`` into one big integer
        (last entry fastest-varying), stored as little-endian bytes
        each sent MSB-first in ``nbits`` total."""

        big = int(nums[0])
        for s, n in zip(sizes[1:], nums[1:]):
            big = big * int(s) + int(n)
        nbytes = max(1, (big.bit_length() + 7) // 8)
        le = big.to_bytes(nbytes, "little")
        if nbits >= nbytes * 8:
            for b in le:
                self.write(8, b)
            self.write(nbits - nbytes * 8, 0)
        else:
            for b in le[:-1]:
                self.write(8, b)
            self.write(nbits - (nbytes - 1) * 8, le[-1])

    def getvalue(self) -> bytes:
        out = bytes(self._bytes)
        if self._nbits:
            out += bytes(
                [(self._acc << (8 - self._nbits)) & 0xFF]
            )
        return out


class _BitReader:
    """MSB-first bit stream over a bytes object."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0  # bit position

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        pos = self._pos
        self._pos = pos + nbits
        out = 0
        data = self._data
        while nbits > 0:
            byte_i, bit_o = divmod(pos, 8)
            take = min(8 - bit_o, nbits)
            chunk = (data[byte_i] >> (8 - bit_o - take)) & (
                (1 << take) - 1
            )
            out = (out << take) | chunk
            pos += take
            nbits -= take
        return out

    def read_ints(self, nbits: int, sizes) -> list:
        """Inverse of :meth:`_BitWriter.write_ints`."""

        nbytes = nbits // 8
        rem = nbits - nbytes * 8
        le = [self.read(8) for _ in range(nbytes)]
        if rem:
            le.append(self.read(rem))
        big = 0
        for b in reversed(le):
            big = (big << 8) | b
        nums = [0] * len(sizes)
        for i in range(len(sizes) - 1, 0, -1):
            big, nums[i] = divmod(big, int(sizes[i]))
        nums[0] = big & 0xFFFFFFFF
        return nums


# ---------------------------------------------------------------------
# xdr3dfcoord compression / decompression (payload level)
# ---------------------------------------------------------------------
def compress_coords(
    coords: np.ndarray,
    precision: float = 1000.0,
    *,
    use_native: bool = True,
) -> bytes:
    """Compress an ``(N, 3)`` float coordinate block into the
    xdr3dfcoord payload that follows the ``natoms`` word in an XTC
    frame (precision, bounds, smallidx, byte count, packed bits)."""

    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    out = bytearray()
    if n <= 9:
        out += coords.astype(">f4").tobytes()
        return bytes(out)

    if use_native:
        from ._xtc_native import native_compress

        native = native_compress(coords, precision)
        if native is not None:
            return native

    scaled = coords * precision
    if np.any(np.abs(scaled) >= _MAXABS):
        raise ValueError(
            "Coordinates too large for the requested XTC precision."
        )
    ints = np.where(
        scaled >= 0, scaled + 0.5, scaled - 0.5
    ).astype(np.int64)
    minint = ints.min(axis=0)
    maxint = ints.max(axis=0)
    if np.any(maxint.astype(float) - minint.astype(float) >= _MAXABS):
        raise ValueError("Coordinate spread too large for XTC.")
    sizeint = (maxint - minint + 1).astype(np.int64)
    if int(sizeint[0]) | int(sizeint[1]) | int(sizeint[2]) > 0xFFFFFF:
        bitsizeint = [_sizeofint(int(s)) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _sizeofints(sizeint)

    # Smallest inter-atom delta (after the first atom) picks the
    # starting small-number radix.
    diffs = np.abs(np.diff(ints, axis=0)).sum(axis=1)
    mindiff = int(diffs.min()) if len(diffs) else 2**31 - 1
    smallidx = _FIRSTIDX
    while smallidx < _LASTIDX and _MAGICINTS[smallidx] < mindiff:
        smallidx += 1

    out += struct.pack(">f", precision)
    out += struct.pack(
        ">6i", *(int(v) for v in minint), *(int(v) for v in maxint)
    )
    out += struct.pack(">i", smallidx)

    maxidx = min(_LASTIDX, smallidx + 8)
    minidx = maxidx - 8
    smaller = int(_MAGICINTS[max(_FIRSTIDX, smallidx - 1)]) // 2
    smallnum = int(_MAGICINTS[smallidx]) // 2
    sizesmall = [int(_MAGICINTS[smallidx])] * 3
    larger = int(_MAGICINTS[maxidx]) // 2

    w = _BitWriter()
    work = ints.copy()
    prev = np.zeros(3, dtype=np.int64)
    prevrun = -1
    i = 0
    while i < n:
        is_small = False
        this = work[i]
        if (
            smallidx < maxidx
            and i >= 1
            and np.all(np.abs(this - prev) < larger)
        ):
            is_smaller = 1
        elif smallidx > minidx:
            is_smaller = -1
        else:
            is_smaller = 0
        if i + 1 < n and np.all(
            np.abs(this - work[i + 1]) < smallnum
        ):
            # Interchange with the next atom (water-molecule trick);
            # the decompressor swaps back.
            work[[i, i + 1]] = work[[i + 1, i]]
            this = work[i]
            is_small = True

        tmp = this - minint
        if bitsize == 0:
            for k in range(3):
                w.write(bitsizeint[k], int(tmp[k]))
        else:
            w.write_ints(bitsize, sizeint, tmp)
        prev = this.copy()
        i += 1

        run_vals = []
        if not is_small and is_smaller == -1:
            is_smaller = 0
        while is_small and len(run_vals) < 8 * 3:
            this = work[i]
            if is_smaller == -1 and int(
                ((this - prev) ** 2).sum()
            ) >= smaller * smaller:
                is_smaller = 0
            run_vals += [
                int(this[0] - prev[0]) + smallnum,
                int(this[1] - prev[1]) + smallnum,
                int(this[2] - prev[2]) + smallnum,
            ]
            prev = this.copy()
            i += 1
            is_small = i < n and np.all(
                np.abs(work[i] - prev) < smallnum
            )
        run = len(run_vals)
        if run != prevrun or is_smaller != 0:
            prevrun = run
            w.write(1, 1)
            w.write(5, run + is_smaller + 1)
        else:
            w.write(1, 0)
        for k in range(0, run, 3):
            w.write_ints(smallidx, sizesmall, run_vals[k:k + 3])
        if is_smaller != 0:
            smallidx += is_smaller
            if is_smaller < 0:
                smallnum = smaller
                smaller = int(_MAGICINTS[max(0, smallidx - 1)]) // 2
            else:
                smaller = smallnum
                smallnum = int(_MAGICINTS[smallidx]) // 2
            sizesmall = [int(_MAGICINTS[smallidx])] * 3

    packed = w.getvalue()
    out += struct.pack(">i", len(packed))
    out += packed
    out += b"\x00" * (-len(packed) % 4)
    return bytes(out)


def decompress_coords(
    data: bytes, n_atoms: int, *, use_native: bool = True
):
    """Decompress one xdr3dfcoord payload.

    Returns ``(coords (N, 3) float32, bytes_consumed, precision)``.
    """

    if n_atoms <= 9:
        nb = 12 * n_atoms
        coords = np.frombuffer(data[:nb], dtype=">f4").reshape(
            n_atoms, 3
        )
        return coords.astype(np.float32), nb, 0.0

    if use_native:
        from ._xtc_native import native_decompress

        native = native_decompress(bytes(data), n_atoms)
        if native is not None:
            return native

    (precision,) = struct.unpack(">f", data[:4])
    minint = np.array(struct.unpack(">3i", data[4:16]), dtype=np.int64)
    maxint = np.array(
        struct.unpack(">3i", data[16:28]), dtype=np.int64
    )
    (smallidx,) = struct.unpack(">i", data[28:32])
    (nbytes,) = struct.unpack(">i", data[32:36])
    packed = data[36:36 + nbytes]
    consumed = 36 + nbytes + (-nbytes % 4)

    sizeint = maxint - minint + 1
    if int(sizeint[0]) | int(sizeint[1]) | int(sizeint[2]) > 0xFFFFFF:
        bitsizeint = [_sizeofint(int(s)) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _sizeofints(sizeint)

    smaller = int(_MAGICINTS[max(_FIRSTIDX, smallidx - 1)]) // 2
    smallnum = int(_MAGICINTS[smallidx]) // 2
    sizesmall = [int(_MAGICINTS[smallidx])] * 3

    r = _BitReader(packed)
    out = np.empty((n_atoms, 3), dtype=np.int64)
    inv = 1.0 / precision
    run = 0
    i = 0
    while i < n_atoms:
        if bitsize == 0:
            this = [r.read(bitsizeint[k]) for k in range(3)]
        else:
            this = r.read_ints(bitsize, sizeint)
        this = [int(v + m) for v, m in zip(this, minint)]
        big_slot = i
        i += 1
        prev = list(this)
        flag = r.read(1)
        is_smaller = 0
        if flag:
            v = r.read(5)
            is_smaller = v % 3
            run = v - is_smaller
            is_smaller -= 1
        if run > 0:
            first = True
            for _ in range(0, run, 3):
                vals = r.read_ints(smallidx, sizesmall)
                cur = [
                    v + p - smallnum for v, p in zip(vals, prev)
                ]
                if first:
                    # Undo the compressor's first/second interchange.
                    cur, prev = prev, cur
                    out[big_slot] = prev
                    first = False
                else:
                    prev = list(cur)
                out[i] = cur
                i += 1
            # After the k==0 swap, `prev` intentionally trails one
            # behind `cur` only in the first iteration (matches the
            # format's reference behavior).
        else:
            out[big_slot] = this
        smallidx += is_smaller
        if is_smaller < 0:
            smallnum = smaller
            smaller = (
                int(_MAGICINTS[smallidx - 1]) // 2
                if smallidx > _FIRSTIDX
                else 0
            )
        elif is_smaller > 0:
            smaller = smallnum
            smallnum = int(_MAGICINTS[smallidx]) // 2
        sizesmall = [int(_MAGICINTS[smallidx])] * 3

    coords = (out * inv).astype(np.float32)
    return coords, consumed, float(precision)


# ---------------------------------------------------------------------
# File level
# ---------------------------------------------------------------------
def _frame_header(data: bytes, offset: int):
    try:
        magic, natoms, step = struct.unpack_from(">3i", data, offset)
    except struct.error:
        raise ValueError(
            f"Truncated XTC frame header at byte {offset}."
        ) from None
    if magic != MAGIC:
        raise ValueError(
            f"Bad XTC magic {magic} at byte {offset} (expected "
            f"{MAGIC})."
        )
    (time,) = struct.unpack_from(">f", data, offset + 12)
    box = np.frombuffer(
        data, dtype=">f4", count=9, offset=offset + 16
    ).reshape(3, 3)
    (lsize,) = struct.unpack_from(">i", data, offset + 52)
    return natoms, step, time, box, lsize


class XTCFile:
    """An XTC trajectory opened for reading (whole-file index built on
    open; frames decompress lazily and individually)."""

    def __init__(self, filename: str):
        import mmap

        self.filename = filename
        self._fh = open(filename, "rb")
        try:
            # Lazy paging: multi-GB trajectories never load whole.
            self._data = mmap.mmap(
                self._fh.fileno(), 0, access=mmap.ACCESS_READ
            )
        except (ValueError, OSError):  # empty file etc.
            self._data = self._fh.read()
        self._index()

    def _index(self) -> None:
        self._offsets = []
        self.steps = []
        self.times = []
        offset = 0
        data = self._data
        n_atoms = None
        while offset < len(data):
            natoms, step, time, _box, lsize = _frame_header(
                data, offset
            )
            if n_atoms is None:
                n_atoms = natoms
            elif natoms != n_atoms:
                raise ValueError(
                    "Variable atom counts are not supported."
                )
            self._offsets.append(offset)
            self.steps.append(step)
            self.times.append(time)
            body = offset + 56
            if lsize <= 9:
                offset = body + 12 * lsize
            else:
                (nbytes,) = struct.unpack_from(
                    ">i", data, body + 32
                )
                offset = body + 36 + nbytes + (-nbytes % 4)
        self.n_atoms = int(n_atoms or 0)
        self.n_frames = len(self._offsets)
        self.times = np.asarray(self.times, dtype=np.float64)
        self.steps = np.asarray(self.steps, dtype=np.int64)

    def read_frame(self, index: int):
        """Read one frame: ``(positions (N, 3) float32 nm,
        box (3, 3) float32 nm, step, time)``."""

        offset = self._offsets[index]
        end = (
            self._offsets[index + 1]
            if index + 1 < self.n_frames
            else len(self._data)
        )
        _natoms, step, time, box, lsize = _frame_header(
            self._data, offset
        )
        coords, _consumed, _prec = decompress_coords(
            self._data[offset + 56:end], lsize
        )
        return coords, box.astype(np.float32), step, time

    def read_frames(self, indices: Sequence[int]):
        indices = np.asarray(indices, dtype=int)
        pos = np.empty((len(indices), self.n_atoms, 3), np.float32)
        boxes = np.empty((len(indices), 3, 3), np.float32)
        for out, i in enumerate(indices):
            pos[out], boxes[out], _, _ = self.read_frame(int(i))
        return pos, boxes

    def close(self) -> None:
        import mmap

        if isinstance(self._data, mmap.mmap):
            self._data.close()
        self._data = b""
        fh = getattr(self, "_fh", None)
        if fh is not None:
            fh.close()


def read_xtc(filename: str):
    """Read a whole XTC file: ``(positions (F, N, 3) float32 nm,
    boxes (F, 3, 3) float32 nm, steps (F,), times (F,))``."""

    xtc = XTCFile(filename)
    pos, boxes = xtc.read_frames(range(xtc.n_frames))
    return pos, boxes, xtc.steps, xtc.times


def write_xtc(
    filename: str,
    positions: np.ndarray,
    boxes: np.ndarray = None,
    *,
    precision: float = 1000.0,
    steps: np.ndarray = None,
    times: np.ndarray = None,
    dt: float = 1.0,
) -> None:
    """Write an XTC file.

    Parameters
    ----------
    positions : `numpy.ndarray`
        ``(n_frames, n_atoms, 3)`` coordinates in nm.
    boxes : `numpy.ndarray`, optional
        ``(3, 3)`` or ``(n_frames, 3, 3)`` box matrices in nm
        (zeros when omitted).
    precision : `float`
        Fixed-point quantization scale (1000 = 0.001 nm, the GROMACS
        default).
    """

    positions = np.asarray(positions, dtype=np.float64)
    if positions.ndim != 3 or positions.shape[-1] != 3:
        raise ValueError(
            "positions must have shape (n_frames, n_atoms, 3); got "
            f"{positions.shape}."
        )
    n_frames, n_atoms = positions.shape[:2]
    if boxes is None:
        boxes = np.zeros((n_frames, 3, 3))
    else:
        boxes = np.asarray(boxes, dtype=np.float64)
        given = boxes.shape
        if boxes.ndim == 2:
            boxes = np.tile(boxes, (n_frames, 1, 1))
        if boxes.shape != (n_frames, 3, 3):
            raise ValueError(
                "boxes must have shape (3, 3) or (n_frames, 3, 3); "
                f"got {given}."
            )
    if steps is None:
        steps = np.arange(n_frames)
    if times is None:
        times = np.asarray(steps, dtype=float) * dt

    with XTCWriter(filename, precision=precision, dt=dt) as writer:
        for f in range(n_frames):
            writer.write(
                positions[f], boxes[f],
                step=int(steps[f]), time=float(times[f]),
            )


class XTCWriter:
    """Streaming XTC writer — append one frame at a time without
    materializing the whole trajectory (the MDAnalysis ``Writer``
    idiom the reference's users rely on; :func:`write_xtc` is the
    whole-array convenience over this).

    Frames are independent records in XTC, so streaming is a plain
    append.  Coordinates and boxes are in nm (the format's native
    unit, like :func:`write_xtc`).

    >>> with XTCWriter("out.xtc") as w:
    ...     for frame in frames:
    ...         w.write(frame, box)
    """

    def __init__(
        self,
        filename: str,
        *,
        n_atoms: int = None,
        precision: float = 1000.0,
        dt: float = 1.0,
    ) -> None:
        self._fh = open(filename, "wb")
        self._n_atoms = None if n_atoms is None else int(n_atoms)
        self._precision = float(precision)
        self._dt = float(dt)
        self._step = 0

    def write(
        self, positions, box=None, *, step=None, time=None
    ) -> None:
        """Append one frame: `positions` ``(n_atoms, 3)`` nm, `box`
        ``(3, 3)`` nm (zeros when omitted).  `step` defaults to an
        auto-incrementing counter, `time` to ``step * dt``."""

        positions = np.asarray(positions, dtype=np.float64)
        if positions.ndim != 2 or positions.shape[-1] != 3:
            raise ValueError(
                "positions must have shape (n_atoms, 3); got "
                f"{positions.shape}."
            )
        if self._n_atoms is None:
            self._n_atoms = positions.shape[0]
        elif positions.shape[0] != self._n_atoms:
            raise ValueError(
                f"Frame has {positions.shape[0]} atoms; this file "
                f"holds {self._n_atoms}-atom frames."
            )
        step = self._step if step is None else int(step)
        time = step * self._dt if time is None else float(time)
        box = (
            np.zeros((3, 3))
            if box is None
            else np.asarray(box, dtype=np.float64)
        )
        n_atoms = positions.shape[0]
        self._fh.write(
            struct.pack(">3if", MAGIC, n_atoms, step, time)
        )
        self._fh.write(box.astype(">f4").tobytes())
        self._fh.write(struct.pack(">i", n_atoms))
        self._fh.write(compress_coords(positions, self._precision))
        self._step = step + 1

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "XTCWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
