"""
TRR trajectory codec
====================

Dependency-free reader/writer for GROMACS TRR full-precision
trajectories (the XDR ``trn`` container: per-frame header with
section byte sizes, then box/virial/pressure/positions/velocities/
forces arrays in float32 or float64).  With :mod:`~mdhelper_tpu_torch.io.
dcd` and :mod:`~mdhelper_tpu_torch.io.xtc` this completes the common
GROMACS/CHARMM format reach the reference inherits from MDAnalysis.

Frame layout (big-endian XDR):

- ``int`` magic (1993);
- version string (``int`` length incl. NUL + bytes padded to 4);
- 10 ``int`` section sizes: ir, e, box, vir, pres, top, sym, x, v, f
  (bytes; 0 = absent — float width is inferred from box/x sizes);
- ``int`` natoms, ``int`` step, ``int`` nre;
- time + lambda (in the inferred float width);
- the sections present, each ``size`` bytes.
"""

import struct
from typing import Sequence

import numpy as np

__all__ = ["TRRFile", "read_trr", "write_trr"]

MAGIC = 1993
_VERSION = b"GMX_trn_file"


def _float_width(box_size: int, x_size: int, n_atoms: int) -> int:
    if box_size:
        return box_size // 9
    if x_size and n_atoms:
        return x_size // (3 * n_atoms)
    return 4


class TRRFile:
    """A TRR trajectory opened for reading (whole-file index built on
    open; sections decode lazily per frame)."""

    def __init__(self, filename: str):
        import mmap

        self.filename = filename
        self._fh = open(filename, "rb")
        try:
            # Lazy paging: multi-GB trajectories never load whole.
            self._data = mmap.mmap(
                self._fh.fileno(), 0, access=mmap.ACCESS_READ
            )
        except (ValueError, OSError):
            self._data = self._fh.read()
        self._index()

    def _parse_header(self, offset: int):
        data = self._data
        try:
            (magic,) = struct.unpack_from(">i", data, offset)
        except struct.error:
            raise ValueError(
                f"Truncated TRR frame header at byte {offset}."
            ) from None
        if magic != MAGIC:
            raise ValueError(
                f"Bad TRR magic {magic} at byte {offset} (expected "
                f"{MAGIC})."
            )
        (slen,) = struct.unpack_from(">i", data, offset + 4)
        # GROMACS writes strlen+1 then the characters WITHOUT the
        # NUL, padded to 4.
        nchars = slen - 1
        pos = offset + 8 + nchars + (-nchars % 4)
        sizes = struct.unpack_from(">10i", data, pos)
        (ir, e, box, vir, pres, top, sym, x, v, f) = sizes
        natoms, step, nre = struct.unpack_from(">3i", data, pos + 40)
        pos += 52
        width = _float_width(box, x, natoms)
        fmt = ">d" if width == 8 else ">f"
        (time,) = struct.unpack_from(fmt, data, pos)
        (lam,) = struct.unpack_from(fmt, data, pos + width)
        pos += 2 * width
        header = {
            "ir": ir, "e": e, "box": box, "vir": vir, "pres": pres,
            "top": top, "sym": sym, "x": x, "v": v, "f": f,
            "natoms": natoms, "step": step, "nre": nre,
            "time": time, "lambda": lam, "width": width,
        }
        body = pos
        frame_end = (
            body + ir + e + box + vir + pres + top + sym + x + v + f
        )
        return header, body, frame_end

    def _index(self) -> None:
        self._frames = []
        self.times = []
        self.steps = []
        offset = 0
        n_atoms = None
        while offset < len(self._data):
            header, body, end = self._parse_header(offset)
            if n_atoms is None:
                n_atoms = header["natoms"]
            elif header["natoms"] != n_atoms:
                raise ValueError(
                    "Variable atom counts are not supported."
                )
            self._frames.append((offset, header, body))
            self.times.append(header["time"])
            self.steps.append(header["step"])
            offset = end
        self.n_atoms = int(n_atoms or 0)
        self.n_frames = len(self._frames)
        self.times = np.asarray(self.times, dtype=np.float64)
        self.steps = np.asarray(self.steps, dtype=np.int64)

    @property
    def has_velocities(self) -> bool:
        """True only when EVERY frame stores a velocity section
        (GROMACS commonly writes velocities at a sparser interval
        than positions — ``nstvout != nstxout`` — so a frame-0 probe
        would claim velocities and then fail mid-stream).  Header
        sizes come from the index; nothing decodes."""

        return bool(self._frames) and all(
            header["v"] > 0 for _, header, _ in self._frames
        )

    @property
    def has_forces(self) -> bool:
        """True only when EVERY frame stores a force section (same
        contract as :attr:`has_velocities`)."""

        return bool(self._frames) and all(
            header["f"] > 0 for _, header, _ in self._frames
        )

    def read_frame(self, index: int):
        """Read one frame: dict with ``box (3, 3)``, ``positions``,
        ``velocities``, ``forces`` (each ``(N, 3)`` float64 nm-based
        GROMACS units, or None when absent), ``step``, ``time``."""

        offset, header, body = self._frames[index]
        data = self._data
        width = header["width"]
        dtype = ">f8" if width == 8 else ">f4"
        pos = body + header["ir"] + header["e"]

        def array(nbytes, shape):
            nonlocal pos
            if not nbytes:
                return None
            out = np.frombuffer(
                data, dtype=dtype, count=nbytes // width, offset=pos
            ).reshape(shape).astype(np.float64)
            pos += nbytes
            return out

        box = array(header["box"], (3, 3))
        pos += header["vir"] + header["pres"]
        pos += header["top"] + header["sym"]
        x = array(header["x"], (-1, 3))
        v = array(header["v"], (-1, 3))
        f = array(header["f"], (-1, 3))
        return {
            "box": box,
            "positions": x,
            "velocities": v,
            "forces": f,
            "step": header["step"],
            "time": header["time"],
        }

    def read_frames(self, indices: Sequence[int]):
        indices = np.asarray(indices, dtype=int)
        pos = np.empty((len(indices), self.n_atoms, 3), np.float64)
        boxes = np.zeros((len(indices), 3, 3), np.float64)
        for out, i in enumerate(indices):
            frame = self.read_frame(int(i))
            if frame["positions"] is None:
                raise ValueError(
                    f"Frame {int(i)} stores no positions."
                )
            pos[out] = frame["positions"]
            if frame["box"] is not None:
                boxes[out] = frame["box"]
        return pos, boxes

    def close(self) -> None:
        import mmap

        if isinstance(self._data, mmap.mmap):
            self._data.close()
        self._data = b""
        fh = getattr(self, "_fh", None)
        if fh is not None:
            fh.close()


def read_trr(filename: str):
    """Read a whole TRR file: ``(positions (F, N, 3), boxes
    (F, 3, 3), steps, times)`` (nm; float64)."""

    trr = TRRFile(filename)
    pos, boxes = trr.read_frames(range(trr.n_frames))
    return pos, boxes, trr.steps, trr.times


def write_trr(
    filename: str,
    positions: np.ndarray,
    boxes: np.ndarray = None,
    *,
    velocities: np.ndarray = None,
    forces: np.ndarray = None,
    double: bool = False,
    steps: np.ndarray = None,
    times: np.ndarray = None,
    dt: float = 1.0,
) -> None:
    """Write a TRR file (positions in nm; float32 sections unless
    ``double``)."""

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
        if boxes.ndim == 2:
            boxes = np.tile(boxes, (n_frames, 1, 1))
    if steps is None:
        steps = np.arange(n_frames)
    if times is None:
        times = np.asarray(steps, dtype=float) * dt

    with TRRWriter(filename, double=double, dt=dt) as writer:
        for i in range(n_frames):
            writer.write(
                positions[i],
                boxes[i],
                velocities=(
                    velocities[i] if velocities is not None else None
                ),
                forces=forces[i] if forces is not None else None,
                step=int(steps[i]),
                time=float(times[i]),
            )


class TRRWriter:
    """Streaming TRR writer — append one frame at a time (frames are
    independent records; :func:`write_trr` is the whole-array
    convenience over this).  Positions/boxes in nm."""

    def __init__(
        self,
        filename: str,
        *,
        n_atoms: int = None,
        double: bool = False,
        dt: float = 1.0,
    ) -> None:
        self._fh = open(filename, "wb")
        self._n_atoms = None if n_atoms is None else int(n_atoms)
        self._double = bool(double)
        self._dt = float(dt)
        self._step = 0

    def write(
        self,
        positions,
        box=None,
        *,
        velocities=None,
        forces=None,
        step=None,
        time=None,
    ) -> None:
        """Append one frame: `positions` ``(n_atoms, 3)`` nm, `box`
        ``(3, 3)`` nm; optional same-shape `velocities`/`forces`."""

        positions = np.asarray(positions, dtype=np.float64)
        if positions.ndim != 2 or positions.shape[-1] != 3:
            raise ValueError(
                "positions must have shape (n_atoms, 3); got "
                f"{positions.shape}."
            )
        n_atoms = positions.shape[0]
        if self._n_atoms is None:
            self._n_atoms = n_atoms
        elif n_atoms != self._n_atoms:
            raise ValueError(
                f"Frame has {n_atoms} atoms; this file holds "
                f"{self._n_atoms}-atom frames."
            )
        step = self._step if step is None else int(step)
        time = step * self._dt if time is None else float(time)
        box = (
            np.zeros((3, 3))
            if box is None
            else np.asarray(box, dtype=np.float64)
        )

        double = self._double
        width = 8 if double else 4
        dtype = ">f8" if double else ">f4"
        ffmt = ">d" if double else ">f"
        sec = 3 * n_atoms * width
        nchars = len(_VERSION)
        version = (
            struct.pack(">i", nchars + 1)
            + _VERSION
            + b"\x00" * (-nchars % 4)
        )

        fh = self._fh
        fh.write(struct.pack(">i", MAGIC))
        fh.write(version)
        fh.write(
            struct.pack(
                ">10i",
                0, 0, 9 * width, 0, 0, 0, 0,
                sec,
                sec if velocities is not None else 0,
                sec if forces is not None else 0,
            )
        )
        fh.write(struct.pack(">3i", n_atoms, step, 0))
        fh.write(struct.pack(ffmt, time))
        fh.write(struct.pack(ffmt, 0.0))  # lambda
        fh.write(box.astype(dtype).tobytes())
        fh.write(positions.astype(dtype).tobytes())
        if velocities is not None:
            fh.write(np.asarray(velocities).astype(dtype).tobytes())
        if forces is not None:
            fh.write(np.asarray(forces).astype(dtype).tobytes())
        self._step = step + 1

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "TRRWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
