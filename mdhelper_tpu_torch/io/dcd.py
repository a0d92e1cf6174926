"""
DCD trajectory codec
====================

Dependency-free reader/writer for CHARMM/NAMD/X-PLOR DCD binary
trajectories, a copy of :mod:`mdhelper_tpu.io.dcd` (numpy only, so
the port keeps its own).  Like :mod:`mdhelper_tpu_torch.io.netcdf3`, this is a struct-level
implementation of the public file format, not a binding.

Format summary (Fortran unformatted records, each payload wrapped in
4-byte length markers):

- header record (84 bytes): magic ``CORD`` + 20 int32 control words
  (frame count, first step, save interval, fixed-atom count, timestep,
  unit-cell flag, CHARMM version);
- title record: ``ntitle`` 80-character lines;
- natoms record: one int32;
- optional free-atom index record when fixed atoms are present;
- per frame: optional unit-cell record (6 float64: a, cos/deg gamma,
  b, cos/deg beta, cos/deg alpha, c) and three float32 records
  (all x, all y, all z).

Both little- and big-endian files are handled (detected from the first
record marker).  Reads are NumPy-vectorized and frame-seekable: the
header fixes every frame's byte offset, so random access and batched
reads never scan the file.
"""

import struct
from typing import Sequence

import numpy as np

__all__ = ["DCDFile", "read_dcd", "write_dcd"]

_HEADER_BYTES = 84


class DCDFile:
    """A DCD trajectory opened for reading.

    Attributes
    ----------
    n_frames, n_atoms : `int`
    has_unitcell : `bool`
    delta : `float`
        Integrator timestep (AKMA units in CHARMM files).
    nsavc : `int`
        Steps between saved frames (frame spacing in steps).
    istart : `int`
        Step number of the first frame.
    """

    def __init__(self, filename: str):
        self.filename = filename
        self._fh = open(filename, "rb")
        self._parse_header()

    # -- low-level record IO ---------------------------------------------
    def _read_record(self) -> bytes:
        raw = self._fh.read(4)
        if len(raw) < 4:
            raise EOFError("Unexpected end of DCD file.")
        (n,) = struct.unpack(self._e + "i", raw)
        payload = self._fh.read(n)
        tail = self._fh.read(4)
        if len(payload) < n or len(tail) < 4:
            raise EOFError("Truncated DCD record.")
        (m,) = struct.unpack(self._e + "i", tail)
        if m != n:
            raise ValueError(
                f"Corrupt DCD record: head {n} != tail {m}."
            )
        return payload

    def _parse_header(self) -> None:
        head = self._fh.read(4)
        if len(head) < 4:
            raise ValueError("Not a DCD file (too short).")
        if struct.unpack("<i", head)[0] == _HEADER_BYTES:
            self._e = "<"
        elif struct.unpack(">i", head)[0] == _HEADER_BYTES:
            self._e = ">"
        else:
            raise ValueError(
                "Not a DCD file (first record is not 84 bytes)."
            )
        self._fh.seek(0)

        header = self._read_record()
        if header[:4] != b"CORD":
            raise ValueError("Not a coordinate DCD (missing CORD).")
        icntrl = np.frombuffer(
            header[4:], dtype=np.dtype(np.int32).newbyteorder(self._e)
        )
        self.nsavc = int(icntrl[2])
        self.istart = int(icntrl[1])
        self._n_fixed = int(icntrl[8])
        self.charmm_version = int(icntrl[19])
        self._is_charmm = self.charmm_version != 0
        if self._is_charmm:
            self.has_unitcell = bool(icntrl[10])
            self._4d = bool(icntrl[11])
            (self.delta,) = struct.unpack(
                self._e + "f", header[4 + 9 * 4:4 + 10 * 4]
            )
        else:  # X-PLOR: DELTA is a float64 across words 9-10
            self.has_unitcell = False
            self._4d = False
            (self.delta,) = struct.unpack(
                self._e + "d", header[4 + 9 * 4:4 + 11 * 4]
            )

        title = self._read_record()
        (ntitle,) = struct.unpack(self._e + "i", title[:4])
        self.titles = [
            title[4 + 80 * i:4 + 80 * (i + 1)]
            .decode("latin-1")
            .rstrip("\x00 ")
            for i in range(ntitle)
        ]

        (self.n_atoms,) = struct.unpack(
            self._e + "i", self._read_record()
        )

        self._free_idx = None
        if self._n_fixed > 0:
            free = self._read_record()
            self._free_idx = (
                np.frombuffer(
                    free,
                    dtype=np.dtype(np.int32).newbyteorder(self._e),
                ).astype(np.int64)
                - 1  # Fortran 1-based
            )

        self._frame0_offset = self._fh.tell()

        # Frame geometry: every frame is the same size except, with
        # fixed atoms, the first (which stores all atoms).
        cell = (8 + 6 * 8) if self.has_unitcell else 0
        dims = 4 if self._4d else 3

        def frame_bytes(n_xyz: int) -> int:
            return cell + dims * (8 + 4 * n_xyz)

        self._first_bytes = frame_bytes(self.n_atoms)
        n_free = (
            self.n_atoms
            if self._free_idx is None
            else len(self._free_idx)
        )
        self._later_bytes = frame_bytes(n_free)

        self._fh.seek(0, 2)
        end = self._fh.tell()
        data = end - self._frame0_offset
        if data < self._first_bytes:
            self.n_frames = 0
        else:
            self.n_frames = 1 + (data - self._first_bytes) // (
                self._later_bytes
            )
        nset = int(icntrl[0])
        if nset and nset < self.n_frames:
            self.n_frames = nset
        self._first_frame_cache = None

    # -- frame access -----------------------------------------------------
    def _seek_frame(self, index: int) -> None:
        if index == 0:
            self._fh.seek(self._frame0_offset)
        else:
            self._fh.seek(
                self._frame0_offset
                + self._first_bytes
                + (index - 1) * self._later_bytes
            )

    def _read_unitcell(self) -> np.ndarray:
        """Return (6,) [a, b, c, alpha, beta, gamma] in Angstrom/deg."""

        rec = self._read_record()
        a, g, b, be, al, c = struct.unpack(self._e + "6d", rec)
        angles = np.array([al, be, g])
        if np.all(np.abs(angles) <= 1.0):
            # CHARMM >= 22 stores cosines of the angles.
            angles = np.degrees(np.arccos(angles))
        elif np.any(angles < 0):
            angles = np.abs(angles)
        return np.array([a, b, c, *angles], dtype=np.float64)

    def read_frame(self, index: int):
        """Read one frame: ``(positions (N, 3) float32,
        unitcell (6,) float64 or None)``."""

        if not 0 <= index < self.n_frames:
            raise IndexError(
                f"Frame {index} out of range ({self.n_frames})."
            )
        if (
            index > 0
            and self._free_idx is not None
            and self._first_frame_cache is None
        ):
            # Fixed-atom trajectories store only free atoms after the
            # first frame; materialize the full first frame once.
            self.read_frame(0)
        self._seek_frame(index)
        cell = self._read_unitcell() if self.has_unitcell else None
        f32 = np.dtype(np.float32).newbyteorder(self._e)
        n_xyz = (
            self.n_atoms
            if (index == 0 or self._free_idx is None)
            else len(self._free_idx)
        )
        xyz = np.empty((3, n_xyz), dtype=np.float32)
        for k in range(3):
            xyz[k] = np.frombuffer(self._read_record(), dtype=f32)
        if self._4d:
            self._read_record()  # discard the 4th dimension
        if index > 0 and self._free_idx is not None:
            full = self._first_frame_cache.copy()
            full[self._free_idx] = xyz.T
            return full, cell
        positions = np.ascontiguousarray(xyz.T)
        if index == 0 and self._free_idx is not None:
            self._first_frame_cache = positions.copy()
        return positions, cell

    def read_frames(self, indices: Sequence[int]):
        """Batched read: ``(positions (F, N, 3) float32,
        unitcells (F, 6) float64)`` (zeros when no unit cell)."""

        indices = np.asarray(indices, dtype=int)
        pos = np.empty((len(indices), self.n_atoms, 3), np.float32)
        cells = np.zeros((len(indices), 6), np.float64)
        for out, i in enumerate(indices):
            p, c = self.read_frame(int(i))
            pos[out] = p
            if c is not None:
                cells[out] = c
        return pos, cells

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_dcd(filename: str):
    """Read a whole DCD file: ``(positions (F, N, 3) float32,
    unitcells (F, 6) float64, header dict)``."""

    with DCDFile(filename) as dcd:
        pos, cells = dcd.read_frames(range(dcd.n_frames))
        header = {
            "istart": dcd.istart,
            "nsavc": dcd.nsavc,
            "delta": dcd.delta,
            "titles": dcd.titles,
            "has_unitcell": dcd.has_unitcell,
        }
    return pos, cells, header


def write_dcd(
    filename: str,
    positions: np.ndarray,
    unitcells: np.ndarray = None,
    *,
    istart: int = 0,
    nsavc: int = 1,
    delta: float = 1.0,
    title: str = "Created by mdhelper_tpu",
) -> None:
    """Write a CHARMM-format (version 24) little-endian DCD file.

    Parameters
    ----------
    positions : `numpy.ndarray`
        ``(n_frames, n_atoms, 3)`` coordinates (stored float32).
    unitcells : `numpy.ndarray`, optional
        ``(n_frames, 6)`` or ``(6,)`` box parameters
        ``[a, b, c, alpha, beta, gamma]`` (degrees); omit for no box.
    """

    positions = np.asarray(positions)
    if positions.ndim != 3 or positions.shape[-1] != 3:
        raise ValueError(
            "positions must have shape (n_frames, n_atoms, 3); got "
            f"{positions.shape}."
        )
    n_frames, n_atoms = positions.shape[:2]
    if unitcells is not None:
        unitcells = np.asarray(unitcells, dtype=np.float64)
        if unitcells.ndim == 1:
            unitcells = np.tile(unitcells, (n_frames, 1))
        if unitcells.shape != (n_frames, 6):
            raise ValueError(
                "unitcells must have shape (6,) or (n_frames, 6); "
                f"got {unitcells.shape}."
            )

    with DCDWriter(
        filename, n_atoms, istart=istart, nsavc=nsavc, delta=delta,
        title=title,
    ) as writer:
        for f in range(n_frames):
            writer.write(
                positions[f],
                unitcells[f] if unitcells is not None else None,
            )


def _record(payload: bytes) -> bytes:
    return (
        struct.pack("<i", len(payload))
        + payload
        + struct.pack("<i", len(payload))
    )


class DCDWriter:
    """Streaming DCD writer — append one frame at a time.  The DCD
    header carries the frame count, so it is written with a zero
    count and patched in place on :meth:`close` (the MDAnalysis
    ``DCDWriter`` does the same); :func:`write_dcd` is the
    whole-array convenience over this.  Coordinates in Angstrom.

    Whether frames carry a unit cell is fixed by the FIRST
    :meth:`write` call (the header's ``icntrl[10]`` flag is patched
    accordingly); later frames must match.
    """

    def __init__(
        self,
        filename: str,
        n_atoms: int,
        *,
        istart: int = 0,
        nsavc: int = 1,
        delta: float = 1.0,
        title: str = "Created by mdhelper_tpu",
    ) -> None:
        self._n_atoms = int(n_atoms)
        self._nsavc = int(nsavc)
        self._n_frames = 0
        self._has_cell = None
        self._fh = open(filename, "wb")

        icntrl = np.zeros(20, dtype=np.int32)
        icntrl[1] = istart
        icntrl[2] = nsavc
        icntrl[9] = np.float32(delta).view(np.int32)
        icntrl[19] = 24  # CHARMM version
        self._fh.write(_record(b"CORD" + icntrl.astype("<i4").tobytes()))
        line = title.encode("latin-1")[:80].ljust(80)
        self._fh.write(_record(struct.pack("<i", 1) + line))
        self._fh.write(_record(struct.pack("<i", self._n_atoms)))

    def write(self, positions, unitcell=None) -> None:
        """Append one frame: `positions` ``(n_atoms, 3)`` Angstrom,
        `unitcell` ``[a, b, c, alpha, beta, gamma]`` (degrees) or
        ``None``."""

        positions = np.asarray(positions)
        if positions.shape != (self._n_atoms, 3):
            raise ValueError(
                f"positions must have shape ({self._n_atoms}, 3); "
                f"got {positions.shape}."
            )
        has_cell = unitcell is not None
        if self._has_cell is None:
            self._has_cell = has_cell
        elif has_cell != self._has_cell:
            raise ValueError(
                "All frames must consistently have (or not have) a "
                "unit cell."
            )
        if has_cell:
            a, b, c, al, be, g = np.asarray(
                unitcell, dtype=np.float64
            )
            # CHARMM >= 22 layout with cosine angles.
            cell = struct.pack(
                "<6d",
                a,
                np.cos(np.radians(g)),
                b,
                np.cos(np.radians(be)),
                np.cos(np.radians(al)),
                c,
            )
            self._fh.write(_record(cell))
        frame = positions.astype("<f4", copy=False)
        for k in range(3):
            self._fh.write(
                _record(np.ascontiguousarray(frame[:, k]).tobytes())
            )
        self._n_frames += 1

    def close(self) -> None:
        if self._fh.closed:
            return
        # Patch the frame count (icntrl[0], file offset 8), total
        # steps (icntrl[3], offset 20) and the unit-cell flag
        # (icntrl[10], offset 48) now that they are known.
        self._fh.seek(8)
        self._fh.write(struct.pack("<i", self._n_frames))
        self._fh.seek(20)
        self._fh.write(
            struct.pack("<i", self._n_frames * self._nsavc)
        )
        self._fh.seek(48)
        self._fh.write(struct.pack("<i", 1 if self._has_cell else 0))
        self._fh.close()

    def __enter__(self) -> "DCDWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
