r"""
NetCDF-3 codec
==============

A dependency-free reader/writer for the NetCDF classic formats
(CDF-1 "classic" and CDF-2 "64-bit offset") exposing the subset of the
``netCDF4.Dataset`` API that the AMBER trajectory layer needs; a copy
of :mod:`mdhelper_tpu.io.netcdf3` (numpy only, so the port keeps its
own).

Supported surface:

* ``Dataset(path, mode="r"|"w", format="NETCDF3_CLASSIC"|
  "NETCDF3_64BIT_OFFSET")``
* ``createDimension(name, size_or_None)`` (``None`` = record/UNLIMITED)
* ``createVariable(name, datatype, dimensions)`` with datatypes
  ``"d" "f" "i" "h" "b" "c"`` or numpy dtypes
* ``dataset.variables[name][...]`` get/set (record append via
  ``var[i] = ...``), variable attributes by plain attribute assignment
  (``var.units = "angstrom"``)
* global attributes by plain attribute assignment
* ``sync()`` / ``close()`` — the writer appends records in place and
  patches the record count, so incremental trajectory writing is O(1)
  per frame.

The binary layout follows the NetCDF classic format specification
(magic ``CDF\x01``/``CDF\x02``, big-endian, 4-byte aligned headers,
interleaved record slabs).
"""

import struct
from collections import OrderedDict

import numpy as np

__all__ = ["Dataset", "Dimension", "Variable"]

_NC_BYTE, _NC_CHAR, _NC_SHORT, _NC_INT, _NC_FLOAT, _NC_DOUBLE = range(1, 7)
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C
_ABSENT = b"\x00" * 8

_TYPE_TO_DTYPE = {
    _NC_BYTE: np.dtype(">i1"),
    _NC_CHAR: np.dtype("S1"),
    _NC_SHORT: np.dtype(">i2"),
    _NC_INT: np.dtype(">i4"),
    _NC_FLOAT: np.dtype(">f4"),
    _NC_DOUBLE: np.dtype(">f8"),
}
_KIND_TO_TYPE = {
    ("i", 1): _NC_BYTE,
    ("S", 1): _NC_CHAR,
    ("i", 2): _NC_SHORT,
    ("i", 4): _NC_INT,
    ("f", 4): _NC_FLOAT,
    ("f", 8): _NC_DOUBLE,
}
_CHAR_CODES = {
    "b": _NC_BYTE, "c": _NC_CHAR, "h": _NC_SHORT, "s": _NC_SHORT,
    "i": _NC_INT, "l": _NC_INT, "f": _NC_FLOAT, "d": _NC_DOUBLE,
    "S1": _NC_CHAR,
}


def _nc_type(datatype) -> int:
    if isinstance(datatype, str) and datatype in _CHAR_CODES:
        return _CHAR_CODES[datatype]
    dtype = np.dtype(datatype)
    key = (dtype.kind if dtype.kind != "u" else "i", dtype.itemsize)
    if dtype.kind == "S":
        key = ("S", 1)
    if key not in _KIND_TO_TYPE:
        raise ValueError(f"Unsupported NetCDF-3 datatype: {datatype!r}.")
    return _KIND_TO_TYPE[key]


def _pad4(n: int) -> int:
    return (n + 3) & ~3


class Dimension:
    """A named dimension; ``size`` of the record dimension tracks the
    current record count."""

    def __init__(self, dataset, name, size):
        self._dataset = dataset
        self.name = name
        self._size = size  # None => record dimension

    @property
    def isunlimited(self):
        return self._size is None

    @property
    def size(self) -> int:
        if self._size is None:
            return self._dataset._numrecs
        return self._size

    def __len__(self) -> int:
        return self.size


class Variable:
    """A NetCDF variable with numpy-backed storage."""

    _RESERVED = {
        "_dataset", "name", "dimensions", "_nc_type", "dtype", "_attrs",
        "_data", "_begin", "_vsize",
    }

    def __init__(self, dataset, name, nc_type, dimensions):
        object.__setattr__(self, "_dataset", dataset)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "dimensions", tuple(dimensions))
        object.__setattr__(self, "_nc_type", nc_type)
        object.__setattr__(self, "dtype", _TYPE_TO_DTYPE[nc_type])
        object.__setattr__(self, "_attrs", OrderedDict())
        object.__setattr__(self, "_begin", None)
        object.__setattr__(self, "_vsize", None)
        shape = tuple(
            dataset.dimensions[d]._size or 0 for d in self.dimensions
        )
        if self.isrec:
            shape = (dataset._numrecs, *shape[1:])
        object.__setattr__(
            self, "_data", np.zeros(shape, dtype=self.dtype)
        )

    # -- attributes --------------------------------------------------------
    def __setattr__(self, key, value):
        if key in self._RESERVED:
            object.__setattr__(self, key, value)
        else:
            self._attrs[key] = value

    def __getattr__(self, key):
        attrs = object.__getattribute__(self, "_attrs")
        if key in attrs:
            return attrs[key]
        raise AttributeError(key)

    def ncattrs(self):
        return list(self._attrs)

    def setncattr(self, key, value):
        self._attrs[key] = value

    def getncattr(self, key):
        return self._attrs[key]

    # -- shape/data ----------------------------------------------------------
    @property
    def isrec(self) -> bool:
        return bool(self.dimensions) and self._dataset.dimensions[
            self.dimensions[0]
        ]._size is None

    @property
    def shape(self):
        return self._data.shape

    @property
    def base_shape(self):
        """Per-record shape (non-record dims only)."""

        dims = self.dimensions[1:] if self.isrec else self.dimensions
        return tuple(self._dataset.dimensions[d].size for d in dims)

    def __getitem__(self, key):
        data = self._data[key]
        if self.dtype.kind in "if":
            return np.ascontiguousarray(data).astype(
                data.dtype.newbyteorder("="), copy=False
            )
        return data

    def __setitem__(self, key, value):
        if self.isrec:
            needed = self._required_records(key)
            if needed > self._data.shape[0]:
                grown = np.zeros(
                    (needed, *self._data.shape[1:]), dtype=self.dtype
                )
                grown[: self._data.shape[0]] = self._data
                object.__setattr__(self, "_data", grown)
                self._dataset._grow_records(needed)
        if self.dtype == np.dtype("S1") and not (
            isinstance(value, np.ndarray) and value.dtype.kind == "S"
        ):
            value = np.array(value, dtype="S1")
        self._data[key] = value

    def _required_records(self, key) -> int:
        head = key[0] if isinstance(key, tuple) else key
        if isinstance(head, (int, np.integer)):
            return int(head) + 1 if head >= 0 else self._data.shape[0]
        if isinstance(head, slice):
            stop = head.stop
            if stop is not None and stop > self._data.shape[0]:
                return int(stop)
            return self._data.shape[0]
        if isinstance(head, (list, np.ndarray)):
            return int(np.max(head)) + 1
        return self._data.shape[0]

    def __array__(self, dtype=None):
        return np.asarray(self[...], dtype=dtype)


class Dataset:
    """Minimal ``netCDF4.Dataset``-compatible NetCDF-3 container."""

    _RESERVED = {
        "_path", "_mode", "_version", "dimensions", "variables",
        "_gattrs", "_numrecs", "_record_order", "_header_blob",
        "_data_start", "_closed", "_appendable", "_recsize",
        "_numrecs_offset",
    }

    def __init__(self, path, mode="r", format="NETCDF3_64BIT_OFFSET",
                 **kwargs):
        object.__setattr__(self, "_path", path)
        object.__setattr__(self, "_mode", mode)
        object.__setattr__(
            self, "_version",
            1 if format == "NETCDF3_CLASSIC" else 2,
        )
        object.__setattr__(self, "dimensions", OrderedDict())
        object.__setattr__(self, "variables", OrderedDict())
        object.__setattr__(self, "_gattrs", OrderedDict())
        object.__setattr__(self, "_numrecs", 0)
        object.__setattr__(self, "_closed", False)
        object.__setattr__(self, "_appendable", False)
        if mode in ("r", "a", "r+"):
            self._read()
        elif mode != "w":
            raise ValueError(f"Unsupported mode: {mode!r}.")

    # -- global attributes -------------------------------------------------
    def __setattr__(self, key, value):
        if key in self._RESERVED:
            object.__setattr__(self, key, value)
        else:
            self._gattrs[key] = value

    def __getattr__(self, key):
        gattrs = object.__getattribute__(self, "_gattrs")
        if key in gattrs:
            return gattrs[key]
        raise AttributeError(key)

    def ncattrs(self):
        return list(self._gattrs)

    def setncattr(self, key, value):
        self._gattrs[key] = value

    def getncattr(self, key):
        return self._gattrs[key]

    def set_always_mask(self, flag):  # netCDF4 compatibility no-op
        return None

    # -- structure -----------------------------------------------------------
    def createDimension(self, name, size=None) -> Dimension:  # noqa: N802
        if any(d._size is None for d in self.dimensions.values()) and (
            size is None
        ):
            raise ValueError(
                "NetCDF-3 files support one record dimension."
            )
        dim = Dimension(self, name, None if size is None else int(size))
        self.dimensions[name] = dim
        return dim

    def createVariable(  # noqa: N802
        self, name, datatype, dimensions=(), **kwargs
    ) -> Variable:
        for d in dimensions:
            if d not in self.dimensions:
                raise ValueError(f"Undefined dimension '{d}'.")
        rec_positions = [
            i for i, d in enumerate(dimensions)
            if self.dimensions[d]._size is None
        ]
        if rec_positions and rec_positions != [0]:
            raise ValueError(
                "The record dimension must be a variable's first "
                "dimension."
            )
        var = Variable(self, name, _nc_type(datatype), dimensions)
        self.variables[name] = var
        self._appendable = False  # header changes invalidate layout
        return var

    def _grow_records(self, n: int) -> None:
        if n <= self._numrecs:
            return
        for var in self.variables.values():
            if var.isrec and var._data.shape[0] < n:
                grown = np.zeros(
                    (n, *var._data.shape[1:]), dtype=var.dtype
                )
                grown[: var._data.shape[0]] = var._data
                object.__setattr__(var, "_data", grown)
        object.__setattr__(self, "_numrecs", n)

    # -- serialization --------------------------------------------------------
    @staticmethod
    def _pack_name(name: str) -> bytes:
        raw = name.encode()
        return (
            struct.pack(">i", len(raw))
            + raw
            + b"\x00" * (_pad4(len(raw)) - len(raw))
        )

    @classmethod
    def _pack_attr_value(cls, value) -> bytes:
        if isinstance(value, str):
            raw = value.encode()
            return (
                struct.pack(">ii", _NC_CHAR, len(raw))
                + raw
                + b"\x00" * (_pad4(len(raw)) - len(raw))
            )
        arr = np.atleast_1d(np.asarray(value))
        nc_type = _nc_type(arr.dtype)
        arr = arr.astype(_TYPE_TO_DTYPE[nc_type])
        raw = arr.tobytes()
        return (
            struct.pack(">ii", nc_type, arr.size)
            + raw
            + b"\x00" * (_pad4(len(raw)) - len(raw))
        )

    @classmethod
    def _pack_attrs(cls, attrs: OrderedDict) -> bytes:
        if not attrs:
            return _ABSENT
        out = struct.pack(">ii", _NC_ATTRIBUTE, len(attrs))
        for key, value in attrs.items():
            out += cls._pack_name(key) + cls._pack_attr_value(value)
        return out

    def _variable_vsize(self, var: Variable) -> int:
        per_record = int(
            np.prod(var.base_shape, dtype=np.int64)
        ) * var.dtype.itemsize
        return _pad4(per_record)

    def _build_header(self) -> bytes:
        offset_fmt = ">i" if self._version == 1 else ">q"
        offset_size = 4 if self._version == 1 else 8

        # Dimensions.
        if self.dimensions:
            dims_blob = struct.pack(
                ">ii", _NC_DIMENSION, len(self.dimensions)
            )
            for dim in self.dimensions.values():
                dims_blob += self._pack_name(dim.name)
                dims_blob += struct.pack(">i", dim._size or 0)
        else:
            dims_blob = _ABSENT
        dim_ids = {
            name: i for i, name in enumerate(self.dimensions)
        }

        gatts_blob = self._pack_attrs(self._gattrs)

        # Variables: compute sizes, then lay out offsets (non-record
        # first, then the record slab).
        rec_vars = [v for v in self.variables.values() if v.isrec]
        fixed_vars = [
            v for v in self.variables.values() if not v.isrec
        ]
        for var in self.variables.values():
            vsize = self._variable_vsize(var)
            if var.isrec and len(rec_vars) == 1:
                # Spec: a sole record variable is packed unpadded.
                vsize = int(
                    np.prod(var.base_shape, dtype=np.int64)
                ) * var.dtype.itemsize
            object.__setattr__(var, "_vsize", vsize)

        # First pass: header length with dummy offsets.
        def var_entry(var, begin):
            blob = self._pack_name(var.name)
            blob += struct.pack(">i", len(var.dimensions))
            for d in var.dimensions:
                blob += struct.pack(">i", dim_ids[d])
            blob += self._pack_attrs(var._attrs)
            blob += struct.pack(">i", var._nc_type)
            blob += struct.pack(">i", min(var._vsize, 2**31 - 1))
            blob += struct.pack(offset_fmt, begin)
            return blob

        if self.variables:
            vars_header_len = len(
                struct.pack(">ii", _NC_VARIABLE, len(self.variables))
            ) + sum(
                len(var_entry(v, 0)) for v in self.variables.values()
            )
        else:
            vars_header_len = len(_ABSENT)

        header_len = (
            4  # magic
            + 4  # numrecs
            + len(dims_blob)
            + len(gatts_blob)
            + vars_header_len
        )

        # Assign offsets.
        begin = header_len
        for var in fixed_vars:
            object.__setattr__(var, "_begin", begin)
            begin += var._vsize
        rec_begin = begin
        for var in rec_vars:
            object.__setattr__(var, "_begin", begin)
            begin += var._vsize
        recsize = sum(v._vsize for v in rec_vars)
        object.__setattr__(self, "_recsize", recsize)
        object.__setattr__(self, "_data_start", rec_begin)

        # Final header bytes.
        magic = b"CDF" + bytes([self._version])
        header = magic + struct.pack(">i", self._numrecs)
        object.__setattr__(self, "_numrecs_offset", 4)
        header += dims_blob + gatts_blob
        if self.variables:
            header += struct.pack(
                ">ii", _NC_VARIABLE, len(self.variables)
            )
            for var in self.variables.values():
                header += var_entry(var, var._begin)
        else:
            header += _ABSENT
        return header

    def _record_bytes(self, rec: int) -> bytes:
        rec_vars = [v for v in self.variables.values() if v.isrec]
        out = b""
        for var in rec_vars:
            if rec < var._data.shape[0]:
                # Note: integer indexing of a big-endian array yields a
                # native-endian scalar; pin the dtype explicitly.
                raw = np.ascontiguousarray(
                    var._data[rec], dtype=var.dtype
                ).tobytes()
            else:
                raw = b"\x00" * (
                    int(np.prod(var.base_shape, dtype=np.int64))
                    * var.dtype.itemsize
                )
            out += raw + b"\x00" * (var._vsize - len(raw))
        return out

    def sync(self) -> None:
        if self._mode == "r":
            return
        header = self._build_header()
        with open(self._path, "wb") as f:
            f.write(header)
            # Fixed variables.
            for var in self.variables.values():
                if not var.isrec:
                    f.seek(var._begin)
                    raw = np.ascontiguousarray(
                        var._data, dtype=var.dtype
                    ).tobytes()
                    f.write(raw + b"\x00" * (var._vsize - len(raw)))
            # Record slabs.
            for rec in range(self._numrecs):
                f.seek(self._data_start + rec * self._recsize)
                f.write(self._record_bytes(rec))

    flush = sync

    def close(self) -> None:
        if not self._closed:
            self.sync()
            object.__setattr__(self, "_closed", True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- parsing -----------------------------------------------------------
    def _read(self) -> None:
        with open(self._path, "rb") as f:
            blob = f.read()
        if blob[:3] != b"CDF" or blob[3] not in (1, 2):
            raise ValueError(
                f"'{self._path}' is not a NetCDF-3 classic file."
            )
        object.__setattr__(self, "_version", blob[3])
        offset_fmt = ">i" if blob[3] == 1 else ">q"
        offset_size = 4 if blob[3] == 1 else 8
        pos = 4
        numrecs = struct.unpack_from(">i", blob, pos)[0]
        pos += 4
        if numrecs < 0:  # STREAMING sentinel
            numrecs = None

        def read_name(pos):
            n = struct.unpack_from(">i", blob, pos)[0]
            pos += 4
            name = blob[pos:pos + n].decode()
            return name, pos + _pad4(n)

        def read_attrs(pos):
            tag, count = struct.unpack_from(">ii", blob, pos)
            pos += 8
            attrs = OrderedDict()
            if tag == 0:
                return attrs, pos
            for _ in range(count):
                name, pos = read_name(pos)
                nc_type, nelems = struct.unpack_from(">ii", blob, pos)
                pos += 8
                dtype = _TYPE_TO_DTYPE[nc_type]
                nbytes = nelems * dtype.itemsize
                raw = blob[pos:pos + nbytes]
                pos += _pad4(nbytes)
                if nc_type == _NC_CHAR:
                    attrs[name] = raw.decode(errors="replace")
                else:
                    values = np.frombuffer(raw, dtype=dtype)
                    attrs[name] = (
                        values[0] if len(values) == 1 else values
                    )
            return attrs, pos

        # Dimensions.
        tag, count = struct.unpack_from(">ii", blob, pos)
        pos += 8
        dim_names = []
        if tag == _NC_DIMENSION:
            for _ in range(count):
                name, pos = read_name(pos)
                size = struct.unpack_from(">i", blob, pos)[0]
                pos += 4
                self.dimensions[name] = Dimension(
                    self, name, None if size == 0 else size
                )
                dim_names.append(name)

        gattrs, pos = read_attrs(pos)
        object.__setattr__(self, "_gattrs", gattrs)

        # Variables.
        tag, count = struct.unpack_from(">ii", blob, pos)
        pos += 8
        entries = []
        if tag == _NC_VARIABLE:
            for _ in range(count):
                name, pos = read_name(pos)
                ndims = struct.unpack_from(">i", blob, pos)[0]
                pos += 4
                dims = tuple(
                    dim_names[
                        struct.unpack_from(">i", blob, pos + 4 * i)[0]
                    ]
                    for i in range(ndims)
                )
                pos += 4 * ndims
                attrs, pos = read_attrs(pos)
                nc_type, vsize = struct.unpack_from(">ii", blob, pos)
                pos += 8
                begin = struct.unpack_from(offset_fmt, blob, pos)[0]
                pos += offset_size
                entries.append((name, dims, attrs, nc_type, vsize,
                                begin))

        rec_entries = [
            e for e in entries
            if e[1] and self.dimensions[e[1][0]]._size is None
        ]
        recsize = sum(e[4] for e in rec_entries)
        if len(rec_entries) == 1:
            # The sole record variable may be unpadded.
            e = rec_entries[0]
            per_rec = int(
                np.prod(
                    [self.dimensions[d].size for d in e[1][1:]],
                    dtype=np.int64,
                )
            ) * _TYPE_TO_DTYPE[e[3]].itemsize
            recsize = per_rec
        if numrecs is None and rec_entries:
            first = min(e[5] for e in rec_entries)
            numrecs = (len(blob) - first) // recsize if recsize else 0
        object.__setattr__(self, "_numrecs", int(numrecs or 0))

        for name, dims, attrs, nc_type, vsize, begin in entries:
            var = Variable(self, name, nc_type, dims)
            object.__setattr__(var, "_attrs", attrs)
            dtype = _TYPE_TO_DTYPE[nc_type]
            if dims and self.dimensions[dims[0]]._size is None:
                base = tuple(
                    self.dimensions[d].size for d in dims[1:]
                )
                per_rec_items = int(np.prod(base, dtype=np.int64))
                records = np.empty(
                    (self._numrecs, *base), dtype=dtype
                )
                for rec in range(self._numrecs):
                    start = begin + rec * recsize
                    records[rec] = np.frombuffer(
                        blob,
                        dtype=dtype,
                        count=per_rec_items,
                        offset=start,
                    ).reshape(base)
                object.__setattr__(var, "_data", records)
            else:
                shape = tuple(self.dimensions[d].size for d in dims)
                n_items = int(np.prod(shape, dtype=np.int64))
                object.__setattr__(
                    var,
                    "_data",
                    np.frombuffer(
                        blob, dtype=dtype, count=n_items, offset=begin
                    ).reshape(shape).copy(),
                )
            self.variables[name] = var
