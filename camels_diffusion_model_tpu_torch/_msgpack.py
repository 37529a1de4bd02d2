"""A msgpack decoder and encoder for flax checkpoints, in pure Python.

:func:`unpackb` reads what ``flax.serialization.to_bytes`` writes: maps,
arrays, str, bin, nil/bool, int and float, plus flax's ext type 1 (ndarray:
a packed ``(shape, dtype_name, bytes)`` that becomes ``np.frombuffer`` on a
memoryview of the input, with no copy per element) and ext type 3 (numpy
scalar).  flax splits arrays above ``MAX_CHUNK_SIZE = 2**30`` bytes into
chunk maps; no array in this repository's checkpoints comes near that, so a
chunked array raises rather than being reassembled.

:func:`packb` writes the same subset byte for byte as
``flax.serialization.to_bytes`` does (``msgpack.packb(...,
strict_types=True)`` with flax's ext hook, maps in their keys' order), so
either package reads the other's files.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {  # type byte -> (length format, kind)
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_SCALARS = {
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
    0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return self._take(n)
            if kind == "str":
                return str(self._take(n), "utf-8")
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(self._unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(self._unpack(">b"), 1 << (b - 0xD4))
        if b in _SCALARS:
            return self._unpack(_SCALARS[b])
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError(
                "msgpack: chunked array (an array over 2**30 bytes) is not "
                "supported"
            )
        return out

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype_name, raw = _Reader(data).value()
        if isinstance(dtype_name, memoryview):
            dtype_name = str(dtype_name, "ascii")
        arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data):
    """Decode one msgpack document (bytes-like) into Python/numpy objects.

    Arrays are read-only views of ``data``; copy what must outlive it.
    """
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: trailing bytes after the document")
    return out


def _head(out: bytearray, n: int, fix: int, fix_max: int, sized) -> None:
    """The smallest header of a str/bin/array/map/ext of length ``n``:
    ``fix | n`` below ``fix_max`` (``fix`` None: no fixed form), else the
    first of ``sized`` ((type byte, length format), narrowest first) that
    holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for type_byte, fmt in sized:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(type_byte)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} is too large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v >= 0 else \
        ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for type_byte, fmt in forms:
        try:
            packed = struct.pack(fmt, v)
        except struct.error:
            continue
        out.append(type_byte)
        out += packed
        return
    raise ValueError(f"msgpack: integer {v} does not fit 64 bits")


def _ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _head(out, n, None, 0, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    out += struct.pack(">b", code)
    out += data


def _ndarray(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``(shape, dtype name, C-order bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured arrays are not supported")
    if arr.nbytes > 2**30:
        raise ValueError("msgpack: arrays over 2**30 bytes (flax's chunked form) "
                         "are not supported")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, v) -> None:
    if v is None or isinstance(v, bool):
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[v])
    elif isinstance(v, np.ndarray):
        _ext(out, _EXT_NDARRAY, _ndarray(v))
    elif isinstance(v, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray(np.asarray(v)))
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out += raw
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        _head(out, len(raw), None, 0, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out += raw
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 16, ((0xDC, ">H"), (0xDD, ">I")))
        for item in v:
            _pack(out, item)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 16, ((0xDE, ">H"), (0xDF, ">I")))
        for key, item in v.items():
            _pack(out, key)
            _pack(out, item)
    else:
        raise TypeError(f"msgpack: cannot pack {type(v).__name__}")


def packb(obj) -> bytes:
    """Encode a tree of dicts (str keys, in their order), lists,
    None/bool/int/float/str/bytes, numpy arrays (ext 1) and numpy scalars
    (ext 3), as ``flax.serialization.to_bytes`` encodes the same tree."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)
