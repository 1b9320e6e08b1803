"""A small msgpack encoder and decoder for the trees of flax's checkpoints.

``flax.serialization.to_bytes`` writes a state dict with
``msgpack.packb(tree, default=_msgpack_ext_pack, strict_types=True)``, and
``msgpack_restore`` reads it back. This module writes and reads the same
bytes without the ``msgpack`` package, for the subset those trees use:

* maps with str keys, in insertion order; str; bin; int; float (as
  float64); nil; bool;
* ext type 1, an ndarray, and ext type 3, a numpy scalar: each payload is
  ``packb((shape, dtype.name, raw C-order bytes))`` with the shape as an
  array of ints and the dtype name as a str.

Every choice of format is msgpack's shortest: fixint, fixstr, fixmap,
fixarray and fixext where they fit, then the 8-, 16- and 32-bit forms.
flax splits an array above ``MAX_CHUNK_SIZE`` (2**30 bytes) into a map of
chunks; such a leaf is an error here, on both sides (no model of this
repository comes near that size).
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED_KEY = "__msgpack_chunked_array__"

__all__ = ["packb", "unpackb"]


def _int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return bytes([v])
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
        raise OverflowError(f"int {v} does not fit 64 bits")
    if v >= -32:
        return struct.pack(">b", v)
    for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                           (0xd2, ">i", -0x80000000),
                           (0xd3, ">q", -0x8000000000000000)):
        if v >= low:
            return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """The header of a str/bin/array/map of n items."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of {n} items is too large")


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARRAY = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    if n in _FIXEXT:
        head = bytes([_FIXEXT[n]])
    elif n <= 0xff:
        head = bytes([0xc7]) + struct.pack(">B", n)
    elif n <= 0xffff:
        head = bytes([0xc8]) + struct.pack(">H", n)
    elif n <= 0xffffffff:
        head = bytes([0xc9]) + struct.pack(">I", n)
    else:
        raise ValueError(f"ext payload of {n} bytes is too large")
    return head + struct.pack(">b", code) + data


def _array_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    if a.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(
            f"array of {a.nbytes} bytes is above flax's MAX_CHUNK_SIZE "
            f"({MAX_CHUNK_SIZE}): flax would chunk it, which this codec "
            "does not write")
    return packb((tuple(int(d) for d in a.shape), a.dtype.name,
                  a.tobytes("C")))


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        raw = x.encode("utf-8")
        out.append(_sized(len(raw), 0xa0, 31, _STR) + raw)
    elif type(x) is bytes:
        out.append(_sized(len(x), None, -1, _BIN) + x)
    elif type(x) in (list, tuple):
        out.append(_sized(len(x), 0x90, 15, _ARRAY))
        for v in x:
            _pack(v, out)
    elif type(x) is dict:
        out.append(_sized(len(x), 0x80, 15, _MAP))
        for k, v in x.items():
            if type(k) is not str:
                raise TypeError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _array_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(EXT_NPSCALAR, _array_payload(np.asarray(x))))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def packb(tree) -> bytes:
    """msgpack bytes of ``tree``, as flax's ``msgpack_serialize`` writes
    them (numpy arrays and scalars as ext types 1 and 3)."""
    out: list[bytes] = []
    _pack(tree, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool):
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, raw)
        if 0x90 <= b <= 0x9f:
            return [self.obj(raw) for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f, raw)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                0xcb: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sized = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"),
                 0xc6: (">I", "bin"), 0xd9: (">B", "str"),
                 0xda: (">H", "str"), 0xdb: (">I", "str"),
                 0xdc: (">H", "array"), 0xdd: (">I", "array"),
                 0xde: (">H", "map"), 0xdf: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n, raw)
            if kind == "array":
                return [self.obj(raw) for _ in range(n)]
            return self.map(n, raw)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            n = fixext[b]
        elif b in (0xc7, 0xc8, 0xc9):
            n = self.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
        else:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
        code = self.unpack(">b")
        return _ext_value(code, bytes(self.take(n)))

    def str(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out


def _array_from_payload(data: bytes) -> np.ndarray:
    r = _Reader(data)
    shape, name, buf = r.obj(raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise ValueError("bfloat16 leaves need ml_dtypes; not supported")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext_value(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    raise ValueError(f"msgpack ext type {code} is not supported")


def _refuse_chunks(tree) -> None:
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            raise ValueError(
                "a leaf was chunked by flax (an array above MAX_CHUNK_SIZE, "
                f"{MAX_CHUNK_SIZE} bytes); this codec does not read chunks")
        for v in tree.values():
            _refuse_chunks(v)


def unpackb(data: bytes):
    """The tree that ``flax.serialization.msgpack_restore`` gives for
    ``data``: maps as dicts, arrays as read-only numpy arrays."""
    r = _Reader(data)
    tree = r.obj(raw=False)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    _refuse_chunks(tree)
    return tree
