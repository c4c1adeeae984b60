"""The wire's control-plane codec: the MessagePack subset the cache speaks.

Replaces the third-party ``msgpack`` package, which the card's machine
does not have, for the port's RPC layer (``curvine_tpu/rpc/frame.py:15,
182-187`` calls ``msgpack.packb(obj, use_bin_type=True)`` and
``msgpack.unpackb(buf, raw=False, strict_map_key=False)``). Pure Python.

It carries what the wire and the cluster's stores carry: None, bool, ints
over the whole int64 and uint64 range, float64, str, bytes (also
bytearray and memoryview), list and tuple, and dicts. Every value gets
msgpack's smallest encoding for its int or length, so ``packb`` gives the
same bytes as ``msgpack.packb(obj, use_bin_type=True)``; subclasses of
these types (an ``IntEnum``) pack as their base, as they do there. Any
other type raises ``TypeError``, and an int outside [-2^63, 2^64 - 1]
raises ``OverflowError``, as msgpack does; nothing is guessed.

``unpackb`` reads the same formats plus float32 (which ``packb`` never
writes); ``raw=True`` gives str values as their UTF-8 bytes, and
``strict_map_key=True`` refuses map keys other than str and bytes, as
msgpack's defaults do. Malformed, truncated or trailing bytes and the
ext formats raise ``UnpackValueError`` (a ``ValueError``)."""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb", "UnpackException", "UnpackValueError"]

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


class UnpackException(Exception):
    """Base of the decoding errors (msgpack's name)."""


class UnpackValueError(UnpackException, ValueError):
    """The bytes are not one well-formed value of the supported formats."""


def _int(out: bytearray, v: int) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 0x100:
            out += b"\xcc" + _B.pack(v)
        elif v < 0x10000:
            out += b"\xcd" + _H.pack(v)
        elif v < 0x100000000:
            out += b"\xce" + _I.pack(v)
        elif v < 0x10000000000000000:
            out += b"\xcf" + _Q.pack(v)
        else:
            raise OverflowError(f"int {v} is above 2^64 - 1")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out += b"\xd0" + _b.pack(v)
    elif v >= -0x8000:
        out += b"\xd1" + _h.pack(v)
    elif v >= -0x80000000:
        out += b"\xd2" + _i.pack(v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(v)
    else:
        raise OverflowError(f"int {v} is below -2^63")


def _len(out: bytearray, n: int, fix: int | None, fix_max: int,
         c8: bytes | None, c16: bytes, c32: bytes) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif c8 is not None and n < 0x100:
        out += c8 + _B.pack(n)
    elif n < 0x10000:
        out += c16 + _H.pack(n)
    elif n < 0x100000000:
        out += c32 + _I.pack(n)
    else:
        raise ValueError(f"length {n} is above 2^32 - 1")


def _pack(out: bytearray, obj, depth: int) -> None:
    if depth > 512:
        raise ValueError("nesting deeper than 512")
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _int(out, int(obj))
    elif isinstance(obj, float):
        out += b"\xcb" + _d.pack(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _len(out, len(b), 0xA0, 31, b"\xd9", b"\xda", b"\xdb")
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = memoryview(obj).cast("B") if isinstance(obj, memoryview) \
            else obj
        _len(out, len(b), None, 0, b"\xc4", b"\xc5", b"\xc6")
        out += b
    elif isinstance(obj, (list, tuple)):
        _len(out, len(obj), 0x90, 15, None, b"\xdc", b"\xdd")
        for x in obj:
            _pack(out, x, depth + 1)
    elif isinstance(obj, dict):
        _len(out, len(obj), 0x80, 15, None, b"\xde", b"\xdf")
        for k, v in obj.items():
            if not isinstance(k, (str, int)):
                raise TypeError(f"map key of type {type(k).__name__} is "
                                f"not carried (str and int only)")
            _pack(out, k, depth + 1)
            _pack(out, v, depth + 1)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def packb(obj, use_bin_type: bool = True) -> bytes:
    """``obj`` as msgpack bytes, equal to ``msgpack.packb(obj,
    use_bin_type=True)``'s."""
    if not use_bin_type:
        raise ValueError("only use_bin_type=True is carried: str and "
                         "bytes must stay apart on the wire")
    out = bytearray()
    _pack(out, obj, 0)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos", "raw", "strict")

    def __init__(self, buf, raw: bool, strict: bool):
        self.buf = buf
        self.pos = 0
        self.raw = raw
        self.strict = strict

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise UnpackValueError("incomplete input")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def num(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def text(self, n: int):
        b = bytes(self.take(n))
        if self.raw:
            return b
        try:
            return b.decode("utf-8")
        except UnicodeDecodeError as e:
            raise UnpackValueError(f"str is not UTF-8: {e}") from e

    def value(self, depth: int = 0):
        if depth > 512:
            raise UnpackValueError("nesting deeper than 512")
        c = self.num(_B)
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c < 0x90:
            return self.map(c & 0x0F, depth)
        if c < 0xA0:
            return self.array(c & 0x0F, depth)
        if c < 0xC0:
            return self.text(c & 0x1F)
        if c == 0xC0:
            return None
        if c == 0xC2:
            return False
        if c == 0xC3:
            return True
        if c in (0xC4, 0xC5, 0xC6):
            n = self.num((_B, _H, _I)[c - 0xC4])
            return bytes(self.take(n))
        if c == 0xCA:
            return self.num(_f)
        if c == 0xCB:
            return self.num(_d)
        if 0xCC <= c <= 0xD3:
            return self.num((_B, _H, _I, _Q, _b, _h, _i, _q)[c - 0xCC])
        if c in (0xD9, 0xDA, 0xDB):
            return self.text(self.num((_B, _H, _I)[c - 0xD9]))
        if c in (0xDC, 0xDD):
            return self.array(self.num((_H, _I)[c - 0xDC]), depth)
        if c in (0xDE, 0xDF):
            return self.map(self.num((_H, _I)[c - 0xDE]), depth)
        raise UnpackValueError(f"format byte {c:#04x} is not carried "
                               f"(ext types and 0xc1)")

    def array(self, n: int, depth: int) -> list:
        return [self.value(depth + 1) for _ in range(n)]

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(depth + 1)
            if self.strict and not isinstance(k, (str, bytes)):
                raise UnpackValueError(f"{type(k).__name__} is not allowed "
                                       f"for a map key when strict_map_key"
                                       f"=True")
            out[k] = self.value(depth + 1)
        return out


def unpackb(buf, raw: bool = False, strict_map_key: bool = True):
    """The one value ``buf`` holds (msgpack's ``unpackb`` with
    ``use_list=True``: arrays come back as lists)."""
    r = _Reader(memoryview(buf).cast("B"), raw, strict_map_key)
    obj = r.value()
    if r.pos != len(r.buf):
        raise UnpackValueError(f"{len(r.buf) - r.pos} bytes of extra data")
    return obj
