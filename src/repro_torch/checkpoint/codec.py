"""The subset of MessagePack the checkpoint format uses, written out so the
port needs no ``msgpack`` package: nil, bool, int, float (64-bit), str, bin,
array and map. ``packb(obj)`` gives the bytes ``msgpack.packb(obj,
use_bin_type=True)`` gives (each value in its smallest encoding; a dict's
items in insertion order); ``unpackb(data)`` reads them back as
``msgpack.unpackb(data, raw=False)`` does, and raises ``ValueError`` on
truncated, unknown or trailing bytes.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _header(out: List[bytes], n: int, fix: int, fix_max: int,
            codes: Tuple[int, int, int], what: str) -> None:
    """A length header: the fix form up to ``fix_max``, else the 8-bit
    (when ``codes[0]`` exists), 16-bit or 32-bit length."""
    if n <= fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack: {what} of length {n} is too long")


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v < 128:
        out.append(bytes((v,)))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, bits in ((0xcc, ">BB", 8), (0xcd, ">BH", 16),
                                (0xce, ">BI", 32), (0xcf, ">BQ", 64)):
            if v < 1 << bits:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"msgpack: int {v} is too large")
    else:
        for code, fmt, bits in ((0xd0, ">Bb", 8), (0xd1, ">Bh", 16),
                                (0xd2, ">Bi", 32), (0xd3, ">Bq", 64)):
            if v >= -(1 << (bits - 1)):
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"msgpack: int {v} is too small")


def _pack(out: List[bytes], obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xa0, 31, (0xd9, 0xda, 0xdb), "str")
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _header(out, len(raw), 0, -1, (0xc4, 0xc5, 0xc6), "bin")
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 15, (0, 0xdc, 0xdd), "array")
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 15, (0, 0xde, 0xdf), "map")
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(out, obj)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.pos:end].tobytes()
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if b in sized:
            return self.take(self.unpack(sized[b]))
        numbers = {0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if b in strs:
            return self.str(self.unpack(strs[b]))
        if b in (0xdc, 0xdd):
            return self.array(self.unpack(">H" if b == 0xdc else ">I"))
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: extra data after the object")
    return obj
