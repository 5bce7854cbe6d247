"""MessagePack codec (self-contained, no third-party dependency).

The JAX package's utils/msgpack.py, copied.  The reference serializes
variable-size object samples (decoded frames, packets) as MessagePack
with a u32 big-endian length header when they cross pipes
(radio/types/object.lua:106-201, vendored
radio/thirdparty/MessagePack.lua).  This module implements the same wire
format from the public MessagePack specification so ObjectType samples
interoperate byte-for-byte across network links.

Supported types: None, bool, int (full 64-bit signed/unsigned range),
float (packed as float64), str, bytes, list/tuple, dict.  Dataclasses are
packed as maps of their fields.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 0x100:
            out += bytes((0xD9, n))
        elif n < 0x10000:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        n = len(b)
        if n < 0x100:
            out += bytes((0xC4, n))
        elif n < 0x10000:
            out.append(0xC5)
            out += struct.pack(">H", n)
        else:
            out.append(0xC6)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 0x10000:
            out.append(0xDC)
            out += struct.pack(">H", n)
        else:
            out.append(0xDD)
            out += struct.pack(">I", n)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 0x10000:
            out.append(0xDE)
            out += struct.pack(">H", n)
        else:
            out.append(0xDF)
            out += struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        _pack(dataclasses.asdict(obj), out)
    else:
        import numpy as np
        if isinstance(obj, np.generic):
            _pack(obj.item(), out)
        elif isinstance(obj, np.ndarray):
            _pack(obj.tolist(), out)
        else:
            raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v < 0x100:
        out += bytes((0xCC, v))
    elif 0 <= v < 0x10000:
        out.append(0xCD)
        out += struct.pack(">H", v)
    elif 0 <= v < 0x100000000:
        out.append(0xCE)
        out += struct.pack(">I", v)
    elif 0 <= v < 0x10000000000000000:
        out.append(0xCF)
        out += struct.pack(">Q", v)
    elif -0x80 <= v < 0:
        out.append(0xD0)
        out += struct.pack(">b", v)
    elif -0x8000 <= v < 0:
        out.append(0xD1)
        out += struct.pack(">h", v)
    elif -0x80000000 <= v < 0:
        out.append(0xD2)
        out += struct.pack(">i", v)
    elif -0x8000000000000000 <= v < 0:
        out.append(0xD3)
        out += struct.pack(">q", v)
    else:
        raise OverflowError(f"msgpack: int out of 64-bit range: {v}")


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]


def _unpack(r: _Reader) -> Any:
    c = r.u8()
    if c < 0x80:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0xA0 <= c < 0xC0:
        return r.take(c & 0x1F).decode("utf-8")
    if 0x90 <= c < 0xA0:
        return [_unpack(r) for _ in range(c & 0x0F)]
    if 0x80 <= c < 0x90:
        return {_unpack(r): _unpack(r) for _ in range(c & 0x0F)}
    if c == 0xC0:
        return None
    if c == 0xC2:
        return False
    if c == 0xC3:
        return True
    if c == 0xC4:
        return r.take(r.u8())
    if c == 0xC5:
        return r.take(struct.unpack(">H", r.take(2))[0])
    if c == 0xC6:
        return r.take(struct.unpack(">I", r.take(4))[0])
    if c == 0xCA:
        return struct.unpack(">f", r.take(4))[0]
    if c == 0xCB:
        return struct.unpack(">d", r.take(8))[0]
    if c == 0xCC:
        return r.u8()
    if c == 0xCD:
        return struct.unpack(">H", r.take(2))[0]
    if c == 0xCE:
        return struct.unpack(">I", r.take(4))[0]
    if c == 0xCF:
        return struct.unpack(">Q", r.take(8))[0]
    if c == 0xD0:
        return struct.unpack(">b", r.take(1))[0]
    if c == 0xD1:
        return struct.unpack(">h", r.take(2))[0]
    if c == 0xD2:
        return struct.unpack(">i", r.take(4))[0]
    if c == 0xD3:
        return struct.unpack(">q", r.take(8))[0]
    if c == 0xD9:
        return r.take(r.u8()).decode("utf-8")
    if c == 0xDA:
        return r.take(struct.unpack(">H", r.take(2))[0]).decode("utf-8")
    if c == 0xDB:
        return r.take(struct.unpack(">I", r.take(4))[0]).decode("utf-8")
    if c == 0xDC:
        return [_unpack(r) for _ in range(struct.unpack(">H", r.take(2))[0])]
    if c == 0xDD:
        return [_unpack(r) for _ in range(struct.unpack(">I", r.take(4))[0])]
    if c == 0xDE:
        n = struct.unpack(">H", r.take(2))[0]
        return {_unpack(r): _unpack(r) for _ in range(n)}
    if c == 0xDF:
        n = struct.unpack(">I", r.take(4))[0]
        return {_unpack(r): _unpack(r) for _ in range(n)}
    raise ValueError(f"msgpack: unsupported type byte 0x{c:02x}")


def unpackb(buf: bytes) -> Any:
    r = _Reader(buf)
    obj = _unpack(r)
    if r.pos != len(buf):
        raise ValueError("msgpack: trailing bytes")
    return obj


# -- framed wire format (reference object.lua:106-201: u32-BE length) -------

def serialize_framed(obj: Any) -> bytes:
    """One object sample on the wire: u32-BE payload length + MessagePack
    payload (the reference's exact pipe framing)."""
    payload = packb(obj)
    return struct.pack(">I", len(payload)) + payload


def deserialize_framed(buf: bytes, offset: int = 0):
    """Parse one framed object at buf[offset:].  Returns (obj, next_offset)
    or (None, offset) if the frame is incomplete."""
    if len(buf) - offset < 4:
        return None, offset
    (n,) = struct.unpack_from(">I", buf, offset)
    if len(buf) - offset - 4 < n:
        return None, offset
    obj = unpackb(bytes(buf[offset + 4:offset + 4 + n]))
    return obj, offset + 4 + n


__all__ = ["packb", "unpackb", "serialize_framed", "deserialize_framed"]
