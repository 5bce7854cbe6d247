"""IQ file source: the reference's radio/blocks/sources/iqfile.lua.

A host block: it reads bytes and converts them to numpy sample arrays
(vectorized, unlike the reference's per-sample Lua loops).  Formats whose
conversion is exact in float32 arithmetic (8- and 16-bit integers) also
offer *wire ingest*: the runtime ships the raw 1-2 byte items to the card
and converts them there (core/block.py HostSourceBlock).  (The other file
sources and the device-resident ring are later slices of the port.)
"""

from __future__ import annotations

import mmap

import numpy as np
import torch

from luaradio_tpu_torch.core.block import HostSourceBlock, Output
from luaradio_tpu_torch.ops.complexutil import wire_to_complex
from luaradio_tpu_torch.types import ComplexFloat32
from luaradio_tpu_torch.utils import format as format_utils

#: wire formats whose raw->float conversion is exact in float32 arithmetic;
#: these may be converted on the card, so only the 1-2 byte/item wire
#: bytes cross the host->device link (32-bit formats stay on the host
#: float64 path for bit-identical rounding).
_DEVICE_CONVERT_FORMATS = {
    "u8", "s8", "u16le", "u16be", "s16le", "s16be",
}


def _open_readable(file):
    if isinstance(file, str):
        return open(file, "rb"), True
    if isinstance(file, int):
        import os
        return os.fdopen(file, "rb"), True
    return file, False


def _make_wire_ingest(fmt, complex_: bool):
    """On-device raw -> samples converter for an exact-in-f32 wire format:
    float = (raw - offset) / scale, then interleaved pairs -> complex64."""
    offset = np.float32(fmt.offset)
    scale = np.float32(fmt.scale)
    u16 = fmt.dtype.kind == "u" and fmt.itemsize == 2

    def ingest(raw: torch.Tensor) -> torch.Tensor:
        if u16:  # shipped as int16 (torch's uint16 has few kernels)
            raw = raw.to(torch.int32) & 0xFFFF
        f = (raw.to(torch.float32) - offset) / scale
        return wire_to_complex(f) if complex_ else f
    return ingest


class IQFileSource(HostSourceBlock):
    """Complex samples from an interleaved-I/Q binary file in any of the 14
    scalar wire formats (reference: iqfile.lua:82-116)."""

    _wire_factor = 2

    def __init__(self, file, format: str, rate: float,
                 repeat_on_eof: bool = False):
        super().__init__()
        self._file_arg = file
        self.rate = rate
        self.repeat_on_eof = repeat_on_eof
        self.file = None
        self._mm = None
        self.format = format_utils.get_format(format)
        self.add_type_signature([], [Output("out", ComplexFloat32)])

    def initialize(self):
        if self.file is None:
            self.file, self._owns = _open_readable(self._file_arg)
        if self._mm is None:
            # mmap path-backed files: reads become zero-copy page-cache
            # views instead of read() copies
            try:
                self._mm = mmap.mmap(self.file.fileno(), 0,
                                     access=mmap.ACCESS_READ)
                self._mm_pos = self.file.tell()
            except (OSError, ValueError):
                self._mm = None

    def cleanup(self):
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self.file is not None and getattr(self, "_owns", False):
            self.file.close()
            self.file = None

    def _read_bytes(self, nbytes: int) -> bytes:
        if self._mm is not None:
            return self._read_bytes_mm(nbytes)
        buf = self.file.read(nbytes)
        while self.repeat_on_eof and len(buf) < nbytes:
            self.file.seek(0)
            more = self.file.read(nbytes - len(buf))
            if not more:
                break
            buf += more
        return buf

    def _read_bytes_mm(self, nbytes: int):
        mm, size = self._mm, len(self._mm)
        pos = self._mm_pos
        end = min(pos + nbytes, size)
        buf = mm[pos:end]
        self._mm_pos = end
        while self.repeat_on_eof and len(buf) < nbytes and size > 0:
            take = min(nbytes - len(buf), size)
            buf += mm[0:take]
            self._mm_pos = take % size if take == size else take
        return buf

    def read(self, n: int):
        buf = self._read_bytes(n * 2 * self.format.itemsize)
        if not buf:
            return None
        return format_utils.bytes_to_complex(buf, self.format)

    def device_ingest(self):
        if self.format.name in _DEVICE_CONVERT_FORMATS:
            return _make_wire_ingest(self.format, complex_=True)
        return None

    def wire_read(self, n: int):
        item = self.format.itemsize
        k = self._wire_factor
        buf = self._read_bytes(n * k * item)
        if not buf:
            return None
        count = len(buf) // (k * item)
        raw = np.frombuffer(buf, dtype=self.format.dtype, count=count * k)
        if self.format.dtype.byteorder == ">":
            raw = raw.astype(self.format.dtype.newbyteorder("="))
        if raw.dtype == np.uint16:
            raw = raw.view(np.int16)
        if not raw.flags.writeable:   # torch tensors need writable memory
            raw = raw.copy()
        return raw, count


__all__ = ["IQFileSource"]
