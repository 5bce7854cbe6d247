"""IQ file source: the reference's radio/blocks/sources/iqfile.lua.

A host block: it reads bytes and converts them to numpy sample arrays
(vectorized, unlike the reference's per-sample Lua loops).  Formats whose
conversion is exact in float32 arithmetic (8- and 16-bit integers) also
offer *wire ingest*: the runtime ships the raw 1-2 byte items to the card
and converts them there (core/block.py HostSourceBlock).  A repeating
source may instead be decoded onto the card once, as a device-resident
ring that the runtime reads windows from (_FileSourceBase).  (The other
file sources are later slices of the port.)
"""

from __future__ import annotations

import mmap
import os

import numpy as np
import torch

from luaradio_tpu_torch.core.block import HostSourceBlock, Output
from luaradio_tpu_torch.ops.complexutil import to_device, wire_to_complex
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


#: the largest decoded payload a repeating file source uploads to the
#: card for its device-resident ring, in bytes
RESIDENT_BUDGET = 256 << 20


class _FileSourceBase(HostSourceBlock):
    """Base for binary file sources: the file, its mmap, byte reads with
    ``repeat_on_eof``, and the device-resident ring.

    ``resident`` controls the ring for repeating sources: a
    ``repeat_on_eof`` file whose decoded payload fits RESIDENT_BUDGET is
    decoded onto the card once, and every chunk after that is a window
    over it, with no host read and no host-to-device copy (the reference
    re-reads and re-converts the file every pass, iqfile.lua:82-116).
    ``None`` (default) takes the ring where the runtime finds the source
    eligible, ``False`` always streams from the host, and ``True``
    requires the ring: the runtime raises where the source cannot have
    it."""

    def __init__(self, file, rate: float | None, repeat_on_eof: bool = False,
                 resident: bool | None = None):
        super().__init__()
        self._file_arg = file
        self.rate = rate
        self.repeat_on_eof = repeat_on_eof
        self.resident = resident
        self.file = None
        self._mm = None
        self._res_buf = None

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
        self._res_buf = None
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

    # -- device-resident ring ----------------------------------------------
    def _whole_file_bytes(self):
        if self._mm is not None:
            return self._mm[:]
        try:
            pos = self.file.tell()
            self.file.seek(0)
            buf = self.file.read()
            self.file.seek(pos)
            return buf
        except (OSError, ValueError):
            return None

    def _file_nbytes(self):
        """File size in bytes without reading it, or None when unseekable."""
        if self._mm is not None:
            return len(self._mm)
        try:
            return os.fstat(self.file.fileno()).st_size
        except (OSError, ValueError, AttributeError):
            return None

    def _payload_nbytes_bound(self, file_bytes: int) -> int:
        """Upper bound on the decoded payload for ``file_bytes`` of wire
        data (a wire item expanding to a float32: 4x), so that
        resident_setup refuses an oversized file before decoding it."""
        return file_bytes * 4

    def _decode_all(self):
        """The whole file as (1-D payload ndarray, samples, payload items
        a sample), or None when it is empty or unreadable; overridden by
        each concrete source."""
        return None

    def _decode_ring(self, ring: torch.Tensor) -> torch.Tensor:
        """The uploaded payload -> samples on the card; overridden by each
        concrete source."""
        return ring

    def resident_setup(self, chunk: int) -> bool:
        """Decode the file onto the card for ``chunk``-sample windows, or
        return False where the source is not eligible: ``resident`` is
        False, the source does not repeat, or the payload exceeds
        RESIDENT_BUDGET (checked from the file's size before decoding)."""
        if self.resident is False or not self.repeat_on_eof:
            return False
        self.initialize()
        size = self._file_nbytes()
        if size is not None and \
                self._payload_nbytes_bound(size) > RESIDENT_BUDGET:
            return False
        decoded = self._decode_all()
        if decoded is None:
            return False
        payload, n, k = decoded
        if n == 0 or payload.nbytes > RESIDENT_BUDGET:
            return False
        # the ring extended by one chunk, so that every window (starting
        # anywhere in the first period) is contiguous
        ext = np.resize(payload[:n * k], n * k + chunk * k)
        self._res_buf = self._decode_ring(to_device(ext, self.device))
        self._res_n = n
        self._res_pos = 0
        return True

    def resident_read(self, n: int) -> torch.Tensor:
        """The next ``n`` samples from the ring: a view, no copy."""
        out = self._res_buf[..., self._res_pos:self._res_pos + n]
        self._res_pos = (self._res_pos + n) % self._res_n
        return out


class IQFileSource(_FileSourceBase):
    """Complex samples from an interleaved-I/Q binary file in any of the 14
    scalar wire formats (reference: iqfile.lua:82-116)."""

    _wire_factor = 2

    def __init__(self, file, format: str, rate: float,
                 repeat_on_eof: bool = False, resident: bool | None = None):
        super().__init__(file, rate, repeat_on_eof, resident)
        self.format = format_utils.get_format(format)
        self.add_type_signature([], [Output("out", ComplexFloat32)])

    def read(self, n: int):
        buf = self._read_bytes(n * 2 * self.format.itemsize)
        if not buf:
            return None
        return format_utils.bytes_to_complex(buf, self.format)

    def device_ingest(self):
        if self.format.name in _DEVICE_CONVERT_FORMATS:
            return _make_wire_ingest(self.format, complex_=True)
        return None

    def _raw(self, buf: bytes, count: int) -> np.ndarray:
        """``count`` wire items of ``buf`` in native byte order (u16 as
        int16, which the wire ingest reads back)."""
        raw = np.frombuffer(buf, dtype=self.format.dtype, count=count)
        if self.format.dtype.byteorder == ">":
            raw = raw.astype(self.format.dtype.newbyteorder("="))
        if raw.dtype == np.uint16:
            raw = raw.view(np.int16)
        if not raw.flags.writeable:   # torch tensors need writable memory
            raw = raw.copy()
        return raw

    def wire_read(self, n: int):
        item = self.format.itemsize
        k = self._wire_factor
        buf = self._read_bytes(n * k * item)
        if not buf:
            return None
        count = len(buf) // (k * item)
        return self._raw(buf, count * k), count

    def _payload_nbytes_bound(self, file_bytes: int) -> int:
        # wire-ingest formats upload the wire items (the same bytes);
        # host-decoded formats expand each wire item to a float32
        if self.device_ingest() is not None:
            return file_bytes
        return (file_bytes // self.format.itemsize) * 4

    def _decode_all(self):
        buf = self._whole_file_bytes()
        if not buf:
            return None
        item = self.format.itemsize
        n = len(buf) // (2 * item)
        if self.device_ingest() is not None:
            return self._raw(buf, 2 * n), n, 2
        z = format_utils.bytes_to_complex(buf[:n * 2 * item], self.format)
        return z.view(np.float32), n, 2

    def _decode_ring(self, ring):
        conv = self.device_ingest()
        return conv(ring) if conv is not None else wire_to_complex(ring)


__all__ = ["IQFileSource", "RESIDENT_BUDGET"]
