"""File sources: IQ, real, raw, WAV and JSON (the reference's
radio/blocks/sources/{iqfile,realfile,rawfile,wavfile,json}.lua).

Host blocks: they read bytes and convert them to numpy sample arrays
(vectorized, unlike the reference's per-sample Lua loops).  Of the ingest
routes (core/ingest.py), the IQ and real file sources (_WireFileSource)
offer the wire one in the formats exact in float32 (8- and 16-bit
integers), and a repeating binary source the resident one
(_FileSourceBase).
"""

from __future__ import annotations

import json as _json
import mmap
import os
import struct

import numpy as np
import torch

from luaradio_tpu_torch.core.block import HostSourceBlock, Output
from luaradio_tpu_torch.ops.complexutil import (to_device, wire_converter,
                                                wire_to_complex)
from luaradio_tpu_torch.types import (ComplexFloat32, Float32, SampleType,
                                      object_type)
from luaradio_tpu_torch.utils import format as format_utils

#: the wire formats whose conversion is exact in float32, which take the
#: wire route (32-bit formats stay on the host's float64 path for
#: bit-identical rounding)
_DEVICE_CONVERT_FORMATS = {
    "u8", "s8", "u16le", "u16be", "s16le", "s16be",
}


def _open_readable(file):
    if isinstance(file, str):
        return open(file, "rb"), True
    if isinstance(file, int):
        return os.fdopen(file, "rb"), True
    return file, False


#: the largest decoded payload a repeating file source uploads to the
#: card for its device-resident ring, in bytes
RESIDENT_BUDGET = 256 << 20


class _FileSourceBase(HostSourceBlock):
    """Base for binary file sources: the file, its mmap, byte reads with
    ``repeat_on_eof``, and the device-resident ring.

    The ring (``resident``, core/block.py HostSourceBlock): a
    ``repeat_on_eof`` file whose decoded payload fits RESIDENT_BUDGET is
    decoded onto the card once, and every chunk after that is a window
    over it, with no host read and no host-to-device copy (the reference
    re-reads and re-converts the file every pass, iqfile.lua:82-116)."""

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

    def _mm_spans(self, nbytes: int):
        """(offset, length) of each piece of the mapped file's next
        ``nbytes``, wrapping to its start with ``repeat_on_eof``; the read
        position moves past each piece as it is yielded."""
        size = len(self._mm)
        while nbytes > 0:
            if self._mm_pos >= size:
                if not self.repeat_on_eof:
                    return
                self._mm_pos = 0
            pos = self._mm_pos
            take = min(nbytes, size - pos)
            self._mm_pos = pos + take
            nbytes -= take
            yield pos, take

    def _read_bytes_mm(self, nbytes: int) -> bytes:
        return b"".join(self._mm[p:p + t] for p, t in self._mm_spans(nbytes))

    def _read_bytes_into(self, dst: np.ndarray) -> int:
        """The next ``dst.size`` bytes, as _read_bytes reads them, written
        into the uint8 array ``dst``; returns the count written.  A mapped
        file is copied straight from its pages (no bytes object between)."""
        if self._mm is None:
            buf = self._read_bytes(dst.size)
            dst[:len(buf)] = np.frombuffer(buf, np.uint8)
            return len(buf)
        got = 0
        for p, t in self._mm_spans(dst.size):
            dst[got:got + t] = np.frombuffer(self._mm, np.uint8, t, p)
            got += t
        return got

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
        """Upper bound on the decoded payload of a ``file_bytes`` file (the
        file itself by default), so that resident_setup refuses an
        oversized file before decoding it."""
        return file_bytes

    def _decode_all(self):
        """The whole file as (1-D payload ndarray, samples, payload items
        a sample), or None when it is empty or unreadable; overridden by
        each concrete source."""
        return None

    def _decode_ring(self, ring: torch.Tensor, k: int) -> torch.Tensor:
        """The uploaded payload (``k`` items a sample) -> samples on the
        card: pairs as complex64."""
        return wire_to_complex(ring) if k == 2 else ring

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
        self._res_buf = self._decode_ring(to_device(ext, self.device), k)
        self._res_n = n
        self._res_pos = 0
        return True

    def resident_read(self, n: int) -> torch.Tensor:
        """The next ``n`` samples from the ring: a view, no copy."""
        out = self._res_buf[..., self._res_pos:self._res_pos + n]
        self._res_pos = (self._res_pos + n) % self._res_n
        return out


class _WireFileSource(_FileSourceBase):
    """The IQ and real file sources: a scalar wire ``format``, the wire
    route of the exact-in-float32 formats, and their rings."""

    def __init__(self, file, format: str, rate: float,
                 repeat_on_eof: bool = False, resident: bool | None = None):
        super().__init__(file, rate, repeat_on_eof, resident)
        self.format = format_utils.get_format(format)

    def device_ingest(self):
        fmt = self.format
        if fmt.name not in _DEVICE_CONVERT_FORMATS:
            return None
        return wire_converter(fmt.offset, fmt.scale, divide=True,
                              complex_=self.wire_factor == 2,
                              u16=fmt.dtype.kind == "u" and fmt.itemsize == 2)

    @property
    def wire_dtype(self) -> np.dtype:
        """wire_read's item dtype: the format's, in native byte order, u16
        as int16."""
        dt = self.format.dtype.newbyteorder("=")
        return np.dtype(np.int16) if dt == np.uint16 else dt

    def _convert(self, buf: bytes) -> np.ndarray:
        """Host conversion of whole samples of ``buf``."""
        raise NotImplementedError

    def read(self, n: int):
        buf = self._read_bytes(n * self.wire_factor * self.format.itemsize)
        if not buf:
            return None
        return self._convert(buf)

    def wire_read(self, n: int):
        out = np.empty(n * self.wire_factor, self.wire_dtype)
        count = self.read_wire_into(out)
        return (out[:count * self.wire_factor], count) if count else None

    def read_wire_into(self, out: np.ndarray) -> int:
        """wire_read's items for up to ``out.size // wire_factor`` samples
        written into ``out`` (a contiguous row of ``wire_dtype``);
        returns the whole samples read (0 at EOF)."""
        got = self._read_bytes_into(out.view(np.uint8))
        count = got // (self.wire_factor * self.format.itemsize)
        if self.format.dtype.byteorder == ">":
            out[:count * self.wire_factor].byteswap(inplace=True)
        return count

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
        k, item = self.wire_factor, self.format.itemsize
        n = len(buf) // (k * item)
        if self.device_ingest() is not None:     # the wire items, u16 as int16
            return np.frombuffer(buf, self.format.dtype, k * n).astype(
                self.wire_dtype), n, k
        f = self._convert(buf[:n * k * item])
        return f.view(np.float32), n, k

    def _decode_ring(self, ring, k):
        conv = self.device_ingest()
        return super()._decode_ring(ring, k) if conv is None else conv(ring)


class IQFileSource(_WireFileSource):
    """Complex samples from an interleaved-I/Q binary file in any of the 14
    scalar wire formats (reference: iqfile.lua:82-116)."""

    wire_factor = 2

    def __init__(self, file, format: str, rate: float,
                 repeat_on_eof: bool = False, resident: bool | None = None):
        super().__init__(file, format, rate, repeat_on_eof, resident)
        self.add_type_signature([], [Output("out", ComplexFloat32)])

    def _convert(self, buf):
        return format_utils.bytes_to_complex(buf, self.format)


class RealFileSource(_WireFileSource):
    """Float32 samples from a binary file in any of the 14 scalar wire
    formats (reference: realfile.lua)."""

    def __init__(self, file, format: str, rate: float,
                 repeat_on_eof: bool = False, resident: bool | None = None):
        super().__init__(file, format, rate, repeat_on_eof, resident)
        self.add_type_signature([], [Output("out", Float32)])

    def _convert(self, buf):
        return format_utils.bytes_to_real(buf, self.format)


class RawFileSource(_FileSourceBase):
    """The native in-memory sample stream of any basic type (reference:
    rawfile.lua reads the wire structs directly)."""

    def __init__(self, file, data_type: SampleType, rate: float,
                 repeat_on_eof: bool = False, resident: bool | None = None):
        super().__init__(file, rate, repeat_on_eof, resident)
        self.data_type = data_type
        self.add_type_signature([], [Output("out", data_type)])

    def read(self, n: int):
        item = self.data_type.dtype.itemsize
        buf = self._read_bytes(n * item)
        if not buf:
            return None
        count = len(buf) // item
        # a copy: torch tensors need writable memory
        return np.frombuffer(buf[:count * item],
                             dtype=self.data_type.dtype).copy()

    def _decode_all(self):
        buf = self._whole_file_bytes()
        if not buf:
            return None
        dt = self.data_type.dtype
        n = len(buf) // dt.itemsize
        arr = np.frombuffer(buf[:n * dt.itemsize], dtype=dt).copy()
        if dt.kind == "c":
            return arr.view(np.float32), n, 2
        return arr, n, 1


class WAVFileSource(HostSourceBlock):
    """PCM or float WAV file source, one Float32 output per channel
    (reference: wavfile.lua; u8, s16 and s32 PCM, f32 and f64 float)."""

    _FMT_DTYPES = {(1, 8): np.dtype("u1"), (1, 16): np.dtype("<i2"),
                   (1, 32): np.dtype("<i4"), (3, 32): np.dtype("<f4"),
                   (3, 64): np.dtype("<f8")}

    def __init__(self, file, num_channels: int, repeat_on_eof: bool = False):
        super().__init__()
        self._file_arg = file
        self.num_channels = int(num_channels)
        self.repeat_on_eof = repeat_on_eof
        self.file = None
        if num_channels == 1:
            self.add_type_signature([], [Output("out", Float32)])
        else:
            self.add_type_signature(
                [], [Output(f"out{i+1}", Float32)
                     for i in range(num_channels)])

    def initialize(self):
        if self.file is not None:
            return
        self.file, self._owns = _open_readable(self._file_arg)
        riff, _size, wave = struct.unpack("<4sI4s", self.file.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        while True:
            hdr = self.file.read(8)
            if len(hdr) < 8:
                raise ValueError("WAV: no data chunk found")
            cid, csz = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                data = self.file.read(csz)
                (tag, nch, rate, _br, _ba, bits) = struct.unpack(
                    "<HHIIHH", data[:16])
                fmt = (tag, nch, rate, bits)
            elif cid == b"data":
                self._data_start = self.file.tell()
                self._data_size = csz
                break
            else:
                self.file.seek(csz + (csz & 1), 1)
        if fmt is None:
            raise ValueError("WAV: no fmt chunk found")
        tag, nch, rate, bits = fmt
        if nch != self.num_channels:
            raise ValueError(f"WAV has {nch} channels, expected "
                             f"{self.num_channels}")
        if (tag, bits) not in self._FMT_DTYPES:
            raise ValueError(f"unsupported WAV format tag={tag} bits={bits}")
        self.rate = float(rate)
        self._dtype = self._FMT_DTYPES[(tag, bits)]
        self._bits = bits
        self._tag = tag
        self._read_bytes_left = self._data_size

    def get_rate(self):
        if self.rate is None:
            self.initialize()
        return float(self.rate)

    def read(self, n: int):
        item = self._dtype.itemsize * self.num_channels
        want = min(n * item, self._read_bytes_left)
        buf = self.file.read(want) if want > 0 else b""
        self._read_bytes_left -= len(buf)
        if not buf:
            if self.repeat_on_eof:
                self.file.seek(self._data_start)
                self._read_bytes_left = self._data_size
                buf = self.file.read(min(n * item, self._read_bytes_left))
                self._read_bytes_left -= len(buf)
            if not buf:
                return None
        count = len(buf) // item
        raw = np.frombuffer(buf[:count * item], dtype=self._dtype)
        raw = raw.reshape(-1, self.num_channels)
        if self._tag == 3:
            f = raw.astype(np.float32)
        elif self._bits == 8:
            f = (raw.astype(np.float32) - 127.5) / 127.5
        else:
            scale = float(2 ** (self._bits - 1) - 0.5)
            f = raw.astype(np.float32) / scale
        if self.num_channels == 1:
            return f[:, 0]
        return tuple(np.ascontiguousarray(f[:, i])
                     for i in range(self.num_channels))

    def cleanup(self):
        if self.file is not None and getattr(self, "_owns", False):
            self.file.close()
            self.file = None


class JSONSource(HostSourceBlock):
    """Newline-delimited JSON object stream (reference: json.lua): host
    object samples at the given rate."""

    def __init__(self, file, rate: float):
        super().__init__()
        self._file_arg = file
        self.rate = rate
        self.file = None
        self.add_type_signature([], [Output("out",
                                            object_type("JSONObject"))])

    def initialize(self):
        if self.file is None:
            if isinstance(self._file_arg, str):
                self.file = open(self._file_arg, "r")
                self._owns = True
            else:
                self.file = self._file_arg
                self._owns = False

    def read(self, n: int):
        out = []
        for _ in range(n):
            line = self.file.readline()
            if not line:
                break
            line = line.strip()
            if line:
                out.append(_json.loads(line))
        if not out:
            return None
        return out

    def cleanup(self):
        if self.file is not None and getattr(self, "_owns", False):
            self.file.close()
            self.file = None


__all__ = ["IQFileSource", "RealFileSource", "RawFileSource",
           "WAVFileSource", "JSONSource", "RESIDENT_BUDGET"]
