"""Binary sample formats.

The 14 scalar wire formats of the reference
(radio/utilities/format_utils.lua:82-111): u8/s8/u16/s16/
u32/s32/f32/f64 in little/big endian, with offset/scale conversion to float
in approximately [-1, 1): float = (raw - offset) / scale.

Host-side conversion takes the native C library (utils/native.py) when it
is available and vectorized numpy otherwise (the reference converts per
sample in Lua).  The formats whose conversion is exact in float32 are
also converted on the card (ops/complexutil.py wire_converter).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SampleFormat:
    name: str
    dtype: np.dtype
    offset: float
    scale: float

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize


def _fmt(name: str, base: str, offset: float, scale: float) -> SampleFormat:
    return SampleFormat(name, np.dtype(base), offset, scale)


FORMATS: dict[str, SampleFormat] = {
    "u8":    _fmt("u8", "u1", 127.5, 127.5),
    "s8":    _fmt("s8", "i1", 0.0, 127.5),
    "u16le": _fmt("u16le", "<u2", 32767.5, 32767.5),
    "u16be": _fmt("u16be", ">u2", 32767.5, 32767.5),
    "s16le": _fmt("s16le", "<i2", 0.0, 32767.5),
    "s16be": _fmt("s16be", ">i2", 0.0, 32767.5),
    "u32le": _fmt("u32le", "<u4", 2147483647.5, 2147483647.5),
    "u32be": _fmt("u32be", ">u4", 2147483647.5, 2147483647.5),
    "s32le": _fmt("s32le", "<i4", 0.0, 2147483647.5),
    "s32be": _fmt("s32be", ">i4", 0.0, 2147483647.5),
    "f32le": _fmt("f32le", "<f4", 0.0, 1.0),
    "f32be": _fmt("f32be", ">f4", 0.0, 1.0),
    "f64le": _fmt("f64le", "<f8", 0.0, 1.0),
    "f64be": _fmt("f64be", ">f8", 0.0, 1.0),
}


def get_format(name: str) -> SampleFormat:
    if name not in FORMATS:
        raise ValueError(f"unsupported format {name!r}")
    return FORMATS[name]


def raw_to_float(raw: np.ndarray, fmt: SampleFormat) -> np.ndarray:
    """raw integer/float samples -> float32 in [-1, 1)."""
    if fmt.offset == 0.0 and fmt.scale == 1.0:
        return raw.astype(np.float32)
    return ((raw.astype(np.float64) - fmt.offset) / fmt.scale).astype(np.float32)


def float_to_raw(x: np.ndarray, fmt: SampleFormat) -> np.ndarray:
    """float samples -> raw wire samples."""
    if fmt.offset == 0.0 and fmt.scale == 1.0:
        return np.asarray(x).astype(fmt.dtype)
    v = np.asarray(x, dtype=np.float64) * fmt.scale + fmt.offset
    info_dtype = fmt.dtype.base
    if np.issubdtype(info_dtype, np.integer):
        info = np.iinfo(info_dtype)
        v = np.clip(np.round(v), info.min, info.max)
    return v.astype(fmt.dtype)


def bytes_to_complex(buf: bytes, fmt: SampleFormat) -> np.ndarray:
    """Interleaved I/Q wire bytes -> complex64 samples."""
    from luaradio_tpu_torch.utils import native
    n = len(buf) // (2 * fmt.itemsize)
    if native.available():
        f = native.raw_bytes_to_f32(buf[:n * 2 * fmt.itemsize], fmt.name,
                                    fmt.offset, fmt.scale)
        return f.view(np.complex64)
    raw = np.frombuffer(buf, dtype=fmt.dtype, count=2 * n)
    f = raw_to_float(raw, fmt)
    return np.ascontiguousarray(f).view(np.complex64)


def bytes_to_real(buf: bytes, fmt: SampleFormat) -> np.ndarray:
    """Wire bytes -> float32 samples."""
    from luaradio_tpu_torch.utils import native
    n = len(buf) // fmt.itemsize
    if native.available():
        return native.raw_bytes_to_f32(buf[:n * fmt.itemsize], fmt.name,
                                       fmt.offset, fmt.scale)
    raw = np.frombuffer(buf, dtype=fmt.dtype, count=n)
    return raw_to_float(raw, fmt)


def complex_to_bytes(x: np.ndarray, fmt: SampleFormat) -> bytes:
    from luaradio_tpu_torch.utils import native
    x = np.ascontiguousarray(np.asarray(x, dtype=np.complex64))
    inter = x.view(np.float32)
    if native.available():
        return native.f32_to_raw_bytes(inter, fmt.name, fmt.offset, fmt.scale)
    return float_to_raw(inter, fmt).tobytes()


def real_to_bytes(x: np.ndarray, fmt: SampleFormat) -> bytes:
    from luaradio_tpu_torch.utils import native
    x = np.asarray(x, dtype=np.float32)
    if native.available():
        return native.f32_to_raw_bytes(x, fmt.name, fmt.offset, fmt.scale)
    return float_to_raw(x, fmt).tobytes()


__all__ = [
    "SampleFormat", "FORMATS", "get_format",
    "raw_to_float", "float_to_raw",
    "bytes_to_complex", "bytes_to_real", "complex_to_bytes", "real_to_bytes",
]
