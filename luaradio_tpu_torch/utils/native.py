"""ctypes binding for the native format-conversion library (the JAX
package's utils/native.py, with a loader of the port's own).

``native/src/format_conv.c`` is plain C, free of any framework.  The port
builds it at first use with the host's C compiler (``cc``, or ``CC``) and
the flags of ``native/Makefile`` into ``luaradio_tpu_torch/_build/`` and
loads it from there.  The library is keyed by a hash of the source, the
flags and the host's name: it is built with ``-march=native``, so a
checkout copied to another machine builds its own.  utils/format.py
takes these conversions for the host wire formats when the library is
available and falls back to vectorized numpy when it is not (no
compiler, a failed build, or ``LUARADIO_TPU_DISABLE_NATIVE`` set), as the
JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "src" / "format_conv.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
#: native/Makefile's CFLAGS for libluaradio_tpu_native.so
CFLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-fvisibility=hidden",
          "-march=native", "-fno-math-errno", "-fno-trapping-math",
          "-shared")

# format name -> native converter (raw -> f32)
_TO_F32 = {
    "u8": "lrtpu_u8_to_f32", "s8": "lrtpu_s8_to_f32",
    "u16le": "lrtpu_u16_to_f32", "s16le": "lrtpu_s16_to_f32",
    "u16be": "lrtpu_u16s_to_f32", "s16be": "lrtpu_s16s_to_f32",
    "u32le": "lrtpu_u32_to_f32", "s32le": "lrtpu_s32_to_f32",
    "u32be": "lrtpu_u32s_to_f32", "s32be": "lrtpu_s32s_to_f32",
    "f32le": "lrtpu_f32_copy", "f32be": "lrtpu_f32s_to_f32",
    "f64le": "lrtpu_f64_to_f32", "f64be": "lrtpu_f64s_to_f32",
}

_FROM_F32 = {
    "u8": "lrtpu_f32_to_u8", "s8": "lrtpu_f32_to_s8",
    "u16le": "lrtpu_f32_to_u16", "s16le": "lrtpu_f32_to_s16",
    "u16be": "lrtpu_f32_to_u16s", "s16be": "lrtpu_f32_to_s16s",
    "u32le": "lrtpu_f32_to_u32", "s32le": "lrtpu_f32_to_s32",
    "u32be": "lrtpu_f32_to_u32s", "s32be": "lrtpu_f32_to_s32s",
    "f32le": "lrtpu_f32_to_f32", "f32be": "lrtpu_f32_to_f32s",
    "f64le": "lrtpu_f32_to_f64", "f64be": "lrtpu_f32_to_f64s",
}

# byte-swapped formats are stored via their native-endian ctypes width
_RAW_DTYPES = {
    "u8": "u1", "s8": "i1", "u16le": "<u2", "u16be": ">u2", "s16le": "<i2",
    "s16be": ">i2", "u32le": "<u4", "u32be": ">u4", "s32le": "<i4",
    "s32be": ">i4", "f32le": "<f4", "f32be": ">f4", "f64le": "<f8",
    "f64be": ">f8",
}

_lib: ctypes.CDLL | None = None
_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libformat_conv-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile format_conv.c into ``out`` (written under a temporary name
    and renamed into place, so concurrent builds need no lock); False
    where there is no compiler or the build fails."""
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None or not SOURCE.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    r = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def load() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None where it is
    disabled or cannot be built."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("LUARADIO_TPU_DISABLE_NATIVE"):
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        for name in (*_TO_F32.values(), *_FROM_F32.values()):
            getattr(lib, name).restype = None
        _lib = lib
        return lib


def available() -> bool:
    return load() is not None


def raw_bytes_to_f32(buf: bytes, fmt_name: str, offset: float,
                     scale: float) -> np.ndarray:
    """Native raw->float32 conversion of a byte buffer of scalar samples."""
    item = np.dtype(_RAW_DTYPES[fmt_name]).itemsize
    n = len(buf) // item
    out = np.empty(n, dtype=np.float32)
    fn = getattr(load(), _TO_F32[fmt_name])
    fn(bytes(buf), out.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(n),
       ctypes.c_double(offset), ctypes.c_double(1.0 / scale))
    return out


def f32_to_raw_bytes(x: np.ndarray, fmt_name: str, offset: float,
                     scale: float) -> bytes:
    """Native float32->raw conversion returning wire bytes."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n = len(x)
    item = np.dtype(_RAW_DTYPES[fmt_name]).itemsize
    out = np.empty(n * item, dtype=np.uint8)
    fn = getattr(load(), _FROM_F32[fmt_name])
    fn(x.ctypes.data_as(ctypes.c_void_p),
       out.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(n),
       ctypes.c_double(offset), ctypes.c_double(scale))
    return out.tobytes()


__all__ = ["available", "load", "library_path", "raw_bytes_to_f32",
           "f32_to_raw_bytes"]
