"""Audio sinks and sources (PulseAudio / PortAudio): the JAX package's
blocks/sinks/audio.py (reference radio/blocks/{sinks,sources}/
{pulseaudio,portaudio}.lua) — ctypes bindings to libpulse-simple /
libportaudio, raising clearly when the library is absent (headless hosts).

The two loaders, ``_load_pulse`` and ``_load_portaudio``, are the seam
where a test (or a run without a sound server) puts an in-process fake
library: the blocks call them at initialize() through this module.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from luaradio_tpu_torch.core.block import (HostSourceBlock, Input, Output,
                                           SinkBlock)
from luaradio_tpu_torch.types import Float32

_PA_SAMPLE_FLOAT32LE = 5
_PA_STREAM_PLAYBACK = 1
_PA_STREAM_RECORD = 2


class _pa_sample_spec(ctypes.Structure):
    _fields_ = [("format", ctypes.c_int), ("rate", ctypes.c_uint32),
                ("channels", ctypes.c_uint8)]


def _load_pulse():
    path = ctypes.util.find_library("pulse-simple")
    if path is None:
        raise RuntimeError("libpulse-simple not found; audio unavailable on "
                           "this host — use a WAVFileSink instead")
    lib = ctypes.CDLL(path)
    lib.pa_simple_new.restype = ctypes.c_void_p
    return lib


def _load_portaudio():
    path = ctypes.util.find_library("portaudio")
    if path is None:
        raise RuntimeError("libportaudio not found; audio unavailable on "
                           "this host")
    return ctypes.CDLL(path)


class _PulseAudioBase:
    def _open(self, direction: int, num_channels: int, rate: float,
              name: bytes):
        self._lib = _load_pulse()
        spec = _pa_sample_spec(_PA_SAMPLE_FLOAT32LE, int(rate), num_channels)
        err = ctypes.c_int(0)
        self._pa = self._lib.pa_simple_new(
            None, b"luaradio_tpu", direction, None, name,
            ctypes.byref(spec), None, None, ctypes.byref(err))
        if not self._pa:
            raise RuntimeError(f"pa_simple_new() failed (error {err.value})")

    def _close(self):
        if getattr(self, "_pa", None):
            self._lib.pa_simple_free(ctypes.c_void_p(self._pa))
            self._pa = None


class PulseAudioSink(SinkBlock, _PulseAudioBase):
    """Play one or more Float32 channels through PulseAudio
    (reference: sinks/pulseaudio.lua)."""

    def __init__(self, num_channels: int = 1):
        super().__init__()
        self.num_channels = num_channels
        if num_channels == 1:
            self.add_type_signature([Input("in", Float32)], [])
        else:
            self.add_type_signature(
                [Input(f"in{i+1}", Float32) for i in range(num_channels)], [])

    def initialize(self):
        self._open(_PA_STREAM_PLAYBACK, self.num_channels, self.get_rate(),
                   b"playback")

    def process(self, *xs):
        data = np.stack([np.asarray(x, dtype=np.float32) for x in xs],
                        axis=-1).tobytes()
        err = ctypes.c_int(0)
        self._lib.pa_simple_write(ctypes.c_void_p(self._pa), data, len(data),
                                  ctypes.byref(err))

    def cleanup(self):
        if getattr(self, "_pa", None):
            self._lib.pa_simple_drain(ctypes.c_void_p(self._pa), None)
        self._close()


class PulseAudioSource(HostSourceBlock, _PulseAudioBase):
    """Record Float32 samples from PulseAudio
    (reference: sources/pulseaudio.lua)."""

    def __init__(self, num_channels: int, rate: float):
        super().__init__()
        self.num_channels = num_channels
        self.rate = rate
        if num_channels == 1:
            self.add_type_signature([], [Output("out", Float32)])
        else:
            self.add_type_signature(
                [], [Output(f"out{i+1}", Float32)
                     for i in range(num_channels)])

    def initialize(self):
        self._open(_PA_STREAM_RECORD, self.num_channels, self.rate, b"record")

    def read(self, n: int):
        nbytes = n * 4 * self.num_channels
        buf = (ctypes.c_uint8 * nbytes)()
        err = ctypes.c_int(0)
        r = self._lib.pa_simple_read(ctypes.c_void_p(self._pa), buf, nbytes,
                                     ctypes.byref(err))
        if r < 0:
            return None
        data = np.frombuffer(bytes(buf), dtype=np.float32)
        data = data.reshape(-1, self.num_channels)
        if self.num_channels == 1:
            return data[:, 0]
        return tuple(np.ascontiguousarray(data[:, i])
                     for i in range(self.num_channels))

    def cleanup(self):
        self._close()


class PortAudioSink(SinkBlock):
    """Play Float32 channels through PortAudio
    (reference: sinks/portaudio.lua)."""

    def __init__(self, num_channels: int = 1):
        super().__init__()
        self.num_channels = num_channels
        if num_channels == 1:
            self.add_type_signature([Input("in", Float32)], [])
        else:
            self.add_type_signature(
                [Input(f"in{i+1}", Float32) for i in range(num_channels)], [])

    def initialize(self):
        lib = _load_portaudio()
        self._lib = lib
        if lib.Pa_Initialize() != 0:
            raise RuntimeError("Pa_Initialize() failed")
        stream = ctypes.c_void_p()
        # paFloat32 = 0x1; blocking default stream
        r = lib.Pa_OpenDefaultStream(ctypes.byref(stream), 0,
                                     self.num_channels, 0x1,
                                     ctypes.c_double(self.get_rate()), 0,
                                     None, None)
        if r != 0:
            raise RuntimeError("Pa_OpenDefaultStream() failed")
        self._stream = stream
        lib.Pa_StartStream(stream)

    def process(self, *xs):
        data = np.stack([np.asarray(x, dtype=np.float32) for x in xs],
                        axis=-1)
        self._lib.Pa_WriteStream(self._stream, data.tobytes(), len(data))

    def cleanup(self):
        if getattr(self, "_stream", None):
            self._lib.Pa_StopStream(self._stream)
            self._lib.Pa_CloseStream(self._stream)
            self._lib.Pa_Terminate()
            self._stream = None


class PortAudioSource(HostSourceBlock):
    """Record Float32 samples from PortAudio
    (reference: sources/portaudio.lua)."""

    def __init__(self, num_channels: int, rate: float):
        super().__init__()
        self.num_channels = num_channels
        self.rate = rate
        if num_channels == 1:
            self.add_type_signature([], [Output("out", Float32)])
        else:
            self.add_type_signature(
                [], [Output(f"out{i+1}", Float32)
                     for i in range(num_channels)])

    def initialize(self):
        lib = _load_portaudio()
        self._lib = lib
        if lib.Pa_Initialize() != 0:
            raise RuntimeError("Pa_Initialize() failed")
        stream = ctypes.c_void_p()
        r = lib.Pa_OpenDefaultStream(ctypes.byref(stream), self.num_channels,
                                     0, 0x1, ctypes.c_double(self.rate), 0,
                                     None, None)
        if r != 0:
            raise RuntimeError("Pa_OpenDefaultStream() failed")
        self._stream = stream
        lib.Pa_StartStream(stream)

    def read(self, n: int):
        frames = min(n, 1 << 16)
        buf = (ctypes.c_float * (frames * self.num_channels))()
        r = self._lib.Pa_ReadStream(self._stream, buf, frames)
        if r not in (0, -9981):  # 0 ok, paInputOverflowed tolerated
            return None
        data = np.frombuffer(bytes(bytearray(buf)), dtype=np.float32)
        data = data.reshape(-1, self.num_channels)
        if self.num_channels == 1:
            return data[:, 0]
        return tuple(np.ascontiguousarray(data[:, i])
                     for i in range(self.num_channels))

    def cleanup(self):
        if getattr(self, "_stream", None):
            self._lib.Pa_StopStream(self._stream)
            self._lib.Pa_CloseStream(self._stream)
            self._lib.Pa_Terminate()
            self._stream = None


__all__ = ["PulseAudioSink", "PulseAudioSource", "PortAudioSink",
           "PortAudioSource"]
