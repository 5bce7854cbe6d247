"""File sinks on the main path: IQ and WAV.

Equivalents of radio/blocks/sinks/{iqfile,wavfile}.lua.  Host blocks:
convert numpy chunks to wire bytes (vectorized) and write.  (The real and
raw file sinks are later slices of the port.)
"""

from __future__ import annotations

import struct

import numpy as np

from luaradio_tpu_torch.core.block import Input, SinkBlock
from luaradio_tpu_torch.types import ComplexFloat32, Float32
from luaradio_tpu_torch.utils import format as format_utils


def _open_writable(file):
    if isinstance(file, str):
        return open(file, "wb"), True
    if isinstance(file, int):
        import os
        return os.fdopen(file, "wb"), True
    return file, False


class _FileSinkBase(SinkBlock):
    def __init__(self, file):
        super().__init__()
        self._file_arg = file
        self.file = None

    def initialize(self):
        if self.file is None:
            self.file, self._owns = _open_writable(self._file_arg)

    def cleanup(self):
        if self.file is not None:
            self.file.flush()
            if getattr(self, "_owns", False):
                self.file.close()
                self.file = None


class IQFileSink(_FileSinkBase):
    """Complex samples -> interleaved-I/Q binary file in any of the 14 wire
    formats (reference: iqfile.lua)."""

    def __init__(self, file, format: str):
        super().__init__(file)
        self.format = format_utils.get_format(format)
        self.add_type_signature([Input("in", ComplexFloat32)], [])

    def process(self, x):
        self.file.write(format_utils.complex_to_bytes(np.asarray(x),
                                                      self.format))


class WAVFileSink(_FileSinkBase):
    """Float32 channel(s) -> PCM WAV file; the RIFF header is finalized in
    cleanup once the total length is known (reference: wavfile.lua writes the
    header on cleanup too)."""

    def __init__(self, file, num_channels: int, bits_per_sample: int = 16):
        super().__init__(file)
        self.num_channels = int(num_channels)
        if bits_per_sample not in (8, 16, 32):
            raise ValueError("bits_per_sample must be 8, 16, or 32")
        self.bits_per_sample = bits_per_sample
        if num_channels == 1:
            self.add_type_signature([Input("in", Float32)], [])
        else:
            self.add_type_signature(
                [Input(f"in{i+1}", Float32) for i in range(num_channels)], [])
        self._frames = 0

    def initialize(self):
        super().initialize()
        # placeholder header, rewritten in cleanup
        self.file.write(b"\x00" * 44)

    def process(self, *xs):
        data = np.stack([np.asarray(x, dtype=np.float64) for x in xs], axis=-1)
        bits = self.bits_per_sample
        if bits == 8:
            raw = np.clip(np.round(data * 127.5 + 127.5), 0, 255
                          ).astype(np.uint8)
        else:
            scale = float(2 ** (bits - 1) - 0.5)
            info = np.iinfo(np.int16 if bits == 16 else np.int32)
            raw = np.clip(np.round(data * scale), info.min, info.max
                          ).astype(np.int16 if bits == 16 else np.int32)
        self.file.write(raw.tobytes())
        self._frames += data.shape[0]

    def cleanup(self):
        if self.file is not None:
            bytes_per_frame = self.num_channels * self.bits_per_sample // 8
            data_size = self._frames * bytes_per_frame
            rate = int(self.get_rate())
            hdr = struct.pack(
                "<4sI4s4sIHHIIHH4sI",
                b"RIFF", 36 + data_size, b"WAVE", b"fmt ", 16,
                1, self.num_channels, rate, rate * bytes_per_frame,
                bytes_per_frame, self.bits_per_sample, b"data", data_size)
            try:
                self.file.seek(0)
                self.file.write(hdr)
            except (OSError, ValueError):
                pass  # unseekable stream: header stays zeroed
        super().cleanup()


__all__ = ["IQFileSink", "WAVFileSink"]
