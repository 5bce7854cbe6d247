"""AX.25 framer (HDLC deframing for packet radio / APRS).

Copied from the JAX package (numpy only).  Reference: radio/blocks/protocol/
ax25framer.lua: flag detection, bit unstuffing, CRC-16-CCITT (reflected)
validation, and address/control/PID/payload extraction.
"""

from __future__ import annotations

import numpy as np

from luaradio_tpu_torch.core.block import HostBlock, Input, Output
from luaradio_tpu_torch.types import Bit, ObjectSampleType

AX25_FLAG = 0x7E
AX25_RAW_FRAME_MAXLEN = 3184
AX25_FRAME_MINLEN = 136


def _crc16_x25(bits: np.ndarray) -> int:
    """Reflected CRC-16-CCITT (X.25 FCS): poly 0x8408 LSB-first, init
    0xFFFF, final complement."""
    crc = 0xFFFF
    for b in bits:
        if (crc ^ int(b)) & 1:
            crc = (crc >> 1) ^ 0x8408
        else:
            crc >>= 1
    return (~crc) & 0xFFFF


def _bits_to_int_lsb(bits: np.ndarray) -> int:
    v = 0
    for i, b in enumerate(bits):
        v |= int(b) << i
    return v


def _unstuff(bits: np.ndarray) -> np.ndarray:
    """Remove the 0 inserted after every run of five 1s."""
    out = []
    ones = 0
    for b in bits:
        if ones == 5 and b == 0:
            pass  # stuffed bit
        else:
            out.append(b)
        ones = ones + 1 if b == 1 else 0
    return np.asarray(out, dtype=np.uint8)


class AX25Frame:
    def __init__(self, addresses, control, pid, payload):
        self.addresses = addresses  # list of {"callsign":…, "ssid":…}
        self.control = control
        self.pid = pid
        self.payload = payload

    def __eq__(self, other):
        return isinstance(other, AX25Frame) and vars(self) == vars(other)

    def __str__(self):
        addrs = ", ".join(
            f'<callsign="{a["callsign"]}", ssid=0x{a["ssid"]:02x}>'
            for a in self.addresses)
        return (f"AX25Frame<addresses=[{addrs}], control=0x{self.control:02x}"
                f", pid={self.pid}, payload={self.payload!r}>")

    def to_json(self):
        import json
        return json.dumps(vars(self))


AX25FrameType = ObjectSampleType("AX25Frame", AX25Frame)


def _extract(frame_bits: np.ndarray) -> AX25Frame | None:
    """Parse an unstuffed, CRC-stripped-at-the-end frame
    (reference: ax25framer.lua ax25_extract_frame)."""
    end = len(frame_bits) - 16  # exclude FCS
    pos = 0
    addresses = []
    while True:
        if pos + 56 > end:
            return None
        callsign = "".join(
            chr(_bits_to_int_lsb(frame_bits[pos + 8 * j:pos + 8 * j + 8]) >> 1)
            for j in range(6))
        ssid_byte = _bits_to_int_lsb(frame_bits[pos + 48:pos + 56])
        addresses.append({"callsign": callsign, "ssid": ssid_byte >> 1})
        pos += 56
        if ssid_byte & 0x1:
            break
    if pos + 8 > end:
        return None
    control = _bits_to_int_lsb(frame_bits[pos:pos + 8])
    pos += 8
    pid = None
    payload = None
    if pos < end:
        pid = _bits_to_int_lsb(frame_bits[pos:pos + 8])
        pos += 8
        chars = []
        while pos + 8 <= end:
            chars.append(chr(_bits_to_int_lsb(frame_bits[pos:pos + 8])))
            pos += 8
        payload = "".join(chars)
    return AX25Frame(addresses, control, pid, payload)


class AX25FramerBlock(HostBlock):
    """NRZI-decoded bit stream -> AX.25 frames
    (reference: ax25framer.lua:137-195)."""

    variable_output = True
    AX25FrameType = AX25FrameType

    def __init__(self):
        super().__init__()
        self._buf = np.zeros(0, dtype=np.uint8)
        self._state = "idle"
        self._frame_bits: list[int] = []
        self.add_type_signature([Input("in", Bit)],
                                [Output("out", AX25FrameType)])

    def _validate_and_extract(self, raw: np.ndarray) -> AX25Frame | None:
        frame = _unstuff(raw)
        if len(frame) % 8 != 0:
            return None
        if len(frame) + 16 < AX25_FRAME_MINLEN:
            return None
        if _crc16_x25(frame[:-16]) != _bits_to_int_lsb(frame[-16:]):
            return None
        return _extract(frame)

    def process(self, x):
        buf = np.concatenate([self._buf, np.asarray(x, dtype=np.uint8)])
        out = []
        pos = 0
        while pos + 8 <= len(buf):
            window = _bits_to_int_lsb(buf[pos:pos + 8])
            if self._state == "idle":
                if window == AX25_FLAG:
                    self._frame_bits = []
                    self._state = "frame"
                    pos += 8
                else:
                    pos += 1
            else:  # frame
                if window == AX25_FLAG:
                    frame = self._validate_and_extract(
                        np.asarray(self._frame_bits, dtype=np.uint8))
                    if frame is not None:
                        out.append(frame)
                        self._state = "idle"
                    else:
                        # the flag may be the next frame's start flag
                        self._frame_bits = []
                    pos += 8
                elif len(self._frame_bits) > AX25_RAW_FRAME_MAXLEN:
                    self._state = "idle"
                else:
                    self._frame_bits.append(int(buf[pos]))
                    pos += 1
        self._buf = buf[pos:]
        return out


__all__ = ["AX25FramerBlock", "AX25Frame", "AX25FrameType"]
