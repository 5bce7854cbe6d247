"""RDS (Radio Data System) framer and decoder.

Copied from the JAX package (numpy only).  Reference: radio/blocks/protocol/
{rdsframer,rdsdecoder}.lua.  Host blocks (bit-rate streams, data-dependent
output); the syndrome tables are derived from the RDS generator polynomial
g(x) = x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1 (RDS Standard, Annex A) rather
than hard-coded.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from luaradio_tpu_torch.core.block import HostBlock, Input, Output
from luaradio_tpu_torch.types import Bit, ObjectSampleType, bits_to_number

RDS_FRAME_LEN = 104
RDS_BLOCK_LEN = 26

#: g(x) for the (26,16) shortened cyclic code, bit 10 = x^10 ... bit 0 = 1.
_RDS_POLY = 0b10110111001  # x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1

#: Offset words added to the check bits of blocks A/B/C/C'/D.
RDS_OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "Cp": 0x350,
                    "D": 0x1B4}


def _poly_mod(value: int, nbits: int) -> int:
    """Remainder of value (as polynomial of degree < nbits) mod g(x)."""
    for i in range(nbits - 1, 9, -1):
        if value & (1 << i):
            value ^= _RDS_POLY << (i - 10)
    return value


# Syndrome of each single-bit position (parity-check matrix rows) and the
# inverse map used for 1-bit error correction.
_SYNDROMES = [_poly_mod(1 << i, 26) for i in range(26)]
_CORRECT = {s: (1 << i) for i, s in enumerate(_SYNDROMES)}


def _syndrome(block_bits: int) -> int:
    s = 0
    for i in range(26):
        if block_bits & (1 << i):
            s ^= _SYNDROMES[i]
    return s


def correct_block(block_bits: int, offset_word: int) -> int | None:
    """Validate a 26-bit block (16 data + 10 check) against an offset word;
    correct single-bit errors.  Returns corrected bits or None."""
    s = _syndrome(block_bits ^ offset_word)
    if s == 0:
        return block_bits
    if s in _CORRECT:
        return block_bits ^ _CORRECT[s]
    return None


@dataclass
class RDSFrame:
    """One validated RDS group: four 16-bit data words."""
    blocks: tuple[int, int, int, int]

    def __str__(self):
        return ("RDSFrame<" + ", ".join(f"0x{b:04x}" for b in self.blocks)
                + ">")

    def to_json(self):
        import json
        return json.dumps({"blocks": list(self.blocks)})


RDSFrameType = ObjectSampleType("RDSFrame", RDSFrame)


class RDSFramerBlock(HostBlock):
    """Bit stream -> validated 104-bit RDS groups with (26,16) syndrome
    decode and 1-bit correction (reference: rdsframer.lua:105-201)."""

    variable_output = True
    RDSFrameType = RDSFrameType

    def __init__(self):
        super().__init__()
        self._buf = np.zeros(0, dtype=np.uint8)
        self._synchronized = False
        self.add_type_signature([Input("in", Bit)],
                                [Output("out", RDSFrameType)])

    def _try_frame(self, window: np.ndarray) -> RDSFrame | None:
        data = []
        for blk in range(4):
            bits = bits_to_number(window, blk * RDS_BLOCK_LEN, RDS_BLOCK_LEN)
            if blk == 2:
                c = (correct_block(bits, RDS_OFFSET_WORDS["C"])
                     or correct_block(bits, RDS_OFFSET_WORDS["Cp"]))
            else:
                c = correct_block(bits, RDS_OFFSET_WORDS["ABCD"[blk]])
            if c is None:
                return None
            data.append(c >> 10)
        return RDSFrame(tuple(data))

    def process(self, x):
        buf = np.concatenate([self._buf, np.asarray(x, dtype=np.uint8)])
        out = []
        pos = 0
        while pos + RDS_FRAME_LEN <= len(buf):
            frame = self._try_frame(buf[pos:pos + RDS_FRAME_LEN])
            if frame is not None:
                out.append(frame)
                self._synchronized = True
                pos += RDS_FRAME_LEN
            else:
                self._synchronized = False
                pos += 1
        self._buf = buf[pos:]
        return out


class RDSPacket:
    """Decoded RDS packet: header + typed payload dict."""

    def __init__(self, header: dict, data: dict):
        self.header = header
        self.data = data

    def __eq__(self, other):
        return (isinstance(other, RDSPacket) and self.header == other.header
                and self.data == other.data)

    def __str__(self):
        import json
        return (f"RDSPacket<pi_code=0x{self.header['pi_code']:04x}, "
                f"group_code={self.header['group_code']}, "
                f"group_version={self.header['group_version']}, "
                f"payload={json.dumps(self.data)}>")

    def to_json(self):
        import json
        return json.dumps({"header": self.header, "data": self.data})


RDSPacketType = ObjectSampleType("RDSPacket", RDSPacket)


def _decode_header(frame: RDSFrame) -> dict:
    b1 = frame.blocks[1]
    return {
        "pi_code": frame.blocks[0],
        "group_code": b1 >> 12,
        "group_version": (b1 >> 11) & 0x1,
        "tp_code": (b1 >> 10) & 0x1,
        "pty_code": (b1 >> 5) & 0x1F,
    }


def _decode_basic_tuning(header: dict, frame: RDSFrame) -> dict:
    b1, b2, b3 = frame.blocks[1], frame.blocks[2], frame.blocks[3]
    text_address = b1 & 0x3
    return {
        "type": "basictuning",
        "ta_code": (b1 >> 4) & 0x1,
        "ms_code": (b1 >> 3) & 0x1,
        "di_position": 3 - text_address,
        "di_value": (b1 >> 2) & 0x1,
        "af_code": ([b2 >> 8, b2 & 0xFF] if header["group_version"] == 0
                    else None),
        "text_address": text_address,
        "text_data": chr(b3 >> 8) + chr(b3 & 0xFF),
    }


def _decode_radiotext(header: dict, frame: RDSFrame) -> dict:
    b1, b2, b3 = frame.blocks[1], frame.blocks[2], frame.blocks[3]
    if header["group_version"] == 0:
        text = (chr(b2 >> 8) + chr(b2 & 0xFF) + chr(b3 >> 8) + chr(b3 & 0xFF))
    else:
        text = chr(b3 >> 8) + chr(b3 & 0xFF)
    return {
        "type": "radiotext",
        "ab_flag": (b1 >> 4) & 0x1,
        "text_address": b1 & 0x0F,
        "text_data": text,
    }


def _decode_datetime(header: dict, frame: RDSFrame) -> dict:
    b1, b2, b3 = frame.blocks[1], frame.blocks[2], frame.blocks[3]
    mjd = ((b1 & 0x3) << 15) | ((b2 & 0xFFFE) >> 1)
    hour = ((b2 & 0x1) << 4) | ((b3 & 0xF000) >> 12)
    minute = (b3 >> 6) & 0x3F
    offset = b3 & 0x3F
    offset = (-(offset & 0x1F) if offset & 0x20 else (offset & 0x1F)) * 0.5
    # MJD -> calendar date (RDS Standard Annex G)
    yp = int((mjd - 15078.2) / 365.25)
    mp = int((mjd - 14956.1 - int(yp * 365.25)) / 30.6001)
    k = 1 if mp in (14, 15) else 0
    day = mjd - 14956 - int(yp * 365.25) - int(mp * 30.6001)
    month = mp - 1 - k * 12
    year = yp + k + 1900
    return {
        "type": "datetime",
        "date": {"year": year, "month": month, "day": day},
        "time": {"hour": hour, "minute": minute, "offset": offset},
    }


class RDSDecoderBlock(HostBlock):
    """RDS frames -> decoded packets: basic tuning (group 0), radiotext
    (group 2), datetime (group 4A), raw otherwise
    (reference: rdsdecoder.lua)."""

    variable_output = True
    RDSPacketType = RDSPacketType

    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("in", RDSFrameType)],
                                [Output("out", RDSPacketType)])

    def process(self, frames):
        out = []
        for frame in frames:
            header = _decode_header(frame)
            gc, gv = header["group_code"], header["group_version"]
            if gc == 0:
                data = _decode_basic_tuning(header, frame)
            elif gc == 2:
                data = _decode_radiotext(header, frame)
            elif gc == 4 and gv == 0:
                data = _decode_datetime(header, frame)
            else:
                data = {"type": "raw", "frame": list(frame.blocks)}
            out.append(RDSPacket(header, data))
        return out


__all__ = ["RDSFramerBlock", "RDSDecoderBlock", "RDSFrame", "RDSPacket",
           "RDSFrameType", "RDSPacketType", "correct_block"]
