"""POCSAG framer and decoder.

Copied from the JAX package (numpy only).  Reference: radio/blocks/protocol/
{pocsagframer,pocsagdecoder}.lua.  The BCH(31,21) syndrome tables are derived
from the POCSAG generator polynomial g(x) = x^10 + x^9 + x^8 + x^6 + x^5 +
x^3 + 1 plus the even-parity bit (ITU-R M.584), not hard-coded.
"""

from __future__ import annotations

import numpy as np

from luaradio_tpu_torch.core.block import HostBlock, Input, Output
from luaradio_tpu_torch.types import Bit, ObjectSampleType, bits_to_number

POCSAG_BATCH_LENGTH = 544
POCSAG_CODEWORD_LENGTH = 32
POCSAG_IDLE_CODEWORD = 0x7A89C197
POCSAG_FRAME_SYNC_CODEWORD = 0x7CD215D8

#: g(x) of the BCH(31,21) code: x^10+x^9+x^8+x^6+x^5+x^3+1.
_BCH_POLY = 0b11101101001


def _bch_mod(value: int, nbits: int) -> int:
    for i in range(nbits - 1, 9, -1):
        if value & (1 << i):
            value ^= _BCH_POLY << (i - 10)
    return value


# Codeword layout: bits 31..11 = 21 message bits, 10..1 = BCH check bits,
# bit 0 = even parity.  The 11-bit syndrome of a single-bit error is the BCH
# remainder (shifted up one) with an LSB tracking the parity of the full
# error pattern: the flipped bit itself plus its induced check bits, i.e.
# (1 + popcount(remainder)) mod 2.
def _codeword_syndrome_table():
    table = []
    for i in range(32):
        if i == 0:
            s = 1  # parity bit only
        else:
            b = _bch_mod(1 << (i - 1), 31)
            s = (b << 1) | ((1 + bin(b).count("1")) & 1)
        table.append(s)
    return table


_SYNDROMES = _codeword_syndrome_table()
_CORRECT = {s: (1 << i) for i, s in enumerate(_SYNDROMES)}


def correct_codeword(codeword: int) -> int | None:
    """Validate/correct a 32-bit POCSAG codeword.  Returns corrected word or
    None if uncorrectable (1-bit correction, like the reference)."""
    s = 0
    w = codeword
    i = 0
    while w:
        if w & 1:
            s ^= _SYNDROMES[i]
        w >>= 1
        i += 1
    if s == 0:
        return codeword
    if s in _CORRECT:
        return codeword ^ _CORRECT[s]
    return None


class POCSAGFrame:
    """address + function bits + raw 20-bit data words."""

    def __init__(self, address: int | None = None, func: int | None = None,
                 data: list | None = None):
        self.address = address
        self.func = func
        self.data = data if data is not None else []

    def __eq__(self, other):
        return (isinstance(other, POCSAGFrame) and self.address == other.address
                and self.func == other.func and self.data == other.data)

    def __str__(self):
        words = ", ".join(f"0x{w:05x}" for w in self.data)
        return (f"POCSAGFrame<address=0x{self.address:05x}, "
                f"func={self.func}, data=[{words}]>")

    def to_json(self):
        import json
        return json.dumps({"address": self.address, "func": self.func,
                           "data": self.data})


POCSAGFrameType = ObjectSampleType("POCSAGFrame", POCSAGFrame)

_FRAME_SYNC_BITS = np.array(
    [(POCSAG_FRAME_SYNC_CODEWORD >> (31 - i)) & 1 for i in range(32)],
    dtype=np.int8)


class POCSAGFramerBlock(HostBlock):
    """Bit stream -> POCSAG frames: frame-sync correlation (>=28/32), batch
    codeword correction, address/data assembly
    (reference: pocsagframer.lua:96-195)."""

    variable_output = True
    POCSAGFrameType = POCSAGFrameType

    def __init__(self):
        super().__init__()
        self._buf = np.zeros(0, dtype=np.uint8)
        self._state = "sync"
        self._frame: POCSAGFrame | None = None
        self.add_type_signature([Input("in", Bit)],
                                [Output("out", POCSAGFrameType)])

    def _find_sync(self, buf: np.ndarray) -> int | None:
        """First offset whose 32-bit window correlates >= 28/32 with the
        frame sync codeword (vectorized over all offsets)."""
        n = len(buf) - 32 + 1
        if n <= 0:
            return None
        windows = np.lib.stride_tricks.sliding_window_view(
            buf.astype(np.int8) * 2 - 1, 32)
        corr = windows @ (_FRAME_SYNC_BITS * 2 - 1)
        hits = np.flatnonzero(corr >= 28)
        return int(hits[0]) if len(hits) else None

    def process(self, x):
        buf = np.concatenate([self._buf, np.asarray(x, dtype=np.uint8)])
        out = []
        pos = 0
        while True:
            if self._state == "sync":
                idx = self._find_sync(buf[pos:])
                if idx is None:
                    pos = max(pos, len(buf) - 31)
                    break
                pos += idx
                self._state = "batch"
            else:  # batch: need sync codeword + 16 codewords
                if len(buf) - pos < POCSAG_BATCH_LENGTH:
                    break
                cw = bits_to_number(buf, pos, 32)
                fs = correct_codeword(cw)
                if fs is None or fs != POCSAG_FRAME_SYNC_CODEWORD:
                    if self._frame:
                        out.append(self._frame)
                        self._frame = None
                    pos += POCSAG_CODEWORD_LENGTH
                    self._state = "sync"
                    continue
                invalid_run = 0
                clock_slipped = False
                for j in range(1, 17):
                    cw = correct_codeword(bits_to_number(buf, pos + j * 32, 32))
                    invalid_run = invalid_run + 1 if cw is None else 0
                    if cw is None:
                        if self._frame:
                            out.append(self._frame)
                            self._frame = None
                        if invalid_run == 2:
                            pos += (j + 1) * 32
                            self._state = "sync"
                            clock_slipped = True
                            break
                    elif cw == POCSAG_IDLE_CODEWORD:
                        if self._frame:
                            out.append(self._frame)
                            self._frame = None
                    elif (cw & 0x80000000) == 0:
                        # address codeword: 18-bit address + 3-bit batch pos
                        if self._frame:
                            out.append(self._frame)
                        self._frame = POCSAGFrame(
                            address=((cw >> 10) & 0x1FFFF8) | ((j - 1) >> 1),
                            func=(cw >> 11) & 0x3)
                    elif self._frame is not None:
                        self._frame.data.append((cw >> 11) & 0xFFFFF)
                if not clock_slipped:
                    pos += POCSAG_BATCH_LENGTH
        self._buf = buf[pos:]
        return out


_BCD = "0123456789RU -()"


class POCSAGMessage:
    def __init__(self, address, func, alphanumeric=None, numeric=None):
        self.address = address
        self.func = func
        self.alphanumeric = alphanumeric
        self.numeric = numeric

    def __eq__(self, other):
        return (isinstance(other, POCSAGMessage)
                and self.address == other.address and self.func == other.func
                and self.alphanumeric == other.alphanumeric
                and self.numeric == other.numeric)

    def __str__(self):
        parts = []
        if self.alphanumeric is not None:
            parts.append(f'alphanumeric="{self.alphanumeric}"')
        if self.numeric is not None:
            parts.append(f'numeric="{self.numeric}"')
        return (f"POCSAGMessage<address=0x{self.address:06x}, "
                f"function={self.func}, {', '.join(parts)}>")

    def to_json(self):
        import json
        return json.dumps({"address": self.address, "func": self.func,
                           "alphanumeric": self.alphanumeric,
                           "numeric": self.numeric})


POCSAGMessageType = ObjectSampleType("POCSAGMessage", POCSAGMessage)


def _decode_alphanumeric(data: list[int]) -> str | None:
    """20-bit words -> 7-bit chars, LSB-first per char, 0x17 (ETB) ends
    (reference: pocsagdecoder.lua)."""
    if not data:
        return None
    text = []
    char = count = 0
    for word in data:
        for i in range(19, -1, -1):
            char |= ((word >> i) & 1) << count
            count += 1
            if count == 7:
                if char == 0x17:
                    return "".join(text)
                text.append(chr(char))
                char = count = 0
    return "".join(text)


def _decode_numeric(data: list[int]) -> str | None:
    if not data:
        return None
    return "".join(_BCD[(word >> (4 * i)) & 0xF]
                   for word in data for i in range(4, -1, -1))


class POCSAGDecoderBlock(HostBlock):
    """POCSAG frames -> alphanumeric/numeric messages
    (reference: pocsagdecoder.lua)."""

    variable_output = True
    POCSAGMessageType = POCSAGMessageType

    def __init__(self, mode: str = "alphanumeric"):
        super().__init__()
        if mode not in ("alphanumeric", "numeric", "both"):
            raise ValueError(f"invalid mode {mode!r}")
        self.mode = mode
        self.add_type_signature([Input("in", POCSAGFrameType)],
                                [Output("out", POCSAGMessageType)])

    def process(self, frames):
        out = []
        for f in frames:
            alnum = (_decode_alphanumeric(f.data)
                     if self.mode in ("alphanumeric", "both") else None)
            num = (_decode_numeric(f.data)
                   if self.mode in ("numeric", "both") else None)
            out.append(POCSAGMessage(f.address, f.func, alnum, num))
        return out


__all__ = ["POCSAGFramerBlock", "POCSAGDecoderBlock", "POCSAGFrame",
           "POCSAGMessage", "POCSAGFrameType", "POCSAGMessageType",
           "correct_codeword"]
