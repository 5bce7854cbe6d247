"""PSK31 varicode decoder.

Copied from the JAX package (numpy only).  Reference: radio/blocks/protocol/
varicodedecoder.lua.  The table below is the standard PSK31 varicode
alphabet (indexed by ASCII code); codes are self-delimiting by the "00"
inter-character gap and never contain "00" internally.
"""

from __future__ import annotations

import numpy as np

from luaradio_tpu_torch.core.block import HostBlock, Input, Output
from luaradio_tpu_torch.types import Bit, Byte

VARICODE = [  # index = ASCII code, value = varicode bit pattern
    "1010101011", "1011011011", "1011101101", "1101110111",
    "1011101011", "1101011111", "1011101111", "1011111101",
    "1011111111", "11101111", "11101", "1101101111",
    "1011011101", "11111", "1101110101", "1110101011",
    "1011110111", "1011110101", "1110101101", "1110101111",
    "1101011011", "1101101011", "1101101101", "1101010111",
    "1101111011", "1101111101", "1110110111", "1101010101",
    "1101011101", "1110111011", "1011111011", "1101111111",
    "1", "111111111", "101011111", "111110101",
    "111011011", "1011010101", "1010111011", "101111111",
    "11111011", "11110111", "101101111", "111011111",
    "1110101", "110101", "1010111", "110101111",
    "10110111", "10111101", "11101101", "11111111",
    "101110111", "101011011", "101101011", "110101101",
    "110101011", "110110111", "11110101", "110111101",
    "111101101", "1010101", "111010111", "1010101111",
    "1010111101", "1111101", "11101011", "10101101",
    "10110101", "1110111", "11011011", "11111101",
    "101010101", "1111111", "111111101", "101111101",
    "11010111", "10111011", "11011101", "10101011",
    "11010101", "111011101", "10101111", "1101111",
    "1101101", "101010111", "110110101", "101011101",
    "101110101", "101111011", "1010101101", "111110111",
    "111101111", "111111011", "1010111111", "101101101",
    "1011011111", "1011", "1011111", "101111",
    "101101", "11", "111101", "1011011",
    "101011", "1101", "111101011", "10111111",
    "11011", "111011", "1111", "111",
    "111111", "110111111", "10101", "10111",
    "101", "110111", "1111011", "1101011",
    "11011111", "1011101", "111010101", "1010110111",
    "110111011", "1010110101", "1011010111", "1110110101",
]

_DECODE = {code: ascii_code for ascii_code, code in enumerate(VARICODE)}


class VaricodeDecoderBlock(HostBlock):
    """Bit stream -> Bytes: split on the "00" inter-character gap, look up
    each code (reference: varicodedecoder.lua; >10-bit runs are discarded)."""

    variable_output = True

    def __init__(self):
        super().__init__()
        self._bits: list[int] = []
        self.add_type_signature([Input("in", Bit)], [Output("out", Byte)])

    def process(self, x):
        out = []
        for b in np.asarray(x, dtype=np.uint8):
            self._bits.append(int(b))
            if len(self._bits) >= 2:
                if self._bits[-2] == 0 and self._bits[-1] == 0:
                    # strip a possible leading 0 from the previous gap
                    bits = self._bits[:-2]
                    if bits and bits[0] == 0:
                        bits = bits[1:]
                    code = "".join(map(str, bits))
                    if code in _DECODE:
                        out.append(_DECODE[code])
                    self._bits = []
                elif len(self._bits) > 10:
                    self._bits = []
        return np.asarray(out, dtype=np.uint8)


__all__ = ["VaricodeDecoderBlock", "VARICODE"]
