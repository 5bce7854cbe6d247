"""ERT (Encoder-Receiver-Transmitter) utility-meter framers: SCM, SCM+, IDM.

Copied from the JAX package (numpy only).  Reference: radio/blocks/protocol/
{scmframer,scmplusframer,idmframer}.lua.  Syndrome tables are derived from
the codes' generator polynomials / CRCs rather than hard-coded:

* SCM uses the BCH(255,239) generator g(x) = x^16 + x^14 + x^13 + x^11 +
  x^10 + x^9 + x^8 + x^6 + x^5 + x + 1 (0x16F63), shortened to (75,59).
* SCM+ and IDM use CRC-16-CCITT (poly 0x1021, init 0xFFFF, final xor
  0xFFFF), whose affine constant shows up as a nonzero initial syndrome.
"""

from __future__ import annotations

import numpy as np

from luaradio_tpu_torch.core.block import HostBlock, Input, Output
from luaradio_tpu_torch.types import Bit, ObjectSampleType, bits_to_bytes, bits_to_number


def _poly_mod(value: int, nbits: int, poly: int, degree: int) -> int:
    for i in range(nbits - 1, degree - 1, -1):
        if value & (1 << i):
            value ^= poly << (i - degree)
    return value


def _crc16_ccitt_bits(bits: np.ndarray) -> int:
    """MSB-first CRC-16-CCITT over a bit array, init 0xFFFF, final xor
    0xFFFF (reference idmframer.lua idm_compute_crc)."""
    crc = 0xFFFF
    for b in np.asarray(bits, dtype=np.uint8):
        fb = ((crc >> 15) ^ int(b)) & 1
        crc = ((crc << 1) & 0xFFFF) ^ (0x1021 if fb else 0)
    return crc ^ 0xFFFF


class _ShortenedCode:
    """Single-bit-correcting shortened cyclic/CRC code over a codeword of
    msg_len message bits + 16 check bits."""

    def __init__(self, msg_len: int, *, bch_poly: int | None = None,
                 crc_ccitt: bool = False):
        self.msg_len = msg_len
        self.n = msg_len + 16
        syn = []
        if bch_poly is not None:
            self.init_syndrome = 0
            for i in range(msg_len):
                syn.append(_poly_mod(1 << (self.n - 1 - i), self.n,
                                     bch_poly, 16))
        else:
            assert crc_ccitt
            # CRC is affine: crc(x) = L(x) ^ c.  Unit-vector syndromes are
            # the linear part; the constant c (crc of the zero message)
            # becomes the initial syndrome.
            zeros = np.zeros(msg_len, dtype=np.uint8)
            self.init_syndrome = _crc16_ccitt_bits(zeros)
            for i in range(msg_len):
                zeros[i] = 1
                syn.append(_crc16_ccitt_bits(zeros) ^ self.init_syndrome)
                zeros[i] = 0
        for i in range(16):
            syn.append(1 << (15 - i))
        self.syndromes = syn
        self.correct_map = {s: i for i, s in enumerate(syn)}

    def correct(self, bits: np.ndarray, offset: int) -> bool:
        """Validate/correct the codeword at bits[offset:offset+n] in place.
        Returns True if valid (after at most one correction)."""
        s = self.init_syndrome
        window = bits[offset:offset + self.n]
        for i in np.flatnonzero(window):
            s ^= self.syndromes[int(i)]
        if s == 0:
            return True
        idx = self.correct_map.get(s)
        if idx is not None:
            bits[offset + idx] ^= 1
            return True
        return False


_SCM_BCH_POLY = 0x16F63
_scm_code = _ShortenedCode(59, bch_poly=_SCM_BCH_POLY)
_scm_plus_code = _ShortenedCode(96, crc_ccitt=True)
_idm_code = _ShortenedCode(688, crc_ccitt=True)


# ---------------------------------------------------------------------------
# SCM
# ---------------------------------------------------------------------------

SCM_PREAMBLE = np.array([1, 1, 1, 1, 1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 1, 1,
                         0, 0, 0, 0, 0], dtype=np.uint8)
SCM_FRAME_LEN = 96


class SCMFrame:
    def __init__(self, ert_type, ert_id, consumption, physical_tamper,
                 encoder_tamper, reserved, crc):
        self.type = "scm"
        self.ert_type = ert_type
        self.ert_id = ert_id
        self.consumption = consumption
        self.physical_tamper = physical_tamper
        self.encoder_tamper = encoder_tamper
        self.reserved = reserved
        self.crc = crc

    def __eq__(self, other):
        return isinstance(other, SCMFrame) and vars(self) == vars(other)

    def __str__(self):
        return (f"SCMFrame<ert_type={self.ert_type}, ert_id={self.ert_id}, "
                f"consumption={self.consumption}, crc=0x{self.crc:04x}>")

    def to_json(self):
        import json
        return json.dumps(vars(self))


SCMFrameType = ObjectSampleType("SCMFrame", SCMFrame)


class _SlidingFramer(HostBlock):
    """Common sliding-bit-window framer scaffold: keep a buffer, try to
    validate a frame at every bit offset, consume the frame on success."""

    variable_output = True
    FRAME_LEN = 0

    def __init__(self):
        super().__init__()
        self._buf = np.zeros(0, dtype=np.uint8)
        self.add_type_signature([Input("in", Bit)],
                                [Output("out", self.frame_type)])

    def _try_frame(self, window: np.ndarray):
        raise NotImplementedError

    def process(self, x):
        buf = np.concatenate([self._buf, np.asarray(x, dtype=np.uint8)])
        out = []
        pos = 0
        while pos + self.FRAME_LEN <= len(buf):
            frame = self._try_frame(buf[pos:pos + self.FRAME_LEN])
            if frame is not None:
                out.append(frame)
                pos += self.FRAME_LEN
            else:
                pos += 1
        self._buf = buf[pos:]
        return out


class SCMFramerBlock(_SlidingFramer):
    """Bit stream -> SCM frames: 21-bit preamble 0x1F2A60, (75,59) BCH
    validation with 1-bit correction (reference: scmframer.lua)."""

    frame_type = SCMFrameType
    SCMFrameType = SCMFrameType
    SCM_PREAMBLE = SCM_PREAMBLE
    SCM_FRAME_LEN = SCM_FRAME_LEN
    FRAME_LEN = SCM_FRAME_LEN

    def _try_frame(self, window):
        if bits_to_number(window, 0, 21) != 0x1F2A60:
            return None
        window = window.copy()
        if not _scm_code.correct(window, 21):
            return None
        ert_id_msb = bits_to_number(window, 21, 2)
        reserved = bits_to_number(window, 23, 1)
        physical_tamper = bits_to_number(window, 24, 2)
        ert_type = bits_to_number(window, 26, 4)
        encoder_tamper = bits_to_number(window, 30, 2)
        consumption = bits_to_number(window, 32, 24)
        ert_id_lsb = bits_to_number(window, 56, 24)
        crc = bits_to_number(window, 80, 16)
        return SCMFrame(ert_type, (ert_id_msb << 24) | ert_id_lsb,
                        consumption, physical_tamper, encoder_tamper,
                        reserved, crc)


# ---------------------------------------------------------------------------
# SCM+
# ---------------------------------------------------------------------------

SCM_PLUS_PREAMBLE = np.array([0, 0, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 0, 0, 1, 1],
                             dtype=np.uint8)
SCM_PLUS_FRAME_LEN = 128


class SCMPlusFrame:
    def __init__(self, protocol_id, ert_type, ert_id, consumption, tamper,
                 crc):
        self.type = "scm+"
        self.protocol_id = protocol_id
        self.ert_type = ert_type
        self.ert_id = ert_id
        self.consumption = consumption
        self.tamper = tamper
        self.crc = crc

    def __eq__(self, other):
        return isinstance(other, SCMPlusFrame) and vars(self) == vars(other)

    def __str__(self):
        return (f"SCMPlusFrame<protocol_id=0x{self.protocol_id:02x}, "
                f"ert_type=0x{self.ert_type:02x}, ert_id={self.ert_id}, "
                f"consumption={self.consumption}, crc=0x{self.crc:04x}>")

    def to_json(self):
        import json
        return json.dumps(vars(self))


SCMPlusFrameType = ObjectSampleType("SCMPlusFrame", SCMPlusFrame)


class SCMPlusFramerBlock(_SlidingFramer):
    """Bit stream -> SCM+ frames: frame sync 0x16A3, CRC-16-CCITT with 1-bit
    correction, protocol id 0x1E (reference: scmplusframer.lua)."""

    frame_type = SCMPlusFrameType
    SCMPlusFrameType = SCMPlusFrameType
    SCM_PLUS_PREAMBLE = SCM_PLUS_PREAMBLE
    SCM_PLUS_FRAME_LEN = SCM_PLUS_FRAME_LEN
    FRAME_LEN = SCM_PLUS_FRAME_LEN

    def _try_frame(self, window):
        if bits_to_number(window, 0, 16) != 0x16A3:
            return None
        window = window.copy()
        if not _scm_plus_code.correct(window, 16):
            return None
        protocol_id = bits_to_number(window, 16, 8)
        if protocol_id != 0x1E:
            return None
        return SCMPlusFrame(protocol_id,
                            bits_to_number(window, 24, 8),
                            bits_to_number(window, 32, 32),
                            bits_to_number(window, 64, 32),
                            bits_to_number(window, 96, 16),
                            bits_to_number(window, 112, 16))


# ---------------------------------------------------------------------------
# IDM
# ---------------------------------------------------------------------------

IDM_PREAMBLE = np.array([0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1,
                         0, 0, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 0, 0, 1, 1],
                        dtype=np.uint8)
IDM_FRAME_LEN = 736


class IDMFrame:
    def __init__(self, application_version, ert_type, ert_id,
                 consumption_interval_count, module_programming_state,
                 tamper_count, async_count, power_outage_flags,
                 last_consumption_count, differential_consumption_intervals,
                 transmit_time_offset, serial_crc, packet_crc):
        self.type = "idm"
        self.application_version = application_version
        self.ert_type = ert_type
        self.ert_id = ert_id
        self.consumption_interval_count = consumption_interval_count
        self.module_programming_state = module_programming_state
        self.tamper_count = tamper_count
        self.async_count = async_count
        self.power_outage_flags = power_outage_flags
        self.last_consumption_count = last_consumption_count
        self.differential_consumption_intervals = \
            differential_consumption_intervals
        self.transmit_time_offset = transmit_time_offset
        self.serial_crc = serial_crc
        self.packet_crc = packet_crc

    def __eq__(self, other):
        return isinstance(other, IDMFrame) and vars(self) == vars(other)

    def __str__(self):
        return (f"IDMFrame<ert_type=0x{self.ert_type:02x}, "
                f"ert_id={self.ert_id}, "
                f"last_consumption_count={self.last_consumption_count}>")

    def to_json(self):
        import json
        d = dict(vars(self))
        for k in ("tamper_count", "async_count", "power_outage_flags",
                  "differential_consumption_intervals"):
            d[k] = d[k].hex() if isinstance(d[k], bytes) else d[k]
        return json.dumps(d)


IDMFrameType = ObjectSampleType("IDMFrame", IDMFrame)


class IDMFramerBlock(_SlidingFramer):
    """Bit stream -> IDM frames: preamble 0x5555 + sync 0x16A3, CRC-16-CCITT
    over the 704-bit codeword with 1-bit correction, serial CRC check
    (reference: idmframer.lua)."""

    frame_type = IDMFrameType
    IDMFrameType = IDMFrameType
    IDM_PREAMBLE = IDM_PREAMBLE
    IDM_FRAME_LEN = IDM_FRAME_LEN
    FRAME_LEN = IDM_FRAME_LEN

    def _try_frame(self, window):
        if (bits_to_number(window, 0, 16) != 0x5555
                or bits_to_number(window, 16, 16) != 0x16A3):
            return None
        window = window.copy()
        if not _idm_code.correct(window, 32):
            return None
        packet_type = bits_to_number(window, 32, 8)
        packet_length = bits_to_number(window, 40, 16)
        serial_crc = bits_to_number(window, 704, 16)
        if (packet_type != 0x1C or packet_length != 0x5CC6
                or serial_crc != _crc16_ccitt_bits(window[72:72 + 32])):
            return None
        return IDMFrame(
            application_version=bits_to_number(window, 56, 8),
            ert_type=bits_to_number(window, 64, 8),
            ert_id=bits_to_number(window, 72, 32),
            consumption_interval_count=bits_to_number(window, 104, 8),
            module_programming_state=bits_to_number(window, 112, 8),
            tamper_count=bits_to_bytes(window[120:120 + 48]),
            async_count=bits_to_bytes(window[168:168 + 16]),
            power_outage_flags=bits_to_bytes(window[184:184 + 48]),
            last_consumption_count=bits_to_number(window, 232, 32),
            differential_consumption_intervals=bits_to_bytes(
                window[264:264 + 424]),
            transmit_time_offset=bits_to_number(window, 688, 16),
            serial_crc=serial_crc,
            packet_crc=bits_to_number(window, 720, 16))


__all__ = ["SCMFramerBlock", "SCMPlusFramerBlock", "IDMFramerBlock",
           "SCMFrame", "SCMPlusFrame", "IDMFrame",
           "SCMFrameType", "SCMPlusFrameType", "IDMFrameType"]
