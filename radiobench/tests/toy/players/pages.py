"""Kind ``pages``: ``rows`` captures, each a pager channel of its own
(seeded by radiobench/synth.py ``row_seed``), replayed in loops through
one ``BankSource`` of ``IQFileSource``s (a closed loop;
``run(channels=rows)``).

A capture is a train of POCSAG transmissions (ITU-R M.584) at the
configuration's ``baudrate``, 2-FSK at +-``deviation_hz`` (a 1 bit at
-deviation, the mark, as rx_pocsag expects): each a 576-bit preamble, the
frame sync codeword and one batch of 16 codewords that carries one
alphanumeric page (its address codeword in the frame its address's low
three bits name, frames 0-3, its text's data codewords after it, idle
codewords to the batch's end), then two fill bits that bring the
transmission's ones less zeros to a multiple of four, so the FSK phase
makes whole cycles over it and the looped capture is one seamless stream.
Every transmission is 1122 bits, so every seed makes the same number of
transmissions of the same length; the seed chooses each page's address,
function and text (``text_chars`` printable ASCII characters).  The
codewords come from the small BCH(31,21) encoder below.  Complex Gaussian
noise (``noise_sigma``) is added, and ``synth.quantize`` puts the capture
on the wire.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from radiobench import synth
from radiobench.drive import Capture

SYNC = 0x7CD215D8
IDLE = 0x7A89C197
PREAMBLE_BITS = 576
TRANSMISSION_BITS = PREAMBLE_BITS + 32 + 16 * 32 + 2
_BCH_POLY = 0b11101101001       # x^10 + x^9 + x^8 + x^6 + x^5 + x^3 + 1


def codeword(msg21: int) -> int:
    """The 21 message bits, their BCH(31,21) check bits and even parity."""
    rem = msg21 << 10
    for i in range(30, 9, -1):
        if rem & (1 << i):
            rem ^= _BCH_POLY << (i - 10)
    w31 = (msg21 << 10) | rem
    return (w31 << 1) | (bin(w31).count("1") & 1)


def _bits(value: int, n: int = 32) -> list:
    return [(value >> (n - 1 - i)) & 1 for i in range(n)]


def text_words(text: str) -> list:
    """The text and its ETB as 7-bit characters, each least significant
    bit first, in 20-bit words filled with ones."""
    bits = []
    for ch in text + chr(0x17):
        bits += [(ord(ch) >> i) & 1 for i in range(7)]
    bits += [1] * (-len(bits) % 20)
    return [int("".join(map(str, bits[i:i + 20])), 2)
            for i in range(0, len(bits), 20)]


def transmission(rng: np.random.Generator, sig: dict) -> list:
    """One transmission's bits."""
    frame = int(rng.integers(0, 4))
    address = (int(rng.integers(0, 1 << 18)) << 3) | frame
    func = int(rng.integers(0, 4))
    lo, hi = sig["text_chars"]
    text = "".join(map(chr, rng.integers(0x20, 0x7F, int(
        rng.integers(lo, hi + 1)))))
    batch = [IDLE] * 16
    batch[2 * frame] = codeword(((address >> 3) << 2) | func)
    for i, w in enumerate(text_words(text)):
        batch[2 * frame + 1 + i] = codeword((1 << 20) | w)
    bits = [1, 0] * (PREAMBLE_BITS // 2) + _bits(SYNC)
    for cw in batch:
        bits += _bits(cw)
    bits += [1, 0] if (2 * sum(bits) - len(bits)) % 4 == 0 else [1, 1]
    return bits


def samples_per_bit(cfg: dict) -> int:
    return int(round(cfg["rate"] / cfg["baudrate"]))


class Player(Capture):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, tmpdir):
        self.cfg, self.mix = cfg, mix
        self.rows = int(mix["rows"])
        sps = samples_per_bit(cfg)
        n_tx = max(1, round(mix["capture_samples"]
                            / (TRANSMISSION_BITS * sps)))
        self.length = n_tx * TRANSMISSION_BITS * sps
        sig = mix["signal"]
        step = 2 * np.pi * cfg["deviation_hz"] / cfg["rate"]
        self.wire, self.paths = [], []
        for r in range(self.rows):
            rng = np.random.default_rng(synth.row_seed(seed, r))
            bits = sum((transmission(rng, sig) for _ in range(n_tx)), [])
            sign = torch.tensor(bits, device=device).repeat_interleave(sps)
            # the FSK phase from whole steps: exact, and closed at the wrap
            turns = torch.cumsum(1 - 2 * sign.to(torch.int64), 0)
            iq = sig["amplitude"] * torch.polar(
                torch.ones(self.length, dtype=torch.float64, device=device),
                step * turns.to(torch.float64))
            gen = torch.Generator(device=device)
            gen.manual_seed(synth.row_seed(seed, self.rows + r))
            noise = torch.randn((self.length, 2), generator=gen,
                                dtype=torch.float64, device=device)
            iq = iq + torch.view_as_complex(noise * sig["noise_sigma"])
            self.wire.append(synth.quantize(iq, cfg["wire"]).cpu().numpy())
            self.paths.append(os.path.join(tmpdir,
                                           f"capture{r}.{cfg['wire']}"))
            self.wire[-1].tofile(self.paths[-1])


__all__ = ["Player", "codeword", "text_words", "transmission",
           "samples_per_bit", "SYNC", "IDLE", "TRANSMISSION_BITS"]
