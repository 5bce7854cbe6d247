"""The reference of configuration ``pocsag_toy`` (a test's own).

For this toy, what was sent stands in for the decoder: ``messages`` reads
back the bits the generator (players/pages.py) put on each row's capture,
which carries so little noise that the sign of the FSK's phase step over
each bit's middle half gives every bit as sent, finds each frame sync
codeword, and reads the pages of the batch after it as the POCSAG framer
and alphanumeric decoder define them.  A real configuration's reference
decodes its captures with a plain float64 receiver instead.

``soft`` is the receiver's front end as pocsagreceiver.lua defines it,
in plain float64 (radiobench/reference/dsp.py): the mark and space
bandpasses, their magnitudes' difference and the data filter, the signal
the clock recovery and sampler read.  It imports nothing of the program.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from radiobench.reference import dsp

SYNC = 0x7CD215D8
IDLE = 0x7A89C197


def _bits(raw_row: np.ndarray, sps: int) -> np.ndarray:
    """A row's u8 wire items -> its bits (a 1 where the phase steps down,
    the mark)."""
    v = raw_row.astype(np.float64) - 127.5
    x = v[0::2] + 1j * v[1::2]
    step = np.angle(x[1:] * np.conj(x[:-1]))
    step = np.concatenate([step[:1], step])     # step into each sample
    mid = step.reshape(-1, sps)[:, sps // 4:sps - sps // 4].mean(-1)
    return (mid < 0).astype(np.int64)


def _word(bits: np.ndarray, at: int) -> int:
    return int("".join(map(str, bits[at:at + 32])), 2)


def _alphanumeric(data: list) -> str:
    text, char, count = [], 0, 0
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


def _pages(bits: np.ndarray, sps: int) -> list:
    """(at, text) of every page in one period of a row's bits."""
    sync = np.array([(SYNC >> (31 - i)) & 1 for i in range(32)])
    win = np.lib.stride_tricks.sliding_window_view(bits, 32)
    out = []
    for s in np.flatnonzero((win == sync).all(-1)):
        page = None
        for j in range(1, 17):
            at = int(s) + 32 * j
            if at + 32 > len(bits):
                break
            cw = _word(bits, at)
            if cw == IDLE or not cw & 0x80000000:
                if page is not None:
                    out.append(page)
                    page = None
                if cw != IDLE:
                    page = [((cw >> 10) & 0x1FFFF8) | ((j - 1) >> 1),
                            (cw >> 11) & 0x3, [], at + 32]
            elif page is not None:
                page[2].append((cw >> 11) & 0xFFFFF)
                page[3] = at + 32
        if page is not None:
            out.append(page)
    return [(end * sps - 1, json.dumps(
        {"address": a, "func": f, "alphanumeric": _alphanumeric(d) if d
         else None, "numeric": None})) for a, f, d, end in out]


def messages(raw, cfg: dict, precision: str = "float64",
             periods: int = 2) -> list:
    """A list a row of (at, text): each page's last bit's input sample in
    the looped stream, and its JSON as the program's POCSAGMessage prints
    it, over ``periods`` loops of the capture.  The bits are read back
    exactly, so ``precision`` changes nothing here."""
    raw = np.asarray(raw.cpu() if hasattr(raw, "cpu") else raw)
    sps = int(round(cfg["rate"] / cfg["baudrate"]))
    n = raw.shape[-1] // 2
    out = []
    for row in raw:
        once = _pages(_bits(row, sps), sps)
        out.append([(at + p * n, t) for p in range(periods)
                    for at, t in once])
    return out


def soft(raw, cfg: dict, precision: str = "float64",
         periods: int = 2) -> torch.Tensor:
    """[rows, 1, periods n]: the data filter's output over ``periods``
    loops of each capture from zero state, |mark| - |space| through a
    128-tap lowpass at the baud rate; ``"tf32"`` one precision down, for
    the control."""
    x = dsp.wire_to_complex(torch.as_tensor(raw).repeat(1, periods),
                            cfg["wire"], precision)
    nyq = cfg["rate"] / 2.0
    mark = dsp.fir(x, dsp.complex_bandpass_taps(129, -5500 / nyq,
                                                -3500 / nyq), precision)
    space = dsp.fir(x, dsp.complex_bandpass_taps(129, 3500 / nyq,
                                                 5500 / nyq), precision)
    y = dsp.fir(mark.abs() - space.abs(),
                dsp.lowpass_taps(128, cfg["baudrate"] / nyq), precision)
    return y[:, None, :]


def plan(cfg: dict) -> dict:
    """``lag``: a page is emitted once its batch has ended (at most 15
    codewords after its last bit) and the receiver's filters (two 129-tap
    bandpasses, a 128-tap lowpass) and clock recovery have passed it on:
    a batch's 512 bits and 16 bits more, at the configuration's samples a
    bit, and the filters' 257 samples.  ``soft_ds``: input samples a soft
    sample (the data filter runs at the input rate)."""
    sps = int(round(cfg["rate"] / cfg["baudrate"]))
    return {"lag": (512 + 16) * sps + 257, "soft_ds": 1}


def work(cfg: dict) -> dict:
    """Floating-point operations and bytes a complex input sample: two
    complex 129-tap bandpasses on a complex input (8 operations a tap),
    two magnitudes and a difference (~10), a real 128-tap lowpass (2 a
    tap); the complex64 sample read once."""
    return {"flops": 2 * 129 * 8.0 + 10.0 + 2 * 128.0, "bytes": 8.0}


__all__ = ["messages", "soft", "plan", "work"]
