"""Signal generator source: the reference's radio/blocks/sources/signal.lua.
A device source: each chunk is generated on the card from a wrapped phase
kept as state, so the source costs one elementwise pass."""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.core.block import Output, SignalSourceBlock
from luaradio_tpu_torch.ops.mixer import FracRamp, PhasorRamp
from luaradio_tpu_torch.types import ComplexFloat32, Float32


class SignalSource(SignalSourceBlock):
    """Waveform generator: exponential (complex), cosine, sine, square,
    triangle, sawtooth, constant (reference: signal.lua:40-215).

    Waveforms are computed from a wrapped-phase position ramp built from
    float64 host tables (ops/mixer.py), so phase accuracy holds over
    unbounded streams; the carried state is one wrapped scalar.
    """

    WAVEFORMS = ("exponential", "cosine", "sine", "square", "triangle",
                 "sawtooth", "constant")

    def __init__(self, signal: str, frequency: float, rate: float,
                 amplitude: float = 1.0, offset: float = 0.0,
                 phase: float = 0.0):
        super().__init__()
        if signal not in self.WAVEFORMS:
            raise ValueError(f"unsupported signal {signal!r}")
        self.signal = signal
        self.frequency = float(frequency)
        self.rate = float(rate)
        self.amplitude = np.float32(amplitude)
        self.offset = np.float32(offset)
        self.phase = float(phase)
        out_t = ComplexFloat32 if signal == "exponential" else Float32
        self.add_type_signature([], [Output("out", out_t)])

    def initialize(self):
        omega = 2 * np.pi * self.frequency / self.rate
        if self.signal == "exponential":
            self._ramp = PhasorRamp(omega, self.device)
        elif self.signal != "constant":
            self._ramp = FracRamp(omega, self.device)

    def init_state(self):
        if self.signal == "exponential":
            v = self.phase
        elif self.signal == "constant":
            return None
        else:
            v = (self.phase / (2 * np.pi)) % 1.0
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def generate(self, state, length: int):
        a, off = float(self.amplitude), float(self.offset)
        if self.signal == "constant":
            return state, torch.full((length,), a, dtype=torch.float32,
                                     device=self.device)
        if self.signal == "exponential":
            p, state = self._ramp.phasor(length, state)
            return state, p * a
        pos, state = self._ramp.positions(length, state)
        two_pi = float(np.float32(2 * np.pi))
        if self.signal == "cosine":
            y = torch.cos(pos * two_pi) * a + off
        elif self.signal == "sine":
            y = torch.sin(pos * two_pi) * a + off
        elif self.signal == "square":
            y = torch.where(pos < 0.5, a, -a) + off
        elif self.signal == "triangle":
            # 1 - (2/pi)*phi on [0, pi); -1 + (2/pi)*(phi-pi) on [pi, 2pi)
            y = torch.where(pos < 0.5, 1.0 - 4.0 * pos,
                            4.0 * pos - 3.0) * a + off
        else:  # sawtooth: -1 + (1/pi)*phi
            y = (2.0 * pos - 1.0) * a + off
        return state, y


__all__ = ["SignalSource"]
