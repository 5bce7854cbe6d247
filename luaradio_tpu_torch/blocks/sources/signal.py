"""Device sources: zero, signal generator, uniform random (the reference's
radio/blocks/sources/{zero,signal,uniformrandom}.lua).  Each chunk is
generated on the graph's device, so a source costs one elementwise pass
(or one allocation, for zeros) and no host-to-device copy."""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.core.block import Output, SignalSourceBlock
from luaradio_tpu_torch.ops.mixer import FracRamp, PhasorRamp
from luaradio_tpu_torch.blocks.signal.sampling import _TORCH_DTYPES
from luaradio_tpu_torch.types import (Bit, Byte, ComplexFloat32, Float32,
                                      SampleType)


class ZeroSource(SignalSourceBlock):
    """Source of zero samples of any basic type (reference: zero.lua)."""

    def __init__(self, data_type: SampleType, rate: float):
        super().__init__()
        self.data_type = data_type
        self.rate = rate
        self.add_type_signature([], [Output("out", data_type)])

    def generate(self, state, length: int):
        return state, torch.zeros((length,),
                                  dtype=_TORCH_DTYPES[self.data_type.dtype],
                                  device=self.device)


#: Alias kept for reference parity (NullSource == ZeroSource there too).
NullSource = ZeroSource


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

    def generate_sharded(self, state, length: int, axis):
        """Per-shard generation: the carried phase offset by omega *
        shard index * length (reduced mod the waveform's period in float64
        on the host), the global state advanced by the whole chunk."""
        if self.signal == "constant":
            _, y = self.generate(state, length)
            return state, y.expand(axis.n_local, length)
        omega = 2 * np.pi * self.frequency / self.rate
        if self.signal == "exponential":
            period = 2 * np.pi
        else:
            period, omega = 1.0, omega / (2 * np.pi)
        offs = np.mod(omega * length * np.arange(axis.lo, axis.hi,
                                                 dtype=np.float64),
                      period).astype(np.float32)
        _, y = self.generate(state + torch.from_numpy(offs).to(self.device),
                             length)
        new = state + np.float32(np.mod(omega * length * axis.size, period))
        if period == 1.0:
            return torch.remainder(new, 1.0), y
        two_pi = float(np.float32(2 * np.pi))
        return new - two_pi * torch.round(new / two_pi), y


class UniformRandomSource(SignalSourceBlock):
    """Uniform random samples of any basic type (reference:
    uniformrandom.lua): ComplexFloat32 and Float32 in [a, b) (default
    [-1, 1), both parts of a complex sample), Byte in [a, b] (default
    [0, 255]), Bit in {0, 1}.  Drawn on the graph's device from a
    ``torch.Generator`` seeded with ``seed`` (0 when None), which is the
    block's state: each chunk continues the stream.  The stream is
    deterministic for a seed on one device type; it is not the JAX
    package's rbg stream."""

    def __init__(self, data_type: SampleType, rate: float, range=None,
                 seed: int | None = None):
        super().__init__()
        if data_type not in (ComplexFloat32, Float32, Byte, Bit):
            raise ValueError("unsupported data type")
        self.data_type = data_type
        self.rate = rate
        self.range = tuple(range) if range else None
        self.seed = 0 if seed is None else int(seed)
        self.add_type_signature([], [Output("out", data_type)])

    def init_state(self):
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def generate(self, state, length: int):
        t, dev = self.data_type, self.device
        if t in (ComplexFloat32, Float32):
            a, b = self.range or (-1.0, 1.0)
            shape = (2, length) if t == ComplexFloat32 else (length,)
            v = torch.rand(shape, generator=state, device=dev) \
                * float(np.float32(b) - np.float32(a)) + float(np.float32(a))
            return state, (torch.complex(v[0], v[1]) if t == ComplexFloat32
                           else v)
        a, b = (self.range or (0, 255)) if t == Byte else (0, 1)
        y = torch.randint(int(a), int(b) + 1, (length,), generator=state,
                          device=dev, dtype=torch.int32)
        return state, y.to(torch.uint8)

    def generate_sharded(self, state, length: int, axis):
        """Per-shard streams: shard d draws from a generator of its own,
        seeded with ``seed`` and d folded together (the JAX package folds
        the shard index into its subkey), so the stream is reproducible
        for a seed and a shard count.  Under a time mesh the state is the
        tuple of this process's shard generators, made at the first
        chunk."""
        if not isinstance(state, tuple):
            state = tuple(
                torch.Generator(device=self.device).manual_seed(
                    _fold_seed(self.seed, d))
                for d in range(axis.lo, axis.hi))
        return state, torch.stack([self.generate(g, length)[1]
                                   for g in state])


def _fold_seed(seed: int, index: int) -> int:
    """A 63-bit seed from ``seed`` and a shard ``index``."""
    hi, lo = np.random.SeedSequence([seed, index]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) >> 1


__all__ = ["ZeroSource", "NullSource", "SignalSource", "UniformRandomSource"]
