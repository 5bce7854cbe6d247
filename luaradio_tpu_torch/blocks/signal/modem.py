"""Modulation / demodulation blocks.

Equivalents of the reference's
radio/blocks/signal/{frequencytranslator,frequencydiscriminator,
frequencymodulator,pulseamplitudemodulator,quadratureamplitudemodulator}.lua,
and the fused discriminator + decimating FIR that the graph optimizer puts
in place of a discriminator and its filter on request (core/optimize.py).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
from luaradio_tpu_torch.ops import wbfm
from luaradio_tpu_torch.ops.mixer import PhasorRamp
from luaradio_tpu_torch.ops.scan import cumsum_phase
from luaradio_tpu_torch.types import Bit, ComplexFloat32, Float32


class FrequencyTranslatorBlock(SignalBlock):
    """y = x * exp(j*2*pi*offset/rate * n): complex mixer via the split-table
    phasor ramp (reference: frequencytranslator.lua — VOLK rotator / liquid
    NCO per-sample loops)."""

    def __init__(self, offset: float):
        super().__init__()
        self.offset = float(offset)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", ComplexFloat32)])

    def initialize(self):
        omega = 2 * np.pi * self.offset / self.get_rate()
        self._ramp = PhasorRamp(omega, self.device)

    def init_state(self):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def process(self, state, x):
        y, phase = self._ramp.rotate(x, state)
        return phase, y

    def process_sharded(self, state, x, *, axis):
        # per-shard phase offset omega * (shard index * shard length),
        # reduced mod 2 pi in float64 on the host: no exchange at all
        two_pi = np.float32(2 * np.pi)
        n_local = x.shape[-1]
        offs = np.mod(self._ramp.omega * n_local
                      * np.arange(axis.lo, axis.hi, dtype=np.float64),
                      2 * np.pi).astype(np.float32)
        lead = (-1,) + (1,) * (x.dim() - 2)
        phase0 = state + torch.from_numpy(offs).to(x.device).view(lead)
        y, _ = self._ramp.rotate(x, phase0)
        new = state + np.float32(np.mod(self._ramp.omega * n_local
                                        * axis.size, 2 * np.pi))
        return new - two_pi * torch.round(new / two_pi), y


class FrequencyDiscriminatorBlock(SignalBlock):
    """y[n] = arg(x[n] * conj(x[n-1])) / (2*pi*modulation_index)
    (reference: frequencydiscriminator.lua:48-88, one-sample carried state)."""

    def __init__(self, modulation_index: float):
        super().__init__()
        self.gain = 2 * np.pi * float(modulation_index)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", Float32)])

    def init_state(self):
        return torch.zeros((), dtype=torch.complex64, device=self.device)

    def process(self, state, x):
        prev = torch.cat([state.expand(x.shape[:-1])[..., None],
                          x[..., :-1]], dim=-1)
        tmp = x * torch.conj(prev)
        inv_gain = float(np.float32(1.0 / self.gain))
        y = torch.atan2(tmp.imag, tmp.real) * inv_gain
        return x[..., -1], y

    def process_sharded(self, state, x, *, axis):
        # one halo exchange (frequencydiscriminator.lua carries the same
        # single sample): each shard's previous sample, the carried one on
        # shard 0, and the stream's last sample as the next carry
        halo, tail = axis.halo_and_tail(x, 1, first=state[..., None])
        _, y = self.process(halo[..., 0], x)
        return tail[..., 0], y


class FrequencyModulatorBlock(SignalBlock):
    """y[n] = exp(j phi[n]), phi[n] = phi[n-1] + 2 pi k x[n] (reference:
    frequencymodulator.lua); the phase is a cumulative sum a chunk, its
    carry wrapped into (-pi, pi] (ops/scan.py cumsum_phase)."""

    def __init__(self, modulation_index: float):
        super().__init__()
        self.modulation_index = float(modulation_index)
        self.add_type_signature([Input("in", Float32)],
                                [Output("out", ComplexFloat32)])

    def init_state(self):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def process(self, state, x):
        delta = float(np.float32(2 * np.pi * self.modulation_index))
        phi, carry = cumsum_phase(x * delta, state)
        return carry, torch.complex(torch.cos(phi), torch.sin(phi))

    def process_sharded(self, state, x, *, axis):
        # the phase accumulator as a distributed cumulative sum; the carry
        # from the same gathered totals
        from luaradio_tpu_torch.parallel.time import cumsum_sharded
        delta = float(np.float32(2 * np.pi * self.modulation_index))
        two_pi = float(np.float32(2 * np.pi))
        psum, total = cumsum_sharded(x * delta, axis, with_total=True)
        phi = psum + state[..., None]
        carry = state + total
        carry = carry - two_pi * torch.round(carry / two_pi)
        return carry, torch.complex(torch.cos(phi), torch.sin(phi))


def _gray(v: int) -> int:
    return v ^ (v >> 1)


class PulseAmplitudeModulatorBlock(SignalBlock):
    """Bits -> gray-coded M-level PAM at symbol_period samples a symbol
    (reference: pulseamplitudemodulator.lua)."""

    def __init__(self, symbol_rate: float, sample_rate: float, levels: int,
                 msb_first: bool = True, amplitudes=None):
        super().__init__()
        if levels < 2 or levels & (levels - 1):
            raise ValueError("levels must be a power of 2 and > 1")
        self.symbol_rate = symbol_rate
        self.sample_rate = sample_rate
        self.levels = levels
        self.symbol_bits = int(np.log2(levels))
        # floor of the true quotient, like the reference's math.floor
        # (pulseamplitudemodulator.lua:40), not Python's a // b, whose
        # fmod-based result differs on exact-ratio floats (2.0 // 0.4 ==
        # 4.0 but floor(2.0 / 0.4) == 5)
        self.symbol_period = int(np.floor(sample_rate / symbol_rate))
        self.msb_first = msb_first
        if amplitudes is None:
            scaling = np.sqrt((levels ** 2 - 1) / 3.0)
            amplitudes = np.zeros(levels, dtype=np.float32)
            for level in range(levels):
                amplitudes[_gray(level)] = (2 * level - levels + 1) / scaling
        self.amplitudes = np.asarray(amplitudes, dtype=np.float32)
        self.add_type_signature([Input("in", Bit)], [Output("out", Float32)])

    def get_rate_ratio(self):
        return Fraction(self.symbol_period, self.symbol_bits)

    def chunk_multiple(self):
        return self.symbol_bits

    def initialize(self):
        self._table = torch.from_numpy(self._symbols()).to(self.device)
        b = self.symbol_bits
        order = range(b - 1, -1, -1) if self.msb_first else range(b)
        self._weights = torch.tensor([1 << k for k in order],
                                     dtype=torch.int64, device=self.device)

    def _symbols(self) -> np.ndarray:
        return self.amplitudes

    def process(self, state, x):
        bits = x.reshape(x.shape[:-1] + (-1, self.symbol_bits))
        idx = (bits.to(torch.int64) * self._weights).sum(-1)
        y = torch.repeat_interleave(self._table[idx], self.symbol_period,
                                    dim=-1)
        return state, y


class QuadratureAmplitudeModulatorBlock(PulseAmplitudeModulatorBlock):
    """Bits -> gray-coded square QAM constellation
    (reference: quadratureamplitudemodulator.lua)."""

    def __init__(self, symbol_rate: float, sample_rate: float, points: int,
                 msb_first: bool = True, constellation=None):
        if points < 2 or points & (points - 1):
            raise ValueError("points must be a power of 2 and > 1")
        symbol_bits = int(np.log2(points))
        if constellation is None:
            i_bits = -(-symbol_bits // 2)
            q_bits = symbol_bits - i_bits
            i_levels, q_levels = 2 ** i_bits, 2 ** q_bits
            scaling = np.sqrt(2 * (points - 1) / 3.0)
            constellation = np.zeros(points, dtype=np.complex64)
            for point in range(points):
                i_value = point >> q_bits
                q_value = point & (q_levels - 1)
                gray_point = (_gray(i_value) << q_bits) | _gray(q_value)
                constellation[gray_point] = complex(
                    2 * i_value - i_levels + 1,
                    2 * q_value - q_levels + 1) / scaling
        super().__init__(symbol_rate, sample_rate, points, msb_first,
                         amplitudes=np.zeros(points, dtype=np.float32))
        self.constellation = np.asarray(constellation, dtype=np.complex64)
        self.signatures.clear()
        self.add_type_signature([Input("in", Bit)],
                                [Output("out", ComplexFloat32)])

    def _symbols(self) -> np.ndarray:
        return self.constellation


class DiscriminatorDecimatingFIRBlock(SignalBlock):
    """FrequencyDiscriminator + DecimatingFIR in one pass: the CUDA kernel
    K2 (ops/wbfm.py disc_fir) forms the discriminator output in shared
    memory and filters it there, so it never goes through device memory.

    The graph optimizer puts this block in place of a discriminator ->
    decimating-FIR pair under LUARADIO_TPU_FORCE_WBFM_KERNEL=1, the same
    switch as the JAX package's (core/optimize.py _fuse_disc_fir); it is
    also available for explicit use.

    State is the last K input samples (complex; zeros at cold start, where
    arg(0 * conj(0)) = 0 matches the unfused blocks)."""

    def __init__(self, taps, decimation: int, modulation_index: float):
        super().__init__()
        taps = np.asarray(taps, np.float32)
        # padded to a multiple of 128 like the JAX block, so the two
        # packages carry the same state shape; zero taps change nothing
        k = -(-len(taps) // 128) * 128
        self.taps = np.concatenate(
            [taps, np.zeros(k - len(taps), np.float32)])
        self.decimation = int(decimation)
        self.gain = 2 * np.pi * float(modulation_index)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", Float32)])

    @classmethod
    def synth(cls, taps, decimation, modulation_index, rate, device,
              name_hint: str = ""):
        blk = cls(taps, decimation, modulation_index)
        blk.differentiate([ComplexFloat32])
        blk.input_rate = rate
        blk.device = device
        if name_hint:
            blk.name = f"DiscriminatorDecimatingFIRBlock[{name_hint}]"
        return blk

    def get_rate_ratio(self):
        return Fraction(1, self.decimation)

    def chunk_multiple(self):
        return self.decimation

    def initialize(self):
        self._taps = torch.from_numpy(self.taps).to(self.device)
        self._inv_gain = float(np.float32(1.0 / self.gain))

    def init_state(self):
        return torch.zeros((len(self.taps),), dtype=torch.complex64,
                           device=self.device)

    def process(self, state, x):
        lead, t = x.shape[:-1], x.shape[-1]
        k = len(self.taps)
        xm = x.reshape(-1, t).contiguous()
        cm = state.expand(lead + (k,)).reshape(-1, k).contiguous()
        audio = wbfm.disc_fir(cm, xm, self._taps, self.decimation,
                              self._inv_gain)
        new_state = torch.cat([cm, xm], dim=-1)[:, -k:]
        return (new_state.reshape(lead + (k,)),
                audio.reshape(lead + (t // self.decimation,)))


__all__ = ["FrequencyTranslatorBlock", "FrequencyDiscriminatorBlock",
           "FrequencyModulatorBlock", "PulseAmplitudeModulatorBlock",
           "QuadratureAmplitudeModulatorBlock",
           "DiscriminatorDecimatingFIRBlock"]

# Symbol mapping and zero stuffing: no coupling along time (the chunk
# planner keeps each shard a whole number of symbols).
PulseAmplitudeModulatorBlock.time_local = True
QuadratureAmplitudeModulatorBlock.time_local = True
