"""Modulation / demodulation blocks on the main path.

Equivalents of the reference's
radio/blocks/signal/{frequencytranslator,frequencydiscriminator}.lua, and
the fused discriminator + decimating FIR that the graph optimizer puts in
their place on request (core/optimize.py).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
from luaradio_tpu_torch.ops import wbfm
from luaradio_tpu_torch.ops.mixer import PhasorRamp
from luaradio_tpu_torch.types import ComplexFloat32, Float32


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
           "DiscriminatorDecimatingFIRBlock"]
