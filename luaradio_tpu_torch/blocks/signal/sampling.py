"""Sample-rate and plumbing blocks (reference:
radio/blocks/signal/{downsampler,delay}.lua).  Rate-changing blocks declare
exact rational rate ratios and chunk-multiple constraints so the graph
planner keeps every chunk a multiple of the factor; the per-call phase
state the reference carries (downsampler.lua:45-55) is then unnecessary."""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
from luaradio_tpu_torch.types import Bit, Byte, ComplexFloat32, Float32

_TORCH_DTYPES = {np.dtype(np.complex64): torch.complex64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.uint8): torch.uint8}


class DownsamplerBlock(SignalBlock):
    """y[n] = x[n*M] (reference: downsampler.lua)."""

    def __init__(self, factor: int):
        super().__init__()
        if factor < 1:
            raise ValueError("factor must be >= 1")
        self.factor = int(factor)
        for t in (ComplexFloat32, Float32):
            self.add_type_signature([Input("in", t)], [Output("out", t)])

    def get_rate_ratio(self):
        return Fraction(1, self.factor)

    def chunk_multiple(self):
        return self.factor

    def process(self, state, x):
        return state, x[..., ::self.factor]


class DelayBlock(SignalBlock):
    """Delay by N samples through a carried sample line
    (reference: delay.lua)."""

    def __init__(self, num_samples: int):
        super().__init__()
        if num_samples <= 0:
            raise ValueError("num_samples must be > 0")
        self.num_samples = int(num_samples)
        for t in (ComplexFloat32, Float32, Bit, Byte):
            self.add_type_signature([Input("in", t)], [Output("out", t)])

    def init_state(self):
        return torch.zeros(
            (self.num_samples,),
            dtype=_TORCH_DTYPES[self.get_input_type().dtype],
            device=self.device)

    def process(self, state, x):
        n = x.shape[-1]
        xin = torch.cat([state.expand(x.shape[:-1] + state.shape[-1:]), x],
                        dim=-1)
        return xin[..., n:], xin[..., :n]


__all__ = ["DownsamplerBlock", "DelayBlock"]
