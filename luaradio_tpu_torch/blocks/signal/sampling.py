"""Sample-rate blocks on the main path (reference:
radio/blocks/signal/downsampler.lua).  Rate-changing blocks declare exact
rational rate ratios and chunk-multiple constraints so the graph planner
keeps every chunk a multiple of the factor; the per-call phase state the
reference carries (downsampler.lua:45-55) is then unnecessary."""

from __future__ import annotations

from fractions import Fraction

from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
from luaradio_tpu_torch.types import ComplexFloat32, Float32


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


__all__ = ["DownsamplerBlock"]
