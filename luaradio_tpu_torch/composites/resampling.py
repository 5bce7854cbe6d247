"""Front-end composite: the reference's radio/composites/tuner.lua.  A
hierarchical CompositeBlock with aliased ports; the graph flattens it into
the enclosing segment, so the composite costs nothing at run time."""

from __future__ import annotations

from luaradio_tpu_torch.blocks.signal.filtering import LowpassFilterBlock
from luaradio_tpu_torch.blocks.signal.modem import FrequencyTranslatorBlock
from luaradio_tpu_torch.blocks.signal.sampling import DownsamplerBlock
from luaradio_tpu_torch.core.block import Input, Output
from luaradio_tpu_torch.core.composite import CompositeBlock
from luaradio_tpu_torch.types import ComplexFloat32


class TunerBlock(CompositeBlock):
    """Frequency translate, lowpass filter, and decimate — the front-end of
    most receivers (reference: tuner.lua:40-47)."""

    def __init__(self, offset: float, bandwidth: float, decimation: int,
                 num_taps: int = 128, window: str = "hamming"):
        super().__init__()
        translator = FrequencyTranslatorBlock(offset)
        filt = LowpassFilterBlock(num_taps, bandwidth / 2, window=window)
        downsampler = DownsamplerBlock(decimation)
        self.connect(translator, filt, downsampler)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", ComplexFloat32)])
        self.connect(self, "in", translator, "in")
        self.connect(self, "out", downsampler, "out")


__all__ = ["TunerBlock"]
