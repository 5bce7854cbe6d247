"""Front-end and resampling composites: the reference's
radio/composites/{tuner,decimator,interpolator,rationalresampler}.lua.
Each is a hierarchical CompositeBlock with aliased ports; the graph
flattens it into the enclosing segment, so a composite costs nothing at
run time."""

from __future__ import annotations

from luaradio_tpu_torch.blocks.signal.filtering import LowpassFilterBlock
from luaradio_tpu_torch.blocks.signal.math import MultiplyConstantBlock
from luaradio_tpu_torch.blocks.signal.modem import FrequencyTranslatorBlock
from luaradio_tpu_torch.blocks.signal.sampling import (DownsamplerBlock,
                                                       UpsamplerBlock)
from luaradio_tpu_torch.core.block import Input, Output
from luaradio_tpu_torch.core.composite import CompositeBlock
from luaradio_tpu_torch.types import ComplexFloat32, Float32


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


class DecimatorBlock(CompositeBlock):
    """Anti-aliased decimator (reference: decimator.lua)."""

    def __init__(self, decimation: int, num_taps: int = 128,
                 window: str = "hamming"):
        super().__init__()
        filt = LowpassFilterBlock(num_taps, 1.0 / decimation, nyquist=1.0,
                                  window=window)
        downsampler = DownsamplerBlock(decimation)
        self.connect(filt, downsampler)
        for t in (ComplexFloat32, Float32):
            self.add_type_signature([Input("in", t)], [Output("out", t)])
        self.connect(self, "in", filt, "in")
        self.connect(self, "out", downsampler, "out")


class InterpolatorBlock(CompositeBlock):
    """Anti-imaged interpolator (reference: interpolator.lua)."""

    def __init__(self, interpolation: int, num_taps: int = 128,
                 window: str = "hamming"):
        super().__init__()
        scaler = MultiplyConstantBlock(float(interpolation))
        upsampler = UpsamplerBlock(interpolation)
        filt = LowpassFilterBlock(num_taps, 1.0 / interpolation, nyquist=1.0,
                                  window=window)
        self.connect(scaler, upsampler, filt)
        for t in (ComplexFloat32, Float32):
            self.add_type_signature([Input("in", t)], [Output("out", t)])
        self.connect(self, "in", scaler, "in")
        self.connect(self, "out", filt, "out")


class RationalResamplerBlock(CompositeBlock):
    """Rational L/M resampler: scale, upsample, filter, downsample
    (reference: rationalresampler.lua)."""

    def __init__(self, interpolation: int, decimation: int,
                 num_taps: int = 128, window: str = "hamming"):
        super().__init__()
        cutoff = min(1.0 / interpolation, 1.0 / decimation)
        scaler = MultiplyConstantBlock(float(interpolation))
        upsampler = UpsamplerBlock(interpolation)
        filt = LowpassFilterBlock(num_taps, cutoff, nyquist=1.0, window=window)
        downsampler = DownsamplerBlock(decimation)
        self.connect(scaler, upsampler, filt, downsampler)
        for t in (ComplexFloat32, Float32):
            self.add_type_signature([Input("in", t)], [Output("out", t)])
        self.connect(self, "in", scaler, "in")
        self.connect(self, "out", downsampler, "out")


__all__ = ["TunerBlock", "DecimatorBlock", "InterpolatorBlock",
           "RationalResamplerBlock"]
