"""FM mono demodulator composite: the reference's
radio/composites/wbfmmonodemodulator.lua.  (Stereo and NBFM are later
slices of the port.)"""

from __future__ import annotations

from luaradio_tpu_torch.blocks.signal.filtering import (
    FMDeemphasisFilterBlock, LowpassFilterBlock)
from luaradio_tpu_torch.blocks.signal.modem import FrequencyDiscriminatorBlock
from luaradio_tpu_torch.core.block import Input, Output
from luaradio_tpu_torch.core.composite import CompositeBlock
from luaradio_tpu_torch.types import ComplexFloat32, Float32


class WBFMMonoDemodulator(CompositeBlock):
    """Broadcast FM mono: discriminator, 15 kHz AF filter, deemphasis
    (reference: wbfmmonodemodulator.lua)."""

    def __init__(self, tau: float = 75e-6):
        super().__init__()
        bandwidth = 15e3
        fm_demod = FrequencyDiscriminatorBlock(1.25)
        af_filter = LowpassFilterBlock(128, bandwidth)
        af_deemphasis = FMDeemphasisFilterBlock(tau)
        self.connect(fm_demod, af_filter, af_deemphasis)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", Float32)])
        self.connect(self, "in", fm_demod, "in")
        self.connect(self, "out", af_deemphasis, "out")


__all__ = ["WBFMMonoDemodulator"]
