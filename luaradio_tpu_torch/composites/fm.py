"""FM demodulator composites: the reference's
radio/composites/{wbfmmonodemodulator,wbfmstereodemodulator,
nbfmdemodulator}.lua."""

from __future__ import annotations

from luaradio_tpu_torch.blocks.signal.carrier import (PilotRecoveryBlock,
                                                      PLLBlock)
from luaradio_tpu_torch.blocks.signal.filtering import (
    ComplexBandpassFilterBlock, FMDeemphasisFilterBlock,
    HilbertTransformBlock, LowpassFilterBlock)
from luaradio_tpu_torch.blocks.signal.math import (AddBlock,
                                                   ComplexToRealBlock,
                                                   MultiplyConjugateBlock,
                                                   SubtractBlock)
from luaradio_tpu_torch.blocks.signal.modem import FrequencyDiscriminatorBlock
from luaradio_tpu_torch.blocks.signal.sampling import DelayBlock
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


class WBFMStereoDemodulator(CompositeBlock):
    """Broadcast FM stereo: 19 kHz pilot recovery doubled to 38 kHz,
    coherent L-R demodulation, stereo matrix, deemphasis (reference:
    wbfmstereodemodulator.lua:28-64).

    ``pilot``: "pll" (the reference's bandpass + PLL, a sequential
    feedback loop; K3 runs the chunks its linear tier cannot) or "vector"
    (PilotRecoveryBlock: bandpass + magnitude normalization, FIR and
    elementwise only)."""

    def __init__(self, tau: float = 75e-6, pilot: str = "pll"):
        super().__init__()
        bandwidth = 15e3
        fm_demod = FrequencyDiscriminatorBlock(1.25)
        hilbert = HilbertTransformBlock(129)
        # the signal path is delayed by the pilot filter's group delay,
        # (129-1)/2 = 64 samples, so the 38 kHz subcarrier is coherent
        delay = DelayBlock(64)
        if pilot == "pll":
            pilot_filter = ComplexBandpassFilterBlock(129, (18e3, 20e3))
            pilot_pll = PLLBlock(100.0, 19e3 - 50, 19e3 + 50, multiplier=2)
        elif pilot == "vector":
            pilot_filter = PilotRecoveryBlock(129, (18e3, 20e3),
                                              multiplier=2)
        else:
            raise ValueError(f"unknown pilot mode {pilot!r}")
        mixer = MultiplyConjugateBlock()
        lpr_filter = LowpassFilterBlock(128, bandwidth)
        lpr_am_demod = ComplexToRealBlock()
        lmr_filter = LowpassFilterBlock(128, bandwidth)
        lmr_am_demod = ComplexToRealBlock()
        l_sum = AddBlock()
        left_af_deemphasis = FMDeemphasisFilterBlock(tau)
        r_sub = SubtractBlock()
        right_af_deemphasis = FMDeemphasisFilterBlock(tau)

        self.connect(fm_demod, hilbert)
        if pilot == "pll":
            self.connect(hilbert, pilot_filter, pilot_pll)
            self.connect(pilot_pll, "out", mixer, "in2")
        else:
            self.connect(hilbert, pilot_filter)
            self.connect(pilot_filter, "out", mixer, "in2")
        self.connect(hilbert, delay)
        self.connect(delay, "out", mixer, "in1")
        self.connect(delay, lpr_filter, lpr_am_demod)
        self.connect(mixer, lmr_filter, lmr_am_demod)
        self.connect(lpr_am_demod, "out", l_sum, "in1")
        self.connect(lmr_am_demod, "out", l_sum, "in2")
        self.connect(lpr_am_demod, "out", r_sub, "in1")
        self.connect(lmr_am_demod, "out", r_sub, "in2")
        self.connect(l_sum, left_af_deemphasis)
        self.connect(r_sub, right_af_deemphasis)

        self.add_type_signature(
            [Input("in", ComplexFloat32)],
            [Output("left", Float32), Output("right", Float32)])
        self.connect(self, "in", fm_demod, "in")
        self.connect(self, "left", left_af_deemphasis, "out")
        self.connect(self, "right", right_af_deemphasis, "out")


class NBFMDemodulator(CompositeBlock):
    """Narrowband FM: RF filter, discriminator, AF filter
    (reference: nbfmdemodulator.lua)."""

    def __init__(self, deviation: float = 5e3, bandwidth: float = 4e3):
        super().__init__()
        rf_filter = LowpassFilterBlock(128, deviation + bandwidth)
        fm_demod = FrequencyDiscriminatorBlock(deviation / bandwidth)
        af_filter = LowpassFilterBlock(128, bandwidth)
        self.connect(rf_filter, fm_demod, af_filter)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", Float32)])
        self.connect(self, "in", rf_filter, "in")
        self.connect(self, "out", af_filter, "out")


__all__ = ["WBFMMonoDemodulator", "WBFMStereoDemodulator", "NBFMDemodulator"]
