"""AM and SSB composites: the reference's radio/composites/
{amenvelopedemodulator,amsynchronousdemodulator,ssbdemodulator,
ssbmodulator}.lua."""

from __future__ import annotations

from luaradio_tpu_torch.blocks.signal.carrier import PLLBlock
from luaradio_tpu_torch.blocks.signal.filtering import (
    ComplexBandpassFilterBlock, HilbertTransformBlock, LowpassFilterBlock,
    SinglepoleHighpassFilterBlock)
from luaradio_tpu_torch.blocks.signal.math import (ComplexConjugateBlock,
                                                   ComplexMagnitudeBlock,
                                                   ComplexToRealBlock,
                                                   MultiplyConjugateBlock)
from luaradio_tpu_torch.core.block import Input, Output
from luaradio_tpu_torch.core.composite import CompositeBlock
from luaradio_tpu_torch.types import ComplexFloat32, Float32


class AMEnvelopeDemodulator(CompositeBlock):
    """AM envelope detection: magnitude, DC block, AF filter
    (reference: amenvelopedemodulator.lua)."""

    def __init__(self, bandwidth: float = 5e3):
        super().__init__()
        am_demod = ComplexMagnitudeBlock()
        dcr_filter = SinglepoleHighpassFilterBlock(100.0)
        af_filter = LowpassFilterBlock(128, bandwidth)
        self.connect(am_demod, dcr_filter, af_filter)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", Float32)])
        self.connect(self, "in", am_demod, "in")
        self.connect(self, "out", af_filter, "out")


class AMSynchronousDemodulator(CompositeBlock):
    """AM synchronous detection: the band around the carrier feeds both a
    carrier PLL (multiplier 1: K3's second path, ops/pll.py) and a
    coherent mixer against the PLL's oscillator
    (reference: amsynchronousdemodulator.lua)."""

    def __init__(self, ifreq: float, bandwidth: float = 5e3):
        super().__init__()
        rf_filter = ComplexBandpassFilterBlock(
            129, (ifreq - bandwidth, ifreq + bandwidth))
        pll = PLLBlock(1000.0, ifreq - 100, ifreq + 100)
        mixer = MultiplyConjugateBlock()
        am_demod = ComplexToRealBlock()
        dcr_filter = SinglepoleHighpassFilterBlock(100.0)
        af_filter = LowpassFilterBlock(128, bandwidth)
        self.connect(rf_filter, pll)
        self.connect(rf_filter, "out", mixer, "in1")
        self.connect(pll, "out", mixer, "in2")
        self.connect(mixer, am_demod, dcr_filter, af_filter)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", Float32)])
        self.connect(self, "in", rf_filter, "in")
        self.connect(self, "out", af_filter, "out")


class SSBDemodulator(CompositeBlock):
    """SSB demodulation: complex sideband filter, Re, AF filter
    (reference: ssbdemodulator.lua)."""

    def __init__(self, sideband: str, bandwidth: float = 3e3):
        super().__init__()
        if sideband not in ("lsb", "usb"):
            raise ValueError("sideband must be 'lsb' or 'usb'")
        cutoffs = (0.0, -bandwidth) if sideband == "lsb" else (0.0, bandwidth)
        sb_filter = ComplexBandpassFilterBlock(129, cutoffs)
        am_demod = ComplexToRealBlock()
        af_filter = LowpassFilterBlock(128, bandwidth)
        self.connect(sb_filter, am_demod, af_filter)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", Float32)])
        self.connect(self, "in", sb_filter, "in")
        self.connect(self, "out", af_filter, "out")


class SSBModulator(CompositeBlock):
    """SSB modulation: AF filter, Hilbert, (conjugate for LSB), sideband
    filter (reference: ssbmodulator.lua)."""

    def __init__(self, sideband: str, bandwidth: float = 3e3):
        super().__init__()
        if sideband not in ("lsb", "usb"):
            raise ValueError("sideband must be 'lsb' or 'usb'")
        af_filter = LowpassFilterBlock(128, bandwidth)
        hilbert = HilbertTransformBlock(129)
        cutoffs = ((-bandwidth, 0.0) if sideband == "lsb"
                   else (0.0, bandwidth))
        sb_filter = ComplexBandpassFilterBlock(129, cutoffs)
        if sideband == "lsb":
            conjugate = ComplexConjugateBlock()
            self.connect(af_filter, hilbert, conjugate, sb_filter)
        else:
            self.connect(af_filter, hilbert, sb_filter)
        self.add_type_signature([Input("in", Float32)],
                                [Output("out", ComplexFloat32)])
        self.connect(self, "in", af_filter, "in")
        self.connect(self, "out", sb_filter, "out")


__all__ = ["AMEnvelopeDemodulator", "AMSynchronousDemodulator",
           "SSBDemodulator", "SSBModulator"]
