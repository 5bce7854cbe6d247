"""Full receiver composites: RDS, AX.25, POCSAG, ERT, BPSK31 (the JAX
package's composites/receivers.py; reference:
radio/composites/{rdsreceiver,ax25receiver,pocsagreceiver,ertreceiver,
bpsk31receiver}.lua).  The DSP front half of each chain runs as one
device segment on the card; the masked Sampler (or, for ERT, the host
preamble sampler) and the host framers form the device->host boundary.
"""

from __future__ import annotations

from luaradio_tpu_torch.blocks.protocol.ax25 import AX25FramerBlock
from luaradio_tpu_torch.blocks.protocol.ert import (IDMFramerBlock, SCMFramerBlock,
                                              SCMPlusFramerBlock)
from luaradio_tpu_torch.blocks.protocol.pocsag import (POCSAGDecoderBlock,
                                                 POCSAGFramerBlock)
from luaradio_tpu_torch.blocks.protocol.rds import RDSDecoderBlock, RDSFramerBlock
from luaradio_tpu_torch.blocks.protocol.varicode import VaricodeDecoderBlock
from luaradio_tpu_torch.blocks.signal.carrier import (BinaryPhaseCorrectorBlock,
                                                PilotRecoveryBlock,
                                                PLLBlock,
                                                ZeroCrossingClockRecoveryBlock)
from luaradio_tpu_torch.blocks.signal.digital import (PreambleSamplerBlock,
                                                SamplerBlock, SlicerBlock,
                                                DifferentialDecoderBlock,
                                                ManchesterDecoderBlock)
from luaradio_tpu_torch.blocks.signal.filtering import (ComplexBandpassFilterBlock,
                                                  HilbertTransformBlock,
                                                  LowpassFilterBlock,
                                                  ManchesterMatchedFilterBlock,
                                                  RootRaisedCosineFilterBlock)
from luaradio_tpu_torch.blocks.signal.math import (ComplexMagnitudeBlock,
                                             ComplexToRealBlock,
                                             MultiplyConjugateBlock,
                                             SubtractBlock)
from luaradio_tpu_torch.blocks.signal.modem import FrequencyDiscriminatorBlock, \
    FrequencyTranslatorBlock
from luaradio_tpu_torch.blocks.signal.sampling import (DelayBlock, DownsamplerBlock)
from luaradio_tpu_torch.composites.fm import NBFMDemodulator
from luaradio_tpu_torch.core.block import Input, Output
from luaradio_tpu_torch.core.composite import CompositeBlock
from luaradio_tpu_torch.types import Byte, ComplexFloat32


class RDSReceiver(CompositeBlock):
    """RDS broadcast data receiver: pilot PLL x3 -> 57 kHz coherent demod ->
    RRC -> BPSK clock recovery -> Manchester -> differential -> framer ->
    decoder (reference: rdsreceiver.lua:24-56)."""

    def __init__(self, pilot: str = "pll"):
        super().__init__()
        fm_demod = FrequencyDiscriminatorBlock(1.25)
        hilbert = HilbertTransformBlock(129)
        # signal-path delay = pilot filter group delay (see composites/fm.py)
        mixer_delay = DelayBlock(64)
        if pilot == "pll":
            pilot_filter = ComplexBandpassFilterBlock(129, (18e3, 20e3))
            pll_baseband = PLLBlock(1500.0, 19e3 - 100, 19e3 + 100,
                                    multiplier=3.0)
        elif pilot == "vector":
            # the vectorized pilot path: FIR + normalize
            # (blocks/signal/carrier.py PilotRecoveryBlock)
            pilot_filter = PilotRecoveryBlock(129, (18e3, 20e3),
                                              multiplier=3)
        else:
            raise ValueError(f"unknown pilot mode {pilot!r}")
        mixer = MultiplyConjugateBlock()
        baseband_filter = LowpassFilterBlock(128, 4e3)
        baseband_rrc = RootRaisedCosineFilterBlock(101, 1, 1187.5)
        phase_corrector = BinaryPhaseCorrectorBlock(8000)
        clock_demod = ComplexToRealBlock()
        clock_recoverer = ZeroCrossingClockRecoveryBlock(1187.5 * 2)
        sampler = SamplerBlock()
        bit_demod = ComplexToRealBlock()
        bit_slicer = SlicerBlock()
        bit_decoder = ManchesterDecoderBlock()
        bit_diff_decoder = DifferentialDecoderBlock()
        framer = RDSFramerBlock()
        decoder = RDSDecoderBlock()

        self.connect(fm_demod, hilbert, mixer_delay)
        if pilot == "pll":
            self.connect(hilbert, pilot_filter, pll_baseband)
            self.connect(pll_baseband, "out", mixer, "in2")
        else:
            self.connect(hilbert, pilot_filter)
            self.connect(pilot_filter, "out", mixer, "in2")
        self.connect(mixer_delay, "out", mixer, "in1")
        self.connect(mixer, baseband_filter, baseband_rrc, phase_corrector)
        self.connect(phase_corrector, clock_demod, clock_recoverer)
        self.connect(phase_corrector, "out", sampler, "data")
        self.connect(clock_recoverer, "out", sampler, "clock")
        self.connect(sampler, bit_demod, bit_slicer, bit_decoder,
                     bit_diff_decoder, framer, decoder)
        self.add_type_signature(
            [Input("in", ComplexFloat32)],
            [Output("out", RDSDecoderBlock.RDSPacketType)])
        self.connect(self, "in", fm_demod, "in")
        self.connect(self, "out", decoder, "out")


class AX25Receiver(CompositeBlock):
    """Bell-202 AFSK AX.25 receiver (reference: ax25receiver.lua)."""

    def __init__(self):
        super().__init__()
        fm_deviation, fm_bandwidth, baudrate = 3e3, 3e3, 1200
        nbfm_demod = NBFMDemodulator(fm_deviation, fm_bandwidth)
        hilbert = HilbertTransformBlock(129)
        translator = FrequencyTranslatorBlock(-1700)
        afsk_filter = LowpassFilterBlock(128, 750)
        afsk_demod = FrequencyDiscriminatorBlock(fm_deviation / fm_bandwidth)
        data_filter = LowpassFilterBlock(128, baudrate)
        clock_recoverer = ZeroCrossingClockRecoveryBlock(baudrate)
        sampler = SamplerBlock()
        bit_slicer = SlicerBlock()
        bit_decoder = DifferentialDecoderBlock(invert=True)
        framer = AX25FramerBlock()
        self.connect(nbfm_demod, hilbert, translator, afsk_filter, afsk_demod,
                     data_filter, clock_recoverer)
        self.connect(data_filter, "out", sampler, "data")
        self.connect(clock_recoverer, "out", sampler, "clock")
        self.connect(sampler, bit_slicer, bit_decoder, framer)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", AX25FramerBlock.AX25FrameType)])
        self.connect(self, "in", nbfm_demod, "in")
        self.connect(self, "out", framer, "out")


class POCSAGReceiver(CompositeBlock):
    """POCSAG pager receiver: dual mark/space bandpass FSK demod
    (reference: pocsagreceiver.lua)."""

    def __init__(self, baudrate: int = 1200):
        super().__init__()
        if baudrate not in (512, 1200):
            raise ValueError("only 512 and 1200 baudrates supported")
        space_filter = ComplexBandpassFilterBlock(129, (3500, 5500))
        space_magnitude = ComplexMagnitudeBlock()
        mark_filter = ComplexBandpassFilterBlock(129, (-5500, -3500))
        mark_magnitude = ComplexMagnitudeBlock()
        subtractor = SubtractBlock()
        data_filter = LowpassFilterBlock(128, baudrate)
        clock_recoverer = ZeroCrossingClockRecoveryBlock(baudrate)
        sampler = SamplerBlock()
        bit_slicer = SlicerBlock()
        framer = POCSAGFramerBlock()
        decoder = POCSAGDecoderBlock()
        self.connect(space_filter, space_magnitude)
        self.connect(mark_filter, mark_magnitude)
        self.connect(mark_magnitude, "out", subtractor, "in1")
        self.connect(space_magnitude, "out", subtractor, "in2")
        self.connect(subtractor, data_filter, clock_recoverer)
        self.connect(data_filter, "out", sampler, "data")
        self.connect(clock_recoverer, "out", sampler, "clock")
        self.connect(sampler, bit_slicer, framer, decoder)
        self.add_type_signature(
            [Input("in", ComplexFloat32)],
            [Output("out", POCSAGDecoderBlock.POCSAGMessageType)])
        self.connect(self, "in", space_filter, "in")
        self.connect(self, "in", mark_filter, "in")
        self.connect(self, "out", decoder, "out")


class ERTReceiver(CompositeBlock):
    """ERT utility-meter receiver with multi-protocol fan-out (IDM / SCM /
    SCM+) (reference: ertreceiver.lua)."""

    PROTOCOLS = {
        "idm": (IDMFramerBlock, IDMFramerBlock.IDM_PREAMBLE,
                IDMFramerBlock.IDM_FRAME_LEN),
        "scm": (SCMFramerBlock, SCMFramerBlock.SCM_PREAMBLE,
                SCMFramerBlock.SCM_FRAME_LEN),
        "scm+": (SCMPlusFramerBlock, SCMPlusFramerBlock.SCM_PLUS_PREAMBLE,
                 SCMPlusFramerBlock.SCM_PLUS_FRAME_LEN),
    }

    def __init__(self, protocols=("scm",), decimation: int = 6):
        super().__init__()
        symbol_rate = 32768
        magnitude = ComplexMagnitudeBlock()
        data_filter = LowpassFilterBlock(128, symbol_rate * 4)
        downsampler = DownsamplerBlock(decimation)
        matched_filter = ManchesterMatchedFilterBlock(symbol_rate)
        self.connect(magnitude, data_filter, downsampler, matched_filter)

        outputs = []
        framers = []
        for i, protocol in enumerate(protocols):
            if protocol not in self.PROTOCOLS:
                raise ValueError(f"unsupported protocol {protocol!r}")
            framer_cls, preamble, frame_len = self.PROTOCOLS[protocol]
            sampler = PreambleSamplerBlock(symbol_rate / 2, preamble,
                                           frame_len)
            slicer = SlicerBlock()
            framer = framer_cls()
            self.connect(matched_filter, sampler, slicer, framer)
            framers.append(framer)
            outputs.append(Output(f"out{i+1}", framer.frame_type))
        self.add_type_signature([Input("in", ComplexFloat32)], outputs)
        self.connect(self, "in", magnitude, "in")
        for i, framer in enumerate(framers):
            self.connect(self, f"out{i+1}", framer, "out")


class BPSK31Receiver(CompositeBlock):
    """PSK31 receiver: RRC matched filter, phase corrector, clock recovery,
    differential decode, varicode (reference: bpsk31receiver.lua)."""

    def __init__(self):
        super().__init__()
        bandwidth, baudrate = 100, 31.25
        filt = LowpassFilterBlock(128, bandwidth)
        rrc_filter = RootRaisedCosineFilterBlock(101, 1, baudrate)
        phase_corrector = BinaryPhaseCorrectorBlock(50)
        clock_demod = ComplexToRealBlock()
        clock_recoverer = ZeroCrossingClockRecoveryBlock(baudrate)
        sampler = SamplerBlock()
        bit_demod = ComplexToRealBlock()
        slicer = SlicerBlock()
        bit_decoder = DifferentialDecoderBlock(invert=True)
        decoder = VaricodeDecoderBlock()
        self.connect(filt, rrc_filter, phase_corrector)
        self.connect(phase_corrector, clock_demod, clock_recoverer)
        self.connect(phase_corrector, "out", sampler, "data")
        self.connect(clock_recoverer, "out", sampler, "clock")
        self.connect(sampler, bit_demod, slicer, bit_decoder, decoder)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", Byte)])
        self.connect(self, "in", filt, "in")
        self.connect(self, "out", decoder, "out")


__all__ = ["RDSReceiver", "AX25Receiver", "POCSAGReceiver", "ERTReceiver",
           "BPSK31Receiver"]
