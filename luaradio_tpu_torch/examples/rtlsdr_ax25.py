"""AX.25 packet radio receiver (1200 baud AFSK) from an RTL-SDR, to JSON
lines on standard output (the JAX package's examples/rtlsdr_ax25.py;
reference examples/rtlsdr_ax25.lua).

    python -m luaradio_tpu_torch.examples.rtlsdr_ax25 [frequency] [--cpu]
"""

from __future__ import annotations

import sys

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.examples import run_main


def build(frequency: float = 144.39e6) -> radio.CompositeBlock:
    tune_offset = -100e3
    baudrate = 1200
    top = radio.CompositeBlock()
    source = radio.RtlSdrSource(frequency + tune_offset, 1000000)
    tuner = radio.TunerBlock(tune_offset, 12e3, 80)
    nbfm_demod = radio.NBFMDemodulator(3e3, 3e3)
    hilbert = radio.HilbertTransformBlock(129)
    translator = radio.FrequencyTranslatorBlock(-1700)
    afsk_filter = radio.LowpassFilterBlock(128, 750)
    afsk_demod = radio.FrequencyDiscriminatorBlock(1.25)
    data_filter = radio.LowpassFilterBlock(128, baudrate)
    clock_recoverer = radio.ZeroCrossingClockRecoveryBlock(baudrate)
    sampler = radio.SamplerBlock()
    bit_slicer = radio.SlicerBlock()
    bit_decoder = radio.DifferentialDecoderBlock(invert=True)
    framer = radio.AX25FramerBlock()
    sink = radio.JSONSink()
    top.connect(source, tuner, nbfm_demod, hilbert, translator, afsk_filter,
                afsk_demod, data_filter)
    top.connect(data_filter, clock_recoverer)
    top.connect(data_filter, "out", sampler, "data")
    top.connect(clock_recoverer, "out", sampler, "clock")
    top.connect(sampler, bit_slicer, bit_decoder, framer, sink)
    return top


def main(argv=None) -> int:
    return run_main(build, argv)


if __name__ == "__main__":
    sys.exit(main())
