"""POCSAG pager receiver from an RTL-SDR, to JSON lines on standard output
(the JAX package's examples/rtlsdr_pocsag.py; reference
examples/rtlsdr_pocsag.lua).

    python -m luaradio_tpu_torch.examples.rtlsdr_pocsag [frequency] [--cpu]
"""

from __future__ import annotations

import sys

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.examples import run_main


def build(frequency: float = 152.24e6) -> radio.CompositeBlock:
    tune_offset = -100e3
    baudrate = 1200
    top = radio.CompositeBlock()
    source = radio.RtlSdrSource(frequency + tune_offset, 1000000)
    tuner = radio.TunerBlock(tune_offset, 12e3, 80)
    space_filter = radio.ComplexBandpassFilterBlock(129, (3500, 5500))
    space_magnitude = radio.ComplexMagnitudeBlock()
    mark_filter = radio.ComplexBandpassFilterBlock(129, (-5500, -3500))
    mark_magnitude = radio.ComplexMagnitudeBlock()
    subtractor = radio.SubtractBlock()
    data_filter = radio.LowpassFilterBlock(128, baudrate)
    clock_recoverer = radio.ZeroCrossingClockRecoveryBlock(baudrate)
    sampler = radio.SamplerBlock()
    bit_slicer = radio.SlicerBlock()
    framer = radio.POCSAGFramerBlock()
    decoder = radio.POCSAGDecoderBlock()
    sink = radio.JSONSink()
    top.connect(source, tuner)
    top.connect(tuner, space_filter, space_magnitude)
    top.connect(tuner, mark_filter, mark_magnitude)
    top.connect(mark_magnitude, "out", subtractor, "in1")
    top.connect(space_magnitude, "out", subtractor, "in2")
    top.connect(subtractor, data_filter)
    top.connect(data_filter, clock_recoverer)
    top.connect(data_filter, "out", sampler, "data")
    top.connect(clock_recoverer, "out", sampler, "clock")
    top.connect(sampler, bit_slicer, framer, decoder, sink)
    return top


def main(argv=None) -> int:
    return run_main(build, argv)


if __name__ == "__main__":
    sys.exit(main())
