"""AM broadcast receiver with synchronous detection (carrier PLL and
mixer) from an RTL-SDR (the JAX package's
examples/rtlsdr_am_synchronous.py; reference
examples/rtlsdr_am_synchronous.lua): the source tuned 50 kHz below the
station, Decimator(5), a 10 kHz IF bandpass, the PLL (K3 on the card at
multiplier 1) and its conjugate mix; PulseAudio where DISPLAY is set, else
am.wav.

    python -m luaradio_tpu_torch.examples.rtlsdr_am_synchronous [frequency] [--cpu]
"""

from __future__ import annotations

import os
import sys

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.examples import run_main


def build(frequency: float = 1030e3) -> radio.CompositeBlock:
    ifreq = 50e3
    bandwidth = 5e3
    top = radio.CompositeBlock()
    source = radio.RtlSdrSource(frequency - ifreq, 1102500)
    rf_decimator = radio.DecimatorBlock(5)
    if_filter = radio.ComplexBandpassFilterBlock(
        129, (ifreq - bandwidth, ifreq + bandwidth))
    pll = radio.PLLBlock(1000, ifreq - 100, ifreq + 100)
    mixer = radio.MultiplyConjugateBlock()
    am_demod = radio.ComplexToRealBlock()
    dcr_filter = radio.SinglepoleHighpassFilterBlock(100)
    af_filter = radio.LowpassFilterBlock(128, bandwidth)
    af_downsampler = radio.DownsamplerBlock(10)
    af_gain = radio.AGCBlock("slow")
    sink = (radio.PulseAudioSink(1) if os.environ.get("DISPLAY")
            else radio.WAVFileSink("am.wav", 1))
    top.connect(source, rf_decimator, if_filter)
    top.connect(if_filter, "out", mixer, "in1")
    top.connect(if_filter, pll)
    top.connect(pll, "out", mixer, "in2")
    top.connect(mixer, am_demod, dcr_filter, af_filter, af_downsampler,
                af_gain, sink)
    return top


def main(argv=None) -> int:
    return run_main(build, argv)


if __name__ == "__main__":
    sys.exit(main())
