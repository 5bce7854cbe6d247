"""SSB receiver from an RTL-SDR (the JAX package's examples/rtlsdr_ssb.py;
reference examples/rtlsdr_ssb.lua); PulseAudio where DISPLAY is set, else
ssb.wav.

    python -m luaradio_tpu_torch.examples.rtlsdr_ssb [frequency [usb|lsb]] [--cpu]
"""

from __future__ import annotations

import os
import sys

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.examples import run_main


def build(frequency: float = 14.2e6,
          sideband: str = "usb") -> radio.CompositeBlock:
    tune_offset = -100e3
    bandwidth = 3e3
    top = radio.CompositeBlock()
    source = radio.RtlSdrSource(frequency + tune_offset, 1102500)
    tuner = radio.TunerBlock(tune_offset, 2 * bandwidth, 50)
    sb_filter = radio.ComplexBandpassFilterBlock(
        129, (0, -bandwidth) if sideband == "lsb" else (0, bandwidth))
    am_demod = radio.ComplexToRealBlock()
    af_filter = radio.LowpassFilterBlock(128, bandwidth)
    af_gain = radio.AGCBlock("fast")
    sink = (radio.PulseAudioSink(1) if os.environ.get("DISPLAY")
            else radio.WAVFileSink("ssb.wav", 1))
    top.connect(source, tuner, sb_filter, am_demod, af_filter, af_gain, sink)
    return top


def main(argv=None) -> int:
    return run_main(build, argv, (float, str))


if __name__ == "__main__":
    sys.exit(main())
