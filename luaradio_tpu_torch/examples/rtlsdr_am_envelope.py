"""AM broadcast receiver (envelope detection) from an RTL-SDR (the JAX
package's examples/rtlsdr_am_envelope.py; reference
examples/rtlsdr_am_envelope.lua); PulseAudio where DISPLAY is set, else
am.wav.

    python -m luaradio_tpu_torch.examples.rtlsdr_am_envelope [frequency] [--cpu]
"""

from __future__ import annotations

import os
import sys

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.examples import run_main


def build(frequency: float = 1030e3) -> radio.CompositeBlock:
    tune_offset = -100e3
    bandwidth = 5e3
    top = radio.CompositeBlock()
    source = radio.RtlSdrSource(frequency + tune_offset, 1102500)
    tuner = radio.TunerBlock(tune_offset, 2 * bandwidth, 50)
    am_demod = radio.ComplexMagnitudeBlock()
    dcr_filter = radio.SinglepoleHighpassFilterBlock(100)
    af_filter = radio.LowpassFilterBlock(128, bandwidth)
    af_gain = radio.AGCBlock("slow")
    sink = (radio.PulseAudioSink(1) if os.environ.get("DISPLAY")
            else radio.WAVFileSink("am.wav", 1))
    top.connect(source, tuner, am_demod, dcr_filter, af_filter, af_gain,
                sink)
    return top


def main(argv=None) -> int:
    return run_main(build, argv)


if __name__ == "__main__":
    sys.exit(main())
