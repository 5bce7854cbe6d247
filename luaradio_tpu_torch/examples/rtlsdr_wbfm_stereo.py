"""Wideband FM broadcast receiver (stereo) from an RTL-SDR (the JAX
package's examples/rtlsdr_wbfm_stereo.py; reference
examples/rtlsdr_wbfm_stereo.lua), with the vector pilot recovery
(PilotRecoveryBlock); PulseAudio where DISPLAY is set, else
wbfm_stereo.wav.

    python -m luaradio_tpu_torch.examples.rtlsdr_wbfm_stereo [frequency] [--cpu]
"""

from __future__ import annotations

import os
import sys

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.examples import run_main


def build(frequency: float = 88.5e6) -> radio.CompositeBlock:
    tune_offset = -250e3
    top = radio.CompositeBlock()
    source = radio.RtlSdrSource(frequency + tune_offset, 1102500)
    tuner = radio.TunerBlock(tune_offset, 200e3, 5)
    demod = radio.WBFMStereoDemodulator(pilot="vector")
    l_downsampler = radio.DownsamplerBlock(5)
    r_downsampler = radio.DownsamplerBlock(5)
    sink = (radio.PulseAudioSink(2) if os.environ.get("DISPLAY")
            else radio.WAVFileSink("wbfm_stereo.wav", 2))
    top.connect(source, tuner, demod)
    top.connect(demod, "left", l_downsampler, "in")
    top.connect(demod, "right", r_downsampler, "in")
    top.connect(l_downsampler, "out", sink, "in1")
    top.connect(r_downsampler, "out", sink, "in2")
    return top


def main(argv=None) -> int:
    return run_main(build, argv)


if __name__ == "__main__":
    sys.exit(main())
