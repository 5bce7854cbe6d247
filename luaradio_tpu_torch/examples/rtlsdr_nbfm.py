"""Narrowband FM receiver from an RTL-SDR (the JAX package's
examples/rtlsdr_nbfm.py; reference examples/rtlsdr_nbfm.lua); PulseAudio
where DISPLAY is set, else nbfm.wav.

    python -m luaradio_tpu_torch.examples.rtlsdr_nbfm [frequency] [--cpu]
"""

from __future__ import annotations

import os
import sys

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.examples import run_main


def build(frequency: float = 162.55e6) -> radio.CompositeBlock:
    tune_offset = -100e3
    deviation, bandwidth = 5e3, 4e3
    top = radio.CompositeBlock()
    source = radio.RtlSdrSource(frequency + tune_offset, 1102500)
    tuner = radio.TunerBlock(tune_offset, 2 * (deviation + bandwidth), 50)
    fm_demod = radio.FrequencyDiscriminatorBlock(deviation / bandwidth)
    af_filter = radio.LowpassFilterBlock(128, bandwidth)
    sink = (radio.PulseAudioSink(1) if os.environ.get("DISPLAY")
            else radio.WAVFileSink("nbfm.wav", 1))
    top.connect(source, tuner, fm_demod, af_filter, sink)
    return top


def main(argv=None) -> int:
    return run_main(build, argv)


if __name__ == "__main__":
    sys.exit(main())
