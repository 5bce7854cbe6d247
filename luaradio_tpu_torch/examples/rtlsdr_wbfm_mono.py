"""Wideband FM broadcast receiver (mono) from an RTL-SDR, to PulseAudio
(the JAX package's examples/rtlsdr_wbfm_mono.py; reference
examples/rtlsdr_wbfm_mono.lua): the source tuned 250 kHz below the
station -> Tuner -> WBFM mono demodulator -> Downsampler(5).

    python -m luaradio_tpu_torch.examples.rtlsdr_wbfm_mono [frequency] [--cpu]
"""

from __future__ import annotations

import sys

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.examples import run_main


def build(frequency: float = 88.5e6) -> radio.CompositeBlock:
    top = radio.CompositeBlock()
    source = radio.RtlSdrSource(frequency - 250e3, 1102500)  # offset-tuned
    tuner = radio.TunerBlock(-250e3, 200e3, 5)
    demod = radio.WBFMMonoDemodulator()
    downsampler = radio.DownsamplerBlock(5)
    sink = radio.PulseAudioSink(1)
    top.connect(source, tuner, demod, downsampler, sink)
    return top


def main(argv=None) -> int:
    return run_main(build, argv)


if __name__ == "__main__":
    sys.exit(main())
