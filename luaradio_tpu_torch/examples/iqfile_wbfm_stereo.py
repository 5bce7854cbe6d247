"""Wideband FM broadcast receiver (stereo) from an IQ capture file, to a
two-channel WAV (the JAX package's examples/iqfile_wbfm_stereo.py; the
reference's examples/rtlsdr_wbfm_stereo.lua with a recorded capture in
the radio's place): the f32le capture at 1 102 500 S/s, its station
250 kHz above the capture's centre -> Tuner -> WBFM stereo demodulator ->
Downsampler(5) on each channel -> WAV.

    python -m luaradio_tpu_torch.examples.iqfile_wbfm_stereo \\
        [capture.iq [out.wav]] [--cpu]
"""

from __future__ import annotations

import sys

import luaradio_tpu_torch as radio

RATE = 1102500


def build(capture: str = "capture.iq",
          out: str = "out.wav") -> radio.CompositeBlock:
    top = radio.CompositeBlock()
    source = radio.IQFileSource(capture, "f32le", RATE)
    tuner = radio.TunerBlock(-250e3, 200e3, 5)
    demod = radio.WBFMStereoDemodulator()
    l_downsampler = radio.DownsamplerBlock(5)
    r_downsampler = radio.DownsamplerBlock(5)
    sink = radio.WAVFileSink(out, 2)
    top.connect(source, tuner, demod)
    top.connect(demod, "left", l_downsampler, "in")
    top.connect(demod, "right", r_downsampler, "in")
    top.connect(l_downsampler, "out", sink, "in1")
    top.connect(r_downsampler, "out", sink, "in2")
    return top


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    args = [a for a in argv if a != "--cpu"]
    build(*args[:2]).run(device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
