"""SSB modulator: WAV file in, f32le IQ file out (the JAX package's
examples/wavfile_ssb_modulator.py and the reference's
examples/wavfile_ssb_modulator.lua, on the port):

    WAV -> 128-tap lowpass -> 129-tap Hilbert transform -> [conjugate for
    lsb] -> 129-tap complex bandpass -> IQ file

Run:

    python -m luaradio_tpu_torch.examples.wavfile_ssb_modulator \\
        <wav in> <iq out> <bandwidth> <usb|lsb> [--cpu]

The IQ file is at the WAV's sample rate, the sideband at baseband.
"""

from __future__ import annotations

import sys

import luaradio_tpu_torch as radio


def build(wav_path: str, iq_path: str, bandwidth: float,
          sideband: str) -> radio.CompositeBlock:
    """The modulator's flow graph."""
    if sideband not in ("usb", "lsb"):
        raise ValueError("sideband should be 'usb' or 'lsb'")
    top = radio.CompositeBlock()
    source = radio.WAVFileSource(wav_path, 1)
    af_filter = radio.LowpassFilterBlock(128, bandwidth)
    hilbert = radio.HilbertTransformBlock(129)
    sb_filter = radio.ComplexBandpassFilterBlock(
        129, (-bandwidth, 0) if sideband == "lsb" else (0, bandwidth))
    sink = radio.IQFileSink(iq_path, "f32le")
    if sideband == "lsb":
        top.connect(source, af_filter, hilbert,
                    radio.ComplexConjugateBlock(), sb_filter, sink)
    else:
        top.connect(source, af_filter, hilbert, sb_filter, sink)
    return top


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    args = [a for a in argv if a != "--cpu"]
    if len(args) < 4:
        print("Usage: python -m luaradio_tpu_torch.examples."
              "wavfile_ssb_modulator <WAV in> <IQ f32le out> <bandwidth> "
              "<usb|lsb> [--cpu]", file=sys.stderr)
        return 1
    build(args[0], args[1], float(args[2]), args[3]).run(device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
