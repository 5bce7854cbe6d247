"""Wideband capture -> polyphase channelizer -> banked FM demodulation
through the ordinary flow-graph API (the JAX package's
examples/wideband_channelizer_bank.py): ChannelizerBlock splits a
16-channel slice of spectrum in one pass, and the [16, time] batch flows
through one WBFMMonoDemodulator and a Downsampler(2) into a sink that
keeps the 16 audio streams.

    python -m luaradio_tpu_torch.examples.wideband_channelizer_bank \\
        [<iq file> <rate>] [--cpu]

With no file, a synthesized capture of FM carriers on channels 1, 3, 7
and 12 (in a temporary directory).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.core.block import Input, SinkBlock

CHANNELS = 16
RATE = 4.096e6


class AudioBankSink(SinkBlock):
    """Collects the [C, time] audio bank (per-channel sinks' stand-in)."""

    def __init__(self):
        super().__init__()
        self.chunks = []
        self.add_type_signature([Input("in", lambda t: True)], [])

    def process(self, x):
        self.chunks.append(np.asarray(x))


def synth_capture(path, n=1 << 18, rate=RATE, channels=CHANNELS):
    """FM carriers (75 kHz deviation, a tone each) on a 16-channel grid."""
    t = np.arange(n) / rate
    x = np.zeros(n, np.complex128)
    rng = np.random.default_rng(0)
    for c in (1, 3, 7, 12):
        tone = 400.0 * (c + 1)
        m = np.sin(2 * np.pi * tone * t)
        phase = 2 * np.pi * 75e3 * np.cumsum(m) / rate
        x += np.exp(1j * (2 * np.pi * (c * rate / channels) * t + phase))
    x += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x.astype(np.complex64).tofile(path)


def build(path: str, rate: float = RATE, channels: int = CHANNELS):
    """(the flow graph, its audio sink)."""
    top = radio.CompositeBlock()
    sink = AudioBankSink()
    top.connect(radio.IQFileSource(path, "f32le", rate),
                radio.ChannelizerBlock(channels, taps_per_branch=8),
                radio.WBFMMonoDemodulator(), radio.DownsamplerBlock(2), sink)
    return top, sink


def run(path: str, rate: float = RATE, channels: int = CHANNELS,
        device=None) -> np.ndarray:
    """The audio bank [channels, time] of the capture at ``path``."""
    top, sink = build(path, rate, channels)
    top.run(chunk_size=channels * 16384, device=device)
    return np.concatenate(sink.chunks, axis=-1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    args = [a for a in argv if a != "--cpu"]
    with tempfile.TemporaryDirectory(prefix="wideband_") as tmp:
        if len(args) >= 2:
            path, rate = args[0], float(args[1])
        else:
            path, rate = os.path.join(tmp, "wideband.iq"), RATE
            synth_capture(path, rate=rate)
        audio = run(path, rate, device=device)
    print(f"demodulated {audio.shape[0]} channels x {audio.shape[1]} "
          f"samples at {rate / CHANNELS / 2 / 1e3:.1f} kHz audio rate")
    rms = np.sqrt((audio ** 2).mean(axis=-1))
    for c in np.argsort(rms)[::-1][:4]:
        print(f"  channel {c:2d}: rms {rms[c]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
