"""FM round-trip self test: tone in == tone out, end to end through files
(the JAX package's examples/fm_roundtrip_selftest.py, on the port).

Stage 1 modulates a cosine tone onto FM and captures it to an IQ file;
stage 2 demodulates that capture back to audio through the mono chain
(discriminator -> lowpass -> deemphasis -> downsampler, the chain of the
reference's examples/rtlsdr_wbfm_mono.lua) and checks that the audio's
spectral peak lands on the tone within 50 Hz.  Run with no arguments:

    python -m luaradio_tpu_torch.examples.fm_roundtrip_selftest [--cpu]

``--cpu`` runs the plain PyTorch path; by default it runs on the CUDA
card.  The peak bin is ``argmax(spec[1:]) + 1``: the search skips the DC
bin, so its index is one less than the bin's (the JAX example reports
the peak one bin low).
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import wave

import numpy as np

from luaradio_tpu_torch import (CompositeBlock, DownsamplerBlock,
                                FMDeemphasisFilterBlock,
                                FrequencyDiscriminatorBlock,
                                FrequencyModulatorBlock, IQFileSink,
                                IQFileSource, LowpassFilterBlock,
                                SignalSource, WAVFileSink)

TONE_HZ = 3000.0
RATE = 256e3
DEVIATION = 0.3
CHUNKS = 6
LIMIT_HZ = 50.0


def modulate(path: str, chunks: int = CHUNKS, chunk_size=None, device=None):
    """Stage 1: tone -> FM -> IQ capture (f32le) of ``chunks`` chunks."""
    top = CompositeBlock()
    top.connect(SignalSource("cosine", TONE_HZ, rate=RATE),
                FrequencyModulatorBlock(DEVIATION),
                IQFileSink(path, "f32le"))
    top.run(max_chunks=chunks, chunk_size=chunk_size, device=device)


def mono_chain() -> list:
    """The demodulator's blocks: discriminator -> 10 kHz lowpass ->
    deemphasis -> downsampler by 8."""
    return [FrequencyDiscriminatorBlock(DEVIATION),
            LowpassFilterBlock(128, 10e3),
            FMDeemphasisFilterBlock(75e-6),
            DownsamplerBlock(8)]


def demodulate(capture: str, wav: str, chunk_size=None, device=None):
    """Stage 2: IQ capture -> mono FM demodulator -> 16-bit WAV at
    RATE / 8."""
    top = CompositeBlock()
    top.connect(IQFileSource(capture, "f32le", RATE), *mono_chain(),
                WAVFileSink(wav, 1))
    top.run(chunk_size=chunk_size, device=device)


def read_audio(wav: str):
    """(int16 samples as float64, sample rate) of a mono WAV."""
    with wave.open(wav) as w:
        n, sr = w.getnframes(), w.getframerate()
        audio = np.frombuffer(w.readframes(n), dtype=np.int16)
    return audio.astype(np.float64), sr


def peak_hz(audio: np.ndarray, sr: int) -> float:
    """The spectral peak of the audio after its first quarter (the
    filters' start-up), over a power-of-two Hann window, DC skipped."""
    audio = audio[len(audio) // 4:]
    win = audio[:1 << int(math.log2(len(audio)))]
    spec = np.abs(np.fft.rfft(win * np.hanning(len(win))))
    return float((np.argmax(spec[1:]) + 1) * sr / len(win))


def run(tmp: str, chunks: int = CHUNKS, chunk_size=None, device=None):
    """Both stages in ``tmp``; returns (peak Hz, audio, audio rate)."""
    capture = os.path.join(tmp, "capture.iq")
    wav = os.path.join(tmp, "audio.wav")
    modulate(capture, chunks, chunk_size, device)
    demodulate(capture, wav, chunk_size, device)
    audio, sr = read_audio(wav)
    return peak_hz(audio, sr), audio, sr


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    with tempfile.TemporaryDirectory(prefix="fm_roundtrip_") as tmp:
        peak, audio, sr = run(tmp, device=device)
    print(f"audio {sr} Hz, {len(audio)} frames; spectral peak {peak:.1f} Hz "
          f"(expected {TONE_HZ:.0f} Hz)")
    if abs(peak - TONE_HZ) > LIMIT_HZ:
        print(f"FAIL: demodulated tone off by > {LIMIT_HZ:.0f} Hz")
        return 1
    print("OK: tone in == tone out")
    return 0


if __name__ == "__main__":
    sys.exit(main())
