"""The plain reference of configuration ``fmband100_hackrf``: the whole US
FM band from one wideband capture, split into its C channels and each
channel demodulated as rx_wbfm --mono demodulates one (vsergeev/luaradio
v0.11.0 radio/applications/rx_wbfm.lua, wbfmmonodemodulator.lua; the
pieces of reference/wbfm.py), and the arithmetic the channelizer needs
(its roofline's operations and bytes).

The channelizer is written by its definition, channel by channel, not by
the polyphase and FFT identity the program uses.  Channel c, in FFT order
(c above C / 2 are the negative offsets, so c = C / 2 is the band's lower
edge), is:

1. the capture shifted by -c rate / C (reference/dsp.py ``translate``, the
   phase reduced exactly);
2. filtered by the prototype lowpass: C q taps, Hamming window, cutoff
   rate / (2 C), unit gain at DC (reference/dsp.py ``lowpass_taps``),
   causal from zero history;
3. cut to every C-th sample, from the first.

Each channel's stream at rate / C then runs the mono chain: the
discriminator, the 15 kHz lowpass and the 75 us deemphasis (one LTI
chain, the deemphasis's impulse response cut below 1e-18 of its peak as
reference/wbfm.py cuts it) and the downsampler.  Plain PyTorch and NumPy,
float64 (``"tf32"``: the control, reference/dsp.py), TF32 off; nothing of
the program.  Departures from the definition: none in what is computed;
the filters run as blockwise FFT convolutions (reference/dsp.py ``fir``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from radiobench import synth
from radiobench.reference import dsp, wbfm


def plan(cfg: dict) -> dict:
    """The band's rates, decimations and designed taps: one channel a
    rate / C slice (``if_ds`` = C), the audio decimation by rx_wbfm's
    rule from the channel's rate (``af_ds``)."""
    rate = float(cfg["rate"])
    c = int(cfg["channels"])
    if_ds, af_ds = synth.decimations(rate, cfg["if_rate"], cfg["af_rate"])
    if if_ds != c:
        raise ValueError(f"if_rate gives a decimation of {if_ds}, not the "
                         f"{c} channels")
    if_rate = rate / c
    b, a = dsp.singlepole_lowpass_ba(1.0 / (2 * np.pi * cfg["tau"]),
                                     if_rate)
    return {
        "rate": rate, "channels": c, "if_ds": c, "af_ds": af_ds,
        "if_rate": if_rate,
        "prototype": dsp.lowpass_taps(c * int(cfg["taps_per_branch"]),
                                      1.0 / c),
        "af": dsp.lowpass_taps(wbfm.AF_TAPS, wbfm.AF_BANDWIDTH
                               / (if_rate / 2)),
        "deemphasis": dsp.iir_impulse(b, a),
    }


def channel(x: torch.Tensor, c: int, p: dict, precision: str
            ) -> torch.Tensor:
    """Channel ``c`` of the complex capture ``x`` [n] by the definition:
    shifted by -c rate / C, lowpassed, every C-th sample kept."""
    y = dsp.translate(x, -c * p["rate"] / p["channels"], p["rate"])
    return dsp.fir(y, p["prototype"], precision, p["channels"])


def audio(raw: torch.Tensor, cfg: dict, precision: str = "float64",
          periods: int = 2, quadrature: bool = False) -> torch.Tensor:
    """Every channel's audio over the capture played ``periods`` times
    from zero state: raw [1, 2 n] -> [C, 1, periods n / (C af_ds)],
    channel by channel.  ``quadrature`` is for stereo and is ignored."""
    del quadrature
    p = plan(cfg)
    af = np.convolve(p["af"], p["deemphasis"])
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = dsp.wire_to_complex(raw[0], cfg["wire"], precision)
        x = x.repeat(periods)
        out = []
        for c in range(p["channels"]):
            d = dsp.discriminate(channel(x, c, p, precision),
                                 wbfm.MODULATION_INDEX)
            out.append(dsp.fir(d, af, precision, p["af_ds"]))
        return torch.stack(out)[:, None]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def channelizer_work(cfg: dict) -> dict:
    """Floating-point operations and unavoidable bytes of the channelizer
    a wideband input sample, whatever implements it: each input sample
    meets q taps of its polyphase branch (a complex sample by a real tap,
    a multiply-add: 4 operations), a length-C DFT across the branches a
    C samples (5 C log2 C operations, the radix-2 count) and a complex
    output scaled by a real (2).  Bytes: the complex64 sample read once
    and the complex64 channel sample written once (critically sampled:
    one out a sample in)."""
    c, q = int(cfg["channels"]), int(cfg["taps_per_branch"])
    return {"flops": 4.0 * q + 5.0 * math.log2(c) + 2.0, "bytes": 16.0}


def work(cfg: dict) -> dict:
    """Floating-point operations and bytes the whole graph needs a wideband
    input sample (reference/wbfm.py ``work``'s counting): the channelizer,
    then over all channels one IF sample a wideband sample, each through
    the discriminator and, at the audio samples kept, the AF lowpass and
    the deemphasis.  Bytes: the s8 wire items in and the float32 audio
    out."""
    p = plan(cfg)
    per_af = 1.0 / p["af_ds"]               # audio samples an input sample
    flops = channelizer_work(cfg)["flops"]
    flops += 6 + 1 + 1                       # discriminator
    flops += (2 * wbfm.AF_TAPS + 3) * per_af
    return {"flops": flops, "bytes": 2.0 + 4.0 * per_af}


__all__ = ["plan", "channel", "audio", "channelizer_work", "work"]
