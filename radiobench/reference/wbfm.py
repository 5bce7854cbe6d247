"""The plain reference of rx_wbfm (vsergeev/luaradio v0.11.0
radio/applications/rx_wbfm.lua and the blocks it builds: tuner.lua,
wbfmmonodemodulator.lua, wbfmstereodemodulator.lua), mono and stereo, and
the arithmetic the chain needs (its roofline's operations and bytes).

``audio`` takes the wire items of captures [rows, 2 n], plays each capture
``periods`` times in a row from the receiver's zero state, and returns the
audio the receiver emits over that stream [rows, channels, periods n /
D] (D the total decimation): the stream every run of the benchmark
starts with.
"""

from __future__ import annotations

import numpy as np
import torch

from radiobench import synth
from radiobench.reference import dsp

TUNER_TAPS = 128
AF_TAPS = 128
AF_BANDWIDTH = 15e3
MODULATION_INDEX = 1.25
HILBERT_TAPS = 129
PILOT_TAPS = 129
PILOT_BAND = (18e3, 20e3)
PLL_BANDWIDTH = 100.0
PLL_SPAN = 50.0


def plan(cfg: dict) -> dict:
    """The graph's rates, decimations and designed taps, as rx_wbfm
    derives them from the input rate."""
    rate = float(cfg["rate"])
    if_ds, af_ds = synth.decimations(rate, cfg["if_rate"], cfg["af_rate"])
    if_rate = rate / if_ds
    b, a = dsp.singlepole_lowpass_ba(1.0 / (2 * np.pi * cfg["tau"]),
                                     if_rate)
    return {
        "rate": rate, "if_ds": if_ds, "af_ds": af_ds, "if_rate": if_rate,
        "tuner": dsp.lowpass_taps(TUNER_TAPS, (cfg["tuner_bandwidth"] / 2)
                                  / (rate / 2)),
        "af": dsp.lowpass_taps(AF_TAPS, AF_BANDWIDTH / (if_rate / 2)),
        "deemphasis": dsp.iir_impulse(b, a),
        "hilbert": dsp.hilbert_taps(HILBERT_TAPS),
        "pilot": dsp.complex_bandpass_taps(
            PILOT_TAPS, PILOT_BAND[0] / (if_rate / 2),
            PILOT_BAND[1] / (if_rate / 2)),
        "pll": dsp.pll_constants(PLL_BANDWIDTH, synth.PILOT_HZ - PLL_SPAN,
                                 synth.PILOT_HZ + PLL_SPAN, if_rate),
    }


def _row(raw: torch.Tensor, cfg: dict, p: dict, precision: str,
         periods: int, quadrature: bool) -> torch.Tensor:
    """One capture's audio [channels, periods n / D] (stereo with
    ``quadrature``: a third row, the L-R path's quadrature component, and
    a fourth, the 38 kHz carrier's offset phi_m - 2 phi at each audio
    sample)."""
    x = dsp.wire_to_complex(raw, cfg["wire"], precision)
    x = x.repeat(periods)
    x = dsp.translate(x, cfg["tune_offset"], p["rate"])
    x = dsp.fir(x, p["tuner"], precision, p["if_ds"])          # the tuner
    d = dsp.discriminate(x, MODULATION_INDEX)
    del x
    # AF lowpass, deemphasis and the downsampler: one LTI chain
    af = np.convolve(p["af"], p["deemphasis"])
    if cfg["mono"]:
        return dsp.fir(d, af, precision, p["af_ds"])[None]
    c = (HILBERT_TAPS - 1) // 2
    analytic = torch.complex(dsp.delay(d, c), dsp.fir(d, p["hilbert"],
                                                      precision))
    del d
    pilot = dsp.fir(analytic, p["pilot"], precision)
    sub, offset = dsp.pll(pilot, p["pll"], 2, precision)   # 38 kHz carrier
    del pilot
    sig = dsp.delay(analytic, (PILOT_TAPS - 1) // 2)
    del analytic
    lpr = sig.real
    mixed = sig * sub.conj()
    del sig, sub
    lmr = mixed.real
    out = [dsp.fir(lpr + lmr, af, precision, p["af_ds"]),
           dsp.fir(lpr - lmr, af, precision, p["af_ds"])]
    if quadrature:
        out.append(dsp.fir(mixed.imag, af, precision, p["af_ds"]))
        n = out[0].shape[-1]
        out.append(offset[::p["af_ds"]][:n].to(out[0].dtype))
    return torch.stack(out)


def audio(raw: torch.Tensor, cfg: dict, precision: str = "float64",
          periods: int = 2, quadrature: bool = False) -> torch.Tensor:
    """The receiver's audio over each capture played ``periods`` times:
    raw [rows, 2 n] -> [rows, channels, periods n / D], row by row.

    With ``quadrature`` a stereo row gets two more signals: the L-R path
    with its 38 kHz carrier a quarter cycle on, Q = LPF(Im(s conj(o))),
    and the carrier's offset phi_m - 2 phi.  The multiplied oscillator's
    phase has a direction the loop does not restore (the PLL's phi_m -
    2 phi drifts by -alpha err a step and keeps what the acquisition's
    clamped steps left in it: upstream's pll.lua does the same), so a
    receiver that rounds otherwise demodulates L-R with its carrier a
    constant angle c away, cos(c) (L-R) + sin(c) Q, and c is the gap
    between the two receivers' offsets (radiobench/judge.py)."""
    p = plan(cfg)
    return torch.stack([_row(r, cfg, p, precision, periods, quadrature)
                        for r in raw])


def work(cfg: dict) -> dict:
    """Floating-point operations and bytes the chain needs a complex input
    sample, counting the outputs it computes (the decimating filters only
    at the samples they keep), whatever implements them: a multiply-add is
    2 operations, a complex product by a real tap 4, by a complex one 8;
    atan2 is counted as 1.  Bytes: the wire items in and the float32
    audio out."""
    p = plan(cfg)
    per_if = 1.0 / p["if_ds"]                   # IF samples an input sample
    per_af = per_if / p["af_ds"]                # audio samples one
    flops = 6.0                                 # translator
    flops += 4 * TUNER_TAPS * per_if            # tuner FIR, kept outputs
    flops += (6 + 1 + 1) * per_if               # discriminator
    # each channel's AF lowpass at the outputs the downsampler keeps and
    # its first-order deemphasis (3 operations a sample)
    channel = (2 * AF_TAPS + 3) * per_af
    channels = 1 if cfg["mono"] else 2
    if cfg["mono"]:
        flops += channel
    else:
        flops += per_if * (2 * HILBERT_TAPS     # Hilbert FIR (real input)
                           + 8 * PILOT_TAPS     # complex pilot bandpass
                           + 20                 # the PLL's step
                           + 6)                 # the mixer
        flops += 2 * channel + 2 * per_af       # L+R, L-R; sum, difference
    wire_bytes = 2.0                            # I and Q, 1 byte each
    audio_bytes = 4.0 * channels * per_af
    return {"flops": flops, "bytes": wire_bytes + audio_bytes}


__all__ = ["plan", "audio", "work"]
