"""The plain reference of configuration ``amband117_rtlsdr``: the whole US
AM broadcast band from one wideband capture, split into its C channels,
each channel demodulated as rx_am --synchronous demodulates one
(vsergeev/luaradio v0.11.0 radio/applications/rx_am.lua,
amsynchronousdemodulator.lua, pll.lua, singlepolehighpassfilter.lua), and
the arithmetic the graph needs a sample.

Channel c, in FFT order, is cut by the channelizer's definition
(reference/fmband100_hackrf.py ``channel``: the capture shifted by
-c rate / C, the C q-tap prototype lowpass, every C-th sample kept).  Each
channel's stream at rate / C then runs the synchronous demodulator:

1. the 129-tap complex bandpass over the carrier +- bandwidth
   (reference/dsp.py ``complex_bandpass_taps``);
2. upstream's second-order carrier loop, PLLBlock(1000, -100, 100) at
   multiplier 1, walked sample by sample (:func:`pll_rows`, the loop of
   reference/dsp.py ``pll``): its oscillator exp(j phi[n]), recorded
   before the step, is the one the mixer conjugates;
3. Re(bandpassed x conj(oscillator));
4. the 100 Hz single-pole highpass (upstream's bilinear coefficients,
   b = (1, -1) / (1 + k), a = (1, (k - 1) / (1 + k)), k = tan(pi 100 /
   rate)) and the 128-tap AF lowpass at the bandwidth: one LTI chain,
   the highpass as its impulse response cut below 1e-18 of its peak
   (reference/dsp.py ``iir_impulse``).

Plain PyTorch and NumPy, float64 (``"tf32"``: the control,
reference/dsp.py), TF32 off; nothing of the program.  Departures from
upstream: the filters run as blockwise FFT convolutions
(reference/dsp.py ``fir``); the loop's phase error is wrap(arg x -
phi), which upstream computes as arg(x conj(exp(j phi))), the same
number up to the last bits; the loop walks all C channels at once, one
sample a step, each row exactly as alone.  rx_am's trailing AGC and its
AF downsampler are not in the configuration (its ``reduced`` and
``assumed``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from radiobench.reference import dsp, fmband100_hackrf

#: upstream amsynchronousdemodulator.lua's taps, loop and DC block
BANDPASS_TAPS = 129
AF_TAPS = 128
LOOP_BANDWIDTH = 1000.0
LOOP_SPAN = 100.0
DC_CUTOFF = 100.0
IFREQ = 0.0


def plan(cfg: dict) -> dict:
    """The band's rates, decimations, designed taps and loop constants: one
    channel a rate / C slice (``if_ds`` = C), no AF decimation
    (``af_ds`` 1)."""
    rate = float(cfg["rate"])
    c = int(cfg["channels"])
    if_ds = int(rate / cfg["if_rate"] + 0.5)
    af_ds = int(cfg["if_rate"] / cfg["af_rate"] + 0.5)
    if if_ds != c or af_ds != 1:
        raise ValueError(f"if_rate and af_rate give decimations {if_ds}, "
                         f"{af_ds}, not the {c} channels and 1")
    if_rate = rate / c
    nyq = if_rate / 2
    bw = float(cfg["bandwidth"])
    k = math.tan(math.pi * DC_CUTOFF / if_rate)
    dc = dsp.iir_impulse(np.array([1 / (1 + k), -1 / (1 + k)]),
                         np.array([1.0, (k - 1) / (1 + k)]))
    return {
        "rate": rate, "channels": c, "if_ds": c, "af_ds": 1,
        "if_rate": if_rate,
        "prototype": dsp.lowpass_taps(c * int(cfg["taps_per_branch"]),
                                      1.0 / c),
        "bandpass": dsp.complex_bandpass_taps(
            BANDPASS_TAPS, (IFREQ - bw) / nyq, (IFREQ + bw) / nyq),
        "loop": dsp.pll_constants(LOOP_BANDWIDTH, IFREQ - LOOP_SPAN,
                                  IFREQ + LOOP_SPAN, if_rate),
        "af": np.convolve(dc, dsp.lowpass_taps(AF_TAPS, bw / nyq)),
    }


def pll_rows(x: torch.Tensor, k: dict, precision: str,
             settle: int = 0) -> tuple[torch.Tensor, float]:
    """(each row's oscillator exp(j phi[n]) [C, n], the largest |err| over
    every row after the first ``settle`` samples) of upstream's loop over
    the rows of x [C, n], all rows a step:

        err    = wrap(arg x[n] - phi)            (arg 0 where x[n] = 0)
        freq  += beta err
        phi   += freq + alpha err                (the pre-clamp freq)
        freq   = clamp(freq, fmin, fmax)
        phi    = wrap(phi)

    phi recorded before its step; phi starts at 0 and freq at the middle
    of its range (reference/dsp.py ``pll`` at multiplier 1)."""
    theta = torch.atan2(x.imag, x.real)
    theta = torch.where(x == 0, torch.zeros_like(theta), theta)
    dt = np.float64 if precision == "float64" else np.float32
    th = np.ascontiguousarray(theta.cpu().numpy().astype(dt).T)   # [n, C]
    f = dt
    two_pi, pi = f(2 * math.pi), f(math.pi)
    alpha, beta = f(k["alpha"]), f(k["beta"])
    fmin, fmax = f(k["fmin"]), f(k["fmax"])
    rows = th.shape[1]
    phi = np.zeros(rows, dt)
    freq = np.full(rows, (fmin + fmax) / f(2), dt)
    e = np.empty(rows, dt)
    worst = np.zeros(rows, dt)
    out = np.empty_like(th)
    for i in range(th.shape[0]):
        out[i] = phi
        np.subtract(th[i], phi, out=e)
        e -= two_pi * (e > pi)
        e += two_pi * (e < -pi)
        freq += beta * e
        phi += freq
        phi += alpha * e
        np.clip(freq, fmin, fmax, out=freq)
        phi -= two_pi * (phi > pi)
        phi += two_pi * (phi < -pi)
        if i >= settle:
            np.maximum(worst, np.abs(e), out=worst)
    ph = torch.from_numpy(np.ascontiguousarray(out.T)).to(x.device)
    osc = torch.polar(torch.ones_like(ph), ph).to(x.dtype)
    return osc, float(worst.max())


def audio(raw: torch.Tensor, cfg: dict, precision: str = "float64",
          periods: int = 2, quadrature: bool = False) -> torch.Tensor:
    """Every channel's audio over the capture played ``periods`` times
    from zero state: raw [1, 2 n] -> [C, 1, periods n / C].
    ``quadrature`` is for stereo and is ignored."""
    del quadrature
    return demodulate(raw, cfg, precision, periods)[0]


def demodulate(raw: torch.Tensor, cfg: dict, precision: str = "float64",
               periods: int = 2, settle: int = 0) -> tuple:
    """(:func:`audio`'s [C, 1, m], the loop's largest |err| after
    ``settle`` channel samples)."""
    p = plan(cfg)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = dsp.wire_to_complex(raw[0], cfg["wire"], precision)
        x = x.repeat(periods)
        bp = torch.stack([
            dsp.fir(fmband100_hackrf.channel(x, c, p, precision),
                    p["bandpass"], precision)
            for c in range(p["channels"])])
        del x
        osc, worst = pll_rows(bp, p["loop"], precision, settle)
        y = (bp * osc.conj()).real
        return dsp.fir(y, p["af"], precision)[:, None], worst
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def pll_work(cfg: dict) -> dict:
    """Floating-point operations and unavoidable bytes of the carrier loop
    a channel sample, whatever implements it: the phase detector (an
    atan2, ~20 operations, and the wrap, 2), the loop filter and phase
    step (5), the clamp and the wrap of phi (4) and the oscillator (a
    sincos, ~20).  Bytes: the complex64 sample read once and the complex64
    oscillator written once."""
    del cfg
    return {"flops": 51.0, "bytes": 16.0}


def work(cfg: dict) -> dict:
    """Floating-point operations and bytes the whole graph needs a wideband
    input sample (reference/wbfm.py ``work``'s counting): the channelizer
    (reference/fmband100_hackrf.py ``channelizer_work``), then over all
    channels one channel sample a wideband sample, each through the
    complex bandpass (a complex sample by a complex tap: 8 a tap), the
    loop, the conjugate mix's real part (2), the DC block (4) and the AF
    lowpass (2 a tap).  Bytes: the u8 wire items in and the float32
    audio out."""
    flops = fmband100_hackrf.channelizer_work(cfg)["flops"] \
        + pll_work(cfg)["flops"]
    flops += 8 * BANDPASS_TAPS + 2 + 4 + 2 * AF_TAPS
    return {"flops": flops, "bytes": 2.0 + 4.0}


__all__ = ["plan", "pll_rows", "audio", "demodulate", "pll_work", "work"]
