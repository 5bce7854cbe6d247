"""The one generator of inputs: a broadcast FM multiplex at a receiver's
tune offset, quantized to an SDR's wire format, made on the device from a
seed.

The multiplex carries L+R audio, the 19 kHz pilot and L-R on a 38 kHz
subcarrier at 75 kHz deviation, plus complex Gaussian noise.  Every
frequency in it (the carrier, each audio tone, the pilot and the
subcarrier's sidebands) makes a whole number of cycles over the capture,
and the audio has zero mean, so the FM phase closes at the wrap: a capture
looped end to end is one seamless stream.  The FM phase is the exact
integral of the message (a sum of sinusoids), computed from integer cycle
counts modulo the capture length, so nothing accumulates rounding along
the capture.

What varies between mixes (capture length, noise, tones) comes from the
traffic file's ``signal`` group; the rate, tune offset and wire format
from the configuration.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

PILOT_HZ = 19e3
DEVIATION_HZ = 75e3


def decimations(rate: float, if_rate: float, af_rate: float) -> tuple:
    """(IF decimation, AF decimation) as rx_wbfm derives them from the
    input rate (rounding half up)."""
    if_ds = int(rate / if_rate + 0.5)
    af_ds = int(rate / if_ds / af_rate + 0.5)
    return if_ds, af_ds


def _period(freq_hz: float, rate: float) -> int:
    """Samples after which a tone of ``freq_hz`` at ``rate`` repeats."""
    return Fraction(freq_hz / rate).limit_denominator(1 << 24).denominator


def seamless_length(target: int, cfg: dict) -> int:
    """The capture length nearest ``target`` that a looped stream of the
    configuration repeats over exactly: a whole number of carrier and
    pilot cycles, and of the graph's total decimation (so the audio
    stream repeats too)."""
    rate = float(cfg["rate"])
    if_ds, af_ds = decimations(rate, cfg["if_rate"], cfg["af_rate"])
    unit = math.lcm(if_ds * af_ds, _period(-cfg["tune_offset"], rate),
                    _period(PILOT_HZ, rate))
    return max(1, round(target / unit)) * unit


def components(rng: np.random.Generator, n: int, rate: float,
               sig: dict) -> list:
    """The multiplex as (amplitude, cycles over the capture, phase) terms:
    m = 0.45 (L + R) + 0.1 pilot + 0.45 (L - R) cos(2 pilot), with L and R
    each a sum of ``tones`` sinusoids whose amplitudes sum to 1."""
    per_hz = n / rate                       # cycles over the capture a Hz
    lo, hi = sig["tone_band_hz"]
    k_lo, k_hi = math.ceil(lo * per_hz), math.floor(hi * per_hz)
    k_p = round(PILOT_HZ * per_hz)
    th_p = float(rng.uniform(0, 2 * np.pi))
    terms = [(0.1, k_p, th_p)]
    for sign in (1.0, -1.0):                # L, then R
        amps = rng.dirichlet(np.ones(sig["tones"]))
        ks = rng.integers(k_lo, k_hi + 1, size=sig["tones"])
        ths = rng.uniform(0, 2 * np.pi, size=sig["tones"])
        for a, k, th in zip(amps, ks, ths):
            a, k, th = float(a), int(k), float(th)
            terms.append((0.45 * a, k, th))                  # (L+R)/2
            # (L-R)/2 cos(2 pilot): two sidebands around 38 kHz
            terms.append((sign * 0.225 * a, 2 * k_p + k, 2 * th_p + th))
            terms.append((sign * 0.225 * a, 2 * k_p - k, 2 * th_p - th))
    return terms


def _cycles(k: int, idx: torch.Tensor, n: int) -> torch.Tensor:
    """2 pi k idx / n, exactly periodic over n (integer arithmetic)."""
    return ((k * idx) % n).to(torch.float64) * (2 * np.pi / n)


def quantize(iq: torch.Tensor, wire: str) -> torch.Tensor:
    """Complex samples -> interleaved wire items as an SDR writes them
    (u8: 127.5 + 127.5 v; s8: 127.5 v), rounded and clipped."""
    v = torch.view_as_real(iq).reshape(iq.shape[:-1] + (-1,))
    if wire == "u8":
        return torch.clamp(torch.round(127.5 + 127.5 * v), 0, 255
                           ).to(torch.uint8)
    if wire == "s8":
        return torch.clamp(torch.round(127.5 * v), -128, 127).to(torch.int8)
    raise ValueError(f"unsupported wire format {wire!r}")


def baseband(seed: int, n: int, cfg: dict, sig: dict, device,
             idx: torch.Tensor | None = None) -> tuple:
    """(the station's noiseless complex baseband at sample indices
    ``idx`` (default 0 .. n-1) of a capture of ``n`` samples, the numpy
    generator the noise is drawn from next)."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    rate = float(cfg["rate"])
    terms = components(rng, n, rate, sig)
    if idx is None:
        idx = torch.arange(n, dtype=torch.int64, device=device)
    phi = torch.zeros(idx.shape, dtype=torch.float64, device=device)
    for amp, k, th in terms:
        # the exact integral of amp cos(2 pi k t / T + th) times the
        # deviation, in radians of carrier phase
        phi += (DEVIATION_HZ * amp * n / (k * rate)) * torch.sin(
            _cycles(k, idx, n) + th)
    k_c = round(-cfg["tune_offset"] * n / rate)    # the station's carrier
    phi += _cycles(k_c, idx, n)
    return sig["carrier_amplitude"] * torch.polar(torch.ones_like(phi),
                                                  phi), rng


def capture(seed: int, n: int, cfg: dict, sig: dict,
            device) -> torch.Tensor:
    """One station's capture of ``n`` samples as wire items [2 n] on
    ``device``: the seed picks the tones, their phases and the noise."""
    iq, rng = baseband(seed, n, cfg, sig, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 1 << 62)))
    noise = torch.randn((n, 2), generator=gen, dtype=torch.float64,
                        device=device) * sig["noise_sigma"]
    iq = iq + torch.view_as_complex(noise)
    return quantize(iq, cfg["wire"])


def row_seed(seed: int, row: int) -> int:
    """The seed of row ``row`` of a bank made from ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), row])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


__all__ = ["decimations", "seamless_length", "components", "quantize",
           "baseband", "capture", "row_seed", "PILOT_HZ", "DEVIATION_HZ"]
