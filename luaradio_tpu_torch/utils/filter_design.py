"""FIR filter design: windowed-sinc prototypes, translated complex band
filters, root-raised-cosine, and Hilbert transform taps.

Covers the same design surface as the reference's filter utilities
(radio/utilities/filter_utils.lua:152-376): lowpass /
highpass / bandpass / bandstop windowed-sinc designs normalized at a scale
frequency, complex translated band filters, RRC matched filter, and the
windowed 2/(pi*n) Hilbert transformer.  Formulas are the standard textbook
ones (equivalently scipy.signal.firwin/firwin2 family); everything is
designed in float64 on the host and handed to kernels as float32.

Frequency convention: cutoffs are normalized to the Nyquist frequency
(1.0 == rate/2), like scipy.
"""

from __future__ import annotations

import numpy as np

from luaradio_tpu_torch.utils.window import window as make_window


def _sinc(x: np.ndarray) -> np.ndarray:
    return np.sinc(x)  # sin(pi x)/(pi x)


def _scale_at(h: np.ndarray, freq: float) -> np.ndarray:
    """Normalize taps to unit magnitude response at normalized freq
    (1.0 = Nyquist).  Reference normalizes designs at a scale frequency
    (filter_utils.lua:121-141)."""
    n = np.arange(len(h)) - (len(h) - 1) / 2.0
    resp = np.sum(h * np.exp(-1j * np.pi * freq * n))
    return h / np.abs(resp)


def firwin_lowpass(num_taps: int, cutoff: float,
                   window_type: str = "hamming") -> np.ndarray:
    """Windowed-sinc lowpass; unity gain at DC."""
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = cutoff * _sinc(cutoff * n) * make_window(num_taps, window_type)
    return _scale_at(h, 0.0).real


def firwin_highpass(num_taps: int, cutoff: float,
                    window_type: str = "hamming") -> np.ndarray:
    """Windowed-sinc highpass via spectral inversion; unity gain at Nyquist.
    Requires odd tap count."""
    if num_taps % 2 == 0:
        raise ValueError("highpass design requires an odd number of taps")
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = -cutoff * _sinc(cutoff * n) * make_window(num_taps, window_type)
    h[(num_taps - 1) // 2] += 1.0
    return _scale_at(h, 1.0).real


def firwin_bandpass(num_taps: int, cutoffs: tuple[float, float],
                    window_type: str = "hamming") -> np.ndarray:
    """Windowed-sinc bandpass; unity gain at band center.  Odd taps."""
    if num_taps % 2 == 0:
        raise ValueError("bandpass design requires an odd number of taps")
    lo, hi = sorted(cutoffs)
    center = (lo + hi) / 2.0
    width = hi - lo
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    lp = (width / 2.0) * _sinc((width / 2.0) * n)
    h = 2.0 * lp * np.cos(np.pi * center * n) * make_window(num_taps, window_type)
    return _scale_at(h, center).real


def firwin_bandstop(num_taps: int, cutoffs: tuple[float, float],
                    window_type: str = "hamming") -> np.ndarray:
    """Windowed-sinc bandstop via spectral inversion; unity gain at DC."""
    if num_taps % 2 == 0:
        raise ValueError("bandstop design requires an odd number of taps")
    lo, hi = sorted(cutoffs)
    center = (lo + hi) / 2.0
    width = hi - lo
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    lp = (width / 2.0) * _sinc((width / 2.0) * n)
    h = -2.0 * lp * np.cos(np.pi * center * n) * make_window(num_taps, window_type)
    h[(num_taps - 1) // 2] += 1.0
    return _scale_at(h, 0.0).real


def firwin_complex_bandpass(num_taps: int, cutoffs: tuple[float, float],
                            window_type: str = "hamming") -> np.ndarray:
    """Frequency-translated complex bandpass (single-sided); cutoffs may be
    negative (range -1..1 of Nyquist).  Reference:
    filter_utils.lua:261-285."""
    lo, hi = cutoffs
    lo, hi = min(lo, hi), max(lo, hi)
    center = (lo + hi) / 2.0
    width = hi - lo
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    lp = (width / 2.0) * _sinc((width / 2.0) * n) * make_window(num_taps, window_type)
    lp = _scale_at(lp, 0.0).real
    return (lp * np.exp(1j * np.pi * center * n)).astype(np.complex128)


def firwin_complex_bandstop(num_taps: int, cutoffs: tuple[float, float],
                            window_type: str = "hamming") -> np.ndarray:
    """Complex bandstop: frequency-translated real HIGHPASS prototype,
    windowed, scaled to unity at DC or Nyquist — whichever lies outside
    the stopband (reference design, filter_utils.lua:278-285).  Verified
    against the reference's shipped golden vectors (tests/refparity); an
    earlier revision used spectral inversion of the complex bandpass,
    which drifts up to 5e-2 from this design."""
    if num_taps % 2 == 0:
        raise ValueError("bandstop design requires an odd number of taps")
    c1, c2 = cutoffs
    cu = (max(c1, c2) - min(c1, c2)) / 2.0       # highpass prototype cutoff
    center = (c1 + c2) / 2.0
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = -cu * _sinc(cu * m)
    h[(num_taps - 1) // 2] = 1.0 - cu
    hc = h * np.exp(1j * np.pi * center * m) * make_window(num_taps,
                                                           window_type)
    # scale at whichever of DC/Nyquist is in the passband
    scale_freq = 1.0 if (c1 < 0.0 < c2) or (c2 < 0.0 < c1) else 0.0
    resp = np.sum(hc * np.exp(-1j * np.pi * m * scale_freq))
    return (hc / resp).astype(np.complex128)


def fir_root_raised_cosine(num_taps: int, rate: float, beta: float,
                           symbol_period: float) -> np.ndarray:
    """Root-raised-cosine matched filter (beta = excess bandwidth, T = symbol
    period in seconds).  Standard closed form with singularity handling;
    reference: filter_utils.lua:301-337.  Normalized to unity DC gain."""
    if num_taps % 2 == 0:
        raise ValueError("RRC design requires an odd number of taps")
    h = np.zeros(num_taps, dtype=np.float64)
    T = symbol_period
    for i in range(num_taps):
        t = (i - (num_taps - 1) / 2.0) / rate
        if abs(t) < 1e-12:
            h[i] = (1.0 / T) * (1.0 + beta * (4.0 / np.pi - 1.0))
        elif beta > 0 and abs(abs(t) - T / (4.0 * beta)) < 1e-12:
            h[i] = (beta / (T * np.sqrt(2.0))) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta)))
        else:
            num = (np.sin(np.pi * (t / T) * (1.0 - beta))
                   + 4.0 * beta * (t / T) * np.cos(np.pi * (t / T) * (1.0 + beta)))
            den = np.pi * (t / T) * (1.0 - (4.0 * beta * t / T) ** 2)
            h[i] = (1.0 / T) * num / den
    return h / np.sum(h)


def fir_hilbert_transform(num_taps: int,
                          window_type: str = "hamming") -> np.ndarray:
    """Windowed ideal Hilbert transformer 2/(pi*n) for odd n (0 for even);
    reference: filter_utils.lua:350-376.  Odd tap count required."""
    if num_taps % 2 == 0:
        raise ValueError("Hilbert design requires an odd number of taps")
    h = np.zeros(num_taps, dtype=np.float64)
    w = make_window(num_taps, window_type)
    c = (num_taps - 1) // 2
    for i in range(num_taps):
        n = i - c
        if n % 2 != 0:
            h[i] = (2.0 / (np.pi * n)) * w[i]
    return h


__all__ = [
    "firwin_lowpass", "firwin_highpass", "firwin_bandpass", "firwin_bandstop",
    "firwin_complex_bandpass", "firwin_complex_bandstop",
    "fir_root_raised_cosine", "fir_hilbert_transform",
]
