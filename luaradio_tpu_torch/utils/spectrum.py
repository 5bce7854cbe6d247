"""Spectrum utilities: DFT / IDFT / PSD / fftshift (the JAX package's
utils/spectrum.py on torch.fft).

The reference implements these with a four-way backend dispatch
(FFTW3F > liquid > VOLK > pure Lua,
radio/utilities/spectrum_utils.lua:69-246).  Here there is one: torch.fft,
batched over leading axes.  Each function computes on the device of the
tensor it is given (a numpy array is taken as a CPU tensor).  The
windowed-periodogram PSD (spectrum_utils.lua:513-642) is one batched
expression.
"""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.utils.window import window as make_window


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def dft(x, n: int | None = None):
    """Forward DFT along the last axis (complex in/out)."""
    return torch.fft.fft(_tensor(x), n=n, dim=-1)


def idft(x, n: int | None = None):
    """Inverse DFT along the last axis."""
    return torch.fft.ifft(_tensor(x), n=n, dim=-1)


def fftshift(x):
    """Swap halves so DC sits at the center
    (reference spectrum_utils.lua:654-667)."""
    return torch.fft.fftshift(_tensor(x), dim=-1)


def fftfreq(n: int, rate: float) -> np.ndarray:
    return np.fft.fftfreq(n, d=1.0 / rate)


class PSD:
    """Windowed-periodogram power spectral density estimator.

    Mirrors the reference's PSD contract (spectrum_utils.lua:513-642):
    num_samples-point window (periodic variant), magnitude-squared DFT
    normalized by the window energy and sample rate, optional log10 dB
    output.  Batched: input [..., num_samples] -> float32 output
    [..., num_samples], on the input's device.
    """

    def __init__(self, num_samples: int, window_type: str = "hanning",
                 sample_rate: float = 1.0, logarithmic: bool = True):
        self.num_samples = num_samples
        self.sample_rate = sample_rate
        self.logarithmic = logarithmic
        w = make_window(num_samples, window_type, periodic=True)
        self.window = w.astype(np.float32)
        # normalization: window energy * Fs  (Welch periodogram scaling)
        self.scale = np.float32(np.sum(w * w) * sample_rate)

    def compute(self, x):
        x = _tensor(x)
        xw = x * torch.as_tensor(self.window, device=x.device)
        spec = torch.fft.fft(xw, dim=-1)
        psd = spec.abs() ** 2 / float(self.scale)
        if self.logarithmic:
            psd = 10.0 * torch.log10(psd + 1e-30)
        return psd.to(torch.float32)


__all__ = ["dft", "idft", "fftshift", "fftfreq", "PSD"]
