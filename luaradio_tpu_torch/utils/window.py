"""Window functions.

Standard window definitions (rectangular, hamming, hanning, bartlett,
blackman), same families as the reference's window utilities
(radio/utilities/window_utils.lua:11-47).  Designed in
float64 on the host; kernels consume float32.
"""

from __future__ import annotations

import numpy as np


def window(num: int, window_type: str, periodic: bool = False) -> np.ndarray:
    """Generate a window of ``num`` points.

    ``periodic=True`` returns the DFT-even variant used for spectral analysis
    (window of length num+1 truncated to num).
    """
    if periodic:
        return window(num + 1, window_type, periodic=False)[:num]
    n = np.arange(num, dtype=np.float64)
    if num == 1:
        return np.ones(1)
    if window_type == "rectangular":
        w = np.ones(num)
    elif window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (num - 1))
    elif window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / (num - 1))
    elif window_type == "bartlett":
        w = (2.0 / (num - 1)) * ((num - 1) / 2.0 - np.abs(n - (num - 1) / 2.0))
    elif window_type == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * n / (num - 1))
             + 0.08 * np.cos(4 * np.pi * n / (num - 1)))
    else:
        raise ValueError(f"unsupported window type {window_type!r}")
    return w


__all__ = ["window"]
