"""Single-card flagship step: the WBFM mono receiver chain as one function
over [channels, time] chunks of the interleaved float32 I/Q wire.

The chain — discriminator -> 15 kHz AF lowpass -> FM deemphasis ->
decimate — runs as ONE CUDA kernel (K1, ops/wbfm.py wbfm_mono): the
deemphasis 1-pole IIR is folded into the FIR taps as its truncated impulse
response (< 1e-10 tail) and only every D-th output is computed.  This is
the same fused filter the graph optimizer (core/optimize.py) builds for
the chain made from ordinary blocks.  Reference chain:
radio/composites/wbfmmonodemodulator.lua + downsampler.
"""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.blocks.signal.filtering import \
    _singlepole_lowpass_coeffs
from luaradio_tpu_torch.core.platform import resolve_device
from luaradio_tpu_torch.ops.fir import combine_taps, iir_to_fir_taps
from luaradio_tpu_torch.ops.wbfm import wbfm_mono
from luaradio_tpu_torch.utils import filter_design


def wbfm_mono_taps(if_rate: float = 256e3, tau: float = 75e-6,
                   num_taps: int = 128) -> np.ndarray:
    """The step's folded taps (AF lowpass * deemphasis impulse response),
    zero-padded to a multiple of 128 so the carry has the JAX kernel's
    shape [C, K]."""
    nyq = if_rate / 2.0
    taps_lpf = filter_design.firwin_lowpass(num_taps, 15e3 / nyq)
    b, a = _singlepole_lowpass_coeffs(1.0 / (2 * np.pi * tau), if_rate)
    g = iir_to_fir_taps(b, a, tol=1e-10)
    if g is None:
        raise ValueError("deemphasis pole does not decay")
    taps = combine_taps(taps_lpf, g).astype(np.float32)
    k = -(-len(taps) // 128) * 128
    return np.concatenate([taps, np.zeros(k - len(taps), np.float32)])


#: discriminator scale 1/(2*pi*modulation index 1.25), as the mono
#: demodulator's FrequencyDiscriminatorBlock(1.25)
INV_GAIN = float(np.float32(1.0 / (2 * np.pi * 1.25)))


def make_wbfm_mono_step(if_rate: float = 256e3, decimation: int = 8,
                        tau: float = 75e-6, num_taps: int = 128,
                        device=None):
    """Returns (step, init_state) with
    step(state, x[C, 2T] float32) -> (state, audio[C, T//decimation]).

    ``x`` is the interleaved I/Q wire on ``device`` (default: the CUDA
    card).  The state is ``(carry,)``: the last K complex samples,
    complex64 [C, K]."""
    dev = resolve_device(device)
    taps = torch.from_numpy(wbfm_mono_taps(if_rate, tau, num_taps)).to(dev)
    k = taps.shape[0]

    def init_state(n_channels: int):
        return (torch.zeros((n_channels, k), dtype=torch.complex64,
                            device=dev),)

    def step(state, x):
        carry, audio = wbfm_mono(state[0], x, taps, decimation, INV_GAIN)
        return (carry,), audio

    return step, init_state


__all__ = ["make_wbfm_mono_step", "wbfm_mono_taps", "INV_GAIN"]
