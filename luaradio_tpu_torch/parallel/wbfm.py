"""WBFM receiver banks on one card: C channels of the mono or stereo
demodulator as one step over [C, T] chunks (the JAX package's
parallel/wbfm.py, whose step is a shard_map over a (channel, time) mesh).

On one card the time axis has a single shard, so each halo of the JAX
step is the carried tail of the previous chunk and its distributed
recurrences are plain first-order recurrences.  The step is built from
the port's ops: the FIR (ops/fir.py, float32 products), the blocked
linear recurrence (ops/scan.py ``linrec_first_order``) and the
vectorized pilot's ``pilot_normalize_multiply``.  The state tuples are
the JAX classes' leaf for leaf and in the same order, so a JAX bank's
state carries across (interop.py ``bank_state_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.blocks.signal.carrier import pilot_normalize_multiply
from luaradio_tpu_torch.blocks.signal.filtering import \
    _singlepole_lowpass_coeffs
from luaradio_tpu_torch.core.platform import resolve_device
from luaradio_tpu_torch.ops.fir import fir_direct
from luaradio_tpu_torch.ops.scan import linrec_first_order
from luaradio_tpu_torch.utils import filter_design


def discriminate(x: torch.Tensor, prev: torch.Tensor, gain: float):
    """FM discriminator along the last axis with the carried last sample
    ``prev`` [C]: arg(x[n] conj(x[n-1])) / (2 pi gain)."""
    before = torch.cat([prev[..., None].to(x.dtype), x[..., :-1]], dim=-1)
    t = x * before.conj()
    return torch.atan2(t.imag, t.real) * float(
        np.float32(1.0 / (2 * np.pi * gain)))


def delay(x: torch.Tensor, k: int, carry: torch.Tensor) -> torch.Tensor:
    """y[n] = x[n-k] with the delay line ``carry`` [C, k]."""
    return torch.cat([carry.to(x.dtype), x[..., :-k]], dim=-1)


class _Deemphasis:
    """The 75 us (or ``tau``) deemphasis as the JAX banks run it:
    y[n] = -a1 y[n-1] + b0 f[n] + b1 f[n-1], carrying y[-1] and f[-1]."""

    def __init__(self, tau: float, rate: float):
        b, a = _singlepole_lowpass_coeffs(1.0 / (2 * np.pi * tau), rate)
        self.b0, self.b1 = (float(np.float32(v)) for v in b)
        self.a = float(-np.float32(a[1]))

    def __call__(self, f, y_prev, f_prev_last):
        f_prev = torch.cat([f_prev_last[..., None], f[..., :-1]], dim=-1)
        u = self.b0 * f + self.b1 * f_prev
        return linrec_first_order(u, self.a, y_prev)


def _taps(h: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(h)).to(dev)


class WBFMMonoBank:
    """C-channel WBFM mono demodulator on one card:
    ``step(state, x[C, T]) -> (state, audio[C, T // decimation])``.
    The state is (last sample [C] complex64, AF FIR tail [C, num_taps-1],
    deemphasis y[-1] [C], its input's last value [C])."""

    def __init__(self, if_rate: float = 256e3, decimation: int = 8,
                 tau: float = 75e-6, num_taps: int = 128, device=None):
        self.device = resolve_device(device)
        self.if_rate = if_rate
        self.decimation = decimation
        self.num_taps = num_taps
        nyq = if_rate / 2.0
        self.taps = _taps(filter_design.firwin_lowpass(
            num_taps, 15e3 / nyq).astype(np.float32), self.device)
        self._deemph = _Deemphasis(tau, if_rate)
        self.gain = 1.25   # the discriminator's modulation index (WBFM)

    def init_state(self, n_channels: int):
        c, dev = n_channels, self.device
        return (torch.zeros(c, dtype=torch.complex64, device=dev),
                torch.zeros(c, self.num_taps - 1, device=dev),
                torch.zeros(c, device=dev),
                torch.zeros(c, device=dev))

    def step(self, state, x):
        disc_prev, fir_tail, deemph_y, f_last = state
        m = discriminate(x, disc_prev, self.gain)
        f, _ = fir_direct(m, self.taps, fir_tail)
        y = self._deemph(f, deemph_y, f_last)
        audio = y[..., ::self.decimation]
        return (x[..., -1], m[..., -(self.num_taps - 1):], y[..., -1],
                f[..., -1]), audio


class WBFMStereoBank:
    """C-channel WBFM STEREO demodulator on one card:
    ``step(state, x[C, T]) -> (state, (left[C, T//D], right[C, T//D]))``.

    The pilot path is the vectorized recovery (bandpass FIR,
    normalization, phase doubling), as in the JAX class; the reference
    topology is wbfmstereodemodulator.lua:28-64 (discriminator -> Hilbert
    -> {pilot bandpass -> carrier x2, delay} -> coherent mixer -> L+R /
    L-R filters -> stereo matrix -> deemphasis).  The state's ten leaves
    are the JAX class's."""

    def __init__(self, if_rate: float = 256e3, decimation: int = 8,
                 tau: float = 75e-6, device=None):
        self.device = resolve_device(device)
        self.if_rate = if_rate
        self.decimation = decimation
        nyq = if_rate / 2.0
        dev = self.device
        self.ht_taps = _taps(filter_design.fir_hilbert_transform(129)
                             .astype(np.float32), dev)
        self.bp_taps = _taps(filter_design.firwin_complex_bandpass(
            129, (18e3 / nyq, 20e3 / nyq)).astype(np.complex64), dev)
        self.af_taps = _taps(filter_design.firwin_lowpass(
            128, 15e3 / nyq).astype(np.float32), dev)
        self._deemph = _Deemphasis(tau, if_rate)
        self.gain = 1.25
        self.group_delay = 64  # (129-1)/2: pilot/Hilbert path group delay

    def init_state(self, n_channels: int):
        c, g, dev = n_channels, self.group_delay, self.device
        f32, c64 = torch.float32, torch.complex64
        return (torch.zeros(c, dtype=c64, device=dev),       # disc prev
                torch.zeros(c, 128, dtype=f32, device=dev),  # hilbert tail
                torch.zeros(c, 128, dtype=c64, device=dev),  # pilot bp tail
                torch.zeros(c, g, dtype=c64, device=dev),    # delay line
                torch.zeros(c, 127, dtype=f32, device=dev),  # lpr fir tail
                torch.zeros(c, 127, dtype=f32, device=dev),  # lmr fir tail
                torch.zeros(c, dtype=f32, device=dev),       # deemph L y
                torch.zeros(c, dtype=f32, device=dev),       # deemph L f
                torch.zeros(c, dtype=f32, device=dev),       # deemph R y
                torch.zeros(c, dtype=f32, device=dev))       # deemph R f

    def step(self, state, x):
        (disc_prev, ht_tail, bp_tail, dly_carry, lpr_tail, lmr_tail,
         dl_y, dl_f, dr_y, dr_f) = state
        g = self.group_delay
        m = discriminate(x, disc_prev, self.gain)
        # Hilbert transform -> analytic signal: imag = 129-tap FIR, real =
        # m delayed by the filter's group delay
        im, _ = fir_direct(m, self.ht_taps, ht_tail)
        re = delay(m, g, ht_tail[..., -g:])
        analytic = torch.complex(re, im)
        # pilot recovery: 19 kHz bandpass -> normalize -> x2 phase
        p, _ = fir_direct(analytic, self.bp_taps, bp_tail)
        carrier = pilot_normalize_multiply(p, 2)
        # the signal path delayed by the pilot filter's group delay
        d = delay(analytic, g, dly_carry)
        mix = d * carrier.conj()
        lpr, _ = fir_direct(d.real.contiguous(), self.af_taps, lpr_tail)
        lmr, _ = fir_direct(mix.real.contiguous(), self.af_taps, lmr_tail)
        l_raw, r_raw = lpr + lmr, lpr - lmr
        yl = self._deemph(l_raw, dl_y, dl_f)
        yr = self._deemph(r_raw, dr_y, dr_f)
        dec = self.decimation
        new_state = (x[..., -1], m[..., -128:], analytic[..., -128:],
                     analytic[..., -g:], d.real[..., -127:],
                     mix.real[..., -127:], yl[..., -1], l_raw[..., -1],
                     yr[..., -1], r_raw[..., -1])
        return new_state, (yl[..., ::dec], yr[..., ::dec])


__all__ = ["WBFMMonoBank", "WBFMStereoBank", "discriminate", "delay"]
