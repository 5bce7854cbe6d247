"""WBFM receiver banks: C channels of the mono or stereo demodulator as one
step over [C, T] chunks, each stream's time axis sharded over the mesh's
``"time"`` axis (the JAX package's parallel/wbfm.py, whose step is a
shard_map over a (channel, time) mesh).

The step splits each chunk into the time shards the mesh gives this
process (parallel/mesh.py) and runs the halo and distributed-prefix
helpers of parallel/time.py over them, as the JAX step does; the channel
axis is the bank's [C] rows.  With no time axis (or ``mesh=None``) the
stream is one shard, whose halos are the carried tails.  The state tuples
are the JAX classes' leaf for leaf and in the same order, so a JAX bank's
state carries across (interop.py ``bank_state_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.blocks.signal.filtering import \
    _singlepole_lowpass_coeffs
from luaradio_tpu_torch.core.platform import resolve_device
from luaradio_tpu_torch.parallel.mesh import Axis, join_shards, split_shards
from luaradio_tpu_torch.parallel.time import (
    delay_sharded, fir_sharded, linrec_first_order_sharded,
    pilot_recovery_sharded)
from luaradio_tpu_torch.utils import filter_design


def time_axis(mesh) -> Axis:
    """The mesh's ``"time"`` Axis, or a single shard where it has none."""
    if mesh is not None and "time" in mesh.axis_names:
        return mesh.axis("time")
    return Axis("time", 1)


def discriminate(x: torch.Tensor, prev: torch.Tensor, gain: float,
                 ax: Axis) -> torch.Tensor:
    """FM discriminator over time shards x [D, ..., L]: arg(x[n]
    conj(x[n-1])) / (2 pi gain), the carried last sample ``prev`` [...]
    entering shard 0 and each other shard's from its left neighbour."""
    halo = ax.left_halo(x, 1, first=prev[..., None])
    t = x * torch.cat([halo, x[..., :-1]], dim=-1).conj()
    return torch.atan2(t.imag, t.real) * float(
        np.float32(1.0 / (2 * np.pi * gain)))


class _Deemphasis:
    """The 75 us (or ``tau``) deemphasis as the JAX banks run it:
    y[n] = -a1 y[n-1] + b0 f[n] + b1 f[n-1], carrying y[-1] and f[-1]."""

    def __init__(self, tau: float, rate: float):
        b, a = _singlepole_lowpass_coeffs(1.0 / (2 * np.pi * tau), rate)
        self.b0, self.b1 = (float(np.float32(v)) for v in b)
        self.a = float(-np.float32(a[1]))

    def __call__(self, f, y_prev, f_prev_last, ax: Axis):
        halo = ax.left_halo(f, 1, first=f_prev_last[..., None])
        u = self.b0 * f + self.b1 * torch.cat([halo, f[..., :-1]], dim=-1)
        return linrec_first_order_sharded(u, self.a, y_prev, ax)


def _taps(h: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(h)).to(dev)


class WBFMMonoBank:
    """C-channel WBFM mono demodulator over a (channel, time) mesh:
    ``step(state, x[C, T]) -> (state, audio[C, T // decimation])``, T
    this process's time block.  The state is (last sample [C] complex64,
    AF FIR tail [C, num_taps-1], deemphasis y[-1] [C], its input's last
    value [C])."""

    def __init__(self, mesh, if_rate: float = 256e3, decimation: int = 8,
                 tau: float = 75e-6, num_taps: int = 128, *, device=None):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.if_rate = if_rate
        self.decimation = decimation
        self.num_taps = num_taps
        nyq = if_rate / 2.0
        self.taps = _taps(filter_design.firwin_lowpass(
            num_taps, 15e3 / nyq).astype(np.float32), self.device)
        self._deemph = _Deemphasis(tau, if_rate)
        self.gain = 1.25   # the discriminator's modulation index (WBFM)
        self._axis = time_axis(mesh)

    def init_state(self, n_channels: int):
        c, dev = n_channels, self.device
        return (torch.zeros(c, dtype=torch.complex64, device=dev),
                torch.zeros(c, self.num_taps - 1, device=dev),
                torch.zeros(c, device=dev),
                torch.zeros(c, device=dev))

    def step(self, state, x):
        ax = self._axis
        disc_prev, fir_tail, deemph_y, f_last = state
        xs = split_shards(x, ax.n_local)                 # [D, C, L]
        m = discriminate(xs, disc_prev, self.gain, ax)
        f = fir_sharded(m, self.taps, ax, tail=fir_tail)
        y = self._deemph(f, deemph_y, f_last, ax)
        new_state = (ax.last(xs[..., -1]),
                     ax.tail(m, self.num_taps - 1),
                     ax.last(y[..., -1]), ax.last(f[..., -1]))
        return new_state, join_shards(y[..., ::self.decimation])


class WBFMStereoBank:
    """C-channel WBFM STEREO demodulator over a (channel, time) mesh:
    ``step(state, x[C, T]) -> (state, (left[C, T//D], right[C, T//D]))``.

    The pilot path is the vectorized recovery (bandpass FIR,
    normalization, phase doubling; parallel/time.py
    pilot_recovery_sharded), as in the JAX class: the reference's
    sequential PLL (pll.lua:138-167) is a per-sample loop that cannot
    time-shard.  The reference topology is wbfmstereodemodulator.lua:28-64
    (discriminator -> Hilbert -> {pilot bandpass -> carrier x2, delay} ->
    coherent mixer -> L+R / L-R filters -> stereo matrix -> deemphasis).
    The state's ten leaves are the JAX class's."""

    def __init__(self, mesh, if_rate: float = 256e3, decimation: int = 8,
                 tau: float = 75e-6, *, device=None):
        self.mesh = mesh
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
        self._axis = time_axis(mesh)

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
        ax, g = self._axis, self.group_delay
        xs = split_shards(x, ax.n_local)
        m = discriminate(xs, disc_prev, self.gain, ax)
        # Hilbert transform -> analytic signal: imag = 129-tap FIR, real =
        # m delayed by the filter's group delay
        im = fir_sharded(m, self.ht_taps, ax, tail=ht_tail)
        re = delay_sharded(m, g, ax, carry=ht_tail[..., -g:])
        analytic = torch.complex(re, im)
        # pilot recovery: 19 kHz bandpass -> normalize -> x2 phase
        carrier = pilot_recovery_sharded(analytic, self.bp_taps, 2, ax,
                                         tail=bp_tail)
        # the signal path delayed by the pilot filter's group delay
        d = delay_sharded(analytic, g, ax, carry=dly_carry)
        mix = d * carrier.conj()
        d_re, mix_re = d.real.contiguous(), mix.real.contiguous()
        lpr = fir_sharded(d_re, self.af_taps, ax, tail=lpr_tail)
        lmr = fir_sharded(mix_re, self.af_taps, ax, tail=lmr_tail)
        l_raw, r_raw = lpr + lmr, lpr - lmr
        yl = self._deemph(l_raw, dl_y, dl_f, ax)
        yr = self._deemph(r_raw, dr_y, dr_f, ax)
        dec = self.decimation
        new_state = (ax.last(xs[..., -1]), ax.tail(m, 128),
                     ax.tail(analytic, 128), ax.tail(analytic, g),
                     ax.tail(d_re, 127), ax.tail(mix_re, 127),
                     ax.last(yl[..., -1]), ax.last(l_raw[..., -1]),
                     ax.last(yr[..., -1]), ax.last(r_raw[..., -1]))
        return new_state, (join_shards(yl[..., ::dec]),
                           join_shards(yr[..., ::dec]))


__all__ = ["WBFMMonoBank", "WBFMStereoBank", "discriminate", "time_axis"]
