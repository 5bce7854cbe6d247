"""RDS front-end bank: the RDS receiver's full-rate stages for C channels as
one step over [C, T] chunks, each stream's time axis sharded over the
mesh's ``"time"`` axis (the JAX package's parallel/rds.py, whose step is
a shard_map over a (channel, time) mesh).

FM discriminator, Hilbert transform, 19 kHz pilot recovery with x3
phase multiplication, 57 kHz coherent demodulation, baseband lowpass and
the RRC matched filter, with the vectorized pilot (FIR, normalize, de
Moivre) as in the JAX class, through the halo helpers of
parallel/time.py.  The output is the full-rate RRC'd BPSK soft-symbol
stream; the 1187.5-baud tail (clock recovery, sampler, decoders) stays
on the ordinary blocks.  Reference topology:
radio/composites/rdsreceiver.lua:24-56.
"""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.core.platform import resolve_device
from luaradio_tpu_torch.parallel.mesh import join_shards, split_shards
from luaradio_tpu_torch.parallel.time import (delay_sharded, fir_sharded,
                                              pilot_recovery_sharded)
from luaradio_tpu_torch.parallel.wbfm import _taps, discriminate, time_axis
from luaradio_tpu_torch.utils import filter_design


class RDSBank:
    """C-channel RDS full-rate front end over a (channel, time) mesh:
    ``step(state, x[C, T] complex) -> (state, soft[C, T] complex)``, the
    57 kHz-demodulated, RRC-matched BPSK stream at the IF rate.  The
    state's six leaves are the JAX class's."""

    def __init__(self, mesh, if_rate: float = 228e3, *, device=None):
        self.mesh = mesh
        self.device = dev = resolve_device(device)
        self.if_rate = if_rate
        nyq = if_rate / 2.0
        self.ht_taps = _taps(filter_design.fir_hilbert_transform(129)
                             .astype(np.float32), dev)
        self.bp_taps = _taps(filter_design.firwin_complex_bandpass(
            129, (18e3 / nyq, 20e3 / nyq)).astype(np.complex64), dev)
        self.lpf_taps = _taps(filter_design.firwin_lowpass(
            128, 4e3 / nyq).astype(np.float32), dev)
        self.rrc_taps = _taps(filter_design.fir_root_raised_cosine(
            101, if_rate, 1.0, 1.0 / 1187.5).astype(np.float32), dev)
        self.gain = 1.25
        self.group_delay = 64  # (129-1)/2 pilot/Hilbert group delay
        self._axis = time_axis(mesh)

    def init_state(self, n_channels: int):
        c, g, dev = n_channels, self.group_delay, self.device
        f32, c64 = torch.float32, torch.complex64
        return (torch.zeros(c, dtype=c64, device=dev),       # disc prev
                torch.zeros(c, 128, dtype=f32, device=dev),  # hilbert tail
                torch.zeros(c, g, dtype=c64, device=dev),    # delay line
                torch.zeros(c, 128, dtype=c64, device=dev),  # pilot bp tail
                torch.zeros(c, 127, dtype=c64, device=dev),  # lpf tail (mix)
                torch.zeros(c, 100, dtype=c64, device=dev))  # rrc tail (bb)

    def step(self, state, x):
        disc_prev, ht_tail, dly_carry, bp_tail, lpf_tail, rrc_tail = state
        ax, g = self._axis, self.group_delay
        xs = split_shards(x, ax.n_local)
        m = discriminate(xs, disc_prev, self.gain, ax)
        im = fir_sharded(m, self.ht_taps, ax, tail=ht_tail)
        re = delay_sharded(m, g, ax, carry=ht_tail[..., -g:])
        analytic = torch.complex(re, im)
        carrier = pilot_recovery_sharded(analytic, self.bp_taps, 3, ax,
                                         tail=bp_tail)
        mix = delay_sharded(analytic, g, ax, carry=dly_carry) \
            * carrier.conj()
        bb = fir_sharded(mix, self.lpf_taps, ax, tail=lpf_tail)
        soft = fir_sharded(bb, self.rrc_taps, ax, tail=rrc_tail)
        new_state = (ax.last(xs[..., -1]), ax.tail(m, 128),
                     ax.tail(analytic, g), ax.tail(analytic, 128),
                     ax.tail(mix, 127), ax.tail(bb, 100))
        return new_state, join_shards(soft)


__all__ = ["RDSBank"]
