"""RDS front-end bank on one card: the RDS receiver's full-rate stages for
C channels as one step over [C, T] chunks (the JAX package's
parallel/rds.py, whose step is a shard_map over a (channel, time) mesh).

FM discriminator, Hilbert transform, 19 kHz pilot recovery with x3
phase multiplication, 57 kHz coherent demodulation, baseband lowpass and
the RRC matched filter, with the vectorized pilot (FIR, normalize, de
Moivre) as in the JAX class.  The output is the full-rate RRC'd BPSK
soft-symbol stream; the 1187.5-baud tail (clock recovery, sampler,
decoders) stays on the ordinary blocks.  One time shard: each halo is the
carried tail (parallel/wbfm.py).  Reference topology:
radio/composites/rdsreceiver.lua:24-56.
"""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.blocks.signal.carrier import pilot_normalize_multiply
from luaradio_tpu_torch.core.platform import resolve_device
from luaradio_tpu_torch.ops.fir import fir_direct
from luaradio_tpu_torch.parallel.wbfm import _taps, delay, discriminate
from luaradio_tpu_torch.utils import filter_design


class RDSBank:
    """C-channel RDS full-rate front end on one card:
    ``step(state, x[C, T] complex) -> (state, soft[C, T] complex)``, the
    57 kHz-demodulated, RRC-matched BPSK stream at the IF rate.  The
    state's six leaves are the JAX class's."""

    def __init__(self, if_rate: float = 228e3, device=None):
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
        g = self.group_delay
        m = discriminate(x, disc_prev, self.gain)
        im, _ = fir_direct(m, self.ht_taps, ht_tail)
        analytic = torch.complex(delay(m, g, ht_tail[..., -g:]), im)
        p, _ = fir_direct(analytic, self.bp_taps, bp_tail)
        carrier = pilot_normalize_multiply(p, 3)
        mix = delay(analytic, g, dly_carry) * carrier.conj()
        bb, _ = fir_direct(mix, self.lpf_taps, lpf_tail)
        soft, _ = fir_direct(bb, self.rrc_taps, rrc_tail)
        new_state = (x[..., -1], m[..., -128:], analytic[..., -g:],
                     analytic[..., -128:], mix[..., -127:], bb[..., -100:])
        return new_state, soft


__all__ = ["RDSBank"]
