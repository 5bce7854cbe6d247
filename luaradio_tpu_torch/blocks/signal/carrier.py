"""Carrier and clock recovery and level control: the PLL, the vectorized
pilot recovery, the AGC, the power squelch, the zero-crossing clock
recovery and the binary phase corrector (the JAX package's
blocks/signal/carrier.py; reference: radio/blocks/signal/{pll,agc,
powersquelch,zerocrossingclockrecovery,binaryphasecorrector}.lua)."""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.blocks.signal.digital import hysteresis
from luaradio_tpu_torch.core import trace
from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
from luaradio_tpu_torch.ops import fir as fir_ops
from luaradio_tpu_torch.ops.scan import cummax_blocked, linrec_first_order
from luaradio_tpu_torch.types import ComplexFloat32, Float32
from luaradio_tpu_torch.utils import filter_design


class PLLBlock(SignalBlock):
    """Phase-locked loop tracking a complex tone; emits the locked
    (optionally frequency-multiplied) oscillator and the phase error.

    The reference's second-order loop filter (pll.lua:138-167):
    err = arg(x * conj(vco)); freq += beta*err; phi += freq + alpha*err
    (the pre-clamp freq); freq clamped to [freq_min, freq_max].

    Integer multipliers take the three tiers of ops/pll_linear.py
    pll_hybrid: the linear solution when the loop is locked, else the
    overlap-and-discard scan where it plans, else the sequential kernel
    K3 (ops/pll.py).  Other multipliers run K3 on every chunk.
    ``exact=True`` skips the overlap tier, whose accepted outputs are
    approximate within fixed warm-up tolerances.  ``tier_counts`` counts
    the row-chunks each tier produced, ``row_tiers`` the tier of each row
    of the last chunk.

    A bank x [C, N] (a channel bank, or a channelizer's batch) runs row by
    row, each row what it gives alone, with state leaves [C]: each tier
    takes its rows in one call.  (The JAX block scans axis 0 of such a
    batch and fails; under its channel mesh it vmaps the one-stream
    block, which is what the port matches.)

    Tracing (core/trace.py): each chunk's work is the span
    ``pll.dispatch`` and, on a CUDA card, its device time the span
    ``pll.device``: CUDA events on the pump's stream before the linear
    tier and after the last tier's launches, so its window also holds the
    card's idle gaps while the host reads the tier flags
    (``pll.host_read``, children of ``pll.dispatch``) and chooses the
    next tier's rows."""

    def __init__(self, loop_bandwidth: float, frequency_min: float,
                 frequency_max: float, multiplier: float = 1.0,
                 exact: bool = False):
        super().__init__()
        self.loop_bandwidth = loop_bandwidth
        self.frequency_min = frequency_min
        self.frequency_max = frequency_max
        self.multiplier = multiplier
        self.exact = bool(exact)
        self.tier_counts = {1: 0, 2: 0, 3: 0}
        self.row_tiers: list = []
        self.add_type_signature(
            [Input("in", ComplexFloat32)],
            [Output("out", ComplexFloat32), Output("error", Float32)])

    def initialize(self):
        rate = self.get_rate()
        damping = np.sqrt(2.0) / 2.0
        loop_bw = 2 * np.pi * (self.loop_bandwidth / rate)
        loop_bw = loop_bw / (damping + 1.0 / (4 * damping))
        denom = 1 + 2 * damping * loop_bw + loop_bw * loop_bw
        self._alpha = np.float32(4 * damping * loop_bw / denom)
        self._beta = np.float32(4 * loop_bw * loop_bw / denom)
        self._freq_min = np.float32(2 * np.pi * self.frequency_min / rate)
        self._freq_max = np.float32(2 * np.pi * self.frequency_max / rate)

    def init_state(self):
        freq0 = (self._freq_min + self._freq_max) / np.float32(2.0)
        return tuple(torch.tensor(float(v), dtype=torch.float32,
                                  device=self.device)
                     for v in (0.0, 0.0, freq0))

    def _sequential(self, state, x):
        from luaradio_tpu_torch.ops.pll import pll_phase
        lead = x.shape[:-1]
        st = torch.stack([torch.as_tensor(s, dtype=torch.float32,
                                          device=x.device).expand(lead)
                          for s in state], dim=-1)
        out, err, st2 = pll_phase(x.contiguous(), st.contiguous(),
                                  self._alpha, self._beta, self._freq_min,
                                  self._freq_max, self.multiplier)
        return tuple(st2.unbind(-1)), (out, err)

    def process(self, state, x):
        with trace.device_span("pll.dispatch", "pll.device", x.device):
            if x.dim() > 2:
                return self._rows(state, x)
            return self._step(state, x)

    def _step(self, state, x):
        mult = self.multiplier
        if float(mult).is_integer() and mult >= 1:
            from luaradio_tpu_torch.ops.pll_linear import pll_hybrid
            out = pll_hybrid(x, state, self._alpha, self._beta,
                             self._freq_min, self._freq_max, int(mult),
                             self._sequential, allow_overlap=not self.exact,
                             row_tiers=self.row_tiers)
        else:
            self.row_tiers[:] = [3] * (x.shape[0] if x.dim() == 2 else 1)
            out = self._sequential(state, x)
        for tier in self.row_tiers:
            self.tier_counts[tier] += 1
        return out

    def _rows(self, state, x):
        """More than one leading axis: run them flattened as one bank."""
        lead, n = x.shape[:-1], x.shape[-1]
        flat = tuple(torch.as_tensor(s, dtype=torch.float32,
                                     device=x.device).expand(lead)
                     .reshape(-1) for s in state)
        st, (out, err) = self._step(flat, x.reshape(-1, n).contiguous())
        return (tuple(v.reshape(lead) for v in st),
                (out.reshape(x.shape), err.reshape(x.shape)))


class PilotRecoveryBlock(SignalBlock):
    """Vectorized pilot-tone carrier recovery: complex bandpass FIR around
    the pilot, magnitude normalization and integer phase multiplication,
    out = (bp(x)/|bp(x)|)^multiplier.  The JAX package's alternative to
    ComplexBandpassFilterBlock -> PLLBlock for pilot-locked receivers; no
    reference analog."""

    def __init__(self, num_taps: int, band: tuple, multiplier: int = 1,
                 nyquist: float | None = None, window: str = "hamming"):
        super().__init__()
        if num_taps % 2 == 0:
            raise ValueError("PilotRecoveryBlock requires odd num_taps")
        self.num_taps = int(num_taps)
        self.band = tuple(band)
        self.multiplier = int(multiplier)
        self.nyquist = nyquist
        self.window = window
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", ComplexFloat32)])

    def initialize(self):
        nyq = self.nyquist or (self.get_rate() / 2.0)
        taps = filter_design.firwin_complex_bandpass(
            self.num_taps, (self.band[0] / nyq, self.band[1] / nyq),
            self.window).astype(np.complex64)
        self._taps = torch.from_numpy(taps).to(self.device)

    def init_state(self):
        return fir_ops.fir_init_state(self.num_taps, torch.complex64,
                                      self.device)

    def process(self, state, x):
        p, state = fir_ops.fir_direct(x, self._taps, state)
        return state, pilot_normalize_multiply(p, self.multiplier)


def pilot_normalize_multiply(p: torch.Tensor,
                             multiplier: int) -> torch.Tensor:
    """(p/|p|)^multiplier, elementwise, 1 where p == 0."""
    mag = p.abs()
    u = p / torch.clamp(mag, min=1e-20)
    u = torch.where(mag > 0, u, torch.ones_like(u))
    y = u
    for _ in range(int(multiplier) - 1):
        y = y * u
    return y.to(torch.complex64)


class AGCBlock(SignalBlock):
    """Feed-forward AGC: a 1-pole power estimate, a 1-pole gain filter
    toward target/power that holds while the power is below the
    threshold, and the square root of the gain applied
    (reference: agc.lua:72-115).  The gain's hold makes its recurrence's
    coefficient data-valued: ops/scan.py's per-sample affine scan."""

    def __init__(self, mode: str, target: float = -35.0,
                 threshold: float = -75.0, gain_tau: float | None = None,
                 power_tau: float = 1.0):
        super().__init__()
        if mode not in ("fast", "slow", "custom"):
            raise ValueError(f"invalid mode {mode!r}")
        self.mode = mode
        self.target_db = target
        self.threshold_db = threshold
        self.gain_tau = {"fast": 0.1, "slow": 3.0}.get(mode, gain_tau)
        if self.gain_tau is None:
            raise ValueError("custom mode requires gain_tau")
        self.power_tau = power_tau
        for t in (Float32, ComplexFloat32):
            self.add_type_signature([Input("in", t)], [Output("out", t)])

    def initialize(self):
        rate = self.get_rate()
        self._power_alpha = np.float32(1.0 / (1.0 + self.power_tau * rate))
        self._gain_alpha = np.float32(1.0 / (1.0 + self.gain_tau * rate))
        self._target = np.float32(10 ** (self.target_db / 10))
        self._threshold = np.float32(10 ** (self.threshold_db / 10))

    def init_state(self):
        return tuple(torch.zeros((), dtype=torch.float32, device=self.device)
                     for _ in range(2))                   # (avg power, gain)

    def process(self, state, x):
        p0, g0 = state
        ap, ag = self._power_alpha, self._gain_alpha
        power_in = x.abs().to(torch.float32) ** 2
        p = linrec_first_order(power_in * float(ap),
                               float(np.float32(1.0) - ap), p0)
        active = p >= float(self._threshold)
        a = torch.where(active, float(np.float32(1.0) - ag), 1.0)
        u = torch.where(active, float(ag * self._target)
                        / torch.clamp(p, min=1e-30), 0.0)
        g = linrec_first_order(u, a, g0)
        y = torch.where(active, torch.sqrt(g) * x, x)
        return (p[..., -1], g[..., -1]), y

    def process_sharded(self, state, x, *, axis):
        # both 1-pole recurrences as distributed prefix scans; the gain's
        # data-valued coefficient (the hold below threshold) goes through
        # the same affine combine, and the final states come from the
        # summaries the scans gathered
        from luaradio_tpu_torch.parallel.time import (
            linrec_first_order_sharded)
        p0, g0 = state
        ap, ag = self._power_alpha, self._gain_alpha
        power_in = x.abs().to(torch.float32) ** 2
        p, p_final = linrec_first_order_sharded(
            power_in * float(ap), float(np.float32(1.0) - ap), p0, axis,
            with_final=True)
        active = p >= float(self._threshold)
        a = torch.where(active, float(np.float32(1.0) - ag), 1.0)
        u = torch.where(active, float(ag * self._target)
                        / torch.clamp(p, min=1e-30), 0.0)
        g, g_final = linrec_first_order_sharded(u, a, g0, axis,
                                                with_final=True)
        y = torch.where(active, torch.sqrt(g) * x, x)
        return (p_final, g_final), y


class PowerSquelchBlock(SignalBlock):
    """Zero the output while the 1-pole average power is below a threshold
    in dB (reference: powersquelch.lua); the average is a first-order
    recurrence (ops/scan.py linrec_first_order) carried across chunks."""

    def __init__(self, threshold: float, tau: float = 0.001):
        super().__init__()
        self.threshold_db = threshold
        self.tau = tau
        for t in (Float32, ComplexFloat32):
            self.add_type_signature([Input("in", t)], [Output("out", t)])

    def initialize(self):
        self._alpha = np.float32(1.0 / (1.0 + self.tau * self.get_rate()))
        self._threshold = np.float32(10 ** (self.threshold_db / 10))

    def init_state(self):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def process(self, state, x):
        a = self._alpha
        power_in = x.abs().to(torch.float32) ** 2
        p = linrec_first_order(float(a) * power_in,
                               float(np.float32(1.0) - a), state)
        y = torch.where(p >= float(self._threshold), x, torch.zeros_like(x))
        return p[..., -1], y

    def process_sharded(self, state, x, *, axis):
        from luaradio_tpu_torch.parallel.time import (
            linrec_first_order_sharded)
        a = self._alpha
        power_in = x.abs().to(torch.float32) ** 2
        p, p_final = linrec_first_order_sharded(
            float(a) * power_in, float(np.float32(1.0) - a), state, axis,
            with_final=True)
        y = torch.where(p >= float(self._threshold), x, torch.zeros_like(x))
        return p_final, y


class ZeroCrossingClockRecoveryBlock(SignalBlock):
    """Emit a +1/-1 clock aligned to half a symbol period after each input
    zero crossing (reference: zerocrossingclockrecovery.lua).

    The reference counts an NCO down per sample; here the pulse positions
    are solved in closed form: with d the distance since the most recent
    crossing (a cummax) the cumulative pulse count is ceil((d + 1 - P/2) /
    P), and a pulse fires wherever that count increments.  All in float32
    as the JAX package computes it, the sample indices included (exact to
    2^24 samples a chunk), with a true division by the period P."""

    def __init__(self, baudrate: float, threshold: float = 0.0):
        super().__init__()
        self.baudrate = baudrate
        self.threshold = threshold
        self.add_type_signature([Input("in", Float32)], [Output("out", Float32)])

    def initialize(self):
        self._period = np.float32(self.get_rate() / self.baudrate)

    def init_state(self):
        # (hysteresis state -1/+1, offset value entering the chunk)
        return tuple(torch.tensor(float(v), dtype=torch.float32,
                                  device=self.device)
                     for v in (-1.0, self._period))

    def _pulse_count(self, decs, base):
        """Pulses after ``decs`` decrements starting from offset ``base``."""
        return torch.clamp(torch.ceil((decs + 1.0 - base)
                                      / float(self._period)), min=0.0)

    def process(self, state, x):
        h0, off0 = state
        p = float(self._period)
        n = x.shape[-1]
        hold, s, s_prev = hysteresis(x, float(np.float32(self.threshold)),
                                     h0)
        cross = (s != s_prev) & ~hold

        # most recent crossing index (or -1)
        idx = torch.arange(n, dtype=torch.float32, device=x.device)
        c = cummax_blocked(torch.where(cross, idx, -1.0))
        has = c >= 0.0

        k = idx - c + 1.0                       # decrements since crossing
        m_cross = self._pulse_count(k, float(self._period / 2))
        m_free = self._pulse_count(idx + 1.0, off0[..., None])
        m = torch.where(has, m_cross, m_free)
        m_prev = torch.cat([torch.zeros_like(m[..., :1]), m[..., :-1]], -1)
        m_prev = torch.where(cross, 0.0, m_prev)
        y = torch.where(m > m_prev, 1.0, -1.0).to(torch.float32)

        off_end = torch.where(
            has[..., -1],
            float(self._period / 2) - k[..., -1] + m[..., -1] * p,
            off0 - float(n) + m[..., -1] * p)
        return (s[..., -1], off_end), y

    def process_sharded(self, state, x, *, axis):
        """Time-sharded form: the hysteresis recurrence as an affine
        prefix scan, the most recent crossing as a distributed cummax over
        GLOBAL sample indices, and the pulse count's previous value as a
        1-sample halo."""
        from luaradio_tpu_torch.parallel.time import (
            cummax_sharded, linrec_first_order_sharded)
        h0, off0 = state
        p = float(self._period)
        n_local = x.shape[-1]
        n_global = float(n_local * axis.size)
        thr = float(np.float32(self.threshold))
        raw = torch.where(x > thr, 1.0,
                          torch.where(x < thr, -1.0, 0.0)).to(torch.float32)
        hold = raw == 0.0
        s, s_final = linrec_first_order_sharded(
            raw, hold.to(torch.float32), h0, axis, with_final=True)
        s_halo = axis.left_halo(s, 1, first=torch.as_tensor(h0)[..., None])
        cross = (s != torch.cat([s_halo, s[..., :-1]], -1)) & ~hold

        # global sample indices of each local shard
        lead = (-1,) + (1,) * (x.dim() - 1)
        idx = (torch.arange(n_local, dtype=torch.float32, device=x.device)
               + (axis.index(x.device).to(torch.float32)
                  * float(n_local)).view(lead))
        c = cummax_sharded(torch.where(cross, idx, -1.0), axis)
        has = c >= 0.0

        k = idx - c + 1.0
        m_cross = self._pulse_count(k, float(self._period / 2))
        m_free = self._pulse_count(idx + 1.0, off0[..., None])
        m = torch.where(has, m_cross, m_free)
        m_halo = axis.left_halo(m, 1)
        m_prev = torch.where(cross, 0.0,
                             torch.cat([m_halo, m[..., :-1]], -1))
        y = torch.where(m > m_prev, 1.0, -1.0).to(torch.float32)

        # the last sample's (k, m, has): one exchange for all three
        gl = axis.last(torch.stack([k[..., -1], m[..., -1],
                                    has[..., -1].to(torch.float32)], -1))
        k_l, m_l, has_l = gl[..., 0], gl[..., 1], gl[..., 2] > 0
        off_end = torch.where(has_l,
                              float(self._period / 2) - k_l + m_l * p,
                              off0 - n_global + m_l * p)
        return (s_final, off_end), y


class BinaryPhaseCorrectorBlock(SignalBlock):
    """Rotate out the moving-average BPSK phase offset, estimated from every
    sample_interval-th sample with angles folded into [-pi/2, pi/2]
    (reference: binaryphasecorrector.lua).  The state is the last
    ``num_samples`` folded phases."""

    def __init__(self, num_samples: int, sample_interval: int = 32):
        super().__init__()
        self.num_samples = int(num_samples)
        self.sample_interval = int(sample_interval)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", ComplexFloat32)])

    def chunk_multiple(self):
        return self.sample_interval

    def init_state(self):
        return torch.zeros((self.num_samples,), dtype=torch.float32,
                           device=self.device)

    def process(self, state, x):
        interval, num = self.sample_interval, self.num_samples
        n = x.shape[-1]
        phi = torch.angle(x[..., ::interval])
        half_pi, pi = float(np.float32(np.pi / 2)), float(np.float32(np.pi))
        phi = torch.where(phi < -half_pi, phi + pi, phi)
        phi = torch.where(phi > half_pi, phi - pi, phi)
        seq = torch.cat([state.expand(phi.shape[:-1] + state.shape[-1:]),
                         phi], dim=-1)
        # ma[j] = mean(seq[j+1 .. j+num]): the window of ``num`` phases
        # ending at (and including) sample point j
        k = phi.shape[-1]
        csum = torch.cumsum(seq, dim=-1)
        prev = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
        ma_pts = (csum[..., num:num + k] - prev[..., 1:k + 1]) / float(num)
        ma = torch.repeat_interleave(ma_pts, interval, dim=-1)[..., :n]
        y = x * torch.polar(torch.ones_like(ma), -ma)
        return seq[..., -num:], y.to(torch.complex64)

    def process_sharded(self, state, x, *, axis):
        """Time-sharded form: the moving average over sample-point phases
        is a distributed cumulative sum minus its ``num``-point delay,
        ma[j] = (CS[j + num + 1] - CS[j + 1]) / num over the virtual
        sequence state ++ phases, the carried prefix entering shard 0 as
        the delay line."""
        from luaradio_tpu_torch.parallel.time import (cumsum_sharded,
                                                      delay_sharded)
        interval, num = self.sample_interval, self.num_samples
        n = x.shape[-1]
        phi = torch.angle(x[..., ::interval])
        if num > phi.shape[-1]:
            raise NotImplementedError(
                f"{self.name}: averaging window ({num} points) exceeds the "
                f"per-shard sample points ({phi.shape[-1]}); increase "
                f"chunk_size")
        half_pi, pi = float(np.float32(np.pi / 2)), float(np.float32(np.pi))
        phi = torch.where(phi < -half_pi, phi + pi, phi)
        phi = torch.where(phi > half_pi, phi - pi, phi)
        gcs = cumsum_sharded(phi, axis)                  # global inclusive
        st_cs = torch.cumsum(state, dim=-1)              # carried prefix
        carry = st_cs - st_cs[..., -1:]                  # CS[j+1] - total
        ma_pts = (gcs - delay_sharded(gcs, num, axis, carry=carry)) \
            / float(num)
        ma = torch.repeat_interleave(ma_pts, interval, dim=-1)[..., :n]
        y = x * torch.polar(torch.ones_like(ma), -ma)
        return axis.tail(phi, num), y.to(torch.complex64)


__all__ = ["PLLBlock", "PilotRecoveryBlock", "AGCBlock", "PowerSquelchBlock",
           "ZeroCrossingClockRecoveryBlock", "BinaryPhaseCorrectorBlock",
           "pilot_normalize_multiply"]

# PilotRecoveryBlock's state is a pure FIR input tail: the generic halo
# exchange (SignalBlock.process_sharded) is exact for it.  PLLBlock keeps
# the default, which raises: its per-sample feedback cannot time-shard
# (parallel/time.py has pll_linear_sharded for callers that handle
# acquisition themselves).
PilotRecoveryBlock.tail_state = True
