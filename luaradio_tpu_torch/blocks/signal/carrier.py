"""Carrier recovery blocks of the stereo receiver: the PLL and the
vectorized pilot recovery (the JAX package's blocks/signal/carrier.py;
reference: radio/blocks/signal/pll.lua).  AGC, squelch, clock recovery
and the phase corrector are later slices of the port."""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
from luaradio_tpu_torch.ops import fir as fir_ops
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
    the chunks each tier produced."""

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
        st = torch.stack([torch.as_tensor(s, dtype=torch.float32,
                                          device=x.device) for s in state])
        out, err, st2 = pll_phase(x.contiguous(), st, self._alpha,
                                  self._beta, self._freq_min,
                                  self._freq_max, self.multiplier)
        return (st2[0], st2[1], st2[2]), (out, err)

    def process(self, state, x):
        if x.dim() != 1:
            raise ValueError(f"{self.name}: runs one stream [N], got "
                             f"{tuple(x.shape)}")
        mult = self.multiplier
        if float(mult).is_integer() and mult >= 1:
            from luaradio_tpu_torch.ops.pll_linear import pll_hybrid
            return pll_hybrid(x, state, self._alpha, self._beta,
                              self._freq_min, self._freq_max, int(mult),
                              self._sequential, allow_overlap=not self.exact,
                              tiers=self.tier_counts)
        self.tier_counts[3] += 1
        return self._sequential(state, x)


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


__all__ = ["PLLBlock", "PilotRecoveryBlock", "pilot_normalize_multiply"]
