"""Sample-rate and plumbing blocks (reference:
radio/blocks/signal/{downsampler,upsampler,delay,interleave,deinterleave,
nop,throttle}.lua).  Rate-changing blocks declare exact rational rate
ratios and chunk-multiple constraints so the graph planner keeps every
chunk a multiple of the factor; the per-call phase state the reference
carries (downsampler.lua:45-55) is then unnecessary.  Interleave and
deinterleave are a stack-and-reshape and strided views (the JAX package's
ops/layout.py selection matmuls are a TPU workaround the card does not
need)."""

from __future__ import annotations

import time
from fractions import Fraction

import numpy as np
import torch

from luaradio_tpu_torch.core.block import HostBlock, Input, Output, SignalBlock
from luaradio_tpu_torch.types import Bit, Byte, ComplexFloat32, Float32

_TORCH_DTYPES = {np.dtype(np.complex64): torch.complex64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.uint8): torch.uint8}


class DownsamplerBlock(SignalBlock):
    """y[n] = x[n*M] (reference: downsampler.lua)."""

    def __init__(self, factor: int):
        super().__init__()
        if factor < 1:
            raise ValueError("factor must be >= 1")
        self.factor = int(factor)
        for t in (ComplexFloat32, Float32):
            self.add_type_signature([Input("in", t)], [Output("out", t)])

    def get_rate_ratio(self):
        return Fraction(1, self.factor)

    def chunk_multiple(self):
        return self.factor

    def process(self, state, x):
        return state, x[..., ::self.factor]


class UpsamplerBlock(SignalBlock):
    """Zero-stuffing upsampler: y[n*L] = x[n], zeros between
    (reference: upsampler.lua)."""

    def __init__(self, factor: int):
        super().__init__()
        if factor < 1:
            raise ValueError("factor must be >= 1")
        self.factor = int(factor)
        for t in (ComplexFloat32, Float32):
            self.add_type_signature([Input("in", t)], [Output("out", t)])

    def get_rate_ratio(self):
        return Fraction(self.factor)

    def process(self, state, x):
        if self.factor == 1:
            return state, x
        y = x.new_zeros(x.shape[:-1] + (x.shape[-1] * self.factor,))
        y[..., ::self.factor] = x
        return state, y


class DelayBlock(SignalBlock):
    """Delay by N samples through a carried sample line
    (reference: delay.lua)."""

    def __init__(self, num_samples: int):
        super().__init__()
        if num_samples <= 0:
            raise ValueError("num_samples must be > 0")
        self.num_samples = int(num_samples)
        for t in (ComplexFloat32, Float32, Bit, Byte):
            self.add_type_signature([Input("in", t)], [Output("out", t)])

    def init_state(self):
        return torch.zeros(
            (self.num_samples,),
            dtype=_TORCH_DTYPES[self.get_input_type().dtype],
            device=self.device)

    def process(self, state, x):
        n = x.shape[-1]
        xin = torch.cat([state.expand(x.shape[:-1] + state.shape[-1:]), x],
                        dim=-1)
        return xin[..., n:], xin[..., :n]


class InterleaveBlock(SignalBlock):
    """Interleave N streams sample by sample into one stream at N-fold
    rate (reference: interleave.lua)."""

    def __init__(self, num_channels: int = 2):
        super().__init__()
        if num_channels < 2:
            raise ValueError("num_channels must be > 1")
        self.num_channels = int(num_channels)
        for t in (Float32, ComplexFloat32):
            ins = [Input(f"in{i+1}", t) for i in range(num_channels)]
            self.add_type_signature(ins, [Output("out", t)])

    def get_rate_ratio(self):
        return Fraction(self.num_channels)

    def process(self, state, *xs):
        xs = torch.broadcast_tensors(*xs)
        y = torch.stack(xs, dim=-1)
        return state, y.reshape(y.shape[:-2] + (-1,))


class DeinterleaveBlock(SignalBlock):
    """Deinterleave one stream into N streams at 1/N rate
    (reference: deinterleave.lua)."""

    def __init__(self, num_channels: int = 2):
        super().__init__()
        if num_channels < 2:
            raise ValueError("num_channels must be > 1")
        self.num_channels = int(num_channels)
        for t in (Float32, ComplexFloat32):
            outs = [Output(f"out{i+1}", t) for i in range(num_channels)]
            self.add_type_signature([Input("in", t)], outs)

    def get_rate_ratio(self):
        return Fraction(1, self.num_channels)

    def chunk_multiple(self):
        return self.num_channels

    def process(self, state, x):
        k = self.num_channels
        return state, tuple(x[..., i::k] for i in range(k))


class NopBlock(SignalBlock):
    """Pass-through of any type (reference: nop.lua)."""

    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("in", lambda t: True)],
                                [Output("out", lambda ts: ts[0])])

    def process(self, state, x):
        return state, x


class ThrottleBlock(HostBlock):
    """Host-side rate pacing for real-time sinks (the JAX package's block;
    reference: throttle.lua).

    The reference adapts a per-chunk usleep with measured-rate feedback
    (throttle.lua:30-110); here pacing is an ABSOLUTE schedule: chunk k is
    released at t0 + samples_sent / rate, so timer oversleep self-corrects
    and long runs cannot drift.  ``actual_rate`` is re-estimated every
    ADJUST_PERIOD_S seconds (LUARADIO_TPU_DEBUG logs it), and if the pump
    stalls longer than MAX_BACKLOG_S the schedule re-anchors, so recovery
    resumes paced output instead of bursting the accumulated debt."""

    ADJUST_PERIOD_S = 0.5
    MAX_BACKLOG_S = 0.25

    def __init__(self, rate: float | None = None):
        super().__init__()
        self.rate_limit = rate
        self._t0 = None
        self._sent = 0
        self._adj_t = None
        self._adj_sent = 0
        #: most recent measured output rate (samples/s), None until the
        #: first adjust period completes
        self.actual_rate: float | None = None
        self.add_type_signature([Input("in", lambda t: True)],
                                [Output("out", lambda ts: ts[0])])

    def process(self, x):
        rate = self.rate_limit or self.get_rate()
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
            self._adj_t = now
        self._sent += len(x)
        self._adj_sent += len(x)
        delay = self._t0 + self._sent / rate - now
        if delay > 0:
            time.sleep(delay)
        elif -delay > self.MAX_BACKLOG_S:
            # a stalled pump: cap the accumulated debt at MAX_BACKLOG_S
            self._t0 = now - (self._sent / rate) - self.MAX_BACKLOG_S
        t = time.monotonic()
        if t - self._adj_t >= self.ADJUST_PERIOD_S:
            self.actual_rate = self._adj_sent / (t - self._adj_t)
            from luaradio_tpu_torch.core import debug
            debug.printf("[ThrottleBlock] target %.2f | actual %.2f | "
                         "error %.2f", rate, self.actual_rate,
                         rate - self.actual_rate)
            self._adj_t = t
            self._adj_sent = 0
        return np.asarray(x)


__all__ = ["DownsamplerBlock", "UpsamplerBlock", "DelayBlock",
           "InterleaveBlock", "DeinterleaveBlock", "NopBlock",
           "ThrottleBlock"]

# Aligned rate changers and pass-throughs have no coupling along time:
# the chunk planner keeps every shard's chunk a multiple of their phase
# period, so process() is exact per time shard.  DelayBlock's state is its
# input tail, which the generic halo exchange carries (core/block.py).
for _cls in (DownsamplerBlock, UpsamplerBlock, InterleaveBlock,
             DeinterleaveBlock, NopBlock):
    _cls.time_local = True
del _cls
DelayBlock.tail_state = True
