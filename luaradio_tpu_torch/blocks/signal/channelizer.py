"""Polyphase filter-bank channelizer: one wideband stream -> C channels
(the JAX package's blocks/signal/channelizer.py, in torch; no reference
analog: LuaRadio tunes one channel at a time with TunerBlock).

A wideband capture splits into C critically-sampled channels in one shot,
and the [C, time] batch feeds banked receiver chains: device blocks
broadcast over leading axes.

Math (standard critically-sampled analysis PFB, e.g. arXiv:1411.3656):

    y_c[m] = sum_k h[k] x[mC - k] e^{+j 2 pi c k / C}
           = IDFT_p->c ( v_p[m] ),  v_p[m] = sum_q h[qC+p] x[(m-q)C - p]

C polyphase branch FIRs on decimated streams and a length-C inverse DFT
across the branches, unnormalised.  On a CUDA card one hand-written
kernel does it all in one pass (ops/channelizer.py ``channelize``,
csrc/channelizer.cu), for every (C, q) its ``fits`` takes; other shapes,
and the CPU, take the stock-torch twin (``channelize_reference``: q
strided multiply-adds and an ifft scaled by C).  The JAX block reaches no
Pallas kernel.

Tracing (core/trace.py): each chunk's work is the span
``channelizer.dispatch`` and, on a CUDA card, its device time the span
``channelizer.device``; ``ChannelizerBlock.rows_emitted`` counts the
channel rows emitted, ``channelize.launches`` (ops/channelizer.py) the
kernel's launches and ``ChannelizerBlock.stock_chunks`` the chunks a card
ran on the stock path (a shape ``fits`` refuses, ~30x slower).
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from luaradio_tpu_torch.core import trace
from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
from luaradio_tpu_torch.ops import channelizer
from luaradio_tpu_torch.types import ComplexFloat32
from luaradio_tpu_torch.utils import filter_design


class ChannelizerBlock(SignalBlock):
    """Split a complex stream into ``num_channels`` critically-sampled
    channels.  Output is one [num_channels, N/C] batch on a single port;
    channel c is centered at c * rate / C (FFT ordering: c > C/2 are the
    negative frequencies).

    ``taps_per_branch`` sets the prototype lowpass length
    (num_channels * taps_per_branch taps, cutoff at rate / (2C)).  The
    state is the last C * taps_per_branch input samples."""

    #: channel rows emitted by every channelizer in the process (a counter)
    rows_emitted = 0
    #: chunks a CUDA card ran on the stock path, every channelizer in the
    #: process (a counter)
    stock_chunks = 0

    def __init__(self, num_channels: int, taps_per_branch: int = 8,
                 window: str = "hamming"):
        super().__init__()
        if num_channels < 2:
            raise ValueError("num_channels must be >= 2")
        self.num_channels = int(num_channels)
        self.taps_per_branch = int(taps_per_branch)
        self.window = window
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", ComplexFloat32)])

    def get_rate_ratio(self):
        # per-channel rate; the [C] leading axis is a batch, not time
        return Fraction(1, self.num_channels)

    def out_batch_shape(self, in_batches):
        return super().out_batch_shape(in_batches) + (self.num_channels,)

    def chunk_multiple(self):
        return self.num_channels

    def initialize(self):
        c, q = self.num_channels, self.taps_per_branch
        # prototype lowpass at the channel Nyquist, unit DC gain; branch p
        # takes taps h[q' C + p], reversed for the causal sum below
        proto = filter_design.firwin_lowpass(c * q, 1.0 / c, self.window)
        hp = proto.astype(np.float64).reshape(q, c).T.astype(np.float32)
        self._branch = torch.from_numpy(
            np.ascontiguousarray(hp[:, ::-1])).to(self.device)   # [C, q]
        self._kernel = channelizer.fits(c, q)

    def init_state(self):
        return torch.zeros((self.num_channels * self.taps_per_branch,),
                           dtype=torch.complex64, device=self.device)

    def process(self, state, x):
        with trace.device_span("channelizer.dispatch", "channelizer.device",
                               x.device):
            state, y = self._channelize(state, x)
        ChannelizerBlock.rows_emitted += math.prod(y.shape[:-1])
        return state, y

    def _channelize(self, state, x):
        # the kernel's wrapper (its twin on the CPU); a shape the kernel
        # does not take keeps the stock path
        if self._kernel:
            return channelizer.channelize(state, x.contiguous(), self._branch)
        if x.is_cuda:
            ChannelizerBlock.stock_chunks += 1
        return channelizer.channelize_reference(state, x, self._branch)


__all__ = ["ChannelizerBlock"]
