"""Polyphase filter-bank channelizer: one wideband stream -> C channels
(the JAX package's blocks/signal/channelizer.py, in torch; no reference
analog: LuaRadio tunes one channel at a time with TunerBlock).

A wideband capture splits into C critically-sampled channels in one shot,
and the [C, time] batch feeds banked receiver chains: device blocks
broadcast over leading axes.

Math (standard critically-sampled analysis PFB, e.g. arXiv:1411.3656):

    y_c[m] = sum_k h[k] x[mC - k] e^{+j 2 pi c k / C}
           = IDFT_p->c ( v_p[m] ),  v_p[m] = sum_q h[qC+p] x[(m-q)C - p]

C polyphase branch FIRs on decimated streams and a length-C inverse FFT
across the branches, scaled by C.  Stock torch ops: the JAX block reaches
no Pallas kernel.

Tracing (core/trace.py): each chunk's work is the span
``channelizer.dispatch`` and, on a CUDA card, its device time the span
``channelizer.device``; ``ChannelizerBlock.rows_emitted`` counts the
channel rows emitted.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from luaradio_tpu_torch.core import trace
from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
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

    def init_state(self):
        return torch.zeros((self.num_channels * self.taps_per_branch,),
                           dtype=torch.complex64, device=self.device)

    def process(self, state, x):
        with trace.device_span("channelizer.dispatch", "channelizer.device",
                               x.device):
            state, y = self._channelize(state, x)
        ChannelizerBlock.rows_emitted += y[..., 0].numel()
        return state, y

    def _channelize(self, state, x):
        c, q = self.num_channels, self.taps_per_branch
        k = c * q
        m = x.shape[-1] // c
        lead = x.shape[:-1]
        # xin[k + t] = x[t]; output m' reads xin[k + m'C - k'], k' < K, so
        # every index lies in [1, k + (m-1)C]
        xin = torch.cat([state.to(x.dtype).expand(lead + state.shape[-1:]),
                         x], dim=-1)
        # one slice covers every branch window: fr[u, j] = xin[1 + uC + j],
        # and branch p's decimated stream is brx[p, u] = fr[u, C-1-p]
        fr = xin[..., 1:1 + (m + q - 1) * c].reshape(lead + (m + q - 1, c))
        brx = fr.flip(-1).transpose(-1, -2)                # [.., C, m+q-1]
        # per-branch causal FIR: v_p[m'] = sum_j hp[p, q-1-j] brx[p, m'+j]
        v = torch.zeros(lead + (c, m), dtype=x.dtype, device=x.device)
        for j in range(q):
            v = v + self._branch[:, j:j + 1] * brx[..., j:j + m]
        # inverse DFT across branches, scaled by C: channel c lands at
        # +c rate / C
        y = (torch.fft.ifft(v, dim=-2) * np.float32(c)).to(torch.complex64)
        return xin[..., xin.shape[-1] - k:], y


__all__ = ["ChannelizerBlock"]
