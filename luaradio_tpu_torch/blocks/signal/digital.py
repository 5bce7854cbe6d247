"""Digital symbol blocks (the JAX package's blocks/signal/digital.py;
reference: radio/blocks/signal/{sampler,slicer,differentialdecoder,
manchesterdecoder,preamblesampler}.lua).

SamplerBlock's output count depends on the data, which a fixed-shape
chunk cannot carry: it runs on the card and emits a (values, mask) pair,
and the runtime keeps values[mask] on the host after its copy
(core/runtime.py _to_host).  The framers downstream are host blocks
anyway.  Slicer and DifferentialDecoder are "dual": device blocks that
the graph demotes to host mode downstream of a masked or variable-rate
stage (core/composite.py _demote_duals).
"""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.core.block import (HostBlock, Input, Output,
                                           SignalBlock)
from luaradio_tpu_torch.ops.scan import linrec_first_order
from luaradio_tpu_torch.types import Bit, ComplexFloat32, Float32


def hysteresis(x: torch.Tensor, threshold: float, h0: torch.Tensor):
    """The two-level comparator with hold: s[n] = +1 above the threshold,
    -1 below, s[n-1] on equality, from s[-1] = h0.  A first-order
    recurrence with a per-sample coefficient in {0, 1}, exact in float32.
    Returns (hold [..., N] bool, s, s_prev: s delayed by one)."""
    raw = torch.where(x > threshold, 1.0,
                      torch.where(x < threshold, -1.0, 0.0)).to(torch.float32)
    hold = raw == 0.0
    s = linrec_first_order(raw, hold.to(torch.float32), h0)
    s_prev = torch.cat([torch.as_tensor(h0, dtype=torch.float32,
                                        device=x.device)[..., None]
                        .expand(s[..., :1].shape), s[..., :-1]], dim=-1)
    return hold, s, s_prev


class SamplerBlock(SignalBlock):
    """Sample the data input on positive zero crossings of the clock input
    (with hysteresis; reference: sampler.lua).  Masked-output device
    block."""

    masked_output = True

    def __init__(self):
        super().__init__()
        self.add_type_signature(
            [Input("data", ComplexFloat32), Input("clock", Float32)],
            [Output("out", ComplexFloat32)])
        self.add_type_signature(
            [Input("data", Float32), Input("clock", Float32)],
            [Output("out", Float32)])

    def init_state(self):
        # clock hysteresis: -1 LOW, +1 HIGH
        return torch.tensor(-1.0, dtype=torch.float32, device=self.device)

    def process(self, state, data, clock):
        _, s, s_prev = hysteresis(clock, 0.0, state)
        emit = (clock > 0) & (s_prev < 0)
        return s[..., -1], (data, emit)

    def process_sharded(self, state, data, clock, *, axis):
        # the hysteresis as a distributed affine prefix scan, the previous
        # clock state as a 1-sample halo; the (values, mask) pair shards
        # on time like any other boundary tensor
        from luaradio_tpu_torch.parallel.time import (
            linrec_first_order_sharded)
        raw = torch.where(clock > 0, 1.0,
                          torch.where(clock < 0, -1.0, 0.0)).to(torch.float32)
        s, s_final = linrec_first_order_sharded(
            raw, (raw == 0.0).to(torch.float32), state, axis,
            with_final=True)
        halo = axis.left_halo(s, 1, first=torch.as_tensor(state)[..., None])
        emit = (clock > 0) & (torch.cat([halo, s[..., :-1]], -1) < 0)
        return s_final, (data, emit)


class SlicerBlock(SignalBlock):
    """Float32 -> Bit by threshold (reference: slicer.lua).  Dual-domain."""

    dual = True

    def __init__(self, threshold: float = 0.0):
        super().__init__()
        self.threshold = threshold
        self.add_type_signature([Input("in", Float32)], [Output("out", Bit)])

    def process(self, state, x):
        return state, (x > float(np.float32(self.threshold))).to(torch.uint8)

    def process_host(self, x):
        return (np.asarray(x) > self.threshold).astype(np.uint8)


class DifferentialDecoderBlock(SignalBlock):
    """y[n] = x[n] xor x[n-1] (optionally inverted; reference:
    differentialdecoder.lua).  Dual-domain; host mode carries the last bit
    in ``_prev_host``."""

    dual = True

    def __init__(self, invert: bool = False):
        super().__init__()
        self.invert = invert
        self.add_type_signature([Input("in", Bit)], [Output("out", Bit)])
        self._prev_host = np.uint8(0)

    def init_state(self):
        return torch.zeros((), dtype=torch.uint8, device=self.device)

    def process(self, state, x):
        prev = torch.cat([state[..., None], x[..., :-1]], dim=-1)
        y = torch.bitwise_xor(x, prev)
        if self.invert:
            y = (y + 1) % 2
        return x[..., -1], y

    def process_sharded(self, state, x, *, axis):
        # one halo exchange: each shard's previous bit (the carried one on
        # shard 0) and the stream's last bit as the next carry
        halo, tail = axis.halo_and_tail(x, 1, first=state[..., None])
        _, y = self.process(halo[..., 0], x)
        return tail[..., 0], y

    def process_host(self, x):
        x = np.asarray(x, dtype=np.uint8)
        prev = np.concatenate([[self._prev_host], x[:-1]])
        y = np.bitwise_xor(x, prev)
        if self.invert:
            y = ((y + 1) % 2).astype(np.uint8)
        if len(x):
            self._prev_host = x[-1]
        return y


class ManchesterDecoderBlock(HostBlock):
    """Manchester pair decode with clock-slip recovery (reference:
    manchesterdecoder.lua).  Data-dependent consumption -> host block."""

    variable_output = True

    def __init__(self, invert: bool = False):
        super().__init__()
        self.invert = invert
        self._prev: int | None = None
        self.add_type_signature([Input("in", Bit)], [Output("out", Bit)])

    def process(self, x):
        x = np.asarray(x, dtype=np.uint8)
        out = []
        prev = self._prev
        for cur in x:
            if prev is None:
                prev = int(cur)
            else:
                if prev == 0 and cur == 1:
                    out.append(1 if self.invert else 0)
                    prev = None
                elif prev == 1 and cur == 0:
                    out.append(0 if self.invert else 1)
                    prev = None
                else:
                    prev = int(cur)  # clock slip
        self._prev = prev
        return np.asarray(out, dtype=np.uint8)


class PreambleSamplerBlock(HostBlock):
    """Correlate for a bit preamble at symbol rate, align to the
    energy-maximizing offset, then clock out a fixed-length frame of
    symbol-rate samples (reference: preamblesampler.lua:1-140).

    Host block (data-dependent framing).  The search is vectorized: candidate
    alignments are validated with strided sign comparisons; the sequential
    state machine only walks state *transitions*.
    """

    variable_output = True

    def __init__(self, baudrate: float, preamble, num_samples: int):
        super().__init__()
        self.baudrate = baudrate
        self.preamble = np.asarray(preamble, dtype=np.uint8)
        self.num_samples = int(num_samples)
        self.add_type_signature([Input("in", Float32)], [Output("out", Float32)])
        self._buf = np.zeros(0, dtype=np.float32)
        self._mode = "search"
        self._search_pos = 0
        self._best_energy = 0.0
        self._best_pos = 0

    def initialize(self):
        # floor of the true quotient (reference preamblesampler.lua:50
        # math.floor) — Python's // differs on exact-ratio floats
        self.symbol_period = int(np.floor(self.get_rate() / self.baudrate))
        self._span = self.symbol_period * len(self.preamble)

    def _energies(self, buf: np.ndarray, start: int, count: int):
        """Energy (or nan if invalid) of preamble alignment at offsets
        start..start+count-1."""
        sp = self.symbol_period
        plen = len(self.preamble)
        idx = (np.arange(count)[:, None] + start
               + np.arange(plen)[None, :] * sp)
        w = buf[idx]
        bits = (w > 0).astype(np.uint8)
        valid = (bits == self.preamble[None, :]).all(axis=1)
        energy = np.abs(w).sum(axis=1)
        energy[~valid] = np.nan
        return energy

    def process(self, x):
        x = np.asarray(x, dtype=np.float32)
        buf = np.concatenate([self._buf, x])
        out = []
        sp = self.symbol_period
        pos = self._search_pos
        # positions are alignment starts; alignment at p needs p+span samples
        while pos + self._span <= len(buf):
            if self._mode == "search":
                count = len(buf) - self._span - pos + 1
                e = self._energies(buf, pos, count)
                hits = np.flatnonzero(~np.isnan(e))
                if len(hits) == 0:
                    pos += count
                    break
                pos += int(hits[0])
                self._best_energy = float(e[hits[0]])
                self._best_pos = pos
                self._mode = "optimize"
                pos += 1
            elif self._mode == "optimize":
                e = self._energies(buf, pos, 1)[0]
                if np.isnan(e) or e < self._best_energy:
                    # best alignment found: emit the frame from best_pos
                    self._mode = "sample"
                    self._frame_start = self._best_pos
                    self._bits_done = 0
                else:
                    self._best_energy = float(e)
                    self._best_pos = pos
                    pos += 1
            else:  # sample
                want = self.num_samples - self._bits_done
                avail = (len(buf) - self._frame_start) // sp
                take = min(want, avail)
                if take > 0:
                    sel = buf[self._frame_start + self._bits_done * sp:
                              self._frame_start + (self._bits_done + take) * sp:sp]
                    out.extend(sel.tolist())
                    self._bits_done += take
                if self._bits_done >= self.num_samples:
                    self._mode = "search"
                    pos = self._frame_start + self.num_samples * sp
                else:
                    break

        # retain enough history for a full alignment window + frame in flight
        keep_from = max(0, min(pos, len(buf)) - 1)
        if self._mode == "sample":
            keep_from = min(keep_from, self._frame_start + self._bits_done * sp)
        elif self._mode == "optimize":
            keep_from = min(keep_from, self._best_pos)
        self._buf = buf[keep_from:]
        self._search_pos = max(0, pos - keep_from)
        if self._mode == "optimize":
            self._best_pos -= keep_from
        if self._mode == "sample":
            self._frame_start -= keep_from
        return np.asarray(out, dtype=np.float32)


__all__ = [
    "SamplerBlock", "SlicerBlock", "DifferentialDecoderBlock",
    "ManchesterDecoderBlock", "PreambleSamplerBlock",
]

SlicerBlock.time_local = True   # a stateless threshold
