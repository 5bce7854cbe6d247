"""Channel-bank source: stack C same-rate host sources into one [C, n]
stream (the JAX package's blocks/sources/bank.py, in torch).

The reference has no multi-channel concept (one stream per graph); a bank
of independent channels is the port's batch axis on the card.  BankSource
adapts C ordinary host sources (files, arrays) into the [channels, time]
layout that ``run(channels=C)`` consumes (core/runtime.py).

A bank of IQ or real file sources that all share one wire format whose
conversion is exact in float32 (8- and 16-bit integers) takes the wire
route (core/ingest.py): ``wire_read`` copies each child's raw items into
its row of one [C, k n] array through the children's public wire
contract (``wire_factor``, ``wire_dtype``, ``read_wire_into``), and the
card converts it with the children's own converter into the samples
``read`` stacks on the host, bit for bit.  Any other bank (32-bit or
float formats, mixed formats, IQ mixed with real, array or SDR children)
takes the host route.
"""

from __future__ import annotations

import numpy as np

from luaradio_tpu_torch.blocks.sources.files import _WireFileSource
from luaradio_tpu_torch.core.block import HostSourceBlock


class BankSource(HostSourceBlock):
    """Stack C single-channel host sources into a [C, n] banked stream.

    All children must have the same rate and output type.  EOF is the
    earliest child EOF (the bank stays rectangular; trailing samples of
    longer children are dropped).

    ``BankSource.wire_reads`` counts the chunks banks read as wire items
    (module docstring)."""

    wire_reads = 0

    def __init__(self, sources):
        super().__init__()
        if not sources:
            raise ValueError("BankSource needs at least one child source")
        self.children = list(sources)
        s0 = self.children[0]
        self.rate = s0.rate
        for s in self.children[1:]:
            if s.rate != s0.rate:
                raise ValueError("BankSource children must share one rate")
        # the first child's (single) output signature
        if not s0.signatures:
            raise ValueError("child source has no type signature")
        sig = s0.signatures[0]
        self.add_type_signature(list(sig.inputs), list(sig.outputs))

    @property
    def n_channels(self) -> int:
        return len(self.children)

    def initialize(self):
        for s in self.children:
            s.device = self.device
            s.differentiate([])
            s.input_rate = None
            s.initialize()

    def cleanup(self):
        for s in self.children:
            s.cleanup()

    def read(self, n: int):
        rows = []
        for s in self.children:
            r = s.read(n)
            if r is None:
                return None
            if isinstance(r, tuple):
                r = r[0]
            rows.append(np.asarray(r))
        n_min = min(r.shape[-1] for r in rows)
        if n_min == 0:
            return None
        return np.stack([r[..., :n_min] for r in rows], axis=0)

    # -- wire ingest --------------------------------------------------------
    @property
    def wire_factor(self) -> int:
        return self.children[0].wire_factor

    def device_ingest(self):
        """The children's converter when every child is a wire file source
        with one, all of one format and ``wire_factor``; else None."""
        c0 = self.children[0]
        if not all(isinstance(s, _WireFileSource)
                   and s.format.name == c0.format.name
                   and s.wire_factor == c0.wire_factor
                   for s in self.children):
            return None
        return c0.device_ingest()

    def wire_read(self, n: int):
        """(raw [C, k * n_min] wire items, n_min) or None at EOF: each
        child's items copied into its row of one array, allocated afresh
        a chunk (the read-ahead queue holds chunks in flight)."""
        k = self.wire_factor
        raw = np.empty((len(self.children), k * n),
                       self.children[0].wire_dtype)
        n_min = n
        for row, s in zip(raw, self.children):
            got = s.read_wire_into(row)
            if got == 0:
                return None
            n_min = min(n_min, got)
        BankSource.wire_reads += 1
        return raw[:, :k * n_min], n_min


__all__ = ["BankSource"]
