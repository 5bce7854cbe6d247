"""Channel-bank source: stack C same-rate host sources into one [C, n]
stream (the JAX package's blocks/sources/bank.py, in torch).

The reference has no multi-channel concept (one stream per graph); a bank
of independent channels is the port's batch axis on the card.  BankSource
adapts C ordinary host sources (files, arrays) into the [channels, time]
layout that ``run(channels=C)`` consumes (core/runtime.py).
"""

from __future__ import annotations

import numpy as np

from luaradio_tpu_torch.core.block import HostSourceBlock


class BankSource(HostSourceBlock):
    """Stack C single-channel host sources into a [C, n] banked stream.

    All children must have the same rate and output type.  EOF is the
    earliest child EOF (the bank stays rectangular; trailing samples of
    longer children are dropped)."""

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


__all__ = ["BankSource"]
