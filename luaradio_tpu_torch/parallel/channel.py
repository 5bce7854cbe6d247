"""Channel-parallel execution on one card: one receiver chain over a bank
of independent channels (the JAX package's parallel/channel.py, without
its mesh).

Every block of the port broadcasts over leading axes, so a bank of C
channels is the same program on [C, T] tensors, with each block's carried
state broadcast to (C,) + its shape.  The JAX class shards the C axis over
a device mesh and jits the step; on one card the step is plain torch, so
there is no mesh and no ``jit_step``.
"""

from __future__ import annotations

from typing import Sequence

from luaradio_tpu_torch.core.block import SignalBlock
from luaradio_tpu_torch.core.runtime import broadcast_state


class ChannelBank:
    """A chain of SignalBlocks applied to a [n_channels, T] batch.

    ``blocks`` must be differentiated and initialized (set up through a
    Graph, or by hand as the tests do)."""

    def __init__(self, blocks: Sequence[SignalBlock], n_channels: int):
        self.blocks = list(blocks)
        self.n_channels = n_channels

    def init_states(self):
        return [broadcast_state(b.init_state(), (self.n_channels,))
                for b in self.blocks]

    def step(self, states, x):
        """One chunk through the chain: x [C, T] -> y [C, T']."""
        new_states = []
        for b, st in zip(self.blocks, states):
            st, x = b.process(st, x)
            new_states.append(st)
        return new_states, x


__all__ = ["ChannelBank"]
