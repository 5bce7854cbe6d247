"""Configuration ``pocsag_toy`` (a test's own): the graph rx_pocsag builds
after its tuner, the port's ``POCSAGReceiver``, between a bank of pager
captures and the benchmark's message sink; the receiver's data filter
(the signal its clock recovery and sampler read) also feeds the sink's
soft tap."""

from __future__ import annotations

import luaradio_tpu_torch as lr


def build(cfg: dict, source, sink) -> lr.CompositeBlock:
    top = lr.CompositeBlock()
    rx = lr.POCSAGReceiver(int(cfg["baudrate"]))
    top.connect(source, rx, sink)
    data_filter, = (b for b in rx._blocks
                    if isinstance(b, lr.LowpassFilterBlock))
    top.connect(data_filter, "out", sink.soft, "in")
    return top


__all__ = ["build"]
