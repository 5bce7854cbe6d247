"""Configuration ``amband117_rtlsdr``: the whole US AM broadcast band from
one wideband capture, split by the program's polyphase channelizer into
its 117 channels, each demodulated by rx_am --synchronous's demodulator
(the port's ``AMSynchronousDemodulator``, as applications/apps.py
``RxAM.run`` builds it, with the channelizer in the tuner's place and
neither the AGC nor the AF downsampler after it), with the benchmark's
sink taking every channel's audio as one [C, n] batch."""

from __future__ import annotations

import luaradio_tpu_torch as lr


def build(cfg: dict, source, sink) -> lr.CompositeBlock:
    top = lr.CompositeBlock()
    top.connect(source,
                lr.ChannelizerBlock(int(cfg["channels"]),
                                    cfg["taps_per_branch"]),
                lr.AMSynchronousDemodulator(0.0, cfg["bandwidth"]), sink)
    return top


__all__ = ["build"]
