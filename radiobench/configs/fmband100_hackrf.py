"""Configuration ``fmband100_hackrf``: the whole US FM band from one
wideband capture, split by the program's polyphase channelizer into its
channels, each demodulated as rx_wbfm --mono demodulates one (the port's
applications/apps.py ``RxWBFM.run`` with the channelizer in the tuner's
place), with the benchmark's sink taking every channel's audio as one
[C, n] batch."""

from __future__ import annotations

import luaradio_tpu_torch as lr


def build(cfg: dict, source, sink) -> lr.CompositeBlock:
    channels = int(cfg["channels"])
    channel_rate = source.get_rate() / channels
    af_downsample = int(channel_rate / cfg["af_rate"] + 0.5)
    top = lr.CompositeBlock()
    top.connect(source,
                lr.ChannelizerBlock(channels, cfg["taps_per_branch"]),
                lr.WBFMMonoDemodulator(cfg["tau"]),
                lr.DownsamplerBlock(af_downsample), sink)
    return top


__all__ = ["build"]
