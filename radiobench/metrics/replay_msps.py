"""replay_msps: complex input samples of one recorded stream completed a
second, in millions (host clock, all the work over the window)."""

from radiobench import readers


def read(ctx):
    return readers.input_msps(ctx)
