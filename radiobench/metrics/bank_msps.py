"""bank_msps: complex input samples completed a second summed over every
row of the bank, in millions (host clock, all the work over the window)."""

from radiobench import readers


def read(ctx):
    return readers.input_msps(ctx)
