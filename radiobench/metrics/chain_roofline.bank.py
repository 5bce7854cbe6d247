"""chain_roofline.bank: the chain's least time (its operations at the
float32 peak or its bytes at the HBM peak, the larger) over the device's
busy time in the profiled slice."""

from radiobench import readers


def read(ctx):
    return readers.chain_roofline_pct(ctx)
