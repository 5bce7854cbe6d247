"""device_idle.live: the device's idle share of the profiled slice
(torch.profiler: 1 minus the union of kernel, copy and set intervals
over the slice)."""

from radiobench import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
