"""latency_p95_ms: the 95th percentile over every chunk of the window of
the time from the creation of the chunk's last input sample to its audio
reaching the sink (host clock)."""

from radiobench import readers


def read(ctx):
    return readers.latency_p95_ms(ctx)
