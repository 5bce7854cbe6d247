"""ingest_wait.replay: the pump's wait for ingest (span sources.wait) as a
share of the traced window."""

from radiobench import readers


def read(ctx):
    return readers.ingest_wait_pct(ctx)
