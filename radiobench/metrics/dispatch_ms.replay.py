"""dispatch_ms.replay: host time dispatching a chunk's device segments
(spans segment[i].dispatch) a chunk."""

from radiobench import readers


def read(ctx):
    return readers.dispatch_ms(ctx)
