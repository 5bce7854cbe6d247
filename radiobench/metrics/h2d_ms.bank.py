"""h2d_ms.bank: the read-ahead thread's copy of a chunk's payloads to the
card (span sources.h2d) a chunk."""

from radiobench import readers

SPAN = "sources.h2d"


def read(ctx):
    tr = ctx.get("traced")
    if not tr or SPAN not in tr["spans"] or not readers._chunks(tr):
        return None
    return 1e3 * tr["spans"][SPAN]["total_s"] / readers._chunks(tr)
