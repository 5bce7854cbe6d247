"""hold_ms.live: the pipelined pump's hold of a chunk (span chunk.hold: from
the end of its dispatch to the start of its host tail, while the next
chunk is waited for and dispatched) a chunk."""

from radiobench import readers

SPAN = "chunk.hold"


def read(ctx):
    tr = ctx.get("traced")
    if not tr or SPAN not in tr["spans"] or not readers._chunks(tr):
        return None
    return 1e3 * tr["spans"][SPAN]["total_s"] / readers._chunks(tr)
