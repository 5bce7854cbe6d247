"""pll_sync_ms.live: the PLL's host reads of its guards (span
pll.host_read, inside segment[i].dispatch; each waits for the kernels
queued before it) a chunk."""

from radiobench import readers

SPAN = "pll.host_read"


def read(ctx):
    tr = ctx.get("traced")
    if not tr or SPAN not in tr["spans"] or not readers._chunks(tr):
        return None
    return 1e3 * tr["spans"][SPAN]["total_s"] / readers._chunks(tr)
