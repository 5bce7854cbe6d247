"""d2h_wait_ms.live: the pump's wait for a chunk's copies back to the host
before its host tail (span host.d2h_wait) a chunk."""

from radiobench import readers

SPAN = "host.d2h_wait"


def read(ctx):
    tr = ctx.get("traced")
    if not tr or SPAN not in tr["spans"] or not readers._chunks(tr):
        return None
    return 1e3 * tr["spans"][SPAN]["total_s"] / readers._chunks(tr)
