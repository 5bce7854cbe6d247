"""channelizer_ms.band: the channelizer's device time (span
channelizer.device: CUDA events around its launches) a chunk, over the
traced part of the window."""

SPAN = "channelizer.device"


def read(ctx):
    tr = ctx.get("traced")
    if not tr or SPAN not in tr["spans"] or tr["spans"][SPAN]["count"] <= 0:
        return None
    sp = tr["spans"][SPAN]
    return 1e3 * sp["total_s"] / sp["count"]
