"""pll_ms.amband: the carrier PLL's device time (span pll.device: CUDA
events around PLLBlock's work, its tiers and the card's gaps while the
host reads their flags) a chunk, over the traced part of the window."""

SPAN = "pll.device"


def read(ctx):
    tr = ctx.get("traced")
    if not tr or SPAN not in tr["spans"] or tr["spans"][SPAN]["count"] <= 0:
        return None
    sp = tr["spans"][SPAN]
    return 1e3 * sp["total_s"] / sp["count"]
