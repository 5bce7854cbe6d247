"""pll_slow_launches.live: launches of the PLL's slow tiers, K3 and the
overlap scan (their wrappers' launch counters), a chunk."""

from radiobench import readers

#: the program's counters this metric reads ("module:attribute")
COUNTERS = {
    "pll_phase": "luaradio_tpu_torch.ops.pll:pll_phase.launches",
    "pll_overlap_discard":
        "luaradio_tpu_torch.ops.pll_overlap:pll_overlap_discard.launches",
}


def read(ctx):
    return readers.launches_per_chunk(ctx, COUNTERS)
