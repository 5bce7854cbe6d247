"""pll_slow_rows.amband: the rows the PLL's slow tiers solved, the overlap
scan's and K3's (pll_hybrid's row counters), a chunk."""

from radiobench import harness, readers

_PATHS = {
    "scan_rows": "luaradio_tpu_torch.ops.pll_linear:pll_hybrid.scan_rows",
    "k3_rows": "luaradio_tpu_torch.ops.pll_linear:pll_hybrid.k3_rows",
}


def _present(paths: dict) -> dict:
    out = {}
    for k, p in paths.items():
        try:
            harness.read_counter(p)
        except AttributeError:
            continue
        out[k] = p
    return out


#: the program's counters this metric reads ("module:attribute"): none
#: where the program lacks either, and the metric then reads nothing
COUNTERS = _present(_PATHS)
if len(COUNTERS) < len(_PATHS):
    COUNTERS = {}


def read(ctx):
    if not COUNTERS:
        return None
    return readers.launches_per_chunk(ctx, COUNTERS)
