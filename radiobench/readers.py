"""What the metric readers (metrics/<metric>.py) share.  A reader takes
the run's context (radiobench/harness.py ``run_cell``) and returns a
number, or None where it finds nothing to read."""

from __future__ import annotations

from radiobench import stats


def input_msps(ctx) -> float | None:
    """Complex input samples (every row of a bank) whose audio or messages
    reached the sink inside the window, in millions a second of the
    window."""
    if not ctx["window_chunks"]:
        return None
    return ctx["input_samples"] / ctx["seconds"] / 1e6


def latency_p95_ms(ctx) -> float | None:
    lat = ctx["latencies_ms"]
    return stats.percentile(lat, 95) if lat else None


def _traced(ctx):
    return ctx.get("traced")


def _chunks(tr) -> int:
    """Chunks the pump dispatched in the traced part of the window."""
    return max((v["count"] for k, v in tr["spans"].items()
                if k.startswith("segment[")), default=0)


def ingest_wait_pct(ctx) -> float | None:
    """The pump's wait for the read-ahead thread's next chunk
    (``sources.wait``) as a share of the traced part of the window."""
    tr = _traced(ctx)
    if not tr or "sources.wait" not in tr["spans"] or tr["seconds"] <= 0:
        return None
    return 100.0 * tr["spans"]["sources.wait"]["total_s"] / tr["seconds"]


def dispatch_ms(ctx) -> float | None:
    """Host time queueing a chunk's device segments
    (``segment[i].dispatch``, summed over segments) a chunk."""
    tr = _traced(ctx)
    if not tr or not _chunks(tr):
        return None
    total = sum(v["total_s"] for k, v in tr["spans"].items()
                if k.startswith("segment[") and k.endswith("].dispatch"))
    return 1e3 * total / _chunks(tr)


def launches_per_chunk(ctx, counters) -> float | None:
    """The program's launch counters ``counters`` (names of a reader's
    ``COUNTERS``) summed over the traced part of the window, a chunk."""
    tr = _traced(ctx)
    if not tr or not _chunks(tr):
        return None
    return sum(tr["counters"][k] for k in counters) / _chunks(tr)


def device_idle_pct(ctx) -> float | None:
    p = ctx.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def chain_roofline_pct(ctx) -> float | None:
    """The least time the card could take for the chain's work in the
    profiled slice, as a share of the device's busy time there.  The
    least time is the larger of the chain's operations at the card's
    float32 peak and its bytes at the HBM peak (reference/<config>.py
    ``work``, radiobench/peaks.json)."""
    p, peaks, work = ctx.get("profile"), ctx.get("peaks"), ctx.get("work")
    if not p or not peaks or not work or p["busy_s"] <= 0 \
            or not ctx["slice_chunks"]:
        return None
    samples = ctx["slice_chunks"] * ctx["chunk_in"] * ctx["rows"]
    least = samples * max(work["flops"] / peaks["fp32_flops_per_s"],
                          work["bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * least / p["busy_s"]


__all__ = ["input_msps", "latency_p95_ms", "ingest_wait_pct", "dispatch_ms",
           "launches_per_chunk", "device_idle_pct", "chain_roofline_pct"]
