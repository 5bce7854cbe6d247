"""channelizer_roofline.band: the channelizer's least time a chunk (its
operations at the float32 peak or its bytes at the HBM peak, the larger;
reference/<config>.py ``channelizer_work``, radiobench/peaks.json) over its
device time a chunk (span channelizer.device)."""

from radiobench import harness

SPAN = "channelizer.device"


def read(ctx):
    tr, peaks = ctx.get("traced"), ctx.get("peaks")
    if not tr or not peaks or SPAN not in tr["spans"]:
        return None
    sp = tr["spans"][SPAN]
    if sp["count"] <= 0 or sp["total_s"] <= 0:
        return None
    cfg = ctx["cfg"]
    work = harness.load_module(harness.ROOT / "reference" / f"{cfg['name']}"
                               ".py").channelizer_work(cfg)
    least = ctx["chunk_in"] * ctx["rows"] * max(
        work["flops"] / peaks["fp32_flops_per_s"],
        work["bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * least / (sp["total_s"] / sp["count"])
