"""The device trace of a traced run's slice: ``torch.profiler`` (CPU and
CUDA activity) started and stopped on the graph's pump thread, exported
as a Chrome trace and reduced to what the per-layer metrics and the
breakdown read.

* ``busy_s``: the union of the intervals in which a kernel, a memory copy
  or a memory set ran on the device;
* ``window_s``: the slice's length on the host clock;
* ``device_ops``: the ten device operations with the most time;
* ``idle_gaps``: the ten longest gaps between device intervals, each named
  by the innermost host operation (a torch op or a benchmark annotation)
  that ran at the gap's middle, ``host`` where the trace shows none.
"""

from __future__ import annotations

import json
import os
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


class Slice:
    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.prof is not None and self.t1 is None:
            self.t1 = time.perf_counter()
            self.prof.stop()

    def reduce(self) -> dict | None:
        """The slice's numbers, or None where nothing was traced."""
        if self.prof is None or self.t1 is None:
            return None
        path = os.path.join(self.tmpdir, "slice.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        return reduce_events(events, self.t1 - self.t0)


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events: list, window_s: float) -> dict:
    dev, host, by_name = [], [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, d = float(ev["ts"]), float(ev["dur"])
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, s + d))
            name = ev.get("name", cat)[:120]
            by_name[name] = by_name.get(name, 0.0) + d * 1e-6
        elif cat in HOST_CATS:
            host.append((s, s + d, ev.get("name", "")[:120]))
    merged = _union(dev)
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = [(merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = []
    for s, e in gaps[:10]:
        mid = (s + e) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host"
        idle.append([name, (e - s) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"busy_s": busy, "window_s": window_s,
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": idle,
            "device_events": len(dev)}


def warm():
    """Start and stop the profiler once (CUPTI's first start is slow), so
    that the slice's start costs the window little."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


__all__ = ["Slice", "reduce_events", "warm"]
