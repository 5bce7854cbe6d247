"""What the measurement entry points share: the device a run names, the
card's power limit, timing that ends each trial in a synchronize, the
median and spread of trials, back-to-back batches fenced once, and the
pageable host-to-device copy rate."""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from luaradio_tpu_torch.core.platform import resolve_device


def device_info(dev: torch.device) -> dict:
    """{"device": the card's name (or "cpu"), "power_limit_w": its power
    limit as nvidia-smi reads it (None on the CPU or where nvidia-smi
    gives none)}."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    watts = None
    if "," in line:
        field = line.rsplit(",", 1)[1].strip().split()
        try:
            watts = float(field[0])
        except (IndexError, ValueError):
            watts = None
    return {"device": torch.cuda.get_device_name(dev),
            "power_limit_w": watts}


def setup(device) -> tuple[torch.device, dict]:
    """(the resolved device, its :func:`device_info`); the card unless
    ``device`` names another, raising without one."""
    dev = resolve_device(device)
    return dev, device_info(dev)


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device) -> float:
    """Host seconds of ``fn()`` ended by a synchronize."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t0


def rate_trials(run_k, units: float, dev: torch.device, row_s: float,
                trials: int = 5, k_max: int = 4096) -> list[float]:
    """Rates (units a call of ``run_k(1)`` over seconds) of ``trials``
    trials after a warm-up: ``run_k(k)`` does k steps; k is set from a
    two-step calibration so that the trials together take about
    ``row_s`` seconds.  Host clock, each trial ended by a synchronize."""
    timed(lambda: run_k(1), dev)                         # warm-up
    per = timed(lambda: run_k(2), dev) / 2
    k = int(min(k_max, max(1, round(row_s / trials / max(per, 1e-6)))))
    return [k * units / timed(lambda: run_k(k), dev) for _ in range(trials)]


def spread(key: str, values) -> dict:
    """{key: median, key_min: min, key_max: max} of a list of values."""
    return {key: statistics.median(values), f"{key}_min": min(values),
            f"{key}_max": max(values)}


def event_ms(fn, dev: torch.device, reps: int = 10, warmup: int = 3
             ) -> float:
    """Median milliseconds of one call: CUDA events around each call on
    the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            times.append(1e3 * timed(fn, dev))
    return statistics.median(times)


def batch_ms(fn, dev: torch.device, n: int = 50, warmup: int = 3) -> float:
    """Milliseconds a call over ``n`` back-to-back calls, fenced once: on
    the card CUDA events before the first and after the last (the JAX
    system's bench_roofline ``_timeit``), so the host's time between
    launches hides behind the card's queue; the host clock ended by a
    synchronize on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        return 1e3 * timed(lambda: [fn() for _ in range(n)], dev) / n
    sync(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def h2d_pageable_MBps(dev: torch.device, nbytes: int = 32 << 20,
                      k: int = 6, seed: int = 0) -> float | None:
    """Pageable host-to-device copy rate in MB/s (1e6 bytes): ``k``
    copies of one ``nbytes`` float32 array after two untimed ones, as the
    JAX system's bench_blocks.measure_ingest_ceiling times its link.  None
    on the CPU: there is no link to measure."""
    if dev.type != "cuda":
        return None
    arr = np.random.default_rng(seed).standard_normal(
        nbytes // 4).astype(np.float32)
    host = torch.from_numpy(arr)
    for _ in range(2):
        host.to(dev)
    sync(dev)

    def copies():
        for _ in range(k):
            host.to(dev)
    return k * arr.nbytes / timed(copies, dev) / 1e6


def emit(rec: dict, out: str | None = None, indent=None):
    """Print ``rec`` as one JSON object (on one line unless ``indent``)
    and, given ``out``, also write it to that file."""
    text = json.dumps(rec, indent=indent)
    print(text, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")


__all__ = ["device_info", "setup", "sync", "timed", "rate_trials", "spread",
           "event_ms", "batch_ms", "h2d_pageable_MBps", "emit"]
