"""Scaling benchmark: WBFM receiver-bank throughput against mesh size (the
JAX system's bench_scaling.py, on the port).

    python -m luaradio_tpu_torch.benchmarks.bench_scaling [--out PATH]
        [--max-devices N]

* :func:`run`: ``WBFMMonoBank`` (parallel/wbfm.py) on the port's ``Mesh``
  of (ch, n / ch) ("channel", "time") shards, n = 1, 2, 4, 8, with the same
  total work [8, 2^20] at every n; samples/s, ``efficiency`` and
  ``overhead_vs_single``, and the audio's largest distance from the
  one-shard run's.
* :func:`run_generic`: an ordinary-blocks WBFM mono graph through the
  Runner on a ("time",) mesh of n = 2, 4, 8 against its serial run at the
  same chunk; samples/s and ``overhead_vs_single``.

On one card every shard shares the device (the port's mesh stacks the
shards on a leading axis of one tensor, parallel/mesh.py), as the JAX
script's virtual devices share the host's cores (bench_scaling.py:10-15):
``efficiency`` there says nothing about a link between cards, and
``overhead_vs_single`` (the same work sharded and not) measures only the
structural cost of sharding (halos, prefix summaries, the shards'
reshapes and extra launches).  Prints one JSON line a mesh size and a
summary line.  Times: host clock around steps ended by a synchronize,
the best of 3 after a warm-up.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

import luaradio_tpu_torch as lr
from luaradio_tpu_torch.benchmarks import common
from luaradio_tpu_torch.core.runtime import Runner
from luaradio_tpu_torch.parallel.mesh import Mesh
from luaradio_tpu_torch.parallel.wbfm import WBFMMonoBank

CHANNELS = 8
TOTAL_T = 8 * (1 << 14) * 8           # the same total work at every size
SIZES = (1, 2, 4, 8, 16, 32)
GENERIC_SIZES = (2, 4, 8, 16)
GENERIC_CHUNK = 1 << 20
TRIALS = 3


def _best(fn, dev, trials=TRIALS) -> float:
    fn()                                                # warm-up
    return min(common.timed(fn, dev) for _ in range(trials))


def bank_mesh(n: int) -> Mesh:
    """(ch, n / ch) ("channel", "time") shards, ch = 2 for even n."""
    ch = 2 if n % 2 == 0 and n >= 2 else 1
    return Mesh((ch, n // ch), ("channel", "time"))


def run(max_devices: int = 8, emit=print, total_t: int = TOTAL_T,
        channels: int = CHANNELS, device=None) -> dict:
    """WBFMMonoBank on meshes of 1, 2, 4, ... up to ``max_devices``
    shards over the same [channels, total_t] input; each record passed
    to ``emit`` as a JSON line; returns the summary."""
    dev, info = common.setup(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((channels, total_t))
                          + 1j * rng.standard_normal((channels, total_t))
                          ).astype(np.complex64)).to(dev)
    results, base_time, base_audio = [], None, None
    for n in (s for s in SIZES if s <= max_devices):
        mesh = bank_mesh(n)
        bank = WBFMMonoBank(mesh, if_rate=256e3, decimation=8, device=dev)
        state = bank.init_state(channels)
        _, audio = bank.step(state, x)
        best = _best(lambda: bank.step(state, x), dev)
        if base_time is None:
            base_time, base_audio = best, audio
        err = float((audio - base_audio).abs().max())
        rec = {"devices": n, "mesh": list(mesh.shape.values()),
               "samples_per_sec": channels * total_t / best,
               "efficiency": (base_time / best) / n,
               "overhead_vs_single": best / base_time - 1.0,
               "max_abs_err_vs_single": err}
        results.append(rec)
        emit(json.dumps(rec))
    summary = {
        "device": info["device"], "power_limit_w": info["power_limit_w"],
        "host_cores": os.cpu_count(),
        "n_cards": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "shared_device": True,
        "secondary_metric": "overhead_vs_single",
        "note": ("every shard on one device: 'efficiency' is bounded by "
                 "the one device and says nothing about links between "
                 "cards; 'overhead_vs_single' (same work, sharded vs not) "
                 "is the structural cost of sharding"),
        "max_overhead_vs_single": max(r["overhead_vs_single"]
                                      for r in results),
        "results": results}
    emit(json.dumps(summary))
    return summary


def generic_graph():
    top = lr.CompositeBlock()
    top.connect(lr.UniformRandomSource(lr.ComplexFloat32, 256e3),
                lr.WBFMMonoDemodulator(), lr.DownsamplerBlock(8),
                lr.NopSink())
    return top


def run_generic(max_devices: int = 8, emit=print,
                chunk_size: int = GENERIC_CHUNK, device=None,
                chunks: int = 4) -> list:
    """The ordinary-blocks graph on ("time",) meshes of 2, 4, ... up to
    ``max_devices`` against its serial run: seconds a chunk (best of 3
    trials of ``chunks`` chunks) and the overhead."""
    dev, _ = common.setup(device)

    def time_run(mesh):
        r = Runner(generic_graph(), chunk_size=chunk_size, mesh=mesh,
                   device=dev)

        def pump():
            for _ in range(chunks):
                r._pump_once()
        try:
            return _best(pump, dev) / chunks
        finally:
            r._cleanup_once()

    base = time_run(None)
    rows = []
    for n in (s for s in GENERIC_SIZES if s <= max_devices):
        t = time_run(Mesh((n,), ("time",)))
        rec = {"devices": n, "mesh": [n], "axis": "time",
               "samples_per_sec": chunk_size / t,
               "serial_samples_per_sec": chunk_size / base,
               "overhead_vs_single": t / base - 1.0}
        rows.append(rec)
        emit(json.dumps(rec))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--max-devices", type=int, default=8)
    args = ap.parse_args(argv)
    summary = run(args.max_devices)
    rows = run_generic(args.max_devices)
    summary["generic_runner_results"] = rows
    summary["max_overhead_generic_runner"] = max(
        (r["overhead_vs_single"] for r in rows), default=None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
