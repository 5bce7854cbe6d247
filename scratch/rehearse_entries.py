"""Rehearse chip_smoke.py's roofline and entries phases, and the bench-graph
and block-row construction that now come from luaradio_tpu_torch/benchmarks,
on the CPU at a small size (no card, no nvcc):

    python scratch/rehearse_entries.py [roofline] [entries] [bench] [blocks]

The kernel wrappers take their twins (a CPU tensor) and are wrapped to
count their calls as launches; CUDA events and graphs, R2's trace, the
card's SM count and the pageable copy rate are stubbed; sizes are cut.  It checks control flow, shapes and
the phases' own assertions, not the card: no number it prints is a
device's.  About 35 s for all four.
"""

import functools
import os
import sys
import tempfile
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
torch.set_num_threads(4)
torch.cuda.synchronize = lambda *a, **k: None

import chip_smoke as cs  # noqa: E402
from luaradio_tpu_torch.benchmarks import (bench, bench_roofline,  # noqa: E402
                                           bench_scaling, common)
from luaradio_tpu_torch.ops import roofline  # noqa: E402
from luaradio_tpu_torch.parallel import flagship  # noqa: E402


def counting(fn):
    def wrapper(*args, **kwargs):
        wrapper.launches += 1
        return fn(*args, **kwargs)
    wrapper.launches = 0
    return wrapper


for name in ("hbm_copy_serial", "hbm_copy_double_buffered", "atan2_halves"):
    setattr(roofline, name, counting(getattr(roofline, name)))
cs.wbfm.wbfm_mono = flagship.wbfm_mono = counting(cs.wbfm.wbfm_mono)
roofline.ring_ctas = lambda: 4
roofline.ring_trace = lambda x: np.tile(
    np.array([[1, 5, 3, 6, 0]]),
    (roofline.n_slabs(x.numel() * 4, roofline.R2.stage_bytes), 1))
torch.cuda.get_device_properties = lambda dev: types.SimpleNamespace(
    multi_processor_count=2)
common.h2d_pageable_MBps = lambda dev, **kw: 1000.0
cs.median_ms = lambda fn, reps=cs.REPS: (fn(), 1.0)[1]
cs.graph_ms = lambda fn, n=20, reps=10: (fn(), 1.0)[1]
cs.ROOF_W = 1 << 16
cs.proofline.run = functools.partial(
    bench_roofline.run, c=2, t=1 << 15, m=64, pll_n=1 << 10, reps=2,
    bench_chunk=1 << 14, bench_file=1 << 15)
cs.pbench.run = functools.partial(bench.run, chunk=1 << 14, channels=2,
                                  t=1 << 14, n_file=1 << 15)
cs.ENTRY_BUDGET_S, cs.REALTIME_S = 0.5, 2.0
bench_scaling.run = functools.partial(bench_scaling.run, total_t=8 * 8 * 512)
bench_scaling.run_generic = functools.partial(bench_scaling.run_generic,
                                              chunk_size=1 << 14)


def main(which):
    dev = torch.device("cpu")
    t0 = time.monotonic()
    if "roofline" in which:
        entries = cs.phase_roofline(dev, torch.Generator().manual_seed(1),
                                    "cpu")
        print([(e["name"], e["launches"]) for e in entries])
    with tempfile.TemporaryDirectory() as tmp:
        if "entries" in which:
            k1 = {}
            cs.phase_entries(tmp, dev, "cpu", k1)
            print(k1)
        if "bench" in which:
            cs.BENCH_CHUNK, cs.BENCH_FILE = 1 << 16, 1 << 17
            print(cs.phase_bench_graphs(tmp, dev, "cpu", None))
        if "blocks" in which:
            cs.BLOCK_FILE = 1 << 15
            rows, paths = cs.block_rows(tmp)
            print(len(rows), "rows;", [r[0] for r in rows if not r[3]],
                  "with optimize off;", sorted(paths))
    print(f"rehearsal {time.monotonic() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or ["roofline", "entries", "bench", "blocks"])
