#!/usr/bin/env python3
"""The floor of K3's fractional-multiplier phi_m walk, and K3 beside it.

    python3 scratch/phim_probe.py [--out PATH]

Builds scratch/phim_probe.cu (the walk's loop-carried chain alone, one
thread) with nvcc into a temporary directory and times 2^20 steps of it
(CUDA events; clock64 cycles), then times K3 (csrc/pll.cu) at the stereo
graph's 52 430-sample chunk with the stereo PLL's constants at
multipliers 2 and 2.5: a launch (CUDA events, median of 25) and device
time (CUDA-graph replay).  The walk's floor at that chunk is the probe's
time a step times 52 430.  Prints the card's name and power limit, then
one JSON object as its last line (also written to --out, if given).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from luaradio_tpu_torch.ops import cudabuild, pll  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from pll_ab import graph_ms, median_ms, signal, stereo_params  # noqa: E402

CHUNK, STEPS = 52430, 1 << 20


def probe(dev, k):
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "phim_probe.cu")
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "libphim_probe.so")
        subprocess.run([cudabuild.nvcc(), *cudabuild.NVCC_FLAGS, "-o", lib,
                        src], check=True, capture_output=True, text=True)
        h = ctypes.CDLL(lib)
    h.lr_phim_walk_probe.argtypes = [ctypes.c_int] + [ctypes.c_float] * 3 \
        + [ctypes.c_void_p] * 3
    h.lr_phim_walk_probe.restype = ctypes.c_int
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = []
    for n in (1024, STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        code = h.lr_phim_walk_probe(n, float(k["k_fm"]), float(k["k_amb"]),
                                    float(np.float32(2 * np.pi)),
                                    cycles.data_ptr(),
                                    sink.data_ptr(), stream)
        b.record()
        b.synchronize()
        if code:
            raise RuntimeError(f"phim_walk_probe: CUDA error {code}")
        res.append((a.elapsed_time(b) * 1e6 / n, int(cycles.item()) / n))
    return res[-1]


def main():
    if not torch.cuda.is_available():
        print("phim_probe: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    params = stereo_params()
    cudabuild.build(("pll",))
    ns, cyc = probe(dev, pll.constants(*params, 2.5))
    gen = torch.Generator(device=dev).manual_seed(5)
    x = signal(gen, CHUNK, dev)
    state = torch.tensor([0.0, 0.0, float(params[2])], device=dev)
    out = {"device": smi, "chunk": CHUNK, "probe_ns_per_step": ns,
           "probe_cycles_per_step": cyc,
           "walk_floor_ms": ns * CHUNK / 1e6}
    for mult in (2.0, 2.5):
        def run(mult=mult):
            pll.pll_phase(x, state, *params, mult)
        out[f"mult_{mult}"] = {"ms": median_ms(run), "graph_ms": graph_ms(run)}
    out["floor_ratio_2.5"] = out["mult_2.5"]["graph_ms"] / out["walk_floor_ms"]
    text = json.dumps(out)
    if "--out" in sys.argv:
        with open(sys.argv[sys.argv.index("--out") + 1], "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
