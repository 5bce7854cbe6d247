#!/usr/bin/env python3
"""K3 of csrc/pll.cu against an older build of the same kernel, in one
process on one card, in turns (old, new, new, old).

    git show 41525df:luaradio_tpu_torch/csrc/pll.cu > .ab_old/pll_old.cu
    python3 scratch/pll_ab.py [--old .ab_old/pll_old.cu] [--out PATH]

The old source must have the same C interface (lr_pll_phase).  It is
built with nvcc beside the current sources (``.ab_old/`` is gitignored).
Both builds are held against the plain PyTorch twin at the kernel's tile
edges, at N = 0, at 8 192 samples and at the stereo graph's 52 430-sample
chunk, for multipliers 1, 2, 2.5 and 3 (max |kernel - twin| of out, err
and state; 0 expected), and against each other at 1 764 000 samples.
Then, with the stereo PLL's constants and multiplier 2, each is timed at
52 430 and 1 764 000 samples four rounds in the order old, new, new, old:
per launch (CUDA events, median of 25 launches, 5 at the long length) and
device time (CUDA-graph replay).  The chain probe of the new build gives
the floor, and each time stands beside it as a ratio; a second probe
(scratch/pll_chain_probe.cu) times the chain as the new walker writes it
(one subtraction after the F2I instead of two integer operations).
Multiplier 2.5 is timed at 52 430 too.  Prints one JSON object as its
last line, and writes it to the file --out names, if given.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from luaradio_tpu_torch.ops import cudabuild, pll  # noqa: E402

REPS = 25
RATE = 1102500
CHUNK, LONG = 52430, 8 * RATE // 5
_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def median_ms(fn, reps=REPS):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, n=20, reps=10):
    """Device time of one call: ``n`` calls captured in a CUDA graph,
    replayed ``reps`` times, median replay over ``n``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def build_old(src):
    lib = os.path.join(os.path.dirname(os.path.abspath(src)),
                       "libpll_old.so")
    subprocess.run([cudabuild.nvcc(), *cudabuild.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(lib)
    h.lr_pll_phase.argtypes = [_VP, _LL, _VP] + [_F] * 10 + \
        [_I, _I, _VP, _VP, _VP, _VP]
    h.lr_pll_phase.restype = ctypes.c_int
    h.lr_error_string.argtypes = [ctypes.c_int]
    h.lr_error_string.restype = ctypes.c_char_p
    return h


def walker_probe(steps, dev):
    """(ns, cycles) a step of scratch/pll_chain_probe.cu, the walker's
    chain alone, with the stereo PLL's constants."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "pll_chain_probe.cu")
    lib = os.path.join(os.path.dirname(os.path.abspath(
        arg("--old", ".ab_old/pll_old.cu"))), "libpll_chain_probe.so")
    subprocess.run([cudabuild.nvcc(), *cudabuild.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(lib)
    h.lr_walker_chain_probe.argtypes = [_I] + [_F] * 5 + [_VP] * 3
    h.lr_walker_chain_probe.restype = ctypes.c_int
    k = pll.constants(*stereo_params(), 2.0)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    out = []
    for n in (1024, steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        code = h.lr_walker_chain_probe(
            n, *(float(k[name]) for name in ("k_ab", "k_b", "fmin_k",
                                             "fmax_k", "fmin_k")),
            cycles.data_ptr(), sink.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        b.record()
        if code:
            raise RuntimeError(f"walker chain probe: CUDA error {code}")
        b.synchronize()
        out = [a.elapsed_time(b) * 1e6 / n, int(cycles.item()) / n]
    return out


def stereo_params():
    """alpha, beta, fmin, fmax of the stereo demodulator's PLL at the IF
    rate (PLLBlock(100, 19e3 - 50, 19e3 + 50, multiplier=2))."""
    from luaradio_tpu_torch.blocks.signal import carrier
    blk = carrier.PLLBlock(100.0, 19e3 - 50, 19e3 + 50, multiplier=2)
    blk.input_rate = RATE / 5
    blk.initialize()
    return blk._alpha, blk._beta, blk._freq_min, blk._freq_max


def signal(gen, n, dev, kind="fm"):
    """A unit phasor with a random-walk phase plus noise ("fm"), noise,
    or a carrier whose first quarter is exact zeros."""
    t = torch.arange(n, device=dev, dtype=torch.float64)
    if kind == "noise":
        z = torch.randn(n, generator=gen, device=dev, dtype=torch.complex128)
    elif kind == "zeros+carrier":
        z = 0.7 * torch.polar(torch.ones_like(t), 2 * np.pi * 0.21 * t + 0.9)
        z[:n // 4] = 0
    else:
        ph = torch.cumsum(0.4 * torch.randn(n, generator=gen, device=dev,
                                            dtype=torch.float64), 0)
        z = torch.polar(torch.ones_like(ph), ph) + 0.1 * torch.randn(
            n, generator=gen, device=dev, dtype=torch.complex128)
    return z.to(torch.complex64)


def diff(a, b):
    """max |a - b| over out, err and state (err and phases mod 2 pi)."""
    def wrapped(u, v):
        d = (u - v).double()
        return float(torch.remainder(d + np.pi, 2 * np.pi).sub(np.pi)
                     .abs().max()) if d.numel() else 0.0
    return max((a[0] - b[0]).abs().max().item() if a[0].numel() else 0.0,
               wrapped(a[1], b[1]), wrapped(a[2][:2], b[2][:2]),
               (a[2][2] - b[2][2]).abs().item())


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    new_lib = pll._lib()
    old = arg("--old", ".ab_old/pll_old.cu")
    old_lib = build_old(old)
    libs = {"old": old_lib, "new": new_lib}
    params = stereo_params()
    gen = torch.Generator(device=dev).manual_seed(7)
    tile = pll.kernel_tile()
    result = {"card": smi, "tile": tile, "hold": {}, "time": {}}

    def run(name, x, state, mult):
        return pll._launch(libs[name], x, state,
                           pll.constants(*params, mult))

    state = torch.tensor([0.3, -0.5, float(params[2])], device=dev)
    worst = {"old": 0.0, "new": 0.0}
    for n in (0, 1, tile - 1, tile, tile + 1, 3 * tile + 5, 8192, CHUNK):
        for kind in ("fm", "noise", "zeros+carrier"):
            x = signal(gen, n, dev, kind)
            for mult in (1.0, 2.0, 2.5, 3.0):
                exp = pll.pll_phase_reference(x, state, *params, mult)
                for name in libs:
                    e = diff(run(name, x, state, mult), exp)
                    worst[name] = max(worst[name], e)
                    if e > 1e-5:
                        raise AssertionError(f"{name} N={n} {kind} x{mult}: "
                                             f"|kernel - twin| {e}")
            if n >= CHUNK:
                break          # the twin's Python loop: one input there
    x = signal(gen, LONG, dev)
    long_err = diff(run("old", x, state, 2.0), run("new", x, state, 2.0))
    result["hold"] = {"max_abs_err_vs_twin": worst,
                      "new_vs_old_at_long": long_err}
    print(f"hold: max |kernel - twin| {worst}; new vs old at {LONG}: "
          f"{long_err}", flush=True)
    if long_err > 1e-5:
        raise AssertionError("new and old differ at the long length")

    pll.chain_probe(1024, dev)
    steps = 1 << 20
    probe_ms, cycles = pll.chain_probe(steps, dev)
    ns_step = probe_ms * 1e6 / steps
    w_ns, w_cycles = walker_probe(steps, dev)
    result["chain_probe"] = {"ns_per_step": ns_step,
                             "cycles_per_step": cycles / steps,
                             "walker_chain_ns_per_step": w_ns,
                             "walker_chain_cycles_per_step": w_cycles}
    print(f"chain probe: {ns_step:.3f} ns, {cycles / steps:.2f} cycles a "
          f"step; the walker's chain alone: {w_ns:.3f} ns, "
          f"{w_cycles:.2f} cycles a step", flush=True)
    for n, mult in ((CHUNK, 2.0), (LONG, 2.0), (CHUNK, 2.5)):
        x = signal(gen, n, dev)
        floor = n * ns_step / 1e6
        reps = REPS if n == CHUNK else 5
        rows = {"old": {"ms": [], "graph_ms": []},
                "new": {"ms": [], "graph_ms": []}}
        for name in ("old", "new", "new", "old"):
            def f(name=name):
                run(name, x, state, mult)
            rows[name]["ms"].append(median_ms(f, reps))
            rows[name]["graph_ms"].append(
                graph_ms(f, *((20, 10) if n == CHUNK else (3, 3))))
        for name in rows:
            rows[name]["floor_ratio"] = [m / floor for m in rows[name]["ms"]]
            rows[name]["walker_chain_ratio"] = [
                m / (n * w_ns / 1e6) for m in rows[name]["graph_ms"]]
        key = f"{n} x{mult}"
        result["time"][key] = dict(rows, floor_ms=floor,
                                   new_over_old=max(rows["new"]["ms"]) /
                                   min(rows["old"]["ms"]))
        print(f"[{key}] floor {floor:.4f} ms; " + "; ".join(
            f"{k} {['%.4f' % v for v in r['ms']]} a launch, "
            f"{['%.4f' % v for v in r['graph_ms']]} device, "
            f"{['%.3f' % v for v in r['floor_ratio']]}x floor"
            for k, r in rows.items()), flush=True)
    out = arg("--out", None)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
