#!/usr/bin/env python3
"""The overlap scan of csrc/pll_overlap.cu on one card, timed by device
time: an older build as the baseline, the sweep of the ring's constants
(and of a register-pipelined one-thread variant), and the shipped kernel
against the older build in turns, each beside the chain probe.

    git show 2f21e18:luaradio_tpu_torch/csrc/pll_overlap.cu \\
        > .ab_old/pll_overlap_old.cu
    python3 scratch/scan_ab.py [--old .ab_old/pll_overlap_old.cu]
        [--parts hold,sweep,ab] [--points "0,3,-1"] [--rounds 3]
        [--out PATH]

The shapes are the scan's on the port's paths:

* ``2^16``: the stereo pilot's 2^16-sample hold chunk (chip_smoke.py
  phase_overlap_hold): 8 segments of 8 192 after 1 585 warm-up steps;
* ``2^22``: the block benchmark's acquiring PLL row (PLLBlock(1e3, 200e3,
  220e3) at 1 MS/s): 1 024 segments of 4 096 after 722 steps;
* ``bank C``: the stereo bank's PLL at 65 536 samples (256 kS/s),
  C in chip_smoke.py's BATCH_ROWS (1, 8, 64, 132, 264) rows: 8 segments
  of 8 192 a row after 1 839 steps.

Parts (comma-separated; all three by default):

* ``hold``: the shipped kernel (through ops/pll_overlap.py _scan_kernel)
  and the older build against the plain scan (_scan_reference) on the
  2^16 chunk and on edge shapes (W and L not multiples of the stage, W
  = 0, L not a multiple of 4, several rows, a last block part full, x 8
  bytes off 16), within 1e-6 (0 expected) and with equal snapshots; then
  every instance of the measurement build (ops/cudabuild.py PROBES
  ``pll_overlap_sweep``) bit-equal to the older build on the edge shapes
  and on the 2^16, 2^22, bank 8 and bank 264 shapes.
* ``sweep``: every instance (segments a block G, steps a stage T, stages
  P, store 0 bulk from shared memory / 1 straight to global memory; -1
  the pipelined one-thread variant) and the older build, the kernel
  alone on preallocated outputs, by device time (CUDA-graph replay, 3
  calls a graph, median of 3 replays) on every shape, in ``--rounds``
  rounds, every other one reversed; ``--points`` keeps the listed
  instances only.
* ``ab``: the shipped wrapper and kernel against the older build in the
  order old, new, new, old on every shape, beside the chain probe
  (overlap_chain_probe, 2^14 steps): each time also as ns a serial step
  and as a ratio to the chain floor (the probe's ns a step x W+L).

Prints the card's name and power limit first and one JSON object as its
last line, also written to the file --out names.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from luaradio_tpu_torch.blocks.signal import carrier  # noqa: E402
from luaradio_tpu_torch.ops import cudabuild, pll_overlap  # noqa: E402

BATCH_ROWS = (1, 8, 64, 132, 264)
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: edge shapes (rows, segments a row, L, W, x 8 bytes off 16)
EDGES = ((1, 4, 96, 37, 0), (2, 3, 64, 0, 1), (1, 2, 50, 50, 0),
         (3, 5, 40, 13, 1), (1, 8, 128, 33, 1), (2, 4, 70, 9, 0),
         (1, 3, 17, 5, 1), (1, 40, 32, 31, 0), (2, 24, 256, 100, 1))


def arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def graph_ms(fn, n=3, reps=3):
    """Device time: ``n`` calls captured in a CUDA graph, median replay
    over ``n``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
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
    del graph
    return statistics.median(times)


def loop_params(loop, lo, hi, rate):
    blk = carrier.PLLBlock(loop, lo, hi)
    blk.input_rate = rate
    blk.initialize()
    return blk._alpha, blk._beta, blk._freq_min, blk._freq_max


def shapes():
    """name -> (rows, n, (alpha, beta, fmin, fmax), mult, tone / rate,
    noise)."""
    stereo = loop_params(100.0, 19e3 - 50, 19e3 + 50, 1102500 / 5)
    acq = loop_params(1e3, 200e3, 220e3, 1e6)
    bank = loop_params(100.0, 19e3 - 50, 19e3 + 50, 256000)
    out = {"2^16": (1, 1 << 16, stereo, 2.0, 19e3 / (1102500 / 5), 0.3),
           "2^22": (1, 1 << 22, acq, 1.0, 0.21, 0.8)}
    for c in BATCH_ROWS:
        out[f"bank {c}"] = (c, 65536, bank, 2.0, 19e3 / 256000, 0.3)
    return out


class Case:
    """One shape's inputs on the card: x [rows, n], the initial states,
    the rounded constants, the plan."""

    def __init__(self, rows, n, params, mult, f, noise, gen, dev,
                 lseg=None, warm=None, shift=0):
        if lseg is None:
            lseg, warm = pll_overlap.plan_overlap(n, float(params[0]))
        self.rows, self.n, self.lseg, self.warm = rows, n, lseg, warm
        self.params, self.mult = params, mult
        t = torch.arange(n, device=dev, dtype=torch.float64)
        z = (torch.polar(torch.ones(rows, n, device=dev, dtype=torch.float64),
                         2 * np.pi * f * t + torch.rand(
                             rows, 1, generator=gen, device=dev,
                             dtype=torch.float64) * 6.28)
             + noise * torch.randn(rows, n, generator=gen, device=dev,
                                   dtype=torch.complex128)).to(
                                       torch.complex64)
        buf = torch.empty(rows * n + 1, dtype=torch.complex64, device=dev)
        self.x = buf[shift:shift + rows * n].view(rows, n)
        self.x.copy_(z)
        s = n // lseg
        st = tuple(torch.full((rows,), v, device=dev) for v in
                   (0.3, -0.2, float(params[2])))
        self.init = pll_overlap._initial_states(self.x, st, s, lseg, warm)
        self.consts = tuple(float(np.float32(v))
                            for v in (*params, mult))
        self.width = rows * s
        self.steps = warm + lseg

    def outs(self, new_layout=True):
        dev = self.x.device
        shape = (self.width, self.lseg) if new_layout else (self.lseg,
                                                           self.width)
        return [torch.empty(shape, device=dev) for _ in range(3)] + \
            [torch.empty(5, self.width, device=dev) for _ in range(2)]


def build_old(src):
    lib = os.path.join(os.path.dirname(os.path.abspath(src)),
                       "libpll_overlap_old.so")
    cmd = [cudabuild.nvcc(), *cudabuild.NVCC_FLAGS, "-o", lib, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, proc


def bind(lib, name):
    fn = getattr(lib, name)
    head = [_I] if name == "lr_scan_sweep" else []
    fn.argtypes = head + [_VP, _I, _I, _I, _I, _VP] + [_F] * 5 + [_VP] * 6
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, case, outs, point=None):
    """A call of a C entry point on the case, into ``outs``."""
    head = () if point is None else (point,)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*head, case.x.data_ptr(), case.rows, case.n // case.lseg,
                  case.lseg, case.warm, case.init.data_ptr(), *case.consts,
                  *(o.data_ptr() for o in outs), stream)
        if code:
            raise RuntimeError(f"launch failed: {code}")
    return run


def as_new(outs):
    """The older build's [L, C S] outputs as [C S, L]."""
    return [o.t().contiguous() for o in outs[:3]] + list(outs[3:])


def equal(a, b):
    return all(torch.equal(torch.nan_to_num(u, 7.0), torch.nan_to_num(
        v, 7.0)) for u, v in zip(a, b))


def max_diff(a, b):
    return max((u - v).abs().max().item() for u, v in zip(a, b))


def part_hold(libs, gen, dev):
    old, sweep, points = libs["old"], libs["sweep"], libs["points"]
    rec = {"twin": {}, "points": {}}
    cases = {f"edge {e}": Case(e[0], e[1] * e[2], (0.05, 0.0012, -0.3, 0.3),
                               2.0, 0.21, 0.3, gen, dev, e[2], e[3], e[4])
             for e in EDGES}
    sh = shapes()
    cases["2^16"] = Case(*sh["2^16"], gen, dev)
    for name, case in cases.items():
        t0 = time.monotonic()
        exp = pll_overlap._scan_reference(case.x, case.init, case.consts,
                                          case.lseg, case.warm)
        torch.cuda.synchronize()
        twin_s = time.monotonic() - t0
        new = pll_overlap._scan_kernel(case.x, case.init, case.consts,
                                       case.lseg, case.warm)
        o = case.outs(False)
        launcher(old, case, o)()
        o = as_new(o)
        torch.cuda.synchronize()
        d_new, d_old = max_diff(new, exp), max_diff(o, exp)
        rec["twin"][name] = {"new": d_new, "old": d_old,
                             "new_equals_old": equal(new, o),
                             "twin_s": twin_s}
        print(f"hold {name}: |new - twin| {d_new:.3g}, |old - twin| "
              f"{d_old:.3g}, new == old {equal(new, o)} (twin "
              f"{twin_s:.1f} s)", flush=True)
        if d_new > 1e-6:
            raise AssertionError(f"hold {name}: |new - twin| {d_new} > 1e-6")
    for name in ("2^22", "bank 8", "bank 264"):
        cases[name] = Case(*sh[name], gen, dev)
    for name, case in cases.items():
        o = case.outs(False)
        launcher(old, case, o)()
        exp = as_new(o)
        for i, pt in points.items():
            got = case.outs()
            launcher(sweep, case, got, i)()
            ok = equal(got, exp)
            rec["points"].setdefault(str(pt), {})[name] = ok
            if not ok:
                raise AssertionError(f"hold {name}: instance {pt} differs "
                                     f"from the older build by "
                                     f"{max_diff(got, exp)}")
        print(f"hold {name}: {len(points)} instances bit-equal to the older "
              f"build", flush=True)
    return rec


def chain_floor(case, dev):
    pll_overlap.chain_probe(64, dev, *case.params)
    steps = 1 << 14
    ms, cycles = pll_overlap.chain_probe(steps, dev, *case.params)
    ns = ms * 1e6 / steps
    return {"ns_per_step": ns, "cycles_per_step": cycles / steps,
            "floor_ms": ns * case.steps / 1e6}


def part_sweep(libs, gen, dev, only, rounds):
    old, sweep, points = libs["old"], libs["sweep"], libs["points"]
    keep = {i: pt for i, pt in points.items()
            if only is None or i in only}
    cases = {name: Case(*s, gen, dev) for name, s in shapes().items()}
    times = {}
    for r in range(rounds):
        order = list(keep.items())
        if r % 2:
            order.reverse()
        for name, case in cases.items():
            o = case.outs(False)
            times.setdefault("old", {}).setdefault(name, []).append(
                graph_ms(launcher(old, case, o)))
            for i, pt in order:
                o = case.outs()
                times.setdefault(str(pt), {}).setdefault(name, []).append(
                    graph_ms(launcher(sweep, case, o, i)))
        print(f"sweep round {r} done", flush=True)
    floors = {name: chain_floor(case, dev) for name, case in cases.items()}
    table = {}
    for pt, by in times.items():
        table[pt] = {}
        for name, ts in by.items():
            ms = statistics.median(ts)
            table[pt][name] = {
                "ms": ms, "all_ms": ts,
                "ns_per_step": ms * 1e6 / cases[name].steps,
                "floor_ratio": ms / floors[name]["floor_ms"],
                "vs_old": ms / statistics.median(times["old"][name])}
    for pt, by in table.items():
        print(f"sweep {pt}: " + "; ".join(
            f"{n} {v['ms']:.4f} ms ({v['floor_ratio']:.3f}x floor, "
            f"{v['vs_old']:.3f}x old)" for n, v in by.items()), flush=True)
    return {"floors": floors, "table": table}


def part_ab(libs, gen, dev):
    old = libs["old"]
    shipped = libs["new"]
    cases = {name: Case(*s, gen, dev) for name, s in shapes().items()}
    out = {}
    for name, case in cases.items():
        o_old, o_new = case.outs(False), case.outs()
        run_old = launcher(old, case, o_old)
        run_new = launcher(shipped, case, o_new)

        def wrapper(case=case):
            pll_overlap._scan_kernel(case.x, case.init, case.consts,
                                     case.lseg, case.warm)
        seq = {"old": [], "new": [], "wrapper": []}
        for who in ("old", "new", "new", "old"):
            if who == "old":
                seq["old"].append(graph_ms(run_old))
            else:
                seq["new"].append(graph_ms(run_new))
                seq["wrapper"].append(graph_ms(wrapper))
        floor = chain_floor(case, dev)
        rec = {"rows": case.rows, "segments": case.width,
               "lseg": case.lseg, "warm": case.warm, "steps": case.steps,
               "chain": floor}
        for who, ts in seq.items():
            ms = statistics.median(ts)
            rec[who] = {"ms": ms, "all_ms": ts,
                        "ns_per_step": ms * 1e6 / case.steps,
                        "floor_ratio": ms / floor["floor_ms"]}
        out[name] = rec
        print(f"ab {name} [{case.width} segments of {case.lseg} after "
              f"{case.warm}]: old {rec['old']['ms']:.4f} ms "
              f"({rec['old']['floor_ratio']:.3f}x floor), new "
              f"{rec['new']['ms']:.4f} ms ({rec['new']['floor_ratio']:.3f}x"
              f"), wrapper {rec['wrapper']['ms']:.4f} ms; floor "
              f"{floor['floor_ms']:.4f} ms ({floor['ns_per_step']:.1f} ns a "
              f"step)", flush=True)
    one = out["bank 1"]
    for c in BATCH_ROWS:
        for who in ("old", "new"):
            out[f"bank {c}"][who]["vs_one_row"] = \
                out[f"bank {c}"][who]["ms"] / one[who]["ms"]
    return out


def main():
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    parts = arg("--parts", "hold,sweep,ab").split(",")
    old_src = arg("--old", ".ab_old/pll_overlap_old.cu")
    t0 = time.monotonic()
    old_path, old_proc = build_old(old_src)
    built = cudabuild.build(("pll_overlap", "pll_overlap_sweep"))
    log, _ = old_proc.communicate()
    if old_proc.returncode:
        raise RuntimeError(f"nvcc failed for {old_src}:\n{log}")
    for name, (secs, text) in built.items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build {name} in {secs:.1f} s: {len(regs)} lines; "
              + " | ".join(regs[:12]), flush=True)
    print(f"builds ready in {time.monotonic() - t0:.1f} s", flush=True)
    sweep_lib = cudabuild.load("pll_overlap_sweep")
    sweep_lib.lr_scan_sweep_point.argtypes = [_I, ctypes.POINTER(_I)]
    points = {}
    for i in range(sweep_lib.lr_scan_sweep_count()):
        o = (_I * 5)()
        sweep_lib.lr_scan_sweep_point(i, o)
        points[i] = tuple(o)
    points[-1] = "pipe"
    pll_overlap._lib()                      # binds the shipped entry points
    libs = {"old": bind(ctypes.CDLL(old_path), "lr_pll_overlap_scan"),
            "new": cudabuild.load("pll_overlap").lr_pll_overlap_scan,
            "sweep": bind(sweep_lib, "lr_scan_sweep"), "points": points}
    gen = torch.Generator(device=dev).manual_seed(1717)
    result = {"device": smi, "shipped": pll_overlap.shipped_ring(),
              "points": {str(i): str(p) for i, p in points.items()}}
    only = arg("--points", None)
    only = None if only is None else {int(v) for v in only.split(",")}
    rounds = int(arg("--rounds", "3"))
    if "hold" in parts:
        result["hold"] = part_hold(libs, gen, dev)
    if "sweep" in parts:
        result["sweep"] = part_sweep(libs, gen, dev, only, rounds)
    if "ab" in parts:
        result["ab"] = part_ab(libs, gen, dev)
    line = json.dumps(result)
    out = arg("--out", None)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
