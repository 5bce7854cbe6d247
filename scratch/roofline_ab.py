#!/usr/bin/env python3
"""The HBM copy probes R1 and R2 of csrc/roofline.cu on one card, timed by
device time: an older build as the baseline, the sweep of the ring's
constants, and the shipped kernels against the older build in turns.

    git show <commit>:luaradio_tpu_torch/csrc/roofline.cu \\
        > .ab_old/roofline_old.cu
    python3 scratch/roofline_ab.py [--old .ab_old/roofline_old.cu]
        [--parts b0,sweep,ab,waits] [--points "S,N,P,H,D,C;..."]
        [--rounds 2] [--out PATH]

Parts (comma-separated; b0, sweep and ab by default):

* ``b0``: the older build's R1, R2 and R3 at [8, 2^23] float32, beside
  their twins and their library calls (``dst.copy_(x)``, ``torch.atan2``
  over the tile views with ``out=``): each as "a launch" (CUDA events
  around one call, median of 25), as device time by CUDA-graph replay (20
  calls a graph, median of 10 replays) and as ``b2b``, n back-to-back
  launches between two events, fenced once, over n (the JAX system's
  ``_timeit``).  The old build's copies are held bit-equal first.
* ``sweep``: the measurement build ``roofline_sweep`` (ops/cudabuild.py
  PROBES, csrc/roofline.cu with -DLR_ROOFLINE_SWEEP): every instance of
  the ring (stage S KiB, stages N, loads ahead P, the L2 evict-first
  hint H, slabs dealt round robin or claimed from the counter D) at every
  CTA count an SM (C) that shared memory allows, for R1 (P = 1) and R2
  (P = N - 1), the claimed ones with the counters kept zero by the
  kernel and also zeroed by a memset each launch; each held bit-equal on
  the edge shapes (ops/roofline.py ``edge_shapes``) and at [8, 2^23],
  traced once there (%globaltimer: each CTA's end, the store/load
  overlap), then timed by device time in ``--rounds`` rounds (every
  other one reversed) beside ``copy_`` before the first and after each;
  ``--points`` keeps the listed points only.
* ``ab``: the shipped R1 and R2 (ops/roofline.py) against the older
  build's, in the order old, new, new, old, by device time and b2b,
  beside ``copy_``.
* ``waits``: the shipped R1 and R2 built as shipped and as the sweep
  builds them (mbarrier waits reading the clock between tries), and the
  wrappers, by device time in turns beside ``copy_``.

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

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from luaradio_tpu_torch.ops import cudabuild, roofline  # noqa: E402

C, W, TILE = 8, 1 << 23, 1 << 15
REPS, B2B = 25, 50
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def median_ms(fn, reps=REPS):
    """A launch: CUDA events around one call, median of ``reps``."""
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
    """Device time: ``n`` calls captured in a CUDA graph, median replay
    over ``n``."""
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
    del graph
    return statistics.median(times)


def b2b_ms(fn, n=B2B):
    """``n`` back-to-back calls between two events, fenced once, over n."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def times(fn):
    return {"launch_ms": median_ms(fn), "device_ms": graph_ms(fn),
            "b2b_ms": b2b_ms(fn)}


def build_old(src):
    lib = os.path.join(os.path.dirname(os.path.abspath(src)),
                       "libroofline_old.so")
    cmd = [cudabuild.nvcc(), *cudabuild.NVCC_FLAGS, "-o", lib, src]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    h = ctypes.CDLL(lib)
    h.lr_hbm_copy.argtypes = [_VP, _VP, _LL, _I, _VP, _VP]
    h.lr_atan2_halves.argtypes = [_VP, _VP, _LL, _LL, _LL, _VP]
    h.lr_error_string.argtypes = [_I]
    h.lr_error_string.restype = ctypes.c_char_p
    return h


def old_copy(lib, double_buffered):
    def run(x):
        out = torch.empty_like(x)
        code = lib.lr_hbm_copy(x.data_ptr(), out.data_ptr(), x.numel() * 4,
                               int(double_buffered), None,
                               torch.cuda.current_stream().cuda_stream)
        cudabuild.check(lib, code, "old hbm_copy")
        return out
    return run


def old_atan2(lib):
    def run(x):
        c, t = x.shape[0], x.shape[1] // 2
        out = torch.empty((c, t), device=x.device)
        code = lib.lr_atan2_halves(x.data_ptr(), out.data_ptr(), c, t, TILE,
                                   torch.cuda.current_stream().cuda_stream)
        cudabuild.check(lib, code, "old atan2_halves")
        return out
    return run


def hold(name, fn, x):
    got = fn(x)
    torch.cuda.synchronize()
    if not torch.equal(got, x):
        raise AssertionError(f"{name} {tuple(x.shape)}: the copy differs")


def part_b0(old, x, dst):
    view = x.reshape(C, W // TILE, 2, TILE // 2)
    out = torch.empty((C, W // TILE, TILE // 2), device=x.device)
    r1, r2, r3 = old_copy(old, False), old_copy(old, True), old_atan2(old)
    for name, fn in (("R1", r1), ("R2", r2)):
        hold(f"old {name}", fn, x)
        hold(f"old {name}", fn, x[:3, :2 * 5003].contiguous())
    e = (r3(x) - roofline.atan2_halves_reference(x, TILE)).abs().max()
    rec = {"atan2_max_abs_err": float(e)}
    for rnd in (1, 2):
        for name, fn in (("R1", lambda: r1(x)), ("R2", lambda: r2(x)),
                         ("copy_twin", lambda: roofline.hbm_copy_reference(
                             x)),
                         ("copy_", lambda: dst.copy_(x)),
                         ("R3", lambda: r3(x)),
                         ("atan2_twin",
                          lambda: roofline.atan2_halves_reference(x, TILE)),
                         ("torch.atan2", lambda: torch.atan2(
                             view[:, :, 0], view[:, :, 1], out=out))):
            rec[f"{name} round {rnd}"] = t = times(fn)
            print(f"b0 {name} round {rnd}: {json.dumps(t)}", flush=True)
    return rec


CTAS_PER_SM = (1, 2, 4)


def sweep_lib():
    lib = cudabuild.load("roofline_sweep")
    lib.lr_hbm_copy_variant.argtypes = [_VP, _VP, _LL] + [_I] * 6 + [
        _VP, _I, _VP, _VP]
    lib.lr_hbm_copy_variant_fit.argtypes = [_I] * 5
    lib.lr_hbm_copy_variants.argtypes = [_VP, _I]
    return lib


def instances(lib):
    buf = (ctypes.c_int * 5000)()
    n = lib.lr_hbm_copy_variants(buf, 1000)
    return [tuple(buf[5 * i:5 * i + 5]) for i in range(n)]


def variant(lib, kib, n, p, hint, dyn, per_sm, memset=1):
    """A point's copy.  memset 1: fresh counters zeroed by a memset each
    call; 0: one pair of counters kept zero by the kernel's last CTA."""
    kept = torch.zeros(2, dtype=torch.int64, device="cuda")

    def run(x, trace=None):
        out = torch.empty_like(x)
        claims = torch.empty(2, dtype=torch.int64, device=x.device) \
            if memset else kept
        code = lib.lr_hbm_copy_variant(
            x.data_ptr(), out.data_ptr(), x.numel() * 4, kib, n, p, hint,
            dyn, per_sm, claims.data_ptr(), memset,
            None if trace is None else trace.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        cudabuild.check(lib, code, f"variant {kib} KiB x {n}, P {p}")
        return out
    return run


def cta_spread(trace, ctas):
    """Each CTA's end (its last store read) from the kernel's first load
    issue, in us: min, median, max; and its slabs: min, max."""
    t = trace.astype("int64")
    t0 = t[:, 0][t[:, 0] > 0].min()
    ends, counts = [], []
    for c in range(ctas):
        rows = t[t[:, 4] == c]
        if len(rows):
            ends.append((rows[:, 3].max() - t0) / 1e3)
            counts.append(len(rows))
    ends.sort()
    return {"end_us_min": ends[0], "end_us_median": ends[len(ends) // 2],
            "end_us_max": ends[-1], "slabs_min": min(counts),
            "slabs_max": max(counts)}


def part_sweep(x, dst, sms, only=None, rounds=2):
    """Every point (or those of ``only``: (stage KiB, stages, ahead, hint,
    dynamic, CTAs an SM) each) held on the edge
    shapes and at [8, 2^23], then timed by device time there in
    ``rounds`` rounds, every other one in reverse order, copy_ before
    the first and after each."""
    lib = sweep_lib()
    points = []
    for kib, n, p, hint, dyn in instances(lib):
        fit = lib.lr_hbm_copy_variant_fit(kib, n, p, hint, dyn)
        for per_sm in CTAS_PER_SM:
            if per_sm <= fit and (only is None or (
                    kib, n, p, hint, dyn, per_sm) in only):
                for memset in ((1, 0) if dyn and hint and only is None
                               else (0,)):
                    points.append((kib, n, p, hint, dyn, per_sm, memset))
    gen = torch.Generator(device=x.device).manual_seed(11)
    recs = {}
    runs = {pt: variant(lib, *pt) for pt in points}
    for pt in points:
        kib, n, p, hint, dyn, per_sm, memset = pt
        run = runs[pt]
        ring = roofline.Ring(kib * 1024, n, p, per_sm, bool(hint), bool(dyn))
        for name, (c, w) in roofline.edge_shapes(ring, per_sm * sms).items():
            e = torch.randn((c, w), generator=gen, device=x.device)
            hold(f"{pt} {name}", run, e)
        hold(f"{pt}", run, x)
        slabs = roofline.n_slabs(x.numel() * 4, kib * 1024)
        trace = torch.zeros((slabs, 5), dtype=torch.int64, device=x.device)
        if not torch.equal(run(x, trace), x):
            raise AssertionError(f"{pt}: the traced copy differs")
        ctas = min(per_sm * sms, slabs)
        tr = trace.cpu().numpy()
        ov = roofline.ring_overlap(tr, ctas)
        recs[pt] = {"stage_kib": kib, "stages": n, "ahead": p,
                    "evict_first": hint, "dynamic": dyn,
                    "ctas_per_sm": per_sm, "memset": memset,
                    "kernel": "R1" if p == 1 else "R2",
                    "overlap_share": ov["overlap_share"],
                    "traced": cta_spread(tr, ctas), "device_ms": []}
    print(f"sweep: {len(points)} points held on the edge shapes and at "
          f"{tuple(x.shape)}", flush=True)
    copy_ms = [graph_ms(lambda: dst.copy_(x))]
    for rnd in range(rounds):
        order = points[::-1] if rnd % 2 else points
        for pt in order:
            run = runs[pt]
            recs[pt]["device_ms"].append(graph_ms(lambda: run(x)))
        copy_ms.append(graph_ms(lambda: dst.copy_(x)))
    rows = []
    for pt in points:
        r = recs[pt]
        r["device_ms_median"] = statistics.median(r["device_ms"])
        r["over_copy_"] = r["device_ms_median"] / statistics.median(copy_ms)
        rows.append(r)
    for r in sorted(rows, key=lambda r: r["device_ms_median"])[:12]:
        print(f"sweep {r['kernel']} S {r['stage_kib']} N {r['stages']} "
              f"P {r['ahead']} h {r['evict_first']} d {r['dynamic']} "
              f"m {r['memset']} "
              f"c {r['ctas_per_sm']}: {r['device_ms_median']:.5f} ms "
              f"({r['over_copy_']:.4f}x)", flush=True)
    print(f"sweep copy_ device ms {copy_ms}", flush=True)
    best = {k: min((r for r in rows if r["kernel"] == k),
                   key=lambda r: r["device_ms_median"]) for k in ("R1", "R2")}
    return {"points": rows, "copy_device_ms": copy_ms, "best": best}


def part_ab(old, x, dst):
    """Shipped R1/R2 against the old build's, old, new, new, old."""
    for name, fn in (("R1", roofline.hbm_copy_serial),
                     ("R2", roofline.hbm_copy_double_buffered)):
        hold(f"new {name}", fn, x)
    rec = {}
    builds = {"old": (old_copy(old, False), old_copy(old, True)),
              "new": (roofline.hbm_copy_serial,
                      roofline.hbm_copy_double_buffered)}
    for i, which in enumerate(("old", "new", "new", "old")):
        r1, r2 = builds[which]
        for name, fn in (("R1", r1), ("R2", r2),
                         ("copy_", lambda t: dst.copy_(t))):
            key = f"{which} {name}" if name != "copy_" else "copy_"
            t = {"device_ms": graph_ms(lambda: fn(x)),
                 "b2b_ms": b2b_ms(lambda: fn(x))}
            rec.setdefault(key, []).append(t)
            print(f"ab {i} {key}: {json.dumps(t)}", flush=True)
    return rec


def build_flags(flags, name):
    """csrc/roofline.cu built with extra nvcc ``flags`` into .ab_old/."""
    os.makedirs(".ab_old", exist_ok=True)
    lib = os.path.abspath(f".ab_old/libroofline_{name}.so")
    cmd = [cudabuild.nvcc(), *cudabuild.NVCC_FLAGS, *flags, "-o", lib,
           str(cudabuild.CSRC / "roofline.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    h = ctypes.CDLL(lib)
    h.lr_hbm_copy.argtypes = [_VP, _VP, _LL, _I, _VP, _I, _VP, _VP]
    h.lr_error_string.argtypes = [_I]
    h.lr_error_string.restype = ctypes.c_char_p
    return h


def kept_copy(lib, double_buffered):
    kept = torch.zeros(2, dtype=torch.int64, device="cuda")

    def run(x):
        out = torch.empty_like(x)
        code = lib.lr_hbm_copy(x.data_ptr(), out.data_ptr(), x.numel() * 4,
                               int(double_buffered), kept.data_ptr(), 0,
                               None, torch.cuda.current_stream().cuda_stream)
        cudabuild.check(lib, code, "hbm_copy")
        return out
    return run


def part_waits(x, dst, rounds=4):
    """The shipped R1/R2 as built (their mbarrier waits spinning) and as
    the measurement build has them (reading the clock between tries, its
    hang guard), and the wrappers; by device time, in turns."""
    builds = {"spin": [], "guard": ["-DLR_ROOFLINE_SWEEP"]}
    fns = {}
    for name, flags in builds.items():
        lib = build_flags(flags, name.replace(" ", ""))
        for k, db in (("R1", False), ("R2", True)):
            fns[f"{k} {name}"] = kept_copy(lib, db)
            hold(f"{k} {name}", fns[f"{k} {name}"], x)
    fns["R1 wrapper"] = roofline.hbm_copy_serial
    fns["R2 wrapper"] = roofline.hbm_copy_double_buffered
    fns["copy_"] = lambda t: dst.copy_(t)
    rec = {k: [] for k in fns}
    keys = list(fns)
    for rnd in range(rounds):
        for k in (keys[::-1] if rnd % 2 else keys):
            rec[k].append(graph_ms(lambda: fns[k](x)))
    for k, v in rec.items():
        print(f"waits {k}: {statistics.median(v):.5f} {v}", flush=True)
    return rec


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    parts = arg("--parts", "b0,sweep,ab").split(",")
    res = {"card": smi, "torch": torch.__version__, "parts": parts,
           "nbytes_moved": 2 * C * W * 4}
    t0 = time.monotonic()
    old = build_old(arg("--old", ".ab_old/roofline_old.cu"))
    print(f"old build in {time.monotonic() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((C, W), generator=gen, device=dev)
    dst = torch.empty_like(x)
    if "b0" in parts:
        res["b0"] = part_b0(old, x, dst)
    if "sweep" in parts:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        t0 = time.monotonic()
        cudabuild.build(("roofline_sweep",))
        print(f"sweep build in {time.monotonic() - t0:.1f} s", flush=True)
        only = arg("--points", None)
        if only:
            only = {tuple(int(v) for v in pt.split(","))
                    for pt in only.split(";")}
        res["sweep"] = part_sweep(x, dst, sms, only,
                                  int(arg("--rounds", "2")))
    if "ab" in parts:
        res["ab"] = part_ab(old, x, dst)
    if "waits" in parts:
        res["waits"] = part_waits(x, dst, int(arg("--rounds", "4")))
    print(json.dumps({k: v for k, v in res.items() if k != "sweep"}),
          flush=True)
    out = arg("--out", None)
    if out:
        with open(out, "w") as f:
            f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()
