#!/usr/bin/env python3
"""S4 (csrc/wbfm_proto.cu) on one card, timed by device time: an older
build as the baseline, the sweep of the ring's constants, and the shipped
kernel against the older build in turns, with K1 (csrc/wbfm.cu) as the
yardstick on the same input.

    mkdir -p .ab_old
    git show c1a6904:luaradio_tpu_torch/csrc/wbfm_proto.cu \\
        > .ab_old/wbfm_proto_old.cu
    python3 scratch/wbfm_proto_ab.py [--old .ab_old/wbfm_proto_old.cu]
        [--parts b0,hold,sweep,ab,k640,stages,sass] [--rounds 2]
        [--points "i,j,..."] [--out PATH]

The size is the entry point's (benchmarks/wbfm_proto.py): C = 8, T =
2^22, x normal from seed 0, a zero carry, the script's 128 taps, D = 8,
tile 2^14 (2^15 for the t32k variant).  Times (milliseconds a call):

* ``device``: CUDA-graph replay, 5 calls a graph, median of 5 replays
  (no host time between launches);
* ``b2b``: 50 calls back to back between two CUDA events (the JAX
  script's ``timeit``; benchmarks/common.py ``batch_ms``);
* ``launch``: CUDA events around one call, median of 5 ("a launch",
  host time included).

Parts (comma-separated):

* ``b0``: the older build on all 14 variants and K1, every time above;
* ``hold``: the shipped kernel (ops/wbfm_proto.py ``wbfm_proto``) and the
  older build against the twin on all 14 variants (a random carry, inv_gain
  0.7) and on chip_smoke.py's PROBE_S4_SHAPES and ring edge shapes:
  dma_only, deint_only and no_fir bit for bit, the FIR stages within 2e-5
  * scale; every sweep instance the same on the edge shapes;
* ``sweep``: every point of the measurement build ``wbfm_proto_sweep``
  (ops/cudabuild.py PROBES) on the FIR variants v2_sel3_fir22, p_highest
  and p_two_hi and on stage_no_fir, by device time, ``--rounds`` rounds,
  every other one reversed, each point held first (atan2f's branch-free
  fast path bit for bit like libdevice; the Hopper atan2's no_fir within
  FAST_TOL; the diagnostics, no atan2 and no FIR, only timed), and the
  Hopper atan2 against atan2f;
* ``ab``: the older build and the shipped one, each kernel alone on a
  preallocated output, on all 14 variants in the order old, new, new,
  old (device time and a launch), the wrapper's device time and K1
  beside;
* ``k640``: highest and split22 at K1's flagship taps (K 640, D 8, block
  128, tile 2^14) for both builds beside K1 on the same input;
* ``stages``: the shipped build's device time per stage (deint_only,
  no_fir, no_deint, full) against the bytes that stage moves;
* ``sass``: instructions a sample of the shipped build's discriminator
  loop from ``cuobjdump -sass`` (benchmarks/wbfm_proto.py
  ``sass_issue_estimate``), turned into an issue-slot time; the loop's
  SASS is written beside --out's file (wbfm_proto_disc_loop.sass).

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

from luaradio_tpu_torch.benchmarks import wbfm_proto as bench  # noqa: E402
from luaradio_tpu_torch.ops import cudabuild, wbfm, wbfm_proto  # noqa: E402

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
HBM = 3.35e12
D = bench.D
FULL = [v for v in bench.VARIANTS if v[3] == "full"]
SWEEP_VARIANTS = ("v2_sel3_fir22", "p_highest", "p_two_hi", "stage_no_fir")
#: no_fir with the Hopper atan2 against the twin's atan2f (radians, at
#: inv_gain 1): 4 ulp of pi
FAST_TOL = 4 * 2.384185791015625e-07


def arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def graph_ms(fn, n=5, reps=5):
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


def launch_ms(fn, reps=5):
    for _ in range(2):
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


def all_times(fn):
    dev = torch.device("cuda")
    return {"device": graph_ms(fn),
            "b2b": bench.common.batch_ms(fn, dev, 50),
            "launch": launch_ms(fn)}


def build_old(src):
    lib = os.path.join(os.path.dirname(os.path.abspath(src)),
                       "libwbfm_proto_old.so")
    cmd = [cudabuild.nvcc(), *cudabuild.NVCC_FLAGS, "-I",
           str(cudabuild.CSRC), "-o", lib, src]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    h = ctypes.CDLL(lib)
    h.lr_wbfm_proto.argtypes = [_VP, _VP, _VP, _LL, _LL, _I, _I, _F, _I, _I,
                                _I, _I, _VP, _VP]
    h.lr_wbfm_proto.restype = _I
    h.lr_error_string.argtypes = [_I]
    h.lr_error_string.restype = ctypes.c_char_p
    return h


def codes(dp, fp, st):
    deint = wbfm_proto._HALVES if st == "no_deint" else \
        wbfm_proto._DEINT.get(dp, 0)
    return wbfm_proto._STAGE[st], deint, wbfm_proto._FIR.get(fp, 0)


def old_call(lib, carry, x, taps, tile, dp, fp, st, gain=1.0, d=D):
    """The older build's kernel alone on a preallocated output."""
    c, w = x.shape
    k = taps.shape[0]
    out = torch.empty((c, w // 2 // d), dtype=torch.float32,
                      device=x.device)
    stage, deint, fir = codes(dp, fp, st)

    def run():
        code = lib.lr_wbfm_proto(
            x.data_ptr(), carry.data_ptr(), taps.data_ptr(), c, w // 2, k, d,
            float(np.float32(gain)), tile, stage, deint, fir, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        cudabuild.check(lib, code, "old wbfm_proto")
        return out
    return run


def new_call(carry, x, taps, tile, dp, fp, st, gain=1.0, d=D):
    """The shipped wrapper (it allocates its output and the new carry, as
    every caller's call does)."""
    return lambda: wbfm_proto.wbfm_proto(carry, x, taps, d, gain, tile, 128,
                                         dp, fp, st)[1]


def k1_call(x, taps, d=D):
    c = x.shape[0]
    kc = torch.zeros((c, taps.shape[0]), dtype=torch.complex64,
                     device=x.device)
    return lambda: wbfm.wbfm_mono(kc, x, taps, d, 1.0)[1]


def part_b0(old, x, carry, taps):
    res = {"k1": all_times(k1_call(x, taps))}
    for name, dp, fp, st, mul in bench.VARIANTS:
        res[name] = all_times(old_call(old, carry, x, taps,
                                       mul * bench.TILE, dp, fp, st))
        print(f"b0 {name}: {res[name]}", flush=True)
    res["k1_after"] = all_times(k1_call(x, taps))
    print(f"b0 k1: {res['k1']} / {res['k1_after']}", flush=True)
    return res


def _hold_one(label, got, exp, st, fast=False):
    """|got - exp| over scale; raises unless dma_only, deint_only and no_fir
    are bit-equal (no_fir within FAST_TOL with the Hopper atan2) and the FIR
    stages within 2e-5 * scale."""
    torch.cuda.synchronize()
    if got.shape != exp.shape:
        raise AssertionError(f"{label}: {tuple(got.shape)} vs "
                             f"{tuple(exp.shape)}")
    err = float((got - exp).abs().max())
    scale = max(1.0, float(exp.abs().max()))
    if st == "no_fir" and fast:
        if not err <= FAST_TOL:
            raise AssertionError(f"{label}: {err} > {FAST_TOL}")
    elif st in ("dma_only", "deint_only", "no_fir"):
        if not torch.equal(got, exp):
            raise AssertionError(f"{label}: not bit-equal ({err})")
    elif not err <= 2e-5 * scale:
        raise AssertionError(f"{label}: {err} > 2e-5 * {scale}")
    return err / scale


def edge_cases(dev, gen):
    """The ring's edge shapes (ops/wbfm_proto.py edge_shapes, as
    chip_smoke.py holds them) and chip_smoke.py's PROBE_S4_SHAPES: (label,
    carry, x, taps, d, tile, dp, fp, st)."""
    import chip_smoke
    cases = []
    for label, (c, k, d, tile, nt, off, dp, fp, st) in \
            wbfm_proto.edge_shapes().items():
        buf = torch.randn(c * 2 * tile * nt + off, generator=gen,
                          device=dev)
        x = buf[off:].view(c, 2 * tile * nt)
        cr = torch.randn((c, 2 * k), generator=gen, device=dev)
        hs = torch.randn(k, generator=gen, device=dev) / k
        cases.append((label, cr, x, hs, d, tile, dp, fp, st))
    for k, d, tile, block, dp, fp in chip_smoke.PROBE_S4_SHAPES:
        xs = torch.randn((2, 2 * 3 * tile), generator=gen, device=dev)
        cs = torch.randn((2, 2 * k), generator=gen, device=dev)
        hs = torch.randn(k, generator=gen, device=dev) / k
        cases.append((f"probe K {k} D {d} tile {tile}", cs, xs, hs, d, tile,
                      dp, fp, "full"))
    return cases


def part_hold(old, x, carry, taps, gen):
    dev = x.device
    fast = bench._ring_constants()["kAtan"] == 1
    rand = torch.randn(carry.shape, generator=gen, device=dev)
    worst = {"new": 0.0, "old": 0.0}
    for name, dp, fp, st, mul in bench.VARIANTS:
        tile = mul * bench.TILE
        exp = wbfm_proto.wbfm_proto_reference(rand, x, taps, D, 0.7, tile,
                                              128, dp, fp, st)[1]
        got = new_call(rand, x, taps, tile, dp, fp, st, 0.7)()
        worst["new"] = max(worst["new"], _hold_one(f"new {name}", got, exp,
                                                   st, fast))
        got = old_call(old, rand, x, taps, tile, dp, fp, st, 0.7)()
        worst["old"] = max(worst["old"], _hold_one(f"old {name}", got, exp,
                                                   st))
        del exp, got
    print(f"hold: 14 variants, worst scaled {worst}", flush=True)
    for label, cr, xs, hs, d, tile, dp, fp, st in edge_cases(dev, gen):
        block = 128 if (tile // d) % 128 == 0 else 32
        exp = wbfm_proto.wbfm_proto_reference(cr, xs, hs, d, 1.0, tile,
                                              block, dp, fp, st)[1]
        got = wbfm_proto.wbfm_proto(cr, xs, hs, d, 1.0, tile, block, dp, fp,
                                    st)[1]
        worst["new"] = max(worst["new"], _hold_one(f"new {label}", got, exp,
                                                   st, fast))
        if xs.is_contiguous() and xs.data_ptr() % 16 == 0:
            got = old_call(old, cr, xs, hs, tile, dp, fp, st, 1.0, d)()
            worst["old"] = max(worst["old"],
                               _hold_one(f"old {label}", got, exp, st))
    print(f"hold: edges, worst scaled {worst}", flush=True)
    return worst


def sweep_lib():
    lib = cudabuild.load("wbfm_proto_sweep")
    if not lib.lr_wbfm_proto_variant.argtypes:
        lib.lr_wbfm_proto_variant.argtypes = [
            _VP, _VP, _VP, _LL, _LL, _I, _I, _F, _I, _I, _I, _I, _VP, _VP,
            _I, _I, _I, _I, _I, _I, _I, _VP]
        lib.lr_wbfm_proto_variant.restype = _I
        lib.lr_wbfm_proto_points.restype = _I
        lib.lr_wbfm_proto_point.argtypes = [_I, ctypes.POINTER(_I)]
        lib.lr_wbfm_proto_point.restype = _I
    return lib


def instances(lib):
    """Every point of the sweep build: (chunk outputs, stages, CTAs an
    SM, consumer warps, claimed, the Hopper atan2, unroll)."""
    pts = []
    for i in range(lib.lr_wbfm_proto_points()):
        v = (_I * 7)()
        lib.lr_wbfm_proto_point(i, v)
        pts.append(tuple(v))
    return pts


def variant_call(lib, pt, carry, x, taps, tile, dp, fp, st, gain=1.0, d=D):
    c, w = x.shape
    k = taps.shape[0]
    out = torch.empty((c, w // 2 // d), dtype=torch.float32,
                      device=x.device)
    claims = torch.zeros(4, dtype=torch.int64, device=x.device)
    stage, deint, fir = codes(dp, fp, st)

    def run():
        code = lib.lr_wbfm_proto_variant(
            x.data_ptr(), carry.data_ptr(), taps.data_ptr(), c, w // 2, k, d,
            float(np.float32(gain)), tile, stage, deint, fir, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream, *pt, claims.data_ptr())
        cudabuild.check(lib, code, f"wbfm_proto variant {pt}")
        return out
    return run


def part_sweep(x, carry, taps, gen, rounds=2, only=None):
    lib = sweep_lib()
    pts = instances(lib)
    if only is not None:
        pts = [pts[i] for i in only]
    variants = [v for v in bench.VARIANTS if v[0] in SWEEP_VARIANTS]
    # every point held first, on the edge shapes and the variants' inputs
    dev = x.device
    for pt in pts:
        if pt[5] in (2, 4):               # diagnostics: timed, not held
            continue
        for label, cr, xs, hs, d, tile, dp, fp, st in edge_cases(dev, gen):
            block = 128 if (tile // d) % 128 == 0 else 32
            exp = wbfm_proto.wbfm_proto_reference(cr, xs, hs, d, 1.0, tile,
                                                  block, dp, fp, st)[1]
            got = variant_call(lib, pt, cr, xs, hs, tile, dp, fp, st, 1.0,
                               d)()
            _hold_one(f"sweep {pt} {label}", got, exp, st, pt[5] == 1)
        for name, dp, fp, st, mul in variants:
            exp = wbfm_proto.wbfm_proto_reference(
                carry, x, taps, D, 1.0, mul * bench.TILE, 128, dp, fp, st)[1]
            got = variant_call(lib, pt, carry, x, taps, mul * bench.TILE, dp,
                               fp, st)()
            _hold_one(f"sweep {pt} {name}", got, exp, st, pt[5] == 1)
            del exp, got
    print(f"sweep: {len(pts)} points held", flush=True)
    res_atan = atan2_hold(lib, dev, gen) if any(p[5] in (1, 3)
                                                for p in pts) else None
    rows = {str(pt): {} for pt in pts}
    for r in range(rounds):
        order = pts if r % 2 == 0 else pts[::-1]
        for pt in order:
            for name, dp, fp, st, mul in variants:
                ms = graph_ms(variant_call(lib, pt, carry, x, taps,
                                           mul * bench.TILE, dp, fp, st))
                rows[str(pt)].setdefault(name, []).append(ms)
        print(f"sweep round {r} done", flush=True)
    res = {k: {n: statistics.median(v) for n, v in row.items()}
           for k, row in rows.items()}
    for k, row in res.items():
        print(f"sweep {k}: " + ", ".join(f"{n} {v:.4f}"
                                          for n, v in row.items()),
              flush=True)
    if res_atan is not None:
        res["atan2_hopper"] = res_atan
    return res


def _ulps(a, b):
    """|a - b| in units in the last place of b (float32), NaN-safe."""
    a64, b64 = a.double(), b.double()
    sp = torch.from_numpy(np.spacing(np.abs(b.cpu().numpy()))).to(
        b.device).double()
    d = (a64 - b64).abs() / sp
    return torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)


def atan2_hold(lib, dev, gen):
    """The Hopper atan2 against libdevice atan2f on the card: the special
    pairs (+-0, +-inf, NaN, subnormals, x < 0 with y = +-0) bit for bit,
    and the largest ulp difference over 2^22 random pairs whose
    magnitudes span 2^-140 to 2^120; atan2f's branch-free fast path (with
    atan2f where it does not hold) on all of them: the count of results
    that differ from atan2f's in any bit."""
    lib.lr_wbfm_proto_atan2.argtypes = [_VP, _VP, _VP, _I, _I, _VP]
    lib.lr_wbfm_proto_atan2.restype = _I
    inf, nan, sub = float("inf"), float("nan"), 1e-40
    vals = [0.0, -0.0, inf, -inf, nan, sub, -sub, 1.0, -1.0, 3.0, -2.5,
            1e30, -1e-30, 1e38]
    ys = torch.tensor([a for a in vals for _ in vals], device=dev)
    xs = torch.tensor([b for _ in vals for b in vals], device=dev)
    n = 1 << 22
    mag = torch.rand(2, n, generator=gen, device=dev) * 260 - 140
    sign = torch.randint(0, 2, (2, n), generator=gen, device=dev) * 2 - 1
    rnd = (sign * torch.exp2(mag) * (1 + torch.rand(2, n, generator=gen,
                                                    device=dev))).float()
    unit = torch.randn(2, n, generator=gen, device=dev)

    def both(y, x, modes=(0, 1)):
        outs = []
        for fast in modes:
            out = torch.empty_like(y)
            code = lib.lr_wbfm_proto_atan2(
                y.data_ptr(), x.data_ptr(), out.data_ptr(), y.numel(), fast,
                torch.cuda.current_stream().cuda_stream)
            cudabuild.check(lib, code, "atan2 probe")
            outs.append(out)
        torch.cuda.synchronize()
        return outs
    ref, got = both(ys, xs)
    same = (ref == got) | (torch.isnan(ref) & torch.isnan(got))
    same &= torch.signbit(ref) == torch.signbit(got)
    specials_bad = [(float(ys[i]), float(xs[i]), float(ref[i]),
                     float(got[i])) for i in torch.nonzero(~same).flatten()
                    .tolist()]
    rr, rg = both(rnd[0].contiguous(), rnd[1].contiguous())
    ur, ug = both(unit[0].contiguous(), unit[1].contiguous())
    # atan2f's fast path without its branches: bit for bit everywhere
    fp_bad, fp_pairs = 0, []
    for y, x in ((ys, xs), (rnd[0].contiguous(), rnd[1].contiguous()),
                 (unit[0].contiguous(), unit[1].contiguous())):
        a, b = both(y, x, (0, 3))
        same = ((a == b) & (torch.signbit(a) == torch.signbit(b))) | (
            torch.isnan(a) & torch.isnan(b))
        fp_bad += int((~same).sum())
        fp_pairs += [(float(y[i]), float(x[i]), float(a[i]), float(b[i]))
                     for i in torch.nonzero(~same).flatten()[:8].tolist()]
    res0 = {"fast_path_mismatches": fp_bad, "fast_path_pairs": fp_pairs}
    res = {**res0, "special_pairs": len(vals) ** 2, "special_mismatches":
           specials_bad[:20], "max_ulp_wide": float(_ulps(rg, rr).max()),
           "max_ulp_normal": float(_ulps(ug, ur).max()),
           "max_abs_normal": float((ug - ur).abs().max())}
    print(f"atan2_hopper: {res}", flush=True)
    return res


def part_ab(old, x, carry, taps):
    """Both kernels alone on preallocated outputs (the shipped library
    through old_call's interface), old, new, new, old; the wrapper's time
    beside (it allocates the output and clones the carry)."""
    res = {}
    new = cudabuild.load("wbfm_proto")
    k1 = k1_call(x, taps)
    res["k1_before"] = {"device": graph_ms(k1), "launch": launch_ms(k1)}
    for name, dp, fp, st, mul in bench.VARIANTS:
        tile = mul * bench.TILE
        fo = old_call(old, carry, x, taps, tile, dp, fp, st)
        fn = old_call(new, carry, x, taps, tile, dp, fp, st)
        seq = []
        for which, f in (("old", fo), ("new", fn), ("new", fn), ("old", fo)):
            seq.append((which, graph_ms(f), launch_ms(f)))
        row = {"old_device": [s[1] for s in seq if s[0] == "old"],
               "new_device": [s[1] for s in seq if s[0] == "new"],
               "old_launch": [s[2] for s in seq if s[0] == "old"],
               "new_launch": [s[2] for s in seq if s[0] == "new"]}
        row["ratio"] = statistics.mean(row["new_device"]) / statistics.mean(
            row["old_device"])
        row["wrapper_device"] = graph_ms(new_call(carry, x, taps, tile, dp,
                                                  fp, st))
        res[name] = row
        print(f"ab {name}: old {row['old_device']} new {row['new_device']} "
              f"({row['ratio']:.3f}x)", flush=True)
    res["k1_after"] = {"device": graph_ms(k1), "launch": launch_ms(k1)}
    print(f"ab k1: {res['k1_before']} / {res['k1_after']}", flush=True)
    return res


def part_k640(old, x, gen):
    """highest and split22 at K1's flagship taps (K 640, D 8)."""
    from luaradio_tpu_torch.ops import fir as firmod  # noqa: F401
    dev = x.device
    k = 640
    taps = torch.randn(k, generator=gen, device=dev) / k
    carry = torch.zeros((x.shape[0], 2 * k), device=dev)
    k1 = k1_call(x, taps)
    res = {"k1": graph_ms(k1)}
    kc = torch.zeros((x.shape[0], k), dtype=torch.complex64, device=dev)
    _, prod = wbfm.wbfm_mono(kc, x, taps, D, 1.0)
    scale = float(prod.abs().max())
    for dp, fp in (("highest", "highest"), ("sel3", "split22")):
        fo = old_call(old, carry, x, taps, bench.TILE, dp, fp, "full")
        fn = old_call(cudabuild.load("wbfm_proto"), carry, x, taps,
                      bench.TILE, dp, fp, "full")
        got = fn()
        seq = [graph_ms(f) for f in (fo, fn, fn, fo)]
        res[f"{dp}_{fp}"] = {"old": [seq[0], seq[3]], "new": [seq[1], seq[2]],
                             "rel_err_vs_k1": float((got - prod).abs().max())
                             / scale}
        print(f"k640 {dp}/{fp}: {res[f'{dp}_{fp}']}, K1 {res['k1']:.4f}",
              flush=True)
    res["k1_after"] = graph_ms(k1)
    return res


def stage_bytes(c, t, k, d, st):
    """Bytes a stage must move: each input read once, each output written
    once."""
    out = c * t // d * 4
    if st == "deint_only":
        return c * 2 * (t // d) * 4 + out
    return c * t * 8 + 2 * c * k * 4 + (k * 4 if st in ("full", "no_deint")
                                        else 0) + out


def part_stages(x, carry, taps):
    c, t = x.shape[0], x.shape[1] // 2
    k = taps.shape[0]
    res = {}
    for st, dp, fp in (("deint_only", "sel3", "split22"),
                       ("no_fir", "sel3", "split22"),
                       ("no_deint", "sel3", "split22"),
                       ("full", "sel3", "split22"),
                       ("full", "highest", "highest")):
        ms = graph_ms(new_call(carry, x, taps, bench.TILE, dp, fp, st))
        nb = stage_bytes(c, t, k, D, st)
        res[f"{st}_{dp}_{fp}"] = {"device": ms, "bytes": nb,
                                  "bound_ms": nb / HBM * 1e3,
                                  "GBps": nb / ms / 1e6}
        print(f"stage {st} ({dp}, {fp}): {ms:.4f} ms, {nb / 1e6:.1f} MB, "
              f"{nb / ms / 1e6:.0f} GB/s", flush=True)
    return res


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    parts = arg("--parts", "b0,hold,sweep,ab,k640,stages,sass").split(",")
    res = {"card": smi, "torch": torch.__version__, "parts": parts}
    t0 = time.monotonic()
    old = build_old(arg("--old", ".ab_old/wbfm_proto_old.cu"))
    names = ["wbfm", "wbfm_proto", "window"]
    if "sweep" in parts:
        names.append("wbfm_proto_sweep")
    built = cudabuild.build(tuple(names))
    print(f"builds in {time.monotonic() - t0:.1f} s: "
          f"{ {n: round(v[0], 1) for n, v in built.items()} }", flush=True)
    if "wbfm_proto" in built:
        log = built["wbfm_proto"][1]
        res["ptxas"] = [ln for ln in log.splitlines() if "registers" in ln
                        or "spill" in ln][:80]
    x, carry, taps = bench.inputs(dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    if "b0" in parts:
        res["b0"] = part_b0(old, x, carry, taps)
    if "hold" in parts:
        res["hold"] = part_hold(old, x, carry, taps, gen)
    if "sweep" in parts:
        only = arg("--points", None)
        only = [int(v) for v in only.split(",")] if only else None
        res["sweep"] = part_sweep(x, carry, taps, gen,
                                  int(arg("--rounds", "2")), only)
    if "ab" in parts:
        res["ab"] = part_ab(old, x, carry, taps)
    if "k640" in parts:
        res["k640"] = part_k640(old, x, gen)
    if "stages" in parts:
        res["stages"] = part_stages(x, carry, taps)
    if "sass" in parts:
        res["sass"] = bench.sass_issue_estimate(x.shape[0], x.shape[1] // 2,
                                                keep_loop=True)
        loop = res["sass"].pop("loop")
        out = arg("--out", None)
        if out:                   # the loop's SASS beside the JSON
            with open(os.path.join(os.path.dirname(out) or ".",
                                   "wbfm_proto_disc_loop.sass"), "w") as f:
                f.write("\n".join(loop) + "\n")
        print(f"sass: {res['sass']}", flush=True)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("sweep", "ptxas")}), flush=True)
    out = arg("--out", None)
    if out:
        with open(out, "w") as f:
            f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()
