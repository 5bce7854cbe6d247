#!/usr/bin/env python3
"""K1/K2 of csrc/wbfm.cu against an older build of the same kernels, in
one process on one card, in turns (old, new, new, old).

    git show <commit>:luaradio_tpu_torch/csrc/wbfm.cu > .ab_old/wbfm_old.cu
    python3 scratch/wbfm_ab.py [--old .ab_old/wbfm_old.cu] [--out PATH]

The old source must have the C interface of the first version (lr_wbfm_mono
and lr_disc_fir without a plan).  It is built with nvcc beside the current
sources (``.ab_old/`` is gitignored).  At three shapes -- K1 at the
flagship's full width (8 x 4 194 304, K 640, D 8), K2 there, and K2 at the
README graph's chunk (1 x 52 430, K 512, D 5) -- both builds are held
against the plain PyTorch twin (2e-5 * scale) and timed with CUDA events
(median of 25 launches each), four rounds in the order old, new, new, old.
Then the new kernel under other plans at full width and at the graph
chunk, its two halves at full width (discriminator alone, FIR alone; the
measurement build of csrc/wbfm.cu with -DLR_WBFM_PARTS), a K1
input that starts 8 bytes off a 16-byte boundary, and the empty-kernel
launch floor.  Prints one JSON object as its last line, and writes it to
the file --out names, if given.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from luaradio_tpu_torch.ops import cudabuild, wbfm  # noqa: E402
from luaradio_tpu_torch.ops.complexutil import complex_to_wire  # noqa: E402
from luaradio_tpu_torch.parallel.flagship import (INV_GAIN,  # noqa: E402
                                                  wbfm_mono_taps)

REPS = 25
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
    replayed ``reps`` times, median replay over ``n``.  Unlike
    median_ms, no host time between launches is counted."""
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
    lib = os.path.join(os.path.dirname(src), "libwbfm_old.so")
    cmd = [cudabuild.nvcc(), *cudabuild.NVCC_FLAGS, "-o", lib, src]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    h = ctypes.CDLL(lib)
    h.lr_wbfm_mono.argtypes = [_VP] * 4 + [_I] * 4 + [_F, _VP]
    h.lr_disc_fir.argtypes = [_VP, _VP, _LL, _LL, _VP, _VP, _LL, _LL, _VP,
                              _VP, _I, _I, _I, _I, _F, _VP]
    h.lr_error_string.argtypes = [_I]
    h.lr_error_string.restype = ctypes.c_char_p
    return h


def old_k1(lib):
    def run(carry, x, taps, d):
        c, t, k = x.shape[0], x.shape[1] // 2, taps.shape[0]
        out = torch.empty((c, t // d), device=x.device)
        code = lib.lr_wbfm_mono(carry.data_ptr(), x.data_ptr(),
                                taps.data_ptr(), out.data_ptr(), c, t, k, d,
                                INV_GAIN,
                                torch.cuda.current_stream().cuda_stream)
        cudabuild.check(lib, code, "old wbfm_mono")
        return out
    return run


def old_k2(lib):
    def run(carry, x, taps, d):
        c, t = x.shape
        k = taps.shape[0]
        out = torch.empty((c, t // d), device=x.device)
        cre, xre = carry.data_ptr(), x.data_ptr()
        code = lib.lr_disc_fir(cre, cre + 4, 2 * k, 2, xre, xre + 4, 2 * t,
                               2, taps.data_ptr(), out.data_ptr(), c, t, k,
                               d, INV_GAIN,
                               torch.cuda.current_stream().cuda_stream)
        cudabuild.check(lib, code, "old disc_fir")
        return out
    return run


def plan_with(c, t, k, d, tile, nt, stages):
    """A plan with the tile, warp-tile width and stages given, and the
    strips ops/wbfm.py plan would give that tile."""
    tiles = -(-(t // d) // tile)
    per_sm = max(1, min(2, (228 * 1024) // (wbfm.smem_bytes(k, d, tile, nt)
                                           + 1024)))
    tps = -(-tiles // max(1, min(tiles, 132 * per_sm // c)))
    return wbfm.Plan(tile, tps, -(-tiles // tps), nt, stages, False,
                     wbfm.smem_bytes(k, d, tile, nt, stages))


def fm_like(gen, c, t, dev):
    steps = torch.randn((c, t), generator=gen, device=dev,
                        dtype=torch.float64) * 0.4
    z = torch.polar(torch.ones_like(steps), torch.cumsum(steps, -1))
    noise = torch.randn((c, t), generator=gen, device=dev,
                        dtype=torch.complex128) * 0.05
    return (z + noise).to(torch.complex64)


def err_vs(got, exp):
    torch.cuda.synchronize()
    scale = max(1.0, exp.abs().max().item())
    e = (got - exp).abs().max().item()
    if not torch.isfinite(got).all() or e > 2e-5 * scale:
        raise AssertionError(f"|kernel - twin| = {e} > 2e-5 * {scale}")
    return e


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    res = {"card": smi, "torch": torch.__version__}
    t0 = time.monotonic()
    for src, (secs, log) in cudabuild.build(
            cudabuild.SOURCES + tuple(cudabuild.PROBES)).items():
        print(f"build {src} {secs:.2f} s:", "; ".join(
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
    old = build_old(arg("--old", ".ab_old/wbfm_old.cu"))
    print(f"built in {time.monotonic() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(7)
    taps = torch.from_numpy(wbfm_mono_taps()).to(dev)
    k = taps.shape[0]
    z = fm_like(gen, 8, (1 << 22) + k, dev)
    carry, xc = z[:, :k].contiguous(), z[:, k:].contiguous()
    wire = complex_to_wire(xc)
    del z
    zg = fm_like(gen, 1, 52430 + 512, dev)
    gtaps = torch.from_numpy(
        (np.hanning(512) * np.sinc(np.linspace(-8, 8, 512)) / 40).astype(
            np.float32)).to(dev)
    gcarry, gx = zg[:, :512].contiguous(), zg[:, 512:].contiguous()

    new_k1 = lambda c, x, h, d: wbfm.wbfm_mono(c, x, h, d, INV_GAIN)[1]  # noqa
    new_k2 = lambda c, x, h, d: wbfm.disc_fir(c, x, h, d, INV_GAIN)  # noqa
    shapes = {
        "K1 full width 8 x 4194304 K640 D8":
            (old_k1(old), new_k1, wbfm.wbfm_mono_reference, carry, wire,
             taps, 8, True),
        "K2 full width 8 x 4194304 K640 D8":
            (old_k2(old), new_k2, wbfm.disc_fir_reference, carry, xc, taps,
             8, False),
        "K2 graph chunk 1 x 52430 K512 D5":
            (old_k2(old), new_k2, wbfm.disc_fir_reference, gcarry, gx, gtaps,
             5, False),
    }
    res["shapes"] = {}
    for name, (fo, fn, twin, cc, x, h, d, is_k1) in shapes.items():
        exp = twin(cc, x, h, d, INV_GAIN)
        exp = exp[1] if is_k1 else exp
        e_old, e_new = err_vs(fo(cc, x, h, d), exp), err_vs(fn(cc, x, h, d),
                                                            exp)
        del exp
        rounds = []
        for which in ("old", "new", "new", "old"):
            f = fo if which == "old" else fn
            rounds.append((which, median_ms(lambda: f(cc, x, h, d)),
                           graph_ms(lambda: f(cc, x, h, d))))
        o = [ms for w, ms, _ in rounds if w == "old"]
        n = [ms for w, ms, _ in rounds if w == "new"]
        og = [ms for w, _, ms in rounds if w == "old"]
        ng = [ms for w, _, ms in rounds if w == "new"]
        c_, t_ = cc.shape[0], x.shape[1] // (2 if is_k1 else 1)
        p = wbfm.plan(c_, t_, h.shape[0], d)
        res["shapes"][name] = {"rounds": rounds, "old_ms": o, "new_ms": n,
                               "new_over_old": max(n) / min(o),
                               "old_graph_ms": og, "new_graph_ms": ng,
                               "graph_new_over_old": max(ng) / min(og),
                               "err_old": e_old, "err_new": e_new,
                               "plan": p._asdict()}
        print(f"{name}: old {o} ms, new {n} ms, new/old <= "
              f"{max(n) / min(o):.3f}; device time (graph replay) old {og}"
              f" new {ng}, new/old <= {max(ng) / min(og):.3f}; "
              f"|kernel - twin| old {e_old:.3g} new "
              f"{e_new:.3g}; plan {p}", flush=True)

    # the new kernel under other plans, with the blocks an SM takes
    exp = wbfm.wbfm_mono_reference(carry, wire, taps, 8, INV_GAIN)[1]
    gexp = wbfm.disc_fir_reference(gcarry, gx, gtaps, 5, INV_GAIN)
    res["plans"] = []
    for label, tile, nt, stages in [
            ("full", 128, 1, 2), ("full", 256, 1, 2), ("full", 256, 2, 2),
            ("full", 256, 2, 3), ("full", 512, 2, 2),
            ("graph", 64, 1, 2), ("graph", 64, 1, 4), ("graph", 128, 1, 4),
            ("graph", 256, 2, 4)]:
        if label == "full":
            p = plan_with(8, 1 << 22, k, 8, tile, nt, stages)
            run = lambda: wbfm._launch_k1(carry, wire, taps, 8, INV_GAIN, p)  # noqa
            ref, kk, dd = exp, k, 8
        else:
            p = plan_with(1, 52430, 512, 5, tile, nt, stages)
            run = lambda: wbfm._launch_k2(gcarry, gx, gtaps, 5, INV_GAIN, p)  # noqa
            ref, kk, dd = gexp, 512, 5
        if p.smem > 227 * 1024:
            continue
        occ = wbfm.occupancy(kk, dd, p)
        e = err_vs(run(), ref)
        ms, gms = median_ms(run), graph_ms(run)
        res["plans"].append({"shape": label, "plan": p._asdict(),
                             "blocks_per_sm": occ, "ms": ms,
                             "graph_ms": gms, "err": e})
        print(f"{label}: {p}, {occ} blocks/SM: {ms:.4f} ms per launch, "
              f"{gms:.4f} ms device (graph), err {e:.3g}", flush=True)
    p = wbfm.plan(8, 1 << 22, k, 8)
    for mode, label in ((1, "discriminator alone"), (2, "FIR alone")):
        ms = median_ms(lambda: wbfm.k1_half(carry, wire, taps, 8, INV_GAIN,
                                            p, mode))
        res[label] = ms
        print(f"K1 full width, {label}: {ms:.4f} ms", flush=True)
    # a compact plan (taps too long for the two-copy layout)
    zc = fm_like(gen, 2, (1 << 16) + 16384, dev)
    ctaps = torch.from_numpy((np.hanning(16384) / 8192).astype(
        np.float32)).to(dev)
    cc, cx = zc[:, :16384].contiguous(), zc[:, 16384:].contiguous()
    pc = wbfm.plan(2, 1 << 16, 16384, 16)
    assert pc.compact
    e = err_vs(wbfm.disc_fir(cc, cx, ctaps, 16, INV_GAIN),
               wbfm.disc_fir_reference(cc, cx, ctaps, 16, INV_GAIN))
    res["compact"] = {"plan": pc._asdict(), "err": e}
    print(f"compact plan {pc}: err {e:.3g}", flush=True)
    # an input 8 bytes off a 16-byte boundary (scalar head in the loader)
    flat = torch.empty(8 * 2 * (1 << 20) + 2, device=dev)
    xo = flat[2:].view(8, 2 * (1 << 20))
    xo.copy_(wire[:, :2 * (1 << 20)])
    assert xo.data_ptr() % 16 == 8
    e = err_vs(wbfm.wbfm_mono(carry, xo, taps, 8, INV_GAIN)[1],
               wbfm.wbfm_mono_reference(carry, xo, taps, 8, INV_GAIN)[1])
    res["misaligned_err"] = e
    print(f"K1 on an input 8 bytes off 16: err {e:.3g}", flush=True)
    res["launch_floor_ms"] = median_ms(lambda: wbfm.empty_launch(dev))
    res["launch_floor_graph_ms"] = graph_ms(lambda: wbfm.empty_launch(dev))
    print(f"empty launch {res['launch_floor_ms']:.4f} ms per launch, "
          f"{res['launch_floor_graph_ms']:.4f} ms device (graph)", flush=True)
    for kk, dd, p in ((640, 8, wbfm.plan(8, 1 << 22, 640, 8)),
                      (16384, 16, wbfm.plan(2, 1 << 16, 16384, 16)),
                      (512, 5, wbfm.plan(1, 52430, 512, 5)),
                      (640, 8, plan_with(8, 1 << 22, 640, 8, 512, 2, 3))):
        a, b = p.smem, wbfm.kernel_smem_bytes(kk, dd, p)
        if a != b:
            raise AssertionError(f"smem mirror ({kk}, {dd}, {p}): "
                                 f"python {a}, kernel {b}")
    out = arg("--out", None)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
