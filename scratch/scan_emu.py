#!/usr/bin/env python3
"""The overlap scan kernels of csrc/pll_overlap.cu run on the host, with no
card and no nvcc: the source is rewritten for g++ over scratch/cuda_emu.h
(each CUDA thread a std::thread, mbarriers and bulk copies emulated),
built as a shared library beside an older build of the same file, and
every ring instance of the measurement build, the pipelined one-thread
variant and the shipped kernel are compared bit for bit with the older
kernel on edge shapes (W and L not multiples of the stage, W = 0, W = L,
L not a multiple of 4, several rows, a part-full last block, x 8 bytes
off 16).

    git show 2f21e18:luaradio_tpu_torch/csrc/pll_overlap.cu \\
        > .ab_old/pll_overlap_old.cu
    python3 scratch/scan_emu.py [--old .ab_old/pll_overlap_old.cu]
        [--points 0,16,-1] [--build DIR]

Both builds use the host's libm, so equality here shows the kernels walk
the same steps on the same samples and store each output where the old
kernel did; agreement with the card's libdevice is chip_smoke.py's and
scratch/scan_ab.py's to show.  Exits 1 on any difference.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "luaradio_tpu_torch", "csrc", "pll_overlap.cu")
VP, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
CONSTS = [float(np.float32(v)) for v in (0.05, 0.0012, -0.3, 0.3, 2.0)]
#: (rows, segments a row, L, W)
SHAPES = ((1, 4, 96, 37), (2, 3, 64, 0), (1, 2, 50, 50), (3, 5, 40, 13),
          (1, 8, 128, 33), (2, 4, 70, 9), (1, 3, 17, 5), (1, 40, 32, 31))
PTX_HELPERS = ("smem_addr", "mbar_init", "mbar_arrive", "mbar_arrive_tx",
               "mbar_wait", "mbar_test", "bulk_load", "bulk_store", "bulk_commit",
               "bulk_wait_read", "bulk_wait_all", "fence_proxy_async",
               "now_ns")


def arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def host_source(src: str) -> str:
    """The .cu text rewritten for g++ over cuda_emu.h: the PTX helpers
    dropped (the header has host versions), the dynamic shared memory a
    per-block buffer, each <<<...>>> launch a call of lr_launch."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    for name in PTX_HELPERS:
        src = re.sub(r"(template <int N>\n)?__device__ __forceinline__ \w+ "
                     + name + r"\(.*?\n}\n", "", src, flags=re.S)
    src = src.replace('asm volatile("fence.mbarrier_init.release.cluster;'
                      '\\n" ::: "memory");', "")
    src = src.replace("extern __shared__ __align__(128) unsigned char "
                      "smem[];", "unsigned char* smem = lr_smem_ptr;")
    return re.sub(r"([\w:]+(?:<[^;{}()]*?>)?)\s*<<<(.*?)>>>\((.*?)\);",
                  lambda m: f"lr_launch([&] {{ {m.group(1)}({m.group(3)}); "
                            f"}}, {m.group(2)});", src, flags=re.S)


def build(src_path, out, defs=()):
    cpp = out + ".cpp"
    with open(src_path) as f, open(cpp, "w") as g:
        g.write(host_source(f.read()))
    cmd = ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
           "-I", os.path.join(ROOT, "scratch"), "-ffp-contract=off",
           "-Wno-unknown-pragmas", *defs, "-o", out, cpp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"g++ failed for {src_path}:\n{res.stderr}")
    lib = ctypes.CDLL(out)
    lib.lr_pll_overlap_scan.argtypes = [VP, I, I, I, I, VP] + [F] * 5 + \
        [VP] * 6
    return lib


def aligned(n, dtype, shift=0):
    """n elements of dtype at an address 64-aligned plus ``shift``
    elements."""
    size = np.dtype(dtype).itemsize
    raw = np.zeros(n + 64 // size + shift, dtype)
    off = ((-raw.ctypes.data) % 64) // size
    return raw[off + shift:off + shift + n]


def run(fn, x, rows, s, lseg, warm, init, new_layout):
    width = rows * s
    shape = (width, lseg) if new_layout else (lseg, width)
    outs = [aligned(width * lseg, np.float32).reshape(shape)
            for _ in range(3)]
    for o in outs:
        o[...] = np.nan
    states = [aligned(5 * width, np.float32).reshape(5, width)
              for _ in range(2)]
    code = fn(x.ctypes.data, rows, s, lseg, warm, init.ctypes.data, *CONSTS,
              *(o.ctypes.data for o in outs + states), None)
    if code:
        raise RuntimeError(f"launch failed: {code}")
    if not new_layout:
        outs = [np.ascontiguousarray(o.T) for o in outs]
    return outs + states


def main():
    build_dir = arg("--build", os.path.join(ROOT, ".ab_old"))
    os.makedirs(build_dir, exist_ok=True)
    old = build(arg("--old", os.path.join(ROOT, ".ab_old",
                                          "pll_overlap_old.cu")),
                os.path.join(build_dir, "libscan_emu_old.so"))
    new = build(SRC, os.path.join(build_dir, "libscan_emu_new.so"),
                ("-DLR_SCAN_SWEEP",))
    new.lr_scan_sweep.argtypes = [I, VP, I, I, I, I, VP] + [F] * 5 + \
        [VP] * 6
    new.lr_scan_sweep_point.argtypes = [I, ctypes.POINTER(I)]
    names = {}
    for i in range(new.lr_scan_sweep_count()):
        o = (I * 5)()
        new.lr_scan_sweep_point(i, o)
        names[i] = tuple(o)
    names[-1] = "pipelined one-thread"
    only = arg("--points", None)
    points = list(names) if only is None else [int(v) for v in
                                               only.split(",")]
    bad = 0
    for k, (rows, s, lseg, warm) in enumerate(SHAPES):
        for shift in (0, 1):
            rng = np.random.default_rng(2 * k + shift)
            n = rows * s * lseg
            x = aligned(n, np.complex64, shift)
            t = np.arange(n)
            x[...] = np.exp(1j * (0.3 * t + 0.5)) + 0.3 * (
                rng.standard_normal(n) + 1j * rng.standard_normal(n))
            init = np.ascontiguousarray(np.stack(
                [np.cos(rng.uniform(0, 6, rows * s)),
                 np.sin(rng.uniform(0, 6, rows * s)),
                 np.cos(rng.uniform(0, 6, rows * s)),
                 np.sin(rng.uniform(0, 6, rows * s)),
                 rng.uniform(-0.3, 0.3, rows * s)]).astype(np.float32))
            exp = run(old.lr_pll_overlap_scan, x, rows, s, lseg, warm, init,
                      False)
            runs = [("shipped", new.lr_pll_overlap_scan)] + [
                (names[i], lambda *a, i=i: new.lr_scan_sweep(i, *a))
                for i in points]
            for name, fn in runs:
                got = run(fn, x, rows, s, lseg, warm, init, True)
                diff = [what for what, a, b in zip(
                    ("o_r", "o_i", "o_e", "snap", "exit"), got, exp)
                    if a.tobytes() != b.tobytes()]
                if diff:
                    bad += 1
                    print(f"{name} on {rows}x{s}x{lseg} W {warm} shift "
                          f"{shift}: {diff} differ", flush=True)
            print(f"{rows} rows x {s} segments of {lseg} after {warm}, x "
                  f"{8 * shift} bytes off 64: {len(runs)} kernels "
                  f"compared", flush=True)
    print(f"{bad} differences")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
