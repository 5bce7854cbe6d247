#!/usr/bin/env python3
"""S4's kernels of csrc/wbfm_proto.cu run on the host, with no card and no
nvcc: the source is rewritten for g++ over scratch/cuda_emu.h (each CUDA
thread a std::thread, warps meeting at barriers for their shuffles,
mbarriers, the consumers' named barrier and the TMA bulk copies
emulated), built as a shared library beside an older build of the same
file, and the stage and fp32 paths (dma_only, deint_only, no_fir, and the
FIR stages on the CUDA cores: highest, two_hi, and the bf16 modes where
tile/D is no multiple of 128) are compared with the older kernel (the
stages bit for bit, the FIR stages, which sum in another order, within
2e-5 * scale; a point with the Hopper atan2 within 4 ulp of pi in
no_fir), and within 2e-5 * scale with the plain twin, on edge shapes
(tile 0's carry, x 4 and 8 bytes off 16, more CTAs than items, items no
multiple of the grid, several FIR chunks a window, a first piece holding
K - D extra values), for the shipped ring and every point of the
measurement build.  The tensor-core band (mma.sync, ldmatrix) is not
emulated.

    mkdir -p .ab_old
    git show c1a6904:luaradio_tpu_torch/csrc/wbfm_proto.cu \\
        > .ab_old/wbfm_proto_old.cu
    python3 scratch/wbfm_proto_emu.py [--old .ab_old/wbfm_proto_old.cu]
        [--points 0,3] [--build DIR]

Both builds use the host's libm, so equality here shows that the kernels
take the same samples, round and combine them in the same order and store
each output where the old kernel did; agreement with the card's libdevice
is chip_smoke.py's and scratch/wbfm_proto_ab.py's to show.  Exits 1 on
any difference.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from luaradio_tpu_torch.ops import wbfm_proto  # noqa: E402

CSRC = os.path.join(ROOT, "luaradio_tpu_torch", "csrc")
SRC = os.path.join(CSRC, "wbfm_proto.cu")
VP, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: device functions the header replaces: the PTX helpers, and atan2f's
#: branch-free fast path (libdevice's instructions, not the host libm's:
#: the header's version declines every pair, so the lanes take atan2f)
PTX_HELPERS = ("smem_addr", "mbar_init", "mbar_arrive", "mbar_arrive_tx",
               "mbar_test", "mbar_wait", "bulk_load", "bar_consumers",
               "ldmatrix_x4", "mma_bf16", "atan2_fast_path")
#: (label, C, K, D, tile, tiles a row, x's offset in floats, deint, fir,
#: stage); every FIR stage on the CUDA cores (fp32, or tile/D no multiple
#: of 128)
CASES = (
    ("no_fir sel3", 2, 128, 8, 1024, 4, 0, "sel3", "split22", "no_fir"),
    ("no_fir highest, x 8 bytes off", 2, 128, 8, 1024, 3, 2, "highest",
     "highest", "no_fir"),
    ("no_fir sel2, x 4 bytes off", 1, 128, 8, 1024, 2, 1, "sel2", "sel2",
     "no_fir"),
    ("deint_only sel3cat", 3, 128, 8, 1024, 3, 2, "sel3cat", "two",
     "deint_only"),
    ("deint_only default", 1, 128, 8, 1024, 1, 0, "default", "default",
     "deint_only"),
    ("dma_only", 2, 128, 8, 1024, 2, 0, "sel3", "two", "dma_only"),
    ("full highest", 2, 128, 8, 1024, 4, 0, "highest", "highest", "full"),
    ("full two_hi, x 8 bytes off", 2, 128, 8, 1024, 3, 2, "highest",
     "two_hi", "full"),
    ("full highest, 2 chunks", 1, 128, 8, 4096, 2, 2, "sel3", "highest",
     "full"),
    ("full highest, tile 2^15", 1, 128, 8, 32768, 1, 0, "sel2", "highest",
     "full"),
    ("full sel3/sel3 per 96", 2, 128, 8, 768, 3, 0, "sel3", "sel3", "full"),
    ("full sel3/split22 per 96, x 4 bytes off", 1, 128, 8, 768, 4, 1,
     "sel3", "split22", "full"),
    ("full default per 96", 1, 128, 8, 768, 2, 2, "default", "default",
     "full"),
    ("full sel2 D 5 per 96", 1, 128, 5, 480, 2, 0, "sel2", "sel2", "full"),
    ("full K 256 D 4 highest", 2, 256, 4, 2048, 2, 0, "sel3", "highest",
     "full"),
    ("no_deint highest", 2, 128, 8, 1024, 3, 2, "sel3", "highest",
     "no_deint"),
    ("no_deint split22 per 96", 1, 128, 8, 768, 2, 1, "sel3", "split22",
     "no_deint"),
)


#: no_fir with the Hopper atan2 against atan2f (radians at inv_gain 0.7):
#: 4 ulp of pi
FAST_TOL = 4 * 2.384185791015625e-07


def shipped_fast() -> bool:
    """Whether the shipped ring takes the Hopper atan2 (kAtan 1)."""
    with open(SRC) as f:
        return bool(re.search(r"kAtan = 1;", f.read()))


def arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def _window_cuh() -> str:
    with open(os.path.join(CSRC, "window.cuh")) as f:
        text = f.read()
    text = text.replace("#pragma once", "")
    return text.replace("#include <cuda_runtime.h>", "")


def host_source(src: str) -> str:
    """The .cu text rewritten for g++ over cuda_emu.h: the PTX helpers
    dropped (the header has host versions), window.cuh inlined, the
    dynamic shared memory a per-block buffer, each <<<...>>> launch a call
    of lr_launch."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("#include <cuda_bf16.h>", "")
    src = src.replace('#include "window.cuh"', _window_cuh())
    for name in PTX_HELPERS:
        src = re.sub(r"__device__ __forceinline__ \w+ " + name +
                     r"\(.*?\n}\n", "", src, flags=re.S)
    src = src.replace('asm volatile("fence.mbarrier_init.release.cluster;'
                      '\\n" ::: "memory");', "")
    src = re.sub(r'asm\("rcp\.approx\.ftz\.f32 %0, %1;" : "=f"\((\w+)\) : '
                 r'"f"\((\w+)\)\);', r"\1 = fast_rcp(\2);", src)
    src = re.sub(r"extern __shared__ __align__\(\d+\) unsigned char "
                 r"smem\[\];", "unsigned char* smem = lr_smem_ptr;", src)
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
    lib.lr_wbfm_proto.argtypes = [VP, VP, VP, LL, LL, I, I, F, I, I, I, I,
                                  VP, VP]
    lib.lr_wbfm_proto.restype = I
    return lib


def aligned(n, shift=0):
    """n float32 at an address 64-aligned plus ``shift`` floats."""
    raw = np.zeros(n + 16 + shift, np.float32)
    off = ((-raw.ctypes.data) % 64) // 4
    return raw[off + shift:off + shift + n]


def codes(dp, fp, st):
    deint = wbfm_proto._HALVES if st == "no_deint" else \
        wbfm_proto._DEINT.get(dp, 0)
    return wbfm_proto._STAGE[st], deint, wbfm_proto._FIR.get(fp, 0)


def run(fn, x, carry, taps, c, t, k, d, tile, dp, fp, st, gain):
    out = aligned(c * t // d)
    out[...] = np.nan
    stage, deint, fir = codes(dp, fp, st)
    code = fn(x.ctypes.data, carry.ctypes.data, taps.ctypes.data, c, t, k,
              d, float(np.float32(gain)), tile, stage, deint, fir,
              out.ctypes.data, None)
    if code:
        raise RuntimeError(f"launch failed: {code}")
    return out.reshape(c, t // d).copy()


def main():
    build_dir = arg("--build", os.path.join(ROOT, ".ab_old"))
    os.makedirs(build_dir, exist_ok=True)
    old = build(arg("--old", os.path.join(ROOT, ".ab_old",
                                          "wbfm_proto_old.cu")),
                os.path.join(build_dir, "libwbfm_proto_emu_old.so"))
    new = build(SRC, os.path.join(build_dir, "libwbfm_proto_emu_new.so"),
                ("-DLR_S4_SWEEP",))
    new.lr_wbfm_proto_variant.argtypes = [VP, VP, VP, LL, LL, I, I, F, I, I,
                                          I, I, VP, VP] + [I] * 7 + [VP]
    new.lr_wbfm_proto_point.argtypes = [I, ctypes.POINTER(I)]
    pts = []
    for i in range(new.lr_wbfm_proto_points()):
        o = (I * 7)()
        new.lr_wbfm_proto_point(i, o)
        pts.append(tuple(o))
    only = arg("--points", None)
    points = range(len(pts)) if only is None else [int(v) for v in
                                                   only.split(",")]
    claims = np.zeros(2, np.uint64)

    def variant(i):
        def fn(*a):
            return new.lr_wbfm_proto_variant(*a, *pts[i],
                                             claims.ctypes.data)
        return fn

    bad = 0
    for n_case, (label, c, k, d, tile, nt, shift, dp, fp, st) in \
            enumerate(CASES):
        rng = np.random.default_rng(n_case)
        t = tile * nt
        x = aligned(c * 2 * t, shift).reshape(c, 2 * t)
        x[...] = rng.standard_normal((c, 2 * t)).astype(np.float32)
        carry = aligned(c * 2 * k)
        carry[...] = rng.standard_normal(c * 2 * k).astype(np.float32)
        carry = carry.reshape(c, 2 * k)
        taps = (rng.standard_normal(k) / k).astype(np.float32)
        gain = 0.7
        exp = run(old.lr_wbfm_proto, x, carry, taps, c, t, k, d, tile, dp,
                  fp, st, gain)
        ref = wbfm_proto.wbfm_proto_reference(
            torch.from_numpy(np.ascontiguousarray(carry)),
            torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(taps),
            d, gain, tile, 128, dp, fp, st)[1].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        runs = [("shipped", new.lr_wbfm_proto)]
        if st != "dma_only":
            runs += [(str(pts[i]), variant(i)) for i in points
                     if not pts[i][5]]
        fast = shipped_fast()
        for name, fn in runs:
            try:
                got = run(fn, x, carry, taps, c, t, k, d, tile, dp, fp, st,
                          gain)
            except RuntimeError as e:
                raise RuntimeError(f"{name} on {label}: {e}") from None
            twin = float(np.abs(got - ref).max())
            if st in ("full", "no_deint"):
                # the FIR sums in another order than the old kernel's
                same = float(np.abs(got - exp).max()) <= 2e-5 * scale
            elif name == "shipped" and fast and st == "no_fir":
                # the Hopper atan2 (its rcp.approx exact here)
                same = float(np.abs(got - exp).max()) <= FAST_TOL
            else:
                same = got.tobytes() == exp.tobytes()
            if not same or not twin <= 2e-5 * scale:
                bad += 1
                where = np.argwhere(got != exp)[:4].tolist()
                print(f"{name} on {label}: differs from the old kernel at "
                      f"{where} (of {int((got != exp).sum())}), |new - "
                      f"twin| {twin:.3g}", flush=True)
            if claims.any():
                bad += 1
                print(f"{name} on {label}: counters left at {claims}")
        print(f"{label} [{c} x {t}] K {k} D {d} tile {tile}: {len(runs)} "
              f"kernels compared", flush=True)
    print(f"{bad} differences")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
