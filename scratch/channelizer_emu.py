#!/usr/bin/env python3
"""The channelizer kernel of csrc/channelizer.cu run on the host, with no
card and no nvcc: the source is rewritten for g++ over scratch/cuda_emu.h
(each CUDA thread a std::thread, blocks one after another) with cp.async
emulated per thread, and held against the block's stock-torch twin
(ops/channelizer.py channelize_reference) on chained chunks: the band's
(100, 16) and the bank example's (64, 8) shapes, the test shapes (8, 16),
(7, 4), (2, 8) and (12, 3), ragged and short chunks, a batch of rows with
one shared first state, every tile length, and a grid of one, two and
three persistent blocks (so blocks walk several tiles through both
window buffers).

    python3 scratch/channelizer_emu.py [--build DIR] [--src FILE]

The generated .cpp and .so go to DIR, by default a temporary directory
removed at the end.

Each case runs twice: cp.async copies landing only at the wait that
covers them (a read before its wait sees stale words) and landing at
once (a copy into a buffer still being read clobbers it).  The new state
must equal the twin's bit for bit and every channel within 2e-6 of that
channel's full scale.  Exits 1 on any failure.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from luaradio_tpu_torch.ops import channelizer  # noqa: E402
from luaradio_tpu_torch.utils import filter_design  # noqa: E402

SRC = os.path.join(ROOT, "luaradio_tpu_torch", "csrc", "channelizer.cu")
HELPERS = ("smem_addr", "cp_async8", "cp_async_commit",
           "cp_async_wait_prior")
PRELUDE = r'''
#include "cuda_emu.h"
#include <algorithm>
#include <deque>
using std::min;
inline cudaError_t cudaSetDevice(int) { return 0; }
struct LrCopy { void* dst; const void* src; int bytes; };
inline thread_local std::vector<LrCopy> lr_open;
inline thread_local std::deque<std::vector<LrCopy>> lr_groups;
inline void lr_land(const LrCopy& c) {
  std::memset(c.dst, 0, 8);
  if (c.bytes) std::memcpy(c.dst, c.src, c.bytes);
}
inline void cp_async8(void* dst, const void* src, int bytes) {
  if (std::getenv("LR_EMU_CP_EARLY")) lr_land({dst, src, bytes});
  else lr_open.push_back({dst, src, bytes});
}
inline void cp_async_commit() {
  lr_groups.push_back(std::move(lr_open));
  lr_open.clear();
}
inline void cp_async_wait_prior() {
  while (lr_groups.size() > 1) {
    for (const LrCopy& c : lr_groups.front()) lr_land(c);
    lr_groups.pop_front();
  }
}
'''
VP, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: (C, q, chunk lengths, rows, shared first state)
CASES = ((100, 16, (4000, 1300, 6400), 1, True),
         (64, 8, (64 * 70, 64 * 3, 64 * 40 + 5), 2, True),
         (8, 16, (8 * 33, 50, 8 * 90), 3, True),
         (7, 4, (7 * 19 + 3, 7 * 40), 1, False),
         (2, 8, (2 * 70, 9, 2 * 65), 3, False),
         (12, 3, (12 * 40,), 1, True))


def host_source(src: str) -> str:
    src = src.replace("#include <cuda_runtime.h>", PRELUDE)
    for name in HELPERS:
        src, n = re.subn(r"__device__ __forceinline__ \w+ " + name
                         + r"\(.*?\n}\n", "", src, flags=re.S)
        assert n == 1, name
    src = src.replace("extern __shared__ __align__(128) unsigned char "
                      "smem[];", "unsigned char* smem = lr_smem_ptr;")
    return re.sub(r"([\w:]+(?:<[^;{}()]*?>)?)\s*<<<(.*?)>>>\((.*?)\);",
                  lambda m: f"lr_launch([&] {{ {m.group(1)}({m.group(3)}); "
                            f"}}, {m.group(2)});", src, flags=re.S)


def build(out_dir):
    os.makedirs(out_dir, exist_ok=True)
    cpp = os.path.join(out_dir, "channelizer_emu.cpp")
    lib = os.path.join(out_dir, "libchannelizer_emu.so")
    src = sys.argv[sys.argv.index("--src") + 1] if "--src" in sys.argv \
        else SRC
    with open(src) as f, open(cpp, "w") as g:
        g.write(host_source(f.read()))
    cmd = ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
           "-I", os.path.join(ROOT, "scratch"), "-ffp-contract=off",
           "-Wno-unknown-pragmas", "-o", lib, cpp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"g++ failed:\n{res.stderr}")
    dll = ctypes.CDLL(lib)
    dll.lr_channelize.argtypes = [VP, LL, VP, LL, VP, VP, VP, VP] + [I] * 9 \
        + [VP]
    return dll


def branch_taps(c, q):
    proto = filter_design.firwin_lowpass(c * q, 1.0 / c, "hamming")
    hp = proto.astype(np.float64).reshape(q, c).T.astype(np.float32)
    return np.ascontiguousarray(hp[:, ::-1])


def launch(dll, state, x, branch, tile, grid):
    rows, n = x.shape
    c, q = branch.shape
    a, b = channelizer.radices(c)
    new = np.full((rows, c * q), np.nan, np.complex64)
    out = np.full((rows, c, n // c), np.nan, np.complex64)
    tw = channelizer.tables(c)
    code = dll.lr_channelize(
        state.ctypes.data, 0 if state.ndim == 1 else c * q, x.ctypes.data,
        n, branch.ctypes.data, tw.ctypes.data, new.ctypes.data,
        out.ctypes.data, rows, c, q, a, b, tile, grid,
        channelizer.smem_bytes(c, q, tile), 0, None)
    if code:
        raise RuntimeError(f"launch refused: {code}")
    return new, out


def main():
    if "--build" not in sys.argv:
        with tempfile.TemporaryDirectory() as tmp:
            return run(build(tmp))
    return run(build(sys.argv[sys.argv.index("--build") + 1]))


def run(dll):
    bad, worst = 0, 0.0
    for c, q, chunks, rows, shared in CASES:
        for tile in (16, 32, 64):
            if channelizer.smem_bytes(c, q, tile) > 227 * 1024:
                continue
            for grid in (1, 2, 3):
                for early in (False, True):
                    if early:
                        os.environ["LR_EMU_CP_EARLY"] = "1"
                    else:
                        os.environ.pop("LR_EMU_CP_EARLY", None)
                    rng = np.random.default_rng(c * 1000 + q + tile + grid)
                    branch = branch_taps(c, q)
                    st_k = np.zeros(c * q, np.complex64) if shared else \
                        (rng.standard_normal((rows, c * q)) + 1j *
                         rng.standard_normal((rows, c * q))).astype(
                            np.complex64)
                    st_t = torch.from_numpy(st_k.copy())
                    for n in chunks:
                        x = (rng.standard_normal((rows, n)) + 1j *
                             rng.standard_normal((rows, n))).astype(
                                 np.complex64)
                        st_k, y = launch(dll, st_k, x, branch, tile, grid)
                        st_t, want = channelizer.channelize_reference(
                            st_t, torch.from_numpy(x),
                            torch.from_numpy(branch))
                        want = want.numpy()
                        scale = np.abs(want).max(axis=-1, keepdims=True)
                        scale = np.maximum(scale, 1e-30)
                        err = float((np.abs(y - want) / scale).max()) \
                            if want.size else 0.0
                        worst = max(worst, err)
                        same = np.array_equal(st_k, st_t.numpy())
                        if not same or not err < 2e-6:
                            bad += 1
                            print(f"C {c} q {q} n {n} rows {rows} tile "
                                  f"{tile} grid {grid} early {early}: "
                                  f"state equal {same}, error {err:.3g}")
        print(f"C {c} q {q} rows {rows}: chunks {chunks} done; worst "
              f"{worst:.3g} of a channel's scale so far", flush=True)
    print(f"{bad} failures; worst {worst:.3g}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
