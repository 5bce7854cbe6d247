#!/usr/bin/env python3
"""The PLL's linear-tier kernel of csrc/pll_linear.cu run on the host, with
no card and no nvcc: the source is rewritten for g++ over a small
emulation (each CUDA thread a std::thread, a warp's 32 meeting at a
barrier for each shuffle, every block of the grid running at once, so the
grid barrier of a cut row is exercised), built with 64 threads a block
(a tile of 512 samples), and held against the twin
(ops/pll_linear.py pll_linear_reference) and :func:`coherence` on CPU
tensors.

    python3 scratch/pll_linear_emu.py [--build DIR]

Cases: locked tones at multipliers 1, 2 and 3 (a stereo-like slow loop and
an AM-like fast one), a frequency step that rails the clamp, carrier-free
noise, a row of zeros; rows cut in 1, 2, 5 and 7 segments (by the plan's
SM count), ragged last tiles, n of 1 and 2, scalar and per-row states;
each case twice, the staging's cp.async copies landing at the wait that
covers them (a read before its wait sees stale words) and at once (a copy
into a buffer still being read clobbers it).
Flags (guards, coherence) must equal the twin's on every row; out within
1e-5 and err within 1e-5 + 2^-22 max|tau| of it, the new state within
the same, or, where the twin's own float32 rounding is larger
(acquisition, a railed clamp, noise), out and err no further from a
float64 walk of the same loop than 1.25 times the twin's.  Exits 1 on any
failure.
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

from luaradio_tpu_torch.ops import pll_linear as pl  # noqa: E402

SRC = os.path.join(ROOT, "luaradio_tpu_torch", "csrc", "pll_linear.cu")
THREADS = int(os.environ.get("LR_EMU_THREADS", "64"))
PRELUDE = r'''
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <mutex>
#include <barrier>
#include <vector>
#include <memory>
#include <atomic>
#include <functional>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct float2 { float x, y; };
struct double2 { double x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
struct dim3 { unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct dim3v { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3v threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
struct EmuWarp { std::barrier<> bar{32}; uint64_t slot[32]; };
struct EmuBlock {
  explicit EmuBlock(int n) : bar(n), smem(1 << 17) {
    for (int w = 0; w < (n + 31) / 32; ++w) warps.push_back(std::make_unique<EmuWarp>());
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  std::vector<unsigned char> smem;
  std::atomic<int> any{0};
};
inline thread_local EmuBlock* lr_blk;
inline void __syncthreads() { lr_blk->bar.arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  if (p) lr_blk->any.store(1);
  lr_blk->bar.arrive_and_wait();
  return lr_blk->any.load();
}
template <class T> inline T lr_shfl(T v, int src) {
  EmuWarp& w = *lr_blk->warps[threadIdx.x / 32];
  uint64_t bits = 0; std::memcpy(&bits, &v, sizeof(T));
  w.slot[threadIdx.x % 32] = bits;
  w.bar.arrive_and_wait();
  uint64_t got = w.slot[src];
  w.bar.arrive_and_wait();
  T r; std::memcpy(&r, &got, sizeof(T)); return r;
}
template <class T> inline T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x % 32;
  return lr_shfl(v, lane >= d ? lane - d : lane);
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) {
  return lr_shfl(v, (threadIdx.x % 32) ^ m);
}
inline std::mutex lr_atomic_mu;
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  std::lock_guard<std::mutex> g(lr_atomic_mu); unsigned long long o = *p; *p = o + v; return o;
}
inline unsigned long long atomicExch(unsigned long long* p, unsigned long long v) {
  std::lock_guard<std::mutex> g(lr_atomic_mu); unsigned long long o = *p; *p = v; return o;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline double __ldcg(const double* p) { return *(volatile const double*)p; }
inline float rhypotf(float x, float y) { return 1.0f / std::hypot(x, y); }
inline void __sincosf(float a, float* s, float* c) { sincosf(a, s, c); }
#include <deque>
struct LrCopy { void* dst; const void* src; int size, bytes; };
inline thread_local std::vector<LrCopy> lr_open;
inline thread_local std::deque<std::vector<LrCopy>> lr_groups;
inline void lr_land(const LrCopy& c) {
  std::memset(c.dst, 0, c.size);
  if (c.bytes) std::memcpy(c.dst, c.src, c.bytes);
}
// cp.async: the copies land at the wait that covers them, or at once with
// LR_EMU_CP_EARLY (a copy into a buffer still being read clobbers it)
inline void lr_cp(void* dst, const void* src, int size, int bytes) {
  if (std::getenv("LR_EMU_CP_EARLY")) lr_land({dst, src, size, bytes});
  else lr_open.push_back({dst, src, size, bytes});
}
inline void cp_async4(void* dst, const void* src, int bytes) { lr_cp(dst, src, 4, bytes); }
inline void cp_async8(void* dst, const void* src, int bytes) { lr_cp(dst, src, 8, bytes); }
inline void cp_async_commit() { lr_groups.push_back(std::move(lr_open)); lr_open.clear(); }
inline void cp_async_wait_prior() {
  while (lr_groups.size() > 1) {
    for (const LrCopy& c : lr_groups.front()) lr_land(c);
    lr_groups.pop_front();
  }
}
template <class F> void lr_launch(F fn, unsigned grid, unsigned block) {
  std::vector<std::unique_ptr<EmuBlock>> blocks;
  for (unsigned b = 0; b < grid; ++b) blocks.push_back(std::make_unique<EmuBlock>(block));
  std::vector<std::thread> ts;
  std::mutex em;
  std::exception_ptr err;
  for (unsigned b = 0; b < grid; ++b)
    for (unsigned t = 0; t < block; ++t)
      ts.emplace_back([&, b, t] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = block; gridDim.x = grid;
        lr_blk = blocks[b].get();
        try { fn(); } catch (...) { std::lock_guard<std::mutex> g(em); err = std::current_exception(); }
      });
  for (auto& th : ts) th.join();
  if (err) std::rethrow_exception(err);
}
template <class P> cudaError_t cudaLaunchCooperativeKernel(
    void (*k)(P), dim3 grid, dim3 block, void** args, size_t, cudaStream_t) {
  P p = *static_cast<P*>(args[0]);
  lr_launch([&] { k(p); }, grid.x, block.x);
  return 0;
}
'''
VP, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


HELPERS = ("smem_addr", "cp_async4", "cp_async8", "cp_async_commit",
           "cp_async_wait_prior")


def host_source(src: str) -> str:
    src = src.replace("#include <cuda_runtime.h>", PRELUDE)
    for name in HELPERS:
        src, n = re.subn(r"__device__ __forceinline__ \w+ " + name
                         + r"\(.*?\n}\n", "", src, flags=re.S)
        assert n == 1, name
    src = src.replace("__shared__ Smem sm;", "Smem& sm = *reinterpret_cast"
                      "<Smem*>(lr_blk->smem.data());")
    src = src.replace("extern __shared__ __align__(16) unsigned char stage[];",
                      "unsigned char* stage = lr_blk->smem.data() + 16384;")
    src = src.replace("reinterpret_cast<const void*>(pll_linear_kernel)",
                      "pll_linear_kernel")
    return re.sub(r"(\w+)<<<(.*?),(.*?),.*?>>>\((.*?)\);",
                  lambda m: f"lr_launch([&] {{ {m.group(1)}({m.group(4)}); "
                            f"}}, {m.group(2)}, {m.group(3)});", src,
                  flags=re.S)


def build(out_dir):
    os.makedirs(out_dir, exist_ok=True)
    cpp = os.path.join(out_dir, "pll_linear_emu.cpp")
    lib = os.path.join(out_dir, "libpll_linear_emu.so")
    with open(SRC) as f, open(cpp, "w") as g:
        g.write(host_source(f.read()))
    cmd = ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
           f"-DLR_PLL_LIN_THREADS={THREADS}", "-ffp-contract=off",
           "-Wno-unknown-pragmas", "-o", lib, cpp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"g++ failed:\n{res.stderr}")
    dll = ctypes.CDLL(lib)
    dll.lr_pll_linear.argtypes = [VP, VP, VP, VP, VP, VP, LL, VP, LL, VP, LL,
                                  VP, VP, LL, LL, I, I, I, VP, I, VP]
    dll.lr_pll_linear_tile.restype = I
    return dll


def launch(dll, x, state, params, mult, sms):
    rows, n = x.shape
    tile = dll.lr_pll_linear_tile()
    p = pl.plan(rows, n, sms, tile)
    out = np.full((rows, n), np.nan, np.complex64)
    err = np.full((rows, n), np.nan, np.float32)
    st = np.full((3, rows), np.nan, np.float32)
    flags = np.full((2, rows), 7, np.uint8)
    leaves = [np.ascontiguousarray(np.broadcast_to(
        np.asarray(v, np.float32), (rows,))) for v in state]
    strides = [0 if np.ndim(v) == 0 else 1 for v in state]
    part = np.full(2 * p.grid * 8, np.nan)
    bar = np.zeros(2, np.uint64)
    k = pl._constants(*(float(v) for v in params), mult)
    code = dll.lr_pll_linear(
        x.ctypes.data, out.ctypes.data, err.ctypes.data, st.ctypes.data,
        flags.ctypes.data, leaves[0].ctypes.data, strides[0],
        leaves[1].ctypes.data, strides[1], leaves[2].ctypes.data,
        strides[2], part.ctypes.data, bar.ctypes.data, n, p.seg_len, rows,
        p.segs, mult, k.ctypes.data, 0, None)
    if code:
        raise RuntimeError(f"launch refused: {code}")
    if bar[0] != 0:
        raise RuntimeError(f"barrier count left at {bar[0]}")
    return p, flags, st, out, err


def loop_params(bw, fmin, fmax, rate):
    """PLLBlock's alpha, beta, fmin, fmax (blocks/signal/carrier.py)."""
    damping = np.sqrt(2.0) / 2.0
    lb = 2 * np.pi * (bw / rate)
    lb = lb / (damping + 1.0 / (4 * damping))
    den = 1 + 2 * damping * lb + lb * lb
    return (np.float32(4 * damping * lb / den), np.float32(4 * lb * lb / den),
            np.float32(2 * np.pi * fmin / rate),
            np.float32(2 * np.pi * fmax / rate))


def inputs(rng, kind, rows, n, f_rad):
    t = np.arange(n)
    if kind == "zeros":
        return np.zeros((rows, n), np.complex64)
    noise = (rng.standard_normal((rows, n)) + 1j *
             rng.standard_normal((rows, n)))
    if kind == "noise":
        return noise.astype(np.complex64)
    if kind == "am":
        # an AM station a row: carrier within +-20 Hz of the channel at
        # 10 kS/s, three tones, ~32 dB carrier to noise
        d = rng.uniform(-20, 20, (rows, 1)) * 2 * np.pi / 1e4
        env = 1 + sum(0.8 / 3 * np.cos(2 * np.pi * f / 1e4 * t + p)
                      for f, p in zip(rng.uniform(100, 4000, 3),
                                      rng.uniform(0, 6.3, 3)))
        return (env * np.exp(1j * (d * t + rng.uniform(0, 6.3, (rows, 1))))
                + 0.025 * noise).astype(np.complex64)
    ph = f_rad * t + rng.uniform(0, 2 * np.pi, (rows, 1))
    if kind == "pilot":
        # a locked pilot: the state's phase and frequency are the tone's
        return (0.1 * np.exp(1j * f_rad * t) + 0.005 * noise
                ).astype(np.complex64)
    if kind == "step":
        ph = ph + np.where(t > n // 2, 3.0 * f_rad * (t - n // 2), 0.0)
    amp = 1.0 + 0.5 * np.cos(0.01 * t)
    return (amp * np.exp(1j * ph) + 0.05 * noise).astype(np.complex64)


def oracle(x, state, params, mult):
    """The linear tier in float64 from the same float32 constants, the
    recurrences walked sample by sample: (tau, err, out)."""
    k = pl._constants(*(float(v) for v in params), mult).astype(np.float64)
    beta, a1m = k[1], k[5]
    c = k[7:].reshape(5, 2, 2)
    lam, w, z0c, vp = (c[i, :, 0] + 1j * c[i, :, 1] for i in range(4))
    rows, n = x.shape
    p0, m0, f0 = (np.broadcast_to(np.asarray(v, np.float64), (rows,))
                  for v in state)
    th = np.angle(x.astype(np.complex128))
    inc = np.angle(np.exp(1j * np.diff(th, axis=-1)))
    c1 = inc.sum(-1) / max(n - 1, 1)
    d0 = np.angle(np.exp(1j * (th[:, 0] - p0)))
    tau = d0[:, None] + np.concatenate(
        [np.zeros((rows, 1)), np.cumsum(inc - c1[:, None], -1)], -1)
    err = np.empty((rows, n))
    for r in range(rows):
        z = z0c * (f0[r] - c1[r])
        for i in range(n):
            err[r, i] = tau[r, i] - (vp * z).real.sum()
            z = lam * z + w * tau[r, i]
    scum = np.concatenate([np.zeros((rows, 1)), np.cumsum(err, -1)[:, :-1]],
                          -1)
    xh = np.where(np.abs(x) > 0, x / np.maximum(np.abs(x), 1e-30), 1.0)
    out = (np.exp(1j * (m0 - mult * p0))[:, None] * xh.astype(np.complex128)
           ** mult * np.exp(1j * (-mult * err + a1m * scum)))
    return tau, err, out


def tau_of(x, p0):
    """The twin's detrended phase, to scale the err tolerance."""
    th = np.angle(x.astype(np.complex128))
    inc = np.angle(np.exp(1j * np.diff(th, axis=-1)))
    c1 = inc.sum(-1, keepdims=True) / max(x.shape[-1] - 1, 1)
    d0 = np.angle(np.exp(1j * (th[:, :1] - p0)))
    return d0 + np.concatenate([np.zeros_like(d0),
                                np.cumsum(inc - c1, -1)], -1)


#: (label, loop (bandwidth Hz, fmin, fmax, rate), mult, input kind, rows,
#:  n, sms, per-row state)
CASES = (
    ("am lock", (1000.0, -100.0, 100.0, 10000.0), 1, "lock", 3, 2000, 64,
     True),
    ("am noise", (1000.0, -100.0, 100.0, 10000.0), 1, "noise", 3, 1500, 4,
     True),
    ("stereo lock", (100.0, 19000 - 100.0, 19000 + 100.0, 220500.0), 2,
     "lock", 1, 3000, 8, False),
    ("stereo lock 2 segs", (100.0, 19000 - 100.0, 19000 + 100.0, 220500.0),
     2, "lock", 2, 1800, 5, True),
    ("rds step", (50.0, 19000 - 100.0, 19000 + 100.0, 171000.0), 3, "step",
     2, 2100, 16, True),
    ("rds lock", (50.0, 19000 - 100.0, 19000 + 100.0, 171000.0), 3, "lock",
     1, 3584, 7, False),
    ("am band rows", (1000.0, -100.0, 100.0, 10000.0), 1, "am", 4, 4000, 8,
     False),
    ("am band rows cut", (1000.0, -100.0, 100.0, 10000.0), 1, "am", 2, 4000,
     8, True),
    ("pilot", (100.0, 19000 - 50.0, 19000 + 50.0, 220500.0), 2, "pilot", 1,
     5000, 16, "locked"),
    ("pilot x2 rows", (100.0, 19000 - 50.0, 19000 + 50.0, 220500.0), 2,
     "pilot", 2, 3000, 4, "locked"),
    ("rds pilot", (50.0, 19000 - 100.0, 19000 + 100.0, 171000.0), 3,
     "pilot", 3, 4096, 12, "locked"),
    ("zeros", (1000.0, -100.0, 100.0, 10000.0), 1, "zeros", 2, 700, 4, True),
    ("one sample", (1000.0, -100.0, 100.0, 10000.0), 2, "lock", 2, 1, 4,
     True),
    ("two samples", (1000.0, -100.0, 100.0, 10000.0), 3, "lock", 1, 2, 4,
     False),
)


def run(dll):
    rng = np.random.default_rng(20261018)
    bad = 0
    for label, loop, mult, kind, rows, n, sms, per_row in CASES:
        params = loop_params(*loop)
        f_rad = float(params[2] + params[3]) / 2 / mult
        if kind == "step":
            f_rad = float(params[3]) / mult * 0.9
        x = inputs(rng, kind, rows, n, f_rad)
        if kind == "pilot":
            f_rad = 2 * np.pi * 19000 / loop[3]
            x = inputs(rng, kind, rows, n, f_rad)
            state = (np.float32(0.0), np.float32(0.0),
                     np.float32(f_rad))
        elif per_row:
            state = tuple(rng.uniform(-0.5, 0.5, rows).astype(np.float32)
                          for _ in range(2)) + (np.full(
                              rows, (params[2] + params[3]) / 2, np.float32),)
        else:
            state = (np.float32(0.3), np.float32(-1.1),
                     np.float32((params[2] + params[3]) / 2))
        p, flags, st, out, err = launch(dll, x, state, params, mult, sms)
        xt = torch.from_numpy(x)
        ts = tuple(torch.as_tensor(v) for v in state)
        valid, tst, tout, terr = pl.pll_linear_reference(xt, ts, *params,
                                                         mult)
        coh = pl.coherence(xt)
        tau = tau_of(x, np.broadcast_to(np.asarray(state[0], np.float64),
                                        (rows,))[:, None])
        tol_e = 1e-5 + 2.0 ** -22 * np.abs(tau).max(-1)
        _, oerr, oout = oracle(x, state, params, mult)
        o_k = (np.abs(out - oout).max(), np.abs(err - oerr).max())
        o_t = (np.abs(tout.numpy() - oout).max(),
               np.abs(terr.numpy() - oerr).max())
        d_out = np.abs(out - tout.numpy()).max(-1)
        d_err = np.abs(err - terr.numpy()).max(-1)
        d_st = np.array([np.abs(np.angle(np.exp(1j * (st[i] - tst[i].numpy()
                                                      .reshape(-1)))))
                         for i in range(2)] + [np.abs(st[2] - tst[2].numpy()
                                                      .reshape(-1))])
        # within the tolerance of the twin, or (where the twin's own
        # float32 rounding is larger: acquisition, a railed clamp, noise)
        # not a quarter further from the float64 loop than the twin is
        close = (np.all(d_out <= 1e-5) and np.all(d_err <= tol_e)
                 and np.all(d_st <= tol_e))
        closer = (o_k[0] <= max(1.25 * o_t[0], 1e-5)
                  and o_k[1] <= max(1.25 * o_t[1], 1e-5))
        ok = (np.array_equal(flags[0].astype(bool), valid.numpy())
              and np.array_equal(flags[1].astype(bool), coh.numpy())
              and (close or closer))
        bad += not ok
        print(f"{('ok  ' if close else 'ok~ ') if ok else 'FAIL'} {label}: rows {rows} n {n} mult "
              f"{mult} plan {tuple(p)}; valid {flags[0].tolist()} / twin "
              f"{valid.numpy().astype(int).tolist()}, coherent "
              f"{flags[1].tolist()} / {coh.numpy().astype(int).tolist()}; "
              f"max |d out| {d_out.max():.3g}, |d err| {d_err.max():.3g} "
              f"(limit {tol_e.min():.3g}), |d state| {d_st.max():.3g}; "
              f"float64 loop: kernel out, err {o_k[0]:.3g}, {o_k[1]:.3g}, "
              f"twin {o_t[0]:.3g}, {o_t[1]:.3g}; max|tau| "
              f"{np.abs(tau).max():.3g}",
              flush=True)
    print(f"{bad} failures")
    return 1 if bad else 0


def run_both(dll):
    """Every case with the copies landing late, then at once."""
    bad = run(dll)
    os.environ["LR_EMU_CP_EARLY"] = "1"
    print("copies landing at once:")
    return run(dll) or bad


def main():
    if "--build" in sys.argv:
        return run_both(build(sys.argv[sys.argv.index("--build") + 1]))
    with tempfile.TemporaryDirectory() as tmp:
        return run_both(build(tmp))


if __name__ == "__main__":
    sys.exit(main())
