"""The sequential PLL in the phase domain (K3).

The PLL is a per-sample nonlinear feedback loop (the reference's
pll.lua:138-167).  Its exact sequential form runs here as a kernel written
by hand in CUDA (csrc/pll.cu), with its plain twin in this module:

* :func:`pll_phase` — x complex64 [N] and the state float32 [3]
  (phi_locked, phi_multiplied, freq) in radians -> (out complex64 [N],
  err float32 [N], new state float32 [3]).  Replaces
  ``luaradio_tpu/ops/pll.py`` ``pll_pallas``.
* :func:`pll_phase_reference` — the same function in plain PyTorch.

The loop is carried in the phase domain: theta = arg(x) as int32 turns
(2^32 = 2 pi) computed for the whole chunk, phases as int32 turns so that
every wrap is integer overflow, and out = e^{j phi_m} reconstructed from
the recorded output phases.  The constants are float32, computed on the
host exactly as the TPU kernel computes them, and every product and sum of
the chain is rounded on its own, so kernel and twin agree on err and
phi_m.  The TPU kernel's 512-sample grid blocks round the frequency to a
whole turn unit between blocks; the port carries it in float throughout
(the blocking existed for the TPU's scalar core).

The twin's chain has no tensor form: it walks the samples in Python with
float32 and explicitly wrapped 32-bit integer arithmetic (numpy scalars,
int64 values wrapped to 32 bits, clamped before each convert), between the
two parallel phases in torch.  A wrapper launches the CUDA kernel for CUDA
tensors and takes the twin only for tensors on the CPU; anything else
raises.  ``pll_phase.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from luaradio_tpu_torch.ops import cudabuild

_TO_F = np.float32(2 * np.pi / 4294967296.0)    # int turns -> radians
_TO_I = np.float32(4294967296.0 / (2 * np.pi))  # radians -> int turns
_TWO_PI = np.float32(2 * np.pi)
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
#: the clip of theta in turns before the round (pll.py:247-248 of the JAX
#: package): keeps +pi inside int32
_TH_LO, _TH_HI = -2147483648.0, 2147483392.0

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _lib():
    lib = cudabuild.load("pll")
    if not lib.lr_pll_phase.argtypes:
        lib.lr_pll_phase.argtypes = [_VP, _LL, _VP] + [_F] * 10 + \
            [_I, _I, _VP, _VP, _VP, _VP]
        lib.lr_pll_phase.restype = ctypes.c_int
        lib.lr_pll_chain_probe.argtypes = [_I, _F, _F, _VP, _VP, _VP]
        lib.lr_pll_chain_probe.restype = ctypes.c_int
    return lib


def constants(alpha, beta, fmin, fmax, mult) -> dict:
    """The loop's float32 constants, as the TPU kernel computes them
    (luaradio_tpu/ops/pll.py:163-176)."""
    alpha, beta, fmin, fmax, mult = (np.float32(v) for v in
                                     (alpha, beta, fmin, fmax, mult))
    int_mult = float(mult).is_integer()
    return {
        "k_ab": np.float32(alpha + beta),
        "k_amb": np.float32(alpha + mult * beta),
        "k_fm": np.float32(_TO_F * mult),
        "k_b": beta,
        "fmin_k": np.float32(fmin * _TO_I),
        "fmax_k": np.float32(fmax * _TO_I),
        "k_corr": np.float32((mult - np.float32(1)) * alpha) if int_mult
        else np.float32(0),
        "mult_i": int(mult) if int_mult else 0,
        "int_mult": int_mult,
    }


def theta_turns(x: torch.Tensor):
    """arg(x) as int32 turns (clipped, rounded half to even) and the flag
    of exact zeros, both [N]."""
    re, im = x.real, x.imag
    t = torch.atan2(im, re) * torch.tensor(_TO_I, device=x.device)
    ti = torch.round(torch.clamp(t, _TH_LO, _TH_HI)).to(torch.int32)
    return ti, (re == 0) & (im == 0)


# -- the twin's scalar chain --------------------------------------------------

def _wrap32(v: int) -> int:
    return ((v - _I32_MIN) & 0xFFFFFFFF) + _I32_MIN


def _to_int(v, mode: str) -> int:
    """float32 -> int32 as the saturating converts do: round half to even
    ("rn") or toward zero ("rz"); NaN -> 0."""
    v = float(v)
    if v != v:
        return 0
    if v >= 2147483648.0:
        return _I32_MAX
    if v <= -2147483648.0:
        return _I32_MIN
    return int(np.rint(v)) if mode == "rn" else int(v)


def _wrap_pi(p):
    return p - _TWO_PI * np.rint(p / _TWO_PI)


def _chain(ti: list, zero: list, state, k: dict):
    """Walk the loop over one chunk.  Returns (phi_m [N], err [N]) as
    float32 arrays and the new state (3 float32)."""
    f32, to_f = np.float32, _TO_F
    s0, s1, s2 = (f32(v) for v in state)
    phi_l = _to_int(s0 * _TO_I, "rn")
    fk = f32(_to_int(s2 * _TO_I, "rn"))
    phi_mf = _wrap_pi(s1)
    phi_m = _to_int(phi_mf * _TO_I, "rn")
    k_ab, k_amb, k_fm, k_b = k["k_ab"], k["k_amb"], k["k_fm"], k["k_b"]
    lo, hi, k_corr, mult_i = k["fmin_k"], k["fmax_k"], k["k_corr"], \
        k["mult_i"]
    int_mult = k["int_mult"]
    n = len(ti)
    phim = np.empty(n, np.float32)
    err = np.empty(n, np.float32)
    for i in range(n):
        phim[i] = f32(phi_m) * to_f if int_mult else phi_mf
        d = _wrap32(ti[i] - phi_l)
        d_f = f32(0) if zero[i] else f32(d)
        e = d_f * to_f
        err[i] = e
        inc = _to_int(fk + k_ab * d_f, "rz")
        phi_l = _wrap32(phi_l + inc)
        if int_mult:
            phi_m = _wrap32(phi_m + mult_i * inc
                            - _to_int(k_corr * d_f, "rz"))
        else:
            phi_mf = _wrap_pi(phi_mf + fk * k_fm + k_amb * e)
        fk = min(max(fk + k_b * d_f, lo), hi)
    new_state = (f32(phi_l) * to_f,
                 f32(phi_m) * to_f if int_mult else phi_mf, fk * to_f)
    return phim, err, new_state


def _check(x, state):
    if x.dim() != 1 or x.dtype != torch.complex64 or not x.is_contiguous():
        raise ValueError(f"x: want contiguous complex64 [N], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if state.dtype != torch.float32 or tuple(state.shape) != (3,) \
            or state.device != x.device:
        raise ValueError(f"state: want float32 [3] on {x.device}, got "
                         f"{state.dtype} {tuple(state.shape)} on "
                         f"{state.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def pll_phase_reference(x: torch.Tensor, state: torch.Tensor, alpha, beta,
                        fmin, fmax, mult):
    """Plain twin of :func:`pll_phase`, on any device."""
    _check(x, state)
    ti, zero = theta_turns(x)
    phim, err, st = _chain(ti.tolist(), zero.tolist(), state.tolist(),
                           constants(alpha, beta, fmin, fmax, mult))
    phim = torch.from_numpy(phim).to(x.device)
    out = torch.complex(torch.cos(phim), torch.sin(phim))
    return (out, torch.from_numpy(err).to(x.device),
            torch.tensor(np.array(st, np.float32), device=x.device))


def pll_phase(x: torch.Tensor, state: torch.Tensor, alpha, beta, fmin, fmax,
              mult):
    """K3.  x complex64 [N], state float32 [3] (phi_locked,
    phi_multiplied, freq; radians) -> (out complex64 [N], err float32 [N],
    new state float32 [3])."""
    _check(x, state)
    if x.device.type == "cpu":
        return pll_phase_reference(x, state, alpha, beta, fmin, fmax, mult)
    k = constants(alpha, beta, fmin, fmax, mult)
    n = x.shape[0]
    out = torch.empty_like(x)
    err = torch.empty(n, dtype=torch.float32, device=x.device)
    new_state = torch.empty(3, dtype=torch.float32, device=x.device)
    state = state.contiguous()
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lr_pll_phase(
            x.data_ptr(), n, state.data_ptr(), float(_TO_I), float(_TO_F),
            float(_TWO_PI), *(float(k[name]) for name in (
                "k_ab", "k_amb", "k_fm", "k_b", "fmin_k", "fmax_k",
                "k_corr")),
            k["mult_i"], int(k["int_mult"]), out.data_ptr(), err.data_ptr(),
            new_state.data_ptr(), stream)
    cudabuild.check(lib, code, "pll_phase")
    pll_phase.launches += 1
    return out, err, new_state


pll_phase.launches = 0


def chain_probe(steps: int, device) -> tuple[float, int]:
    """Time the loop-carried chain of K3's step alone on the card (one
    thread, ``steps`` steps; csrc/pll.cu chain_probe_kernel): returns
    (milliseconds, clock64 cycles).  A measurement of the sequential
    PLL's floor, not a kernel of the receiver."""
    dev = torch.device(device)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _lib()
    k = constants(7.57e-3, 2.9e-5, 0.54, 0.55, 2.0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        code = lib.lr_pll_chain_probe(steps, float(k["k_ab"]),
                                      float(np.float32(0.5) * _TO_I),
                                      cycles.data_ptr(), sink.data_ptr(),
                                      stream.cuda_stream)
        b.record()
    cudabuild.check(lib, code, "chain_probe")
    b.synchronize()
    return a.elapsed_time(b), int(cycles.item())

__all__ = ["pll_phase", "pll_phase_reference", "constants", "theta_turns",
           "chain_probe"]
