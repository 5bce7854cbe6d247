"""The PLL ablations S7: a float-radian vector-oscillator PLL in four
bodies that price its parts, written by hand in CUDA (csrc/pll_ablate.cu),
with its plain PyTorch twin in this module.

* :func:`pll_ablate` (S7) — x float32 [2, n] (re row, im row), the state
  float32 [3] (oscillator angle, phi_m, freq) and the loop's constants ->
  (err float32 [1, n], state float32 [3]) for ``variant`` one of
  :data:`VARIANTS`: ``full``, ``no-osc`` (computes what ``full``
  computes, as the TPU body does), ``no-atan`` (atan2 replaced by its
  input product: a cost probe, not a valid PLL) and ``bare`` (no
  oscillator update).  Replaces the Pallas TPU kernel of
  ``scratch/pll_ablate.py`` (``run_variant`` :73 -> ``make_kernel`` :25,
  ``pallas_call`` :78); its block size k does not enter the function.
* :func:`pll_ablate_reference` — the same loop, a sample at a time over
  float32 0-d tensors.
* :func:`chain_probe` — one variant's loop-carried chain alone on the
  card (clock64, one thread, the step alone): the floor of ``full``; for
  the other variants a cost, which the kernel may beat (``no-atan``
  does).

Both sides round every product and sum on its own in the TPU body's order,
with ``_sincos_small``'s polynomial copied into the port and atan2f
(``torch.atan2``) where the body calls its polynomial ``_atan2``.  The
wrapper launches the CUDA kernel for CUDA tensors and takes the twin only
for tensors on the CPU; anything else raises.  ``pll_ablate.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from luaradio_tpu_torch.ops import cudabuild

VARIANTS = ("full", "no-osc", "no-atan", "bare")

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_TWO_PI = np.float32(2 * np.pi)


def _lib():
    lib = cudabuild.load("pll_ablate")
    if not lib.lr_pll_ablate.argtypes:
        lib.lr_pll_ablate.argtypes = [_VP, _LL, _VP] + [_F] * 5 + \
            [_I, _VP, _VP, _VP]
        lib.lr_pll_ablate.restype = ctypes.c_int
        lib.lr_pll_ablate_chain_probe.argtypes = [_LL] + [_F] * 5 + \
            [_I, _VP, _VP, _VP]
        lib.lr_pll_ablate_chain_probe.restype = ctypes.c_int
    return lib


def _variant(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"pll_ablate: variant {variant!r} is not one of "
                         f"{VARIANTS}")
    return VARIANTS.index(variant)


def _check(x: torch.Tensor, state: torch.Tensor):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != 2:
        raise ValueError(f"pll_ablate: x must be float32 [2, n], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if state.dtype != torch.float32 or tuple(state.shape) != (3,):
        raise ValueError(f"pll_ablate: state must be float32 [3], got "
                         f"{state.dtype} {tuple(state.shape)}")
    if not x.is_contiguous() or not state.is_contiguous():
        raise ValueError("pll_ablate: x and state must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pll_ablate: unsupported device {x.device}")
    if state.device != x.device:
        raise ValueError(f"pll_ablate: state on {state.device}, x on "
                         f"{x.device}")


def _constants(alpha, beta, fmin, fmax, mult):
    return tuple(np.float32(v) for v in (alpha, beta, fmin, fmax, mult))


def pll_ablate_reference(x: torch.Tensor, state: torch.Tensor, alpha, beta,
                         fmin, fmax, mult, variant: str = "full"):
    """Plain twin of :func:`pll_ablate`: the TPU body's loop, one sample
    at a time over float32 0-d tensors on x's device."""
    v = _variant(variant)
    dev = x.device

    def f32(value):
        return torch.tensor(np.float32(value), device=dev)
    alpha, beta, fmin, fmax, mult = (f32(c) for c in _constants(
        alpha, beta, fmin, fmax, mult))
    one, milli, half, three_half = f32(1.0), f32(1e-3), f32(0.5), f32(1.5)
    two_pi, zero = f32(_TWO_PI), f32(0.0)
    s_c = [f32(c) for c in (-1.0 / 6.0, 1.0 / 120.0, -1.0 / 5040.0,
                            1.0 / 362880.0)]
    c_c = [f32(c) for c in (-0.5, 1.0 / 24.0, -1.0 / 720.0, 1.0 / 40320.0)]
    n = x.shape[1]
    err = torch.empty((1, n), dtype=torch.float32, device=dev)
    vr, vi = torch.cos(state[0]), torch.sin(state[0])
    phim, freq = state[1].clone(), state[2].clone()
    for i in range(n):
        xr, xi = x[0, i], x[1, i]
        pr = xr * vr + xi * vi
        pi = xi * vr - xr * vi
        e = torch.atan2(pi, pr) if v <= 1 else pi * pr * milli
        err[0, i] = e
        freq = freq + beta * e
        dl = freq + alpha * e
        if variant != "bare":
            d2 = dl * dl
            sl = dl * (one + d2 * (s_c[0] + d2 * (s_c[1] + d2 * (
                s_c[2] + d2 * s_c[3]))))
            cl = one + d2 * (c_c[0] + d2 * (c_c[1] + d2 * (
                c_c[2] + d2 * c_c[3])))
            vr2 = vr * cl - vi * sl
            vi2 = vr * sl + vi * cl
            gv = three_half - half * (vr2 * vr2 + vi2 * vi2)
            vr, vi = vr2 * gv, vi2 * gv
        dm = freq * mult + alpha * e
        phim = phim + dm
        phim = phim - torch.where(phim > two_pi, two_pi, zero)
        freq = torch.minimum(torch.maximum(freq, fmin), fmax)
    out = torch.stack([torch.atan2(vi, vr), phim, freq])
    return err, out


def pll_ablate(x: torch.Tensor, state: torch.Tensor, alpha, beta, fmin,
               fmax, mult, variant: str = "full"):
    """S7: x float32 [2, n], state float32 [3] -> (err float32 [1, n],
    state float32 [3]) of the variant's loop."""
    v = _variant(variant)
    _check(x, state)
    if x.device.type == "cpu":
        return pll_ablate_reference(x, state, alpha, beta, fmin, fmax, mult,
                                    variant)
    n = x.shape[1]
    err = torch.empty((1, n), dtype=torch.float32, device=x.device)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.lr_pll_ablate(
            x.data_ptr(), n, state.data_ptr(),
            *(float(c) for c in _constants(alpha, beta, fmin, fmax, mult)),
            v, err.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    cudabuild.check(lib, code, "pll_ablate")
    pll_ablate.launches += 1
    return err, out


pll_ablate.launches = 0


def chain_probe(steps: int, variant: str, alpha, beta, fmin, fmax, mult,
                device) -> tuple[float, int, int]:
    """Time one variant's step alone on the card (csrc/pll_ablate.cu
    chain_probe_kernel: one thread, inputs from registers): returns
    (milliseconds by CUDA events, clock64 cycles, steps run: ``steps``
    rounded down to a multiple of 8).  A measurement of the chain, not a
    launch of S7."""
    v = _variant(variant)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("chain_probe: the probe is the card's")
    blocks = int(steps) // 8
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(4, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        code = lib.lr_pll_ablate_chain_probe(
            blocks, *(float(c) for c in _constants(alpha, beta, fmin, fmax,
                                                    mult)),
            v, cycles.data_ptr(), sink.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        b.record()
    cudabuild.check(lib, code, "pll_ablate chain_probe")
    b.synchronize()
    return a.elapsed_time(b), int(cycles.item()), 8 * blocks


__all__ = ["pll_ablate", "pll_ablate_reference", "chain_probe", "VARIANTS"]
