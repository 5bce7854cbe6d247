"""The flagship kernel taken apart, S4: K1's function stopped after a
chosen stage, with a chosen precision for the deinterleave and for the
FIR's tap product, written by hand in CUDA (csrc/wbfm_proto.cu), with its
plain PyTorch twin in this module.

* :func:`wbfm_proto` (S4) — carry float32 [C, 2K], x float32 [C, 2T]
  interleaved I/Q, taps float32 [K], decimation D, ``inv_gain``, ``tile``,
  ``block`` and the three axes -> (new carry float32 [C, 2K], out float32
  [C, T/D]).  Replaces the Pallas TPU kernel of ``scratch/wbfm_proto.py``
  (``make_proto`` :172 -> ``_kernel`` :82, ``pallas_call`` :195).

For each tile i of ``tile`` complex samples, the window is
``[carry | x][:, 2 tile i : 2 tile i + 2 (K + tile)]`` and the output's
tile i holds tile/D values (``stage``):

* ``dma_only`` — the window's first tile/D floats (S8's gather);
* ``deint_only`` — re + im of the window's first tile/D samples;
* ``no_fir`` — the discriminator m = arg(w[q+1] conj(w[q])) inv_gain;
* ``full`` — the decimating FIR y[j] = sum_k h[k] m[j D + K-1 - k];
* ``no_deint`` — ``full`` with re/im the window's two halves.

The stage outputs depend on the tile, so ``tile`` is part of the function.
Precision follows the TPU's meaning of each mode (:data:`PRECISIONS`): a
product is a sum of terms whose operands are rounded to bf16 (one, two or
three terms), accumulated in fp32; ``highest`` is fp32 and ``default``
one bf16 pass of both operands (JAX on the CPU computes DEFAULT in fp32;
the port keeps the TPU's meaning).  The deinterleave of a selection
matrix rounds each float as its mode's product does.  ``two`` and
``two_hi`` split the TPU's frame into body and tail products of
``split22`` and ``highest`` terms: the same sum in another order.

The wrapper raises where ``make_proto`` raises (an unknown precision, a
tile that is no multiple of block * D for a FIR stage, taps too long for
the frame, a window whose samples are no multiple of 128 for the
selection product) and where the port's shapes do not hold (T a multiple
of tile, tile of D, tile >= K); an unknown stage raises too, where
``make_proto`` would run ``full``.  It launches the CUDA kernel for CUDA
tensors and takes the twin only for tensors on the CPU; anything else
raises.  ``wbfm_proto.launches`` counts kernel launches.  The bf16 FIR
modes run on the tensor cores (mma.sync along K1's Toeplitz band), fp32
on the CUDA cores.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from luaradio_tpu_torch.ops import cudabuild
from luaradio_tpu_torch.ops.fir import _conv_real
from luaradio_tpu_torch.ops.wbfm import discriminate

#: the precisions of split3_dot (scratch/wbfm_proto.py:36-79)
PRECISIONS = ("highest", "default", "sel3", "sel3cat", "sel2", "split22")
#: the FIR's precisions: those and the body + tail forms (:150-163)
FIR_PRECISIONS = PRECISIONS + ("two", "two_hi")
STAGES = ("dma_only", "no_deint", "deint_only", "no_fir", "full")

#: csrc/wbfm_proto.cu's codes of the stage, the deinterleave and the FIR
_STAGE = {"dma_only": 0, "deint_only": 1, "no_fir": 2, "full": 3,
          "no_deint": 3}
_DEINT = {"highest": 0, "default": 1, "sel3": 2, "sel3cat": 2, "sel2": 3,
          "split22": 3}
_HALVES = 4
_FIR = {"highest": 0, "two_hi": 0, "default": 1, "sel3": 2, "sel3cat": 2,
        "sel2": 3, "split22": 4, "two": 4}

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _lib():
    lib = cudabuild.load("wbfm_proto")
    if not lib.lr_wbfm_proto.argtypes:
        lib.lr_wbfm_proto.argtypes = [_VP, _VP, _VP, _LL, _LL, _I, _I, _F,
                                      _I, _I, _I, _I, _VP, _VP]
        lib.lr_wbfm_proto.restype = ctypes.c_int
    return lib


def _validate(c, t, k, d, tile, block, deint_prec, fir_prec, stage):
    """Raise ValueError where ``make_proto``'s kernel cannot run (or the
    port's shapes do not hold); the arguments are counts of complex
    samples and taps."""
    if stage not in STAGES:
        raise ValueError(f"wbfm_proto: stage {stage!r} is not one of "
                         f"{STAGES}")
    if min(k, d, block, tile) < 1 or t < 1:
        raise ValueError(f"wbfm_proto: K {k}, D {d}, block {block}, tile "
                         f"{tile} and T {t} must be positive")
    if t % tile or tile % d or tile < k:
        raise ValueError(f"wbfm_proto: T {t} must be a multiple of tile "
                         f"{tile}, tile a multiple of D {d} and at least "
                         f"K {k}")
    bb = block * d
    w = bb + max(k - d, 0)
    if fir_prec.startswith("two") and w > bb + 128:
        raise ValueError(f"wbfm_proto: fir_prec {fir_prec!r} pads the "
                         f"{w}-row tap matrix to block * D + 128 = "
                         f"{bb + 128} rows: the taps are too long")
    if stage in ("deint_only", "no_fir", "full"):
        if deint_prec not in PRECISIONS:
            raise ValueError(f"wbfm_proto: deint_prec {deint_prec!r} is not "
                             f"one of {PRECISIONS}")
        if (k + tile) % 128:
            raise ValueError(f"wbfm_proto: the selection product takes the "
                             f"window's K + tile = {k + tile} samples in "
                             f"rows of 128")
    if stage in ("no_deint", "full"):
        if fir_prec not in FIR_PRECISIONS:
            raise ValueError(f"wbfm_proto: fir_prec {fir_prec!r} is not one "
                             f"of {FIR_PRECISIONS}")
        if tile % bb:
            raise ValueError(f"wbfm_proto: tile {tile} must be a multiple of "
                             f"block * D = {bb}")
        if fir_prec.startswith("two"):
            if bb < 128 or 2 * bb < k - 1:
                raise ValueError(f"wbfm_proto: the body + tail FIR needs "
                                 f"block * D = {bb} >= 128 and >= (K-1)/2")
        elif k - 1 > bb:
            raise ValueError(f"wbfm_proto: taps too long for the frame "
                             f"window: K - 1 = {k - 1} > block * D = {bb}")


def _check(carry, x, taps, d, tile, block, deint_prec, fir_prec, stage):
    for name, v, dim in (("carry", carry, 2), ("x", x, 2), ("taps", taps, 1)):
        if v.dtype != torch.float32 or v.dim() != dim:
            raise ValueError(f"wbfm_proto: {name} must be float32 {dim}-D, "
                             f"got {v.dtype} {tuple(v.shape)}")
        if not v.is_contiguous():
            raise ValueError(f"wbfm_proto: {name} must be contiguous")
        if v.device != x.device:
            raise ValueError(f"wbfm_proto: {name} on {v.device}, x on "
                             f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wbfm_proto: unsupported device {x.device}")
    k = taps.shape[0]
    c, w = x.shape
    if w % 2 or tuple(carry.shape) != (c, 2 * k):
        raise ValueError(f"wbfm_proto: want x [C, 2T] and carry [C, 2K], "
                         f"got {tuple(x.shape)} and {tuple(carry.shape)} "
                         f"for K = {k}")
    _validate(c, w // 2, k, d, tile, block, deint_prec, fir_prec, stage)


def _bf(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def round_deint(v: torch.Tensor, prec: str) -> torch.Tensor:
    """What the selection product of precision ``prec`` gives for each
    float: highest v, default bf(v), sel3/sel3cat the 3-term split summed
    back, sel2/split22 hi + bf(v - hi)."""
    if prec == "highest":
        return v
    hi = _bf(v)
    if prec == "default":
        return hi
    if prec in ("sel3", "sel3cat"):
        r1 = v - hi
        mid = _bf(r1)
        return (hi + mid) + _bf(r1 - mid)
    return hi + _bf(v - hi)


def fir_terms(m: torch.Tensor, h: torch.Tensor, prec: str):
    """[(m term, tap term)] whose products the FIR of precision ``prec``
    sums."""
    if prec in ("highest", "two_hi"):
        return [(m, h)]
    if prec == "default":
        return [(_bf(m), _bf(h))]
    hi = _bf(m)
    if prec in ("sel3", "sel3cat"):
        r1 = m - hi
        mid = _bf(r1)
        hb = _bf(h)
        return [(hi, hb), (mid, hb), (_bf(r1 - mid), hb)]
    lo = _bf(m - hi)
    h_hi = _bf(h)
    if prec == "sel2":
        return [(hi, h_hi), (lo, h_hi)]
    return [(hi, h_hi), (lo, h_hi), (hi, _bf(h - h_hi))]    # split22, two


def wbfm_proto_reference(carry, x, taps, d: int, inv_gain: float,
                         tile: int, block: int = 128,
                         deint_prec: str = "highest",
                         fir_prec: str = "highest", stage: str = "full"):
    """Plain twin of :func:`wbfm_proto` (no argument checks)."""
    k = taps.shape[0]
    c, w = x.shape
    t = w // 2
    nt, n, per = t // tile, k + tile, tile // d
    win = torch.cat([carry, x], 1).unfold(1, 2 * n, 2 * tile)  # [C, NT, 2n]
    new_carry = x[:, w - 2 * k:].clone()
    if stage == "dma_only":
        return new_carry, win[..., :per].reshape(c, t // d)
    if stage == "no_deint":
        re, im = win[..., :n], win[..., n:]
    else:
        re = round_deint(win[..., 0::2], deint_prec)
        im = round_deint(win[..., 1::2], deint_prec)
    if stage == "deint_only":
        return new_carry, (re[..., :per] + im[..., :per]).reshape(c, t // d)
    m = discriminate(re, im, torch.tensor(np.float32(inv_gain),
                                          device=x.device))
    if stage == "no_fir":
        return new_carry, m[..., :per].reshape(c, t // d)
    y = None
    for mt, ht in fir_terms(m, taps, fir_prec):
        part = _conv_real(mt.reshape(c * nt, n - 1), ht, d)
        y = part if y is None else y + part
    return new_carry, y.reshape(c, t // d)


def wbfm_proto(carry: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
               d: int, inv_gain: float, tile: int, block: int = 128,
               deint_prec: str = "highest", fir_prec: str = "highest",
               stage: str = "full"):
    """S4: carry float32 [C, 2K], x float32 [C, 2T] -> (new carry float32
    [C, 2K], out float32 [C, T/D]) of the stage, at the precisions."""
    d, tile, block = int(d), int(tile), int(block)
    _check(carry, x, taps, d, tile, block, deint_prec, fir_prec, stage)
    if x.device.type == "cpu":
        return wbfm_proto_reference(carry, x, taps, d, inv_gain, tile, block,
                                    deint_prec, fir_prec, stage)
    k = taps.shape[0]
    c, w = x.shape
    t = w // 2
    out = torch.empty((c, t // d), dtype=torch.float32, device=x.device)
    deint = _HALVES if stage == "no_deint" else _DEINT.get(deint_prec, 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.lr_wbfm_proto(
            x.data_ptr(), carry.data_ptr(), taps.data_ptr(), c, t, k, d,
            float(np.float32(inv_gain)), tile, _STAGE[stage], deint,
            _FIR.get(fir_prec, 0), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    cudabuild.check(lib, code, "wbfm_proto")
    wbfm_proto.launches += 1
    return x[:, w - 2 * k:].clone(), out


wbfm_proto.launches = 0


__all__ = ["wbfm_proto", "wbfm_proto_reference", "round_deint", "fir_terms",
           "PRECISIONS", "FIR_PRECISIONS", "STAGES"]
