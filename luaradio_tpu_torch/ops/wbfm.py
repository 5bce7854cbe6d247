"""WBFM mono demodulation in one pass: frequency discriminator + decimating
FIR (deemphasis folded into the taps).

Two kernels written by hand in CUDA (csrc/wbfm.cu), each with its plain
PyTorch twin in this module:

* :func:`wbfm_mono` (K1) — the flagship step's form: interleaved float32
  I/Q chunk [C, 2T] and a complex64 carry of the last K samples [C, K];
  returns the new carry and the audio [C, T/D].  Replaces
  ``luaradio_tpu/ops/wbfm_pallas.py`` ``make_wbfm_pallas``.
* :func:`disc_fir` (K2) — the in-graph form: a complex64 stream [C, T]
  (read as its re/im planes) and the same carry; returns the audio.
  Replaces ``make_disc_fir_pallas``.

Both compute, over the window w = [carry | x]:

    m[i] = arg(w[i+1] * conj(w[i])) * inv_gain
    y[j] = sum_k h[k] * m[K-1 + j*D - k]

for any T with T % D == 0; the TPU kernels' tile constraints do not carry
over, so ragged chunks run in the kernel too.  A wrapper launches the CUDA
kernel for CUDA tensors and takes the twin only for tensors on the CPU;
anything else raises.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from luaradio_tpu_torch.ops import cudabuild
from luaradio_tpu_torch.ops.complexutil import wire_to_complex
from luaradio_tpu_torch.ops.fir import _conv_real

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _lib():
    lib = cudabuild.load("wbfm")
    if not lib.lr_wbfm_mono.argtypes:
        lib.lr_wbfm_mono.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F,
                                     _VP]
        lib.lr_wbfm_mono.restype = ctypes.c_int
        lib.lr_disc_fir.argtypes = [_VP, _VP, _LL, _LL, _VP, _VP, _LL, _LL,
                                    _VP, _VP, _I, _I, _I, _I, _F, _VP]
        lib.lr_disc_fir.restype = ctypes.c_int
    return lib


# -- plain PyTorch twins ------------------------------------------------------

def discriminate(re: torch.Tensor, im: torch.Tensor,
                 inv_gain: float) -> torch.Tensor:
    """m[i] = arg(w[i+1] * conj(w[i])) * inv_gain over window planes
    [..., L] -> [..., L-1], with the conj-multiply rounded term by term
    as the kernels do."""
    rp, ip = re[..., :-1], im[..., :-1]
    rc, ic = re[..., 1:], im[..., 1:]
    tre = rc * rp + ic * ip
    tim = ic * rp - rc * ip
    return torch.atan2(tim, tre) * inv_gain


def _window(carry: torch.Tensor, xc: torch.Tensor):
    w = torch.cat([carry, xc], dim=-1)
    return w.real, w.imag


def wbfm_mono_reference(carry, x, taps, d: int, inv_gain: float):
    """Plain twin of :func:`wbfm_mono`: carry complex64 [C, K], x float32
    [C, 2T] interleaved -> (new_carry [C, K], audio [C, T/D])."""
    k = taps.shape[0]
    xc = wire_to_complex(x)
    m = discriminate(*_window(carry, xc), inv_gain)
    return _new_carry(carry, xc, k), _conv_real(m, taps, d)


def disc_fir_reference(carry, x, taps, d: int, inv_gain: float):
    """Plain twin of :func:`disc_fir`: carry complex64 [C, K], x complex64
    [C, T] -> audio [C, T/D]."""
    m = discriminate(*_window(carry, x), inv_gain)
    return _conv_real(m, taps, d)


# -- kernel wrappers ----------------------------------------------------------

#: outputs per thread block and per thread, as in csrc/wbfm.cu
_TILE_OUT, _PER_THREAD = 1024, 4
_SMEM_MAX = 227 * 1024


def smem_bytes(k: int, d: int) -> int:
    """Shared memory one block of the kernel needs for K taps and
    decimation D (mirrors launch() in csrc/wbfm.cu)."""
    cols = _TILE_OUT + (k - 1) // d + 2
    row_len = cols + cols // _PER_THREAD + 1
    return 4 * (k + d * row_len)


def fits(k: int, d: int) -> bool:
    """Whether the kernel takes K taps at decimation D on an H100."""
    return k >= 1 and d >= 1 and smem_bytes(k, d) <= _SMEM_MAX


def _new_carry(carry: torch.Tensor, xc: torch.Tensor, k: int):
    if xc.shape[-1] >= k:
        return xc[:, xc.shape[-1] - k:].contiguous()
    return torch.cat([carry, xc], dim=-1)[:, -k:].contiguous()


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_common(carry, taps, c, t, d, device):
    k = taps.shape[0] if taps.dim() == 1 else -1
    _check("taps", taps, torch.float32, (k,), device)
    _check("carry", carry, torch.complex64, (c, k), device)
    if d < 1 or t < 1 or t % d:
        raise ValueError(f"chunk of {t} samples is not a positive multiple "
                         f"of the decimation {d}")
    if not fits(k, d):
        raise ValueError(f"{k} taps at decimation {d} need "
                         f"{smem_bytes(k, d)} bytes of shared memory, more "
                         f"than the kernel's {_SMEM_MAX}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return k


def wbfm_mono(carry: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
              d: int, inv_gain: float):
    """K1.  carry complex64 [C, K], x float32 [C, 2T] interleaved I/Q,
    taps float32 [K] -> (new_carry complex64 [C, K], audio float32
    [C, T/D])."""
    if x.dim() != 2 or x.shape[1] % 2:
        raise ValueError(f"x: want float32 [C, 2T], got {tuple(x.shape)}")
    c, t = x.shape[0], x.shape[1] // 2
    _check("x", x, torch.float32, (c, 2 * t), x.device)
    k = _check_common(carry, taps, c, t, d, x.device)
    if x.data_ptr() % 8 or carry.data_ptr() % 8:
        # the kernel reads each I/Q pair as one 8-byte float2
        raise ValueError("x and carry must start on an 8-byte boundary "
                         "(x begins at an odd float offset)")
    if x.device.type == "cpu":
        return wbfm_mono_reference(carry, x, taps, d, inv_gain)
    out = torch.empty((c, t // d), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lr_wbfm_mono(carry.data_ptr(), x.data_ptr(),
                                taps.data_ptr(), out.data_ptr(), c, t, k, d,
                                float(inv_gain), stream)
    cudabuild.check(lib, code, "wbfm_mono")
    wbfm_mono.launches += 1
    return _new_carry(carry, wire_to_complex(x), k), out


def disc_fir(carry: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
             d: int, inv_gain: float) -> torch.Tensor:
    """K2.  carry complex64 [C, K], x complex64 [C, T], taps float32 [K]
    -> audio float32 [C, T/D]."""
    if x.dim() != 2:
        raise ValueError(f"x: want complex64 [C, T], got {tuple(x.shape)}")
    c, t = x.shape
    _check("x", x, torch.complex64, (c, t), x.device)
    k = _check_common(carry, taps, c, t, d, x.device)
    if x.device.type == "cpu":
        return disc_fir_reference(carry, x, taps, d, inv_gain)
    out = torch.empty((c, t // d), dtype=torch.float32, device=x.device)
    lib = _lib()
    # the re/im planes of a complex64 tensor: step 2 floats, im 4 bytes on
    cre, xre = carry.data_ptr(), x.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lr_disc_fir(cre, cre + 4, 2 * k, 2, xre, xre + 4, 2 * t,
                               2, taps.data_ptr(), out.data_ptr(), c, t, k,
                               d, float(inv_gain), stream)
    cudabuild.check(lib, code, "disc_fir")
    disc_fir.launches += 1
    return out


wbfm_mono.launches = 0
disc_fir.launches = 0

__all__ = ["wbfm_mono", "disc_fir", "wbfm_mono_reference",
           "disc_fir_reference", "discriminate", "fits", "smem_bytes"]
