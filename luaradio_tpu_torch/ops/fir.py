"""FIR filtering.

The reference's FIRFilterBlock is its most important kernel
(radio/blocks/signal/firfilter.lua): a stateful sliding-window dot product.
The JAX package lowers it to banded-Toeplitz MXU matmuls; on the card a
single-channel ``conv1d`` is the plain form, so the port has no tap
matrices.

* ``fir_direct`` — causal y[n] = sum_k taps[k] x[n-k] with the last M-1
  input samples carried as explicit state.
* ``fir_decimate`` — the same filter computing only every D-th output
  (a strided convolution), which the graph optimizer (core/optimize.py)
  folds FIR/IIR -> Downsampler chains into.

The reference products run at float32 (``Precision.HIGHEST``).  cuDNN
convolutions default to TF32 on the card, which keeps ~3 decimal digits,
so every convolution here runs under :func:`fp32_exact`.

All functions treat the **last axis as time** and broadcast over leading
batch axes.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_exact():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls inside the
    block (restored afterwards): the reference computes these products in
    full float32."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32 = False
    mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = prev


def _conv_real(x: torch.Tensor, h: torch.Tensor, stride: int) -> torch.Tensor:
    """Real 'valid' correlation with reversed taps: x [..., L] float32,
    h [M] float32 -> y [..., (L-M)//stride + 1] with
    y[j] = sum_k h[k] x[j*stride + M-1-k]."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, 1, x.shape[-1])
    with fp32_exact():
        y = F.conv1d(xb, h.flip(0).reshape(1, 1, -1), stride=stride)
    return y.reshape(lead + (y.shape[-1],))


def _conv(x: torch.Tensor, taps: torch.Tensor, stride: int) -> torch.Tensor:
    """:func:`_conv_real` for any mix of real/complex input and taps."""
    if x.is_complex():
        xs = torch.view_as_real(x).movedim(-1, 0)          # [2, ..., L]
    else:
        xs = x
    if taps.is_complex():
        a = _conv_real(xs, taps.real.contiguous(), stride)
        b = _conv_real(xs, taps.imag.contiguous(), stride)
        if x.is_complex():
            re, im = a[0] - b[1], a[1] + b[0]
        else:
            re, im = a, b
        return torch.complex(re, im)
    y = _conv_real(xs, taps, stride)
    if x.is_complex():
        return torch.view_as_complex(y.movedim(0, -1).contiguous())
    return y


def _out_dtype(x: torch.Tensor, taps: torch.Tensor) -> torch.dtype:
    return (torch.complex64 if (x.is_complex() or taps.is_complex())
            else torch.float32)


def fir_init_state(num_taps: int, dtype: torch.dtype, device,
                   batch_shape: tuple = ()) -> torch.Tensor:
    """Carried state: the last M-1 input samples (zeros initially — the
    reference also starts its sliding window at zero, firfilter.lua:115)."""
    return torch.zeros(batch_shape + (max(num_taps - 1, 0),), dtype=dtype,
                       device=device)


def fir_direct(x: torch.Tensor, taps: torch.Tensor, tail: torch.Tensor):
    """Causal FIR.  x: [..., N]; taps: [M] (real or complex); tail:
    [..., M-1] carried input.  Returns (y [..., N], new_tail)."""
    return fir_decimate(x, taps, tail, 1)


def fir_decimate(x: torch.Tensor, taps: torch.Tensor, tail: torch.Tensor,
                 d: int):
    """Fused causal FIR + decimate-by-d: y[j] = sum_k h[k] x[j*d - k].

    x: [..., N] with N % d == 0 (real or complex); taps [K] (real or
    complex); tail: [..., K-1] carried input samples.
    Returns (y [..., N // d], new_tail)."""
    k = taps.shape[0]
    n = x.shape[-1]
    if n % d:
        raise ValueError(f"fir_decimate: chunk {n} not a multiple of {d}")
    xin = torch.cat([tail.to(x.dtype).expand(x.shape[:-1] + tail.shape[-1:]),
                     x], dim=-1) if k > 1 else x
    y = _conv(xin, taps, d).to(_out_dtype(x, taps))
    new_tail = xin[..., xin.shape[-1] - (k - 1):] if k > 1 else tail
    return y, new_tail


# ---------------------------------------------------------------------------
# Tap algebra (graph-optimizer helpers, host-side float64)
# ---------------------------------------------------------------------------

def combine_taps(h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    """Taps of the cascade of two FIR filters (= convolution of taps)."""
    cplx = np.iscomplexobj(h1) or np.iscomplexobj(h2)
    dt = np.complex128 if cplx else np.float64
    return np.convolve(np.asarray(h1, dtype=dt), np.asarray(h2, dtype=dt))


def iir_to_fir_taps(b_taps: np.ndarray, a_taps: np.ndarray,
                    tol: float = 1e-9, max_len: int = 4096):
    """Truncated impulse response of a stable IIR b/a, or None if the filter
    does not decay below ``tol`` (relative to its peak) within ``max_len``
    samples.  Used by the graph optimizer to fold short IIRs (deemphasis,
    single-pole filters) into neighboring FIR stages within float32 noise."""
    import scipy.signal
    b = np.asarray(b_taps, dtype=np.float64)
    a = np.asarray(a_taps, dtype=np.float64)
    impulse = np.zeros(max_len)
    impulse[0] = 1.0
    h = scipy.signal.lfilter(b, a, impulse)
    peak = np.max(np.abs(h))
    if peak == 0:
        return np.zeros(1, np.float64)
    idx = np.nonzero(np.abs(h) > tol * peak)[0]
    if len(idx) == 0:
        return np.zeros(1, np.float64)
    last = idx[-1]
    if last >= max_len - 1:
        return None  # did not decay; not representable
    return h[:last + 1]


__all__ = ["fp32_exact", "fir_init_state", "fir_direct", "fir_decimate",
           "combine_taps", "iir_to_fir_taps"]
