"""Plain DSP for the references: the semantics of LuaRadio's blocks
(vsergeev/luaradio v0.11.0, radio/blocks/signal/*.lua and
radio/utilities/{filter,window}_utils.lua) written out from their
definitions, in plain PyTorch and NumPy.  Nothing here imports the
program under test.

Every function processes a whole stream from the start with zero initial
state (the state a block starts with), the last axis being time.  Two
precisions:

* ``"float64"``: the reference.  Filters run as FFT convolutions in
  float64 (exact to ~1e-15 of the signal, and linear in memory at any
  length); the PLL's loop in float64.
* ``"tf32"``: the control, the reference one precision below the float32
  (TF32 off) that the configurations state: float32 throughout, every
  filter's operands rounded to TF32 (10 explicit mantissa bits,
  nearest-even) as a TF32 tensor-core convolution rounds them, their
  products summed exactly and the sum rounded to float32; the PLL's loop
  in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

#: output samples a block of the blockwise convolutions
BLOCK = 1 << 20


def real_dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


# -- wire formats ---------------------------------------------------------

WIRE = {"u8": (127.5, 127.5), "s8": (0.0, 127.5)}   # (offset, scale)


def wire_to_complex(raw: torch.Tensor, wire: str,
                    precision: str) -> torch.Tensor:
    """Interleaved I/Q wire items [..., 2 n] -> complex samples [..., n]:
    (item - offset) / scale."""
    offset, scale = WIRE[wire]
    f = (raw.to(real_dtype(precision)) - offset) / scale
    return torch.view_as_complex(f.reshape(f.shape[:-1] + (-1, 2))
                                 .contiguous())


# -- designs (window_utils.lua, filter_utils.lua) -------------------------

def hamming(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))


def _centered(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.float64) - (n - 1) / 2.0


def lowpass_taps(n: int, cutoff: float) -> np.ndarray:
    """Windowed-sinc lowpass, ``cutoff`` a fraction of Nyquist, scaled to
    unity gain at DC."""
    h = cutoff * np.sinc(cutoff * _centered(n)) * hamming(n)
    return h / h.sum()


def complex_bandpass_taps(n: int, lo: float, hi: float) -> np.ndarray:
    """The lowpass prototype of half the band's width (unity at DC),
    translated to the band's centre; edges a fraction of Nyquist."""
    m = _centered(n)
    half = (hi - lo) / 2.0
    proto = half * np.sinc(half * m) * hamming(n)
    proto = proto / proto.sum()
    return proto * np.exp(1j * np.pi * ((lo + hi) / 2.0) * m)


def hilbert_taps(n: int) -> np.ndarray:
    """Windowed ideal Hilbert transformer: 2 / (pi k) at odd offsets k
    from the centre, 0 at even ones."""
    k = _centered(n)
    h = np.zeros(n)
    odd = (np.abs(k) % 2) == 1
    h[odd] = 2.0 / (np.pi * k[odd])
    return h * hamming(n)


def singlepole_lowpass_ba(cutoff: float, rate: float):
    """H(s) = 1 / (1 + s / wc) by the bilinear transform with the cutoff
    prewarped: (b, a)."""
    k = math.tan(math.pi * cutoff / rate)
    return (np.array([k / (1 + k), k / (1 + k)]),
            np.array([1.0, (k - 1) / (1 + k)]))


def iir_impulse(b, a, tol: float = 1e-18) -> np.ndarray:
    """The impulse response of a first-order IIR (b0 + b1 z^-1) /
    (1 + a1 z^-1), cut where it falls below ``tol`` of its peak: a filter
    the float64 reference applies as an FIR without a visible cut."""
    b0, b1 = float(b[0]), float(b[1])
    pole = -float(a[1]) / float(a[0])
    n = int(math.ceil(math.log(tol) / math.log(abs(pole)))) + 2
    h = np.empty(n)
    h[0] = b0
    h[1:] = (b1 + b0 * pole) * pole ** np.arange(n - 1)
    return h


# -- filters --------------------------------------------------------------

def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 explicit mantissa bits
    (nearest, ties to even), kept in float32."""
    i = x.contiguous().view(torch.int32)
    keep = ((i >> 13) & 1) + 0x0FFF
    return ((i + keep) & ~0x1FFF).view(torch.float32)


def _fft_conv_real(x: torch.Tensor, h: torch.Tensor, stride: int
                   ) -> torch.Tensor:
    """Causal y[i] = sum_k h[k] x[i stride - k], zero history, x real or
    complex [..., n], h real or complex [m], in float64 by FFT blocks."""
    m, n = h.shape[0], x.shape[-1]
    n_out = (n + stride - 1) // stride
    xp = F.pad(x, (m - 1, 0)) if not x.is_complex() else torch.cat(
        [x.new_zeros(x.shape[:-1] + (m - 1,)), x], -1)
    outs = []
    per = BLOCK * stride              # input samples a block of outputs
    for s in range(0, n, per):
        seg = xp[..., s:s + per + m - 1]
        size = 1 << (seg.shape[-1] - 1).bit_length()
        y = torch.fft.ifft(torch.fft.fft(seg, size) * torch.fft.fft(h, size))
        y = y[..., m - 1:seg.shape[-1]][..., ::stride]
        outs.append(y)
    y = torch.cat(outs, -1)[..., :n_out]
    if not x.is_complex() and not h.is_complex():
        y = y.real
    return y


def fir(x: torch.Tensor, taps: np.ndarray, precision: str,
        stride: int = 1) -> torch.Tensor:
    """Causal FIR from zero history, keeping outputs 0, stride, 2 stride,
    ... (a filter followed by a downsampler that keeps sample 0).  In
    ``"tf32"`` the input and the taps are rounded to TF32 first and the
    sum of their products is rounded to float32."""
    h = torch.as_tensor(taps, device=x.device)
    if precision == "float64":
        h = h.to(torch.complex128 if np.iscomplexobj(taps)
                 else torch.float64)
        return _fft_conv_real(x, h, stride)
    if x.is_complex():
        x = torch.complex(to_tf32(x.real), to_tf32(x.imag))
    else:
        x = to_tf32(x)
    if np.iscomplexobj(taps):
        hc = h.to(torch.complex64)
        h = torch.complex(to_tf32(hc.real), to_tf32(hc.imag))
    else:
        h = to_tf32(h.to(torch.float32))
    y = _fft_conv_real(x.to(torch.complex128 if x.is_complex()
                            else torch.float64),
                       h.to(torch.complex128 if h.is_complex()
                            else torch.float64), stride)
    return y.to(torch.complex64 if y.is_complex() else torch.float32)


# -- elementwise blocks ---------------------------------------------------

def translate(x: torch.Tensor, offset: float, rate: float) -> torch.Tensor:
    """x[n] exp(j 2 pi offset n / rate), the phase reduced exactly (integer
    n modulo the rotation's period) before it is scaled."""
    from fractions import Fraction
    q = Fraction(offset / rate).limit_denominator(1 << 24)
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    ph = ((q.numerator * idx) % q.denominator).to(torch.float64) * (
        2 * np.pi / q.denominator)
    rot = torch.polar(torch.ones_like(ph), ph).to(x.dtype)
    return x * rot


def discriminate(x: torch.Tensor, modulation_index: float) -> torch.Tensor:
    """arg(x[n] conj(x[n-1])) / (2 pi k), x[-1] = 0."""
    prev = torch.cat([x.new_zeros(x.shape[:-1] + (1,)), x[..., :-1]], -1)
    tmp = x * prev.conj()
    return torch.atan2(tmp.imag, tmp.real) / (2 * np.pi * modulation_index)


def delay(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x.new_zeros(x.shape[:-1] + (n,)), x[..., :-n]], -1)


def pll_constants(loop_bandwidth: float, fmin: float, fmax: float,
                  rate: float) -> dict:
    """The second-order loop's gains (damping 1/sqrt 2) and frequency
    limits in radians a sample."""
    damping = math.sqrt(2.0) / 2.0
    bw = 2 * math.pi * loop_bandwidth / rate
    bw = bw / (damping + 1.0 / (4 * damping))
    denom = 1 + 2 * damping * bw + bw * bw
    return {"alpha": 4 * damping * bw / denom, "beta": 4 * bw * bw / denom,
            "fmin": 2 * math.pi * fmin / rate,
            "fmax": 2 * math.pi * fmax / rate}


def pll(x: torch.Tensor, k: dict, multiplier: int,
        precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(the PLL's multiplied oscillator exp(j phi_m[n]), the multiplied
    phase's offset phi_m[n] - multiplier phi[n] wrapped to [-pi, pi]) over
    one stream x [n], walked sample by sample:

        err    = arg(x[n] conj(exp(j phi)))      (0 where x[n] = 0)
        freq'  = freq + beta err                  (before the clamp)
        phi   += freq' + alpha err
        phi_m += multiplier freq' + alpha err     (the output's phase)
        freq   = clamp(freq', fmin, fmax)

    phi_m is recorded before its update; phases start at 0 and the
    frequency at the middle of its range."""
    theta = torch.atan2(x.imag, x.real)
    theta = torch.where(x == 0, torch.zeros_like(theta), theta)
    th = theta.cpu().numpy()
    if precision == "float64":
        th = th.astype(np.float64).tolist()
        f = float
    else:
        th = th.astype(np.float32)
        f = np.float32
    two_pi, pi = f(2 * math.pi), f(math.pi)
    alpha, beta = f(k["alpha"]), f(k["beta"])
    fmin, fmax, mult = f(k["fmin"]), f(k["fmax"]), f(multiplier)
    phi, phi_m, freq = f(0), f(0), (fmin + fmax) / f(2)
    out = np.empty(len(th), dtype=np.float64 if f is float else np.float32)
    offset = np.empty_like(out)
    for i, t in enumerate(th):
        out[i] = phi_m
        offset[i] = phi_m - mult * phi
        e = t - phi
        if e > pi:
            e -= two_pi
        elif e < -pi:
            e += two_pi
        freq = freq + beta * e
        phi = phi + freq + alpha * e
        phi_m = phi_m + mult * freq + alpha * e
        freq = fmin if freq < fmin else (fmax if freq > fmax else freq)
        if phi > pi:
            phi -= two_pi
        elif phi < -pi:
            phi += two_pi
        if phi_m > pi or phi_m < -pi:
            phi_m -= two_pi * f(round(phi_m / two_pi))
    ph = torch.from_numpy(out).to(x.device)
    off = torch.from_numpy(offset.astype(np.float64)).to(x.device)
    off = torch.remainder(off + math.pi, 2 * math.pi) - math.pi
    return torch.polar(torch.ones_like(ph), ph).to(x.dtype), off


__all__ = ["wire_to_complex", "lowpass_taps",
           "complex_bandpass_taps", "hilbert_taps", "singlepole_lowpass_ba",
           "iir_impulse", "fir", "translate", "discriminate", "delay",
           "pll_constants", "pll", "to_tf32", "real_dtype"]
