"""Time-axis sharding: one stream's time axis split into shards, the carried
state exchanged between neighbours (the JAX package's parallel/time.py).

The reference carries per-block streaming state sequentially (FIR keeps
M-1 samples, the discriminator 1 sample, IIR filters scalar recurrences).
Sharding time across D shards turns those into:

* **halo exchange** for blocks whose state is just the last K input
  samples (FIR, discriminator, delay);
* **distributed prefix combine** for first-order linear recurrences:
  each shard scans locally, the per-shard summaries are gathered, the
  cross-shard carry is an exclusive scan over D elements, and the local
  results are corrected.

Each helper takes the stream as ``[D_local, ..., T_local]`` with the
shards this process holds stacked on the leading axis, and the mesh
:class:`~luaradio_tpu_torch.parallel.mesh.Axis` in place of JAX's axis
name.  A replicated value (a carried state, a final value, a psum) has no
leading shard axis.  The JAX package's ``shard0_state`` has no
counterpart: the port carries one global state per block, and the helpers
that end a chunk hand back the true global carry on every process
(core/block.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from luaradio_tpu_torch.blocks.signal.carrier import pilot_normalize_multiply
from luaradio_tpu_torch.ops.fir import fir_direct, fir_fft
from luaradio_tpu_torch.ops.pll_linear import _eigen_setup, _phasor_pow, \
    _rot, _wrap
from luaradio_tpu_torch.ops.scan import linrec_first_order
from luaradio_tpu_torch.parallel.mesh import Axis


def left_halo(x: torch.Tensor, k: int, axis: Axis) -> torch.Tensor:
    """The last k samples of each shard's LEFT neighbour (zeros on shard
    0): the FIR tail the reference carries across process() calls
    (firfilter.lua:115-119)."""
    return axis.left_halo(x, k)


def ring_halo(x: torch.Tensor, k: int, axis: Axis) -> torch.Tensor:
    """Circular left-neighbour tail: shard d receives shard (d-1) mod D's
    last k samples, so shard 0 receives the stream's global tail."""
    return axis.ring_halo(x, k)


def fir_sharded(x: torch.Tensor, taps: torch.Tensor, axis: Axis,
                tail=None) -> torch.Tensor:
    """Causal FIR over a time-sharded stream.  ``tail`` (the global
    carried state, [..., M-1]) enters on shard 0; interior shards take
    their halo from the left neighbour."""
    m = taps.shape[0]
    if m == 1:
        return fir_direct(x, taps, x.new_zeros(x.shape[:-1] + (0,)))[0]
    return fir_direct(x, taps, axis.left_halo(x, m - 1, first=tail))[0]


def fir_fft_sharded(x: torch.Tensor, h_freq: torch.Tensor, l: int,
                    axis: Axis, real_in_real_taps: bool,
                    tail=None) -> torch.Tensor:
    """Overlap-save FFT FIR over a time-sharded stream: each shard's
    L-sample overlap comes from its left neighbour (the reference carries
    the same overlap between its FFT blocks, firfilter.lua:392).  The
    shard length must be a multiple of the frame hop L."""
    return fir_fft(x, h_freq, axis.left_halo(x, l, first=tail),
                   real_in_real_taps)[0]


def discriminator_sharded(x: torch.Tensor, gain: float,
                          axis: Axis) -> torch.Tensor:
    """Frequency discriminator with a 1-sample halo
    (frequencydiscriminator.lua:61 carries one sample)."""
    prev = torch.cat([axis.left_halo(x, 1), x[..., :-1]], dim=-1)
    t = x * prev.conj()
    return torch.atan2(t.imag, t.real) * float(
        np.float32(1.0 / (2 * np.pi * gain)))


@functools.lru_cache(maxsize=64, typed=True)
def _ramp(a, n: int, device: str) -> torch.Tensor:
    """a^1 .. a^n: built in float64 (complex128 for a complex ``a``) on
    the host once for a coefficient, a length and a device, kept as
    float32 (complex64) on the device."""
    cplx = isinstance(a, complex)
    pw = (np.complex128 if cplx else np.float64)(a) ** np.arange(
        1, n + 1, dtype=np.float64)
    return torch.from_numpy(pw.astype(np.complex64 if cplx
                                      else np.float32)).to(device)


def _chain(all_a, all_u, y0, n: int) -> list:
    """c[0] = y0, c[d + 1] = a[d] c[d] + u[d] for d < n: the value
    entering each shard, and the final one (c[n])."""
    c = [y0]
    for d in range(n):
        c.append(all_a[d] * c[-1] + all_u[d])
    return c


def linrec_first_order_sharded(u: torch.Tensor, a, y0, axis: Axis,
                               with_final: bool = False):
    """Distributed y[n] = a*y[n-1] + u[n] over a time-sharded stream.

    Each shard solves its part from a zero start (ops/scan.py); the
    per-shard summaries (the product of ``a`` over the shard, the shard's
    last value) are gathered, the value entering each shard is their
    exclusive chain from ``y0``, and each shard adds it times the
    cumulative product of ``a``.  ``a`` is a scalar (real or complex) or
    a per-sample tensor broadcastable to ``u``.

    ``with_final=True`` also returns the stream's global final value
    (replicated), from the summaries already gathered."""
    n = u.shape[-1]
    lead = u.shape[:-1]
    if axis.size == 1:          # one shard: the serial recurrence itself
        y = linrec_first_order(u, a, torch.as_tensor(y0, device=u.device))
        return (y, y[0, ..., -1]) if with_final else y
    if isinstance(a, torch.Tensor) and a.dim() > 0:
        a = a.to(u.dtype).expand(u.shape)
        local = linrec_first_order(u, a, u.new_zeros(lead))
        acum = torch.cumprod(a, dim=-1)
        all_a = axis.all_gather(acum[..., -1])
        out_dtype = u.dtype
    else:
        cplx = np.iscomplexobj(a)
        out_dtype = torch.complex64 if (cplx or u.is_complex()) \
            else torch.float32
        local = linrec_first_order(u, a, torch.zeros(
            lead, dtype=out_dtype, device=u.device))
        acum = _ramp(complex(a) if cplx else float(a), n, str(u.device))
        all_a = [acum[-1]] * axis.size
    all_u = axis.all_gather(local[..., -1])
    y0 = torch.as_tensor(y0, device=u.device).to(out_dtype).expand(
        all_u.shape[1:])
    c = _chain(all_a, all_u, y0, axis.size)
    carry_in = torch.stack(c[axis.lo:axis.hi], 0)
    y = acum * carry_in[..., None] + local
    if with_final:
        return y, c[-1]
    return y


def delay_sharded(x: torch.Tensor, k: int, axis: Axis,
                  carry=None) -> torch.Tensor:
    """y[n] = x[n-k] over a time-sharded stream: the first k samples of
    each shard come from its left neighbour (``carry``, the global delay
    line, enters on shard 0; the reference's delay.lua keeps the same
    line)."""
    return torch.cat([axis.left_halo(x, k, first=carry),
                      x[..., :x.shape[-1] - k]], dim=-1)


def pilot_recovery_sharded(x: torch.Tensor, taps: torch.Tensor, mult: int,
                           axis: Axis, tail=None) -> torch.Tensor:
    """Time-sharded vectorized pilot recovery: complex bandpass FIR (halo
    exchange), magnitude normalization and integer phase multiplication
    (blocks/signal/carrier.py PilotRecoveryBlock)."""
    return pilot_normalize_multiply(fir_sharded(x, taps, axis, tail=tail),
                                    mult)


def cummax_sharded(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Distributed cumulative max along a time-sharded axis (most-recent-
    event indices, e.g. zero-crossing clock recovery)."""
    local = torch.cummax(x, dim=-1).values
    heads = axis.all_gather(local[..., -1])                 # [D, ...]
    run = torch.cummax(heads, dim=0).values
    prev = torch.cat([torch.full_like(run[:1], -np.inf), run[:-1]], 0)
    return torch.maximum(local, prev[axis.lo:axis.hi][..., None])


def cumsum_sharded(x: torch.Tensor, axis: Axis, with_total: bool = False):
    """Distributed cumulative sum along a time-sharded axis (phase
    accumulators in FM modulators).  ``with_total=True`` also returns the
    global sum (replicated, from the totals already gathered)."""
    local = torch.cumsum(x, dim=-1)
    totals = axis.all_gather(local[..., -1])                # [D, ...]
    prefix = torch.cumsum(totals, dim=0) - totals           # exclusive
    y = local + prefix[axis.lo:axis.hi][..., None]
    if with_total:
        return y, totals.sum(0)
    return y


def pll_linear_sharded(x: torch.Tensor, state, alpha, beta, fmin, fmax,
                       mult: int, axis: Axis):
    """Time-sharded parallel-in-time PLL (the locked loop's linear
    solution, ops/pll_linear.py, in the distributed form): wrapped phase
    differences with a 1-sample halo, a global detrended cumsum, two
    first-order complex recurrences and error cumsums, all over the
    shards.  The guards are global reductions and ``valid`` is one
    replicated flag per row: with no in-stream sequential fallback (a
    per-sample feedback loop cannot time-shard), a caller re-runs the
    chunk serially where it is False.

    x: [D_local, ..., T_local] complex64; state (phi_l, phi_m, freq),
    each a scalar or [...]; ``mult`` a positive integer.
    Returns (valid, new_state, out, err)."""
    f32, c64 = torch.float32, torch.complex64
    dev = x.device
    alpha, beta = np.float32(alpha), np.float32(beta)
    lead = x.shape[1:-1]
    n_local = x.shape[-1]
    n_global = axis.size * n_local
    p0, m0, f0 = (torch.as_tensor(s, device=dev).to(f32).expand(lead)
                  for s in state)

    theta = torch.atan2(x.imag, x.real)
    mag = x.abs()
    xhat = torch.where(mag > 0, x / torch.clamp(mag, min=1e-30),
                       torch.ones_like(x)).to(c64)

    # wrapped phase increments with a 1-sample halo; the global first
    # slot holds d0 = wrap(theta[0] - p0) instead
    prev = torch.cat([axis.left_halo(theta, 1), theta[..., :-1]], -1)
    inc = _wrap(theta - prev)
    d0 = _wrap(theta[..., :1] - p0[..., None])             # [Dl, ..., 1]
    if axis.lo == 0:
        inc = axis.at_first(inc, torch.cat([d0[0], inc[0, ..., 1:]], -1))
    first = (axis.index(dev) == 0).view((-1,) + (1,) * len(lead))

    # global trend c1 = mean of the n_global - 1 true increments
    local_sum = inc.sum(-1) - torch.where(first, d0[..., 0],
                                          torch.zeros_like(d0[..., 0]))
    c1 = axis.psum(local_sum) / float(np.float32(max(n_global - 1, 1)))

    # detrended unwrapped phase tau[n] = d0 + sum_{1..n}(inc - c1)
    v = inc - c1[..., None]
    if axis.lo == 0:
        v = axis.at_first(v, torch.cat([d0[0], v[0, ..., 1:]], -1))
    tau = cumsum_sharded(v, axis)

    # two decoupled complex first-order recurrences (host eigenvectors)
    lam, vmat, vinv = _eigen_setup(alpha, beta)
    w_in = vinv @ np.array([alpha + beta, beta], np.complex128)
    f_dev = (f0 - c1).to(c64)
    tau_c = tau.to(c64)
    phs = []
    for row in range(2):                     # p_h and f_h rows of s_h
        acc = None
        for k in range(2):
            u = complex(np.complex64(w_in[k])) * tau_c
            z_init = complex(np.complex64(vinv[k, 1])) * f_dev
            zk = linrec_first_order_sharded(u, np.complex64(lam[k]),
                                            z_init, axis)
            # shift right by one: s_h[n] enters err[n]
            zk = delay_sharded(zk, 1, axis, carry=z_init[..., None])
            term = complex(np.complex64(vmat[row, k])) * zk
            acc = term if acc is None else acc + term
        phs.append(acc.real.to(f32))
    p_h, f_h = phs

    err = tau - p_h
    f_new = c1[..., None] + f_h + float(beta) * err

    margin = float(np.float32(np.pi * (15.0 / 16.0)))
    ok = ((err.abs().amax(-1) < margin)
          & (f_new.amax(-1) <= float(np.float32(fmax)))
          & (f_new.amin(-1) >= float(np.float32(fmin)))
          & (tau.abs().amax(-1) < 512.0))
    valid = axis.pmin(ok.to(f32)) > 0

    # outputs: unit phasors times small rotations
    s_cum = cumsum_sharded(err, axis) - err                 # exclusive
    small = -float(mult) * err + float(alpha * np.float32(1 - mult)) * s_cum
    base = _rot(m0 - float(mult) * p0)[..., None]
    out = (base * _phasor_pow(xhat, mult) * _rot(small)).to(c64)

    # final state from the global last sample
    lasts = [axis.last(t[..., -1]) for t in (xhat, err, f_new, out)]
    xl, el, fl, ol = lasts
    dl = fl + float(alpha - np.float32(1.0)) * el
    vco_next = xl * _rot(dl)
    dm = float(mult) * fl + float(alpha) * el
    osc_next = ol * _rot(dm)
    new_state = (torch.atan2(vco_next.imag, vco_next.real),
                 torch.atan2(osc_next.imag, osc_next.real),
                 torch.clamp(fl, float(np.float32(fmin)),
                             float(np.float32(fmax))))
    return valid, new_state, out, err


__all__ = ["left_halo", "ring_halo", "fir_sharded", "fir_fft_sharded",
           "discriminator_sharded", "linrec_first_order_sharded",
           "delay_sharded", "pilot_recovery_sharded", "cummax_sharded",
           "cumsum_sharded", "pll_linear_sharded"]
