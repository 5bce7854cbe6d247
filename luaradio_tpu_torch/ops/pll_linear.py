"""Parallel-in-time PLL: the locked loop as a guarded linear scan, and the
three-tier dispatch of PLLBlock (the JAX package's ops/pll_linear.py, in
torch).

While |err| < pi and the frequency clamp is inactive, the loop of
pll.lua:138-167 is exactly linear in (phi, freq):

    err[n] = theta_u[n] - phi[n]       (theta_u: the unwrapped input phase)
    freq'  = freq + beta * err
    phi'   = phi + freq' + alpha * err

After detrending theta_u = p0 + c1 n + tau (the type-2 loop follows the
trend with zero error), the residual drives s[n+1] = A s[n] + b tau[n],
which the 2x2 matrix's eigenvectors split into two first-order complex
recurrences (ops/scan.py).  Outputs are composed from unit phasors of the
wrapped input phase times small rotations, so no large phase is ever held
in float32.  The guards are checked on the solution afterwards: max|err|
within 15/16 pi, the frequency inside [fmin, fmax], |tau| < 512.

:func:`pll_hybrid` runs this tier on every chunk and takes the exact
sequential kernel (K3, ops/pll.py) — or, where it plans, the
overlap-and-discard tier — only for the chunks whose guards fail.  The
JAX package chooses with ``lax.cond``; here the choice is a host branch on
the guard, one device-to-host sync per chunk.  A bank [C, N] (the JAX
package vmaps the block over C) is solved row by row with the same rules,
from one read of the C flags.

:func:`pll_newton_scan` is the JAX package's per-segment Newton solver
with the sequential kernel as its fallback (only tests and callers that
ask for it use it; PLLBlock takes pll_hybrid).
"""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.core import trace
from luaradio_tpu_torch.ops.scan import linrec_first_order

_TWO_PI = float(np.float32(2 * np.pi))


def _wrap(a: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi]."""
    return a - _TWO_PI * torch.round(a / _TWO_PI)


def _rot(a: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(a), torch.sin(a))


def _phasor_pow(u: torch.Tensor, mult: int) -> torch.Tensor:
    y = u
    for _ in range(mult - 1):
        y = y * u
    return y


def _eigen_setup(alpha, beta):
    """Diagonalize the loop's 2x2 state matrix (host, complex128)."""
    a_mat = np.array([[1.0 - alpha - beta, 1.0], [-beta, 1.0]], np.float64)
    lam, vmat = np.linalg.eig(a_mat.astype(np.complex128))
    return lam, vmat, np.linalg.inv(vmat)


def pll_linear(x, state, alpha, beta, fmin, fmax, mult: int):
    """Linear-scan PLL along the last axis of x complex64 [..., N] with
    state (phi_l, phi_m, freq), each a scalar or [...] (one per row).

    Returns (valid, new_state, out [..., N] complex64, err [..., N]
    float32): the locked-loop solution and a bool tensor [...] saying for
    each row whether it is exact (see :func:`pll_hybrid`).  ``mult`` is a
    positive integer."""
    f32, c64 = torch.float32, torch.complex64
    dev = x.device
    alpha = np.float32(alpha)
    beta = np.float32(beta)
    af, bf = float(alpha), float(beta)
    lead, n = x.shape[:-1], x.shape[-1]
    p0, m0, f0 = (torch.as_tensor(s, dtype=f32, device=dev).expand(lead)
                  for s in state)

    theta = torch.atan2(x.imag, x.real)
    mag = x.abs()
    xhat = torch.where(mag > 0, x / torch.clamp(mag, min=1e-30),
                       torch.ones_like(x))

    # unwrapped input phase, detrended: theta_u[n] = p0 + c1*n + tau[n]
    d0 = _wrap(theta[..., 0] - p0)
    inc = _wrap(theta[..., 1:] - theta[..., :-1])
    c1 = inc.sum(-1) / float(max(n - 1, 1))
    tau = d0[..., None] + torch.cat(
        [theta.new_zeros(lead + (1,)),
         torch.cumsum(inc - c1[..., None], -1)], -1)

    # residual-driven part s_h[n+1] = A s_h[n] + b tau[n], diagonalized
    lam, vmat, vinv = _eigen_setup(alpha, beta)
    w_in = vinv @ np.array([alpha + beta, beta], np.complex128)
    z0_coef = vinv[:, 1]                             # s_h[0] = [0, f0 - c1]
    f_dev = (f0 - c1).to(c64)
    tau_c = tau.to(c64)
    zs = []
    for k in range(2):
        u = complex(np.complex64(w_in[k])) * tau_c
        z_init = complex(np.complex64(z0_coef[k])) * f_dev
        zk = linrec_first_order(u, np.complex64(lam[k]), z_init)
        zs.append(torch.cat([z_init[..., None], zk], -1))
    p_h = (complex(np.complex64(vmat[0, 0])) * zs[0]
           + complex(np.complex64(vmat[0, 1])) * zs[1]).real
    f_h = (complex(np.complex64(vmat[1, 0])) * zs[0]
           + complex(np.complex64(vmat[1, 1])) * zs[1]).real

    err = tau - p_h[..., :-1]
    f_new = c1[..., None] + f_h[..., :-1] + bf * err  # pre-clamp freq[n+1]

    # guards, row by row: the linear solution is exact iff these hold
    margin = float(np.float32(np.pi * (15.0 / 16.0)))
    valid = ((err.abs().amax(-1) < margin)
             & (f_new.amax(-1) <= float(np.float32(fmax)))
             & (f_new.amin(-1) >= float(np.float32(fmin)))
             & (tau.abs().amax(-1) < 512.0))

    # outputs: unit phasors times small rotations
    s_cum = torch.cat([err.new_zeros(lead + (1,)), torch.cumsum(err, -1)],
                      -1)
    small = -float(mult) * err + float(alpha * np.float32(1 - mult)) \
        * s_cum[..., :-1]
    base = _rot(m0 - float(mult) * p0)[..., None]
    out = base * _phasor_pow(xhat, mult) * _rot(small)

    # final state by phasor composition (no large phases)
    dl = f_new[..., -1] + float(alpha - np.float32(1.0)) * err[..., -1]
    vco_next = xhat[..., -1] * _rot(dl)
    dm = float(mult) * f_new[..., -1] + af * err[..., -1]
    osc_next = out[..., -1] * _rot(dm)
    new_state = (torch.atan2(vco_next.imag, vco_next.real),
                 torch.atan2(osc_next.imag, osc_next.real),
                 torch.clamp(f_new[..., -1], float(np.float32(fmin)),
                             float(np.float32(fmax))))
    return valid, new_state, out.to(c64), err


def _vco(x: torch.Tensor, err: torch.Tensor,
         out: torch.Tensor) -> torch.Tensor:
    """The VCO the loop measured ``err`` against, x / |x| exp(-j err)
    (the linear tier's output at multiplier 1), where x != 0; ``out``
    where x == 0 (the phase detector reads 0 there)."""
    mag = x.abs()
    vco = x / torch.clamp(mag, min=1e-30) * _rot(-err)
    return torch.where(mag > 0, vco, out)


def _host(t: torch.Tensor) -> list:
    """One device-to-host read of a small tensor (counted, and timed as
    span ``pll.host_read`` where the thread has a tracer: the read waits
    for every kernel queued before it)."""
    pll_hybrid.host_reads += 1
    with trace.span("pll.host_read"):
        return t.reshape(-1).tolist()


def pll_hybrid(x, state, alpha, beta, fmin, fmax, mult: int, sequential,
               allow_overlap: bool = True, row_tiers: list | None = None):
    """Three-tier PLL dispatch over x complex64 [N], or a bank [C, N] with
    state leaves [C], row by row:

    1. the full-chunk LINEAR solution for the rows where the loop is
       locked;
    2. the OVERLAP-AND-DISCARD batched scan for the other rows, where it
       plans for the chunk and the row looks coherent
       (ops/pll_overlap.py), as one launch on those rows;
    3. the exact sequential kernel ``sequential(state, x) -> (state',
       (out, err))`` (K3) on every row still unsolved, as one call on
       those rows (x [R, N], state leaves [R]; [N] and scalars for a
       single stream).

    The linear tier always runs; each later tier runs only on the rows
    the one before it left, chosen on the host from one read of the
    linear guards and the coherence gates together and, if the overlap
    tier ran, one read of its flags: at most two reads a chunk whatever C
    is (``pll_hybrid.host_reads`` counts them).  Rows are gathered with
    ``index_select`` and scattered back.  ``allow_overlap=False``
    (PLLBlock(exact=True)) skips tier 2.  ``row_tiers``, when given, is
    filled with the tier (1, 2 or 3) each row took;
    ``pll_hybrid.scan_rows`` and ``pll_hybrid.k3_rows`` count the
    row-chunks tiers 2 and 3 solved.

    At multiplier 1 the output oscillator is the VCO (pll.lua's
    phi_multiplied takes phi's steps), and the state's phi_m is phi_l.
    The overlap scan tracks the output as a second phasor chained across
    its segments, which walks off the VCO (~1e-5 rad a 2^16-sample chunk
    in its CPU twin, carried from chunk to chunk through phi_m), so its
    rows take
    the VCO as the linear tier builds it, x / |x| exp(-j err), where
    x != 0.  Returns (state', (out, err))."""
    from luaradio_tpu_torch.ops.pll_overlap import (plan_overlap,
                                                    pll_overlap_discard)

    def taken(tier, sel):
        for r in sel:
            took[r] = tier

    one = x.dim() == 1
    xb = x[None] if one else x
    rows = xb.shape[0]
    dev = x.device
    valid, st, out, err = pll_linear(xb, state, alpha, beta, fmin, fmax,
                                     mult)
    plan = plan_overlap(x.shape[-1], float(alpha)) if allow_overlap else None
    if plan is not None:
        # coherence gate: on carrier-free noise the warm-up never
        # converges, so the batched scan would be wasted ahead of the
        # sequential kernel; the lag-1 autocorrelation says whether there
        # is a carrier to track.  Read with the guards.
        c = (xb[:, 1:] * xb[:, :-1].conj()).sum(-1)
        p = (xb.real ** 2 + xb.imag ** 2).sum(-1)
        coherent = c.abs() > 0.05 * torch.clamp(p, min=1e-30)
        flags = _host(torch.stack([valid, coherent]))
        lin, gate = flags[:rows], flags[rows:]
    else:
        lin, gate = _host(valid), [False] * rows
    todo = [r for r in range(rows) if not lin[r]]
    took = [0] * rows
    taken(1, [r for r in range(rows) if lin[r]])
    if todo:
        st = [v.clone() for v in st]
        out, err = out.clone(), err.clone()

    def solve(sel, r_state, r_out, r_err):
        idx = torch.tensor(sel, dtype=torch.long, device=dev)
        for leaf, v in zip(st, r_state):
            leaf.index_copy_(0, idx, torch.as_tensor(v).to(leaf.dtype)
                             .reshape(-1))
        out.index_copy_(0, idx, r_out.reshape(len(sel), -1))
        err.index_copy_(0, idx, r_err.reshape(len(sel), -1))

    def gather(sel):
        idx = torch.tensor(sel, dtype=torch.long, device=dev)
        xs = xb.index_select(0, idx)
        ss = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev)
                   .expand(rows).index_select(0, idx) for v in state)
        if one:
            return xs[0], tuple(v[0] for v in ss)
        return xs, ss

    scan_rows = [r for r in todo if gate[r]]
    if scan_rows:
        xs, ss = gather(scan_rows)
        ok, b_state, b_out, b_err = pll_overlap_discard(
            xs, ss, alpha, beta, fmin, fmax, mult, *plan)
        ok = _host(ok)
        good = [r for r, g in zip(scan_rows, ok) if g]
        if good:
            keep = torch.tensor([i for i, g in enumerate(ok) if g],
                                dtype=torch.long, device=dev)
            pick = (lambda t: t.reshape(len(scan_rows), -1)
                    .index_select(0, keep))
            if mult == 1:
                b_out = _vco(xs, b_err, b_out)
            solve(good, [pick(v) for v in b_state], pick(b_out),
                  pick(b_err))
        taken(2, good)
        pll_hybrid.scan_rows += len(good)
        todo = [r for r in todo if r not in set(good)]
    if todo:
        xs, ss = gather(todo)
        s_state, (s_out, s_err) = sequential(ss, xs)
        solve(todo, s_state, s_out, s_err)
        taken(3, todo)
        pll_hybrid.k3_rows += len(todo)
    if mult == 1:
        st = (st[0], st[0].clone(), st[2])
    if row_tiers is not None:
        row_tiers[:] = took
    if one:
        return tuple(v[0] for v in st), (out[0], err[0])
    return tuple(st), (out, err)


pll_hybrid.host_reads = 0
pll_hybrid.scan_rows = 0
pll_hybrid.k3_rows = 0


def pll_newton_segment(x, state, alpha, beta, fmin, fmax, mult: int,
                       iters: int = 6, tol: float = 3e-4):
    """Solve the exact nonlinear PLL recurrence on one segment in parallel
    by Newton/Picard iteration, with no lock assumption (the JAX
    package's pll_newton_segment).

    The loop's only nonlinearity is the wrapped phase detector, whose
    derivative is 1 almost everywhere, so linearizing around a guess
    trajectory gives the locked loop's constant 2x2 affine recurrence,
    driven by the wrapped residual w = angle(x_hat conj(u)) and the
    guess's increments.  Each iteration solves it with two first-order
    complex scans and rotates the guess's unit phasors by the correction.
    The fixed point is checked after the fact, elementwise: the phasors
    must satisfy u[n+1] = u[n] exp(i (f1[n] + alpha w[n])) with the
    frequency rebuilt from the errors alone within ``tol``, and the clamp
    must stay inactive.

    x: [L] complex64; state (phi_l, phi_m, freq) float32 scalars.
    Returns (valid (a 0-d bool tensor), new_state, out [L] complex64,
    err [L] float32)."""
    f32, c64 = torch.float32, torch.complex64
    dev = x.device
    alpha = np.float32(alpha)
    beta = np.float32(beta)
    n = x.shape[-1]
    p0, m0, f0 = (torch.as_tensor(s, dtype=f32, device=dev) for s in state)

    mag = x.abs()
    has = mag > 0
    xhat = torch.where(has, x / torch.clamp(mag, min=1e-30),
                       torch.ones_like(x)).to(c64)

    lam, vmat, vinv = _eigen_setup(alpha, beta)
    w_in = vinv @ np.array([alpha + beta, beta], np.complex128)
    g_in = vinv @ np.array([-1.0, 0.0], np.complex128)
    z0_coef = vinv[:, 1]                      # s[0] = (0, f0)

    def angle(z):
        return torch.atan2(z.imag, z.real)

    # guess: constant-frequency extrapolation u[n] = exp(i (p0 + f0 n)),
    # n = 0..L (one extra sample carries the segment's exit phase)
    steps = torch.cat([torch.ones(1, dtype=c64, device=dev),
                       _rot(f0).to(c64).expand(n)])
    u = _rot(p0).to(c64) * torch.cumprod(steps, 0)

    f_dev = f0.to(c64)
    for _ in range(iters):
        w = torch.where(has, angle(xhat * torch.conj(u[:-1])), 0.0)
        g = angle(u[1:] * torch.conj(u[:-1]))
        d = torch.zeros(n, dtype=f32, device=dev)
        for k in range(2):
            uin = (complex(np.complex64(w_in[k])) * w.to(c64)
                   + complex(np.complex64(g_in[k])) * g.to(c64))
            z_init = complex(np.complex64(z0_coef[k])) * f_dev
            zk = linrec_first_order(uin, np.complex64(lam[k]), z_init)
            d = d + (complex(np.complex64(vmat[0, k])) * zk).real
        u = u * _rot(torch.cat([d.new_zeros(1), d]))
        u = u * (1.5 - 0.5 * (u.real * u.real + u.imag * u.imag)).to(c64)

    # exact elementwise validation of the fixed point
    w = torch.where(has, angle(xhat * torch.conj(u[:-1])), 0.0)
    f1 = f0 + float(beta) * torch.cumsum(w, 0)   # freq after update at n
    inc = f1 + float(alpha) * w                  # phase increment at n
    resid = angle(u[1:] * torch.conj(u[:-1]) * _rot(-inc))
    valid = ((resid.abs().max() < float(np.float32(tol)))
             & (f1.max() <= float(np.float32(fmax)))
             & (f1.min() >= float(np.float32(fmin))))

    # outputs: dphi_m = mult inc + alpha (1 - mult) w, composed as phasors
    s_cum = torch.cat([w.new_zeros(1), torch.cumsum(w, 0)])
    base = _rot(m0 - float(mult) * p0)
    um = _phasor_pow(u, mult) * _rot(float(alpha * np.float32(1 - mult))
                                     * s_cum).to(c64)
    out = (base * um[:-1]).to(c64)

    new_state = (angle(u[-1]), angle(base * um[-1]),
                 torch.clamp(f1[-1], float(np.float32(fmin)),
                             float(np.float32(fmax))))
    return valid, new_state, out, w


def _pow2_segment(n: int, cap: int = 1024) -> int:
    """Largest power-of-two divisor of n, capped."""
    s = 1
    while n % (s * 2) == 0 and s < cap:
        s *= 2
    return s


def pll_newton_scan(x, state, alpha, beta, fmin, fmax, mult: int, sequential,
                    seg_len: int | None = None, iters: int = 6):
    """Per-segment Newton solve with the sequential fallback, over a chunk
    x [N] complex64 (the JAX package's pll_newton_scan): a segment whose
    fixed point fails its check runs ``sequential(state, x) -> (state',
    (out, err))`` (K3 on the card) from the same entering state, so one
    unlocked region serializes only its own segment.

    The JAX package chooses with ``lax.cond`` inside ``lax.scan``; here
    the choice is a host branch, one device-to-host read of the
    segment's ``valid`` flag a segment: a sync a segment
    (``pll_newton_scan.host_reads`` counts them).  Segments are the
    largest power-of-two divisor of N up to 1024; below 64 the whole
    chunk runs ``sequential``.  Returns (state', (out, err))."""
    n = x.shape[-1]
    if seg_len is None:
        seg_len = _pow2_segment(n)

    def seq(st, xs):
        st2, (o, e) = sequential(st, xs)
        return (tuple(torch.as_tensor(v, dtype=torch.float32,
                                      device=x.device).reshape(())
                      for v in st2),
                o.to(torch.complex64), e.to(torch.float32))

    if seg_len < 64:
        st, o, e = seq(state, x)
        return st, (o, e)
    carry = tuple(torch.as_tensor(v, dtype=torch.float32, device=x.device)
                  .reshape(()) for v in state)
    outs, errs = [], []
    for k in range(n // seg_len):
        xs = x[k * seg_len:(k + 1) * seg_len]
        ok, n_state, n_out, n_err = pll_newton_segment(
            xs, carry, alpha, beta, fmin, fmax, mult, iters=iters)
        pll_newton_scan.host_reads += 1
        if bool(ok):
            carry = n_state
            outs.append(n_out)
            errs.append(n_err)
            pll_newton_scan.segments[0] += 1
        else:
            carry, o, e = seq(carry, xs)
            outs.append(o)
            errs.append(e)
            pll_newton_scan.segments[1] += 1
    return carry, (torch.cat(outs), torch.cat(errs))


pll_newton_scan.host_reads = 0
#: segments solved by Newton and segments that fell back, so far
pll_newton_scan.segments = [0, 0]


__all__ = ["pll_linear", "pll_hybrid", "pll_newton_segment",
           "pll_newton_scan"]
