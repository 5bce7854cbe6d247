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
the guard, one device-to-host sync per chunk.
"""

from __future__ import annotations

import numpy as np
import torch

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
    """Linear-scan PLL over x complex64 [N] with state (phi_l, phi_m, freq).

    Returns (valid, new_state, out [N] complex64, err [N] float32): the
    locked-loop solution and a bool tensor saying whether it is exact
    (see :func:`pll_hybrid`).  ``mult`` is a positive integer."""
    f32, c64 = torch.float32, torch.complex64
    dev = x.device
    alpha = np.float32(alpha)
    beta = np.float32(beta)
    af, bf = float(alpha), float(beta)
    p0, m0, f0 = (torch.as_tensor(s, dtype=f32, device=dev) for s in state)
    n = x.shape[-1]

    theta = torch.atan2(x.imag, x.real)
    mag = x.abs()
    xhat = torch.where(mag > 0, x / torch.clamp(mag, min=1e-30),
                       torch.ones_like(x))

    # unwrapped input phase, detrended: theta_u[n] = p0 + c1*n + tau[n]
    d0 = _wrap(theta[0] - p0)
    inc = _wrap(theta[1:] - theta[:-1])
    c1 = inc.sum() / float(max(n - 1, 1))
    tau = d0 + torch.cat([theta.new_zeros(1), torch.cumsum(inc - c1, 0)])

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
        zs.append(torch.cat([z_init[None], zk]))
    p_h = (complex(np.complex64(vmat[0, 0])) * zs[0]
           + complex(np.complex64(vmat[0, 1])) * zs[1]).real
    f_h = (complex(np.complex64(vmat[1, 0])) * zs[0]
           + complex(np.complex64(vmat[1, 1])) * zs[1]).real

    err = tau - p_h[:-1]
    f_new = c1 + f_h[:-1] + bf * err                 # pre-clamp freq[n+1]

    # guards: the linear solution is exact iff these hold
    margin = float(np.float32(np.pi * (15.0 / 16.0)))
    valid = ((err.abs().max() < margin)
             & (f_new.max() <= float(np.float32(fmax)))
             & (f_new.min() >= float(np.float32(fmin)))
             & (tau.abs().max() < 512.0))

    # outputs: unit phasors times small rotations
    s_cum = torch.cat([err.new_zeros(1), torch.cumsum(err, 0)])
    small = -float(mult) * err + float(alpha * np.float32(1 - mult)) \
        * s_cum[:-1]
    base = _rot(m0 - float(mult) * p0)
    out = base * _phasor_pow(xhat, mult) * _rot(small)

    # final state by phasor composition (no large phases)
    dl = f_new[-1] + float(alpha - np.float32(1.0)) * err[-1]
    vco_next = xhat[-1] * _rot(dl)
    dm = float(mult) * f_new[-1] + af * err[-1]
    osc_next = out[-1] * _rot(dm)
    new_state = (torch.atan2(vco_next.imag, vco_next.real),
                 torch.atan2(osc_next.imag, osc_next.real),
                 torch.clamp(f_new[-1], float(np.float32(fmin)),
                             float(np.float32(fmax))))
    return valid, new_state, out.to(c64), err


def pll_hybrid(x, state, alpha, beta, fmin, fmax, mult: int, sequential,
               allow_overlap: bool = True, tiers: dict | None = None):
    """Three-tier PLL dispatch over x complex64 [N]:

    1. the full-chunk LINEAR solution when the loop is locked;
    2. the OVERLAP-AND-DISCARD batched scan otherwise, where it plans for
       the chunk and the chunk looks coherent (ops/pll_overlap.py);
    3. the exact sequential kernel ``sequential(state, x) -> (state',
       (out, err))`` (K3) when neither holds.

    The linear tier always runs; each later tier runs only when the one
    before it failed, decided on the host.  ``allow_overlap=False``
    (PLLBlock(exact=True)) skips tier 2.  ``tiers``, when given, maps each
    tier's number (1, 2, 3) to the chunks it produced and is counted up.
    Returns (state', (out, err))."""
    from luaradio_tpu_torch.ops.pll_overlap import (plan_overlap,
                                                    pll_overlap_discard)

    def taken(tier, result):
        if tiers is not None:
            tiers[tier] = tiers.get(tier, 0) + 1
        return result

    valid, lin_state, lin_out, lin_err = pll_linear(
        x, state, alpha, beta, fmin, fmax, mult)
    if bool(valid):
        return taken(1, (lin_state, (lin_out, lin_err)))
    plan = plan_overlap(x.shape[-1], float(alpha)) if allow_overlap else None
    if plan is not None:
        # coherence gate: on carrier-free noise the warm-up never
        # converges, so the batched scan would be wasted ahead of the
        # sequential kernel; the lag-1 autocorrelation says whether there
        # is a carrier to track
        c = (x[1:] * x[:-1].conj()).sum()
        p = (x.real ** 2 + x.imag ** 2).sum()
        if bool(c.abs() > 0.05 * torch.clamp(p, min=1e-30)):
            ok, b_state, b_out, b_err = pll_overlap_discard(
                x, state, alpha, beta, fmin, fmax, mult, *plan)
            if bool(ok):
                return taken(2, (b_state, (b_out, b_err)))
    return taken(3, sequential(state, x))


__all__ = ["pll_linear", "pll_hybrid"]
