"""Overlap-and-discard batched PLL: the unlocked loop run as concurrent
segments (the JAX package's ops/pll_overlap.py, in torch).

The loop is contractive: both eigenvalues of its small-signal matrix have
|lambda| ~ 1 - alpha/2, so a segment started W samples early from a guessed
state has forgotten the guess after the warm-up.  The chunk is split into
S segments of L samples; all S run together as one Python loop over W+L
steps of [S]-wide tensors (the reference's per-sample loop, pll.lua:138-167,
vectorized over segments instead of samples), the warm-up outputs are
discarded, and exactness is checked, not assumed: each segment's state
entering its first real sample must match its left neighbour's exit state
within a tolerance derived from the contraction bound.  One failed
boundary invalidates the chunk, and the caller runs the exact sequential
kernel instead (ops/pll_linear.py pll_hybrid).
"""

from __future__ import annotations

import numpy as np
import torch


def plan_overlap(n: int, alpha: float, decay: float = 12.0,
                 max_segments: int = 4096):
    """Choose (segment length L, warm-up W) for an n-sample chunk, or None
    when the chunk is too short for the warm-up the loop bandwidth needs
    (W ~ decay/alpha forgets the guess by e^(-decay/2); L = 4W keeps the
    redundant warm-up work at 25 %)."""
    if alpha <= 0:
        return None
    w = int(decay / alpha)
    w = max(w, 64)
    lseg = 1
    while lseg < 4 * w:
        lseg *= 2
    while n % lseg != 0 or n // lseg > max_segments:
        lseg *= 2
        if lseg > n:
            return None
    if n // lseg < 2:
        return None
    return lseg, min(w, lseg)


def _unit(z: torch.Tensor) -> torch.Tensor:
    mag = z.abs()
    return torch.where(mag > 0, z / torch.clamp(mag, min=1e-30),
                       torch.ones_like(z))


def pll_overlap_discard(x, state, alpha, beta, fmin, fmax, mult,
                        lseg: int, warm: int, tol_phase: float = 0.02,
                        tol_freq: float = 0.005):
    """Run the exact PLL recurrence over x complex64 [N] as S = N/L
    concurrent segments.

    Returns (valid, new_state, out [N] complex64, err [N] float32), with
    ``valid`` a bool tensor; when it is False the outputs are not to be
    trusted and the caller must use the sequential kernel.  ``state`` is
    (phi_l, phi_m, freq)."""
    f32 = torch.float32
    dev = x.device
    alpha, beta, fmin, fmax, multf = (float(np.float32(v)) for v in
                                      (alpha, beta, fmin, fmax, mult))
    n = x.shape[-1]
    s = n // lseg
    p0, m0, f0 = (torch.as_tensor(v, dtype=f32, device=dev) for v in state)

    # per-segment inputs [S, W+L]: W samples of the left neighbour's tail
    # (zeros for segment 0, whose warm-up is masked off anyway)
    xpad = torch.cat([x.new_zeros(warm), x])[:s * lseg]
    seg = torch.cat([xpad.reshape(s, lseg)[:, :warm], x.reshape(s, lseg)],
                    dim=1)

    # initial states: segment 0 takes the true carry; the others guess the
    # VCO on the first warm-up sample's phase and the carried frequency
    fhat = _unit(seg[:, 0])
    is0 = torch.arange(s, device=dev) == 0
    vr = torch.where(is0, torch.cos(p0), fhat.real)
    vi = torch.where(is0, torch.sin(p0), fhat.imag)
    mr = torch.where(is0, torch.cos(m0), torch.ones_like(vr))
    mi = torch.where(is0, torch.sin(m0), torch.zeros_like(vr))
    fr = f0.expand(s).clone()

    xr_all = seg.real.t().contiguous()                     # [W+L, S]
    xi_all = seg.imag.t().contiguous()
    o_r = torch.empty(lseg, s, dtype=f32, device=dev)
    o_i = torch.empty_like(o_r)
    o_e = torch.empty_like(o_r)
    not0 = ~is0
    for i in range(warm + lseg):
        if i == warm:
            # the state ENTERING the first post-warm-up sample: the
            # boundary state the left neighbour must reproduce
            snap = [vr, vi, mr, mi, fr]
        xr, xim = xr_all[i], xi_all[i]
        pr = xr * vr + xim * vi
        pi_ = xim * vr - xr * vi
        err = torch.atan2(pi_, pr)
        f2 = fr + beta * err
        dl = f2 + alpha * err
        dm = multf * f2 + alpha * err
        sl, cl = torch.sin(dl), torch.cos(dl)
        sm, cm = torch.sin(dm), torch.cos(dm)
        vr2 = vr * cl - vi * sl
        vi2 = vr * sl + vi * cl
        mr2 = mr * cm - mi * sm
        mi2 = mr * sm + mi * cm
        gv = 1.5 - 0.5 * (vr2 * vr2 + vi2 * vi2)
        gm = 1.5 - 0.5 * (mr2 * mr2 + mi2 * mi2)
        f3 = torch.clamp(f2, fmin, fmax)
        if i >= warm:
            o_r[i - warm], o_i[i - warm], o_e[i - warm] = mr, mi, err
            vr, vi, mr, mi, fr = vr2 * gv, vi2 * gv, mr2 * gm, mi2 * gm, f3
        else:
            # segment 0 holds its true carry through the zero warm-up
            vr = torch.where(not0, vr2 * gv, vr)
            vi = torch.where(not0, vi2 * gv, vi)
            mr = torch.where(not0, mr2 * gm, mr)
            mi = torch.where(not0, mi2 * gm, mi)
            fr = torch.where(not0, f3, fr)
    svr, svi, smr, smi, sfr = snap

    # boundary check: segment s-1's exit state against segment s's entry
    # state after the warm-up, VCO phasor and frequency.  The multiplied
    # oscillator is an open-loop integrator (pll.lua:158), so each segment
    # has it up to a constant offset, chained below.
    d_v = torch.atan2(vi[:-1] * svr[1:] - vr[:-1] * svi[1:],
                      vr[:-1] * svr[1:] + vi[:-1] * svi[1:]).abs()
    d_f = (fr[:-1] - sfr[1:]).abs()
    valid = (d_v.max() < tol_phase) & (d_f.max() < tol_freq)

    exit_m = torch.complex(mr, mi)
    snap_m = torch.complex(smr, smi)
    ratio = torch.cat([torch.ones(1, dtype=torch.complex64, device=dev),
                       exit_m[:-1] * snap_m[1:].conj()])
    delta = torch.cumprod(ratio, dim=0)
    delta = delta / torch.clamp(delta.abs(), min=1e-30)

    out = torch.complex(o_r, o_i) * delta[None, :]        # [L, S]
    out = out.t().reshape(n).contiguous()
    err = o_e.t().reshape(n).contiguous()
    m_last = exit_m[-1] * delta[-1]
    new_state = (torch.atan2(vi[-1], vr[-1]),
                 torch.atan2(m_last.imag, m_last.real), fr[-1])
    return valid, new_state, out, err


__all__ = ["plan_overlap", "pll_overlap_discard"]
