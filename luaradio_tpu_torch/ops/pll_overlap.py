"""Overlap-and-discard batched PLL: the unlocked loop run as concurrent
segments (the JAX package's ops/pll_overlap.py, in torch).

The loop is contractive: both eigenvalues of its small-signal matrix have
|lambda| ~ 1 - alpha/2, so a segment started W samples early from a guessed
state has forgotten the guess after the warm-up.  The chunk is split into
S segments of L samples, all S run together over W+L steps (the
reference's per-sample loop, pll.lua:138-167, batched over segments
instead of samples), the warm-up outputs are discarded, and exactness is
checked, not assumed: each segment's state entering its first real sample
must match its left neighbour's exit state within a tolerance derived from
the contraction bound.  One failed boundary invalidates the chunk, and the
caller runs the exact sequential kernel instead (ops/pll_linear.py
pll_hybrid).

The scan runs as one CUDA kernel launch for CUDA tensors (csrc/
pll_overlap.cu, one thread per segment; the port's own kernel for the JAX
package's lax.scan) and as its plain twin, a Python loop over the steps of
[S]-wide tensors, for CPU tensors; any other device raises.  The set-up,
the boundary check and the chaining are torch on both paths.
``pll_overlap_discard.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from luaradio_tpu_torch.ops import cudabuild

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = cudabuild.load("pll_overlap")
    if not lib.lr_pll_overlap_scan.argtypes:
        lib.lr_pll_overlap_scan.argtypes = [_VP, _I, _I, _I, _VP] + \
            [_F] * 5 + [_VP] * 6
        lib.lr_pll_overlap_scan.restype = ctypes.c_int
        lib.lr_overlap_chain_probe.argtypes = [_I] + [_F] * 4 + [_VP] * 3
        lib.lr_overlap_chain_probe.restype = ctypes.c_int
    return lib


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


def _initial_states(x, state, s: int, lseg: int, warm: int):
    """[5, S] float32 (vr, vi, mr, mi, fr): segment 0 takes the true
    carry; the others guess the VCO on the phase of their first warm-up
    sample, x[s*L - W], and take the carried frequency."""
    f32 = torch.float32
    dev = x.device
    p0, m0, f0 = (torch.as_tensor(v, dtype=f32, device=dev) for v in state)
    fhat = _unit(torch.cat([x.new_zeros(1), x[lseg - warm::lseg][:s - 1]]))
    is0 = torch.arange(s, device=dev) == 0
    one = torch.ones(s, dtype=f32, device=dev)
    return torch.stack([torch.where(is0, torch.cos(p0), fhat.real),
                        torch.where(is0, torch.sin(p0), fhat.imag),
                        torch.where(is0, torch.cos(m0), one),
                        torch.where(is0, torch.sin(m0), 0 * one),
                        f0.expand(s)]).contiguous()


def _scan_reference(x, init, consts, lseg: int, warm: int):
    """The batched scan in plain PyTorch, one Python step at a time over
    [S]-wide tensors.  Returns o_r, o_i, o_e [L, S], the state entering
    step W and the exit state, each [5, S]."""
    alpha, beta, fmin, fmax, multf = consts
    s = init.shape[1]
    f32 = torch.float32
    # per-segment inputs [S, W+L]: W samples of the left neighbour's tail
    # (zeros for segment 0, whose warm-up is masked off anyway)
    xpad = torch.cat([x.new_zeros(warm), x])[:s * lseg]
    seg = torch.cat([xpad.reshape(s, lseg)[:, :warm], x.reshape(s, lseg)],
                    dim=1)
    vr, vi, mr, mi, fr = init.unbind(0)
    not0 = torch.arange(s, device=x.device) != 0
    xr_all = seg.real.t().contiguous()                     # [W+L, S]
    xi_all = seg.imag.t().contiguous()
    o_r = torch.empty(lseg, s, dtype=f32, device=x.device)
    o_i = torch.empty_like(o_r)
    o_e = torch.empty_like(o_r)
    for i in range(warm + lseg):
        if i == warm:
            # the state ENTERING the first post-warm-up sample: the
            # boundary state the left neighbour must reproduce
            snap = torch.stack([vr, vi, mr, mi, fr])
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
    return o_r, o_i, o_e, snap, torch.stack([vr, vi, mr, mi, fr])


def _scan_kernel(x, init, consts, lseg: int, warm: int):
    """The batched scan as one launch of csrc/pll_overlap.cu; returns as
    :func:`_scan_reference`."""
    s = init.shape[1]
    o_r = torch.empty(lseg, s, dtype=torch.float32, device=x.device)
    o_i = torch.empty_like(o_r)
    o_e = torch.empty_like(o_r)
    snap = torch.empty_like(init)
    fin = torch.empty_like(init)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lr_pll_overlap_scan(
            x.data_ptr(), s, lseg, warm, init.data_ptr(), *consts,
            o_r.data_ptr(), o_i.data_ptr(), o_e.data_ptr(), snap.data_ptr(),
            fin.data_ptr(), stream)
    cudabuild.check(lib, code, "pll_overlap_discard")
    pll_overlap_discard.launches += 1
    return o_r, o_i, o_e, snap, fin


def _run(scan, x, state, alpha, beta, fmin, fmax, mult, lseg, warm,
         tol_phase, tol_freq):
    if x.dim() != 1 or x.dtype != torch.complex64 or not x.is_contiguous():
        raise ValueError(f"x: want contiguous complex64 [N], got {x.dtype} "
                         f"{tuple(x.shape)}")
    n = x.shape[-1]
    if n % lseg or n < 2 * lseg or not 0 <= warm <= lseg:
        raise ValueError(f"{n} samples do not split into segments of {lseg} "
                         f"after {warm} warm-up steps")
    s = n // lseg
    dev = x.device
    # (alpha, beta, fmin, fmax, mult), each rounded to float32
    consts = tuple(float(np.float32(v))
                   for v in (alpha, beta, fmin, fmax, mult))
    init = _initial_states(x, state, s, lseg, warm)
    o_r, o_i, o_e, snap, fin = scan(x, init, consts, lseg, warm)
    vr, vi, mr, mi, fr = fin.unbind(0)
    svr, svi, smr, smi, sfr = snap.unbind(0)

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


def pll_overlap_discard_reference(x, state, alpha, beta, fmin, fmax, mult,
                                  lseg: int, warm: int,
                                  tol_phase: float = 0.02,
                                  tol_freq: float = 0.005):
    """Plain twin of :func:`pll_overlap_discard`, on any device: the scan
    as a Python loop over the W+L steps."""
    return _run(_scan_reference, x, state, alpha, beta, fmin, fmax, mult,
                lseg, warm, tol_phase, tol_freq)


def pll_overlap_discard(x, state, alpha, beta, fmin, fmax, mult,
                        lseg: int, warm: int, tol_phase: float = 0.02,
                        tol_freq: float = 0.005):
    """Run the exact PLL recurrence over x complex64 [N] as S = N/L
    concurrent segments.

    Returns (valid, new_state, out [N] complex64, err [N] float32), with
    ``valid`` a bool tensor; when it is False the outputs are not to be
    trusted and the caller must use the sequential kernel.  ``state`` is
    (phi_l, phi_m, freq)."""
    if x.device.type == "cpu":
        return pll_overlap_discard_reference(x, state, alpha, beta, fmin,
                                             fmax, mult, lseg, warm,
                                             tol_phase, tol_freq)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _run(_scan_kernel, x, state, alpha, beta, fmin, fmax, mult, lseg,
                warm, tol_phase, tol_freq)


pll_overlap_discard.launches = 0


def chain_probe(steps: int, device, alpha, beta, fmin,
                fmax) -> tuple[float, int]:
    """Time the scan step's dependent chain through the VCO alone on the
    card (one thread, ``steps`` steps, no m update; csrc/pll_overlap.cu
    overlap_chain_probe_kernel): returns (milliseconds, clock64 cycles).
    A measurement of a segment's latency floor, not a kernel of the
    receiver."""
    dev = torch.device(device)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        code = lib.lr_overlap_chain_probe(
            steps, *(float(np.float32(v)) for v in (alpha, beta, fmin,
                                                     fmax)),
            cycles.data_ptr(), sink.data_ptr(), stream.cuda_stream)
        b.record()
    cudabuild.check(lib, code, "overlap_chain_probe")
    b.synchronize()
    return a.elapsed_time(b), int(cycles.item())


__all__ = ["plan_overlap", "pll_overlap_discard",
           "pll_overlap_discard_reference", "chain_probe"]
