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
pll_overlap.cu, the port's own kernel for the JAX package's lax.scan:
copy, walker and oscillator warps over shared-memory rings, a lane a
segment) and as its plain twin, a Python loop over the steps of [S]-wide
tensors, for CPU tensors; any other device raises.  Both give the
outputs [C*S, L], each segment's L samples contiguous.  The set-up, the
boundary check and the chaining are torch on both paths.  A bank of C
rows [C, N] runs all its C x S segments in one launch, and the boundary
check, the chaining and ``valid`` are per row.
``pll_overlap_discard.launches`` counts kernel launches and
``pll_overlap_discard.rows`` the rows they carried.
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
        lib.lr_pll_overlap_scan.argtypes = [_VP, _I, _I, _I, _I, _VP] + \
            [_F] * 5 + [_VP] * 6
        lib.lr_pll_overlap_scan.restype = ctypes.c_int
        lib.lr_overlap_chain_probe.argtypes = [_I] + [_F] * 4 + [_VP] * 3
        lib.lr_overlap_chain_probe.restype = ctypes.c_int
        lib.lr_pll_overlap_ring.argtypes = [ctypes.POINTER(_I)]
        lib.lr_pll_overlap_ring.restype = None
    return lib


def shipped_ring() -> dict:
    """The built kernel's ring: segments a block ``g``, steps a stage
    ``t``, stages ``p``, ``store`` (0: bulk copies from shared memory, 1:
    straight to global memory) and ``zero_warm`` (1: steps with no sample
    walk zeros; 0: samples that exist, csrc/pll_overlap.cu stage_base).
    Needs the CUDA build."""
    out = (_I * 5)()
    _lib().lr_pll_overlap_ring(out)
    return dict(zip(("g", "t", "p", "store", "zero_warm"), out))


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


def _cumprod(z: torch.Tensor) -> torch.Tensor:
    """Inclusive product along the last axis by doubling (Hillis-Steele):
    elementwise products only, so each row of a bank rounds as it does
    alone.  torch.cumprod on the card picks its scan algorithm by the
    tensor's shape, which moved a bank row's chained outputs by ~2e-7
    against its one-row call."""
    d, n = 1, z.shape[-1]
    while d < n:
        z = torch.cat([z[..., :d], z[..., d:] * z[..., :-d]], dim=-1)
        d *= 2
    return z


def _unit(z: torch.Tensor) -> torch.Tensor:
    mag = z.abs()
    return torch.where(mag > 0, z / torch.clamp(mag, min=1e-30),
                       torch.ones_like(z))


def _initial_states(x, state, s: int, lseg: int, warm: int):
    """[5, C*S] float32 (vr, vi, mr, mi, fr), column c*S + s for row c's
    segment s: segment 0 takes the row's true carry; the others guess the
    VCO on the phase of their first warm-up sample, x[c, s*L - W], and take
    the carried frequency."""
    f32 = torch.float32
    dev = x.device
    rows = x.shape[0]
    p0, m0, f0 = (torch.as_tensor(v, dtype=f32, device=dev).expand(rows)
                  [:, None] for v in state)
    fhat = _unit(torch.cat([x.new_zeros(rows, 1),
                            x[:, lseg - warm::lseg][:, :s - 1]], dim=1))
    is0 = torch.arange(s, device=dev) == 0
    one = torch.ones(rows, s, dtype=f32, device=dev)
    init = torch.stack([torch.where(is0, torch.cos(p0), fhat.real),
                        torch.where(is0, torch.sin(p0), fhat.imag),
                        torch.where(is0, torch.cos(m0), one),
                        torch.where(is0, torch.sin(m0), 0 * one),
                        f0.expand(rows, s)])
    return init.reshape(5, rows * s).contiguous()


def _scan_reference(x, init, consts, lseg: int, warm: int):
    """The batched scan in plain PyTorch, one Python step at a time over
    [C*S]-wide tensors.  Returns o_r, o_i, o_e [C*S, L] (segment g's
    outputs in row g, as the kernel gives them), the state entering step
    W and the exit state, each [5, C*S]."""
    alpha, beta, fmin, fmax, multf = consts
    rows, n = x.shape
    s = n // lseg
    f32 = torch.float32
    # per-segment inputs [C*S, W+L]: W samples of the left neighbour's tail
    # (zeros for segment 0, whose warm-up is masked off anyway)
    xpad = torch.cat([x.new_zeros(rows, warm), x], dim=1)[:, :s * lseg]
    seg = torch.cat([xpad.reshape(rows, s, lseg)[..., :warm],
                     x.reshape(rows, s, lseg)], dim=2).reshape(rows * s, -1)
    vr, vi, mr, mi, fr = init.unbind(0)
    not0 = torch.arange(rows * s, device=x.device) % s != 0
    xr_all = seg.real.t().contiguous()                     # [W+L, C*S]
    xi_all = seg.imag.t().contiguous()
    o_r = torch.empty(lseg, rows * s, dtype=f32, device=x.device)
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
    return (o_r.t().contiguous(), o_i.t().contiguous(), o_e.t().contiguous(),
            snap, torch.stack([vr, vi, mr, mi, fr]))


def _scan_kernel(x, init, consts, lseg: int, warm: int):
    """The batched scan as one launch of csrc/pll_overlap.cu over every
    segment of every row; returns as :func:`_scan_reference`."""
    rows, n = x.shape
    width = init.shape[1]
    o_r = torch.empty(width, lseg, dtype=torch.float32, device=x.device)
    o_i = torch.empty_like(o_r)
    o_e = torch.empty_like(o_r)
    snap = torch.empty_like(init)
    fin = torch.empty_like(init)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lr_pll_overlap_scan(
            x.data_ptr(), rows, n // lseg, lseg, warm, init.data_ptr(),
            *consts, o_r.data_ptr(), o_i.data_ptr(), o_e.data_ptr(),
            snap.data_ptr(), fin.data_ptr(), stream)
    cudabuild.check(lib, code, "pll_overlap_discard")
    pll_overlap_discard.launches += 1
    pll_overlap_discard.rows += rows
    return o_r, o_i, o_e, snap, fin


def _run(scan, x, state, alpha, beta, fmin, fmax, mult, lseg, warm,
         tol_phase, tol_freq):
    if x.dim() not in (1, 2) or x.dtype != torch.complex64 \
            or not x.is_contiguous():
        raise ValueError(f"x: want contiguous complex64 [N] or [C, N], got "
                         f"{x.dtype} {tuple(x.shape)}")
    n = x.shape[-1]
    if n % lseg or n < 2 * lseg or not 0 <= warm <= lseg:
        raise ValueError(f"{n} samples do not split into segments of {lseg} "
                         f"after {warm} warm-up steps")
    one = x.dim() == 1
    xb = x[None] if one else x
    rows, s = xb.shape[0], n // lseg
    dev = x.device
    # (alpha, beta, fmin, fmax, mult), each rounded to float32
    consts = tuple(float(np.float32(v))
                   for v in (alpha, beta, fmin, fmax, mult))
    init = _initial_states(xb, state, s, lseg, warm)
    o_r, o_i, o_e, snap, fin = scan(xb, init, consts, lseg, warm)
    vr, vi, mr, mi, fr = fin.reshape(5, rows, s).unbind(0)
    svr, svi, smr, smi, sfr = snap.reshape(5, rows, s).unbind(0)

    # boundary check, row by row: segment s-1's exit state against segment
    # s's entry state after the warm-up, VCO phasor and frequency.  The
    # multiplied oscillator is an open-loop integrator (pll.lua:158), so
    # each segment has it up to a constant offset, chained below.
    d_v = torch.atan2(vi[:, :-1] * svr[:, 1:] - vr[:, :-1] * svi[:, 1:],
                      vr[:, :-1] * svr[:, 1:] + vi[:, :-1] * svi[:, 1:]).abs()
    d_f = (fr[:, :-1] - sfr[:, 1:]).abs()
    valid = (d_v.amax(dim=1) < tol_phase) & (d_f.amax(dim=1) < tol_freq)

    exit_m = torch.complex(mr, mi)
    snap_m = torch.complex(smr, smi)
    ratio = torch.cat([torch.ones(rows, 1, dtype=torch.complex64,
                                  device=dev),
                       exit_m[:, :-1] * snap_m[:, 1:].conj()], dim=1)
    delta = _cumprod(ratio)
    delta = delta / torch.clamp(delta.abs(), min=1e-30)

    # [C*S, L] -> [C, S, L] -> [C, N]: reshapes, no copies
    out = (torch.complex(o_r, o_i).reshape(rows, s, lseg)
           * delta[..., None]).reshape(rows, n)
    err = o_e.reshape(rows, n)
    m_last = exit_m[:, -1] * delta[:, -1]
    new_state = (torch.atan2(vi[:, -1], vr[:, -1]),
                 torch.atan2(m_last.imag, m_last.real), fr[:, -1])
    if one:
        return (valid[0], tuple(v[0] for v in new_state), out[0], err[0])
    return valid, new_state, out, err


def pll_overlap_discard_reference(x, state, alpha, beta, fmin, fmax, mult,
                                  lseg: int, warm: int,
                                  tol_phase: float = 0.02,
                                  tol_freq: float = 0.005):
    """Plain twin of :func:`pll_overlap_discard`, on any device: the scan
    as a Python loop over the W+L steps.  A bank [C, N] runs its rows one
    after another, so each row is exactly what it gives alone (torch's
    CPU kernels round a complex product differently in their vector and
    scalar loops, so a batched set-up could move a row by an ulp)."""
    if x.dim() != 2:
        return _run(_scan_reference, x, state, alpha, beta, fmin, fmax,
                    mult, lseg, warm, tol_phase, tol_freq)
    rows = x.shape[0]
    leaves = [torch.as_tensor(v, dtype=torch.float32, device=x.device)
              .expand(rows) for v in state]
    got = [_run(_scan_reference, x[c].contiguous(),
                tuple(v[c] for v in leaves), alpha, beta, fmin, fmax, mult,
                lseg, warm, tol_phase, tol_freq) for c in range(rows)]
    return (torch.stack([g[0] for g in got]),
            tuple(torch.stack(v) for v in zip(*(g[1] for g in got))),
            torch.stack([g[2] for g in got]),
            torch.stack([g[3] for g in got]))


def pll_overlap_discard(x, state, alpha, beta, fmin, fmax, mult,
                        lseg: int, warm: int, tol_phase: float = 0.02,
                        tol_freq: float = 0.005):
    """Run the exact PLL recurrence over x complex64 [N] as S = N/L
    concurrent segments; a bank x [C, N] runs its C x S segments in one
    launch, each row on its own.

    Returns (valid, new_state, out [N] complex64, err [N] float32), with
    ``valid`` a bool tensor; when it is False the outputs are not to be
    trusted and the caller must use the sequential kernel.  ``state`` is
    (phi_l, phi_m, freq).  For a bank: valid [C], state leaves [C] (scalars
    broadcast) and out, err [C, N]."""
    if x.device.type == "cpu":
        return pll_overlap_discard_reference(x, state, alpha, beta, fmin,
                                             fmax, mult, lseg, warm,
                                             tol_phase, tol_freq)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _run(_scan_kernel, x, state, alpha, beta, fmin, fmax, mult, lseg,
                warm, tol_phase, tol_freq)


pll_overlap_discard.launches = 0
pll_overlap_discard.rows = 0


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
           "pll_overlap_discard_reference", "chain_probe", "shipped_ring"]
