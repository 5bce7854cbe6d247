"""First-order linear recurrences (single-pole IIR filters).

The reference runs IIR filters as sequential per-sample loops
(radio/blocks/signal/iirfilter.lua).  Stable torch has no associative scan,
so y[n] = a*y[n-1] + u[n] is solved in blocks of B samples as matrix
products: within a block y = L u with the lower-triangular Toeplitz matrix
L[i, j] = a^(i-j); the block-end values form the same recurrence with
coefficient a^B one level up, solved by the same function, and each block
then adds a^(i+1) times the value entering it.  Every level is one matmul,
so a chunk costs a few passes over memory instead of N sequential steps.

A complex coefficient (the eigenvalues of the PLL's loop matrix,
ops/pll_linear.py) takes the same blocks as complex64 matrices built in
complex128; a real coefficient keeps its real float32 matrices.

A per-sample coefficient a[n] (the AGC's gain gate, blocks/signal/
carrier.py) has no Toeplitz matrix.  It takes the JAX package's blocked
affine scan instead: (a, u) pairs combine as (a1 a2, a2 u1 + u2), solved
by Hillis-Steele doubling inside blocks of 256, the block summaries by the
same scan one level up, then each block adds its cumulative product times
the value entering it.  Only products of the a[n] are formed, never a
quotient, so a long run of a = 1 (a hold) or of small a stays exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from luaradio_tpu_torch.ops.fir import fp32_exact

_B = 128


@functools.lru_cache(maxsize=64)
def _powers(a: float | complex, n: int, device: str):
    """(L [n, n] with L[i, j] = a^(i-j) for i >= j else 0, p [n] = a^(i+1)):
    float32 tensors built in float64 for a real ``a``, complex64 ones built
    in complex128 for a complex ``a``."""
    wide, narrow = ((np.complex128, np.complex64) if isinstance(a, complex)
                    else (np.float64, np.float32))
    i = np.arange(n)
    e = i[:, None] - i[None, :]
    lmat = np.where(e >= 0, wide(a) ** np.maximum(e, 0), 0.0)
    p = wide(a) ** (i + 1)
    return (torch.from_numpy(lmat.astype(narrow)).to(device),
            torch.from_numpy(p.astype(narrow)).to(device))


def _linrec_rows(u: torch.Tensor, a: float | complex,
                 y0: torch.Tensor) -> torch.Tensor:
    """u [M, N] float32 (complex64 for a complex ``a``), y0 [M] ->
    y [M, N]."""
    m, n = u.shape
    dev = str(u.device)
    if n <= _B:
        lmat, p = _powers(a, n, dev)
        with fp32_exact():
            return u @ lmat.T + p * y0[:, None]
    nb = -(-n // _B)
    if nb * _B != n:
        u = torch.cat([u, u.new_zeros(m, nb * _B - n)], dim=-1)
    lmat, p = _powers(a, _B, dev)
    with fp32_exact():
        local = u.reshape(m, nb, _B) @ lmat.T             # zero entry state
    ends = _linrec_rows(local[..., -1], a ** _B, y0)      # y at block ends
    cin = torch.cat([y0[:, None], ends[:, :-1]], dim=-1)  # y entering block
    y = local + p * cin[..., None]
    return y.reshape(m, nb * _B)[:, :n]


_AB = 256   # block of the per-sample coefficient's scan (the JAX package's)


def _affine_scan_doubling(a: torch.Tensor, u: torch.Tensor):
    """Inclusive affine scan along the last axis by Hillis-Steele doubling:
    returns (prod a[0..n], y[n] from a zero start)."""
    n = a.shape[-1]
    d = 1
    while d < n:
        a_prev = torch.cat([torch.ones_like(a[..., :d]), a[..., :-d]], -1)
        u_prev = torch.cat([torch.zeros_like(u[..., :d]), u[..., :-d]], -1)
        u = a * u_prev + u
        a = a_prev * a
        d *= 2
    return a, u


def _linrec_array(u: torch.Tensor, a: torch.Tensor,
                  y0: torch.Tensor) -> torch.Tensor:
    """y[n] = a[n] y[n-1] + u[n] for u, a [..., N], y0 [...]."""
    n = u.shape[-1]
    if n <= _AB:
        acum, ucum = _affine_scan_doubling(a, u)
        return acum * y0[..., None] + ucum
    nb = -(-n // _AB)
    if nb * _AB != n:        # identity steps after the end change nothing
        pad = nb * _AB - n
        a = torch.cat([a, a.new_ones(a.shape[:-1] + (pad,))], -1)
        u = torch.cat([u, u.new_zeros(u.shape[:-1] + (pad,))], -1)
    lead = u.shape[:-1]
    acum, ucum = _affine_scan_doubling(a.reshape(lead + (nb, _AB)),
                                       u.reshape(lead + (nb, _AB)))
    ends = _linrec_array(ucum[..., -1], acum[..., -1], y0)  # y at block ends
    cin = torch.cat([y0[..., None], ends[..., :-1]], -1)    # y entering
    y = acum * cin[..., None] + ucum
    return y.reshape(lead + (nb * _AB,))[..., :n]


def linrec_first_order(u: torch.Tensor, a, y0: torch.Tensor) -> torch.Tensor:
    """Solve y[n] = a*y[n-1] + u[n] along the last axis.

    u: [..., N] float32 or complex64; a: real or complex scalar with
    |a| <= 1 (a complex ``a`` makes y complex64), or a per-sample
    coefficient a[n], a tensor broadcastable to u; y0: [...] the value
    before the chunk.  Returns y: [..., N]."""
    if isinstance(a, torch.Tensor) and a.dim() > 0:
        a = a.to(u.dtype).expand(u.shape)
        y0 = torch.as_tensor(y0, dtype=u.dtype,
                             device=u.device).expand(u.shape[:-1])
        return _linrec_array(u, a, y0)
    if abs(a) > 1:
        raise ValueError(f"linrec_first_order: unstable coefficient {a}")
    lead, n = u.shape[:-1], u.shape[-1]
    if np.iscomplexobj(a):
        u = u.to(torch.complex64)
        y0 = y0.to(torch.complex64).expand(lead)
        y = _linrec_rows(u.reshape(-1, n), complex(a), y0.reshape(-1))
        return y.reshape(lead + (n,))
    y0 = y0.to(u.dtype).expand(lead)
    if u.is_complex():
        ur = torch.view_as_real(u).movedim(-1, 0)          # [2, ..., N]
        yr = torch.view_as_real(y0.contiguous()).movedim(-1, 0)
        y = _linrec_rows(ur.reshape(-1, n), float(a), yr.reshape(-1))
        y = y.reshape((2,) + lead + (n,)).movedim(0, -1).contiguous()
        return torch.view_as_complex(y)
    y = _linrec_rows(u.reshape(-1, n), float(a), y0.reshape(-1))
    return y.reshape(lead + (n,))


def cummax_blocked(x: torch.Tensor) -> torch.Tensor:
    """Cumulative max along the last axis (the JAX package's
    cummax_blocked; its two-level blocking works around XLA's log-depth
    cummax on the TPU, which torch.cummax does not need)."""
    return torch.cummax(x, dim=-1).values


__all__ = ["linrec_first_order", "cummax_blocked"]
