"""Linear recurrences: first-order (single-pole IIR filters), order p
(IIR filters of any order) and the running phase of the FM modulator.

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

An IIR filter of order p runs in the transposed direct form II state
space s[n] = A s[n-1] + g x[n], y[n] = b0 x[n] + s[n-1][0]
(:func:`iir_state_space`).  The JAX package scans the affine maps
(A, g x[n]) with ``lax.associative_scan`` over [N, p, p] matrices; the
port uses the same two-level blocking as the first-order scan instead, so
nothing of size N p^2 is ever formed: within blocks of 128 samples the
outputs and the block-end states from a zero entry are matrix products
with constant matrices of A's powers (built in float64), the block-entry
states solve the order-p recurrence with A^128 one level up (the same
blocking on p-vectors), and each block then adds A^(i+1) times the state
entering it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from luaradio_tpu_torch.ops.fir import fp32_exact

_B = 128


@functools.lru_cache(maxsize=64, typed=True)
def _powers(a: float | complex, n: int, device: str):
    """(L [n, n] with L[i, j] = a^(i-j) for i >= j else 0, p [n] = a^(i+1)):
    float32 tensors built in float64 for a real ``a``, complex64 ones built
    in complex128 for a complex ``a``.  Cached by type as well as value:
    a complex ``a`` with no imaginary part (a real eigenvalue of the PLL's
    loop, or the 0 that deep levels reach) equals the float, whose real
    matrices must not be handed its complex ones."""
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


def iir_state_space(b_taps: np.ndarray, a_taps: np.ndarray):
    """The transposed-direct-form-II state space (A, g, b0) of y = b/a,
    with a[0]-normalized coefficients:

        s[n] = A s[n-1] + g x[n];  y[n] = b0 x[n] + s[n-1][0].

    Returns float32 numpy (A [p, p], g [p], b0), as the JAX package's."""
    b = np.asarray(b_taps, dtype=np.float64)
    a = np.asarray(a_taps, dtype=np.float64)
    b = b / a[0]
    a = a / a[0]
    p = max(len(b), len(a)) - 1
    bb = np.zeros(p + 1)
    bb[:len(b)] = b
    aa = np.zeros(p + 1)
    aa[:len(a)] = a
    amat = np.zeros((p, p))
    for i in range(p - 1):
        amat[i, i + 1] = 1.0
    amat[:, 0] = -aa[1:]
    g = bb[1:] - aa[1:] * bb[0]
    return amat.astype(np.float32), g.astype(np.float32), np.float32(bb[0])


_IB = 128   # samples in a block of the order-p scan


def _mat_powers(amat: np.ndarray, n: int) -> np.ndarray:
    """[n + 1, p, p] float64: A^0 .. A^n."""
    p = amat.shape[0]
    out = np.empty((n + 1, p, p))
    out[0] = np.eye(p)
    for k in range(1, n + 1):
        out[k] = amat @ out[k - 1]
    return out


@functools.lru_cache(maxsize=64)
def _iir_mats(a_bytes: bytes, g_bytes: bytes, p: int, n: int, device: str):
    """The constant matrices of one block of n samples, float32 on
    ``device`` (built in float64 from the float32 A and g):

    * t [n, n]: t[i, j] = (A^(i-1-j) g)[0] for j < i, the first state
      component before sample i from the block's inputs;
    * e [p, n]: e[:, j] = A^(n-1-j) g, the state after the block from its
      inputs;
    * q [n, p]: q[i] = (A^i)[0], the first state component before sample
      i from the state entering the block;
    * A^n, float64 numpy (the next level's matrix)."""
    amat = np.frombuffer(a_bytes, np.float32).reshape(p, p).astype(np.float64)
    g = np.frombuffer(g_bytes, np.float32).astype(np.float64)
    pw = _mat_powers(amat, n)
    ag = pw @ g                                     # [n + 1, p]: A^k g
    i = np.arange(n)
    lag = i[:, None] - 1 - i[None, :]
    t = np.where(lag >= 0, ag[np.maximum(lag, 0), 0], 0.0)
    e = ag[n - 1 - i].T
    q = pw[:n, 0, :]
    return tuple(torch.from_numpy(np.ascontiguousarray(m, np.float32))
                 .to(device) for m in (t, e, q)) + (pw[n],)


@functools.lru_cache(maxsize=64)
def _vec_mats(m_bytes: bytes, p: int, n: int, device: str):
    """For s[k] = M s[k-1] + v[k] over blocks of n steps: w [(n p),
    (n p)] with w[(i, a), (j, b)] = (M^(i-j))[a, b] for j <= i (the states
    from the block's inputs), r [(n p), p] with r[(i, a)] = (M^(i+1))[a]
    (from the state entering it) and M^n, float32 on ``device``."""
    mmat = np.frombuffer(m_bytes, np.float64).reshape(p, p)
    pw = _mat_powers(mmat, n)
    i = np.arange(n)
    lag = i[:, None] - i[None, :]
    w = np.where((lag >= 0)[:, :, None, None], pw[np.maximum(lag, 0)], 0.0)
    w = w.transpose(0, 2, 1, 3).reshape(n * p, n * p)
    r = pw[1:].reshape(n * p, p)
    return (torch.from_numpy(w.astype(np.float32)).to(device),
            torch.from_numpy(r.astype(np.float32)).to(device),
            pw[n])


def _vec_rec(v: torch.Tensor, mmat: np.ndarray,
             s0: torch.Tensor) -> torch.Tensor:
    """s[k] = M s[k-1] + v[k] for v [R, K, p] float32, M float64 [p, p],
    s0 [R, p] (the state before step 0) -> s [R, K, p]."""
    r_, k, p = v.shape
    n = max(4, min(_IB, 512 // p))
    if k <= n:
        w, r, _ = _vec_mats(mmat.tobytes(), p, k, str(v.device))
        with fp32_exact():
            s = v.reshape(r_, k * p) @ w.T + s0 @ r.T
        return s.reshape(r_, k, p)
    nb = -(-k // n)
    if nb * n != k:
        v = torch.cat([v, v.new_zeros(r_, nb * n - k, p)], 1)
    w, r, mn = _vec_mats(mmat.tobytes(), p, n, str(v.device))
    with fp32_exact():
        local = (v.reshape(r_ * nb, n * p) @ w.T).reshape(r_, nb, n, p)
    ends = _vec_rec(local[:, :, -1, :], mn, s0)        # s at block ends
    cin = torch.cat([s0[:, None], ends[:, :-1]], 1)    # s entering a block
    with fp32_exact():
        s = local + (cin @ r.T).reshape(r_, nb, n, p)
    return s.reshape(r_, nb * n, p)[:, :k]


def _iir_blocks(xb: torch.Tensor, amat: np.ndarray, g: np.ndarray):
    """Blocks xb [R, nb, n] from a zero entry state: (the first state
    component before each sample [R, nb, n], the state after each block
    [R, nb, p]) — the blocked form of the JAX package's ``_iir_cums``."""
    p, n = amat.shape[0], xb.shape[-1]
    t, e, _, _ = _iir_mats(amat.tobytes(), g.tobytes(), p, n, str(xb.device))
    with fp32_exact():
        return xb @ t.T, xb @ e.T


def _iir_emit(xb, prev0, ends, amat, g, b0, s_in):
    """Outputs [R, nb, n] and the final state [R, p] of blocks xb given
    the state entering the first one, s_in [R, p]."""
    r_, nb, n = xb.shape
    p = amat.shape[0]
    _, _, q, an = _iir_mats(amat.tobytes(), g.tobytes(), p, n,
                            str(xb.device))
    states = _vec_rec(ends, an, s_in)
    cin = torch.cat([s_in[:, None], states[:, :-1]], 1)   # entering a block
    with fp32_exact():
        y = float(b0) * xb + prev0 + cin @ q.T
    return y, states[:, -1]


def _iir_rows(x: torch.Tensor, amat, g, b0, s0: torch.Tensor):
    """x [R, N] float32, s0 [R, p] -> (y [R, N], s [R, p])."""
    r_, n = x.shape
    y, s = [], s0
    n_main = (n // _IB) * _IB
    for lo, hi, blk in ((0, n_main, _IB), (n_main, n, n - n_main)):
        if hi == lo:
            continue
        xb = x[:, lo:hi].reshape(r_, -1, blk)
        prev0, ends = _iir_blocks(xb, amat, g)
        yb, s = _iir_emit(xb, prev0, ends, amat, g, b0, s)
        y.append(yb.reshape(r_, hi - lo))
    if not y:
        return x.clone(), s
    return torch.cat(y, -1) if len(y) > 1 else y[0], s


def iir_apply(x: torch.Tensor, amat, g, b0, s0: torch.Tensor):
    """Apply an order-p IIR (:func:`iir_state_space`) along the last axis.

    x: [..., N] float32 or complex64; amat: [p, p], g: [p] (numpy float32);
    s0: [..., p] the carried state.  Returns (y [..., N], s_new [..., p]).
    A complex input runs its real and imaginary parts as two real rows
    (A, g and b0 are real)."""
    amat = np.ascontiguousarray(amat, np.float32)
    g = np.ascontiguousarray(g, np.float32)
    p = amat.shape[0]
    lead, n = x.shape[:-1], x.shape[-1]
    s0 = s0.to(x.dtype).expand(lead + (p,))
    if n == 0:
        return x.clone(), s0.clone()
    if x.is_complex():
        xr = torch.view_as_real(x).movedim(-1, 0).reshape(-1, n)
        sr = torch.view_as_real(s0.contiguous()).movedim(-1, 0)
        y, s = _iir_rows(xr.contiguous(), amat, g, b0, sr.reshape(-1, p))
        y = y.reshape((2,) + lead + (n,)).movedim(0, -1).contiguous()
        s = s.reshape((2,) + lead + (p,)).movedim(0, -1).contiguous()
        return torch.view_as_complex(y), torch.view_as_complex(s)
    y, s = _iir_rows(x.reshape(-1, n), amat, g, b0, s0.reshape(-1, p))
    return y.reshape(lead + (n,)), s.reshape(lead + (p,))


def iir_apply_sharded(x: torch.Tensor, amat, g, b0, s0: torch.Tensor, axis):
    """Order-p IIR over a time-sharded stream ``x`` [D_local, ..., L]
    (parallel/time.py; ``axis`` the mesh axis).

    Each shard runs from a zero state; its final state is its summary
    v_d, and one all_gather of these p-vectors gives every shard the
    chain s_in(d + 1) = A^L s_in(d) + v_d from s_in(0) = ``s0``, with the
    static A^L built in float64.  Each shard then runs again from its own
    s_in(d).  Returns (y [D_local, ..., L], the global final state
    s_in(D) [..., p], replicated)."""
    amat = np.ascontiguousarray(amat, np.float32)
    p = amat.shape[0]
    lead = x.shape[:-1]
    _, v_last = iir_apply(x, amat, g, b0, x.new_zeros(lead + (p,)))
    all_v = axis.all_gather(v_last)                         # [D, ..., p]
    al = np.linalg.matrix_power(amat.astype(np.float64), x.shape[-1])
    al_t = torch.from_numpy(al.T.astype(np.float32)).to(x.device).to(
        x.dtype)
    s_in = s0.to(x.dtype).expand(all_v.shape[1:])
    s_ins = []
    for d in range(axis.size):                              # D is small
        s_ins.append(s_in)
        with fp32_exact():
            s_in = s_in @ al_t + all_v[d]
    y, _ = iir_apply(x, amat, g, b0, torch.stack(s_ins[axis.lo:axis.hi]))
    return y, s_in


def cumsum_phase(x: torch.Tensor, phase0):
    """Running phase accumulation with wrap-around: phi[n] = phi[n-1] +
    x[n], the carry kept in (-pi, pi] to preserve float32 precision over
    unbounded streams.  Returns (phi [..., N], carry phi[N-1] wrapped)."""
    two_pi = float(np.float32(2 * np.pi))
    phi = torch.cumsum(x, dim=-1) + torch.as_tensor(
        phase0, dtype=x.dtype, device=x.device)[..., None]
    carry = phi[..., -1]
    carry = carry - two_pi * torch.round(carry / two_pi)
    return phi, carry


def cummax_blocked(x: torch.Tensor) -> torch.Tensor:
    """Cumulative max along the last axis (the JAX package's
    cummax_blocked; its two-level blocking works around XLA's log-depth
    cummax on the TPU, which torch.cummax does not need)."""
    return torch.cummax(x, dim=-1).values


__all__ = ["linrec_first_order", "iir_state_space", "iir_apply",
           "iir_apply_sharded",
           "cumsum_phase", "cummax_blocked"]
