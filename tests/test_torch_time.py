"""The port's time-sharding helpers (luaradio_tpu_torch/parallel/time.py,
ops/scan.py ``iir_apply_sharded``) against the JAX package's under
``shard_map`` on the 8-device CPU mesh (tests/conftest.py), for D = 2, 4
and 8 shards, on the same numpy-seeded inputs; and the port's mesh
(parallel/mesh.py) itself.

Each case is held at the bound of the JAX package's own test of that
helper (tests/parallel/test_parallel.py: the FIR 1e-4, the FFT FIR 1e-3,
the discriminator 1e-5, the first-order recurrence and the cumulative sum
1e-3; tests/parallel/test_pll_sharded.py: the sharded PLL 2e-3), times
max(1, the reference's peak magnitude).  Halos, delays and the cumulative
max move samples without arithmetic: those are equal bit for bit.  The
order-p IIR has no sharded test of its own in the JAX package; it is held
at the 1e-3 of its IIR block test (tests/blocks/test_filtering.py:97).
"""

import numpy as np
import pytest
import scipy.signal
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from luaradio_tpu.ops import scan as jscan  # noqa: E402
from luaradio_tpu.parallel import time as jtime  # noqa: E402
from luaradio_tpu_torch.ops import fir as tfir  # noqa: E402
from luaradio_tpu_torch.ops import scan as tscan  # noqa: E402
from luaradio_tpu_torch.parallel import time as ttime  # noqa: E402
from luaradio_tpu_torch.parallel.mesh import (  # noqa: E402
    Axis, Mesh, join_shards, split_shards)

DS = [2, 4, 8]
C, L_SHARD = 2, 512           # rows, samples per shard
RNG = np.random.default_rng(71)


def _noise(n, cplx=True, c=C):
    x = RNG.standard_normal((c, n))
    if cplx:
        x = x + 1j * RNG.standard_normal((c, n))
    return x.astype(np.complex64 if cplx else np.float32)


def _run_jax(fn, d, ins, kinds, out_kinds):
    """fn(*ins, "time") under shard_map over d CPU devices; ``kinds`` and
    ``out_kinds`` say for each input and output whether it is sharded on
    its last axis ("s") or replicated ("r")."""
    mesh = JaxMesh(np.asarray(jax.devices("cpu")[:d]), ("time",))

    def spec(k, rank):
        return P(*([None] * (rank - 1)), "time") if k == "s" else P()
    in_specs = tuple(spec(k, np.ndim(a)) for k, a in zip(kinds, ins))
    out_specs = tuple(spec(k, 2) for k in out_kinds)
    f = shard_map(lambda *a: fn(*a, "time"), mesh=mesh, in_specs=in_specs,
                  out_specs=out_specs if len(out_specs) > 1
                  else out_specs[0], check_vma=False)
    out = jax.jit(f)(*[jnp.asarray(a) for a in ins])
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in out]


def _run_port(fn, d, ins, kinds, out_kinds):
    ax = Axis("time", d)
    args = [split_shards(torch.from_numpy(np.ascontiguousarray(a)), d)
            if k == "s" else torch.from_numpy(np.asarray(a))
            for k, a in zip(kinds, ins)]
    out = fn(*args, ax)
    out = out if isinstance(out, tuple) else (out,)
    return [(join_shards(o) if k == "s" else o).numpy()
            for o, k in zip(out, out_kinds)]


def _compare(jfn, tfn, d, ins, kinds, out_kinds, tol):
    exp = _run_jax(jfn, d, ins, kinds, out_kinds)
    got = _run_port(tfn, d, ins, kinds, out_kinds)
    for g, e in zip(got, exp):
        # JAX's replicated output keeps one shard's leading axes
        e = e.reshape(g.shape) if e.size == g.size else e
        assert g.shape == e.shape, (g.shape, e.shape)
        if tol == 0:
            assert np.array_equal(g, e)
        else:
            scale = max(1.0, float(np.max(np.abs(e))))
            assert float(np.max(np.abs(g.astype(np.complex128) - e))) \
                < tol * scale


# -- halos, FIRs, the discriminator -------------------------------------------

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("ring", [False, True])
def test_halos_equal_jax(d, ring):
    x = _noise(d * L_SHARD)
    jfn = jtime.ring_halo if ring else jtime.left_halo
    tfn = ttime.ring_halo if ring else ttime.left_halo
    _compare(lambda a, ax: jfn(a, 7, ax), lambda a, ax: tfn(a, 7, ax), d,
             [x], "s", "s", 0)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("with_tail", [False, True])
def test_fir_sharded_matches_jax(d, with_tail):
    taps = RNG.standard_normal(33).astype(np.float32)
    x = _noise(d * L_SHARD)
    tail = _noise(32)
    jt, tt = jnp.asarray(taps), torch.from_numpy(taps)
    if with_tail:
        _compare(lambda a, t, ax: jtime.fir_sharded(a, jt, ax, tail=t),
                 lambda a, t, ax: ttime.fir_sharded(a, tt, ax, tail=t),
                 d, [x, tail], "sr", "s", 1e-4)
    else:
        _compare(lambda a, ax: jtime.fir_sharded(a, jt, ax),
                 lambda a, ax: ttime.fir_sharded(a, tt, ax), d, [x], "s",
                 "s", 1e-4)


@pytest.mark.parametrize("d", DS)
def test_fir_fft_sharded_matches_jax(d):
    from luaradio_tpu.ops import fir as jfir
    taps = RNG.standard_normal(129).astype(np.float32)
    l = tfir.fft_frame_length(129, min_l=512)
    hf = tfir.fir_fft_freq_taps(taps, l, False)
    assert np.array_equal(hf, jfir.fir_fft_freq_taps(taps, l, False))
    x = _noise(8 * l * 2)
    tail = _noise(l)
    jh, th = jnp.asarray(hf), torch.from_numpy(hf)
    _compare(lambda a, t, ax: jtime.fir_fft_sharded(a, jh, l, ax, False,
                                                    tail=t),
             lambda a, t, ax: ttime.fir_fft_sharded(a, th, l, ax, False,
                                                    tail=t),
             d, [x, tail], "sr", "s", 1e-3)


@pytest.mark.parametrize("d", DS)
def test_discriminator_sharded_matches_jax(d):
    x = _noise(d * L_SHARD)
    _compare(lambda a, ax: jtime.discriminator_sharded(a, 1.25, ax),
             lambda a, ax: ttime.discriminator_sharded(a, 1.25, ax), d,
             [x], "s", "s", 1e-5)


@pytest.mark.parametrize("d", DS)
def test_delay_and_pilot_recovery_sharded_match_jax(d):
    x = _noise(d * L_SHARD)
    carry = _noise(5)
    _compare(lambda a, cr, ax: jtime.delay_sharded(a, 5, ax, carry=cr),
             lambda a, cr, ax: ttime.delay_sharded(a, 5, ax, carry=cr),
             d, [x, carry], "sr", "s", 0)
    from luaradio_tpu.ops.complexutil import const_complex
    taps = (RNG.standard_normal(129)
            + 1j * RNG.standard_normal(129)).astype(np.complex64) / 20
    tail = _noise(128)
    jt, tt = const_complex(taps), torch.from_numpy(taps)
    _compare(lambda a, t, ax: jtime.pilot_recovery_sharded(a, jt, 2, ax,
                                                           tail=t),
             lambda a, t, ax: ttime.pilot_recovery_sharded(a, tt, 2, ax,
                                                           tail=t),
             d, [x, tail], "sr", "s", 1e-4)


# -- distributed prefixes -----------------------------------------------------

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("coef", ["real", "complex", "per_sample"])
def test_linrec_first_order_sharded_matches_jax(d, coef):
    """y and the global final value (with_final) against the JAX helper,
    and y against scipy's lfilter for the real coefficient (the JAX
    test's own oracle) at the same 1e-3."""
    n = d * L_SHARD
    y0 = RNG.standard_normal(C).astype(np.float32)
    if coef == "real":
        u, a, kinds = _noise(n, cplx=False), np.float32(0.97), "sr"
        ins = [u, y0]
    elif coef == "complex":
        u = _noise(n)
        a = np.complex64(0.95 * np.exp(0.3j))
        y0 = (y0 + 1j * y0[::-1]).astype(np.complex64)
        kinds, ins = "sr", [u, y0]
    else:
        u = _noise(n, cplx=False)
        a = np.where(RNG.uniform(size=(C, n)) < 0.5, 0.99, 1.0).astype(
            np.float32)
        kinds, ins = "srs", [u, y0, a]

    def jfn(uu, yy, *rest):
        aa = rest[0] if coef == "per_sample" else a
        return jtime.linrec_first_order_sharded(uu, aa, yy, rest[-1],
                                                with_final=True)

    def tfn(uu, yy, *rest):
        aa = rest[0] if coef == "per_sample" else a
        return ttime.linrec_first_order_sharded(uu, aa, yy, rest[-1],
                                                with_final=True)
    _compare(jfn, tfn, d, ins, kinds, "sr", 1e-3)
    if coef == "real":
        y, _ = _run_port(tfn, d, ins, kinds, "sr")
        exp = np.stack([scipy.signal.lfilter(
            [1.0], [1.0, -0.97], u[c].astype(np.float64),
            zi=[0.97 * float(y0[c])])[0] for c in range(C)])
        assert np.max(np.abs(y - exp)) < 1e-3 * max(1.0, np.abs(exp).max())


@pytest.mark.parametrize("d", DS)
def test_cumsum_and_cummax_sharded_match_jax(d):
    x = _noise(d * L_SHARD, cplx=False)
    _compare(lambda a, ax: jtime.cumsum_sharded(a, ax, with_total=True),
             lambda a, ax: ttime.cumsum_sharded(a, ax, with_total=True),
             d, [x], "s", "sr", 1e-3)
    idx = np.where(RNG.uniform(size=x.shape) < 0.01,
                   np.arange(x.shape[-1], dtype=np.float32), -1.0)
    _compare(jtime.cummax_sharded, ttime.cummax_sharded, d,
             [idx.astype(np.float32)], "s", "s", 0)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("cplx", [False, True])
def test_iir_apply_sharded_matches_jax(d, order, cplx):
    """Outputs and the global final state against the JAX helper, and the
    outputs against the port's serial order-p scan."""
    b, a = scipy.signal.butter(order, 0.2)
    amat, g, b0 = tscan.iir_state_space(b, a)
    x = _noise(d * L_SHARD, cplx=cplx)
    s0 = _noise(order, cplx=cplx) * np.float32(0.1)
    jg = jnp.asarray(g)
    _compare(lambda xx, ss, ax: jscan.iir_apply_sharded(xx, amat, jg, b0,
                                                        ss, ax),
             lambda xx, ss, ax: tscan.iir_apply_sharded(xx, amat, g, b0,
                                                        ss, ax),
             d, [x, s0], "sr", "sr", 1e-3)
    y, s = _run_port(lambda xx, ss, ax: tscan.iir_apply_sharded(
        xx, amat, g, b0, ss, ax), d, [x, s0], "sr", "sr")
    ys, ss = tscan.iir_apply(torch.from_numpy(x), amat, g, b0,
                             torch.from_numpy(s0))
    scale = max(1.0, float(np.abs(ys.numpy()).max()))
    assert np.max(np.abs(y - ys.numpy())) < 1e-3 * scale
    assert np.max(np.abs(s - ss.numpy())) < 1e-3 * scale


# -- the sharded linear PLL (tests/parallel/test_pll_sharded.py) --------------

ALPHA, BETA = 0.05, 0.002
FMIN, FMAX = np.float32(0.10), np.float32(0.22)
W0 = 0.16


def _pll(mod, mult):
    def fn(x, p, m, f, ax):
        valid, st, out, err = mod.pll_linear_sharded(
            x, (p, m, f), ALPHA, BETA, FMIN, FMAX, mult, ax)
        return (valid * 1.0, *st, out, err)      # the flag as 0.0 / 1.0
    return fn


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("locked", [True, False])
def test_pll_linear_sharded_matches_jax(d, locked):
    """A locked tone (multiplier 3): valid, the state, the output and the
    error against the JAX helper within 2e-3; a tone above fmax: both
    reject it (valid False on every row)."""
    n = d * L_SHARD
    if locked:
        ph = (2 * np.pi * RNG.uniform(size=(C, 1))).astype(np.float32)
        x = np.exp(1j * (W0 * np.arange(n)[None, :] + ph))
        x += 0.01 * (RNG.standard_normal((C, n))
                     + 1j * RNG.standard_normal((C, n)))
        st = [ph[:, 0], ph[:, 0], np.full(C, W0, np.float32)]
        mult = 3
    else:
        x = np.exp(1j * 0.5 * np.arange(n))[None, :].repeat(C, 0)
        st = [np.zeros(C, np.float32), np.zeros(C, np.float32),
              np.full(C, W0, np.float32)]
        mult = 1
    x = x.astype(np.complex64)
    ins = [x] + [s.astype(np.float32) for s in st]
    exp = _run_jax(_pll(jtime, mult), d, ins, "srrr", "rrrrss")
    got = _run_port(_pll(ttime, mult), d, ins, "srrr", "rrrrss")
    assert np.array_equal(got[0].reshape(-1) > 0, exp[0].reshape(-1) > 0)
    assert bool(np.all(got[0] > 0)) is locked
    if locked:
        for g, e in zip(got[1:], exp[1:]):
            e = e.reshape(g.shape)
            assert np.max(np.abs(g.astype(np.complex128) - e)) < 2e-3


# -- the mesh -----------------------------------------------------------------

def test_mesh_axes_and_local_ranges():
    mesh = Mesh((2, 4), ("channel", "time"))
    assert mesh.shape == {"channel": 2, "time": 4}
    assert not mesh.multihost and mesh.local_range("time") == (0, 4)
    ax = mesh.axis("time")
    assert (ax.size, ax.lo, ax.hi, ax.n_local, ax.group) == (4, 0, 4, 4,
                                                             None)
    with pytest.raises(ValueError, match="does not match"):
        Mesh((2, 4), ("time",))
    with pytest.raises(ValueError, match="repeated"):
        Mesh((2, 2), ("time", "time"))


def test_split_join_and_the_first_shard():
    x = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)
    s = split_shards(x, 3)
    assert s.shape == (3, 2, 4) and torch.equal(s[1], x[:, 4:8])
    assert torch.equal(join_shards(s), x)
    ax = Axis("time", 3)
    first = ax.at_first(ax.left_halo(s, 2), torch.tensor([-1.0, -2.0])
                        [:, None])
    assert torch.equal(first[0], torch.tensor([[-1.0, -1.0],
                                               [-2.0, -2.0]]))
    assert torch.equal(first[2], x[:, 6:8])
    halo, tail = ax.halo_and_tail(s, 3)
    assert torch.equal(tail, x[:, -3:]) and torch.equal(halo[0],
                                                        torch.zeros(2, 3))
    assert torch.equal(ax.ring_halo(s, 3)[0], x[:, -3:])
    # an axis not holding shard 0 leaves its first entry as it is
    later = Axis("time", 6, lo=3, hi=6)
    assert torch.equal(later.at_first(s, 0.0), s)
    # the reductions over the shards, and the last shard's value
    v = torch.tensor([[1.0, -4.0], [3.0, 2.0], [-2.0, 5.0]])
    assert torch.equal(ax.psum(v), torch.tensor([2.0, 3.0]))
    assert torch.equal(ax.pmin(v), torch.tensor([-2.0, -4.0]))
    assert torch.equal(ax.pmax(v), torch.tensor([3.0, 5.0]))
    assert torch.equal(ax.last(v), v[-1]) and torch.equal(
        ax.index(), torch.arange(3))


def test_helpers_on_one_shard_equal_the_serial_ops():
    """A one-shard axis is the serial path: the sharded FIR with its tail
    is fir_direct, the sharded recurrence linrec_first_order."""
    x = torch.from_numpy(_noise(4096))
    taps = torch.from_numpy(RNG.standard_normal(17).astype(np.float32))
    tail = torch.from_numpy(_noise(16))
    ax = Axis("time", 1)
    y = join_shards(ttime.fir_sharded(split_shards(x, 1), taps, ax,
                                      tail=tail))
    assert torch.allclose(y, tfir.fir_direct(x, taps, tail)[0], atol=1e-6)
    u = x.real.contiguous()
    y0 = torch.tensor([0.5, -0.25])
    y, fin = ttime.linrec_first_order_sharded(split_shards(u, 1), 0.9, y0,
                                              ax, with_final=True)
    ref = tscan.linrec_first_order(u, 0.9, y0)
    assert torch.allclose(join_shards(y), ref, atol=1e-5)
    assert torch.allclose(fin, ref[..., -1], atol=1e-5)


def test_linrec_keeps_real_and_complex_coefficients_apart():
    """A complex coefficient with no imaginary part, then the equal real
    one (the sharded deemphasis after the PLL's real eigenvalue on the
    card): each gets matrices of its own type from ops/scan.py's cache,
    and the real run equals a fresh real run."""
    u = torch.from_numpy(_noise(1 << 16, cplx=False))
    y0 = torch.zeros(C)
    tscan.linrec_first_order(u.to(torch.complex64), complex(0.875, 0.0), y0)
    y = tscan.linrec_first_order(u, 0.875, y0)
    assert y.dtype == torch.float32
    tscan._powers.cache_clear()
    assert torch.equal(y, tscan.linrec_first_order(u, 0.875, y0))
