"""The PLL on a bank of C streams [C, N]: K3 (ops/pll.py) and the overlap
scan (ops/pll_overlap.py) as one launch over the rows, the linear tier
and the three-tier dispatch row by row (ops/pll_linear.py), and PLLBlock
on a bank, against the same functions row by row and against the JAX
package, whose banks vmap the one-stream functions (its channel mesh).

Every row of a bank must give what that row gives alone: K3's twin and
the scan's twin exactly, the dispatch's outputs within 1e-6 (its linear
tier runs batched torch reductions and matmuls, whose rounding may depend
on the batch), with the same tier on every row.  Against the JAX package
the tolerances of tests/test_torch_pll.py hold.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.ops import pll_linear as jax_pll_linear  # noqa: E402
from luaradio_tpu.ops.pll import pll_pallas  # noqa: E402
from luaradio_tpu_torch.interop import pll_state_from_jax  # noqa: E402
from luaradio_tpu_torch.ops.pll import pll_phase  # noqa: E402
from luaradio_tpu_torch.ops.pll_linear import (  # noqa: E402
    pll_hybrid, pll_linear)
from luaradio_tpu_torch.ops.pll_overlap import (  # noqa: E402
    plan_overlap, pll_overlap_discard)
from tests.test_torch_pll import (  # noqa: E402
    _params, _setup, _slow_case, _wrapped)

MULTS = (1.0, 2.0, 3.0, 2.5)
#: the acquisition loop of tests/blocks/test_pll_overlap.py: 1 kHz at
#: 1 MS/s over 200-220 kHz, where an 8192-sample chunk plans 2 segments
ACQ = (1e3, 200e3, 220e3, 1e6)


def _bank(n, seed=3):
    """Three rows: noise, a carrier at 0.21 cycles a sample, and zeros
    then a carrier."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    carrier = 0.7 * np.exp(1j * (2 * np.pi * 0.21 * t + 0.9))
    late = np.where(t < n // 3, 0, carrier * np.exp(0.4j))
    return np.stack([noise, carrier, late]).astype(np.complex64)


# -- K3 -------------------------------------------------------------------

@pytest.mark.parametrize("mult", MULTS)
@pytest.mark.parametrize("n", [1, 511, 1541, 2048])
def test_k3_twin_on_a_bank_equals_each_row(n, mult):
    """K3's twin on [3, N] with state [3, 3] gives each row exactly what
    a one-row call of that row gives."""
    alpha, beta, fmin, fmax = _params()
    x = torch.from_numpy(_bank(n))
    st = torch.tensor([[0.3, -0.5, (fmin + fmax) / 2],
                       [-2.0, 1.0, fmin], [3.0, 3.1, fmax]],
                      dtype=torch.float32)
    out, err, ns = pll_phase(x, st, alpha, beta, fmin, fmax, mult)
    assert out.shape == x.shape and err.shape == x.shape
    assert ns.shape == (3, 3)
    for c in range(3):
        o1, e1, s1 = pll_phase(x[c].contiguous(), st[c].contiguous(), alpha,
                               beta, fmin, fmax, mult)
        assert torch.equal(out[c], o1) and torch.equal(err[c], e1)
        assert torch.equal(ns[c], s1)


@pytest.mark.parametrize("mult", MULTS)
def test_k3_bank_matches_vmapped_pallas_interpret(mult):
    """The bank of the three slow-loop cases of
    test_k3_twin_matches_pallas_interpret_across_blocks (four of the TPU
    kernel's 512-sample blocks) against ``jax.vmap(pll_pallas(...,
    interpret=True))``, the JAX package's banked K3: err and the
    frequency within 1e-6, out and phi_m within 2e-5, as for one row."""
    alpha, beta, fmin, fmax = _params(lo=200, hi=1200)
    x = np.stack([_slow_case(c) for c in ("noise", "slow carrier",
                                          "fast carrier")])
    st = np.array([[0.3, -0.5, (fmin + fmax) / 2]] * 3, np.float32)
    st[1, :2] = (1.5, -2.5)
    xp = jnp.asarray(np.stack([x.real, x.imag], axis=1))       # [3, 2, N]
    out, err, ns = jax.vmap(lambda a, s: pll_pallas(
        a, s, alpha, beta, fmin, fmax, mult, interpret=True))(
            xp, jnp.asarray(st))
    got_out, got_err, got_st = (v.numpy() for v in pll_phase(
        torch.from_numpy(x), torch.from_numpy(st), alpha, beta, fmin, fmax,
        mult))
    assert np.max(np.abs(got_err - np.asarray(err[:, 0]))) <= 1e-6
    exp_out = np.asarray(out[:, 0]) + 1j * np.asarray(out[:, 1])
    assert np.max(np.abs(got_out - exp_out)) <= 2e-5
    exp_st = np.asarray(ns)
    assert np.max(_wrapped(got_st[:, :2] - exp_st[:, :2])) <= 2e-5
    assert np.max(np.abs(got_st[:, 2] - exp_st[:, 2])) <= 1e-6


def test_k3_rejects_a_mismatched_bank_state():
    x = torch.zeros(3, 64, dtype=torch.complex64)
    with pytest.raises(ValueError, match="state"):
        pll_phase(x, torch.zeros(3), 0.1, 0.01, -1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="state"):
        pll_phase(x, torch.zeros(2, 3), 0.1, 0.01, -1.0, 1.0, 1.0)


# -- the overlap scan -----------------------------------------------------

def _acq_bank(n=8192, seed=17):
    """Rows the overlap tier tells apart: a weak carrier acquired from a
    cold start (validates), noise (rejected), and the carrier again at
    another phase."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    noise = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    carrier = np.exp(1j * (2 * np.pi * 0.208 * t + 1.1))
    x = np.stack([0.4 * carrier + 0.4 * noise[0], noise[1],
                  0.4 * carrier * np.exp(2.0j) + 0.3 * noise[2]])
    return x.astype(np.complex64)


@pytest.mark.parametrize("mult", [1.0, 2.0])
def test_overlap_twin_on_a_bank_equals_each_row(mult):
    """One call on [3, N] over all 3 x S segments: the [3] valid flags,
    the outputs and the state leaves each equal a one-row call of that
    row."""
    loop, lo, hi, rate = ACQ
    blk = _setup(tl, tl.PLLBlock(loop, lo, hi), rate)
    a, b, fmin, fmax = blk._alpha, blk._beta, blk._freq_min, blk._freq_max
    x = torch.from_numpy(_acq_bank())
    plan = plan_overlap(x.shape[-1], float(a))
    assert plan is not None
    st = (torch.tensor([0.3, -1.0, 2.0]), torch.tensor([0.1, 0.0, -3.0]),
          torch.full((3,), float((fmin + fmax) / 2)))
    valid, ns, out, err = pll_overlap_discard(x, st, a, b, fmin, fmax, mult,
                                              *plan)
    assert valid.shape == (3,) and out.shape == x.shape
    assert valid.tolist() == [True, False, True]
    for c in range(3):
        v1, s1, o1, e1 = pll_overlap_discard(
            x[c].contiguous(), tuple(v[c] for v in st), a, b, fmin, fmax,
            mult, *plan)
        assert bool(v1) == bool(valid[c])
        assert torch.equal(out[c], o1) and torch.equal(err[c], e1)
        assert all(torch.equal(u[c], w) for u, w in zip(ns, s1))


@pytest.mark.parametrize("mult", [1.0, 2.0])
def test_overlap_batched_setup_matches_each_row(mult):
    """The set-up, boundary check and chaining the kernel's path runs on
    the whole bank (ops/pll_overlap.py _run, here around the plain scan)
    against the twin row by row: the same [3] valid flags, outputs and
    state within 1e-6 (the CPU's vector and scalar complex products may
    part by an ulp; on the card each element rounds alike)."""
    from luaradio_tpu_torch.ops import pll_overlap
    loop, lo, hi, rate = ACQ
    blk = _setup(tl, tl.PLLBlock(loop, lo, hi), rate)
    a, b, fmin, fmax = blk._alpha, blk._beta, blk._freq_min, blk._freq_max
    x = torch.from_numpy(_acq_bank(seed=19))
    plan = plan_overlap(x.shape[-1], float(a))
    st = (torch.tensor([0.3, -1.0, 2.0]), torch.tensor([0.1, 0.0, -3.0]),
          torch.full((3,), float((fmin + fmax) / 2)))
    got = pll_overlap._run(pll_overlap._scan_reference, x, st, a, b, fmin,
                           fmax, mult, *plan, 0.02, 0.005)
    exp = pll_overlap_discard(x, st, a, b, fmin, fmax, mult, *plan)
    assert torch.equal(got[0], exp[0]) and got[0].tolist() == [True, False,
                                                               True]
    assert torch.max(torch.abs(got[2] - exp[2])) <= 1e-6
    assert torch.max(torch.abs(got[3] - exp[3])) <= 1e-6
    assert max(float(torch.max(torch.abs(u - w)))
               for u, w in zip(got[1], exp[1])) <= 1e-6


# -- the linear tier and the dispatch -------------------------------------

def _mixed_bank(n=8192):
    """Rows of the dispatch test: a carrier the loop has locked onto
    (linear tier), a weak carrier from a cold start (overlap tier), noise
    and zeros (the coherence gate fails: sequential tier), with each row's
    state."""
    loop, lo, hi, rate = ACQ
    blk = _setup(tl, tl.PLLBlock(loop, lo, hi), rate)
    rng = np.random.default_rng(41)
    t = np.arange(n)
    w = 2 * np.pi * 0.208
    noise = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    x = np.stack([np.exp(1j * (w * t + 0.4)) + 0.01 * noise[0],
                  0.4 * np.exp(1j * (w * t + 1.1)) + 0.4 * noise[1],
                  noise[2], np.zeros(n)]).astype(np.complex64)
    f0 = float((blk._freq_min + blk._freq_max) / 2)
    st = (torch.tensor([0.4, 0.0, 0.0, 0.0]),
          torch.tensor([0.4, 0.0, 0.0, 0.0]),
          torch.tensor([float(np.float32(w)), f0, f0, f0]))
    return blk, x, st


def test_pll_hybrid_on_a_bank_takes_each_rows_tier():
    """pll_hybrid on the four mixed rows: each row takes the tier it takes
    alone (linear, overlap, sequential, sequential), its outputs and state
    agree with the one-row call within 1e-6, K3 runs once on the two
    unsolved rows together, and the bank reads the host no more often
    than one row does."""
    blk, x, st = _mixed_bank()
    args = (blk._alpha, blk._beta, blk._freq_min, blk._freq_max, 1)
    seq_rows = []

    def sequential(state, xs):
        seq_rows.append(tuple(xs.shape))
        return blk._sequential(state, xs)

    rows, reads = [], pll_hybrid.host_reads
    ns, (out, err) = pll_hybrid(torch.from_numpy(x), st, *args, sequential,
                                row_tiers=rows)
    bank_reads = pll_hybrid.host_reads - reads
    assert rows == [1, 2, 3, 3]
    assert seq_rows == [(2, x.shape[1])]
    row_tiers, row_reads = [], []
    for c in range(4):
        one, reads = [], pll_hybrid.host_reads
        s1, (o1, e1) = pll_hybrid(torch.from_numpy(x[c].copy()),
                                  tuple(v[c] for v in st), *args,
                                  blk._sequential, row_tiers=one)
        row_reads.append(pll_hybrid.host_reads - reads)
        row_tiers.append(one)
        assert o1.shape == (x.shape[1],) and s1[0].dim() == 0
        assert torch.max(torch.abs(out[c] - o1)) <= 1e-6
        assert torch.max(torch.abs(err[c] - e1)) <= 1e-6
        assert max(abs(float(u[c]) - float(w)) for u, w in zip(ns, s1)) \
            <= 1e-6
    assert row_tiers == [[1], [2], [3], [3]]
    assert bank_reads <= max(row_reads) <= 2


def test_pll_linear_valid_on_a_bank_matches_jax_chunk_by_chunk():
    """The stereo pilot loop on three rows (a pilot, noise then the
    pilot, the pilot at another phase) over four chunks: the linear
    tier's [3] valid flags equal ``jax.vmap`` of the JAX package's
    pll_linear on every chunk, each package carrying its own banked
    PLLBlock state from chunk to chunk."""
    loop, lo, hi, rate, n = 100.0, 19e3 - 50, 19e3 + 50, 220500.0, 4096
    jb = _setup(jl, jl.PLLBlock(loop, lo, hi, multiplier=2), rate)
    tb = _setup(tl, tl.PLLBlock(loop, lo, hi, multiplier=2), rate)
    rng = np.random.default_rng(8)
    t = np.arange(4 * n)
    pilot = np.exp(1j * 2 * np.pi * 19e3 / rate * t)
    noise = 0.01 * (rng.standard_normal((3, 4 * n))
                    + 1j * rng.standard_normal((3, 4 * n)))
    x = np.stack([pilot + noise[0],
                  np.where(t < n, 100 * noise[1], pilot + noise[1]),
                  pilot * np.exp(2.5j) + noise[2]]).astype(np.complex64)
    args = (jb._alpha, jb._beta, jb._freq_min, jb._freq_max, 2)
    jax_valid = jax.jit(jax.vmap(
        lambda xr, s: jax_pll_linear.pll_linear(xr, s, *args)[0]))
    jax_step = jax.jit(jax.vmap(jb.process))
    js = jax.tree.map(lambda v: jnp.broadcast_to(v, (3,)), jb.init_state())
    ts = tuple(v.expand(3).clone() for v in tb.init_state())
    flags = []
    for k in range(4):
        xc = x[:, k * n:(k + 1) * n]
        jv = np.asarray(jax_valid(jnp.asarray(xc), js)).tolist()
        tv = pll_linear(torch.from_numpy(xc), ts, *args)[0].tolist()
        flags.append((jv, tv))
        js, _ = jax_step(js, jnp.asarray(xc))
        ts, _ = tb.process(ts, torch.from_numpy(xc))
    parted = [k for k, (a, b) in enumerate(flags) if a != b]
    assert not parted, f"valid flags part on chunks {parted}: {flags}"
    assert flags[0][1][1] is False and flags[-1][1] == [True] * 3


# -- PLLBlock on a bank ---------------------------------------------------

def _collect(mod, t):
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature([mod.Input("in", t)], [])

        def process(self, x):
            self.got.append(np.array(x))
    return Collect()


def _array_source(mod, data, rate):
    class ArraySource(mod.HostSourceBlock):
        def __init__(self):
            super().__init__()
            self.rate, self.pos = rate, 0
            self.add_type_signature(
                [], [mod.Output("out", mod.ComplexFloat32)])

        def read(self, n):
            if self.pos >= len(data):
                return None
            chunk = data[self.pos:self.pos + n]
            self.pos += len(chunk)
            return chunk
    return ArraySource()


def _pll_bank_run(mod, x, chunk, **kw):
    """BankSource of the rows of x -> PLLBlock (acquisition loop) ->
    sinks on out and error; returns ([C, N] out, [C, N] err, the block)."""
    loop, lo, hi, rate = ACQ
    top = mod.CompositeBlock()
    pll = mod.PLLBlock(loop, lo, hi)
    so, se = _collect(mod, mod.ComplexFloat32), _collect(mod, mod.Float32)
    top.connect(mod.BankSource([_array_source(mod, r, rate) for r in x]),
                pll)
    top.connect(pll, "out", so, "in")
    top.connect(pll, "error", se, "in")
    top.run(chunk_size=chunk, **kw)
    return (np.concatenate(so.got, axis=-1), np.concatenate(se.got, axis=-1),
            pll)


def test_pll_block_bank_matches_jax_channel_mesh():
    """run(channels=3) of BankSource -> PLLBlock against the JAX package's
    run on a one-device channel mesh (its vmapped block) over two chunks:
    every row at the oracle tolerances of test_pll_block_matches_jax (the
    sequential tiers round differently), and the port's rows against its
    own one-stream runs within 1e-6."""
    x = _acq_bank(2 * 8192, seed=5)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("channel",))
    jo, je, _ = _pll_bank_run(jl, x, 8192, mesh=mesh, channels=3)
    to, te, pll = _pll_bank_run(tl, x, 8192, device="cpu", channels=3)
    assert to.shape == x.shape == jo.shape
    assert np.max(_wrapped(te - je)) < 1e-3
    assert np.max(np.abs(to - jo)) < 5e-2
    assert sum(pll.tier_counts.values()) == 6
    for c in range(3):
        o1, e1, _ = _pll_bank_run(tl, x[c:c + 1], 8192, device="cpu")
        assert np.max(np.abs(to[c] - o1[0])) <= 1e-6
        assert np.max(np.abs(te[c] - e1[0])) <= 1e-6


def test_pll_block_on_a_channelizer_batch_runs_each_row():
    """ChannelizerBlock -> PLLBlock: the batch [4, N/4] runs row by row,
    each row what PLLBlock gives on that row alone (the JAX block fails
    on such a batch: its scan runs over axis 0)."""
    rng = np.random.default_rng(2)
    n, rate = 4 * 8192, 4e6
    t = np.arange(n)
    x = (np.exp(1j * 2 * np.pi * (1e6 + 208e3) / rate * t)
         + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    top = tl.CompositeBlock()
    chan = tl.ChannelizerBlock(4, taps_per_branch=8)
    pll = tl.PLLBlock(*ACQ[:3])
    tap, so = _collect(tl, tl.ComplexFloat32), _collect(tl, tl.ComplexFloat32)
    top.connect(_array_source(tl, x, rate), chan, pll)
    top.connect(chan, "out", tap, "in")
    top.connect(pll, "out", so, "in")
    top.run(chunk_size=n // 2, device="cpu")
    rows, got = (np.concatenate(s.got, axis=-1) for s in (tap, so))
    assert got.shape == rows.shape == (4, n // 4)
    blk = _setup(tl, tl.PLLBlock(*ACQ[:3]), rate / 4)
    for c in range(4):
        st, outs = blk.init_state(), []
        for xc in np.split(rows[c], 2):
            st, (o, _) = blk.process(st, torch.from_numpy(xc.copy()))
            outs.append(o.numpy())
        assert np.max(np.abs(np.concatenate(outs) - got[c])) <= 1e-6


def test_pll_state_from_jax_takes_a_bank():
    """The banked form of PLLBlock's state: [C] leaves, phases wrapped to
    [-pi, pi]."""
    js = (np.array([7.0, -7.0, 0.5], np.float32),
          np.array([-6.0, 1.0, 6.5], np.float32),
          np.array([0.1, 0.2, 0.3], np.float32))
    ts = pll_state_from_jax(js, device="cpu")
    assert [v.shape for v in ts] == [(3,)] * 3
    assert all(float(v.abs().max()) <= np.pi for v in ts[:2])
    assert np.allclose(_wrapped(ts[0].numpy() - js[0]), 0, atol=1e-6)
    assert np.array_equal(ts[2].numpy(), js[2])


def test_pll_block_flattens_more_leading_axes():
    """A bank of channelizer batches [2, 2, N] (the JAX package vmaps
    over any leading axes) runs as the four rows [4, N], state leaves
    [2, 2]."""
    blk = _setup(tl, tl.PLLBlock(*ACQ[:3]), ACQ[3])
    x = torch.from_numpy(np.concatenate([_acq_bank(4096), _acq_bank(
        4096, seed=3)[:1]]))
    st = tuple(v.expand(4).clone() for v in blk.init_state())
    flat_st, (flat_o, flat_e) = blk.process(st, x)
    st4 = tuple(v.reshape(2, 2) for v in st)
    ns, (o, e) = blk.process(st4, x.reshape(2, 2, -1))
    assert o.shape == (2, 2, 4096) and ns[0].shape == (2, 2)
    assert torch.equal(o.reshape(4, -1), flat_o)
    assert torch.equal(e.reshape(4, -1), flat_e)
    assert all(torch.equal(u.reshape(4), w) for u, w in zip(ns, flat_st))
    assert blk.row_tiers and len(blk.row_tiers) == 4
