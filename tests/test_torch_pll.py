"""The port's PLL against the JAX package on the same numpy inputs: the
sequential kernel's twin (K3, ops/pll.py) against the Pallas kernel in
interpret mode and against the float64 per-sample oracle, the complex
first-order recurrence, the linear and overlap-and-discard tiers, and
PLLBlock chunk by chunk with the tier each package takes.

On the CPU the JAX package's sequential tier is its float-radian lax.scan
(carrier.py _scan) and the port's is K3's twin (int32-turn phases, as the
TPU kernel).  Where tier 3 runs the two differ by that rounding, so those
chunks are held at the float64 oracle's tolerances (err 1e-3, out 5e-2,
state 1e-3 / 1e-5, tests/blocks/test_pll_overlap.py), with err compared
modulo 2 pi: a detector input within the two paths' rounding distance of
+-pi gives err = +pi in one and -pi in the other.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.ops.pll import pll_pallas  # noqa: E402
from luaradio_tpu.ops import pll_linear as jax_pll_linear  # noqa: E402
from luaradio_tpu.ops import pll_overlap as jax_pll_overlap  # noqa: E402
from luaradio_tpu_torch.interop import pll_state_from_jax  # noqa: E402
from luaradio_tpu_torch.ops.pll import (  # noqa: E402
    pll_phase, pll_phase_reference)
from luaradio_tpu_torch.ops.pll_linear import pll_linear  # noqa: E402
from luaradio_tpu_torch.ops.pll_overlap import (  # noqa: E402
    plan_overlap, pll_overlap_discard)
from luaradio_tpu_torch.ops.scan import linrec_first_order  # noqa: E402

# the JAX package's tiers, compiled once (op-by-op dispatch is slow)
jax_plan = jax_pll_overlap.plan_overlap
jax_linear = jax.jit(jax_pll_linear.pll_linear, static_argnums=(2, 3, 4, 5, 6))
jax_overlap = jax.jit(jax_pll_overlap.pll_overlap_discard,
                      static_argnums=(2, 3, 4, 5, 6, 7, 8))

MULTS = (1.0, 2.0, 2.5, 3.0)
CASES = ("noise", "carrier", "zeros+carrier")


def pll_oracle(x, state, alpha, beta, fmin, fmax, mult):
    """The reference loop (pll.lua:138-167) in float64, arg(0) = 0."""
    phi_l, phi_m, freq = [float(s) for s in state]
    out = np.zeros(len(x), np.complex128)
    err = np.zeros(len(x))
    for i, xi in enumerate(x.astype(np.complex128)):
        out[i] = np.exp(1j * phi_m)
        err[i] = np.angle(xi * np.exp(-1j * phi_l)) if xi != 0 else 0.0
        freq += beta * err[i]
        phi_l += freq + alpha * err[i]
        phi_m += freq * mult + alpha * err[i]
        freq = min(max(freq, fmin), fmax)
    return out, err, (phi_l, phi_m, freq)


def _setup(mod, block, rate):
    if mod is tl:
        block.device = torch.device("cpu")
    block.differentiate([mod.ComplexFloat32])
    block.input_rate = rate
    block.initialize()
    return block


def _params(loop=1e3, lo=200e3, hi=220e3, rate=1e6):
    """Loop constants of PLLBlock(loop, lo, hi) at ``rate`` (the JAX
    package's benchmark PLL by default)."""
    blk = _setup(jl, jl.PLLBlock(loop, lo, hi), rate)
    return blk._alpha, blk._beta, blk._freq_min, blk._freq_max


def _case(name, n=512):
    rng = np.random.default_rng(17 + CASES.index(name))
    t = np.arange(n)
    if name == "noise":
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    elif name == "carrier":
        x = 0.7 * np.exp(1j * (2 * np.pi * 0.21 * t + 0.9))
    else:
        x = np.concatenate([np.zeros(128),
                            0.7 * np.exp(1j * 2 * np.pi * 0.21 * t[128:])])
    return x.astype(np.complex64)


def _wrapped(a):
    return np.abs(np.angle(np.exp(1j * np.asarray(a, np.float64))))


def _twin(x, st, alpha, beta, fmin, fmax, mult):
    out, err, ns = pll_phase(torch.from_numpy(x), torch.from_numpy(st),
                             alpha, beta, fmin, fmax, mult)
    return out.numpy(), err.numpy(), ns.numpy()


@pytest.mark.parametrize("mult", MULTS)
@pytest.mark.parametrize("case", CASES)
def test_k3_twin_matches_pallas_interpret(case, mult):
    """Same chain, same float32 rounding: err and the frequency agree
    exactly here (limit 1e-6).  out and phi_m within 2e-5: cos/sin differ
    by an ulp, and for a fractional multiplier XLA's CPU compiler
    contracts the float-radian oscillator chain into FMAs where the twin
    (and the CUDA kernel) round each operation, which moves phi_m by up to
    ~2e-8 rad a sample (1e-5 over these 512 samples)."""
    alpha, beta, fmin, fmax = _params()
    x = _case(case)
    st = np.array([0.3, -0.5, (fmin + fmax) / 2], np.float32)
    xp = jnp.asarray(np.stack([x.real, x.imag]))
    out, err, ns = pll_pallas(xp, jnp.asarray(st), alpha, beta, fmin, fmax,
                              mult, interpret=True)
    got_out, got_err, got_st = _twin(x, st, alpha, beta, fmin, fmax, mult)
    assert np.max(np.abs(got_err - np.asarray(err[0]))) <= 1e-6
    exp_out = np.asarray(out[0]) + 1j * np.asarray(out[1])
    assert np.max(np.abs(got_out - exp_out)) <= 2e-5
    exp_st = np.asarray(ns)
    assert np.max(_wrapped(got_st[:2] - exp_st[:2])) <= 2e-5
    assert abs(got_st[2] - exp_st[2]) <= 1e-6


@pytest.mark.parametrize("mult", MULTS)
@pytest.mark.parametrize("case", CASES)
def test_k3_twin_matches_oracle(case, mult):
    """The twin against the float64 loop at the JAX package's own
    tolerances for its kernel (test_pll_overlap.py:155-198)."""
    alpha, beta, fmin, fmax = _params()
    x = _case(case)
    st = np.array([0.3, -0.5, (fmin + fmax) / 2], np.float32)
    got_out, got_err, got_st = _twin(x, st, alpha, beta, fmin, fmax, mult)
    oo, oe, ost = pll_oracle(x, st, alpha, beta, fmin, fmax, mult)
    assert np.max(np.abs(got_err - oe)) < 1e-3
    assert np.max(np.abs(got_out - oo)) < 5e-2
    assert _wrapped(got_st[0] - ost[0]) < 1e-3
    assert abs(got_st[2] - np.float32(ost[2])) < 1e-5


def test_k3_wrapper_takes_the_twin_only_on_the_cpu():
    alpha, beta, fmin, fmax = _params()
    x = torch.from_numpy(_case("carrier", 300))
    st = torch.tensor([0.1, 0.2, float(fmin)], dtype=torch.float32)
    before = pll_phase.launches
    a = pll_phase(x, st, alpha, beta, fmin, fmax, 2.0)
    b = pll_phase_reference(x, st, alpha, beta, fmin, fmax, 2.0)
    assert pll_phase.launches == before
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="complex64"):
        pll_phase(x.to(torch.complex128), st, alpha, beta, fmin, fmax, 2.0)
    with pytest.raises(ValueError, match="state"):
        pll_phase(x, st[:2], alpha, beta, fmin, fmax, 2.0)


# -- the first-order recurrence ---------------------------------------------

def _linrec_oracle(u, a, y0):
    y, out = complex(y0), np.zeros(len(u), np.complex128)
    for i, ui in enumerate(u.astype(np.complex128)):
        y = complex(a) * y + ui
        out[i] = y
    return out


@pytest.mark.parametrize("n", [100, 128, 300, 1000])
@pytest.mark.parametrize("coef", ["pll_eigenvalue", "rotating"])
def test_linrec_complex_coefficient(n, coef):
    """Complex coefficient, complex64 in and out, against a complex128
    loop: within 1e-5 * scale (the blocks' float32 matmuls)."""
    alpha, beta, _, _ = _params(100.0, 19e3 - 50, 19e3 + 50, 220500.0)
    a = (np.linalg.eigvals(np.array([[1 - alpha - beta, 1.0], [-beta, 1.0]],
                                    np.float64))[0]
         if coef == "pll_eigenvalue" else 0.97 * np.exp(0.3j))
    a = np.complex64(a)
    rng = np.random.default_rng(n)
    u = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    y0 = np.complex64(0.4 - 0.7j)
    got = linrec_first_order(torch.from_numpy(u), a, torch.tensor(y0))
    assert got.dtype == torch.complex64
    exp = _linrec_oracle(u, a, y0)
    scale = max(1.0, np.max(np.abs(exp)))
    assert np.max(np.abs(got.numpy() - exp)) < 1e-5 * scale


@pytest.mark.parametrize("n", [100, 1000])
@pytest.mark.parametrize("a", [0.5, -0.9])
def test_linrec_real_coefficient(n, a):
    """The real path, unchanged: float32 in and out, against a float64
    loop within 1e-5 * scale."""
    rng = np.random.default_rng(n)
    u = rng.standard_normal(n).astype(np.float32)
    got = linrec_first_order(torch.from_numpy(u), a, torch.tensor(0.25))
    assert got.dtype == torch.float32
    exp = _linrec_oracle(u, a, 0.25).real
    scale = max(1.0, np.max(np.abs(exp)))
    assert np.max(np.abs(got.numpy() - exp)) < 1e-5 * scale


# -- the linear and the overlap tiers -----------------------------------------

STEREO = (100.0, 19e3 - 50, 19e3 + 50, 220500.0)


def _linear_input(name, n=4096):
    alpha, beta, fmin, fmax = _params(*STEREO)
    rng = np.random.default_rng(5)
    t = np.arange(n)
    f0 = (fmin + fmax) / 2
    noise = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    if name == "locked":
        x, st = np.exp(1j * (f0 * t + 0.4)) + noise, (0.4, 0.1, f0)
    elif name == "acquisition":
        x, st = np.exp(1j * (f0 * t + 3.09)) + noise, (0.0, 0.0, f0)
    elif name == "railing":
        x, st = np.exp(1j * 0.3 * t) + noise, (0.0, 0.0, f0)
    else:
        x, st = 10 * noise, (0.0, 0.0, f0)
    st = tuple(np.float32(v) for v in st)
    return x.astype(np.complex64), st, (alpha, beta, fmin, fmax)


@pytest.mark.parametrize("name", ["locked", "acquisition", "railing",
                                  "noise"])
def test_pll_linear_matches_jax(name):
    """The valid flags agree; a valid solution agrees within 2e-5 (unit
    phasors, errors in radians, the state)."""
    x, st, (alpha, beta, fmin, fmax) = _linear_input(name)
    jv, jst, jout, jerr = jax_linear(jnp.asarray(x), st, alpha, beta, fmin,
                                     fmax, 2)
    tv, tst, tout, terr = pll_linear(torch.from_numpy(x), st, alpha, beta,
                                     fmin, fmax, 2)
    assert bool(tv) == bool(jv) == (name == "locked")
    if name == "locked":
        assert np.max(np.abs(tout.numpy() - np.asarray(jout))) < 2e-5
        assert np.max(np.abs(terr.numpy() - np.asarray(jerr))) < 2e-5
        for a, b in zip(tst[:2], jst[:2]):
            assert _wrapped(float(a) - float(b)) < 2e-5
        assert abs(float(tst[2]) - float(jst[2])) < 2e-5


@pytest.mark.parametrize("name", ["acquisition", "noise"])
def test_pll_overlap_matches_jax(name):
    """The acquisition and noise chunks of test_pll_overlap.py: the valid
    flags agree (acquisition validates, noise is rejected); the validated
    solution agrees with the JAX one within the oracle tolerance, 2e-2,
    and the frequency within 1e-4."""
    alpha, beta, fmin, fmax = _params()
    rng = np.random.default_rng(17)
    n = 1 << 14
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    if name == "acquisition":
        x = np.exp(1j * (2 * np.pi * 0.21 * np.arange(n) + 0.5)) \
            + 0.3 * noise
    else:
        x = noise
    x = x.astype(np.complex64)
    st = (np.float32(0.3), np.float32(0.1), np.float32((fmin + fmax) / 2))
    plan = plan_overlap(n, float(alpha))
    assert plan == jax_plan(n, float(alpha)) and plan is not None
    jok, jst, jout, jerr = jax_overlap(jnp.asarray(x), st, alpha, beta, fmin,
                                       fmax, 1, *plan)
    tok, tst, tout, terr = pll_overlap_discard(
        torch.from_numpy(x), st, alpha, beta, fmin, fmax, 1, *plan)
    assert bool(tok) == bool(jok) == (name == "acquisition")
    if name == "acquisition":
        assert np.max(np.abs(tout.numpy() - np.asarray(jout))) < 2e-2
        assert np.max(_wrapped(terr.numpy() - np.asarray(jerr))) < 2e-2
        assert abs(float(tst[2]) - float(jst[2])) < 1e-4


def test_plan_overlap_matches_jax():
    for n, a in ((700, 0.2), (1 << 16, 0.0), (1 << 22, 0.0166),
                 (52430, 7.57e-3), (1 << 16, 7.57e-3)):
        assert plan_overlap(n, a) == jax_plan(n, a)
    assert plan_overlap(52430, 7.57e-3) is None   # the stereo graph's chunk


# -- PLLBlock, chunk by chunk -------------------------------------------------

def _jax_tier(blk, state, x, exact):
    """The tier the JAX package's pll_hybrid takes on one chunk, from its
    own functions (its lax.cond does not say)."""
    a, b, lo, hi = blk._alpha, blk._beta, blk._freq_min, blk._freq_max
    mult = blk.multiplier
    if not float(mult).is_integer():
        return 3
    xj = jnp.asarray(x)
    if bool(jax_linear(xj, state, a, b, lo, hi, int(mult))[0]):
        return 1
    plan = None if exact else jax_plan(len(x), float(a))
    if plan is not None:
        c = np.sum(x[1:].astype(np.complex128) * np.conj(x[:-1]))
        p = np.sum(np.abs(x.astype(np.complex128)) ** 2)
        if abs(c) > 0.05 * max(p, 1e-30) and bool(jax_overlap(
                xj, state, a, b, lo, hi, int(mult), *plan)[0]):
            return 2
    return 3


def _block_input(name):
    rng = np.random.default_rng(23)
    if name in ("locked", "noise", "fractional"):
        loop, lo, hi, rate = STEREO
        n, chunks, mult = 3 * 4096, 3, (2.5 if name == "fractional" else 2)
        t = np.arange(n)
        noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        x = (np.exp(1j * (2 * np.pi * 19e3 / rate * t))
             + 0.01 * noise) if name != "noise" else noise
    else:   # a weak carrier acquired from a cold start (test_pll_overlap)
        loop, lo, hi, rate = 1e3, 200e3, 220e3, 1e6
        n, chunks, mult = 2 * 8192, 2, 1
        t = np.arange(n)
        x = 0.4 * np.exp(1j * (2 * np.pi * 0.208 * t + 1.1)) + 0.4 * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64), chunks, (loop, lo, hi, mult, rate)


@pytest.mark.parametrize("name,tiers", [
    ("locked", [1, 1, 1]), ("acquiring", [2, 2]), ("noise", [3, 3, 3]),
    ("fractional", [3, 3, 3])])
def test_pll_block_matches_jax(name, tiers):
    """Both packages take the same tier on every chunk.  Linear chunks
    agree within 2e-5 (unit phasors, radians); overlap and sequential
    chunks at the oracle tolerances (err modulo 2 pi), as the two
    packages' sequential tiers round differently."""
    x, chunks, (loop, lo, hi, mult, rate) = _block_input(name)
    jb = _setup(jl, jl.PLLBlock(loop, lo, hi, multiplier=mult), rate)
    tb = _setup(tl, tl.PLLBlock(loop, lo, hi, multiplier=mult), rate)
    js, ts = jb.init_state(), tb.init_state()
    jax_process = jax.jit(jb.process)
    for c, xc in enumerate(np.split(x, chunks)):
        tier = _jax_tier(jb, js, xc, exact=False)
        before = dict(tb.tier_counts)
        js, (jo, je) = jax_process(js, jnp.asarray(xc))
        ts, (to, te) = tb.process(ts, torch.from_numpy(xc))
        took = [k for k in tb.tier_counts if tb.tier_counts[k] != before[k]]
        assert took == [tier] == [tiers[c]], (c, took, tier)
        d_out = np.max(np.abs(to.numpy() - np.asarray(jo)))
        d_err = np.max(_wrapped(te.numpy() - np.asarray(je)))
        d_ph = _wrapped([float(a) - float(b) for a, b in zip(ts[:2], js[:2])])
        d_f = abs(float(ts[2]) - float(js[2]))
        if tier == 1:
            assert max(d_out, d_err, d_f, *d_ph) < 2e-5, (c, d_out, d_err)
        else:
            assert d_err < 1e-3 and d_out < 5e-2, (c, d_out, d_err)
            assert d_ph[0] < 1e-3 and d_f < 1e-5, (c, d_ph, d_f)


def test_pll_block_exact_runs_the_sequential_kernel():
    """exact=True skips the overlap tier: on the acquiring chunk where the
    default takes tier 2 it takes K3 and equals pll_phase on the whole
    chunk exactly (test_pll_overlap.py:109-132)."""
    x, _, (loop, lo, hi, mult, rate) = _block_input("acquiring")
    x = x[:8192]
    outs = {}
    for exact in (False, True):
        blk = _setup(tl, tl.PLLBlock(loop, lo, hi, exact=exact), rate)
        st, outs[exact] = blk.process(blk.init_state(), torch.from_numpy(x))
        assert blk.tier_counts == ({1: 0, 2: 0, 3: 1} if exact
                                   else {1: 0, 2: 1, 3: 0})
    st0 = torch.stack(list(blk.init_state()))
    out, err, _ = pll_phase(torch.from_numpy(x), st0, blk._alpha, blk._beta,
                            blk._freq_min, blk._freq_max, 1.0)
    assert torch.equal(outs[True][0], out) and torch.equal(outs[True][1], err)


def test_pll_block_on_noise_is_chunk_invariant():
    """Pure noise split at chunk boundaries (test_pll_overlap.py:91-106):
    whole and split runs both track the float64 oracle within 2e-2."""
    blk = _setup(tl, tl.PLLBlock(1e3, 200e3, 220e3), 1e6)
    rng = np.random.default_rng(17)
    n = 8192
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    exp_out, exp_err, _ = pll_oracle(
        x, (0.0, 0.0, (blk._freq_min + blk._freq_max) / 2), blk._alpha,
        blk._beta, blk._freq_min, blk._freq_max, 1.0)
    for splits in ((), (2048, 4096)):
        st, outs, errs = blk.init_state(), [], []
        for xc in np.split(x, splits):
            st, (o, e) = blk.process(st, torch.from_numpy(xc))
            outs.append(o.numpy())
            errs.append(e.numpy())
        assert np.max(np.abs(np.concatenate(outs) - exp_out)) < 2e-2
        assert np.max(np.abs(np.concatenate(errs) - exp_err)) < 2e-2


def test_pll_state_from_jax_resumes_the_stream():
    """A stream started in the JAX package and resumed in the port: the
    JAX state (phases in (-2 pi, 2 pi) from its CPU loop) carried over,
    the next chunk against the JAX package's own next chunk."""
    x, _, (loop, lo, hi, mult, rate) = _block_input("noise")
    jb = _setup(jl, jl.PLLBlock(loop, lo, hi, multiplier=mult), rate)
    tb = _setup(tl, tl.PLLBlock(loop, lo, hi, multiplier=mult), rate)
    jax_process = jax.jit(jb.process)
    js, _ = jax_process(jb.init_state(), jnp.asarray(x[:4096]))
    ts = pll_state_from_jax(js, device="cpu")
    assert all(abs(float(v)) <= np.pi for v in ts[:2])
    _, (jo, je) = jax_process(js, jnp.asarray(x[4096:8192]))
    _, (to, te) = tb.process(ts, torch.from_numpy(x[4096:8192]))
    assert np.max(_wrapped(te.numpy() - np.asarray(je))) < 1e-3
    assert np.max(np.abs(to.numpy() - np.asarray(jo))) < 5e-2
