"""The PLL ablations S7 (luaradio_tpu_torch/ops/pll_ablate.py) against the
TPU body of scratch/pll_ablate.py, its refusals and its entry point
(benchmarks/pll_ablate.py) on the CPU.

The body (``make_kernel``, loaded by tests/test_torch_window.py's
``load_scratch``) runs through the script's ``run_variant`` pallas_call
(:78-88) with ``interpret=True`` and k = 8: at the script's k = 128 the
interpreter unrolls 128 steps a block and takes minutes.  k does not enter
the function (the carry crosses blocks in scratch), so n <= 256 samples
in blocks of 8 hold the same loop.

Bounds, read off the runs:
* ``no-atan`` and ``bare`` on the script's normal noise: err within 1e-6
  (0 in the runs: the same float32 operations in the same order) and the
  state within 1e-6 (the oscillator's start, cos/sin of the state's
  angle, differs in the last bits between XLA and torch: 2.2e-11);
* ``full`` and ``no-osc`` on a locked noisy tone: atan2f against the
  body's polynomial ``_atan2`` is ~2.7e-7 rad a step, so err within 2e-6
  rad (4.8e-7 in the runs) and the state within 4e-6 (phi_m ~ 2 pi
  carries a few of its 4.8e-7 ulps; 9.5e-7 in the runs).  On pure noise
  one detector output landing on the other side of +-pi would take the
  two loops apart, so the tone keeps the detector away from the cut.
``no-osc`` computes what ``full`` computes in both packages (the body
takes the oscillator branch for every variant but ``bare``,
pll_ablate.py:41 and :48): held bit for bit on each side."""

from functools import partial

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from luaradio_tpu_torch.benchmarks import pll_ablate as bench  # noqa: E402
from luaradio_tpu_torch.ops import cudabuild, pll_ablate  # noqa: E402
from tests.test_torch_window import load_scratch  # noqa: E402

PARAMS = (0.01, 1e-4, -1.0, 1.0, 1.0)
K = 8
NOISE_TOL = 1e-6
TONE_ERR_TOL, TONE_STATE_TOL = 2e-6, 4e-6

_BODY = load_scratch("pll_ablate")


def _tpu(variant, x, state, params=PARAMS, k=K):
    """scratch/pll_ablate.py run_variant's pallas_call, interpreted."""
    n = x.shape[1]
    kernel = partial(_BODY.make_kernel(variant),
                     *(np.float32(p) for p in params), k)
    f = _BODY.pl.pallas_call(
        kernel, grid=(n // k,),
        out_shape=(jax.ShapeDtypeStruct((1, n), jnp.float32),
                   jax.ShapeDtypeStruct((3,), jnp.float32)),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec((2, k), lambda i: (0, i),
                               memory_space=pltpu.SMEM)],
        out_specs=(pl.BlockSpec((1, k), lambda i: (0, i),
                                memory_space=pltpu.SMEM),
                   pl.BlockSpec(memory_space=pltpu.SMEM)),
        scratch_shapes=[pltpu.SMEM((4,), jnp.float32)])
    err, st = f(jnp.asarray(state), jnp.asarray(x))
    return np.asarray(err), np.asarray(st)


def _port(variant, x, state, params=PARAMS):
    err, st = pll_ablate.pll_ablate(torch.from_numpy(x),
                                    torch.from_numpy(state), *params,
                                    variant)
    return err.numpy(), st.numpy()


def _noise(n, seed=0):
    return np.random.default_rng(seed).standard_normal((2, n)).astype(
        np.float32)


def _tone(n, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    z = np.exp(1j * (0.002 * t + 0.3)) + 0.05 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return np.stack([z.real, z.imag]).astype(np.float32)


@pytest.mark.parametrize("variant", ["no-atan", "bare"])
@pytest.mark.parametrize("state", [(0.0, 0.0, 0.0), (0.7, 6.2, 0.3)])
def test_cost_probes_match_the_tpu_body_on_noise(variant, state):
    x, st = _noise(256), np.float32(state)
    je, js = _tpu(variant, x, st)
    pe, ps = _port(variant, x, st)
    assert pe.shape == je.shape == (1, 256) and ps.shape == (3,)
    assert np.max(np.abs(pe - je)) <= NOISE_TOL
    assert np.max(np.abs(ps - js)) <= NOISE_TOL


@pytest.mark.parametrize("variant", ["full", "no-osc"])
def test_loop_matches_the_tpu_body_on_a_locked_tone(variant):
    x, st = _tone(256), np.zeros(3, np.float32)
    je, js = _tpu(variant, x, st)
    pe, ps = _port(variant, x, st)
    assert np.max(np.abs(pe - je)) <= TONE_ERR_TOL
    assert np.max(np.abs(ps - js)) <= TONE_STATE_TOL
    assert np.max(np.abs(pe)) < 1.0        # locked: far from the +-pi cut


def test_no_osc_computes_full_in_both_packages():
    """The reference's fault (ROADMAP queue 3): its docstring removes the
    oscillator, its code keeps it."""
    x, st = _noise(64, 5), np.float32([0.2, 0.0, 0.01])
    jf, jo = _tpu("full", x, st), _tpu("no-osc", x, st)
    assert all(np.array_equal(a, b) for a, b in zip(jf, jo))
    pf, po = _port("full", x, st), _port("no-osc", x, st)
    assert all(np.array_equal(a, b) for a, b in zip(pf, po))


def test_blocks_do_not_enter_the_function():
    """The TPU body at k = 4 and k = 8 gives the same bits: the port has
    no k."""
    x, st = _noise(64, 6), np.zeros(3, np.float32)
    a, b = _tpu("bare", x, st, k=4), _tpu("bare", x, st, k=8)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))


def test_twin_wraps_phi_m_and_clips_freq():
    """Samples 45 degrees ahead of the oscillator drive freq to its clip
    and phi_m past 2 pi every few steps (``bare``: the oscillator, which
    such steps would throw out of its polynomial's range, stands still);
    both sides agree."""
    params = (0.5, 0.5, -0.3, 0.3, 2.0)
    w = _noise(64, 8)
    z = 30 * np.exp(1j * (0.7 + np.pi / 4)) + w[0] + 1j * w[1]
    x = np.stack([z.real, z.imag]).astype(np.float32)
    st = np.float32([0.7, 6.0, 0.0])
    je, js = _tpu("bare", x, st, params)
    pe, ps = _port("bare", x, st, params)
    assert np.max(np.abs(pe - je)) <= NOISE_TOL and (pe > 0).all()
    assert np.max(np.abs(ps - js)) <= NOISE_TOL
    assert ps[2] == np.float32(0.3)
    assert 0 <= ps[1] <= np.float32(2 * np.pi)


@pytest.mark.parametrize("case", ["variant", "float64", "shape", "state",
                                  "non-contiguous", "devices differ",
                                  "meta device"])
def test_wrapper_raises(case):
    x, st = torch.zeros((2, 8)), torch.zeros(3)
    args = {"variant": (x, st, "no-pll"),
            "float64": (x.double(), st, "full"),
            "shape": (torch.zeros((3, 8)), st, "full"),
            "state": (x, torch.zeros(4), "full"),
            "non-contiguous": (torch.zeros((8, 2)).t(), st, "full"),
            "devices differ": (x, torch.zeros(3, device="meta"), "full"),
            "meta device": (torch.zeros((2, 8), device="meta"),
                            torch.zeros(3, device="meta"), "full")}[case]
    with pytest.raises(ValueError):
        pll_ablate.pll_ablate(args[0], args[1], *PARAMS, args[2])


def test_twin_counts_no_launch_and_the_probe_needs_a_card():
    before = pll_ablate.pll_ablate.launches
    pll_ablate.pll_ablate(torch.zeros((2, 4)), torch.zeros(3), *PARAMS)
    assert pll_ablate.pll_ablate.launches == before
    with pytest.raises(ValueError, match="card"):
        pll_ablate.chain_probe(64, "full", *PARAMS, "cpu")


def test_source_is_built_and_bound():
    assert "pll_ablate" in cudabuild.SOURCES
    src = (cudabuild.CSRC / "pll_ablate.cu").read_text()
    for fn in ("lr_pll_ablate", "lr_pll_ablate_chain_probe",
               "lr_error_string"):
        assert f" {fn}(" in src, fn
    assert "atan2f(" in src and "clock64()" in src
    # the polynomial's constants, as the body's np.float32 of each double
    for c in ("1.0 / 362880.0", "1.0 / 40320.0", "-1.0 / 5040.0"):
        assert c in src


def test_entry_point_on_the_cpu_names_its_device():
    lines = []
    rec = bench.run("cpu", n=128, reps=1, emit=lines.append)
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert [ln.split(":")[0].strip() for ln in lines] == \
        ["shipped"] + list(pll_ablate.VARIANTS)
    for key in ("shipped",) + pll_ablate.VARIANTS:
        assert rec[key] > 0
    assert "chain_probe" not in rec                # the card's only


def test_entry_point_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
