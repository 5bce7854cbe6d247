"""The digital receiver composites of the port against the JAX package:
RDSReceiver (PLL and vector pilot), POCSAGReceiver, AX25Receiver,
ERTReceiver and BPSK31Receiver, each in a graph on the synthesizer of
tests/core/test_receivers.py, where the decoded objects must equal the
JAX package's (their JSON forms, field by field) and the JAX test's own
assertions must hold for the port.

RDS also runs on a capture that starts with 0.5 s of noise (a receiver
tuned before the station comes up) at 275 625 S/s, the IF rate of
rx_rds on a 1 102 500 S/s input, in chunks of 65 536 (what rx_rds's
default chunk gives its PLL there).  Its pilot loop is PLLBlock(1500,
19e3 +- 100, multiplier 3), 15x the stereo pilot's bandwidth: on that
capture the port's linear-tier guard (the ``valid`` flag of pll_linear)
must equal the JAX package's on every chunk, each package carrying its
own state, and the sequential kernel's twin (K3) must equal the TPU
kernel in interpret mode at those constants across its 512-sample grid
blocks (1e-6, as tests/test_torch_pll.py).
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.ops import pll_linear as jax_pll_linear  # noqa: E402
from luaradio_tpu.ops.pll import pll_pallas  # noqa: E402
from luaradio_tpu_torch.ops.pll import pll_phase  # noqa: E402
from luaradio_tpu_torch.ops.pll_linear import pll_linear  # noqa: E402
from tests.blocks.test_protocol import rds_encode_group  # noqa: E402
from tests.core.test_receivers import (make_ax25_iq,  # noqa: E402
                                       make_bpsk31_iq, make_pocsag_iq,
                                       make_scm_iq, manchester_diff_encode)

jax_linear = jax.jit(jax_pll_linear.pll_linear,
                     static_argnums=(2, 3, 4, 5, 6))

RDS_IF = 1102500 / 4          # rx_rds's IF rate on a 1 102 500 S/s input
RDS_CHUNK = 1 << 16
RDS_PLL = (1500.0, 19e3 - 100, 19e3 + 100, 3.0)


def _source(mod, data, rate):
    class ArraySource(mod.HostSourceBlock):
        def __init__(self):
            super().__init__()
            self.rate = rate
            self.pos = 0
            self.add_type_signature([], [mod.Output("out",
                                                    mod.ComplexFloat32)])

        def read(self, n):
            if self.pos >= len(data):
                return None
            chunk = data[self.pos:self.pos + n]
            self.pos += len(chunk)
            return chunk
    return ArraySource()


def _collector(mod):
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.items = []
            self.add_type_signature([mod.Input("in", lambda t: True)], [])

        def process(self, x):
            if isinstance(x, (list, tuple)):
                self.items.extend(x)
            else:
                self.items.extend(np.asarray(x).reshape(-1).tolist())
    return Collect()


def _receive(mod, make, iq, rate, chunk, out="out", taps=()):
    """iq -> the receiver ``make(mod)`` -> sink, on the CPU for the port.
    Returns (decoded items, the receiver, {type name: tapped stream})."""
    top = mod.CompositeBlock()
    rx, sink = make(mod), _collector(mod)
    top.connect(_source(mod, iq, rate), "out", rx, "in")
    top.connect(rx, out, sink, "in")
    tapped = {}
    for name in taps:
        block = next(b for b in rx._blocks if type(b).__name__ == name)
        tapped[name] = _collector(mod)
        top.connect(block, "out", tapped[name], "in")
    kw = {"device": "cpu"} if mod is tl else {}
    top.run(chunk_size=chunk, **kw)
    return sink.items, rx, {k: np.asarray(s.items) for k, s in
                            tapped.items()}


def _json(items):
    return [i.to_json() if hasattr(i, "to_json") else i for i in items]


@functools.lru_cache(maxsize=None)
def _both(name):
    """The receiver ``name`` over its synthesizer in both packages:
    (port items, JAX items, the port's receiver)."""
    if name.startswith("rds"):
        iq, rate, _ = _rds_test_capture()
        make = (lambda m: m.RDSReceiver(pilot=name.split("_")[1]))
        args = (iq, rate, 1 << 17)
    elif name == "pocsag":
        iq, rate, baud, *_ = make_pocsag_iq()
        make, args = (lambda m: m.POCSAGReceiver(baud)), (iq, rate, 1 << 15)
    elif name == "ax25":
        iq, rate = make_ax25_iq()
        make, args = (lambda m: m.AX25Receiver()), (iq, rate, 1 << 15)
    elif name == "ert":
        iq, rate, *_ = make_scm_iq()
        make = (lambda m: m.ERTReceiver(("scm",)))
        args = (iq, rate, 1 << 17, "out1")
    else:
        iq, rate, _ = make_bpsk31_iq()
        make, args = (lambda m: m.BPSK31Receiver()), (iq, rate, 1 << 15)
    got, rx, _ = _receive(tl, make, *args)
    exp, _, _ = _receive(jl, make, *args)
    return got, exp, rx


def _rds_test_capture():
    """tests/core/test_receivers.py test_rds_receiver_end_to_end's
    capture (its RNG seeded as that module seeds it): (iq, rate,
    groups)."""
    rng = np.random.default_rng(99)
    rate = 228000.0
    groups = [tuple(int(v) for v in rng.integers(0, 1 << 16, 4))
              for _ in range(6)]
    chips = manchester_diff_encode(np.concatenate(
        [rds_encode_group(g) for g in groups]))
    n = int(len(chips) * rate / 2375.0) + int(rate * 0.05)
    t = np.arange(n) / rate
    bpsk = 2.0 * chips[np.minimum((t * 2375.0).astype(int),
                                  len(chips) - 1)] - 1.0
    mpx = (0.2 * np.sin(2 * np.pi * 800.0 * t)
           + 0.1 * np.cos(2 * np.pi * 19e3 * t)
           + 0.06 * bpsk * np.cos(3 * 2 * np.pi * 19e3 * t))
    iq = np.exp(1j * 2 * np.pi * np.cumsum(mpx)).astype(np.complex64)
    return iq, rate, groups


@pytest.mark.parametrize("pilot", ["pll", "vector"])
def test_rds_receiver_matches_jax(pilot):
    got, exp, _ = _both(f"rds_{pilot}")
    assert _json(got) == _json(exp)
    _, _, groups = _rds_test_capture()
    raw = [tuple(p.data["frame"]) for p in got if p.data.get("type") == "raw"]
    assert len(got) >= 4
    assert len([g for g in groups if g in raw]) >= 3, (groups, raw)


def test_pocsag_receiver_matches_jax():
    got, exp, _ = _both("pocsag")
    assert _json(got) == _json(exp)
    _, _, _, address, func, text = make_pocsag_iq()
    assert len(got) >= 1
    assert (got[0].address, got[0].func, got[0].alphanumeric) == (
        address, func, text)


def test_ax25_receiver_matches_jax():
    got, exp, _ = _both("ax25")
    assert _json(got) == _json(exp)
    assert len(got) >= 1
    assert got[0].addresses[0]["callsign"] == "NOCALL"
    assert got[0].payload == "hello from tpu radio"


def test_ert_scm_receiver_matches_jax():
    got, exp, _ = _both("ert")
    assert _json(got) == _json(exp)
    _, _, ert_id, consumption = make_scm_iq()
    assert len(got) >= 1
    assert (got[0].ert_id, got[0].consumption, got[0].ert_type) == (
        ert_id, consumption, 4)


def test_bpsk31_receiver_matches_jax():
    got, exp, rx = _both("bpsk31")
    assert got == exp
    _, _, text = make_bpsk31_iq()
    assert text in bytes(int(v) for v in got).decode(errors="replace")
    # the demoted tail: Sampler -> ComplexToReal -> Slicer -> decoders
    kinds = {type(b).__name__: b.domain for b in rx._blocks}
    assert kinds["SamplerBlock"] == "device"
    assert kinds["SlicerBlock"] == kinds["DifferentialDecoderBlock"] \
        == "host"


# -- RDS from noise: the PLL at multiplier 3 -----------------------------------

def rds_noise_capture(rate=RDS_IF, noise_s=0.5, n_groups=8, seed=5):
    """noise_s of complex noise, then broadcast FM at 75 kHz peak
    deviation of the multiplex of tests/core/test_receivers.py (0.2 * an
    800 Hz tone, 0.1 * the 19 kHz pilot, 0.06 * the coded BPSK on 57 kHz)
    carrying ``n_groups`` random RDS groups, at ~30 dB SNR throughout.
    Returns (iq, groups)."""
    rng = np.random.default_rng(seed)
    groups = [tuple(int(v) for v in rng.integers(0, 1 << 16, 4))
              for _ in range(n_groups)]
    chips = manchester_diff_encode(np.concatenate(
        [rds_encode_group(g) for g in groups]))
    n0 = int(noise_s * rate)
    n = n0 + int(len(chips) / 2375.0 * rate) + int(0.05 * rate)
    t = np.arange(n - n0) / rate
    bpsk = 2.0 * chips[np.minimum((t * 2375.0).astype(int),
                                  len(chips) - 1)] - 1.0
    mpx = (0.2 * np.sin(2 * np.pi * 800 * t)
           + 0.1 * np.cos(2 * np.pi * 19e3 * t)
           + 0.06 * bpsk * np.cos(2 * np.pi * 57e3 * t))
    z = np.zeros(n, np.complex128)
    z[n0:] = np.exp(2j * np.pi * 75e3 / 0.36 / rate * np.cumsum(mpx))
    z += np.sqrt(0.5e-3) * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
    return z.astype(np.complex64), groups


@functools.lru_cache(maxsize=None)
def _rds_from_noise():
    """Both packages' RDSReceiver over rds_noise_capture, with the pilot
    filter's output (the PLL's input) tapped: {module: (items, receiver,
    pilot)}."""
    iq, _ = rds_noise_capture()
    out = {}
    for mod in (jl, tl):
        items, rx, taps = _receive(
            mod, lambda m: m.RDSReceiver(), iq, RDS_IF, RDS_CHUNK,
            taps=("ComplexBandpassFilterBlock",))
        out[mod] = (items, rx, taps["ComplexBandpassFilterBlock"]
                    .astype(np.complex64))
    return out


def test_rds_from_noise_takes_k3s_tier_and_matches_jax():
    """The noise chunks fail the linear tier's guards; the port's PLL
    takes the sequential tier on at least one chunk (K3's twin here, K3
    on the card) and decodes the JAX package's packets."""
    res = _rds_from_noise()
    got, rx, _ = res[tl]
    pll = next(b for b in rx._blocks if isinstance(b, tl.PLLBlock))
    assert pll.tier_counts[3] >= 1 and pll.tier_counts[1] >= 1, \
        pll.tier_counts
    assert _json(got) == _json(res[jl][0])
    _, groups = rds_noise_capture()
    raw = [tuple(p.data["frame"]) for p in got if p.data.get("type") == "raw"]
    assert len([g for g in groups if g in raw]) >= len(groups) // 2


def _pll_blocks():
    loop, lo, hi, mult = RDS_PLL
    out = {}
    for mod in (jl, tl):
        blk = mod.PLLBlock(loop, lo, hi, multiplier=mult)
        if mod is tl:
            blk.device = torch.device("cpu")
        blk.differentiate([mod.ComplexFloat32])
        blk.input_rate = RDS_IF
        blk.initialize()
        out[mod] = blk
    return out


def test_rds_pll_linear_guard_matches_jax_chunk_by_chunk():
    """On the pilot the JAX receiver's PLL saw (the first five full
    chunks of the noise capture), both packages' linear tier decides
    ``valid`` alike on every chunk, each from the state its own PLLBlock
    carried out of the chunk before.  A chunk where they part is named."""
    pilot = _rds_from_noise()[jl][2]
    blocks = _pll_blocks()
    jb, tb = blocks[jl], blocks[tl]
    assert (tb._alpha, tb._beta, tb._freq_min, tb._freq_max) == (
        jb._alpha, jb._beta, jb._freq_min, jb._freq_max)
    js, ts = jb.init_state(), tb.init_state()
    jax_process = jax.jit(jb.process)
    flags = []
    for c in range(len(pilot) // RDS_CHUNK):
        x = pilot[c * RDS_CHUNK:(c + 1) * RDS_CHUNK]
        jv = bool(jax_linear(jnp.asarray(x), js, jb._alpha, jb._beta,
                             jb._freq_min, jb._freq_max, 3)[0])
        tv = bool(pll_linear(torch.from_numpy(x), ts, tb._alpha, tb._beta,
                             tb._freq_min, tb._freq_max, 3)[0])
        flags.append((jv, tv))
        js, _ = jax_process(js, jnp.asarray(x))
        ts, _ = tb.process(ts, torch.from_numpy(x))
    assert len(flags) == 5
    parted = [c for c, (a, b) in enumerate(flags) if a != b]
    assert not parted, f"valid flags part on chunks {parted}: {flags}"
    assert flags[0] == (False, False) and flags[-1] == (True, True)


def _k3_case(name, n=2048):
    rng = np.random.default_rng(31 + ("noise", "pilot", "capture").index(
        name))
    if name == "capture":        # across the station's arrival at 0.5 s
        pilot = _rds_from_noise()[jl][2]
        n0 = int(0.5 * RDS_IF) - n // 2
        return pilot[n0:n0 + n]
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    if name == "noise":
        return (0.05 * noise).astype(np.complex64)
    t = np.arange(n)
    return (0.1 * np.exp(1j * (2 * np.pi * 19.03e3 / RDS_IF * t + 0.3))
            + 0.01 * noise).astype(np.complex64)


@pytest.mark.parametrize("case", ["noise", "pilot", "capture"])
def test_k3_twin_matches_pallas_interpret_at_rds_constants(case):
    """K3's twin against the TPU kernel (interpret mode) at the RDS loop's
    constants over N = 2048, four of the TPU kernel's 512-sample grid
    blocks: err and the frequency within 1e-6, out and phi_m within 2e-5
    (tests/test_torch_pll.py's limits)."""
    tb = _pll_blocks()[tl]
    alpha, beta, fmin, fmax = tb._alpha, tb._beta, tb._freq_min, tb._freq_max
    x = _k3_case(case)
    st = np.array([0.3, -0.5, (fmin + fmax) / 2], np.float32)
    xp = jnp.asarray(np.stack([x.real, x.imag]))
    out, err, ns = pll_pallas(xp, jnp.asarray(st), alpha, beta, fmin, fmax,
                              3.0, interpret=True)
    got_out, got_err, got_st = (v.numpy() for v in pll_phase(
        torch.from_numpy(x), torch.from_numpy(st), alpha, beta, fmin, fmax,
        3.0))
    assert np.max(np.abs(got_err - np.asarray(err[0]))) <= 1e-6
    exp_out = np.asarray(out[0]) + 1j * np.asarray(out[1])
    assert np.max(np.abs(got_out - exp_out)) <= 2e-5
    wrapped = np.abs(np.angle(np.exp(1j * (got_st[:2].astype(np.float64)
                                           - np.asarray(ns)[:2]))))
    assert np.max(wrapped) <= 2e-5
    assert abs(got_st[2] - np.asarray(ns)[2]) <= 1e-6

