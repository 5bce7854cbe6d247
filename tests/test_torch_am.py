"""The analog receivers' blocks and composites of the port against the JAX
package on the same numpy inputs: the per-sample coefficient of
linrec_first_order, AGCBlock, the designed filters, UpsamplerBlock, the
resampling composites, and the AM, SSB and NBFM composites in graphs
(whole and split at chunk boundaries, with the optimizer on and off).

NBFMDemodulator's discriminator takes arg(x[n] conj(x[n-1])), which jumps
by 2 pi where the product lies within rounding of the negative real axis
(the RF filter's start-up transient crosses it): the two packages may
land on either side.  The AF lowpass is linear, so the audio then differs
by that filter's response to the discriminators' difference: the test
holds the discriminators equal modulo 2 pi / gain and the audio within
|h| convolved with their raw difference.

AMSynchronousDemodulator runs a PLL.  Where the loop is not locked the
port's PLL takes K3's twin (int32-turn phases) and the JAX package's CPU
path its float-radian scan, which differ by rounding; as in
tests/test_torch_stereo.py the demodulated output is then held within a
bound derived sample by sample from the two runs' own PLL phase gap dphi:
audio = AF(Re(rf * conj(pll))), the mixer's output moves by at most
|rf| * dphi, and the DC block and the AF lowpass, a linear filter with
impulse response h, move the audio by at most |h| convolved with that.
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
from luaradio_tpu.ops.scan import \
    linrec_first_order as jax_linrec  # noqa: E402
from luaradio_tpu_torch.ops.scan import linrec_first_order  # noqa: E402
from tests.blocks.test_carrier import agc_oracle  # noqa: E402
from tests.core.test_demodulators import _tone_snr  # noqa: E402


def _close(got, exp, tol=2e-5):
    assert got.shape == exp.shape, (got.shape, exp.shape)
    scale = max(1.0, float(np.max(np.abs(exp))))
    err = float(np.max(np.abs(got.astype(np.complex128) - exp)))
    assert err < tol * scale, (err, tol * scale)


# -- linrec_first_order with a per-sample coefficient ------------------------

def _loop(u, a, y0):
    """The recurrence one sample at a time in float64 (complex128)."""
    y = np.zeros(len(u), np.result_type(u.dtype, a.dtype, np.float64))
    p = y0
    for i in range(len(u)):
        p = a[i] * p + u[i]
        y[i] = p
    return y


def _gated(rng, n, hold=0.5):
    """u, a of the AGC's gain recurrence: a = 1 (a hold, u = 0) on a share
    ``hold`` of the samples, else a in [0.9, 1) and u ~ N(0, 1)."""
    held = rng.random(n) < hold
    a = np.where(held, 1.0, rng.uniform(0.9, 1.0, n)).astype(np.float32)
    u = np.where(held, 0.0, rng.standard_normal(n)).astype(np.float32)
    return u, a


@pytest.mark.parametrize("n", [1, 5, 63, 64, 200, 256, 257, 1000, 1023,
                               1024, 3000, 70000])
def test_linrec_array_matches_jax(n):
    """Ragged lengths, lengths below 4 blocks and several levels of block
    summaries: against the JAX package's blocked scan and a float64 loop
    within 1e-5 * scale."""
    rng = np.random.default_rng(n)
    u, a = _gated(rng, n)
    y0 = np.float32(0.7)
    got = linrec_first_order(torch.from_numpy(u), torch.from_numpy(a),
                             torch.tensor(y0)).numpy()
    exp = np.asarray(jax_linrec(jnp.asarray(u), jnp.asarray(a),
                                jnp.float32(y0)))
    assert got.dtype == exp.dtype == np.float32
    _close(got, exp, 1e-5)
    _close(got, _loop(u, a, float(y0)), 1e-5)


def test_linrec_array_carries_y0_across_chunks():
    """Chunks of 777 with y[-1] carried equal one call over the whole,
    and the JAX package's chunked run; a batch of rows with one y0
    each."""
    rng = np.random.default_rng(3)
    u, a = _gated(rng, 3 * 5000)
    u, a = u.reshape(3, -1), a.reshape(3, -1)
    y0 = np.array([0.5, -1.0, 2.0], np.float32)
    whole = linrec_first_order(torch.from_numpy(u), torch.from_numpy(a),
                               torch.from_numpy(y0)).numpy()
    parts, jparts = [], []
    yt, yj = torch.from_numpy(y0), jnp.asarray(y0)
    for lo in range(0, u.shape[1], 777):
        uc, ac = u[:, lo:lo + 777], a[:, lo:lo + 777]
        y = linrec_first_order(torch.from_numpy(uc.copy()),
                               torch.from_numpy(ac.copy()), yt)
        yt = y[:, -1]
        parts.append(y.numpy())
        yj_c = jax_linrec(jnp.asarray(uc), jnp.asarray(ac), yj)
        yj = yj_c[:, -1]
        jparts.append(np.asarray(yj_c))
    _close(np.concatenate(parts, 1), whole, 1e-5)
    _close(np.concatenate(parts, 1), np.concatenate(jparts, 1), 1e-5)
    for r in range(3):
        _close(whole[r], _loop(u[r], a[r], float(y0[r])), 1e-5)


def test_linrec_array_long_holds():
    """Long runs of a = 1 (the AGC's gate holding the gain) keep y exactly;
    runs of a = 1e-3 between them drive the block products to zero, which
    must not blow up (no quotient by a product is ever formed)."""
    n = 20000
    a = np.ones(n, np.float32)
    u = np.zeros(n, np.float32)
    a[5000:5300] = 1e-3
    u[5000:5300] = 0.25
    a[12000:12001] = 0.5
    y0 = np.float32(3.0)
    got = linrec_first_order(torch.from_numpy(u), torch.from_numpy(a),
                             torch.tensor(y0)).numpy()
    assert np.all(np.isfinite(got))
    assert np.all(got[:5000] == np.float32(3.0))
    assert np.all(got[5300:12000] == got[5299])
    _close(got, _loop(u, a, 3.0), 1e-5)
    exp = np.asarray(jax_linrec(jnp.asarray(u), jnp.asarray(a),
                                jnp.float32(y0)))
    _close(got, exp, 1e-5)


def test_linrec_array_complex_input():
    """A complex u with a real per-sample a (the form the AGC's gain takes
    on a complex stream)."""
    rng = np.random.default_rng(5)
    u, a = _gated(rng, 2000)
    uc = (u + 1j * rng.standard_normal(2000)).astype(np.complex64)
    got = linrec_first_order(torch.from_numpy(uc), torch.from_numpy(a),
                             torch.tensor(0.0)).numpy()
    assert got.dtype == np.complex64
    _close(got, _loop(uc, a, 0.0), 1e-5)


# -- blocks -------------------------------------------------------------------

def _setup(mod, block, types, rate):
    if mod is tl:
        block.device = torch.device("cpu")
    block.differentiate(types)
    block.input_rate = rate
    block.initialize()
    return block


def _run_block(mod, factory, kind, x, splits, rate):
    t = mod.ComplexFloat32 if kind == "complex" else mod.Float32
    blk = _setup(mod, factory(mod), [t], rate)
    st = blk.init_state()
    process = jax.jit(blk.process) if mod is jl else blk.process
    conv = jnp.asarray if mod is jl else torch.from_numpy
    outs = []
    for part in np.split(x, splits):
        st, y = process(st, conv(np.ascontiguousarray(part)))
        outs.append(np.asarray(y))
    return np.concatenate(outs), blk


def _signal(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "float":
        return (0.3 * rng.standard_normal(n)).astype(np.float32)
    ph = np.cumsum(0.4 * rng.standard_normal(n))
    z = np.exp(1j * ph) + 0.05 * (rng.standard_normal(n)
                                  + 1j * rng.standard_normal(n))
    return z.astype(np.complex64)


FILTERS = {
    "highpass": (lambda m: m.HighpassFilterBlock(65, 3e3), "float"),
    "highpass_complex": (lambda m: m.HighpassFilterBlock(63, 5e3),
                         "complex"),
    "bandpass": (lambda m: m.BandpassFilterBlock(129, (2e3, 6e3)),
                 "float"),
    "bandstop": (lambda m: m.BandstopFilterBlock(129, (2e3, 6e3)),
                 "complex"),
    "complex_bandstop": (lambda m: m.ComplexBandstopFilterBlock(
        129, (-3e3, 1e3)), "complex"),
    "singlepole_lowpass": (lambda m: m.SinglepoleLowpassFilterBlock(1e3),
                           "float"),
    "singlepole_highpass": (lambda m: m.SinglepoleHighpassFilterBlock(
        100.0), "complex"),
    "fm_preemphasis": (lambda m: m.FMPreemphasisFilterBlock(75e-6),
                       "float"),
    "upsampler": (lambda m: m.UpsamplerBlock(3), "complex"),
    "upsampler_float": (lambda m: m.UpsamplerBlock(4), "float"),
}


@pytest.mark.parametrize("splits", [1, [1000, 2500, 2501]])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_matches_jax(name, splits):
    """Whole, and split at ragged chunk boundaries (the carried state),
    against the JAX block run whole: 2e-5 * scale."""
    factory, kind = FILTERS[name]
    x = _signal(len(name), 4096, kind)
    exp, _ = _run_block(jl, factory, kind, x, 1, 44100.0)
    got, _ = _run_block(tl, factory, kind, x, splits, 44100.0)
    assert got.dtype == exp.dtype
    _close(got, exp)


@functools.lru_cache(maxsize=None)
def _jax_filter_graph(name):
    factory, kind = FILTERS[name]
    x = _signal(len(name), 4096, kind)
    out_t = _C if kind == "complex" else _F
    return _run_graph(jl, x, 44100.0, factory(jl), out_t, 4096)["out"]


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_in_graph_matches_jax(name, optimize):
    """Each filter in a graph (source -> filter -> sink), in chunks of 1000
    with the optimizer on and off, against the JAX package's graph in one
    chunk: 2e-5 * scale."""
    factory, kind = FILTERS[name]
    x = _signal(len(name), 4096, kind)
    out_t = _C if kind == "complex" else _F
    got = _run_graph(tl, x, 44100.0, factory(tl), out_t, 1000,
                     optimize)["out"]
    exp = _jax_filter_graph(name)
    assert got.dtype == exp.dtype
    _close(got, exp)


@pytest.mark.parametrize("mode", ["fast", "slow", "custom"])
@pytest.mark.parametrize("kind", ["complex", "float"])
def test_agc_matches_jax_and_oracle(mode, kind):
    """tests/blocks/test_carrier.py::test_agc's signal (a quarter below the
    threshold, then above it), split as there, against its per-sample
    oracle and against the JAX block, at its 1e-4.  A sample whose power
    lies within float32 rounding of the threshold may take the other gate
    in one of the two; such samples are listed in the message."""
    n = 8192
    rng = np.random.default_rng(23)
    x = (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    x[:n // 4] *= 1e-4
    if kind == "float":
        x = np.ascontiguousarray(x.real)
    factory = (lambda m: m.AGCBlock(mode, gain_tau=0.5)) if mode == "custom" \
        else (lambda m: m.AGCBlock(mode))
    got, blk = _run_block(tl, factory, kind, x, (1000, 5000), 44100.0)
    exp, _ = _run_block(jl, factory, kind, x, 1, 44100.0)
    oracle = agc_oracle(x, blk._power_alpha, blk._gain_alpha, blk._target,
                        blk._threshold)
    p, pa, near = 0.0, float(blk._power_alpha), []
    for i, v in enumerate(x.astype(np.complex128)):
        p = (1 - pa) * p + pa * abs(v) ** 2
        if abs(p - float(blk._threshold)) <= 4 * np.spacing(
                np.float32(blk._threshold)):
            near.append(i)
    assert got.dtype == x.dtype
    # the threshold is crossed inside the signal
    assert np.any(got[:n // 4] == x[:n // 4]) and np.any(got != x)
    for label, ref in (("oracle", oracle), ("jax", exp)):
        err = float(np.max(np.abs(got - ref)))
        assert err < 1e-4, (label, err, "samples within rounding of the "
                            "threshold:", near)


def test_agc_state_is_power_and_gain():
    blk = _setup(tl, tl.AGCBlock("fast"), [tl.Float32], 8000.0)
    st, _ = blk.process(blk.init_state(), torch.ones(100))
    assert len(st) == 2 and st[0].shape == () and float(st[1]) > 0
    with pytest.raises(ValueError, match="invalid mode"):
        tl.AGCBlock("medium")
    with pytest.raises(ValueError, match="gain_tau"):
        tl.AGCBlock("custom")


# -- composites in graphs -----------------------------------------------------

def _source(mod, data, rate):
    t = mod.ComplexFloat32 if np.iscomplexobj(data) else mod.Float32

    class ArraySource(mod.HostSourceBlock):
        def __init__(self):
            super().__init__()
            self.rate = rate
            self.pos = 0
            self.add_type_signature([], [mod.Output("out", t)])

        def read(self, n):
            if self.pos >= len(data):
                return None
            chunk = data[self.pos:self.pos + n]
            self.pos += len(chunk)
            return chunk
    return ArraySource()


def _collector(mod, t):
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature([mod.Input("in", t)], [])

        def process(self, x):
            self.got.append(np.array(x))
    return Collect()


def _run_graph(mod, data, rate, composite, out_t, chunk, optimize=True,
               taps=()):
    """data -> composite -> sink; also a sink on the "out" of the first
    inner block of each type named in ``taps``.  Returns {"out": ...,
    name: ...}."""
    top = mod.CompositeBlock()
    sinks = {"out": _collector(mod, out_t(mod))}
    top.connect(_source(mod, data, rate), composite, sinks["out"])
    for name in taps:
        block = next(b for b in composite._blocks
                     if type(b).__name__ == name)
        sinks[name] = _collector(mod, lambda t: True)
        top.connect(block, "out", sinks[name], "in")
    kw = {"device": "cpu"} if mod is tl else {}
    top.run(chunk_size=chunk, optimize=optimize, **kw)
    return {k: np.concatenate(s.got) for k, s in sinks.items()}


def _am(rate, seconds, ifreq, tone):
    n = int(rate * seconds)
    t = np.arange(n) / rate
    msg = 0.5 * np.sin(2 * np.pi * tone * t)
    return ((1.0 + msg) * np.exp(1j * 2 * np.pi * ifreq * t)
            ).astype(np.complex64)


def _nbfm(rate, seconds):
    n = int(rate * seconds)
    t = np.arange(n) / rate
    msg = 0.8 * np.sin(2 * np.pi * 700.0 * t)
    return np.exp(1j * 2 * np.pi * 5e3 * np.cumsum(msg) / rate
                  ).astype(np.complex64)


def _msg(rate, seconds):
    n = int(rate * seconds)
    t = np.arange(n) / rate
    return (0.5 * np.sin(2 * np.pi * 1200.0 * t)).astype(np.float32)


_F, _C = (lambda m: m.Float32), (lambda m: m.ComplexFloat32)

# name -> (input, rate, factory, output type, the JAX test's chunk,
#          (tone, SNR floor) the JAX test asserts, or None)
COMPOSITES = {
    "am_envelope": (lambda: _am(88200.0, 0.6, 0.0, 1000.0), 88200.0,
                    lambda m: m.AMEnvelopeDemodulator(5e3), _F, 1 << 15,
                    (1000.0, 10)),
    "ssb_usb": (lambda: _am(44100.0, 0.5, 1.2e3, 600.0), 44100.0,
                lambda m: m.SSBDemodulator("usb", 3e3), _F, 1 << 14, None),
    "ssb_lsb": (lambda: _am(44100.0, 0.5, -1.2e3, 600.0), 44100.0,
                lambda m: m.SSBDemodulator("lsb", 3e3), _F, 1 << 14, None),
    "ssb_modulator_usb": (lambda: _msg(44100.0, 0.5), 44100.0,
                          lambda m: m.SSBModulator("usb", 3e3), _C, 1 << 14,
                          None),
    "ssb_modulator_lsb": (lambda: _msg(44100.0, 0.5), 44100.0,
                          lambda m: m.SSBModulator("lsb", 3e3), _C, 1 << 14,
                          None),
    "decimator": (lambda: _am(44100.0, 0.5, 3e3, 600.0), 44100.0,
                  lambda m: m.DecimatorBlock(4), _C, 1 << 14, None),
    "decimator_float": (lambda: _msg(44100.0, 0.5), 44100.0,
                        lambda m: m.DecimatorBlock(3, num_taps=65), _F,
                        1 << 14, None),
    "interpolator": (lambda: _am(11025.0, 0.5, 1e3, 300.0), 11025.0,
                     lambda m: m.InterpolatorBlock(4), _C, 1 << 14, None),
    "rational_resampler": (lambda: _msg(44100.0, 0.5), 44100.0,
                           lambda m: m.RationalResamplerBlock(3, 4), _F,
                           1 << 14, None),
}


@functools.lru_cache(maxsize=None)
def _jax_composite(name):
    """The JAX package's graph at its test's chunk (one run a composite)."""
    make, rate, factory, out_t, jchunk, _ = COMPOSITES[name]
    return _run_graph(jl, make(), rate, factory(jl), out_t, jchunk)["out"]


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("chunk", ["jax", "split"])
@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_composite_matches_jax(name, chunk, optimize):
    """Each composite in a graph, at the JAX test's chunk (the whole input
    in one or a few chunks) and split into chunks of 3000 (a boundary
    every few thousand samples), optimizer on and off, against the JAX
    package's graph at the JAX test's chunk: 2e-5 * scale."""
    make, rate, factory, out_t, jchunk, tone = COMPOSITES[name]
    data = make()
    exp = _jax_composite(name)
    got = _run_graph(tl, data, rate, factory(tl), out_t,
                     jchunk if chunk == "jax" else 3000, optimize)["out"]
    assert got.dtype == exp.dtype
    _close(got, exp)
    if tone is not None:
        assert _tone_snr(got, rate, tone[0]) > tone[1]


def hold_discriminators(rf_p, rf_j, disc_p, disc_j, index):
    """Two runs' discriminator outputs, from RF streams held equal first:
    the angle of a product of two RF samples moves by at most the sum of
    their relative differences, and modulo 2 pi (a period of 1/index at
    the output) that bounds the discriminators' difference.  Returns
    their raw difference."""
    rf_j = rf_j.astype(np.complex128)
    _close(rf_p, rf_j)
    rel = np.abs(rf_p - rf_j) / np.maximum(np.abs(rf_j), 1e-30)
    dtheta = rel + np.concatenate([[0.0], rel[:-1]])
    period = 1 / index
    dd = disc_p.astype(np.float64) - disc_j
    wrapped = np.abs((dd + period / 2) % period - period / 2)
    limit = 2e-5 + 1.01 * dtheta / (2 * np.pi * index)
    assert np.all(wrapped[1:] <= limit[1:]), np.max(wrapped[1:] - limit[1:])
    # the first product is x[0] times the zero carried in, whose parts
    # are zeros with the signs of x[0]'s (one of them may be a rounding
    # residue in one package): atan2 of zeros gives 0 or +-pi
    assert min(abs(abs(dd[0]) - k * period / 2) for k in (0, 1, 2)) < 1e-6
    return dd


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("chunk", [1 << 14, 3000])
def test_nbfm_matches_jax(chunk, optimize):
    """tests/core/test_demodulators.py's NBFM case (5 kHz deviation, 700 Hz
    tone at 44.1 kS/s) in a graph, against the JAX package's graph at its
    chunk (module docstring), and its tone test."""
    import scipy.signal
    rate = 44100.0
    taps = ("LowpassFilterBlock", "FrequencyDiscriminatorBlock")
    data = _nbfm(rate, 0.5)
    jax_ = _run_graph(jl, data, rate, jl.NBFMDemodulator(5e3, 4e3), _F,
                      1 << 14, taps=taps)
    port = _run_graph(tl, data, rate, tl.NBFMDemodulator(5e3, 4e3), _F,
                      chunk, optimize, taps=taps)
    dd = hold_discriminators(port[taps[0]], jax_[taps[0]], port[taps[1]],
                             jax_[taps[1]], 1.25)
    lpf = tl.LowpassFilterBlock(128, 4e3)
    lpf.input_rate = rate
    bound = 2e-5 * max(1.0, float(np.max(np.abs(jax_["out"])))) \
        + scipy.signal.fftconvolve(np.abs(lpf.design_taps()),
                                   np.abs(dd))[:len(dd)]
    d = np.abs(port["out"].astype(np.float64) - jax_["out"])
    assert np.all(d <= bound), float(np.max(d - bound))
    assert _tone_snr(port["out"], rate, 700.0) > 10


def _af_response(rate, bandwidth, n):
    """The impulse response of the synchronous demodulator after its
    mixer: the 100 Hz DC block, then the 128-tap AF lowpass."""
    import scipy.signal
    lpf = tl.LowpassFilterBlock(128, bandwidth)
    lpf.input_rate = rate
    hpf = tl.SinglepoleHighpassFilterBlock(100.0)
    hpf.input_rate = rate
    b, a = hpf._design_ba()
    h = np.zeros(n)
    h[:128] = lpf.design_taps()
    return scipy.signal.lfilter(b, a, h)


def am_sync_bound(port, jax_, rate, bandwidth=5e3):
    """The derived bound on |audio(port) - audio(JAX)| at each sample (the
    module docstring), from the PLL and RF-filter taps of the two runs."""
    import scipy.signal
    dphi = np.abs(np.angle(port["PLLBlock"].astype(np.complex128)
                           * np.conj(jax_["PLLBlock"])))
    mixed = np.abs(jax_["ComplexBandpassFilterBlock"]).astype(
        np.float64) * dphi
    h = np.abs(_af_response(rate, bandwidth, len(mixed)))
    return scipy.signal.fftconvolve(h, mixed)[:len(mixed)]


def _hold_am_sync(port, jax_, rate):
    bound = 2e-5 * max(1.0, float(np.max(np.abs(jax_["out"])))) \
        + am_sync_bound(port, jax_, rate)
    d = np.abs(port["out"].astype(np.float64) - jax_["out"])
    assert np.all(d <= bound), (float(np.max(d - bound)),
                                int(np.argmax(d - bound)))


_TAPS = ("PLLBlock", "ComplexBandpassFilterBlock")


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("chunk", [1 << 15, 3000])
def test_am_synchronous_matches_jax(chunk, optimize):
    """tests/core/test_demodulators.py's synchronous case (a 10 kHz
    carrier, 800 Hz tone at 88.2 kS/s) in a graph, held within the
    derived bound of the JAX package's graph, and its tone test."""
    rate = 88200.0
    data = _am(rate, 0.8, 10e3, 800.0)
    jax_ = _run_graph(jl, data, rate, jl.AMSynchronousDemodulator(10e3),
                      _F, 1 << 15, taps=_TAPS)
    port = _run_graph(tl, data, rate, tl.AMSynchronousDemodulator(10e3),
                      _F, chunk, optimize, taps=_TAPS)
    _hold_am_sync(port, jax_, rate)
    assert _tone_snr(port["out"], rate, 800.0) > 10


def test_am_synchronous_from_noise_takes_k3s_tier():
    """A capture that starts with noise (a receiver tuned before the
    station comes up), at the IF rate rx_am gives the demodulator: the
    loop cannot stay linear through the noise and the acquisition, so the
    PLL's chunks there take the sequential tier (K3's twin on the CPU);
    the audio is held within the derived bound of the JAX package's."""
    rate = 220500.0
    rng = np.random.default_rng(8)
    n, n0 = int(0.4 * rate), int(0.1 * rate)
    data = _am(rate, 0.4, 0.0, 1000.0) * np.exp(1j * 0.8)
    data[:n0] = 0
    data = (data + 0.03 * (rng.standard_normal(n)
                           + 1j * rng.standard_normal(n))).astype(
        np.complex64)
    jax_ = _run_graph(jl, data, rate, jl.AMSynchronousDemodulator(0.0),
                      _F, 1 << 14, taps=_TAPS)
    demod = tl.AMSynchronousDemodulator(0.0)
    port = _run_graph(tl, data, rate, demod, _F, 1 << 14, taps=_TAPS)
    pll_block = next(b for b in demod._blocks
                     if isinstance(b, tl.PLLBlock))
    counts = pll_block.tier_counts
    assert counts[3] >= 1 and counts[1] >= 1, counts
    _hold_am_sync(port, jax_, rate)
    assert _tone_snr(port["out"], rate, 1000.0,
                     seg=slice(n // 2, n // 2 + 16384)) > 10
