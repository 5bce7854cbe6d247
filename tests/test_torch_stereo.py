"""The stereo receiver of the port against the JAX package on the same
numpy inputs: each block the stereo graph adds (Hilbert, complex
bandpass, delay, the elementwise math, pilot recovery), whole and split
at chunk boundaries; WBFMStereoDemodulator in both pilot modes, in a graph
and resumed from the JAX package's block states; and rx_wbfm through the
port's cli.main against the JAX package's cli.main.

The pilot="pll" path differs from the JAX package's CPU path by rounding:
the port's sequential PLL tier is K3's twin (int32-turn phases), the JAX
package's is its float-radian lax.scan.  Only the L-R channel sees the PLL:
L-R = Re(LPF(delayed * conj(pll))), so if the two PLL outputs differ in
phase by at most dphi, the two L-R channels differ by at most
|h_lpf| convolved with dphi * |delayed|, sample by sample (a unit-phasor
difference is at most its angle), and the deemphasis, whose impulse
response is positive, carries that bound through.  The PLL tests derive
their tolerance from that bound, with dphi and |delayed| read off the two
runs themselves (sinks on the PLL's output and on the delay line); L+R is
held at 2e-5 * scale as everywhere else.
"""

import os
import wave

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.cli import main as jax_main  # noqa: E402
from luaradio_tpu_torch import applications  # noqa: E402
from luaradio_tpu_torch.cli import main as port_main  # noqa: E402
from luaradio_tpu_torch.interop import (  # noqa: E402
    composite_states_from_jax)

RATE = 220500.0        # the IF rate rx_wbfm gives the demodulator
RX_RATE = 1102500.0    # the RTL-SDR rate (apps.py)


def _close(got, exp, tol=2e-5):
    assert got.shape == exp.shape, (got.shape, exp.shape)
    scale = max(1.0, float(np.max(np.abs(exp))))
    err = float(np.max(np.abs(got.astype(np.complex128) - exp)))
    assert err < tol * scale, (err, tol * scale)


def _signal(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "byte":
        return rng.integers(0, 256, n).astype(np.uint8)
    if kind == "float":
        return (0.3 * rng.standard_normal(n)).astype(np.float32)
    ph = np.cumsum(0.4 * rng.standard_normal(n))
    z = np.exp(1j * ph) + 0.05 * (rng.standard_normal(n)
                                  + 1j * rng.standard_normal(n))
    return z.astype(np.complex64)


def _type(mod, kind):
    return {"complex": mod.ComplexFloat32, "float": mod.Float32,
            "byte": mod.Byte}[kind]


# name -> (factory of the block in a package, kinds of its inputs)
SPECS = {
    "hilbert": (lambda m: m.HilbertTransformBlock(129), ["float"]),
    "complex_bandpass": (lambda m: m.ComplexBandpassFilterBlock(
        129, (18e3, 20e3)), ["complex"]),
    "delay_complex": (lambda m: m.DelayBlock(64), ["complex"]),
    "delay_float": (lambda m: m.DelayBlock(7), ["float"]),
    "delay_byte": (lambda m: m.DelayBlock(5), ["byte"]),
    "pilot_recovery": (lambda m: m.PilotRecoveryBlock(
        129, (18e3, 20e3), multiplier=2), ["complex"]),
    "add": (lambda m: m.AddBlock(), ["complex", "complex"]),
    "add_float": (lambda m: m.AddBlock(), ["float", "float"]),
    "add_byte": (lambda m: m.AddBlock(), ["byte", "byte"]),
    "subtract": (lambda m: m.SubtractBlock(), ["float", "float"]),
    "multiply": (lambda m: m.MultiplyBlock(), ["complex", "complex"]),
    "multiply_conjugate": (lambda m: m.MultiplyConjugateBlock(),
                           ["complex", "complex"]),
    "multiply_constant": (lambda m: m.MultiplyConstantBlock(0.7),
                          ["float"]),
    "multiply_constant_complex": (lambda m: m.MultiplyConstantBlock(
        0.3 - 0.2j), ["complex"]),
    "add_constant": (lambda m: m.AddConstantBlock(1.5), ["complex"]),
    "absolute_value": (lambda m: m.AbsoluteValueBlock(), ["float"]),
    "complex_conjugate": (lambda m: m.ComplexConjugateBlock(),
                          ["complex"]),
    "complex_magnitude": (lambda m: m.ComplexMagnitudeBlock(),
                          ["complex"]),
    "complex_phase": (lambda m: m.ComplexPhaseBlock(), ["complex"]),
    "complex_to_real": (lambda m: m.ComplexToRealBlock(), ["complex"]),
    "complex_to_imag": (lambda m: m.ComplexToImagBlock(), ["complex"]),
    "complex_to_float": (lambda m: m.ComplexToFloatBlock(), ["complex"]),
    "real_to_complex": (lambda m: m.RealToComplexBlock(), ["float"]),
    "float_to_complex": (lambda m: m.FloatToComplexBlock(),
                         ["float", "float"]),
}


def _setup(mod, block, types, rate=RATE):
    if mod is tl:
        block.device = torch.device("cpu")
    block.differentiate(types)
    block.input_rate = rate
    block.initialize()
    return block


def _run_block(mod, name, xs, chunks):
    factory, kinds = SPECS[name]
    blk = _setup(mod, factory(mod), [_type(mod, k) for k in kinds])
    st = blk.init_state()
    process = jax.jit(blk.process) if mod is jl else blk.process
    conv = jnp.asarray if mod is jl else torch.from_numpy
    outs = []
    for parts in zip(*(np.split(x, chunks) for x in xs)):
        st, ys = process(st, *(conv(np.ascontiguousarray(p))
                               for p in parts))
        ys = ys if isinstance(ys, tuple) else (ys,)
        outs.append([np.asarray(y) for y in ys])
    return [np.concatenate(o) for o in zip(*outs)]


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_block_matches_jax(name, chunks):
    n = 4096
    xs = [_signal(7 * i + len(name), n, k)
          for i, k in enumerate(SPECS[name][1])]
    exp = _run_block(jl, name, xs, 1)
    got = _run_block(tl, name, xs, chunks)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype
        _close(g, e)


def test_pilot_normalize_multiply_is_one_at_zero():
    from luaradio_tpu_torch.blocks.signal.carrier import \
        pilot_normalize_multiply
    p = torch.tensor([0j, 3 + 4j, -2j], dtype=torch.complex64)
    y = pilot_normalize_multiply(p, 2).numpy()
    np.testing.assert_allclose(y, [1, (0.6 + 0.8j) ** 2, -1], atol=1e-6)


# -- the composite ------------------------------------------------------------

def stereo_mpx(n, rate, tone_l=1000.0, tone_r=400.0):
    """Broadcast FM stereo at baseband (test_applications.py:95-113): L a
    1 kHz tone, R a 400 Hz tone, pilot 0.1 cos 19 kHz, 75 kHz deviation."""
    t = np.arange(n) / rate
    left = 0.4 * np.sin(2 * np.pi * tone_l * t)
    right = 0.4 * np.sin(2 * np.pi * tone_r * t)
    mpx = (left + right) + 0.1 * np.cos(2 * np.pi * 19e3 * t) \
        + (left - right) * np.cos(2 * np.pi * 38e3 * t)
    return np.exp(1j * 2 * np.pi * 75e3 * np.cumsum(mpx) / rate).astype(
        np.complex64)


def _collector(mod, t=None):
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature([mod.Input("in", t or mod.Float32)], [])

        def process(self, x):
            self.got.append(np.array(x))
    return Collect()


def _lmr_response():
    """The L-R path after the mixer: the 128-tap 15 kHz lowpass and the
    75 us deemphasis at the IF rate (as the demodulator designs them)."""
    from luaradio_tpu_torch.blocks.signal.filtering import \
        _singlepole_lowpass_coeffs
    lpf = tl.LowpassFilterBlock(128, 15e3)
    lpf.input_rate = RATE
    return lpf.design_taps(), _singlepole_lowpass_coeffs(
        1 / (2 * np.pi * 75e-6), RATE)


def _tapped_run(mod, path, pilot, chunk):
    """WBFMStereoDemodulator in a graph over the IQ file at the IF rate,
    with sinks on left and right and, for pilot="pll", on the PLL's output
    and the delayed analytic signal the mixer takes."""
    top = mod.CompositeBlock()
    demod = mod.WBFMStereoDemodulator(pilot=pilot)
    sinks = {"left": _collector(mod), "right": _collector(mod)}
    top.connect(mod.IQFileSource(path, "f32le", RATE), demod)
    top.connect(demod, "left", sinks["left"], "in")
    top.connect(demod, "right", sinks["right"], "in")
    if pilot == "pll":
        inner = {type(b).__name__: b for b in demod._blocks}
        for name, block in (("pll", inner["PLLBlock"]),
                            ("delayed", inner["DelayBlock"])):
            sinks[name] = _collector(mod, mod.ComplexFloat32)
            top.connect(block, "out", sinks[name], "in")
    kw = {"device": "cpu"} if mod is tl else {}
    top.run(chunk_size=chunk, **kw)
    return {k: np.concatenate(v.got) for k, v in sinks.items()}


def pll_bound(port, jax_):
    """The derived bound on |L-R(port) - L-R(JAX)| at each sample (module
    docstring), from the taps of the two runs: the mixer's output moves by
    at most |delayed| * dphi, the lowpass by at most |h| convolved with
    that, and the deemphasis (positive impulse response) carries the
    bound through."""
    import scipy.signal
    dphi = np.abs(np.angle(port["pll"].astype(np.complex128)
                           * np.conj(jax_["pll"])))
    h, (b, a) = _lmr_response()
    mixed = np.abs(jax_["delayed"]).astype(np.float64) * dphi
    return scipy.signal.lfilter(b, a, np.convolve(np.abs(h), mixed)
                                [:len(mixed)])


def _hold_stereo(port, jax_, pll):
    """vector: left and right within 2e-5 * scale.  pll: L+R within
    2e-5 * scale, left - right = 2 (L-R) within that plus twice the
    derived bound."""
    if not pll:
        _close(port["left"], jax_["left"])
        _close(port["right"], jax_["right"])
        return
    _close(port["left"] + port["right"], jax_["left"] + jax_["right"])
    lmr_p = port["left"] - port["right"]
    lmr_j = jax_["left"] - jax_["right"]
    scale = max(1.0, float(np.max(np.abs(lmr_j))))
    bound = 2e-5 * scale + 2 * pll_bound(port, jax_)
    assert np.all(np.abs(lmr_p - lmr_j) <= bound)


@pytest.mark.parametrize("pilot", ["vector", "pll"])
def test_stereo_demodulator_matches_jax(tmp_path, pilot):
    """In a graph, chunks of 8192 in both packages, the PLL's output and
    the delayed signal tapped for the derived bound."""
    x = stereo_mpx(1 << 15, RATE)
    path = str(tmp_path / "mpx.iq")
    x.view(np.float32).tofile(path)
    jax_ = _tapped_run(jl, path, pilot, 8192)
    port = _tapped_run(tl, path, pilot, 8192)
    assert len(port["left"]) == len(x)
    _hold_stereo(port, jax_, pilot == "pll")


@pytest.mark.parametrize("pilot", ["vector", "pll"])
def test_stereo_states_from_jax(pilot):
    """A stream started in the JAX package's stereo demodulator and
    resumed in the port: every leaf block's state carried over
    (interop.composite_states_from_jax), the next chunk against the JAX
    package's own next chunk, held as in the graph test."""
    n = 8192
    x = stereo_mpx(3 * n, RATE)
    jd = jl.WBFMStereoDemodulator(pilot=pilot)
    td = tl.WBFMStereoDemodulator(pilot=pilot)
    jleaves, tleaves = _leaves(jl, jd), _leaves(tl, td)
    jstates = {b: b.init_state() for b in jleaves[0]}
    for c in np.split(x[:2 * n], 2):
        _leaves_run(jl, jleaves, jstates, c)
    tstates = composite_states_from_jax(jd, td, jstates, device="cpu")
    jax_ = _leaves_run(jl, jleaves, jstates, x[2 * n:])
    port = _leaves_run(tl, tleaves, tstates, x[2 * n:])
    _hold_stereo(port, jax_, pilot == "pll")


def _leaves(mod, comp):
    """A stereo demodulator's leaf blocks set up by hand, in topological
    order, and the map of each input to the output feeding it."""
    leaves, edges = comp._flatten()
    src = {(id(d.block), d.index): (s.block, s.index)
           for d, s in edges.items()}
    order, done = [], set()
    while len(order) < len(leaves):
        for b in leaves:
            if id(b) not in done and all(
                    id(src[(id(b), i)][0]) in done
                    for i in range(len(b.inputs)) if (id(b), i) in src):
                order.append(b)
                done.add(id(b))
    for b in order:
        types = [src[(id(b), i)][0].get_output_type(src[(id(b), i)][1])
                 if (id(b), i) in src else mod.ComplexFloat32
                 for i in range(len(b.inputs))]
        _setup(mod, b, types)
    return order, src


def _leaves_run(mod, leaves, states, x):
    """One chunk through the leaf blocks (states updated in place);
    returns {left, right, delayed, pll} over the chunk."""
    order, src = leaves
    conv = jnp.asarray if mod is jl else torch.from_numpy
    vals, named = {}, {}
    for b in order:
        named.setdefault(type(b).__name__, []).append(b)
        ins = [vals[(id(src[(id(b), i)][0]), src[(id(b), i)][1])]
               if (id(b), i) in src else conv(x)
               for i in range(len(b.inputs))]
        process = jax.jit(b.process) if mod is jl else b.process
        states[b], ys = process(states[b], *ins)
        ys = ys if isinstance(ys, tuple) else (ys,)
        for oi, y in enumerate(ys):
            vals[(id(b), oi)] = y
    left, right = named["FMDeemphasisFilterBlock"]
    taps = {"left": left, "right": right, "delayed": named["DelayBlock"][0]}
    if "PLLBlock" in named:
        taps["pll"] = named["PLLBlock"][0]
    return {k: np.asarray(vals[(id(b), 0)]) for k, b in taps.items()}


# -- rx_wbfm through the CLI --------------------------------------------------

def _capture(tmp_path):
    """0.25 s of the stereo multiplex at the RTL-SDR rate, the station at
    baseband (test_applications.py:95-113)."""
    path = str(tmp_path / "st.iq")
    stereo_mpx(int(RX_RATE * 0.25), RX_RATE).view(np.float32).tofile(path)
    return path


def _record_port_tiers(monkeypatch):
    """The tier of every chunk the port's PLLBlocks run from now on."""
    from luaradio_tpu_torch.blocks.signal import carrier
    tiers, process = [], carrier.PLLBlock.process

    def recording(self, state, x):
        before = dict(self.tier_counts)
        out = process(self, state, x)
        tiers.extend(k for k in self.tier_counts
                     if self.tier_counts[k] != before[k])
        return out
    monkeypatch.setattr(carrier.PLLBlock, "process", recording)
    return tiers


def _read_wav(path):
    with wave.open(path) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
        return pcm.reshape(-1, w.getnchannels()).astype(np.int64), \
            w.getframerate()


def _tone_power(pcm, ch, freq):
    seg = slice(4096, 4096 + 4096)
    spec = np.abs(np.fft.rfft(pcm[seg, ch] / 32767.5 * np.hanning(4096)))
    idx = int(round(freq * 4096 / 44100))
    return spec[max(0, idx - 2):idx + 3].max()


@pytest.mark.parametrize("mono", [False, True])
def test_rx_wbfm_cli_matches_jax(tmp_path, monkeypatch, mono):
    """What test_applications.py:115-140 asserts (2 channels, > 8000
    frames, each channel's tone > 3x the other's), then the WAV against
    the JAX package's cli.main on the same file: mono within 2 LSB of 16
    bits (float32 differences of 2e-5 * scale, plus one rounding step
    either side); stereo L+R within 2 LSB, and L-R within 2 LSB plus the
    derived PLL bound in LSB."""
    cap = _capture(tmp_path)
    tiers = _record_port_tiers(monkeypatch)
    args = ["-a", "rx_wbfm", "-i", f"iqfile:{cap},rate={RX_RATE:.0f}"]
    extra = ["--mono"] if mono else []
    wavs = {k: str(tmp_path / f"{k}.wav") for k in ("jax", "port")}
    assert jax_main(args + ["-o", f"wavfile:{wavs['jax']}", "100e6"]
                    + extra) == 0
    assert port_main(args + ["-o", f"wavfile:{wavs['port']}", "100e6"]
                     + extra, device="cpu") == 0
    got, rate = _read_wav(wavs["port"])
    exp, _ = _read_wav(wavs["jax"])
    assert rate == 44100 and got.shape == exp.shape
    assert got.shape[1] == (1 if mono else 2) and len(got) > 8000
    if mono:
        assert np.max(np.abs(got - exp)) <= 2
        return
    assert _tone_power(got, 0, 1000) > 3 * _tone_power(got, 0, 400)
    assert _tone_power(got, 1, 400) > 3 * _tone_power(got, 1, 1000)
    assert np.max(np.abs(got.sum(1) - exp.sum(1))) <= 2
    # the PLL's gap: both demodulators over the IF stream the PLL sees
    # (the port's tuner output), each in one chunk; the CLIs' PLLs ran
    # their sequential tier on every chunk (asserted), which is chunk
    # invariant, so the taps see the CLIs' PLL trajectories
    assert tiers and set(tiers) == {3}, tiers
    if_path = str(tmp_path / "if.iq")
    tuned = _tuned(cap)
    tuned.view(np.float32).tofile(if_path)
    chunk = 1 << (len(tuned) - 1).bit_length()
    bound = pll_bound(_tapped_run(tl, if_path, "pll", chunk),
                      _tapped_run(jl, if_path, "pll", chunk))
    bound = 2 + 2 * 32767 * bound[::5][:len(got)]   # the AF downsampler
    d_lmr = (got[:, 0] - got[:, 1]) - (exp[:, 0] - exp[:, 1])
    assert np.all(np.abs(d_lmr) <= bound)


def _tuned(cap):
    top = tl.CompositeBlock()
    sink = _collector(tl, tl.ComplexFloat32)
    top.connect(tl.IQFileSource(cap, "f32le", RX_RATE),
                tl.TunerBlock(0, 200e3, 5), sink)
    top.run(device="cpu")
    return np.concatenate(sink.got)


def test_parse_spec_and_unknown_names():
    assert applications.parse_spec("iqfile:a.iq,s16le,rate=2e6,repeat=1") \
        == ("iqfile", ["a.iq", "s16le"], {"rate": "2e6", "repeat": "1"})
    assert applications.parse_spec("benchmark") == ("benchmark", [], {})
    with pytest.raises(ValueError, match="unknown application"):
        port_main(["-a", "rx_nope", "-i", "iqfile:x", "-o", "wavfile:y"],
                  device="cpu")
    with pytest.raises(ValueError, match="unsupported input 'rtlsdr'"):
        port_main(["-a", "rx_wbfm", "-i", "rtlsdr", "-o", "wavfile:y",
                   "100e6"], device="cpu")
    with pytest.raises(ValueError, match="unsupported output 'print'"):
        port_main(["-a", "rx_wbfm", "-i", "iqfile:x,rate=1e6", "-o",
                   "print", "100e6"], device="cpu")
    with pytest.raises(SystemExit):
        port_main(["-a", "rx_wbfm"])              # missing -i/-o
    assert sorted(applications.APPLICATIONS) == ["rx_wbfm"]
    assert sorted(applications.INPUTS) == ["iqfile"]
    assert sorted(applications.OUTPUTS) == ["benchmark", "iqfile",
                                            "wavfile"]


def test_cli_version_and_platform(capsys):
    assert port_main(["--version"]) == 0
    assert "luaradio_tpu_torch" in capsys.readouterr().out
    assert port_main(["--platform"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out and "cuda available" in out


def test_cli_runs_on_the_card_by_default(tmp_path):
    """Without device="cpu" the application asks for the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cap = str(tmp_path / "x.iq")
    np.zeros(2 * 4096, np.float32).tofile(cap)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["-a", "rx_wbfm", "-i", f"iqfile:{cap},rate=1102500",
                   "-o", f"wavfile:{tmp_path / 'y.wav'}", "100e6"])


def test_module_runs_as_a_script():
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-m", "luaradio_tpu_torch.cli",
                        "--version"], capture_output=True, text=True,
                       timeout=120, cwd=os.path.dirname(
                           os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0 and "luaradio_tpu_torch" in r.stdout
