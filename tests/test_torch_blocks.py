"""Each main-path block of the port against its JAX block on the same
numpy input: whole, split into chunks, and resumed from the JAX block's
carried state (luaradio_tpu_torch/interop.py)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.interop import block_state_from_jax  # noqa: E402

RATE = 220500.0
N = 5120  # a multiple of the decimations and of the JAX FFT frame


def _signal(seed, n=N, complex_=True):
    rng = np.random.default_rng(seed)
    if not complex_:
        return (0.3 * rng.standard_normal(n)).astype(np.float32)
    ph = np.cumsum(0.4 * rng.standard_normal(n))
    z = np.exp(1j * ph) + 0.05 * (rng.standard_normal(n)
                                  + 1j * rng.standard_normal(n))
    return z.astype(np.complex64)


def _lpf_taps(k=128):
    from luaradio_tpu_torch.utils.filter_design import firwin_lowpass
    return firwin_lowpass(k, 0.2)


def _disc_fir_taps():
    from luaradio_tpu_torch.ops.fir import combine_taps, iir_to_fir_taps
    from luaradio_tpu_torch.blocks.signal.filtering import \
        _singlepole_lowpass_coeffs
    b, a = _singlepole_lowpass_coeffs(1 / (2 * np.pi * 75e-6), RATE)
    return combine_taps(_lpf_taps(), iir_to_fir_taps(b, a, tol=1e-10))


# name -> (JAX block factory, port block factory, complex input, chunks)
SPECS = {
    "translator": (lambda m: m.FrequencyTranslatorBlock(-50e3), True),
    "discriminator": (lambda m: m.FrequencyDiscriminatorBlock(1.25), True),
    "fir_complex": (lambda m: m.FIRFilterBlock(_lpf_taps()), True),
    "fir_real": (lambda m: m.FIRFilterBlock(_lpf_taps(33)), False),
    "lowpass": (lambda m: m.LowpassFilterBlock(128, 15e3), False),
    "iir": (lambda m: m.IIRFilterBlock([0.2, 0.1], [1.0, -0.7]), False),
    "iir_complex": (lambda m: m.IIRFilterBlock([0.5], [1.0, -0.9]), True),
    "deemphasis": (lambda m: m.FMDeemphasisFilterBlock(75e-6), False),
    "decim_fir_complex": (lambda m: m.DecimatingFIRBlock(_lpf_taps(), 5),
                          True),
    "decim_fir_real": (lambda m: m.DecimatingFIRBlock(_disc_fir_taps(), 5),
                       False),
    "downsampler": (lambda m: m.DownsamplerBlock(5), True),
    "disc_fir": (lambda m: m.DiscriminatorDecimatingFIRBlock(
        _disc_fir_taps(), 5, 1.25), True),
}


def _jax_mod(name):
    if name == "disc_fir":
        from luaradio_tpu.blocks.signal import modem
        return modem
    return jl


def _port_mod(name):
    if name == "disc_fir":
        from luaradio_tpu_torch.blocks.signal import modem
        return modem
    return tl


def _setup(block, complex_, device=None):
    t = jl.ComplexFloat32 if complex_ else jl.Float32
    if device is not None:
        t = tl.ComplexFloat32 if complex_ else tl.Float32
        block.device = torch.device(device)
    block.differentiate([t])
    block.input_rate = RATE
    block.initialize()
    return block


def _run_jax(name, x, chunks, state=None, ret_state=False):
    factory, complex_ = SPECS[name]
    blk = _setup(factory(_jax_mod(name)), complex_)
    st = blk.init_state() if state is None else state
    process = jax.jit(blk.process)
    outs = []
    for c in np.split(x, chunks):
        st, y = process(st, jnp.asarray(c))
        outs.append(np.asarray(y))
    y = np.concatenate(outs)
    return (y, st) if ret_state else y


def _run_port(name, x, chunks, state=None):
    factory, complex_ = SPECS[name]
    blk = _setup(factory(_port_mod(name)), complex_, "cpu")
    st = blk.init_state() if state is None else state
    outs = []
    for c in np.split(x, chunks):
        st, y = blk.process(st, torch.from_numpy(np.ascontiguousarray(c)))
        outs.append(y.numpy())
    return np.concatenate(outs)


def _close(got, exp, tol=2e-5):
    assert got.shape == exp.shape and got.dtype == exp.dtype
    scale = max(1.0, float(np.max(np.abs(exp))))
    assert np.max(np.abs(got - exp)) < tol * scale


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_block_matches_jax(name, chunks):
    x = _signal(hash(name) % 1000, complex_=SPECS[name][1])
    exp = _run_jax(name, x, 1)
    _close(_run_port(name, x, chunks), exp)


@pytest.mark.parametrize("name", sorted(set(SPECS) - {"fir_complex",
                                                      "fir_real",
                                                      "lowpass"}))
def test_block_resumes_from_jax_state(name):
    """Two chunks in JAX, the state carried over, the third in the port.
    (The JAX FIR blocks above 16 taps carry an FFT overlap-save state,
    which has no counterpart in the port: they are held by the test
    above.)"""
    x = _signal(7, n=3 * N, complex_=SPECS[name][1])
    first, third = x[:2 * N], x[2 * N:]
    _, st = _run_jax(name, first, 2, ret_state=True)
    exp = _run_jax(name, third, 1, state=st)
    got = _run_port(name, third, 1,
                    state=block_state_from_jax(st, device="cpu"))
    _close(got, exp)


def test_iir_above_first_order_is_refused():
    blk = tl.IIRFilterBlock([1.0], [1.0, -0.5, 0.1])
    with pytest.raises(NotImplementedError, match="order 2"):
        _setup(blk, False, "cpu")


def _graph(mod, src_path, composite, sink_cls):
    top = mod.CompositeBlock()
    top.connect(mod.IQFileSource(src_path, "f32le", 1102500), composite,
                sink_cls())
    return top


def _collector(mod, t):
    class Collect(mod.SinkBlock):
        got = []

        def __init__(self):
            super().__init__()
            self.add_type_signature([mod.Input("in", t)], [])
            Collect.got = []

        def process(self, x):
            Collect.got.append(np.asarray(x))
    return Collect


@pytest.mark.parametrize("which", ["tuner", "wbfm_mono"])
@pytest.mark.parametrize("optimize", [False, True])
def test_composite_matches_jax(tmp_path, which, optimize):
    """TunerBlock and WBFMMonoDemodulator in a graph, in both packages."""
    rate = 1102500
    n = 1 << 15
    t = np.arange(n) / rate
    z = np.exp(2j * np.pi * np.cumsum(100e3 + 40e3 * np.cos(
        2 * np.pi * 3e3 * t)) / rate).astype(np.complex64)
    p = str(tmp_path / "x.iq")
    z.view(np.float32).tofile(p)
    outs = {}
    for name, mod in (("jax", jl), ("port", tl)):
        if which == "tuner":
            comp = mod.TunerBlock(-100e3, 200e3, 5)
            sink = _collector(mod, mod.ComplexFloat32)
        else:
            comp = mod.WBFMMonoDemodulator()
            sink = _collector(mod, mod.Float32)
        top = _graph(mod, p, comp, sink)
        kw = {"device": "cpu"} if name == "port" else {}
        top.run(chunk_size=1 << 13, optimize=optimize, **kw)
        outs[name] = np.concatenate(sink.got)
    _close(outs["port"], outs["jax"])
