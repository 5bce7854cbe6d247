"""The four example modules added last to the port
(luaradio_tpu_torch/examples/), each against the JAX package's example on
the same input, on the CPU:

* iqfile_converter: the output file's bytes equal the JAX example's, from
  and to u8, s16le and f32le;
* iqfile_wbfm_stereo: over 0.25 s of a stereo station 250 kHz up, the WAV
  as tests/test_torch_stereo.py holds rx_wbfm's against the JAX CLI: L+R
  within 2 LSB, L-R within 2 LSB plus the derived PLL bound, each
  channel's tone > 3x the other's;
* channel_bank_pod: its bank's audio against the JAX ``WBFMMonoBank`` on a
  (1, 1) mesh over the same draws, within 2e-5 * scale;
* wideband_channelizer_bank: its graph against the JAX module's over a
  shortened synthesized capture, within 2e-5 * scale.
"""

import importlib.util
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.parallel.wbfm import WBFMMonoBank  # noqa: E402
from luaradio_tpu_torch.examples import (channel_bank_pod,  # noqa: E402
                                         iqfile_converter,
                                         iqfile_wbfm_stereo,
                                         wideband_channelizer_bank)
from tests.test_torch_stereo import (RX_RATE, _read_wav,  # noqa: E402
                                     _record_port_tiers, _tapped_run,
                                     _tone_power, pll_bound, stereo_mpx)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def _close(got, exp, tol=2e-5):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    scale = max(1.0, float(np.max(np.abs(exp))))
    err = float(np.max(np.abs(got.astype(np.float64) - exp)))
    assert err < tol * scale, (err, tol * scale)


def _run_jax_example(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [str(EXAMPLES / name)] + argv)
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")


WIRE = {"u8": lambda r, n: r.integers(0, 256, n).astype(np.uint8),
        "s16le": lambda r, n: r.integers(-32768, 32768, n).astype("<i2"),
        "f32le": lambda r, n: r.standard_normal(n).astype("<f4")}


@pytest.mark.parametrize("fmt", sorted(WIRE))
def test_iqfile_converter_matches_jax(tmp_path, monkeypatch, fmt):
    """fmt -> f32le (s16le for f32le) and f32le -> fmt."""
    rng = np.random.default_rng(5)
    src = tmp_path / f"in.{fmt}"
    WIRE[fmt](rng, 4096).tofile(src)
    f32 = tmp_path / "in.f32le"
    WIRE["f32le"](rng, 4096).tofile(f32)
    for i, (inp, ifmt, ofmt) in enumerate(
            [(src, fmt, "f32le" if fmt != "f32le" else "s16le"),
             (f32, "f32le", fmt)]):
        outs = {k: tmp_path / f"out{i}.{k}" for k in ("jax", "port")}
        _run_jax_example("iqfile_converter.py",
                         [str(inp), ifmt, str(outs["jax"]), ofmt],
                         monkeypatch)
        assert iqfile_converter.main([str(inp), ifmt, str(outs["port"]),
                                      ofmt, "--cpu"]) == 0
        port, jax_ = outs["port"].read_bytes(), outs["jax"].read_bytes()
        assert len(port) > 0 and port == jax_


def test_iqfile_converter_usage():
    assert iqfile_converter.main(["a", "u8", "--cpu"]) == 1


def test_iqfile_wbfm_stereo_matches_jax(tmp_path, monkeypatch):
    n = int(RX_RATE * 0.25)
    z = stereo_mpx(n, RX_RATE) * np.exp(
        2j * np.pi * 250e3 / RX_RATE * np.arange(n))
    cap = tmp_path / "cap.iq"
    z.astype(np.complex64).tofile(cap)
    wavs = {k: str(tmp_path / f"{k}.wav") for k in ("jax", "port")}
    tiers = _record_port_tiers(monkeypatch)
    _run_jax_example("iqfile_wbfm_stereo.py", [str(cap), wavs["jax"]],
                     monkeypatch)
    assert iqfile_wbfm_stereo.main([str(cap), wavs["port"], "--cpu"]) == 0
    got, rate = _read_wav(wavs["port"])
    exp, _ = _read_wav(wavs["jax"])
    assert rate == 44100 and got.shape == exp.shape
    assert got.shape[1] == 2 and len(got) > 8000
    assert _tone_power(got, 0, 1000) > 3 * _tone_power(got, 0, 400)
    assert _tone_power(got, 1, 400) > 3 * _tone_power(got, 1, 1000)
    assert np.max(np.abs(got.sum(1) - exp.sum(1))) <= 2
    # L-R: the PLL's gap, from both demodulators over the IF stream the
    # example's tuner gives (the sequential tier on every chunk: chunk
    # invariant), as tests/test_torch_stereo.py derives it
    assert tiers and set(tiers) == {3}, tiers
    top = tl.CompositeBlock()
    sink = _IFSink()
    top.connect(tl.IQFileSource(str(cap), "f32le", RX_RATE),
                tl.TunerBlock(-250e3, 200e3, 5), sink)
    top.run(device="cpu")
    tuned = np.concatenate(sink.got)
    if_path = str(tmp_path / "if.iq")
    tuned.astype(np.complex64).tofile(if_path)
    chunk = 1 << (len(tuned) - 1).bit_length()
    bound = pll_bound(_tapped_run(tl, if_path, "pll", chunk),
                      _tapped_run(jl, if_path, "pll", chunk))
    bound = 2 + 2 * 32767 * bound[::5][:len(got)]
    d_lmr = (got[:, 0] - got[:, 1]) - (exp[:, 0] - exp[:, 1])
    assert np.all(np.abs(d_lmr) <= bound)


class _IFSink(tl.SinkBlock):
    def __init__(self):
        super().__init__()
        self.got = []
        self.add_type_signature([tl.Input("in", tl.ComplexFloat32)], [])

    def process(self, x):
        self.got.append(np.array(x))


def test_channel_bank_pod_matches_the_jax_bank():
    """The example's bank (one shard: a (1, 1) mesh) over 2 chunks of 4
    channels x 4096 against the JAX example's bank class on a (1, 1) mesh
    fed the same numpy draws."""
    lines = []
    got = channel_bank_pod.run(1, "cpu", n_channels=4, chunks=2, chunk=4096,
                               emit=lines.append)
    assert len(lines) == 2 and "(4, 512)" in lines[0]
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("channel", "time"))
    bank = WBFMMonoBank(mesh, if_rate=256e3, decimation=8)
    state, step = bank.init_state(4), bank.jit_step()
    rng = np.random.default_rng(0)
    for audio in got:
        iq = (rng.standard_normal((4, 4096))
              + 1j * rng.standard_normal((4, 4096))).astype(np.complex64)
        x = jax.device_put(jnp.asarray(iq),
                           NamedSharding(mesh, P("channel", "time")))
        state, exp = step(state, x)
        _close(audio.numpy(), np.asarray(exp))
    _, chunk = channel_bank_pod.build(4, "cpu")
    assert chunk == 2 * 8 * 4096


def test_wideband_channelizer_example_matches_the_jax_module(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_wideband_example", EXAMPLES / "wideband_channelizer_bank.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    path = str(tmp_path / "wideband.iq")
    wideband_channelizer_bank.synth_capture(path, n=1 << 16)
    other = str(tmp_path / "wideband_jax.iq")
    jmod.synth_capture(other, n=1 << 16)
    assert pathlib.Path(path).read_bytes() == pathlib.Path(other).read_bytes()
    got = wideband_channelizer_bank.run(path, device="cpu")
    top, sink = jl.CompositeBlock(), jmod.AudioBankSink()
    top.connect(jl.IQFileSource(path, "f32le", 4.096e6),
                jl.ChannelizerBlock(16, taps_per_branch=8),
                jl.WBFMMonoDemodulator(), jl.DownsamplerBlock(2), sink)
    top.run(chunk_size=16 * 16384)
    exp = np.concatenate(sink.chunks, axis=-1)
    assert got.shape == (16, (1 << 16) // 16 // 2)
    _close(got, exp)
