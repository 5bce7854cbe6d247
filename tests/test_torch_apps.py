"""The analog applications through the port's cli.main(..., device="cpu")
against the JAX package's cli.main on the same file: rx_am (envelope and
synchronous), rx_nbfm, rx_ssb (usb, lsb), rx_raw (with and without a tune
offset) and iq_converter.

WAVs are held within 2 LSB of 16 bits (float32 differences of 2e-5 *
scale, plus one rounding step either side), widened only where a stage
of the receiver is known to magnify rounding, and then by a bound read off
the two runs themselves.  Each such bound comes from a graph built by hand
as the application builds it, with sinks on the stage's inputs; the JAX
package's hand-built graph is first held to its own CLI's WAV (1 LSB), so
the taps see what the CLIs ran.

- rx_nbfm: the discriminator's angle jumps by 2 pi where its product lies
  within rounding of the negative real axis, so the audio may differ by
  the AF lowpass's response to the two discriminators' difference, which
  is held first (tests/test_torch_am.py hold_discriminators).
- rx_am: the AGC's gain sums target/power from the moment the power
  estimate crosses the threshold, while the power is tiny, so it magnifies
  the relative error of the stream's first samples for seconds after.
  Its input is held first (2e-5 * scale; --synchronous: plus the PLL
  bound of tests/test_torch_am.py), then the WAVs within 2 LSB plus the
  difference the JAX package's own AGC makes between the two inputs.
"""

import wave

import numpy as np
import pytest
import scipy.signal
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.cli import main as jax_main  # noqa: E402
from luaradio_tpu_torch.cli import main as port_main  # noqa: E402
from luaradio_tpu_torch.utils import format as format_utils  # noqa: E402
from tests.test_torch_am import (am_sync_bound,  # noqa: E402
                                 hold_discriminators)

RATE = 1102500
SCALE = 32767.5          # the WAV sink's float -> int16 scale


def _capture(tmp_path, kind, seconds=0.2, noise_s=0.04):
    """f32le I/Q at RATE, the station at the tuned frequency (baseband):
    ``noise_s`` of noise first (a receiver tuned before the station comes
    up), then the signal with the noise under it at ~30 dB SNR."""
    rng = np.random.default_rng(len(kind))
    n, n0 = int(RATE * seconds), int(RATE * noise_s)
    t = np.arange(n) / RATE
    if kind == "am":
        z = (1 + 0.5 * np.sin(2 * np.pi * 1000 * t)) * np.exp(1j * 0.7)
    elif kind == "nbfm":
        z = np.exp(2j * np.pi * 5e3 * np.cumsum(
            0.8 * np.sin(2 * np.pi * 700 * t)) / RATE)
    else:   # usb: a 1.2 kHz tone above the carrier
        z = 0.5 * np.exp(2j * np.pi * 1.2e3 * t)
    z[:n0] = 0
    z = z + 0.03 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    path = str(tmp_path / f"{kind}.iq")
    z.astype(np.complex64).view(np.float32).tofile(path)
    return path


def _read_wav(path):
    with wave.open(path) as w:
        assert w.getframerate() == 44100 and w.getnchannels() == 1
        return np.frombuffer(w.readframes(w.getnframes()),
                             np.int16).astype(np.int64)


def _clis(tmp_path, app, cap, *args):
    """The application through both packages' cli.main; the two WAVs."""
    spec = ["-a", app, "-i", f"iqfile:{cap},rate={RATE}"]
    wavs = {k: str(tmp_path / f"{k}.wav") for k in ("jax", "port")}
    assert jax_main(spec + ["-o", f"wavfile:{wavs['jax']}", *args]) == 0
    assert port_main(spec + ["-o", f"wavfile:{wavs['port']}", *args],
                     device="cpu") == 0
    got, exp = _read_wav(wavs["port"]), _read_wav(wavs["jax"])
    assert got.shape == exp.shape and len(got) > 8000
    return got, exp


def _collector(mod):
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature([mod.Input("in", lambda t: True)], [])

        def process(self, x):
            self.got.append(np.array(x))
    return Collect()


def _tapped(mod, app, cap):
    """The application's graph built by hand (apps.py), with sinks on
    "out" (the WAV's samples) and on the inputs of the stages that
    magnify rounding."""
    top = mod.CompositeBlock()
    src = mod.IQFileSource(cap, "f32le", RATE)
    taps = {}
    if app == "rx_nbfm":
        demod = mod.NBFMDemodulator(5e3, 4e3)
        top.connect(src, mod.TunerBlock(0.0, 18e3, 25), demod)
        last = demod
        taps["rf"] = demod._blocks[0]
        taps["disc"] = demod._blocks[1]
    else:
        agc = mod.AGCBlock("slow")
        if app == "rx_am":
            demod = mod.AMEnvelopeDemodulator(5e3)
            top.connect(src, mod.TunerBlock(0.0, 10e3, 25), demod, agc)
            taps["agc_in"] = demod
        else:
            demod = mod.AMSynchronousDemodulator(0.0, 5e3)
            ds = mod.DownsamplerBlock(5)
            top.connect(src, mod.DecimatorBlock(5), demod, ds, agc)
            taps["agc_in"] = ds
            for b in demod._blocks:
                if isinstance(b, (mod.PLLBlock,
                                  mod.ComplexBandpassFilterBlock)):
                    taps[type(b).__name__] = b
        last = agc
    taps["out"] = last
    sinks = {k: _collector(mod) for k in taps}
    for k, b in taps.items():
        top.connect(b, "out", sinks[k], "in")
    top.run(**({"device": "cpu"} if mod is tl else {}))
    return {k: np.concatenate(s.got) for k, s in sinks.items()}


def _jax_agc(x):
    blk = jl.AGCBlock("slow")
    blk.differentiate([jl.Float32])
    blk.input_rate = 44100.0
    blk.initialize()
    return np.asarray(jax.jit(blk.process)(blk.init_state(),
                                           jnp.asarray(x))[1])


def _pcm(x):
    """The WAV sink's 16-bit samples of a float stream."""
    return np.clip(np.round(x.astype(np.float64) * SCALE), -32768, 32767)


def _hold_close(d, limit):
    assert np.all(d <= limit), (float(np.max(d - limit)),
                                int(np.argmax(d - limit)))


@pytest.mark.parametrize("synchronous", [False, True])
def test_rx_am_cli_matches_jax(tmp_path, synchronous):
    cap = _capture(tmp_path, "am")
    app = "rx_am_sync" if synchronous else "rx_am"
    got, exp = _clis(tmp_path, "rx_am", cap, "0",
                     *(["--synchronous"] if synchronous else []))
    jax_ = _tapped(jl, app, cap)
    port = _tapped(tl, app, cap)
    _hold_close(np.abs(_pcm(jax_["out"]) - exp), 1)
    # the AGC's input
    x_p, x_j = port["agc_in"], jax_["agc_in"]
    bound = np.full(len(x_j), 2e-5 * max(1.0, float(np.max(np.abs(x_j)))))
    if synchronous:
        taps = ("PLLBlock", "ComplexBandpassFilterBlock")
        bound += am_sync_bound({k: port[k] for k in taps},
                               {k: jax_[k] for k in taps}, 220500.0)[::5]
    _hold_close(np.abs(x_p.astype(np.float64) - x_j), bound)
    # the WAV: 2 LSB plus what the reference's AGC makes of the two inputs
    spread = np.abs(_jax_agc(x_p).astype(np.float64) - _jax_agc(x_j))
    _hold_close(np.abs(got - exp), 2 + SCALE * spread)


def test_rx_nbfm_cli_matches_jax(tmp_path):
    cap = _capture(tmp_path, "nbfm")
    got, exp = _clis(tmp_path, "rx_nbfm", cap, "0")
    jax_ = _tapped(jl, "rx_nbfm", cap)
    port = _tapped(tl, "rx_nbfm", cap)
    _hold_close(np.abs(_pcm(jax_["out"]) - exp), 1)
    dd = np.abs(hold_discriminators(port["rf"], jax_["rf"], port["disc"],
                                    jax_["disc"], 1.25))
    lpf = tl.LowpassFilterBlock(128, 4e3)
    lpf.input_rate = 44100.0
    af = scipy.signal.fftconvolve(np.abs(lpf.design_taps()), dd)[:len(dd)]
    _hold_close(np.abs(got - exp), 2 + SCALE * af)


@pytest.mark.parametrize("sideband", ["usb", "lsb"])
def test_rx_ssb_cli_matches_jax(tmp_path, sideband):
    """A tone 1.2 kHz above the carrier: usb passes it, lsb rejects it."""
    cap = _capture(tmp_path, "usb")
    got, exp = _clis(tmp_path, "rx_ssb", cap, "0", sideband)
    assert np.max(np.abs(got - exp)) <= 2
    power = np.mean(got[len(got) // 2:].astype(np.float64) ** 2)
    if sideband == "usb":
        assert power > 1e4
    else:
        assert power < 1e4


def _read_iq(path, fmt):
    with open(path, "rb") as f:
        return format_utils.bytes_to_complex(f.read(),
                                             format_utils.get_format(fmt))


@pytest.mark.parametrize("offset", [None, "-25e3"])
def test_rx_raw_cli_matches_jax(tmp_path, offset):
    """Without a tune offset the IQ file is copied: exactly.  With one,
    the frequency translator's output within 2e-5 * scale."""
    cap = _capture(tmp_path, "am", seconds=0.1)
    outs = {}
    for name, main, kw in (("jax", jax_main, {}),
                           ("port", port_main, {"device": "cpu"})):
        out = str(tmp_path / f"{name}.iq")
        argv = ["-a", "rx_raw", "-i", f"iqfile:{cap}", "-o",
                f"iqfile:{out}", "100e6", f"{RATE}"]
        if offset is not None:
            argv += ["--tune-offset", offset]
        assert main(argv, **kw) == 0
        outs[name] = _read_iq(out, "f32le")
    src = _read_iq(cap, "f32le")
    got, exp = outs["port"], outs["jax"]
    assert got.shape == exp.shape == src.shape
    if offset is None:
        assert np.array_equal(got, src) and np.array_equal(exp, src)
    else:
        assert np.max(np.abs(got - exp)) < 2e-5 * max(
            1.0, float(np.max(np.abs(exp))))
        t = np.arange(len(src)) / RATE
        host = src * np.exp(2j * np.pi * float(offset) * t)
        assert np.max(np.abs(got - host)) < 1e-5


def test_iq_converter_cli_matches_host(tmp_path):
    """u8 -> f32: the port's output equals the host conversion of the same
    bytes exactly, and the JAX package's output."""
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, 2 * 30000).astype(np.uint8)
    cap = str(tmp_path / "in.u8")
    raw.tofile(cap)
    outs = {}
    for name, main, kw in (("jax", jax_main, {}),
                           ("port", port_main, {"device": "cpu"})):
        out = str(tmp_path / f"{name}.f32")
        assert main(["-a", "iq_converter", "-i", f"iqfile:{cap},u8,"
                     f"rate=1e6", "-o", f"iqfile:{out},f32le"], **kw) == 0
        outs[name] = _read_iq(out, "f32le")
    host = format_utils.bytes_to_complex(raw.tobytes(),
                                         format_utils.get_format("u8"))
    assert outs["port"].shape == host.shape == (30000,)
    assert np.array_equal(outs["port"], host)
    assert np.array_equal(outs["port"], outs["jax"])


def test_rx_ssb_rejects_an_unknown_sideband():
    with pytest.raises(ValueError, match="sideband"):
        port_main(["-a", "rx_ssb", "-i", "iqfile:x,rate=1e6", "-o",
                   "wavfile:y", "0", "dsb"], device="cpu")


@pytest.mark.parametrize("app,args", [
    ("rx_am", ["0"]), ("rx_am", ["0", "--synchronous"]), ("rx_nbfm", ["0"]),
    ("rx_ssb", ["0", "usb"]), ("rx_raw", ["100e6", f"{RATE}"]),
    ("iq_converter", [])])
def test_new_applications_run_on_the_card_by_default(tmp_path, app, args):
    """Without device="cpu" each application asks for the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cap = str(tmp_path / "x.iq")
    np.zeros(2 * 4096, np.float32).tofile(cap)
    out = "iqfile" if app in ("rx_raw", "iq_converter") else "wavfile"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["-a", app, "-i", f"iqfile:{cap},rate={RATE}", "-o",
                   f"{out}:{tmp_path / 'y'}", *args])
