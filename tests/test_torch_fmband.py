"""The whole-band configuration ``fmband100_hackrf`` (radiobench/): the
port's ChannelizerBlock against the plain reference's channelizer by its
definition (shift, prototype lowpass, keep every C-th), the
configuration's graph through the Runner against the reference's audio
through the benchmark's comparison, planted faults reading false, the
cell through the harness on the CPU, the band generator, and the readers
of the channelizer's spans (CPU).

Tolerances: the channelizer at 1e-5 of the input's scale (float32 against
float64 over C q taps); the graph's audio at the cell's own ``audio_gap``
limit (radiobench/workloads/band100.replay.json)."""

import json
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.blocks.signal.channelizer import \
    ChannelizerBlock  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402
from radiobench import harness, judge  # noqa: E402
from radiobench.players import band  # noqa: E402
from radiobench.reference import dsp  # noqa: E402

ROOT = REPO / "radiobench"
CFG = json.loads((ROOT / "configs" / "fmband100_hackrf.json").read_text())
MIX = json.loads((ROOT / "traffic" / "band100_2p24.json").read_text())
LIMIT = json.loads((ROOT / "workloads" / "band100.replay.json").read_text()
                   )["limits"]["audio_gap"]
REF = harness.load_module(ROOT / "reference" / "fmband100_hackrf.py")
GRAPH = harness.load_module(ROOT / "configs" / "fmband100_hackrf.py")
SEED = 3000000023


def _small(channels=8):
    """The configuration at ``channels`` channels of the same 200 kHz grid
    (the rate cut with them)."""
    return dict(CFG, channels=channels, rate=channels * 200000)


def _block(c, q):
    b = ChannelizerBlock(c, q)
    b.device = torch.device("cpu")
    b.differentiate([tl.ComplexFloat32])
    b.input_rate = c * 200000.0
    b.initialize()
    return b


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("c", [8, 100])
def test_channelizer_matches_the_definition(c, split):
    """Channel c of the port's polyphase bank is the input shifted by
    -c rate / C, lowpassed by the C q-tap prototype and cut to every C-th
    sample, whole and split at chunk boundaries (its state carried)."""
    q = 16
    rng = np.random.default_rng(c)
    n = c * 96
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    blk = _block(c, q)
    st, got = blk.init_state(), []
    for part in (np.split(x, [c * 17, c * 50]) if split else [x]):
        st, y = blk.process(st, torch.from_numpy(part))
        got.append(y.numpy())
    got = np.concatenate(got, -1)
    p = REF.plan(dict(_small(c), taps_per_branch=q))
    xr = torch.from_numpy(x.astype(np.complex128))
    want = np.stack([REF.channel(xr, k, p, "float64").numpy()
                     for k in range(c)])
    assert got.shape == want.shape == (c, n // c)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(st.numpy(), x[-c * q:])


def _graph_gap(cfg, n=16000, chunk=4000, chunks=9):
    """The configuration's graph over a band capture of ``n`` samples
    (looped) through the Runner, against the reference: ``audio_gap``."""
    raw = band.capture(SEED, n, cfg, MIX["signal"], "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "band.s8")
        raw.numpy().tofile(path)

        class Keep(tl.SinkBlock):
            def __init__(self):
                super().__init__()
                self.got = []
                self.add_type_signature([tl.Input("in", tl.Float32)], [])

            def process(self, y):
                self.got.append(np.array(y)[:, None])
        sink = Keep()
        src = tl.IQFileSource(path, "s8", cfg["rate"], repeat_on_eof=True,
                              resident=True)
        Runner(GRAPH.build(cfg, src, sink), device="cpu",
               chunk_size=chunk).run(max_chunks=chunks)
    ref = REF.audio(raw[None], cfg)
    d = REF.plan(cfg)
    per = chunk // (d["if_ds"] * d["af_ds"])
    # from the second chunk, as a run's window opens after warm chunks:
    # the first holds the filters' start from zero history, where a phase
    # step near pi can take the other branch of atan2 in float32
    kept = {c: y for c, y in enumerate(sink.got) if c >= 1}
    got, _ = judge.gaps(kept, ref, per)
    return got["audio_gap"]


def test_graph_matches_the_reference():
    """ChannelizerBlock(8, 16) -> WBFMMonoDemodulator -> DownsamplerBlock(5)
    over a looped 8-channel band, every chunk within the cell's limit."""
    assert _graph_gap(_small()) < LIMIT


def _zeroed_state(mp):
    orig = ChannelizerBlock._channelize

    def zeroed(self, s, x):
        s, y = orig(self, s, x)
        return torch.zeros_like(s), y
    mp.setattr(ChannelizerBlock, "_channelize", zeroed)


def _mirrored(mp):
    orig = ChannelizerBlock._channelize

    def mirrored(self, s, x):
        s, y = orig(self, s, x)
        idx = torch.remainder(-torch.arange(self.num_channels),
                              self.num_channels)
        return s, y[..., idx, :]
    mp.setattr(ChannelizerBlock, "_channelize", mirrored)


def _branch_reversed(mp):
    orig = ChannelizerBlock.initialize

    def init(self):
        orig(self)
        self._branch[1] = self._branch[1].flip(-1)
    mp.setattr(ChannelizerBlock, "initialize", init)


@pytest.mark.parametrize("plant", [_zeroed_state, _mirrored,
                                   _branch_reversed])
def test_planted_channelizer_faults_read_false(plant):
    """The channelizer's state zeroed each chunk, the channel order
    mirrored (c <-> C - c), or one branch's taps reversed: the audio leaves
    the limit."""
    with pytest.MonkeyPatch.context() as mp:
        plant(mp)
        assert _graph_gap(_small()) > LIMIT


def test_cell_runs_correct_through_the_harness():
    """band100.replay at C = 100 on a small capture: correct, and
    ``bank_msps`` counts the wideband samples once (one input stream)."""
    ov = {"capture_samples": 40000, "chunk_size": 20000, "warm_chunks": 2,
          "keep_chunks": 4}
    seconds = 0.5
    res, rec = harness.run_cell("band100.replay", SEED, seconds, False,
                                device="cpu", overrides=ov)
    assert res["correct"], (res, rec)
    assert res["failed"] == 0 and rec["rows"] == 1
    assert res["checks"]["audio_gap"]["value"] < LIMIT
    assert res["checks"]["compared_chunks"]["value"] >= 2
    msps = res["metrics"]["bank_msps"]["value"]
    assert math.isclose(msps, rec["window_chunks"] * 20000 / seconds / 1e6)
    assert res["attempted"] == rec["window_chunks"]
    assert set(res["metrics"]) == {"bank_msps", "setup_s"}


def test_band_generator():
    """Deterministic from the seed; every station closes at the wrap; a
    station on every channel; no wire item at the rails."""
    sig = MIX["signal"]
    n = band.unit(CFG) * 2
    assert band.unit(CFG) == 20000
    assert round(MIX["capture_samples"] / band.unit(CFG)) * band.unit(
        CFG) == 16780000
    a = band.capture(SEED, n, CFG, sig, "cpu")
    assert torch.equal(a, band.capture(SEED, n, CFG, sig, "cpu"))
    assert not torch.equal(a, band.capture(SEED + 1, n, CFG, sig, "cpu"))
    assert int(a.abs().max()) < 127
    offs = band.offsets(CFG)
    assert offs[0] == 0 and offs[50] == -10e6 and offs[49] == 9.8e6
    idx = torch.tensor([0, n], dtype=torch.int64)
    from radiobench import synth
    for c in (0, 1, 49, 50, 99):
        x, _ = synth.baseband(synth.row_seed(SEED, c), n,
                              dict(CFG, tune_offset=-offs[c]), sig, "cpu",
                              idx)
        assert abs(complex(x[1] - x[0])) < 1e-9
    # the power in each channel's +-75 kHz, against the noise between
    x = dsp.wire_to_complex(a, "s8", "float64").numpy()
    spec = np.abs(np.fft.fft(x)) ** 2
    f = np.fft.fftfreq(n, 1 / CFG["rate"])
    power = np.array([spec[np.abs(f - o) < 75e3].sum() for o in offs])
    assert power.min() > 0.3 * power.mean()
    with pytest.raises(ValueError):
        band.capture(SEED, n + 100, CFG, sig, "cpu")


def _ctx(spans):
    part = {"seconds": 2.0, "spans": spans, "h2d": 0, "counters": {}}
    peaks = json.loads((ROOT / "peaks.json").read_text())
    return {"cfg": CFG, "chunk_in": 8192000, "rows": 1, "traced": part,
            "peaks": peaks["NVIDIA H100 80GB HBM3"]}


@pytest.mark.parametrize("name", ["channelizer_ms.band",
                                  "channelizer_roofline.band"])
def test_channelizer_readers(name):
    """A number from the channelizer's device span, None without it (as
    on a program that has no such span)."""
    mod = harness.load_module(ROOT / "metrics" / f"{name}.py")
    seg = {"segment[1].dispatch": {"count": 10, "total_s": 0.05}}
    assert mod.read(_ctx(seg)) is None
    assert mod.read(dict(_ctx(seg), traced=None)) is None
    spans = dict(seg, **{"channelizer.device": {"count": 10,
                                                "total_s": 0.025}})
    v = mod.read(_ctx(spans))
    assert isinstance(v, float) and math.isfinite(v) and v > 0
    if name == "channelizer_ms.band":
        assert math.isclose(v, 2.5)
    else:
        # 16 B a sample at 3.35 TB/s over 2.5 ms a chunk
        assert math.isclose(v, 100 * 8192000 * 16 / 3.35e12 / 2.5e-3)
