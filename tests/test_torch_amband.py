"""The AM band configuration ``amband117_rtlsdr`` (radiobench/): its graph
(ChannelizerBlock -> AMSynchronousDemodulator) through the Runner at a
small size against the plain reference through the benchmark's
comparison, split at chunk boundaries two ways; each banked row against
the same channel run alone through the port's and the JAX package's
one-stream AMSynchronousDemodulator; planted faults reading false; the
reference's loop against reference/dsp.py's; the band generator; the
cell through the harness; and the readers of the PLL's span and row
counters (CPU).

The small size is the band's own 10 kHz channel grid cut to C = 13
channels (130 kS/s), so each channel runs at the configuration's 10 kS/s
with its loop constants; the capture is 8 192 channel samples, looped.

Tolerances: the graph's audio at the cell's own ``audio_gap`` limit
(radiobench/workloads/amband.replay.json); a banked row against its
one-stream run at 1e-6 of the row's full scale (the same tiers on the
same float32 inputs; torch's CPU kernels may round a batch's complex
products apart from one row's by an ulp); against the JAX package within
the bound tests/test_torch_am.py derives from the two runs' own PLL
phase gap (the JAX loop is another float32 implementation)."""

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

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.blocks.signal.carrier import PLLBlock  # noqa: E402
from luaradio_tpu_torch.blocks.signal.channelizer import \
    ChannelizerBlock  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402
from luaradio_tpu_torch.ops.pll_linear import pll_hybrid  # noqa: E402
from radiobench import harness, judge  # noqa: E402
from radiobench.players import amband  # noqa: E402
from radiobench.reference import dsp  # noqa: E402
from tests.test_torch_am import _run_graph, am_sync_bound  # noqa: E402

ROOT = REPO / "radiobench"
CFG = json.loads((ROOT / "configs" / "amband117_rtlsdr.json").read_text())
MIX = json.loads((ROOT / "traffic" / "amband_2p23.json").read_text())
LIMIT = json.loads((ROOT / "workloads" / "amband.replay.json").read_text()
                   )["limits"]["audio_gap"]
REF = harness.load_module(ROOT / "reference" / "amband117_rtlsdr.py")
GRAPH = harness.load_module(ROOT / "configs" / "amband117_rtlsdr.py")
SEED = 3000000027
C = 13
SMALL = dict(CFG, channels=C, rate=C * 10000)
PERIOD = 8192                     # channel samples in the looped capture
RATE = 10000.0                    # a channel's rate
CHUNKS = 3                        # chunks of the banked run


def _F(mod):
    return mod.Float32


class _Keep(tl.SinkBlock):
    def __init__(self, t=tl.Float32):
        super().__init__()
        self.got = []
        self.add_type_signature([tl.Input("in", t)], [])

    def process(self, y):
        self.got.append(np.array(y))


def _run(cfg, raw, per, chunks, taps=False):
    """The configuration's graph over the looped capture ``raw`` through
    the Runner, ``per`` channel samples a chunk: (audio chunks [C, 1,
    per], the channelizer's output [C, chunks per] if ``taps``, the PLL
    block)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "band.u8")
        raw.numpy().tofile(path)
        src = tl.IQFileSource(path, "u8", cfg["rate"], repeat_on_eof=True,
                              resident=True)
        sink = _Keep()
        top = GRAPH.build(cfg, src, sink)
        chan = None
        if taps:
            chan = _Keep(tl.ComplexFloat32)
            block = next(b for b in top._flatten()[0]
                         if isinstance(b, ChannelizerBlock))
            top.connect(block, "out", chan, "in")
        Runner(top, device="cpu", chunk_size=int(cfg["channels"]) * per
               ).run(max_chunks=chunks)
    pll = next(b for b in top._flatten()[0] if isinstance(b, PLLBlock))
    return ([y[:, None] for y in sink.got],
            np.concatenate(chan.got, -1) if taps else None, pll)


def _gap(cfg, raw, audio, per):
    """``audio_gap`` of the chunks from the second on (a run's window
    opens after warm chunks) against the reference."""
    ref = REF.audio(raw[None], cfg)
    kept = {c: y for c, y in enumerate(audio) if c >= 1}
    got, _ = judge.gaps(kept, ref, per)
    return got["audio_gap"]


@pytest.fixture(scope="module")
def capture():
    return amband.capture(SEED, C * PERIOD, SMALL, MIX["signal"], "cpu")


@pytest.fixture(scope="module")
def banked(capture):
    """The graph at 2 048 channel samples a chunk over one period, with
    the channelizer's output tapped and the PLL's row counters read."""
    scan0, k30 = pll_hybrid.scan_rows, pll_hybrid.k3_rows
    audio, chan, pll = _run(SMALL, capture, 2048, CHUNKS, taps=True)
    return {"audio": audio, "chan": chan, "tiers": dict(pll.tier_counts),
            "scan_rows": pll_hybrid.scan_rows - scan0,
            "k3_rows": pll_hybrid.k3_rows - k30}


@pytest.mark.parametrize("per", [2048, 4096])
def test_graph_matches_the_reference(capture, banked, per):
    """ChannelizerBlock(13, 16) -> AMSynchronousDemodulator(0, 4500) over
    the looped 13-channel band, at 2 048 and at 4 096 channel samples a
    chunk (the overlap scan in 8 and in 16 segments), every chunk after
    the first within the cell's limit; the reference's loop keeps its
    error 0.5 rad or more from pi after acquisition."""
    audio = banked["audio"] if per == 2048 else \
        _run(SMALL, capture, per, 2)[0]
    assert len(audio) >= 2
    assert _gap(SMALL, capture, audio, per) < LIMIT
    _, worst = REF.demodulate(capture[None], SMALL, settle=500)
    assert worst < math.pi - 0.5


def test_pll_leaves_the_linear_tier_and_counts_its_rows(banked):
    """Every channel's loop leaves the linear tier on every chunk (the
    frequency clamp binds in the noise), and ``pll_hybrid.scan_rows`` and
    ``k3_rows`` grew by what ``PLLBlock.tier_counts`` gives tiers 2 and
    3."""
    tiers = banked["tiers"]
    assert tiers[1] == 0 and tiers[2] + tiers[3] == CHUNKS * C
    assert banked["scan_rows"] == tiers[2]
    assert banked["k3_rows"] == tiers[3]


def _one_stream(mod, x, per):
    return _run_graph(mod, x, RATE, mod.AMSynchronousDemodulator(
        0.0, CFG["bandwidth"]), _F, per,
        taps=("PLLBlock", "ComplexBandpassFilterBlock"))


@pytest.mark.parametrize("row", range(C))
def test_banked_row_is_its_one_stream_run(banked, row):
    """Channel ``row`` of the bank equals the same channel (the
    channelizer's own output) run alone through the port's one-stream
    AMSynchronousDemodulator within 1e-6 of its full scale."""
    got = np.concatenate([y[row, 0] for y in banked["audio"]])
    port = _one_stream(tl, banked["chan"][row], 2048)
    scale = float(np.abs(port["out"]).max())
    assert np.abs(got - port["out"]).max() <= 1e-6 * scale


@pytest.mark.parametrize("row", [1, C - 1])
def test_banked_row_is_the_jax_one_stream_run(banked, row):
    """Channel ``row`` of the bank (one above the band's centre, one
    below) against the same channel run alone through the JAX package's
    one-stream AMSynchronousDemodulator (whose PLLBlock takes no batch),
    within the derived bound of the two runs' PLL phase gap."""
    x = banked["chan"][row]
    port = _one_stream(tl, x, 2048)
    jax_ = _one_stream(jl, x, 2048)
    bound = 2e-5 * max(1.0, float(np.max(np.abs(jax_["out"])))) \
        + am_sync_bound(port, jax_, RATE, CFG["bandwidth"])
    d = np.abs(port["out"].astype(np.float64) - jax_["out"])
    assert np.all(d <= bound), float(np.max(d - bound))


def _unconjugated(mp):
    mp.setattr(tl.MultiplyConjugateBlock, "process",
               lambda self, state, x, y: (state, x * y))


def _mirrored(mp):
    orig = ChannelizerBlock._channelize

    def mirrored(self, s, x):
        s, y = orig(self, s, x)
        idx = torch.remainder(-torch.arange(self.num_channels),
                              self.num_channels)
        return s, y[..., idx, :]
    mp.setattr(ChannelizerBlock, "_channelize", mirrored)


def _unclamped(mp):
    orig = PLLBlock.initialize

    def init(self):
        orig(self)
        self._freq_min, self._freq_max = np.float32(-3.0), np.float32(3.0)
    mp.setattr(PLLBlock, "initialize", init)


def _no_dc_block(mp):
    mp.setattr(tl.SinglepoleHighpassFilterBlock, "_design_ba",
               lambda self: (np.array([1.0, 0.0]), np.array([1.0, 0.0])))


@pytest.mark.parametrize("plant", [_unconjugated, _mirrored, _unclamped,
                                   _no_dc_block])
def test_planted_faults_read_false(plant):
    """The mixer not conjugating the PLL's oscillator, the channel order
    mirrored (c <-> C - c), the PLL's frequency clamp removed, or the DC
    block skipped: the audio leaves the limit (on 5 channels of the same
    grid)."""
    cfg = dict(CFG, channels=5, rate=50000)
    raw = amband.capture(SEED, 5 * PERIOD, cfg, MIX["signal"], "cpu")
    with pytest.MonkeyPatch.context() as mp:
        plant(mp)
        audio = _run(cfg, raw, 2048, 3)[0]
    assert _gap(cfg, raw, audio, 2048) > LIMIT


@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_reference_loop_walks_each_row_as_dsp_pll(capture, precision):
    """The reference's loop over all rows at once gives each row what
    reference/dsp.py ``pll`` (multiplier 1) gives it walked alone: bit
    for bit."""
    p = REF.plan(SMALL)
    x = dsp.wire_to_complex(capture[:2 * 13 * 600], "u8", precision)
    rows = torch.stack([dsp.fir(x, p["bandpass"], precision)[k::13]
                        for k in range(3)])
    osc, _ = REF.pll_rows(rows, p["loop"], precision)
    for k in range(3):
        want, _ = dsp.pll(rows[k], p["loop"], 1, precision)
        assert torch.equal(osc[k], want)


def test_band_generator():
    """Deterministic from the seed; every station closes at the wrap; a
    carrier within 20 Hz of every channel's frequency; the band's sum
    clear of the u8 rails; the plan's decimations."""
    sig = MIX["signal"]
    assert amband.seamless_length(MIX["capture_samples"], CFG) == 8388666
    cfg = dict(CFG)
    m = 117 * 32
    a = amband.capture(SEED, m, cfg, sig, "cpu")
    assert torch.equal(a, amband.capture(SEED, m, cfg, sig, "cpu"))
    assert not torch.equal(a, amband.capture(SEED + 1, m, cfg, sig, "cpu"))
    n = 117 * 1024
    a = amband.capture(SEED, n, cfg, sig, "cpu")
    v = a.to(torch.int32)
    assert 20 < int(v.min()) and int(v.max()) < 235
    offs = amband.offsets(cfg)
    assert offs[0] == 0 and offs[59] == -580e3 and offs[58] == 580e3
    idx = torch.tensor([0, n], dtype=torch.int64)
    for c in (0, 1, 58, 59, 116):
        x = amband.station(7 + c, n, cfg["rate"], offs[c], sig, idx)
        assert abs(complex(x[1] - x[0])) < 1e-12
    x = dsp.wire_to_complex(a, "u8", "float64").numpy()
    spec = np.abs(np.fft.fft(x))
    f = np.fft.fftfreq(n, 1 / cfg["rate"])
    res = cfg["rate"] / n
    for o in offs:
        near = np.abs(f - o) < 30.0
        peak = f[near][np.argmax(spec[near])]
        assert abs(peak - o) <= 20.0 + res
    d = REF.plan(cfg)
    assert (d["if_ds"], d["af_ds"], d["if_rate"]) == (117, 1, 10000.0)
    with pytest.raises(ValueError):
        amband.capture(SEED, n + 1, cfg, sig, "cpu")


def test_cell_runs_correct_through_the_harness():
    """amband.replay at C = 117 on a small capture (256 channel samples a
    chunk, where the overlap scan does not plan and K3's twin takes every
    row): correct, and ``bank_msps`` counts the wideband samples once."""
    ov = {"capture_samples": 117 * 512, "chunk_size": 117 * 256,
          "warm_chunks": 2, "keep_chunks": 3}
    seconds = 0.6
    res, rec = harness.run_cell("amband.replay", SEED, seconds, False,
                                device="cpu", overrides=ov)
    assert res["correct"], (res, rec)
    assert res["failed"] == 0 and rec["rows"] == 1
    assert res["checks"]["audio_gap"]["value"] < LIMIT
    assert res["checks"]["compared_chunks"]["value"] >= 2
    msps = res["metrics"]["bank_msps"]["value"]
    assert math.isclose(msps, rec["window_chunks"] * 117 * 256 / seconds
                        / 1e6)
    assert set(res["metrics"]) == {"bank_msps", "setup_s"}


def _ctx(spans, counters):
    part = {"seconds": 2.0, "spans": spans, "h2d": 0, "counters": counters}
    return {"cfg": CFG, "chunk_in": 7667712, "rows": 1, "traced": part}


def test_pll_readers():
    """``pll_ms.amband`` reads the PLL's device span a chunk and
    ``pll_slow_rows.amband`` the slow tiers' rows a chunk; each reads
    None without them (as on a program that has no such span, or before
    the counters), and the counters' paths resolve in the program."""
    ms = harness.load_module(ROOT / "metrics" / "pll_ms.amband.py")
    rows = harness.load_module(ROOT / "metrics" / "pll_slow_rows.amband.py")
    seg = {"segment[1].dispatch": {"count": 10, "total_s": 0.05}}
    assert ms.read(_ctx(seg, {})) is None
    assert ms.read(dict(_ctx(seg, {}), traced=None)) is None
    spans = dict(seg, **{"pll.device": {"count": 10, "total_s": 0.03}})
    assert math.isclose(ms.read(_ctx(spans, {})), 3.0)
    assert set(rows.COUNTERS) == {"scan_rows", "k3_rows"}
    for p in rows.COUNTERS.values():
        assert isinstance(harness.read_counter(p), int)
    assert rows.read(dict(_ctx(seg, {}), traced=None)) is None
    got = rows.read(_ctx(seg, {"scan_rows": 1150, "k3_rows": 20}))
    assert math.isclose(got, 117.0)


def test_multiplier_one_output_stays_on_the_vco():
    """The carrier loop at multiplier 1 on the overlap scan's tier, chunk
    after chunk: its output is the VCO it measured its error against,
    x / |x| exp(-j err), within float32 rounding on every sample, and the
    state's phi_m is phi_l (the scan's own chained output phasor walks
    ~1e-5 rad a 2^16-sample chunk off the VCO and never back)."""
    blk = PLLBlock(1000.0, -100.0, 100.0)
    blk.device = torch.device("cpu")
    blk.differentiate([tl.ComplexFloat32])
    blk.input_rate = RATE
    blk.initialize()
    rng = np.random.default_rng(5)
    n, rows = 16384, 2
    st = tuple(v.expand(rows).clone() for v in blk.init_state())
    for k in range(4):
        t = (k * n + np.arange(n)) / RATE
        env = 1 + 0.5 * np.cos(2 * np.pi * 440 * t) \
            + 0.3 * np.cos(2 * np.pi * 1234 * t)
        x = 0.02 * env * np.exp(1j * (2 * np.pi * np.array([[7.3], [-11.0]])
                                      * t + 0.4)) \
            + 5e-4 * (rng.standard_normal((rows, n))
                      + 1j * rng.standard_normal((rows, n)))
        x = torch.from_numpy(x.astype(np.complex64))
        st, (out, err) = blk.process(st, x)
        assert blk.row_tiers == [2, 2]
        assert torch.equal(st[0], st[1])
        vco = x / x.abs() * torch.polar(torch.ones_like(err), -err)
        assert float(torch.angle(out * vco.conj()).abs().max()) < 3e-7
