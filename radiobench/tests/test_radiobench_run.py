"""Whole runs of each cell on the CPU at a small size, the control, and the
faults that ``correct`` has to catch (CPU; ~2 min).

    python -m pytest radiobench/tests -q

The harness's look for a card is skipped (``run_cell(device="cpu")``) and
everything else of a run is driven: the inputs, the window, the sink, the
comparison and the result line.  The faults are planted under the timed
path, in the program's blocks, by monkeypatching.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from radiobench import control, harness  # noqa: E402
from radiobench.fakes import hackrf  # noqa: E402

torch.set_num_threads(1)

SMALL = {
    "mono.replay": {"capture_samples": 120000, "chunk_size": 20000,
                    "warm_chunks": 3},
    "stereo.replay": {"capture_samples": 300000, "chunk_size": 52000,
                      "warm_chunks": 3},
    "mono.bank64": {"capture_samples": 50000, "chunk_size": 10000,
                    "rows": 4, "warm_chunks": 2, "keep_chunks": 6},
    "stereo.live": {"capture_samples": 300000, "chunk_size": 52000,
                    "warm_chunks": 3, "prewarm_chunks": 2,
                    "transfer_bytes": 26000},
}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}

#: the closed-loop replay cells, measured and left out of BENCHMARK.json
#: (PERF.md), as a later change would add them back: entries only
LEFT_OUT = {
    "workloads": [
        {"name": "mono.replay", "config": "wbfm_mono_rtlsdr",
         "traffic": "replay_2p24", "chips": 1},
        {"name": "stereo.replay", "config": "wbfm_stereo_hackrf",
         "traffic": "replay_2p25", "chips": 1}],
    "end_to_end": [
        {"name": "replay_msps", "unit": "MS/s", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["mono.replay", "stereo.replay"]}],
    "per_layer": [
        {"name": f"{m}.replay", "unit": u, "better": "lower",
         "source": "program_span", "layer": "-", "moves": "replay_msps",
         "workloads": cells}
        for m, u, cells in (
            ("ingest_wait", "%", ["mono.replay", "stereo.replay"]),
            ("dispatch_ms", "ms", ["mono.replay", "stereo.replay"]),
            ("pll_slow_launches", "launch/chunk", ["stereo.replay"]),
            ("device_idle", "%", ["mono.replay", "stereo.replay"]))],
}


def _bench():
    b = harness.benchmark()
    for k, v in LEFT_OUT.items():
        b[k] = b[k] + v
    return b


class _SlowFake(hackrf.PacedFakeHackRF):
    """The fake at a quarter of the rate: the CPU keeps up."""

    def __init__(self, wire, rate, transfer_bytes):
        super().__init__(wire, rate / 4, transfer_bytes)


@pytest.fixture(autouse=True)
def _slow_live(monkeypatch):
    monkeypatch.setattr(hackrf, "PacedFakeHackRF", _SlowFake)


def _run(cell, trace=False, seconds=1.5, seed=3000000021, **extra):
    ov = dict(SMALL[cell], **extra)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            bench=_bench(), overrides=ov)


@pytest.mark.parametrize("cell", list(SMALL))
def test_cell_runs_correct(cell):
    res, rec = _run(cell)
    assert KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"], (res, rec)
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert "setup_s" in res["metrics"]
    assert res["device"]["count"] == 1
    # every chunk of the window streamed through ingest
    assert rec["h2d_copies_window"] >= rec["window_chunks"]
    checks = res["checks"]
    assert checks["compared_chunks"]["value"] >= 1
    for k, c in checks.items():
        assert c["value"] <= c["limit"] or k == "compared_chunks"


@pytest.mark.parametrize("cell", ["stereo.replay", "mono.bank64",
                                  "stereo.live"])
def test_traced_run_reads_per_layer_metrics(cell):
    res, _ = _run(cell, trace=True)
    assert res["correct"]
    names = {m["name"] for m in harness.cell_metrics(
        _bench(), cell, "per_layer")}
    # the CPU has no device trace: the span and counter readers report
    got = set(res["metrics"])
    assert got == {n for n in names if not n.startswith(
        ("device_idle", "chain_roofline"))}


@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()[
    "workloads"]])
def test_control_fails_the_limits(cell):
    lim = harness.cell_files(harness.benchmark(), cell)["limits"]
    ov = {"capture_samples": 300000, "rows": 2, "chunk_size": 52000}
    for seed in (3000000031, 3000000032, 3000000033):
        got = control.control_numbers(cell, seed, "cpu", ov)
        assert any(v > lim[k] for k, v in got["control"].items()), got


def test_fault_state_unchanged():
    """A FIR step that returns its state unchanged (its history never
    moves on): every chunk starts from the first one's history."""
    from luaradio_tpu_torch.blocks.signal import filtering
    orig = filtering.DecimatingFIRBlock.process

    def stuck(self, state, x):
        _, y = orig(self, state, x)
        return state, y
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(filtering.DecimatingFIRBlock, "process", stuck)
        res, _ = _run("mono.bank64")
    assert not res["correct"]


def test_fault_half_the_bank():
    """Half of a bank's rows left out: the second half computed from the
    first half's inputs, on the host route (``read``) and on the wire
    route (``read_wire_into``) that a bank of u8 captures takes."""
    from luaradio_tpu_torch.blocks.sources.bank import BankSource
    orig, orig_wire = BankSource.read, BankSource.read_wire_into

    def half(self, n):
        x = orig(self, n)
        if x is not None:
            h = x.shape[0] // 2
            x = x.copy()
            x[h:] = x[:h]
        return x

    def half_wire(self, out):
        n = orig_wire(self, out)
        h = out.shape[0] // 2
        out[h:2 * h] = out[:h]
        return n
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BankSource, "read", half)
        mp.setattr(BankSource, "read_wire_into", half_wire)
        res, _ = _run("mono.bank64")
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["mono.bank64", "stereo.live"])
def test_fault_answer_altered(cell):
    """One sample of audio altered where the graph produces it (the AF
    filter, deemphasis and downsampler that the optimizer folds into one
    decimating FIR), by 1e-3 of full scale, in one chunk in three."""
    from luaradio_tpu_torch.blocks.signal import filtering
    orig = filtering.DecimatingFIRBlock.process
    calls = {"n": 0}

    def altered(self, state, x):
        state, y = orig(self, state, x)
        calls["n"] += 1
        if y.dtype == torch.float32 and calls["n"] % 3 == 0:
            y = y.clone()
            y[..., y.shape[-1] // 2] += 1e-3
        return state, y
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(filtering.DecimatingFIRBlock, "process", altered)
        res, _ = _run(cell)
    assert not res["correct"]


def _planted_carrier(factor):
    """The pilot PLL's 38 kHz carrier multiplied by ``factor`` where the
    loop produces it; the loop's state is left as it is."""
    from luaradio_tpu_torch.blocks.signal.carrier import PLLBlock
    orig = PLLBlock.process

    def planted(self, state, x):
        state, (out, err) = orig(self, state, x)
        if self.multiplier == 2:
            out = out * factor
        return state, (out, err)
    return PLLBlock, planted


@pytest.mark.parametrize("cell", ["stereo.live", "stereo.replay"])
@pytest.mark.parametrize("factor,reads", [(-1, math.pi), (1j, math.pi / 2)])
def test_fault_carrier_inverted_or_in_quadrature(cell, factor, reads):
    """The carrier inverted (L and R swapped) or a quarter cycle off: the
    fitted angle absorbs it, ``lmr_angle`` reads it."""
    cls, planted = _planted_carrier(factor)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "process", planted)
        res, _ = _run(cell)
    assert not res["correct"]
    assert res["checks"]["lmr_gap"]["value"] <= res["checks"]["lmr_gap"][
        "limit"]
    assert abs(res["checks"]["lmr_angle"]["value"] - reads) < 0.05


def test_fault_channels_swapped_at_the_sink():
    """The two outputs handed over swapped, y[:, [1, 0]]."""
    from radiobench.window import BenchSink
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BenchSink, "process",
                   lambda self, *xs: self.window.on_chunk(xs[::-1]))
        res, _ = _run("stereo.live")
    assert not res["correct"]
    assert res["checks"]["lmr_angle"]["value"] > 3.0


def test_judge_reads_inf_on_a_short_chunk():
    from radiobench import judge
    ref = torch.zeros(1, 1, 40, dtype=torch.float64)
    ref[..., 20:] = 1.0
    got, _ = judge.gaps({0: np.zeros((1, 1, 9), np.float32)}, ref, 10)
    assert got["audio_gap"] == float("inf")
