"""The harness's files, found by name, and what they build (CPU).

    python -m pytest radiobench/tests -q
"""

import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
sys.path.insert(0, str(REPO))

from radiobench import harness, synth  # noqa: E402

torch.set_num_threads(1)
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["radiobench"]
    assert (REPO / BENCH["command"][1]).is_file()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 << 10


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    files = harness.cell_files(BENCH, cell)
    assert files["graph"].is_file() and files["reference"].is_file()
    cfg = files["cfg"]
    conf = [c for c in BENCH["configs"] if c["name"] == files["entry"][
        "config"]][0]
    assert (REPO / conf["file"]).resolve() == (
        ROOT / "configs" / f"{conf['name']}.json")
    assert set(conf["reduced"]) <= set(cfg)
    for section in ("end_to_end", "per_layer"):
        ms = harness.cell_metrics(BENCH, cell, section)
        assert ms, section
        for m in ms:
            mod = harness.load_module(ROOT / "metrics" / f"{m['name']}.py")
            assert callable(mod.read)
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                    "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert files["limits"]
    # the mix's player, and a live mix's fake library, found by name
    mix = files["mix"]
    assert (ROOT / "players" / f"{mix['kind']}.py").is_file()
    if "sdr" in mix:
        assert (ROOT / "fakes" / f"{mix['sdr']}.py").is_file()


def _ctx(stereo):
    """A run's context as radiobench/harness.py hands it to the readers,
    with every field a reader may read filled: every span and counter the
    readers name, and a configuration with a channelizer."""
    spans = {k: {"count": 40, "total_s": t} for k, t in (
        ("sources.wait", 0.5), ("sources.h2d", 0.01),
        ("segment[0].dispatch", 0.2), ("host[0].process", 0.1),
        ("chunk.hold", 1.2), ("host.d2h_wait", 0.004),
        ("pll.host_read", 0.01), ("pll.device", 0.16),
        ("channelizer.device", 0.004))}
    part = {"seconds": 2.0, "spans": spans, "h2d": 40,
            "counters": {"pll_phase": 3, "pll_overlap_discard": 1,
                         "scan_rows": 4680, "k3_rows": 0}}
    cfg = json.loads((ROOT / "configs" / "fmband100_hackrf.json"
                      ).read_text())
    return {"cell": "-", "cfg": dict(cfg, mono=not stereo), "seconds": 20.0,
            "rows": 1, "chunk_in": 262200, "window_chunks": 400,
            "input_samples": 400 * 262200, "latencies_ms": [50.0] * 100,
            "setup_s": 12.5, "window": part, "traced": part,
            "profile": {"busy_s": 0.5, "window_s": 2.0},
            "slice_chunks": 40, "work": {"flops": 300.0, "bytes": 2.2},
            "peaks": {"fp32_flops_per_s": 6.7e13,
                      "hbm_bytes_per_s": 3.35e12}}


@pytest.mark.parametrize("path", sorted(
    p.name for p in (ROOT / "metrics").glob("*.py")
    if p.name != "__init__.py"))
def test_every_metric_reader_reads(path):
    """Each reader, whether or not a cell of BENCHMARK.json names it yet,
    resolves, names only counters that exist, and reads a number from a
    run's context (and nothing from a run that found nothing)."""
    mod = harness.load_module(ROOT / "metrics" / path)
    for p in getattr(mod, "COUNTERS", {}).values():
        assert isinstance(harness.read_counter(p), int)
    v = mod.read(_ctx(stereo=True))
    assert isinstance(v, float) and math.isfinite(v) and v > 0
    empty = dict(_ctx(stereo=True), window_chunks=0, latencies_ms=[],
                 traced=None, profile=None, setup_s=None)
    assert mod.read(empty) is None


class _Spec:
    """An input or output of the CLI: ``make`` hands out a given block."""

    def __init__(self, block, rate=None):
        self.block, self.rate, self.options = block, rate, {}

    def make(self, *args):
        return self.block


def _leaves(top):
    blocks, edges = top._flatten()
    desc = []
    for b in blocks:
        d = {"type": type(b).__name__}
        for k in ("offset", "bandwidth", "factor", "tau", "num_taps",
                  "cutoff", "cutoffs", "multiplier", "loop_bandwidth",
                  "frequency_min", "frequency_max", "gain", "taps"):
            v = getattr(b, k, None)
            if v is not None:
                d[k] = np.asarray(v).tolist() if k == "taps" else v
        desc.append(d)
    index = {id(b): i for i, b in enumerate(blocks)}
    conns = sorted((index[id(s.block)], s.index, index[id(d.block)], d.index)
                   for d, s in edges.items())
    return desc, conns


@pytest.mark.parametrize("config", [
    c["name"] for c in BENCH["configs"]
    if "tuner_bandwidth" in json.loads((REPO / c["file"]).read_text())])
def test_config_builds_what_rx_wbfm_builds(config, tmp_path, monkeypatch):
    """A configuration with rx_wbfm's tuner builds rx_wbfm's graph.  The
    band configurations put a channelizer in the tuner's place, a graph
    rx_wbfm does not build: tests/test_torch_fmband.py and
    tests/test_torch_amband.py hold theirs."""
    import luaradio_tpu_torch as lr
    from luaradio_tpu_torch.applications.apps import RxWBFM
    from radiobench.window import BenchSink, Window
    cfg = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    build = harness.load_module(ROOT / "configs" / f"{config}.py").build
    path = tmp_path / "cap.iq"
    path.write_bytes(b"\0" * 64)
    ch = 1 if cfg["mono"] else 2

    def parts():
        return (lr.IQFileSource(str(path), cfg["wire"], cfg["rate"]),
                BenchSink(ch, Window(0, 1 << 60, 0, 0)))

    captured = {}
    monkeypatch.setattr(lr.CompositeBlock, "run",
                        lambda self, *a, **k: captured.setdefault("top",
                                                                  self))
    src, sink = parts()
    RxWBFM().run(_Spec(src, cfg["rate"]), _Spec(sink),
                 _Args([cfg["frequency"]], mono=cfg["mono"]), device="cpu")
    src2, sink2 = parts()
    assert _leaves(captured["top"]) == _leaves(build(cfg, src2, sink2))


class _Args(list):
    """rx_wbfm's parsed arguments: positionals and options."""

    def __init__(self, positional, **options):
        super().__init__(positional)
        self.options = options

    def get(self, k, default=None):
        return self.options.get(k, default)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_generator_deterministic_and_seamless(config):
    cfg = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    sig = json.loads((ROOT / "traffic" / "replay_2p24.json").read_text())[
        "signal"]
    n = synth.seamless_length(40000, cfg)
    rate = cfg["rate"]
    assert (n * cfg["tune_offset"] / rate) == round(
        n * cfg["tune_offset"] / rate)
    a = synth.capture(3000000001, n, cfg, sig, "cpu")
    b = synth.capture(3000000001, n, cfg, sig, "cpu")
    c = synth.capture(3000000002, n, cfg, sig, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the stream continues across the wrap: sample n is sample 0 again
    idx = torch.arange(n + 1, dtype=torch.int64)
    x, _ = synth.baseband(3000000001, n, cfg, sig, "cpu", idx)
    assert abs(complex(x[n] - x[0])) < 1e-9
    # and the message has zero mean: no step of the phase at the wrap
    d = torch.angle(x[1:] * x[:-1].conj())
    assert abs(float(d[-1]) - float(d[0])) < 2 * float(d.diff().abs().max())
    k_p = synth.PILOT_HZ * n / rate
    assert math.isclose(k_p, round(k_p))


def test_no_jax_in_a_fresh_process():
    code = ("import sys; sys.path.insert(0, %r); "
            "from radiobench import harness, drive, judge, profile, window, "
            "control, readers, synth; "
            "import radiobench.reference.wbfm; "
            "[harness.load_module(p) for p in "
            "harness.ROOT.glob('*/*.py') if p.parent.name != 'tests']; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'luaradio_tpu'}))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_exits_nonzero_without_a_card():
    out = subprocess.run(
        [sys.executable, str(REPO / "radiobench" / "run.py"), "--workload",
         CELLS[0], "--seed", "3000000003", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
