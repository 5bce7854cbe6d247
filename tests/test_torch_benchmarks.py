"""The port's measurement entry points (luaradio_tpu_torch/benchmarks/) on
the CPU at small sizes: their records have the JAX scripts' keys, their
rows are the JAX scripts' rows, and what they compute agrees with a serial
run or with the JAX package.  No timing is asserted: rates, latency and
overflows are the card's.

* bench: bench.py's keys (:192-233), the link pair replaced by the
  pageable host-to-device pair, plus device and power limit; on the CPU
  the host-to-device pair is None (no link to measure);
* bench_blocks: the row names and baselines of root bench_blocks.py's
  ``benchmarks()``, in order;
* bench_scaling: the sharded bank's audio within 1e-6 of one shard's;
* bench_realtime: unpaced, every delivered sample is accounted for;
* bench_multihost: the u8 wire scenario over two gloo processes against
  its serial run (the scenario tests/test_torch_multihost.py has no
  counterpart of in bench form);
* entry: the flagship step against the JAX ``__graft_entry__.entry()``
  step on the same payload, resumed from the JAX state through
  interop.flagship_state_from_jax, within K1's 2e-5 * scale; and
  ``dryrun_multichip(8)``'s shapes.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import __graft_entry__ as graft  # noqa: E402
import bench_blocks as root_bench_blocks  # noqa: E402
from luaradio_tpu_torch.benchmarks import (bench, bench_blocks,  # noqa: E402
                                           bench_multihost, bench_realtime,
                                           bench_scaling, entry)
from luaradio_tpu_torch.interop import flagship_state_from_jax  # noqa: E402
from luaradio_tpu_torch.parallel.flagship import INV_GAIN  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _root_bench_keys() -> set:
    """The keys bench.py's ``main`` writes into its record (the initial
    dict and every ``rec[...] =``), its error keys left out."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store) and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return {k for k in keys if not k.endswith("error")}


def test_bench_record_has_bench_py_keys():
    rec = bench.run(device="cpu", budget=0.2, chunk=1 << 14, channels=2,
                    t=1 << 14, n_file=1 << 15)
    root = _root_bench_keys()
    assert {"link_ceiling_mbps", "file_driven_fraction_of_link",
            "value", "runner_samples_per_sec",
            "file_resident_vs_baseline"} <= root
    want = (root - {"link_ceiling_mbps", "file_driven_fraction_of_link"}) \
        | {"h2d_pageable_MBps", "file_driven_fraction_of_h2d", "device",
           "power_limit_w"}
    rates = ("value", "runner_samples_per_sec",
             "file_driven_samples_per_sec", "file_resident_samples_per_sec")
    spread = {f"{k}_{s}" for k in rates for s in ("min", "max")}
    assert set(rec) == want | spread | {"ok", "file_resident_h2d_copies"}
    assert rec["ok"] and rec["metric"] == bench.METRIC
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert rec["h2d_pageable_MBps"] is None
    assert rec["file_driven_fraction_of_h2d"] is None
    assert rec["file_resident_h2d_copies"] == 0
    for k in rates:
        assert rec[f"{k}_min"] <= rec[k] <= rec[f"{k}_max"]
    assert rec["vs_baseline"] == rec["value"] / bench.BASELINE_SPS


def test_bench_main_prints_its_line_with_the_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench.main(["--budget", "1"]) == 1
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["metric"] == bench.METRIC and rec["value"] == 0.0
    assert "no CUDA device" in rec["error"]


def test_bench_blocks_rows_are_the_root_scripts(tmp_path, monkeypatch):
    made = []

    def tmpfile(data):
        path = tmp_path / f"root{len(made)}.bin"
        path.write_bytes(data)
        made.append(path)
        return str(path)
    monkeypatch.setattr(root_bench_blocks, "_tmpfile", tmpfile)
    root = [(name, base) for name, base, _ in root_bench_blocks.benchmarks()]
    port = [(name, base) for name, base, _
            in bench_blocks.benchmarks(str(tmp_path), 1 << 12)]
    assert port == root
    assert len(port) == 53
    assert set(bench_blocks.OPTIMIZE_OFF) <= {n for n, _ in port}
    assert set(bench_blocks.CHUNK_OVERRIDES) == set(
        root_bench_blocks.CHUNK_OVERRIDES)
    assert all(bench_blocks.CHUNK_OVERRIDES[k]
               == root_bench_blocks.CHUNK_OVERRIDES[k]
               for k in bench_blocks.CHUNK_OVERRIDES)


def test_bench_blocks_rows_run_on_the_cpu(tmp_path):
    rows = []
    agg = bench_blocks.run(device="cpu", only="File Source", duration=0.01,
                           emit=rows.append, chunk=1 << 12, n_file=1 << 14)
    assert agg["n_rows"] == agg["n_ok"] == 5 == len(rows)
    for r in rows:
        assert r["samples_per_second"] > 0 and r["chunk"] == 1 << 12
        assert r["device"] == "cpu"
        if r["name"] in bench_blocks.WIRE_BYTES:
            assert r["h2d_pageable_MBps"] is None
            assert "fraction_of_h2d" not in r


def test_bench_scaling_shards_match_one_shard():
    lines = []
    summary = bench_scaling.run(8, emit=lines.append, total_t=8 * 8 * 256,
                                channels=4, device="cpu")
    assert [r["devices"] for r in summary["results"]] == [1, 2, 4, 8]
    assert [r["mesh"] for r in summary["results"]] == [[1, 1], [2, 1],
                                                       [2, 2], [2, 4]]
    assert all(r["max_abs_err_vs_single"] <= 1e-6
               for r in summary["results"])
    assert len(lines) == 5 and json.loads(lines[-1])["device"] == "cpu"
    rows = bench_scaling.run_generic(8, emit=lines.append,
                                     chunk_size=1 << 13, device="cpu",
                                     chunks=1)
    assert [r["mesh"] for r in rows] == [[2], [4], [8]]
    assert all("overhead_vs_single" in r for r in rows)


def test_bench_realtime_accounts_for_every_sample():
    rec = bench_realtime.run_realtime(duration=0.3, grace=0.05,
                                      chunk=1 << 16, device="cpu",
                                      paced=False, burst_chunks=1)
    for key in ("radio_rate_sps", "duration_s", "chunk_rf_samples",
                "delivered_rf_samples", "sustained_input_sps",
                "audio_samples_out", "ring_overflows_steady_state",
                "ring_overflows_startup", "latency_p50_s", "latency_max_s",
                "latency_slope_s_per_s", "unpaced_throughput_sps",
                "real_time_margin", "compile_warmup_s", "grace_s", "ok",
                "dropped_rf_samples", "device", "power_limit_w"):
        assert key in rec, key
    assert rec["delivered_rf_samples"] >= 0.3 * bench_realtime.RATE
    # the chain decimates by 10 then 5: 50 RF samples an audio sample
    left = rec["delivered_rf_samples"] - rec["dropped_rf_samples"] \
        - 50 * rec["audio_samples_out"]
    assert 0 <= left < 50
    assert bench_realtime.RtlSdrSource._injected_lib is None


def test_bench_multihost_wire_matches_serial(tmp_path):
    (rec,) = bench_multihost.run(("wbfm_wire",), tmpdir=str(tmp_path),
                                 device="cpu")
    assert rec["ok"] and rec["scenario"] == "wbfm_wire"
    assert rec["n_processes"] == 2 and rec["time_shards"] == 4
    assert rec["samples"] == bench_multihost.CHUNK * bench_multihost.N_CHUNKS
    assert rec["max_abs_err_vs_serial"] <= 1e-5


def _close(got, exp, tol=2e-5):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    scale = max(1.0, float(np.max(np.abs(exp))))
    assert np.max(np.abs(got - exp)) < tol * scale


def test_entry_matches_the_jax_entry():
    jstep, (jstate, jx) = graft.entry()
    step, (state, x) = entry.entry(device="cpu")
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert tuple(state[0].shape) == (4, 640)
    jstate1, jaudio1 = jstep(jstate, jx)
    _, jaudio2 = jstep(jstate1, jx)
    state1, audio1 = step(state, x)
    _close(audio1.numpy(), jaudio1)
    resumed = flagship_state_from_jax(jstate1, INV_GAIN, device="cpu")
    _, audio2 = step(resumed, x)
    assert tuple(audio2.shape) == (4, (1 << 16) // 8)
    _close(audio2.numpy(), jaudio2)


def test_dryrun_multichip_shapes():
    out = entry.dryrun_multichip(8, device="cpu")
    assert out["bank"] == {"mesh": [2, 4], "audio": [4, 128]}
    assert out["channel"] == {"mesh": [8], "chunks": [(8, 128)] * 4}
    assert out["time"] == {"mesh": [8], "chunks": [(1024,)] * 2}
