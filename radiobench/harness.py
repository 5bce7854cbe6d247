"""One run of one cell: set-up, the measured window, the comparison, and
the result line (radiobench/README.md).

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json`` names the configuration (``configs/<config>.json`` and
the graph's code ``configs/<config>.py``, the reference
``reference/<config>.py``) and the traffic mix (``traffic/<mix>.json``,
played by ``players/<kind>.py``); ``workloads/<cell>.json`` holds the
cell's limits; each metric is read by ``metrics/<metric>.py``, and a
metric that reads counters of the program names them there
(``COUNTERS``).  The cells of BENCHMARK.json have their files under
radiobench/; those of another benchmark file (``benchmark(path)``, a
test's own) beside it.  The metric readers are radiobench/metrics/'s.

The graph's output is audio unless the configuration's file says
``"output": "messages"``: then the sink is ``window.MessageSink``, the
window keeps every chunk's messages beside a sample of the soft samples'
chunks, and ``judge.messages`` and ``judge.gaps`` hold them against the
reference's ``messages`` and ``soft`` (radiobench/README.md).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "luaradio_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "radiobench._by_name." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(path: Path | None = None) -> dict:
    """BENCHMARK.json, or the benchmark file at ``path``; its cells'
    files lie under ``root`` (radiobench/, or beside ``path``)."""
    if path is None:
        return {**load_json(REPO / "BENCHMARK.json"), "root": ROOT}
    return {**load_json(path), "root": Path(path).resolve().parent}


def cell_files(bench: dict, name: str) -> dict:
    """The cell's entry and the files its names point to."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    root = Path(bench.get("root", ROOT))
    cfg = load_json(root / "configs" / f"{w['config']}.json")
    mix = load_json(root / "traffic" / f"{w['traffic']}.json")
    return {"entry": w, "cfg": cfg, "mix": mix,
            "limits": load_json(root / "workloads" / f"{name}.json")[
                "limits"],
            "graph": root / "configs" / f"{w['config']}.py",
            "reference": root / "reference" / f"{w['config']}.py",
            "player": root / "players" / f"{mix['kind']}.py"}


def make_player(files: dict, mix: dict, seed: int, device, tmpdir):
    """The cell's player (``players/<kind>.py``), its inputs made."""
    return load_module(files["player"]).Player(files["cfg"], mix, seed,
                                               device, tmpdir)


#: the checks that count what was compared, each held from below (value
#: >= limit; every other check holds its reading from above): at least one
#: window chunk, and at least one expected message in every row
AT_LEAST = {"compared_chunks": 1, "compared_messages": 1}


def verdict(checks: dict) -> bool:
    """Whether every check holds its limit."""
    return all(c["value"] >= c["limit"] if k in AT_LEAST
               else c["value"] <= c["limit"] for k, c in checks.items())


def judge_messages(kept_messages: dict, kept_soft: dict, ref_mod, raw,
                   cfg: dict, chunk_in: int, period: int
                   ) -> tuple[dict, dict]:
    """A message cell's numbers: ``kept_messages`` (every window chunk's
    messages) against the reference's ``messages`` by ``judge.messages``,
    and ``kept_soft`` (a sample of the soft samples' chunks) against its
    ``soft`` by ``judge.gaps``, as ``soft_gap``; ``period`` the input
    samples a loop of the capture."""
    from radiobench import judge
    d = ref_mod.plan(cfg)
    got, extra = judge.messages(kept_messages, ref_mod.messages(raw, cfg),
                                chunk_in, d["lag"], period)
    soft, _ = judge.gaps(kept_soft, ref_mod.soft(raw, cfg),
                         chunk_in // d["soft_ds"])
    got = {"msg_missed": got["msg_missed"], "msg_wrong": got["msg_wrong"],
           "soft_gap": soft["audio_gap"],
           "compared_messages": got["compared_messages"]}
    return got, extra


def cell_metrics(bench: dict, name: str, section: str) -> list:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or name in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def counter_paths(metric_modules) -> dict:
    """{counter: "module:attribute.path"} that the metric readers name in
    their ``COUNTERS``."""
    out = {}
    for mod in metric_modules:
        out.update(getattr(mod, "COUNTERS", {}))
    return out


def read_counter(path: str):
    """The number at "module:attribute.path" (a counter of the
    program)."""
    mod, _, attrs = path.partition(":")
    v = importlib.import_module(mod)
    for a in attrs.split("."):
        v = getattr(v, a)
    return v


class _Marks:
    """Snapshots of the program's tracer, counters and copies at the
    window's marks, taken on the pump thread."""

    def __init__(self, counters: dict):
        self.runner = None
        self.counters = counters
        self.at = {}

    def take(self, mark: str):
        r = self.runner
        self.at[mark] = {
            "t": time.perf_counter(),
            "tracer": r.tracer.report() if r.tracer is not None else {},
            "counters": {k: read_counter(p)
                         for k, p in self.counters.items()},
            "h2d": r.h2d_copies}

    def diff(self, a: str, b: str) -> dict:
        x, y = self.at[a], self.at[b]
        spans = {}
        for k, v in y["tracer"].items():
            u = x["tracer"].get(k, {"count": 0, "total_s": 0.0})
            spans[k] = {"count": v["count"] - u["count"],
                        "total_s": v["total_s"] - u["total_s"]}
        return {"seconds": y["t"] - x["t"], "spans": spans,
                "counters": {k: y["counters"][k] - x["counters"][k]
                             for k in y["counters"]},
                "h2d": y["h2d"] - x["h2d"]}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             bench: dict | None = None, overrides: dict | None = None
             ) -> tuple[dict, dict]:
    """(the result line, the run's record for the line before it)."""
    from luaradio_tpu_torch.core.runtime import Runner
    from radiobench import devinfo, judge, profile, window as win

    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or benchmark()
    files = cell_files(bench, name)
    cfg, mix = files["cfg"], dict(files["mix"])
    messages = cfg.get("output", "audio") == "messages"
    mix.update(overrides or {})
    dev = torch.device(device)
    if trace:
        os.environ["LUARADIO_TPU_TRACE"] = "1"      # the tracer's switch
    rec = {"cell": name, "seed": seed, "trace": int(trace),
           "t_imports_s": time.perf_counter() - t_start}

    # the kernels this configuration's path may launch, built or loaded
    t = time.perf_counter()
    if dev.type == "cuda" and cfg["kernels"]:
        from luaradio_tpu_torch.ops import cudabuild
        rec["built"] = {k: v[0] for k, v in
                        cudabuild.build(cfg["kernels"]).items()}
        for k in cfg["kernels"]:
            cudabuild.load(k)
    if trace and dev.type == "cuda":
        profile.warm()
    rec["t_compile_s"] = time.perf_counter() - t

    tmp = tempfile.TemporaryDirectory(prefix="radiobench-")
    graph = load_module(files["graph"])
    build = graph.build
    chunk = mix.get("chunk_size")
    readers = {m["name"]: load_module(ROOT / "metrics" / f"{m['name']}.py")
               for sec in ("end_to_end", "per_layer")
               for m in cell_metrics(bench, name, sec)}
    marks = _Marks(counter_paths(readers.values()))
    state = None
    sl = profile.Slice(tmp.name) if trace and dev.type == "cuda" else None
    error = None
    drv = runner = w = sink = chunk_in = t_warm = None
    try:
        t = time.perf_counter()
        drv = make_player(files, mix, seed, dev, tmp.name)
        rec["t_inputs_s"] = time.perf_counter() - t
        t_warm = time.perf_counter()
        if hasattr(drv, "warm_source"):
            # an open loop cannot wait for set-up: the same graph warms
            # its shapes on the capture first
            w0 = win.Window(0, 1 << 60, 0, seed)
            Runner(build(cfg, drv.warm_source(),
                         win.sink_for(cfg, drv.rows, w0)),
                   device=dev, chunk_size=chunk).run(
                       max_chunks=mix["prewarm_chunks"])

        def on_open():
            marks.take("open")

        def on_slice():
            marks.take("slice")
            if sl is not None:
                sl.start()

        def on_close():
            if sl is not None:
                sl.stop()
            marks.take("close")

        w = win.Window(seconds, mix["warm_chunks"], mix["keep_chunks"],
                       seed, slice_s=mix["slice_seconds"] if trace else None,
                       on_open=on_open, on_slice=on_slice,
                       on_close=on_close)
        src = drv.source()
        sink = win.sink_for(cfg, drv.rows, w)
        top = build(cfg, src, sink)
        runner = Runner(top, device=dev, chunk_size=chunk)
        marks.runner = runner
        chunk_in = runner.graph.out_chunk[id(src)]
        runner.start()
        deadline = time.perf_counter() + seconds + mix["open_timeout_s"]
        while not w.closed.wait(0.2):
            if not runner.running or time.perf_counter() > deadline:
                break
        try:
            runner.stop(timeout=120)
        except Exception as exc:  # noqa: BLE001 — reported, judged false
            error = exc
        if messages and error is None and (
                sink.calls != sink.rows * runner.chunks_processed
                or sink.soft.calls != runner.chunks_processed):
            error = RuntimeError(
                f"the message sink took {sink.calls} calls and its soft "
                f"tap {sink.soft.calls} over {runner.chunks_processed} "
                f"chunks of {sink.rows} rows: not whole rows a chunk, or "
                f"not one soft chunk a chunk")
        if hasattr(graph, "program_state"):
            state = graph.program_state(runner)
        if not w.closed.is_set() and error is None:
            error = RuntimeError("the window did not close: the graph "
                                 "stopped or stalled")
    except Exception as exc:  # noqa: BLE001 — reported, judged false
        error = exc
    finally:
        if sl is not None:
            sl.stop()
        if drv is not None:
            drv.close()
    opened = w is not None and w.t_open is not None
    rec["t_warm_s"] = (w.t_open - t_warm) if opened else None
    setup_s = (w.t_open - t_start) if opened else None
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    info = devinfo.device_info(dev)
    rec["power_limit_w"] = info["power_limit_w"]
    if error is not None:
        rec["error"] = f"{type(error).__name__}: {error}"

    # -- what the window read --------------------------------------------
    rows = drv.rows if drv is not None else 1
    n_win = w.window_chunks if opened else 0
    attempted = max(n_win, 1) * rows
    failed = 0
    latencies = []
    comparable = dict(w.kept) if n_win else {}
    if n_win and hasattr(drv, "fake"):
        fake = drv.fake
        drops = [pos for pos, _ in fake.drops]
        for c, t_arr in w.arrivals:
            lo, hi = c * chunk_in, (c + 1) * chunk_in
            if any(lo <= p < hi for p in drops):
                failed += rows
            latencies.append(1e3 * (t_arr - fake.created(hi - 1)))
        first = min(drops) if drops else None
        if first is not None:
            comparable = {c: y for c, y in comparable.items()
                          if (c + 1) * chunk_in <= first}
        rec["drops"] = len(drops)
        rec["generator_late_max_ms"] = 1e3 * max(
            (late for due, late in fake.late
             if w.t_open <= due <= w.t_close), default=0.0)
    if error is not None:        # the chunk in flight, or all if none came
        failed = attempted if n_win == 0 else failed + rows
    ctx = {"cell": name, "cfg": cfg, "mix": mix, "seconds": seconds,
           "rows": rows, "chunk_in": chunk_in, "window_chunks": n_win,
           "input_samples": n_win * (chunk_in or 0) * rows,
           "latencies_ms": latencies, "setup_s": setup_s}
    if n_win and "close" in marks.at:
        ctx["window"] = marks.diff("open", "close")
        ctx["traced"] = marks.diff("open", "slice") \
            if "slice" in marks.at else ctx["window"]
        rec["h2d_copies_window"] = ctx["window"]["h2d"]
        n_tr = max((v["count"] for k, v in ctx["traced"]["spans"].items()
                    if k.startswith("segment[")), default=0)
        if n_tr:
            rec["spans_ms_per_chunk"] = {
                k: 1e3 * v["total_s"] / n_tr
                for k, v in ctx["traced"]["spans"].items()}
        rec["counters_setup"] = marks.at["open"]["counters"]
        rec["counters_window"] = ctx["window"]["counters"]
    ctx["profile"] = sl.reduce() if sl is not None else None
    ctx["slice_chunks"] = w.slice_chunks if opened else 0
    ref_mod = load_module(files["reference"])
    ctx["work"] = ref_mod.work(cfg)
    ctx["peaks"] = load_json(ROOT / "peaks.json").get(info["device"])
    if latencies:
        rec["latency_ms"] = {"median": float(np.median(latencies)),
                             "max": float(np.max(latencies)),
                             "count": len(latencies)}
    if n_win:
        # chunks a second of the window, to see whether a run's rate holds
        sec = np.floor([t_arr - w.t_open for _, t_arr in w.arrivals])
        rec["chunks_by_second"] = np.bincount(
            np.clip(sec.astype(int), 0, None)).tolist()
    rec.update(window_chunks=n_win, chunk_in=chunk_in, rows=rows,
               setup_s=setup_s)

    # -- free the program, then the reference ---------------------------
    del runner
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    limits = files["limits"]
    checks = {}
    if comparable and error is None and messages:
        got, extra = judge_messages(w.messages, comparable, ref_mod,
                                    drv.raw(dev), cfg, chunk_in, drv.length)
        rec.update(extra)
        checks = {k: {"value": v,
                      "limit": AT_LEAST[k] if k in AT_LEAST else limits[k]}
                  for k, v in got.items()}
    elif comparable and error is None:
        ref = ref_mod.audio(drv.raw(dev), cfg, quadrature=not cfg["mono"])
        d = ref_mod.plan(cfg)
        got, extra = judge.gaps(comparable, ref,
                                chunk_in // (d["if_ds"] * d["af_ds"]),
                                state)
        rec.update(extra)
        del ref
        checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    checks["compared_chunks"] = {"value": len(comparable),
                                 "limit": AT_LEAST["compared_chunks"]}
    rec["t_reference_s"] = time.perf_counter() - t
    tmp.cleanup()
    correct = error is None and verdict(checks)

    # -- metrics ---------------------------------------------------------
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    if n_win:
        for m in cell_metrics(bench, name, section):
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": info["device"], "count": 1,
              "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": device}
    prof = ctx["profile"]
    if trace and prof is not None:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    return result, rec


__all__ = ["run_cell", "benchmark", "cell_files", "make_player", "AT_LEAST",
           "verdict", "judge_messages", "cell_metrics", "counter_paths",
           "read_counter", "forbidden_modules", "load_json", "load_module"]
