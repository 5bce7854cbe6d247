"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's float32 (TF32
off): float32 with every filter's operands rounded to TF32
(reference/dsp.py).  Its audio over the cell's own captures, chunked as
the cell's graph chunks it, from the chunk a run's window opens at
(the mix's ``warm_chunks``) over at least one more period of the capture,
goes through the same comparison as a run's (radiobench/judge.py); each
of its numbers is an upper reading of the cell's limits, and ``correct``
is read as a run reads it (radiobench/harness.py ``verdict``).  The
benchmark's runs never run it.

    python3 radiobench/control.py --workload <cell> --seeds <n,n,...>

prints one JSON line a seed: the control's numbers beside the cell's
limits.  Runs on the card (``--device cpu`` for a small rehearsal, with
``--capture`` cutting the capture; ``--bench`` for a cell of another
benchmark file, as a test's own).

A message cell takes the reference's ``soft(raw, cfg, "tf32")`` in the
place of the program's soft samples and its ``messages(raw, cfg,
"tf32")`` in the place of its messages, each message emitted in the
chunk its last bit enters, and holds both against the float64
reference's as a run does (radiobench/harness.py ``judge_messages``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def control_numbers(name: str, seed: int, device="cuda",
                    overrides: dict | None = None,
                    bench: dict | None = None) -> dict:
    import torch

    from luaradio_tpu_torch.core.runtime import Runner
    from radiobench import harness, judge, window as win
    files = harness.cell_files(bench or harness.benchmark(), name)
    cfg, mix = files["cfg"], dict(files["mix"])
    mix.update(overrides or {})
    messages = cfg.get("output", "audio") == "messages"
    ref_mod = harness.load_module(files["reference"])
    build = harness.load_module(files["graph"]).build
    dev = torch.device(device)
    d = ref_mod.plan(cfg)
    ds = d["soft_ds"] if messages else d["if_ds"] * d["af_ds"]
    with tempfile.TemporaryDirectory(prefix="radiobench-") as tmp:
        drv = harness.make_player(files, mix, seed, dev, tmp)
        try:
            src = drv.file_source()
            sink = win.sink_for(cfg, drv.rows, win.Window(0, 1 << 60, 0,
                                                          seed))
            runner = Runner(build(cfg, src, sink), device=dev,
                            chunk_size=mix.get("chunk_size"))
            chunk_in = runner.graph.out_chunk[id(src)]
            del runner
            raw = drv.raw(dev)
            period = drv.length
        finally:
            drv.close()
    first = int(mix["warm_chunks"])
    per = chunk_in // ds                # output samples a chunk
    periods = 2 + -(-first * chunk_in // period)
    if messages:
        ctl = ref_mod.soft(raw, cfg, "tf32", periods=periods)
    else:
        ref = ref_mod.audio(raw, cfg, quadrature=not cfg["mono"])
        ctl = ref_mod.audio(raw, cfg, "tf32", periods=periods,
                            quadrature=not cfg["mono"])
    ctl = ctl.to(torch.float64)
    channels = 1 if messages or cfg["mono"] else 2
    chunks = ctl.shape[-1] // per
    kept = {c: ctl[:, :channels, c * per:(c + 1) * per].cpu().numpy()
            for c in range(first, chunks)}
    if not kept:
        raise ValueError("the capture holds no whole chunk of output")
    if messages:
        emitted = _emitted(ref_mod.messages(raw, cfg, "tf32",
                                            periods=periods),
                           chunk_in, first, chunks - 1)
        got, extra = harness.judge_messages(emitted, kept, ref_mod, raw,
                                            cfg, chunk_in, period)
    else:
        # the control's own carrier offset at the start of its last
        # chunk, as a run reads the program's from its PLL's state
        state = None if cfg["mono"] else {
            "offset": ctl[:, 3, (chunks - 1) * per].tolist(),
            "chunks": chunks - 1}
        got, extra = judge.gaps(kept, ref, per, state)
    limits = {k: harness.AT_LEAST[k] if k in harness.AT_LEAST
              else files["limits"][k] for k in got}
    correct = harness.verdict({k: {"value": v, "limit": limits[k]}
                               for k, v in got.items()})
    return {"cell": name, "seed": seed, "correct": correct, "control": got,
            "limits": limits, **extra}


def _emitted(msgs: list, chunk_in: int, first: int, last: int) -> dict:
    """A window's messages {chunk: [(chunk, row, text), ...]} over chunks
    first .. last, each emitted in the chunk its last bit enters, each
    chunk's in row order, as a run's."""
    kept = {c: [] for c in range(first, last + 1)}
    for row, ms in enumerate(msgs):
        for at, text in ms:
            if first <= at // chunk_in <= last:
                kept[at // chunk_in].append((at // chunk_in, row, text))
    for c in kept:
        kept[c].sort(key=lambda m: m[1])
    return kept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--capture", type=int, default=None)
    ap.add_argument("--bench", default=None,
                    help="a benchmark file naming the cell in place of "
                    "BENCHMARK.json; the cell's files lie beside it")
    args = ap.parse_args(argv)
    from radiobench import harness
    ov = {"capture_samples": args.capture} if args.capture else None
    bench = harness.benchmark(Path(args.bench) if args.bench else None)
    for s in args.seeds.split(","):
        print(json.dumps(control_numbers(args.workload, int(s), args.device,
                                         ov, bench)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
