"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's float32 (TF32
off): float32 with every filter's operands rounded to TF32
(reference/dsp.py).  Its audio over the cell's own captures, chunked as
the cell's graph chunks it, from the chunk a run's window opens at
(the mix's ``warm_chunks``) over at least one more period of the capture,
goes through the same comparison as a run's (radiobench/judge.py); each
of its numbers is an upper reading of the cell's limits.  The benchmark's
runs never run it.

    python3 radiobench/control.py --workload <cell> --seeds <n,n,...>

prints one JSON line a seed: the control's numbers beside the cell's
limits.  Runs on the card (``--device cpu`` for a small rehearsal, with
``--capture`` cutting the capture).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def control_numbers(name: str, seed: int, device="cuda",
                    overrides: dict | None = None) -> dict:
    import torch

    from luaradio_tpu_torch.core.runtime import Runner
    from radiobench import drive, harness, judge, window as win
    files = harness.cell_files(harness.benchmark(), name)
    cfg, mix = files["cfg"], dict(files["mix"])
    mix.update(overrides or {})
    ref_mod = harness.load_module(files["reference"])
    build = harness.load_module(files["graph"]).build
    dev = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="radiobench-") as tmp:
        drv = drive.make(cfg, mix, seed, dev, tmp)
        try:
            src = drv.file_source()
            channels = 1 if cfg["mono"] else 2
            runner = Runner(build(cfg, src, win.BenchSink(
                channels, win.Window(0, 1 << 60, 0, seed))), device=dev,
                chunk_size=mix.get("chunk_size"))
            chunk_in = runner.graph.out_chunk[id(src)]
            del runner
            d = ref_mod.plan(cfg)
            per = chunk_in // (d["if_ds"] * d["af_ds"])
            period = drv.length // (d["if_ds"] * d["af_ds"])
            first = int(mix["warm_chunks"])
            raw = drv.raw(dev)
            ref = ref_mod.audio(raw, cfg, quadrature=not cfg["mono"])
            ctl = ref_mod.audio(raw, cfg, "tf32",
                                periods=2 + -(-first * per // period),
                                quadrature=not cfg["mono"]).to(ref.dtype)
        finally:
            drv.close()
    chunks = ctl.shape[-1] // per
    kept = {c: ctl[:, :channels, c * per:(c + 1) * per].cpu().numpy()
            for c in range(first, chunks)}
    if not kept:
        raise ValueError("the capture holds no whole chunk of audio")
    # the control's own carrier offset at the start of its last chunk, as
    # a run reads the program's from its PLL's state
    state = None if cfg["mono"] else {
        "offset": ctl[:, 3, (chunks - 1) * per].tolist(),
        "chunks": chunks - 1}
    got, extra = judge.gaps(kept, ref, per, state)
    return {"cell": name, "seed": seed, "control": got, "limits": files[
        "limits"], **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--capture", type=int, default=None)
    args = ap.parse_args(argv)
    ov = {"capture_samples": args.capture} if args.capture else None
    for s in args.seeds.split(","):
        print(json.dumps(control_numbers(args.workload, int(s), args.device,
                                         ov)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
