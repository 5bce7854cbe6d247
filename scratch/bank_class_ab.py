"""Time the bank classes (WBFMMonoBank, WBFMStereoBank, RDSBank) of one
tree of the port on one card, for an A/B in turns against another tree in
one chip call.

    python3 scratch/bank_class_ab.py ROOT [--mesh D] [--out FILE]

ROOT is the checkout whose ``luaradio_tpu_torch`` is imported.  Each class
steps [64, 2^17] chunks of FM-like noise: 4 chunks after one warm-up
chunk, host clock around synchronized steps, the median of REPS such
runs.  With ``--mesh D`` the class gets a (64, D) ("channel", "time")
mesh, else one shard (no mesh in trees whose classes take none).  Prints one JSON line: complex samples/s
summed over the channels, by class, with the card's name and power
limit.
"""

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time

REPS = 9


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--mesh", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from luaradio_tpu_torch.parallel.rds import RDSBank
    from luaradio_tpu_torch.parallel.wbfm import WBFMMonoBank, WBFMStereoBank

    dev = torch.device("cuda")
    c, chunk, chunks = 64, 1 << 17, 4
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.polar(torch.ones(c, chunk * chunks, device=dev),
                    torch.cumsum(torch.randn(c, chunk * chunks, device=dev,
                                             generator=gen) * 0.3, -1))
    mesh = None
    if args.mesh:
        from luaradio_tpu_torch.parallel.mesh import Mesh
        mesh = Mesh((c, args.mesh), ("channel", "time"))
    out = {}
    for cls, kw in ((WBFMMonoBank, {"decimation": 8}),
                    (WBFMStereoBank, {"decimation": 8}), (RDSBank, {})):
        params = inspect.signature(cls).parameters
        pos = (mesh,) if "mesh" in params else ()
        bank = cls(*pos, if_rate=256e3, device=dev, **kw)
        state = bank.init_state(c)
        bank.step(state, x[:, :chunk].contiguous())           # warm-up
        rates = []
        for _ in range(REPS):
            state = bank.init_state(c)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for xc in x.split(chunk, dim=-1):
                state, _ = bank.step(state, xc.contiguous())
            torch.cuda.synchronize()
            rates.append(x.numel() / (time.monotonic() - t0))
        out[cls.__name__] = statistics.median(rates)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = json.dumps({"root": args.root, "mesh": args.mesh,
                       "device": smi, "sps": out})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
