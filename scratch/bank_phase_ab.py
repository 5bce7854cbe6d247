"""Run chip_smoke.py's bank-host and bank-stereo phases of one tree on one
card, for an A/B in turns against another tree in one chip call.

    python3 scratch/bank_phase_ab.py ROOT [--out FILE]

ROOT is the checkout whose ``chip_smoke.py`` and ``luaradio_tpu_torch``
are imported.  Each phase runs REPS times (its own checks included);
prints one JSON line with the complex samples/s of each run (summed over
the channels, host clock), the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPS = 3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--out")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke

    dev = torch.device("cuda")
    out = {"bank_host": [], "bank_stereo": []}
    for _ in range(REPS):
        with tempfile.TemporaryDirectory() as tmp:
            out["bank_host"].append(chip_smoke.phase_bank_host(tmp, dev))
        with tempfile.TemporaryDirectory() as tmp:
            out["bank_stereo"].append(
                chip_smoke.phase_bank_stereo(tmp, dev)["sps"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = json.dumps({"root": args.root, "device": smi, "sps": out})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
