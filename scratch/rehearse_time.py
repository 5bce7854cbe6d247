"""Rehearse chip_smoke.py's time, multihost and embed phases on the CPU at a
small size (no card: the plain PyTorch path, the card's busy share not
measured).

    python scratch/rehearse_time.py [rds seconds]

The RDS capture is cut to the given seconds (default 4); bench.py's
chunk, the file ring and the bank classes' shape are cut down too.  The
rx_rds CLI runs first for the packets the time phase compares with.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
torch.set_num_threads(4)
torch.cuda.synchronize = lambda *a, **k: None

import chip_smoke as cs  # noqa: E402

cs.BENCH_CHUNK, cs.BENCH_FILE, cs.BENCH_S = 1 << 16, 1 << 17, 0.5
cs.CLASS_CHUNK, cs.CLASS_CHUNKS, cs.BANK_C = 1 << 12, 2, 4
cs.DIGITAL_S = int(sys.argv[1]) if len(sys.argv) > 1 else 4
cs.busy_share = lambda run: (run(), (0.0, 0.0))[1]


def main():
    dev = torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        paths, _ = cs.write_capture(tmp)
        rds_path, _, sent = cs.write_rds_capture(tmp)
        t0 = time.monotonic()
        cs.run_cli(["-a", "rx_rds", "-i", f"iqfile:{rds_path},rate={cs.RATE}",
                    "-o", f"json:{tmp}/rds.json", "0"], dev)
        packets = cs.read_json_lines(f"{tmp}/rds.json")
        print(f"rx_rds: {len(packets)} packets in "
              f"{time.monotonic() - t0:.1f} s")
        tsh, audio = cs.phase_time(tmp, dev, "cpu", paths, rds_path, sent,
                                   packets)
        mh = cs.phase_multihost(tmp, dev, paths, audio)
        emb = cs.phase_embed(tmp, dev)
        print(json.dumps({"time": tsh, "multihost": mh, "embed": emb},
                         default=str))


if __name__ == "__main__":
    main()
