"""Rehearse chip_smoke.py's io-wire, live, net and plot-tx phases on the
CPU at a small size: K3's plain twin counted as its launches,
torch.cuda.synchronize stubbed, the RDS and AM captures cut to
``seconds`` and the live runs' wall-time limit loosened to ``slack`` x
real time (the CPU runs the PLL's twin).

    python scratch/io_rehearsal.py [seconds [slack]]     # default 2 10
"""

import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as cs  # noqa: E402
from luaradio_tpu_torch.ops import pll  # noqa: E402


def main(argv):
    torch.cuda.synchronize = lambda *a, **k: None
    twin = pll.pll_phase_reference

    def counted(*args, **kw):
        pll.pll_phase.launches += 1
        return twin(*args, **kw)
    pll.pll_phase_reference = counted
    cs.DIGITAL_S = cs.LIVE_S = int(argv[0]) if argv else 2
    cs.LIVE_SLACK = float(argv[1]) if len(argv) > 1 else 10.0
    dev = torch.device("cpu")
    t0 = time.monotonic()
    cs.phase_io_wire(dev)
    with tempfile.TemporaryDirectory() as tmp:
        paths, n, rds_path, sent, wires = cs.live_captures(tmp)
        packets = cs.phase_rds(tmp, dev)["packets"]
        cs.phase_live(dev, wires, sent)
        cs.phase_net(tmp, dev, paths, n, rds_path, packets)
        cs.phase_plot_tx(tmp, dev)
    print(f"rehearsal passed in {time.monotonic() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
