"""RDS receiver on broadcast FM from an RTL-SDR: prints the decoded RDS
packets as JSON lines on standard output (the JAX package's
examples/rtlsdr_rds.py; reference examples/rtlsdr_rds.lua).  The RDS
receiver's PLL pilot runs K3 on the card at multiplier 3.

    python -m luaradio_tpu_torch.examples.rtlsdr_rds [frequency] [--cpu]
"""

from __future__ import annotations

import sys

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.examples import run_main


def build(frequency: float = 88.5e6) -> radio.CompositeBlock:
    top = radio.CompositeBlock()
    source = radio.RtlSdrSource(frequency - 250e3, 1102500)
    tuner = radio.TunerBlock(-250e3, 200e3, 4)
    receiver = radio.RDSReceiver()
    sink = radio.JSONSink()
    top.connect(source, tuner, receiver, sink)
    return top


def main(argv=None) -> int:
    return run_main(build, argv)


if __name__ == "__main__":
    sys.exit(main())
