#!/usr/bin/env python3
"""Only the bank phases of chip_smoke.py, on one card: the quick way to
iterate on the channel banks without the earlier phases' minute.

    python3 scratch/bank_phases.py [mono,stereo,time,classes,host,pinned]

Builds the kernel sources (csrc/), then runs the named phases (all by
default) exactly as chip_smoke.py does: bank-mono, bank-stereo, K3 and
the overlap scan timed batched (with the two chain probes measured
first, as chip_smoke.py's phases 8 and 9 measure them), bank-classes,
bank-host and bank-pinned (which needs no kernel build: ``pinned``
alone builds nothing).  Each phase raises on a failed check.
"""

import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from luaradio_tpu_torch.ops import cudabuild, pll, pll_overlap  # noqa: E402


def main(argv):
    which = argv[0].split(",") if argv else [
        "mono", "stereo", "time", "classes", "host", "pinned"]
    if which != ["pinned"]:
        cudabuild.build(cudabuild.SOURCES)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    if "mono" in which:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(cs.phase_bank_mono(tmp, dev)))
    if "stereo" in which:
        with tempfile.TemporaryDirectory() as tmp:
            st = cs.phase_bank_stereo(tmp, dev)
            print(json.dumps({k: v for k, v in st.items() if k != "tiers"}))
    if "time" in which:
        pll.chain_probe(1024, dev)
        ms, _ = pll.chain_probe(1 << 20, dev)
        params = cs.stereo_pll_params()
        pll_overlap.chain_probe(64, dev, *params)
        pms, _ = pll_overlap.chain_probe(1 << 14, dev, *params)
        print(json.dumps(cs.phase_bank_timing(
            dev, gen, ms * 1e6 / (1 << 20), pms * 1e6 / (1 << 14))))
    if "classes" in which:
        print(json.dumps(cs.phase_bank_classes(dev, gen)))
    if "host" in which:
        with tempfile.TemporaryDirectory() as tmp:
            print(cs.phase_bank_host(tmp, dev))
    if "pinned" in which:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(cs.phase_bank_pinned(tmp, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
