#!/usr/bin/env python3
"""The PLL linear tier's kernel (csrc/pll_linear.cu) alone on a card:
build it and the kernels the AM band cell's graph runs (printing ptxas'
registers, shared memory and spills), run chip_smoke.py's pll-linear
phase (the kernel against its twin on the AM band's rows, the stereo
pilot and 8 RDS pilots; timed beside its bound) and
tests/test_torch_pll_linear_cuda.py.

    python3 scratch/pll_linear_chip.py

Exits non-zero on any failure; a hang ends the run after 600 s.
"""

import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
faulthandler.dump_traceback_later(600, exit=True)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from luaradio_tpu_torch.ops import cudabuild  # noqa: E402


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.monotonic()
    for name, (secs, log) in cudabuild.build(
            ("pll_linear", "channelizer", "pll", "pll_overlap")).items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln
                 or "warning" in ln]
        print(f"build {name} {secs:.1f} s: " + " | ".join(lines), flush=True)
    print(f"built in {time.monotonic() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2828)
    with tempfile.TemporaryDirectory() as tmp:
        entry = cs.phase_pll_linear(tmp, dev, gen, smi)
    print(json.dumps({"pll_linear": entry}), flush=True)
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p",
                        "no:cacheprovider", "-q",
                        "tests/test_torch_pll_linear_cuda.py"], cwd=ROOT)
    faulthandler.cancel_dump_traceback_later()
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
