"""L/R separation of rx_wbfm stereo (PLL pilot) on chip_smoke.py's 8 s
capture, the port and the JAX package on the CPU, with the two WAVs
compared.  Run from the repository root: python scratch/stereo_sep_cpu.py
(JAX_PLATFORMS=cpu)."""
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as C  # noqa: E402
from luaradio_tpu.cli import main as jax_main  # noqa: E402
from luaradio_tpu_torch.cli import main as port_main  # noqa: E402

torch.set_num_threads(4)
with tempfile.TemporaryDirectory() as d:
    path, n = C.write_stereo_capture(d)
    args = ["-a", "rx_wbfm", "-i", f"iqfile:{path},rate=1102500"]
    t = time.time()
    port_main(args + ["-o", f"wavfile:{d}/t.wav", "100e6"], device="cpu")
    print("port", time.time() - t)
    pcm, rate = C.read_wav(f"{d}/t.wav")
    print("port sep", C.separation_db(pcm, rate))
    t = time.time()
    jax_main(args + ["-o", f"wavfile:{d}/j.wav", "100e6"])
    print("jax", time.time() - t)
    pcm2, _ = C.read_wav(f"{d}/j.wav")
    print("jax sep", C.separation_db(pcm2, rate))
    a, b = pcm.astype(float), pcm2.astype(float)
    print("L+R diff", np.abs(a.sum(1) - b.sum(1)).max(), "L-R corr",
          np.corrcoef(a[:, 0] - a[:, 1], b[:, 0] - b[:, 1])[0, 1])
