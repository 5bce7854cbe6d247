"""Roofline accounting on the card (the JAX system's bench_roofline.py, on
the port): the card's achievable rates measured by hand-written probes,
then the headline rows beside them.

    python -m luaradio_tpu_torch.benchmarks.bench_roofline [--out PATH]

Prints one JSON object; ``--out`` also writes it to PATH (nothing is
written at the repo root).  Hardware part (``hardware_measured``):

* ``hbm_copy_serial_GBps`` (R1) and ``hbm_copy_double_buffered_GBps``
  (R2), ops/roofline.py: [8, 2^23] float32 copied through shared memory,
  counting 536 870 912 bytes read plus written; ``hbm_copy_copy__GBps``:
  the same copy by ``Tensor.copy_``, beside them;
* ``tensor_core_bf16_TFLOPs``: an 8192^3 product of bf16 matrices by
  ``torch.matmul`` (bf16 inputs, float32 accumulation in the tensor
  cores, bf16 output), 2 * 8192^3 operations;
* ``atan2_GSps`` (R3): [8, 2^23] -> [8, 2^22] atan2 outputs a second.

Row part, in the port's own accounting:

* the flagship step (K1 at 8 x 2^22, parallel/flagship.py): its complex
  samples/s; its byte bound at 8.5 bytes a sample (8 read, 0.5 written
  at D = 8) against R2's measured rate and against the data sheet's
  3.35 TB/s; its 3xTF32 FIR operations a sample, counted from
  csrc/wbfm.cu's Toeplitz band (ops/wbfm.py's mirror of the kernel's
  geometry) against the 495 TFLOP/s TF32 peak;
* the noise-fed PLL row: K3 alone on 2^22 samples of noise with the
  JAX script's parameters (alpha 0.0166, beta 0.000139, -0.1 to 0.1,
  multiplier 1, zero state), M samples/s beside the floor of its
  dependency chain measured in the same run (ops/pll.py chain_probe);
* bench.py's resident row (benchmarks/bench.py file_resident).

Every object carries ``device`` and ``power_limit_w``.  Times are CUDA
events around one call, median of the repetitions, after a warm-up.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from luaradio_tpu_torch import BenchmarkSink
from luaradio_tpu_torch.benchmarks import bench, common
from luaradio_tpu_torch.ops import pll, roofline, wbfm
from luaradio_tpu_torch.parallel.flagship import (make_wbfm_mono_step,
                                                  wbfm_mono_taps)

C, T = 8, 1 << 22
MATMUL_M = 8192
PLL_N = 1 << 22
PLL_PARAMS = (0.0166, 0.000139, -0.1, 0.1, 1.0)
#: H100 SXM data sheet (NVIDIA): HBM rate, dense TF32 tensor-core rate
SHEET_BYTES_PER_S = 3.35e12
SHEET_TF32_FLOPS = 495e12
#: flagship wire bytes a complex sample: 8 read (I/Q float32), 0.5
#: written (one float32 output every D = 8 samples)
FLAGSHIP_BYTES = 8.5
REPS = 10


def _input(c, w, dev, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (c, w)).astype(np.float32)).to(dev)


def measure_copy(dev, c=C, t=T, reps=REPS) -> dict:
    """GB/s of R1, R2 and copy_ on [c, 2t] float32 (bytes read plus
    written), and the ms of each."""
    x = _input(c, 2 * t, dev, 0)
    nbytes = 2 * x.numel() * 4
    out = {"copy_bytes": nbytes}
    for key, fn in (("serial", roofline.hbm_copy_serial),
                    ("double_buffered", roofline.hbm_copy_double_buffered),
                    ("copy_", roofline.hbm_copy_reference)):
        ms = common.event_ms(lambda: fn(x), dev, reps)
        out[f"{key}_ms"] = ms
        out[f"{key}_GBps"] = nbytes / ms / 1e6
    return out


def measure_matmul(dev, m=MATMUL_M, reps=REPS) -> dict:
    """TFLOP/s of an m^3 bf16 product (float32 accumulation, bf16 out)."""
    a = _input(m, m, dev, 1).to(torch.bfloat16)
    b = _input(m, m, dev, 2).to(torch.bfloat16)
    ms = common.event_ms(lambda: torch.matmul(a, b), dev, reps)
    return {"matmul_ms": ms, "matmul_TFLOPs": 2 * m ** 3 / ms / 1e9,
            "matmul_types": "bf16 x bf16 -> bf16, float32 accumulation"}


def measure_atan2(dev, c=C, t=T, tile=1 << 15, reps=REPS) -> dict:
    """G outputs/s of R3 on [c, 2t] -> [c, t], and its ms."""
    x = _input(c, 2 * t, dev, 3)
    ms = common.event_ms(lambda: roofline.atan2_halves(x, tile), dev, reps)
    return {"atan2_ms": ms, "atan2_GSps": c * t / ms / 1e6}


def flagship_fir_flops_per_sample(c=C, t=T, d=8) -> dict:
    """3xTF32 FIR operations a complex input sample of K1 at [c, t],
    counted from the Toeplitz band: a warp tile of 128 nt outputs takes,
    for each of the D polyphase rows, a 16 x 8 ksp by 8 ksp x 8 nt
    product in each of the three passes (hi hi, hi lo, lo hi), so an
    output costs 3 D 8 ksp multiply-adds; beside the direct sum's K/D."""
    k = len(wbfm_mono_taps())
    p = wbfm.plan(c, t, k, d)
    g = wbfm._geometry(k, d, p.tile, p.nt)
    per_out = 2 * 3 * d * 8 * g["ksp"]
    return {"taps": k, "decimation": d, "nt": p.nt, "ksp": g["ksp"],
            "fir_flops_per_output": per_out,
            "fir_flops_per_sample": per_out / d,
            "direct_fir_flops_per_sample_one_pass": 2 * k / d}


def measure_flagship(dev, c=C, t=T, reps=REPS) -> dict:
    """The flagship step's ms (CUDA events, median) and samples/s."""
    step, init_state = make_wbfm_mono_step(if_rate=256e3, decimation=8,
                                           device=dev)
    state = init_state(c)
    x = _input(c, 2 * t, dev, 0)
    ms = common.event_ms(lambda: step(state, x), dev, reps)
    return {"ms": ms, "GSps": c * t / ms / 1e6}


def measure_pll(dev, n=PLL_N, reps=3) -> dict:
    """K3 alone on n samples of noise (multiplier 1, zero state): its ms
    and M samples/s, beside the chain probe's floor over n steps."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, n)).astype(np.float32).T.copy()).to(dev)
    z = torch.view_as_complex(x)
    st = torch.zeros(3, dtype=torch.float32, device=dev)
    ms = common.event_ms(lambda: pll.pll_phase(z, st, *PLL_PARAMS), dev,
                         reps, warmup=1)
    out = {"n": n, "ms": ms, "MSps": n / ms / 1e3}
    if dev.type == "cuda":
        floor_ms, _ = pll.chain_probe(n, dev)
        out.update(chain_floor_ms=floor_ms, chain_floor_MSps=n / floor_ms / 1e3,
                   ns_per_step=ms * 1e6 / n,
                   chain_floor_ns_per_step=floor_ms * 1e6 / n,
                   ratio_to_floor=ms / floor_ms)
    return out


def run(device=None, c=C, t=T, m=MATMUL_M, pll_n=PLL_N, reps=REPS,
        bench_chunk=bench.CHUNK, bench_file=bench.N_FILE,
        resident_s: float = 3.0) -> dict:
    """The roofline object on ``device`` (the card by default)."""
    dev, info = common.setup(device)
    cp = measure_copy(dev, c, t, reps)
    mm = measure_matmul(dev, m, reps)
    at = measure_atan2(dev, c, t, reps=reps)
    hw = {"device": info["device"], "power_limit_w": info["power_limit_w"],
          "hbm_copy_serial_GBps": cp["serial_GBps"],
          "hbm_copy_double_buffered_GBps": cp["double_buffered_GBps"],
          "hbm_copy_copy__GBps": cp["copy__GBps"],
          "hbm_copy_bytes": cp["copy_bytes"],
          "tensor_core_bf16_TFLOPs": mm["matmul_TFLOPs"],
          "tensor_core_bf16_types": mm["matmul_types"],
          "atan2_GSps": at["atan2_GSps"],
          "ms": {"hbm_copy_serial": cp["serial_ms"],
                 "hbm_copy_double_buffered": cp["double_buffered_ms"],
                 "copy_": cp["copy__ms"], "matmul_bf16": mm["matmul_ms"],
                 "atan2": at["atan2_ms"]}}
    r2 = cp["double_buffered_GBps"]

    flag = measure_flagship(dev, c, t, reps)
    fir = flagship_fir_flops_per_sample(c, t)
    roof_r2 = r2 / FLAGSHIP_BYTES                       # G samples/s
    roof_sheet = SHEET_BYTES_PER_S / 1e9 / FLAGSHIP_BYTES
    roof_tf32 = SHEET_TF32_FLOPS / 1e9 / fir["fir_flops_per_sample"]
    rows = [{
        "name": "flagship step (K1, bench.py value)", "shape": [c, t],
        "ms": flag["ms"], "measured_GSps": flag["GSps"],
        "bytes_per_sample": FLAGSHIP_BYTES,
        "byte_roofline_GSps_at_R2": roof_r2,
        "fraction_of_R2_byte_roofline": flag["GSps"] / roof_r2,
        "byte_roofline_GSps_at_sheet": roof_sheet,
        "fraction_of_sheet_byte_roofline": flag["GSps"] / roof_sheet,
        **fir,
        "tf32_roofline_GSps_at_sheet": roof_tf32,
        "binding_resource": ("bytes" if roof_sheet < roof_tf32
                             else "tensor-core operations")}]
    p = measure_pll(dev, pll_n)
    rows.append({"name": "PLL sequential tier (K3, noise input)",
                 "params": list(PLL_PARAMS), **p,
                 "binding_resource": "the loop-carried chain of one step "
                                     "(latency, not throughput)"})
    with tempfile.TemporaryDirectory(prefix="roofline_") as tmp:
        path = bench.write_u8_file(os.path.join(tmp, "res.u8.iq"),
                                   bench_file)
        rates, runner = bench.bench_graph(
            bench.file_graph(path, BenchmarkSink(report_period=1e9), True),
            bench_chunk, dev, resident_s)
    res = common.spread("measured_samples_per_sec", rates)
    rows.append({"name": "file_resident rx_wbfm (bench.py file_resident "
                         "row)", "chunk": bench_chunk, **res,
                 "h2d_copies": runner.h2d_copies,
                 "fraction_of_flagship_step": res["measured_samples_per_sec"]
                 / (flag["GSps"] * 1e9)})
    return {"hardware_measured": hw, "rows": rows,
            "device": info["device"], "power_limit_w": info["power_limit_w"],
            "method": ("rates from the port's probes on this card (CUDA "
                       "events, median); bounds from the H100 SXM data "
                       "sheet and from R2's measured copy rate")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the object here")
    args = ap.parse_args(argv)
    common.emit(run(), args.out, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
