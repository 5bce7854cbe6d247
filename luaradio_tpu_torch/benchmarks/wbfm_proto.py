"""The flagship kernel taken apart, S4, on the card (scratch/wbfm_proto.py,
on the port): K1's function at each precision of its two products and
stopped after each stage.

    python -m luaradio_tpu_torch.benchmarks.wbfm_proto [--out PATH]

At the script's size (C = 8, T = 2^22, x normal from seed 0, a zero carry,
taps 120 Hann-windowed sinc + 8 zeros, D = 8, inv_gain 1): ``prod_GSps``
is the port's K1 (ops/wbfm.py ``wbfm_mono``), then for each variant of
the script's ``main()`` (:250-254) and each added here (every other
precision, and the four stages at tile 2^14) ops/wbfm_proto.py
``wbfm_proto``'s ``<name>_GSps`` and, for the full stage, its
``<name>_rel_err``: max |variant - K1| over max |K1|.  Rates are complex
samples/s from ``<name>_ms``, the time a call of ``reps`` calls back to
back between two CUDA events (benchmarks/common.py ``batch_ms``, the
script's own ``timeit``: the card's queue hides the host's time between
launches); ``<name>_launch_ms`` is one call's (CUDA events around it,
median of 3, host time included).  Prints one JSON object (``--out``
also writes it), with the card's name and power limit.

:func:`sass_issue_estimate` reads the shipped kernel's instructions a
sample from ``cuobjdump -sass`` and turns them into an issue-slot time.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from luaradio_tpu_torch.benchmarks import common
from luaradio_tpu_torch.ops import cudabuild, wbfm, wbfm_proto

C, T, TILE, D = 8, 1 << 22, 1 << 14, 8
#: (name, deint_prec, fir_prec, stage, tile as a multiple of TILE): the
#: script's main() variants, then the other precisions and the stages
VARIANTS = (("v2_sel3_fir22", "sel3", "split22", "full", 1),
            ("v3_sel3cat_fir2", "sel3cat", "two", "full", 1),
            ("v3_sel3_fir2", "sel3", "two", "full", 1),
            ("v3_sel3cat_fir22", "sel3cat", "split22", "full", 1),
            ("v3_sel3cat_fir2_t32k", "sel3cat", "two", "full", 2),
            ("p_highest", "highest", "highest", "full", 1),
            ("p_default", "default", "default", "full", 1),
            ("p_sel3", "sel3", "sel3", "full", 1),
            ("p_sel2", "sel2", "sel2", "full", 1),
            ("p_two_hi", "highest", "two_hi", "full", 1),
            ("stage_dma_only", "sel3cat", "two", "dma_only", 1),
            ("stage_no_deint", "sel3cat", "two", "no_deint", 1),
            ("stage_deint_only", "sel3cat", "two", "deint_only", 1),
            ("stage_no_fir", "sel3cat", "two", "no_fir", 1))
REPS = 50
LAUNCH_REPS = 3


def proto_taps() -> np.ndarray:
    """The script's taps: 120 of a Hann-windowed sinc and 8 zeros."""
    taps = (np.hanning(120) * np.sinc(np.linspace(-4, 4, 120))).astype(
        np.float32)
    return np.concatenate([taps, np.zeros(8, np.float32)])


def inputs(dev, c=C, t=T, seed=0):
    """(x [c, 2t], the zero carry [c, 2K], taps [K]) on ``dev``."""
    x = np.random.default_rng(seed).standard_normal((c, 2 * t)).astype(
        np.float32)
    taps = proto_taps()
    return (torch.from_numpy(x).to(dev),
            torch.zeros((c, 2 * len(taps)), dtype=torch.float32, device=dev),
            torch.from_numpy(taps).to(dev))


def run(device=None, c=C, t=T, tile=TILE, reps=REPS,
        variants=VARIANTS) -> dict:
    """The script's record on ``device`` (the card by default)."""
    dev, info = common.setup(device)
    x, carry, taps = inputs(dev, c, t)
    k = taps.shape[0]
    kcarry = torch.zeros((c, k), dtype=torch.complex64, device=dev)
    _, prod = wbfm.wbfm_mono(kcarry, x, taps, D, 1.0)
    scale = float(prod.abs().max())
    def k1():
        return wbfm.wbfm_mono(kcarry, x, taps, D, 1.0)
    ms = common.batch_ms(k1, dev, reps)
    rec = {"device": info["device"], "power_limit_w": info["power_limit_w"],
           "shape": [c, t], "tile": tile, "prod_GSps": c * t / ms / 1e6,
           "prod_ms": ms,
           "prod_launch_ms": common.event_ms(k1, dev, LAUNCH_REPS)}
    for name, dp, fp, st, mul in variants:
        def call():
            return wbfm_proto.wbfm_proto(carry, x, taps, D, 1.0, mul * tile,
                                         128, dp, fp, st)
        if st == "full":
            _, audio = call()
            err = float((audio - prod).abs().max())
            rec[f"{name}_rel_err"] = err / scale
        ms = common.batch_ms(call, dev, reps)
        rec[f"{name}_GSps"] = c * t / ms / 1e6
        rec[f"{name}_ms"] = ms
        rec[f"{name}_launch_ms"] = common.event_ms(call, dev, LAUNCH_REPS)
    rec["method"] = (f"complex samples/s from the time a call of {reps} "
                     f"calls back to back between two CUDA events (the "
                     f"script's timeit); launch_ms: CUDA events around one "
                     f"call, median of {LAUNCH_REPS}; rel_err against K1 on "
                     f"the same input")
    return rec


def _ring_constants() -> dict:
    """The shipped ring's constants as csrc/wbfm_proto.cu states them."""
    text = (cudabuild.CSRC / "wbfm_proto.cu").read_text()
    ints = dict(re.findall(r"\b(k[A-Z]\w*) = (\d+)", text))
    bools = dict(re.findall(r"\b(k[A-Z]\w*) = (true|false)", text))
    out = {k: int(v) for k, v in ints.items()}
    out.update({k: v == "true" for k, v in bools.items()})
    return out


def disc_loop_sass(sass: str):
    """(instructions, SHFL.UP count, the loop's lines) of the innermost
    loop holding a SHFL.UP in one function's SASS text (its lines
    ``/*addr*/ OP ...``) with the most bf16 conversions: the
    discriminator's loop under sel3's rounding, two SHFL.UP (re, im) a
    sample a lane.  Instructions a forward branch skips over a call or a
    libdevice division check (FCHK) are not counted: that is atan2f's
    fallback (or its division's slow path), which a lane takes only where
    the fast path does not hold."""
    ins = []
    for ln in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, op in ins:
        b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
        if not b:
            continue
        target = int(b.group(1), 16)
        if target >= addr:
            continue
        body = [(a, o) for a, o in ins if target <= a <= addr]
        if any("SHFL.UP" in o for _, o in body):
            loops.append((target, addr, body))
    # the innermost: loops holding no other such loop
    loops = [b for t0, a0, b in loops
             if not any(t0 <= t1 and a1 <= a0 and (t1, a1) != (t0, a0)
                        for t1, a1, _ in loops)]
    if not loops:
        return None
    # the function holds a loop a deinterleave mode: the one with the
    # most bf16 conversions is sel3's (three a float), the smallest of them
    # its aligned form
    conv = [sum(o.startswith(("F2F", "F2FP")) for _, o in b) for b in loops]
    best = min((b for b, n in zip(loops, conv) if n == max(conv)), key=len)
    skipped = set()
    for addr, op in best:
        b = re.search(r"@!?P\d\s+BRA\b.*?0x([0-9a-f]+)", op)
        if b and int(b.group(1), 16) > addr:
            span = [a for a, o in best if addr < a < int(b.group(1), 16)]
            if any(o.startswith(("FCHK", "CALL")) for a, o in best
                   if a in span):
                skipped.update(span)
    n_run = sum(a not in skipped for a, _ in best)
    return (n_run, sum("SHFL.UP" in o for _, o in best),
            [f"/*{a:04x}*/ {o}" + (" (fallback)" if a in skipped else "")
             for a, o in best])


def sass_issue_estimate(c: int, t: int, sms: int | None = None,
                        clock_mhz: float | None = None,
                        keep_loop: bool = False) -> dict:
    """Issue slots of the shipped ring at [c, t]: the discriminator loop's
    instructions a sample (``cuobjdump -sass`` of the built library, the
    v2_sel3_fir22 instance; atan2f's fallback not counted), times c t
    samples over 32 lanes, over the card's SMs x 4 schedulers x its SM
    clock (nvidia-smi's clocks.max.sm unless given).  The loop is most of
    the kernel's work; the FIR, the producer and the set-up come on
    top."""
    consts = _ring_constants()
    lib = cudabuild.library_path("wbfm_proto")
    cuobjdump = Path(cudabuild.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    want = f"ILi{consts['kWarps']}ELi3ELi4ELb1ELi{consts['kAtan']}E"
    body = next((f for f in funcs if want in f.split("\n", 1)[0]), None)
    if body is None:
        raise RuntimeError(f"no ring_kernel instance {want} in {lib.name}")
    loop = disc_loop_sass(body)
    if loop is None:
        raise RuntimeError("no loop holding SHFL.UP in the ring's SASS")
    n_ins, n_shfl, body = loop
    per_sample = n_ins / (n_shfl / 2)   # two SHFL.UP (re, im) a sample
    if sms is None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
    if clock_mhz is None:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits", "--id=0"],
                             capture_output=True, text=True).stdout
        clock_mhz = float(out.strip().splitlines()[0])
    warp_ins = per_sample * c * t / 32
    ms = warp_ins / (sms * 4 * clock_mhz * 1e6) * 1e3
    rec = {"instructions_a_sample": per_sample, "shfl_up_in_loop": n_shfl,
           "loop_instructions": n_ins, "sms": sms, "clock_mhz": clock_mhz,
           "issue_bound_ms": ms, "function": want}
    if keep_loop:
        rec["loop"] = body
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the object here")
    args = ap.parse_args(argv)
    common.emit(run(), args.out, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
